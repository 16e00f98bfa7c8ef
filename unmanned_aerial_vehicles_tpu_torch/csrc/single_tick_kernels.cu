// The single-tick fused kernels, one thread block per call (K4 and K6: one
// block per flight of a population, below):
//
//   K14 admm_explicit_kernel  replaces the JAX package's
//      ops/admm_pallas.py:admm_box_qp_fused (pallas_call at :107, body
//      _make_kernel at :28): `iterations` over-relaxed ADMM steps of the box
//      QP with an explicit M^-1, rhs = -f + (rho z - y) G, u = rhs M^-1,
//      Gu = G u, relaxation, clip and dual step, then one more u from the
//      final (z, y). 512 threads, each holding its slices of G and M^-1 in
//      registers (see K14 below). Plain version:
//      ops/admm_pallas.py:admm_box_qp_fused_plain.
//   K6 admm_composite_kernel / admm_factored_kernel  replace the JAX
//      package's ops/admm_pallas.py:admm_box_qp_fused_composite (pallas_call
//      at :193): `iterations` composite-ADMM steps, then the primal recovery
//      U = -M^-1 f + (rho z - y) GMinvT'. Plain version:
//      ops/admm_pallas.py:admm_box_qp_fused_composite_plain.
//   K3 controller_kernel  replaces ops/controller_pallas.py:
//      gpmpc_controller_fused (pallas_call at :169): prediction offset,
//      condensed gradient, box bounds, p0 and M^-1 f, the ADMM loop, U and
//      the predicted tail X_tail, from an already shifted warm start. Plain
//      version: ops/controller_pallas.py:gpmpc_controller_fused_plain.
//   K4 gpmpc_tick_kernel  replaces ops/tick_pallas.py:gpmpc_tick_fused
//      (pallas_call at :344): the warm-start shift, the condensed solve with
//      the controller reading ctrl_state and the state boxes tightened by
//      the `tight` row, then the u0 clips, the hover fallback, allocation +
//      attitude PID and the plant's RK4 substeps on `state`, and the 25-lane
//      packed row. Plain version: ops/tick_pallas.py:gpmpc_tick_fused_plain.
//
// K4 and K3 are kernels of the multi-tick family (tick_kernel.cu: K5,
// noisy_tick_kernel.cu: K9): 512 threads and multitick_phases.cuh's
// condensed_solve, so they run one device implementation of the tick; K4
// adds warm_shift before it and plant_math.cuh's mpc_command_plant_warp on
// warp 0 after it.
//
// The ADMM operator P1 = G M^-1 G' (m x m). K4 applies P1 itself
// (P1Operator; 160,000 bytes at N=20): in dynamic shared memory where the
// layout fits the block's opt-in shared memory (kSharedP1, N <= 23 on an
// H100), else read through L1/L2 each step; thread 0 bulk-copies it at the
// kernel's start and the solve waits for it only before the first ADMM
// step. K3 and K6 (given Su') apply P1 as its two factors for G = [I; Su]
// (block_linalg.cuh): t = v GM^-1, GU = p0 + [t | t Su'], 64 N^2
// multiply-adds a step against P1's 100 N^2, and each of the 512 threads
// holds its slices of both factors in registers for the whole launch
// (SliceOperator, factored_admm_slices: at most 36 + 20 floats a thread to
// N=20, 52 + 36 to N=25), so a step reads only its vectors from shared
// memory. Both load their slices from device memory when the ADMM starts:
// K3 from GM^-1 (P0matT, m x Nnu) and Su' (SuT, Nnu x Nnx), neighbouring
// threads reading neighbouring columns; K6 from GMinvT (GM^-1's transpose,
// the JAX operand), each thread's slice a contiguous run. Past N=25 both
// read the factors through L2 every step (FactoredOperator,
// factored_admm). Without Su', K6 runs the P1 step on
// 256 threads (admm_composite_kernel: composite_admm, one column a thread,
// P1 copied in with 16-byte loads before any other work).
//
// What bounds them on an H100: one block on one SM of 132, so latency, not
// the card's rates. A factored step is two register products, their slices
// added after a barrier each, and the updates, four barriers in all; the
// other phases are short matvecs against L2-resident operands (~200 KB)
// and, in K4, the one-warp RK4. K14's iteration, three products on the
// register slices, was five barriers and dependent chains of shared-memory
// loads on 256 threads before (matvec_partial; 367.80 us at N=25 on an
// H100); see K14 below for what bounds it now. The bound from the
// card's rates (bytes over 3.35 TB/s, operations over 67 TFLOP/s) is well
// under a microsecond; a batch of QPs (a grid of blocks) is what would
// approach it.
//
// Every sum runs in a fixed order, so two launches agree bit for bit.
//
// A population (loop/closed_loop.py batched_mpc_flight_rollout) launches K4
// and K6 as a grid of one block per flight: block b reads and writes flight
// b's rows of the per-flight operands (tick_flight, admm_flight below) and
// shares the rest (K4: the tick data, ref and tight; K6: P1's factors), so
// each block runs the one-flight kernel's arithmetic on its flight and
// agrees with a one-flight launch bit for bit. The blocks keep their
// 512 threads and one-block-an-SM register budget, so B flights run in
// ceil(B / 132) waves on an H100; the bound at B flights is B times one
// flight's bytes and operations at the card's rates.

#include <cuda_runtime.h>

#include "block_linalg.cuh"
#include "cluster.cuh"
#include "multitick_phases.cuh"
#include "plant_math.cuh"

// Host-visible (external linkage): laid out as ops/admm_pallas.py's
// _AdmmParams / _AdmmOperands and ops/controller_pallas.py's
// _SingleTickParams / _SingleTickOperands.
struct AdmmParams {
  int n, m, iterations;
  float rho, over_relax, one_minus_over_relax;
};

// SuT (n x (m - n), G's block below the identity, transposed) is read by
// admm_factored_kernel only; P1 by admm_composite_kernel only.
struct AdmmOperands {
  const float *P1, *p0, *GMinvT, *minvf, *lower, *upper, *z_in, *y_in;
  float *u_out, *z_out, *y_out;
  const float* SuT;
};

// K14 (ops/admm_pallas.py _ExplicitParams / _ExplicitOperands)
struct ExplicitParams {
  int n, m, iterations;
  float rho, over_relax, one_minus_over_relax;
  int shared_slices;   // the memory variant: G and M^-1 copied into shared memory
};

struct ExplicitOperands {
  const float *Minv, *G, *f, *lower, *upper, *z_in, *y_in;
  float *u_out, *z_out, *y_out;
};

struct SingleTickParams {
  int n, m, iterations, substeps, use_fallback;
  double dt;
  float rho, over_relax, one_minus_over_relax, yawrate_limit;
  float fallback_error_sq, fallback_thrust_ceiling;
  float accel_lo[3], accel_hi[3], fallback_lo[3], fallback_hi[3];
};

// x0: the controller's state (K3: 6 lanes; K4: ctrl_state, 12 lanes).
// state, misc = [yaw_ref, integral (3)], tight, plant_row and packed are
// K4's only. K4's operands copied with bulk copies (P1) are 16-byte
// aligned.
struct SingleTickOperands {
  const float *SxSwT, *SuTqT, *PM, *P1, *P0matT, *SuT, *lo_row, *hi_row;
  const float *x0, *w, *ref, *z_in, *y_in;
  const float *state, *misc, *tight, *plant_row;
  float *z_out, *y_out, *u_out, *xtail_out, *packed;
};

namespace {

constexpr int kThreads = 256;       // ops/admm_pallas.py KERNEL_THREADS: K6 on P1
constexpr int kTickThreads = 512;   // ops/tick_pallas.py SINGLE_TICK_THREADS: K4, K3, K6 factored, K14
constexpr int kNu = 4;
constexpr int kNx = 6;

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Flight b's K4 operands: its rows of ctrl_state, w, z, y, state, misc and
// the plant block, and of every output.
__device__ __forceinline__ SingleTickOperands tick_flight(const SingleTickOperands& O, int b,
                                                          int m, int Nnu, int Nnx) {
  SingleTickOperands F = O;
  F.x0 += b * 12;
  F.w += b * Nnx;
  F.z_in += b * m;
  F.y_in += b * m;
  F.state += b * 12;
  F.misc += b * 4;
  F.plant_row += b * 10;
  F.z_out += b * m;
  F.y_out += b * m;
  F.u_out += b * Nnu;
  F.xtail_out += b * Nnx;
  F.packed += b * 25;
  return F;
}

// Flight b's K6 operands: its p0, M^-1 f, bounds, z and y, and its outputs.
__device__ __forceinline__ AdmmOperands admm_flight(const AdmmOperands& O, int b, int n, int m) {
  AdmmOperands F = O;
  F.p0 += b * m;
  F.minvf += b * n;
  F.lower += b * m;
  F.upper += b * m;
  F.z_in += b * m;
  F.y_in += b * m;
  F.u_out += b * n;
  F.z_out += b * m;
  F.y_out += b * m;
  return F;
}

template <bool kSharedP1>
__global__ void __launch_bounds__(kThreads, 1)
admm_composite_kernel(const AdmmParams P, const AdmmOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int m = P.m, m4 = round4(m);

  // shared memory layout (ops/admm_pallas.py shared_memory_bytes)
  float* P1s = sm;
  float* va = P1s + (kSharedP1 ? round4(m * m) : 0);
  float* vb = va + m4;
  float* z = vb + m4;
  float* y = z + m;
  float* p0 = y + m;
  float* lower = p0 + m;
  float* upper = lower + m;

  if constexpr (kSharedP1) uav::copy_floats_to_shared(P1s, O.P1, m * m, tid, nth);
  for (int i = tid; i < m; i += nth) {
    z[i] = O.z_in[i];
    y[i] = O.y_in[i];
    p0[i] = O.p0[i];
    lower[i] = O.lower[i];
    upper[i] = O.upper[i];
    va[i] = P.rho * z[i] - y[i];
  }
  __syncthreads();
  const float* vsrc = uav::composite_admm<kSharedP1>(
      kSharedP1 ? P1s : O.P1, m, p0, lower, upper, z, y, va, vb, P.rho, P.over_relax,
      P.one_minus_over_relax, P.iterations, tid, nth);
  // primal recovery: U[r] = -minvf[r] + GMinvT[r, :] . (rho z - y)
  uav::row_dots_warp(O.GMinvT, m, vsrc, m, P.n, tid, nth,
                     [=](int r, float acc) { O.u_out[r] = -O.minvf[r] + acc; });
  for (int i = tid; i < m; i += nth) {
    O.z_out[i] = z[i];
    O.y_out[i] = y[i];
  }
}

// ---- K14 ----------------------------------------------------------------
//
// One block of 512 threads, 16 warps. Warp w owns a band of H = ceil(m /
// 16) rows of G (w H .. w H + H - 1) and of Hn = ceil(n / 16) rows of M^-1;
// lane l owns the columns l + 32 q (q < 4) of each 128-column block. One
// slice of G serves both of its products:
//   (a) v G: each lane sums its band's rows for its own columns (an FMA
//       chain over the rows in order), one partial per (warp, column);
//   (b) rhs = -f + the 16 warps' partials, for the rows of the warp's M^-1
//       band (lane group g = l >> 3 adds warps g, g + 4, g + 8, g + 12 in
//       order, then the four groups meet by xor shuffles at 8 and 16);
//   (c) rhs M^-1: each lane's chain over the band's rows (their rhs passed
//       through shared memory, 8 a warp), one partial per (warp, column);
//   (d) u = the 16 warps' partials (the same sum as (b)), 8 columns a warp;
//   (e) G u: each lane's chain over its columns for each band row, the row
//       reduced over the warp's 32 lanes by a fixed xor tree (offsets 16, 8,
//       4, 2, 1: a plain butterfly's sums, 16 rows at a time, lanes 2h and
//       2h + 1 ending with row h), then the relaxation, clip and dual step
//       of the band's rows and v = rho z - y for the warp's next (a).
// Three barriers an iteration, after (a), (c) and (d); (e) needs none,
// since a warp's (a) reads only its own band's v. The last pass stops
// after (d) and writes u.
//
// Variants (ops/admm_pallas.py explicit_variant), chosen by whether a
// thread's slices fit: kQ = 3 or 4 holds each thread's slices in registers
// for the whole launch, 16 rows x kQ columns of G and kMRows x kQ of M^-1
// (m <= 256 and n <= 96, 112 or 128 for (kQ, kMRows) = (3, 6), (4, 7), (4,
// 8): the staged MPC's QP at N=20 and N=25, the 128-lane padded operands),
// with no bounds tested in the loops (the slices hold 0 outside the
// matrix); kQ = 0 loads each 16-row group's (and 8-row M^-1 group's) slice
// of each 128-column block into registers where it is used, from copies in
// shared memory where they fit (shared_slices) or through L1/L2, in as
// many groups and blocks as the shape needs, adding in the same order.
//
// What bounds it on an H100: one block on one SM, so latency and the SM's
// issue. An iteration is 2 n m + n^2 multiply-adds (60,000 at N=25, n=100,
// m=250; 4 warps x 156 FMAs on each SM sub-partition on the padded
// slices), the shuffle trees, the shared-memory sums and three barriers
// (the single_tick_clocks build times each phase: chip_smoke.py prints
// them); ~4x fewer cycles an iteration than the first design's five
// barriers and dependent shared-memory chains on 256 threads.
// Every sum runs in a fixed order, so two launches agree bit for bit.
constexpr int kExplicitWarps = kTickThreads / 32;   // 16 row bands
constexpr int kRowGroup = 16;   // G rows of a band held or read at a time
constexpr int kColSlots = 4;    // a lane's columns in a 128-column block
constexpr int kColBlock = 32 * kColSlots;
constexpr int kMGroup = 8;      // M^-1 rows whose rhs a warp reduces at once

// K14's shape: the bands, groups and blocks, and the partials' row stride
// (128 blocks + 8: the four lane groups of a sum read distinct banks).
struct ExplicitShape {
  int n, m, band, mband, groups, mgroups, blocks, slots, ldp;
};

__host__ __device__ __forceinline__ ExplicitShape explicit_shape(int n, int m) {
  ExplicitShape S;
  S.n = n;
  S.m = m;
  S.band = (m + kExplicitWarps - 1) / kExplicitWarps;
  S.mband = (n + kExplicitWarps - 1) / kExplicitWarps;
  S.groups = (S.band + kRowGroup - 1) / kRowGroup;
  S.mgroups = (S.mband + kMGroup - 1) / kMGroup;
  S.blocks = (n + kColBlock - 1) / kColBlock;
  S.slots = kRowGroup * S.groups;   // a warp's row slots (its band, padded)
  S.ldp = kColBlock * S.blocks + 8;
  return S;
}

// The register variants' slices of G (band rows h < 16, columns 32 q +
// lane, q < kQ) and of M^-1 (band rows j < kMRows), loaded once; 0 outside
// the band and the matrix.
template <int kQ, int kMRows>
struct ExplicitSlices {
  float g[kRowGroup][kQ], mi[kMRows][kQ];

  __device__ __forceinline__ ExplicitSlices(const float* __restrict__ G,
                                            const float* __restrict__ Minv,
                                            const ExplicitShape& S, int warp, int lane) {
#pragma unroll
    for (int h = 0; h < kRowGroup; ++h) {
      const int row = warp * S.band + h;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int col = 32 * q + lane;
        g[h][q] = h < S.band && row < S.m && col < S.n ? __ldg(G + row * S.n + col) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kMRows; ++j) {
      const int row = warp * S.mband + j;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int col = 32 * q + lane;
        mi[j][q] = j < S.mband && row < S.n && col < S.n ? __ldg(Minv + row * S.n + col) : 0.0f;
      }
    }
  }
};

template <>
struct ExplicitSlices<0, 0> {   // the memory variant holds none
  __device__ __forceinline__ ExplicitSlices(const float*, const float*, const ExplicitShape&, int,
                                            int) {}
};

// The memory variant's pointers to a lane's columns 128 cb + 32 q + lane of
// a matrix of n columns, clamped inside it: a column past n is read as the
// last one, and what it adds lands only in partials and rows the kernel
// discards (past n), or meets u = 0.
__device__ __forceinline__ void lane_columns(const float* (&cp)[kColSlots], const float* A, int cb,
                                             int n, int lane) {
#pragma unroll
  for (int q = 0; q < kColSlots; ++q) cp[q] = A + min(cb * kColBlock + 32 * q + lane, n - 1);
}

// The 16 warps' partials of column c (part: 16 rows of ldp floats), lane
// group g adding warps g, g + 4, g + 8, g + 12, the groups meeting at xor
// 8 and 16: every lane ends with the sum.
__device__ __forceinline__ float warp_partials_total(const float* __restrict__ part, int ldp,
                                                     int c, int g) {
  const float* p = part + c;
  float s = ((p[g * ldp] + p[(g + 4) * ldp]) + p[(g + 8) * ldp]) + p[(g + 12) * ldp];
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  return s;
}

// Section clocks (thread 0; ops/admm_pallas.py EXPLICIT_SECTIONS): 0 (a),
// 1 the wait after it, 2 (b) and (c), 3 the wait after them, 4 (d), 5 the
// wait after it, 6 (e), 7 the whole launch, 8 the set-up (slices, vectors).
template <int kQ, int kMRows>
__global__ void __launch_bounds__(kTickThreads, 1)
admm_explicit_kernel(const __grid_constant__ ExplicitParams P,
                     const __grid_constant__ ExplicitOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int nth = kTickThreads;
  constexpr bool kRegs = kQ > 0;
  const ExplicitShape S = explicit_shape(P.n, P.m);
  const int n = S.n, m = S.m, ldp = S.ldp, slots = S.slots;
  const float rho = P.rho, inv_rho = 1.0f / rho;
  const int j8 = lane & 7, g4 = lane >> 3;
  SECTION_START(t_whole);

  // shared memory layout (ops/admm_pallas.py explicit_shared_memory_bytes)
  float* part1 = sm;                        // (a)'s partials: 16 rows of ldp
  float* part2 = part1 + kExplicitWarps * ldp;   // (c)'s
  float* fs = part2 + kExplicitWarps * ldp; // f, 0 past n: ldp
  float* us = fs + ldp;                     // u, 0 past n: 128 blocks
  float* rb = us + kColBlock * S.blocks;    // each warp's 8 rhs rows of (c)
  float* vs = rb + kExplicitWarps * kMGroup;   // rho z - y by row slot (warp w: w slots + hh)
  float* zs = vs + kExplicitWarps * slots;
  float* ys = zs + kExplicitWarps * slots;
  float* los = ys + kExplicitWarps * slots;
  float* his = los + kExplicitWarps * slots;
  float* Gs = his + kExplicitWarps * slots; // the memory variant's copies (shared_slices)
  float* Ms = Gs + round4(m * n);

  for (int i = tid; i < 2 * kExplicitWarps * ldp + ldp + kColBlock * S.blocks; i += nth) {
    sm[i] = 0.0f;
  }
  for (int i = tid; i < kExplicitWarps * slots; i += nth) {
    const int hh = i % slots, row = (i / slots) * S.band + hh;
    const bool valid = hh < S.band && row < m;
    const float z = valid ? O.z_in[row] : 0.0f, y = valid ? O.y_in[row] : 0.0f;
    zs[i] = z;
    ys[i] = y;
    los[i] = valid ? O.lower[row] : 0.0f;
    his[i] = valid ? O.upper[row] : 0.0f;
    vs[i] = rho * z - y;
  }
  __syncthreads();   // the zeros before f
  for (int k = tid; k < n; k += nth) fs[k] = O.f[k];
  const float* Gsrc = O.G;
  const float* Msrc = O.Minv;
  if constexpr (!kRegs) {
    if (P.shared_slices) {
      uav::copy_floats_to_shared(Gs, O.G, m * n, tid, nth);
      uav::copy_floats_to_shared(Ms, O.Minv, n * n, tid, nth);
      Gsrc = Gs;
      Msrc = Ms;
    }
  }
  // the register variants' slices, and the rows of a warp's G and M^-1
  // bands that lie in the matrix (the memory variant's loads)
  const ExplicitSlices<kQ, kMRows> sl(O.G, O.Minv, S, warp, lane);
  const int g_end = min(warp * S.band + S.band, m), m_end = min(warp * S.mband + S.mband, n);
  __syncthreads();
  // the register variants keep f of their one rhs row and z and y of
  // their row slot (lane >> 1) in registers
  const int own = warp * slots + (lane >> 1);
  const float f_own = fs[warp * S.mband + j8];
  float z_own = zs[own], y_own = ys[own];
  if (tid == 0) SECTION_ADD(8, t_whole);

  const float* vw = vs + warp * slots;
  for (int it = 0;; ++it) {
    SECTION_START(c0);
    // (a) v G: the band's partials for the lane's columns, each a chain
    // over the band's rows in order
    if constexpr (kRegs) {
      float p[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) p[q] = 0.0f;
#pragma unroll
      for (int h4 = 0; h4 < kRowGroup / 4; ++h4) {
        const float4 v4 = reinterpret_cast<const float4*>(vw)[h4];
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int q = 0; q < kQ; ++q) p[q] = fmaf(v[e], sl.g[4 * h4 + e][q], p[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) part1[warp * ldp + 32 * q + lane] = p[q];
    } else {
      for (int cb = 0; cb < S.blocks; ++cb) {
        const float* cp[kColSlots];
        lane_columns(cp, Gsrc, cb, n, lane);
        float p[kColSlots] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int hg = 0; hg < S.groups; ++hg) {
          const int r0 = warp * S.band + hg * kRowGroup, count = min(kRowGroup, g_end - r0);
#pragma unroll
          for (int h = 0; h < kRowGroup; ++h) {
            if (h >= count) break;
            const float v = vw[hg * kRowGroup + h];
            const size_t ro = (size_t)(r0 + h) * n;
#pragma unroll
            for (int q = 0; q < kColSlots; ++q) p[q] = fmaf(v, cp[q][ro], p[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kColSlots; ++q) {
          if (cb * kColBlock + 32 * q < n) part1[warp * ldp + cb * kColBlock + 32 * q + lane] = p[q];
        }
      }
    }
    SECTION_START(c1);
    if (tid == 0) SECTION_ADD(0, c0);
    __syncthreads();
    SECTION_START(c2);
    if (tid == 0) SECTION_ADD(1, c1);
    // (b) rhs for the rows of the warp's M^-1 band, 8 at a time, broadcast
    // through rb; (c) rhs M^-1's partials, each a chain over the band's rows
    if constexpr (kRegs) {
      const float rhs = -f_own + warp_partials_total(part1, ldp, warp * S.mband + j8, g4);
      if (g4 == 0) rb[warp * kMGroup + j8] = rhs;
      __syncwarp();
      const float4* r4 = reinterpret_cast<const float4*>(rb + warp * kMGroup);
      const float4 ra = r4[0], rc = r4[1];
      const float r[kMGroup] = {ra.x, ra.y, ra.z, ra.w, rc.x, rc.y, rc.z, rc.w};
      __syncwarp();
      float p[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) p[q] = 0.0f;
#pragma unroll
      for (int j = 0; j < kMRows; ++j) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) p[q] = fmaf(r[j], sl.mi[j][q], p[q]);
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) part2[warp * ldp + 32 * q + lane] = p[q];
    } else {
      for (int cb = 0; cb < S.blocks; ++cb) {
        const float* cp[kColSlots];
        lane_columns(cp, Msrc, cb, n, lane);
        float p[kColSlots] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int mg = 0; mg < S.mgroups; ++mg) {
          const int k = warp * S.mband + mg * kMGroup + j8;
          const int r0 = warp * S.mband + mg * kMGroup, count = min(kMGroup, m_end - r0);
          const float rhs = -fs[k] + warp_partials_total(part1, ldp, k, g4);
          __syncwarp();   // rb read by the last group
          if (g4 == 0) rb[warp * kMGroup + j8] = rhs;
          __syncwarp();
#pragma unroll
          for (int j = 0; j < kMGroup; ++j) {
            if (j >= count) break;
            const float r = rb[warp * kMGroup + j];
            const size_t ro = (size_t)(r0 + j) * n;
#pragma unroll
            for (int q = 0; q < kColSlots; ++q) p[q] = fmaf(r, cp[q][ro], p[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kColSlots; ++q) {
          if (cb * kColBlock + 32 * q < n) part2[warp * ldp + cb * kColBlock + 32 * q + lane] = p[q];
        }
      }
    }
    SECTION_START(c3);
    if (tid == 0) SECTION_ADD(2, c2);
    __syncthreads();
    SECTION_START(c4);
    if (tid == 0) SECTION_ADD(3, c3);
    // (d) u, 8 columns a warp in each block
    for (int cb = 0; cb < (kRegs ? 1 : S.blocks); ++cb) {
      const int c = cb * kColBlock + 8 * warp + j8;
      const float u = warp_partials_total(part2, ldp, c, g4);
      if (g4 == 0 && c < n) us[c] = u;
    }
    SECTION_START(c5);
    if (tid == 0) SECTION_ADD(4, c4);
    __syncthreads();
    if (it == P.iterations) break;
    SECTION_START(c6);
    if (tid == 0) SECTION_ADD(5, c5);
    // (e) G u for the band's rows, 16 at a time (each row's chain over the
    // lane's columns in order), then their updates (rows past the band or
    // past m: state 0 and box [0, 0], so they stay 0)
    for (int hg = 0; hg < (kRegs ? 1 : S.groups); ++hg) {
      // the xor tree: at 16, 8, 4 and 2 each lane keeps half of its rows
      // (in the register variants rows h and h + 8 meet as soon as both are
      // formed), so that lanes 2h, 2h + 1 end with row h
      const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4, hi2 = lane & 2;
      float k8[8], k4[4], k2[2];
      if constexpr (kRegs) {
        float uv[kQ];
#pragma unroll
        for (int q = 0; q < kQ; ++q) uv[q] = us[32 * q + lane];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            a0 = fmaf(sl.g[e][q], uv[q], a0);
            a1 = fmaf(sl.g[e + 8][q], uv[q], a1);
          }
          k8[e] = (hi16 ? a1 : a0) + __shfl_xor_sync(0xffffffffu, hi16 ? a0 : a1, 16);
        }
      } else {
        const int r0 = warp * S.band + hg * kRowGroup, count = min(kRowGroup, g_end - r0);
        float acc[kRowGroup];
#pragma unroll
        for (int h = 0; h < kRowGroup; ++h) acc[h] = 0.0f;
        for (int cb = 0; cb < S.blocks; ++cb) {
          const float* cp[kColSlots];
          lane_columns(cp, Gsrc, cb, n, lane);
          float u[kColSlots];   // 0 past n
#pragma unroll
          for (int q = 0; q < kColSlots; ++q) u[q] = us[cb * kColBlock + 32 * q + lane];
#pragma unroll
          for (int h = 0; h < kRowGroup; ++h) {
            if (h >= count) break;   // rows past the band or m keep 0
            const size_t ro = (size_t)(r0 + h) * n;
#pragma unroll
            for (int q = 0; q < kColSlots; ++q) acc[h] = fmaf(cp[q][ro], u[q], acc[h]);
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          k8[e] = (hi16 ? acc[e + 8] : acc[e]) +
                  __shfl_xor_sync(0xffffffffu, hi16 ? acc[e] : acc[e + 8], 16);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k4[e] = (hi8 ? k8[4 + e] : k8[e]) +
                __shfl_xor_sync(0xffffffffu, hi8 ? k8[e] : k8[4 + e], 8);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        k2[e] = (hi4 ? k4[2 + e] : k4[e]) +
                __shfl_xor_sync(0xffffffffu, hi4 ? k4[e] : k4[2 + e], 4);
      }
      float gu = (hi2 ? k2[1] : k2[0]) + __shfl_xor_sync(0xffffffffu, hi2 ? k2[0] : k2[1], 2);
      gu += __shfl_xor_sync(0xffffffffu, gu, 1);
      // the row's relaxation, clip and dual step, on lanes 2h and 2h + 1
      const int i = warp * slots + hg * kRowGroup + (lane >> 1);
      const float z = kRegs ? z_own : zs[i], y = kRegs ? y_own : ys[i];
      const float Gt = P.over_relax * gu + P.one_minus_over_relax * z;
      const float zn = uav::clipf(Gt + y * inv_rho, los[i], his[i]);
      const float yn = y + rho * (Gt - zn);
      z_own = zn;
      y_own = yn;
      if ((lane & 1) == 0) {
        zs[i] = zn;
        ys[i] = yn;
        vs[i] = rho * zn - yn;
      }
    }
    __syncwarp();   // the band's v before the warp's next (a)
    if (tid == 0) SECTION_ADD(6, c6);
  }
  for (int c = tid; c < n; c += nth) O.u_out[c] = us[c];
  for (int r = tid; r < m; r += nth) {
    const int i = (r / S.band) * slots + r % S.band;
    O.z_out[r] = zs[i];
    O.y_out[r] = ys[i];
  }
  if (tid == 0) SECTION_ADD(7, t_whole);
}

// ---- K4 -----------------------------------------------------------------
//
// One block of 512 threads. Thread 0 starts P1's copy into shared memory
// (kSharedP1: bulk copies of at most kCopyChunk bytes, completing on one
// transaction barrier) before anything else; the block loads the warm
// start, shifts it (warm_shift) and loads [ctrl_state[0:6] | w]; the
// condensed solve (condensed_solve) runs its offset, f, bounds, p0 and
// M^-1 f phases against L2 while the copy lands, and waits on the barrier
// only before its first ADMM step. Then warp 0 runs the scalar section
// (mpc_command_plant_warp: clips, fallback, allocation + PID on ctrl_state,
// RK4 on state) and lane 0 writes the packed row, while warps 1-15 write
// the slack, dual and U. X_tail goes straight to device memory.
//
// Section clocks (ops/tick_pallas.py SINGLE_TICK_SECTIONS): the wait for
// P1 (the copy's part not hidden), the warm start, the solve's six phases,
// the scalar section and the whole launch.
constexpr int kCopyChunk = 16384;

template <bool kSharedP1>
__global__ void __launch_bounds__(kTickThreads, 1)
gpmpc_tick_kernel(const __grid_constant__ SingleTickParams P,
                  const __grid_constant__ SingleTickOperands Og) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int nth = kTickThreads;
  const int N = P.n, m = P.m, Nnu = N * kNu, Nnx = N * kNx, npm = m + Nnu;
  const SingleTickOperands O = tick_flight(Og, blockIdx.x, m, Nnu, Nnx);
  const int m4 = round4(m);
  SECTION_START(t_whole);

  // shared memory layout (ops/tick_pallas.py single_tick_shared_memory_bytes):
  // the transaction barrier (16 bytes), then P1, va and vb 16-byte aligned
  [[maybe_unused]] unsigned long long* bar = reinterpret_cast<unsigned long long*>(sm);
  float* P1s = sm + 4;
  float* va = P1s + (kSharedP1 ? m * m : 0);   // ADMM matvec input, double-buffered
  float* vb = va + m4;
  float* z = vb + m4;
  float* y = z + m;
  float* p0 = y + m;
  float* lower = p0 + m;
  float* upper = lower + m;
  float* xw = upper + m;        // [x0 (6) | w (Nnx)]
  float* offset = xw + kNx + Nnx;
  float* dref = offset + Nnx;
  float* f = dref + Nnx;
  float* minvf = f + Nnu;
  float* U = minvf + Nnu;
  float* part = U + Nnu;        // matvec slices: max(nth, npm)
  float* anchor = part + max(nth, npm);   // x0 (condensed_solve's copy; unused here)

  if constexpr (kSharedP1) {
    if (tid == 0) {
      const unsigned bytes = 4u * static_cast<unsigned>(m * m);
      uav::barrier_init(bar, 1);
      uav::fence_barrier_init();
      uav::barrier_expect(bar, bytes);
      const char* src = reinterpret_cast<const char*>(O.P1);
      char* dst = reinterpret_cast<char*>(P1s);
      for (unsigned off = 0; off < bytes; off += kCopyChunk) {
        uav::copy_from_global(dst + off, src + off, min(bytes - off, (unsigned)kCopyChunk), bar);
      }
    }
  }
  SECTION_START(t_shift);
  auto wait_p1 = [&] {
    if constexpr (kSharedP1) {
      SECTION_START(t_wait);
      uav::barrier_wait(bar, 0);
      if (tid == 0) SECTION_ADD(0, t_wait);
    }
  };
  for (int i = tid; i < m; i += nth) {
    z[i] = O.z_in[i];
    y[i] = O.y_in[i];
  }
  if (tid < kNx) xw[tid] = O.x0[tid];
  for (int i = tid; i < Nnx; i += nth) xw[kNx + i] = O.w[i];
  __syncthreads();   // also publishes the barrier's initialisation
  uav::warm_shift(z, y, va, vb, N, m, tid, nth, uav::BlockBarrier{});
  if (tid == 0) SECTION_ADD(1, t_shift);

  const uav::CondensedOperands cops{O.SxSwT, O.SuTqT, O.PM, O.P0matT, O.SuT};
  const uav::TickVectors vec{kSharedP1 ? P1s : O.P1, O.lo_row, O.hi_row, O.ref, va, vb, z, y,
                             p0, lower, upper, xw, O.xtail_out, offset, dref, f, minvf, U,
                             part, anchor, O.tight};
  uav::condensed_solve<kSharedP1>(cops, vec, N, m, P.rho, P.over_relax, P.one_minus_over_relax,
                                  P.iterations, tid, nth, 2, wait_p1);
  if (warp == 0) {
    SECTION_START(t_scalar);
    const uav::Plant pl = uav::load_plant(O.plant_row);
    float s[12], sc[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      s[i] = O.state[i];
      sc[i] = O.x0[i];
    }
    const float z4[4] = {z[0], z[1], z[2], z[3]};
    const float ref3[3] = {O.ref[0], O.ref[1], O.ref[2]};
    const float integral[3] = {O.misc[1], O.misc[2], O.misc[3]};
    float sn[12], c[4], att_sp[3], new_int[3], accel[3];
    uav::mpc_command_plant_warp(P, pl, z4, ref3, sc, s, O.misc[0], integral, lane, sn, c, att_sp,
                                new_int, accel, [](const float*) {});
    if (lane == 0) {
      float* row = O.packed;   // 25 lanes
#pragma unroll
      for (int i = 0; i < 12; ++i) row[i] = sn[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) row[12 + i] = c[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) row[16 + i] = att_sp[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) row[19 + i] = new_int[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) row[22 + i] = accel[i];
      SECTION_ADD(8, t_scalar);
      SECTION_ADD(9, t_whole);
    }
  } else {
    const int ot = tid - 32, onth = nth - 32;
    for (int i = ot; i < m; i += onth) {
      O.z_out[i] = z[i];
      O.y_out[i] = y[i];
    }
    for (int c = ot; c < Nnu; c += onth) O.u_out[c] = U[c];
  }
}

// ---- K3 -----------------------------------------------------------------
//
// One block of 512 threads: K4's tick without the warm-start shift and the
// plant, its ADMM on P1's two factors, GM^-1 (P0matT) and Su' (SuT). The
// register variants load each thread's slices from device memory when the
// ADMM starts (SliceOperator); kFactorsL2 reads both factors through L2
// every step (FactoredOperator).
//
// Section clocks (K4's slots and three more, ops/controller_pallas.py
// CONTROLLER_SECTIONS): 2-7 the solve's six phases (the ADMM with the
// slices' loads), 10-12 the ADMM step's three, 9 the whole launch.
//
// The factors' variants of K3 and K6 (ops/controller_pallas.py
// FACTORS_L2 ...): each thread's slices in registers, of at most 36 / 20
// rows of GM^-1 / Su' (N <= 20) or 52 / 36 (N <= 25), or both factors read
// through L2 every step beyond.
constexpr int kFactorsL2 = 0, kFactorsRegs20 = 1, kFactorsRegs25 = 2;

template <int kVariant>
__global__ void __launch_bounds__(kTickThreads, 1)
controller_kernel(const __grid_constant__ SingleTickParams P,
                  const __grid_constant__ SingleTickOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x;
  constexpr int nth = kTickThreads;
  const int N = P.n, m = P.m, Nnu = N * kNu, Nnx = N * kNx, npm = m + Nnu;
  const int m4 = round4(m);
  SECTION_START(t_whole);

  // shared memory layout (ops/controller_pallas.py
  // controller_shared_memory_bytes): va, vb and t 16-byte aligned
  float* va = sm;               // ADMM matvec input, double-buffered
  float* vb = va + m4;
  float* ts = vb + m4;          // t = v GM^-1
  float* z = ts + Nnu;
  float* y = z + m;
  float* p0 = y + m;
  float* lower = p0 + m;
  float* upper = lower + m;
  float* xw = upper + m;        // [x0 (6) | w (Nnx)]
  float* offset = xw + kNx + Nnx;
  float* dref = offset + Nnx;
  float* f = dref + Nnx;
  float* minvf = f + Nnu;
  float* U = minvf + Nnu;
  float* part = U + Nnu;        // matvec slices: max(nth, npm)
  float* anchor = part + max(nth, npm);   // x0 (condensed_solve's copy; unused here)

  for (int i = tid; i < m; i += nth) {
    z[i] = O.z_in[i];
    y[i] = O.y_in[i];
  }
  if (tid < kNx) xw[tid] = O.x0[tid];
  for (int i = tid; i < Nnx; i += nth) xw[kNx + i] = O.w[i];
  __syncthreads();

  const uav::CondensedOperands cops{O.SxSwT, O.SuTqT, O.PM, O.P0matT, O.SuT};
  const uav::TickVectors vec{nullptr, O.lo_row, O.hi_row, O.ref, va, vb, z, y, p0, lower, upper,
                             xw, O.xtail_out, offset, dref, f, minvf, U, part, anchor};
  auto solve = [&](auto op) {
    uav::condensed_solve(cops, vec, N, m, P.rho, P.over_relax, P.one_minus_over_relax,
                         P.iterations, tid, nth, 2, uav::NoWait{}, op);
  };
  if constexpr (kVariant == kFactorsRegs20) {
    solve(uav::SliceOperator<36, 20>{O.P0matT, O.SuT, ts, 10});
  } else if constexpr (kVariant == kFactorsRegs25) {
    solve(uav::SliceOperator<52, 36>{O.P0matT, O.SuT, ts, 10});
  } else {
    solve(uav::FactoredOperator{O.P0matT, O.SuT, ts, 10});
  }
  for (int i = tid; i < m; i += nth) {
    O.z_out[i] = z[i];
    O.y_out[i] = y[i];
  }
  for (int c = tid; c < Nnu; c += nth) O.u_out[c] = U[c];
  if (tid == 0) SECTION_ADD(9, t_whole);
}

// ---- K6 on the factors --------------------------------------------------
//
// One block of 512 threads: `iterations` factored steps and U = -M^-1 f +
// t of the final (z, y). G = [I; Su]: n rows of I over m - n rows of Su,
// GM^-1 given as its transpose GMinvT (n x m, the JAX operand) and Su' as
// SuT (n x (m - n)). The register variants load each thread's slices
// straight from device memory (GMinvT's rows 8 bytes a load, m even) while
// nothing else is left to run; kFactorsL2 reads both factors through L2
// every step, t as row dots (factor_t's row form). The factors never enter
// shared memory.
//
// Section clocks (K4's slots, ops/admm_pallas.py COMPOSITE_SECTIONS): 5
// the ADMM (the slices' loads included), 10-12 its three phases, 6 U, 9 the
// whole launch.
template <int kVariant>
__global__ void __launch_bounds__(kTickThreads, 1)
admm_factored_kernel(const __grid_constant__ AdmmParams P,
                     const __grid_constant__ AdmmOperands Og) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x;
  constexpr int nth = kTickThreads;
  const int n = P.n, m = P.m;
  const AdmmOperands O = admm_flight(Og, blockIdx.x, n, m);
  SECTION_START(t_whole);

  // shared memory layout (ops/admm_pallas.py factored_shared_memory_bytes):
  // va, vb and t 16-byte aligned, five m-vectors and the slices
  float* va = sm;
  float* vb = va + round4(m);
  float* ts = vb + round4(m);
  float* z = ts + round4(n);
  float* y = z + m;
  float* p0 = y + m;
  float* lower = p0 + m;
  float* upper = lower + m;
  float* part = upper + m;      // the products' slices: nth

  for (int i = tid; i < m; i += nth) {
    z[i] = O.z_in[i];
    y[i] = O.y_in[i];
    p0[i] = O.p0[i];
    lower[i] = O.lower[i];
    upper[i] = O.upper[i];
    va[i] = P.rho * z[i] - y[i];
  }
  __syncthreads();
  const auto emit_u = [&](int c, float t) { O.u_out[c] = -O.minvf[c] + t; };
  SECTION_START(t_admm);
  auto slices = [&](auto& sl) {
    uav::load_factor_slices<true>(sl, O.GMinvT, m, O.SuT, m, n, tid, nth);
    const float* vsrc = uav::factored_admm_slices(sl, m, n, p0, lower, upper, z, y, va, vb, ts,
                                                  part, P.rho, P.over_relax,
                                                  P.one_minus_over_relax, P.iterations, tid,
                                                  nth, 10);
    SECTION_START(t_u);
    if (tid == 0) SECTION_ADD(5, t_admm);
    uav::slices_t(sl, vsrc, n, part, tid, nth, emit_u);
    __syncthreads();
    if (tid == 0) SECTION_ADD(6, t_u);
  };
  if constexpr (kVariant == kFactorsRegs20) {
    uav::FactorSlices<36, 20> sl;
    slices(sl);
  } else if constexpr (kVariant == kFactorsRegs25) {
    uav::FactorSlices<52, 36> sl;
    slices(sl);
  } else {
    const float* vsrc = uav::factored_admm<true>(
        O.GMinvT, m, O.SuT, m, n, p0, lower, upper, z, y, va, vb, ts, part, P.rho,
        P.over_relax, P.one_minus_over_relax, P.iterations, tid, nth, 10);
    SECTION_START(t_u);
    if (tid == 0) SECTION_ADD(5, t_admm);
    uav::factor_t<true>(vsrc, O.GMinvT, m, m, n, part, tid, nth, emit_u);
    __syncthreads();
    if (tid == 0) SECTION_ADD(6, t_u);
  }
  for (int i = tid; i < m; i += nth) {
    O.z_out[i] = z[i];
    O.y_out[i] = y[i];
  }
  if (tid == 0) SECTION_ADD(9, t_whole);
}

// Raise the block's shared-memory limit once per size and instantiation
// (a host-side call, kept out of the per-launch path and out of CUDA graph
// captures), then launch `blocks` blocks (K4 and K6: one per flight; the
// others one) on `stream`.
template <class Params, class Operands>
int launch_blocks(void (*kernel)(const Params, const Operands), int* configured,
                  const Params* params, const Operands* ops, int smem_bytes, void* stream,
                  int threads = kThreads, int blocks = 1) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  if (smem_bytes > *configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    *configured = smem_bytes;
  }
  kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(*params, *ops);
  return (int)cudaGetLastError();
}

int configured_bytes[14] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1};

}  // namespace

extern "C" int admm_composite_launch(const AdmmParams* params, const AdmmOperands* ops,
                                     int p1_shared, int smem_bytes, void* stream) {
  return p1_shared ? launch_blocks(admm_composite_kernel<true>, &configured_bytes[0], params,
                                   ops, smem_bytes, stream)
                   : launch_blocks(admm_composite_kernel<false>, &configured_bytes[1],
                                   params, ops, smem_bytes, stream);
}

// K6 on P1's factors (ops->SuT set) for `flights` QPs, one block each:
// `variant` is one of the factors' variants (kFactorsL2, kFactorsRegs20,
// kFactorsRegs25).
extern "C" int admm_factored_launch(const AdmmParams* params, const AdmmOperands* ops,
                                    int variant, int smem_bytes, int flights, void* stream) {
  switch (variant) {
    case kFactorsRegs20:
      return launch_blocks(admm_factored_kernel<kFactorsRegs20>, &configured_bytes[8], params,
                           ops, smem_bytes, stream, kTickThreads, flights);
    case kFactorsRegs25:
      return launch_blocks(admm_factored_kernel<kFactorsRegs25>, &configured_bytes[10], params,
                           ops, smem_bytes, stream, kTickThreads, flights);
    default:
      return launch_blocks(admm_factored_kernel<kFactorsL2>, &configured_bytes[9], params, ops,
                           smem_bytes, stream, kTickThreads, flights);
  }
}

extern "C" int gpmpc_controller_launch(const SingleTickParams* params,
                                       const SingleTickOperands* ops, int variant,
                                       int smem_bytes, void* stream) {
  switch (variant) {
    case kFactorsRegs20:
      return launch_blocks(controller_kernel<kFactorsRegs20>, &configured_bytes[2], params,
                           ops, smem_bytes, stream, kTickThreads);
    case kFactorsRegs25:
      return launch_blocks(controller_kernel<kFactorsRegs25>, &configured_bytes[11], params,
                           ops, smem_bytes, stream, kTickThreads);
    default:
      return launch_blocks(controller_kernel<kFactorsL2>, &configured_bytes[3], params, ops,
                           smem_bytes, stream, kTickThreads);
  }
}

// K4 for `flights` flights, one block each.
extern "C" int gpmpc_tick_launch(const SingleTickParams* params, const SingleTickOperands* ops,
                                 int p1_shared, int smem_bytes, int flights, void* stream) {
  return p1_shared ? launch_blocks(gpmpc_tick_kernel<true>, &configured_bytes[4], params, ops,
                                   smem_bytes, stream, kTickThreads, flights)
                   : launch_blocks(gpmpc_tick_kernel<false>, &configured_bytes[5], params, ops,
                                   smem_bytes, stream, kTickThreads, flights);
}

// The section counters of K4 (ops/tick_pallas.py SINGLE_TICK_SECTIONS), K3
// and K6 on the factors (their slots among K4's) summed since the last
// call, then reset (section_clocks.cuh).
extern "C" int single_tick_section_cycles(unsigned long long* out) {
  return uav::read_section_cycles(out, 13);
}

// K14: `variant` 1, 2 or 3, the register slices of 3 columns a lane and 6
// rows of M^-1 (n <= 96), 4 and 7 (n <= 112) or 4 and 8 (n <= 128); or 0,
// the slices read where used (params->shared_slices: from copies in shared
// memory). ops/admm_pallas.py EXPLICIT_REG_VARIANTS.
extern "C" int admm_explicit_launch(const ExplicitParams* params, const ExplicitOperands* ops,
                                    int variant, int smem_bytes, void* stream) {
  switch (variant) {
    case 1:
      return launch_blocks(admm_explicit_kernel<3, 6>, &configured_bytes[6], params, ops,
                           smem_bytes, stream, kTickThreads);
    case 2:
      return launch_blocks(admm_explicit_kernel<4, 7>, &configured_bytes[7], params, ops,
                           smem_bytes, stream, kTickThreads);
    case 3:
      return launch_blocks(admm_explicit_kernel<4, 8>, &configured_bytes[13], params, ops,
                           smem_bytes, stream, kTickThreads);
    default:
      return launch_blocks(admm_explicit_kernel<0, 0>, &configured_bytes[12], params, ops,
                           smem_bytes, stream, kTickThreads);
  }
}
