// The single-tick fused kernels, one thread block per call:
//
//   K14 admm_explicit_kernel  replaces the JAX package's
//      ops/admm_pallas.py:admm_box_qp_fused (pallas_call at :107, body
//      _make_kernel at :28): `iterations` over-relaxed ADMM steps of the box
//      QP with an explicit M^-1, rhs = -f + (rho z - y) G, u = rhs M^-1,
//      Gu = G u, relaxation, clip and dual step, then one more u from the
//      final (z, y). Plain version:
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
// and, in K4, the one-warp RK4. The bound from the card's rates (bytes
// over 3.35 TB/s, operations over 67 TFLOP/s) is well under a
// microsecond; a batch of flights (a grid of blocks) is what would
// approach it.
//
// Every sum runs in a fixed order, so two launches agree bit for bit.

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

using uav::matvec_partial;
using uav::matvec_total;

constexpr int kThreads = 256;       // ops/admm_pallas.py KERNEL_THREADS: K14, K6 on P1
constexpr int kTickThreads = 512;   // ops/tick_pallas.py SINGLE_TICK_THREADS: K4, K3, K6 factored
constexpr int kNu = 4;
constexpr int kNx = 6;

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

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

// K14. M^-1 (n x n) and G (m x n) lie in shared memory (kShared: 140 KB at
// the staged MPC's N=25, n=100, m=250) or are read through L1/L2. G serves
// both products: rhs = (rho z - y) G as column dots (matvec_partial, the
// column sums split over the threads) and Gu = G u as one row dot per
// thread. In shared memory G's rows are stored with an odd stride, so the
// threads of a warp, each on its own row, read from distinct banks. Every
// sum runs in a fixed order. What bounds it: one block on one SM; per
// iteration 2 n m + n^2 multiply-adds (60,000 at N=25) over five barriers,
// so latency, not the card's rates.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
admm_explicit_kernel(const ExplicitParams P, const ExplicitOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int n = P.n, m = P.m;
  const int ldg = kShared ? (n | 1) : n;
  const float rho = P.rho;

  // shared memory layout (ops/admm_pallas.py explicit_shared_memory_bytes)
  float* Minv_s = sm;
  float* G_s = Minv_s + (kShared ? n * n : 0);
  float* z = G_s + (kShared ? m * ldg : 0);
  float* y = z + m;
  float* v = y + m;             // rho z - y
  float* lower = v + m;
  float* upper = lower + m;
  float* f = upper + m;
  float* rhs = f + n;
  float* u = rhs + n;
  float* part = u + n;          // matvec slices: max(nth, n)

  if constexpr (kShared) {
    for (int i = tid; i < n * n; i += nth) Minv_s[i] = __ldg(O.Minv + i);
    for (int i = tid; i < m * n; i += nth) {
      const int r = i / n, c = i - r * n;
      G_s[r * ldg + c] = __ldg(O.G + i);
    }
  }
  const float* Minv = kShared ? Minv_s : O.Minv;
  const float* G = kShared ? G_s : O.G;
  for (int i = tid; i < m; i += nth) {
    z[i] = O.z_in[i];
    y[i] = O.y_in[i];
    lower[i] = O.lower[i];
    upper[i] = O.upper[i];
    v[i] = rho * z[i] - y[i];
  }
  for (int i = tid; i < n; i += nth) f[i] = O.f[i];
  __syncthreads();

  // iteration `iterations` only forms the final primal
  for (int it = 0;; ++it) {
    // rhs = -f + (rho z - y) G
    matvec_partial(v, G, ldg, m, n, part, tid, nth);
    __syncthreads();
    for (int c = tid; c < n; c += nth) rhs[c] = -f[c] + matvec_total(part, n, nth, c);
    __syncthreads();
    // u = rhs M^-1
    matvec_partial(rhs, Minv, n, n, n, part, tid, nth);
    __syncthreads();
    for (int c = tid; c < n; c += nth) u[c] = matvec_total(part, n, nth, c);
    __syncthreads();
    if (it == P.iterations) break;
    // Gu = G u, over-relaxation, box projection, dual step
    for (int j = tid; j < m; j += nth) {
      const float* row = G + j * ldg;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int c = 0;
      for (; c + 4 <= n; c += 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += row[c + q] * u[c + q];
      }
      if (c < n) acc[0] += row[c] * u[c];
      if (c + 1 < n) acc[1] += row[c + 1] * u[c + 1];
      if (c + 2 < n) acc[2] += row[c + 2] * u[c + 2];
      const float gu = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      const float Gt = P.over_relax * gu + P.one_minus_over_relax * z[j];
      const float zn = uav::clipf(Gt + y[j] / rho, lower[j], upper[j]);
      const float yn = y[j] + rho * (Gt - zn);
      z[j] = zn;
      y[j] = yn;
      v[j] = rho * zn - yn;
    }
    __syncthreads();
  }
  for (int c = tid; c < n; c += nth) O.u_out[c] = u[c];
  for (int i = tid; i < m; i += nth) {
    O.z_out[i] = z[i];
    O.y_out[i] = y[i];
  }
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
                  const __grid_constant__ SingleTickOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int nth = kTickThreads;
  const int N = P.n, m = P.m, Nnu = N * kNu, Nnx = N * kNx, npm = m + Nnu;
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
                     const __grid_constant__ AdmmOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x;
  constexpr int nth = kTickThreads;
  const int n = P.n, m = P.m;
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
// captures), then launch one block on `stream`.
template <class Params, class Operands>
int launch_one_block(void (*kernel)(const Params, const Operands), int* configured,
                     const Params* params, const Operands* ops, int smem_bytes, void* stream,
                     int threads = kThreads) {
  if (smem_bytes > *configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    *configured = smem_bytes;
  }
  kernel<<<1, threads, smem_bytes, (cudaStream_t)stream>>>(*params, *ops);
  return (int)cudaGetLastError();
}

int configured_bytes[12] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1};

}  // namespace

extern "C" int admm_composite_launch(const AdmmParams* params, const AdmmOperands* ops,
                                     int p1_shared, int smem_bytes, void* stream) {
  return p1_shared ? launch_one_block(admm_composite_kernel<true>, &configured_bytes[0], params,
                                      ops, smem_bytes, stream)
                   : launch_one_block(admm_composite_kernel<false>, &configured_bytes[1],
                                      params, ops, smem_bytes, stream);
}

// K6 on P1's factors (ops->SuT set) and K3: `variant` is one of the
// factors' variants (kFactorsL2, kFactorsRegs20, kFactorsRegs25).
extern "C" int admm_factored_launch(const AdmmParams* params, const AdmmOperands* ops,
                                    int variant, int smem_bytes, void* stream) {
  switch (variant) {
    case kFactorsRegs20:
      return launch_one_block(admm_factored_kernel<kFactorsRegs20>, &configured_bytes[8],
                              params, ops, smem_bytes, stream, kTickThreads);
    case kFactorsRegs25:
      return launch_one_block(admm_factored_kernel<kFactorsRegs25>, &configured_bytes[10],
                              params, ops, smem_bytes, stream, kTickThreads);
    default:
      return launch_one_block(admm_factored_kernel<kFactorsL2>, &configured_bytes[9], params,
                              ops, smem_bytes, stream, kTickThreads);
  }
}

extern "C" int gpmpc_controller_launch(const SingleTickParams* params,
                                       const SingleTickOperands* ops, int variant,
                                       int smem_bytes, void* stream) {
  switch (variant) {
    case kFactorsRegs20:
      return launch_one_block(controller_kernel<kFactorsRegs20>, &configured_bytes[2], params,
                              ops, smem_bytes, stream, kTickThreads);
    case kFactorsRegs25:
      return launch_one_block(controller_kernel<kFactorsRegs25>, &configured_bytes[11], params,
                              ops, smem_bytes, stream, kTickThreads);
    default:
      return launch_one_block(controller_kernel<kFactorsL2>, &configured_bytes[3], params, ops,
                              smem_bytes, stream, kTickThreads);
  }
}

extern "C" int gpmpc_tick_launch(const SingleTickParams* params, const SingleTickOperands* ops,
                                 int p1_shared, int smem_bytes, void* stream) {
  return p1_shared ? launch_one_block(gpmpc_tick_kernel<true>, &configured_bytes[4], params, ops,
                                      smem_bytes, stream, kTickThreads)
                   : launch_one_block(gpmpc_tick_kernel<false>, &configured_bytes[5], params, ops,
                                      smem_bytes, stream, kTickThreads);
}

// The section counters of K4 (ops/tick_pallas.py SINGLE_TICK_SECTIONS), K3
// and K6 on the factors (their slots among K4's) summed since the last
// call, then reset (section_clocks.cuh).
extern "C" int single_tick_section_cycles(unsigned long long* out) {
  return uav::read_section_cycles(out, 13);
}

extern "C" int admm_explicit_launch(const ExplicitParams* params, const ExplicitOperands* ops,
                                    int shared, int smem_bytes, void* stream) {
  return shared ? launch_one_block(admm_explicit_kernel<true>, &configured_bytes[6], params,
                                   ops, smem_bytes, stream)
                : launch_one_block(admm_explicit_kernel<false>, &configured_bytes[7], params,
                                   ops, smem_bytes, stream);
}
