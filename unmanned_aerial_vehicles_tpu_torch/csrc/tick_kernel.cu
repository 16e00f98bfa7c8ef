// K5: K whole GP-MPC control ticks of one flight in one launch.
//
// Replaces the JAX package's ops/tick_pallas.py:gpmpc_multitick_fused
// (pallas_call at :786). Its plain version is the port's
// ops/tick_pallas.py:multitick_staged.
//
// Design: one thread block per flight; the K ticks are a loop inside the
// block, so the carries (state, previous x0 + attitude integral, X_tail,
// ADMM slack z and dual y) stay in shared memory for the whole launch and
// nothing but the packed per-tick rows and the final carries goes back to
// device memory. P1 = G M^-1 G' (m x m, 160 KB at N=20) is copied into
// dynamic shared memory once per launch; the other condensed matrices
// (~290 KB at N=20) and the GP operands (~45 KB at P=800) are read through
// L1/L2 every tick.
//
// The per-tick phases (GP, shift, condensed solve: multitick_phases.cuh)
// are the same device code that the noisy kernel K9 runs
// (noisy_tick_kernel.cu), and the shift and the solve the single-tick
// kernel K4's (single_tick_kernels.cu); the scalar section is
// plant_math.cuh's mpc_command_plant_warp, which all three run.
//
// The untightened kernel runs on 512 threads (16 warps, one block on one
// SM). A tick is the solve on the whole block, then one phase where warp 0
// runs this tick's scalar section while warps 1-15 run the next tick's GP
// and shift, joined by one block barrier:
//   solve  offset = [x0, w] @ [Sx'; Sw'],  f = (offset - ref) @ (Su'Q)',
//          box bounds, p0 = -(f @ P0mat), M^-1 f; the ADMM, `iterations`
//          x one (m, m) matvec from shared memory, thread j owning column
//          j; U, X_tail. Each product with a fixed operator splits a
//          column over nth / n_out threads (block_linalg.cuh).
//   warp 0 reads z[0:4] and X_tail[3:6], lets the shift run (a named
//          barrier's arrive), and runs the clips, hover fallback,
//          allocation + attitude PID and the plant's RK4 substeps with the
//          sines and divisions spread over its lanes, and writes the packed
//          row and the carries;
//   warps 1-15 form the GP horizon mean of tick t+1: it reads only what
//          the solve of tick t fixed (x0, X_tail, the unshifted slack), so
//          it need not wait for the plant. A thread loads every S-th
//          training point once for a group of 4 stages; 8-lane groups meet
//          in a shuffle tree and the groups' sums are added in order. Then
//          the warm start moves one stage forward. Tick 0's GP runs before
//          the loop; none runs after tick K-1.
//
// What bounds it on an H100: at N=20, P=800 one tick is about 0.73 M
// multiply-adds (GP ~0.26 M, 10 ADMM iterations 0.4 M, the rest ~0.07 M):
// ~3 us at one SM's 128 FP32 FMA per clock. One block uses one SM of 132:
// the kernel is latency-bound by design for one flight. By the section
// clocks (the tick_clocks build; PERF.md) what is left is the solve: the
// ADMM steps, each ~3,600 clocks against P1's 1,250 of shared-memory
// traffic (every warp also reads the whole input), and the five products
// with the fixed operators (~290 KB a tick), which arrive at an SM's rate
// of reads from L2 whatever the block's width. The overlap takes the
// one-warp plant and the GP off each other's path. Measured slower on the
// card and not kept (PERF.md): 1024 threads, the ADMM's column split over
// lanes or warps or several columns a thread, and the operators copied
// through shared memory in bulk or held in a cluster's other blocks.
//
// With tighten_kappa > 0 (the kTighten instantiation) each tick also runs
// the variance section between the shift and the solve: the GP section
// leaves K* (N x P) in a workspace in device memory, and the section forms
// the posterior variance K* K^-1 K*' from the cached K^-1 and the box
// back-off that the solve's bounds take (multitick_phases.cuh). It is N P^2
// multiply-adds per tick (12.8 M at N = 20, P = 800), ~17x the rest of the
// tick: on the tick's one SM, bound by that SM's FMA rate (~57 us per tick
// at best), it took ~247 us (H100 80GB HBM3, 700 W; PERF.md). So the
// tightened K5 launches a thread-block cluster (csrc/cluster.cuh) per
// flight: 16 blocks where the card runs such a cluster (a non-portable
// size; measured faster than 8 on the H100, PERF.md), 8 otherwise, of 256
// threads each (the workers' variance loop holds ~100 live floats a thread,
// which a 1024-thread block's 64 registers would spill). Rank 0 runs the
// tick as the untightened kernel does, on its 256 threads; the other ranks
// are variance workers that loop over the launch's K ticks beside it. Rank
// 0's GP warps write K* and arrive at a cluster barrier (release: the
// workers then read K* through L2) before they shift; at the next tick rank
// 0 waits there, meets the workers at a second barrier once their partial
// sums over equal shares of K^-1's upper triangle are done (half of N P^2:
// K^-1 is symmetric; ~0.43 M multiply-adds each for 15 workers at N = 20,
// P = 800), adds their sums in rank order through distributed shared memory
// and forms the back-off. K^-1 is fixed within a launch (refits happen
// between launches): a worker keeps its share of the triangle in its shared
// memory where it fits (P = 800: ~85 KB for 15 workers) and streams it from
// L2 otherwise. K* stays in device memory (64 KB at N = 20, P = 800: it
// does not fit beside rank 0's tick). Rank 0's layout holds only the
// variance row and the back-off row, so the tightened kernel reaches the
// untightened one's horizon (N <= 23 on an H100).
//
// loop_precision: both modes compute in float32 with FMAs here. Every sum
// runs in a fixed order, so a second launch is bit-identical.
//
// A population (loop/closed_loop.py batched_mpc_flight_rollout) launches
// the untightened kernel as a grid of one block per flight: block b reads
// and writes flight b's rows of the carries, the plant block and the
// outputs (flight_operands) and shares the operators, the GP rows and the
// references, so each block runs the one-flight arithmetic and agrees with
// a one-flight launch bit for bit. At N = 20 a block's shared memory
// (~176 KB) leaves one block an SM: 256 flights run in two waves over an
// H100's 132 SMs. The tightened cluster kernel takes one flight.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "multitick_phases.cuh"
#include "plant_math.cuh"

// Host-visible (external linkage): the C entry point takes pointers to
// these, laid out as ops/tick_pallas.py's _TickParams / _TickOperands.
struct TickParams {
  int k_ticks, n, m, n_train, use_gp, iterations, substeps, use_fallback, tighten;
  int var_kinv_shared;   // the workers keep their share of K^-1 in shared memory
  int var_rows[16];      // worker r takes the triangle's rows [var_rows[r - 1], var_rows[r])
  double dt;
  float rho, over_relax, one_minus_over_relax, yawrate_limit;
  float fallback_error_sq, fallback_thrust_ceiling, tighten_kappa;
  float accel_lo[3], accel_hi[3], fallback_lo[3], fallback_hi[3];
};

struct TickOperands {
  const float *SxSwT, *SuTqT, *PM, *P1, *P0matT, *SuT, *lo_row, *hi_row;
  const float *ztrT, *sq2, *alpha_s, *y_mean, *inv_ls, *scal;
  const float *kinv, *y_std, *SwSqT;
  float* kst_ws;
  const float *state_in, *aux_in, *xtail_in, *z_in, *y_in, *refs, *yaw_refs, *plant_row;
  float *packed, *state_out, *aux_out, *xtail_out, *z_out, *y_out;
  float* tight_out;   // (K, m) each tick's back-off row, or nullptr
};

namespace {

// Flight b's operands: its rows of the carries in and out, the plant block
// and the packed rows (K x 32).
__device__ __forceinline__ TickOperands flight_operands(const TickOperands& O, int b, int k_ticks,
                                                        int m, int Nnx) {
  TickOperands F = O;
  F.state_in += b * 12;
  F.aux_in += b * 9;
  F.xtail_in += b * Nnx;
  F.z_in += b * m;
  F.y_in += b * m;
  F.plant_row += b * 10;
  F.packed += b * k_ticks * 32;
  F.state_out += b * 12;
  F.aux_out += b * 9;
  F.xtail_out += b * Nnx;
  F.z_out += b * m;
  F.y_out += b * m;
  return F;
}

constexpr int kThreads = 512;              // ops/tick_pallas.py KERNEL_THREADS
constexpr int kTightThreads = 256;         // TIGHT_KERNEL_THREADS: the tightened cluster's blocks
// the GP's lanes whose sums meet in a shuffle tree (GP_GROUP, TIGHT_GP_GROUP)
// and its stages per thread (GP_STAGES; the tightened rank 0: 1)
template <bool kTighten>
constexpr int kGpGroup = kTighten ? 1 : 8;
template <bool kTighten>
constexpr int kGpStages = kTighten ? 1 : 4;
constexpr int kGPBarrier = 1;     // named barrier of warps 1.. (0 is __syncthreads)
constexpr int kShiftBarrier = 2;  // warp 0 has read z[0:4] and X_tail: the shift may run
constexpr int kNu = 4;
constexpr int kNx = 6;
constexpr int kFeat = uav::kTickFeat;
constexpr int kPacked = 32;
constexpr int kAux = 9;

// Section clocks (multitick_phases.cuh; the library tick_clocks, which
// chip_smoke.py reads for its breakdown). Sections (ops/tick_pallas.py
// TICK_SECTIONS): the GP (warps 1..), the shift, the solve, the scalar
// section (warp 0), the whole tick, then the solve's six phases (offset, f,
// p0 and M^-1 f, the ADMM, U, X_tail).
constexpr int kSections = 11;

// The scalar section of tick t on warp 0: u0 clips, hover fallback,
// allocation + attitude PID and the plant's RK4 substeps
// (mpc_command_plant_warp), then lane 0 writes the packed row, the state
// and aux carries and x0 of the next tick's solve into xw. z4 and xt3 (the
// slack's first stage, X_tail[3:6]) were read before the shift could move
// them.
__device__ __forceinline__ void scalar_tick_warp(const TickParams& P, const TickOperands& O,
                                                 int t, const float z4[4], const float xt3[3],
                                                 const float* ref, float* st, float* aux,
                                                 float* xw, int lane) {
  const uav::Plant pl = uav::load_plant(O.plant_row);
  float s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = st[i];
  const float integral[3] = {aux[6], aux[7], aux[8]};
  const float ref3[3] = {ref[0], ref[1], ref[2]};
  const float yaw_ref = O.yaw_refs[t];
  __syncwarp();   // every lane has read st and aux before lane 0 rewrites them
  float sn[12], c[4], att_sp[3], new_int[3], accel[3];
  uav::mpc_command_plant_warp(P, pl, z4, ref3, s, s, yaw_ref, integral, lane, sn, c, att_sp,
                              new_int, accel, [](const float*) {});
  if (lane == 0) {
    float* row = O.packed + t * kPacked;
#pragma unroll
    for (int i = 0; i < 12; ++i) row[i] = s[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) row[12 + i] = c[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) row[16 + i] = att_sp[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) row[19 + i] = new_int[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) row[22 + i] = accel[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) row[25 + i] = z4[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) row[29 + i] = xt3[i];
#pragma unroll
    for (int i = 0; i < 12; ++i) st[i] = sn[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      aux[i] = s[i];
      xw[i] = sn[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) aux[6 + i] = new_int[i];
  }
}

// A variance worker (cluster rank >= 1) of the tightened K5: K ticks of
// its share of the quadratic form, in step with rank 0 (two cluster
// barriers a tick, one more at the end).
template <int kS, bool kShared>
__device__ void variance_worker_ticks(const TickParams& P, const TickOperands& O, float* sm,
                                      int tid, int q0, int q1) {
  const int N = P.n, n_train = P.n_train;
  float* quad_out = sm;                    // read by rank 0
  float* wsum = sm + uav::kMaxVarStages;
  float* rows = sm + uav::kVarHead;        // 16-byte aligned
  const int rows_pad = (q1 - q0 + uav::kVarRows - 1) / uav::kVarRows * uav::kVarRows;
  float* share = rows + rows_pad * kS;
  for (int i = tid; i < rows_pad * kS; i += kTightThreads) rows[i] = 0.0f;
  if (tid < uav::kMaxVarStages) quad_out[tid] = 0.0f;
  if constexpr (kShared) {
    // the share's rows packed (row q: columns q .. P - 1), eight loads in
    // flight per thread; q follows the thread's rising index
    const int entries = uav::packed_row(q1, q0, n_train);
    int q = q0;
    for (int i0 = tid; i0 < entries; i0 += 8 * kTightThreads) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kTightThreads;
        v[u] = 0.0f;
        if (i < entries) {
          while (uav::packed_row(q + 1, q0, n_train) <= i) ++q;
          v[u] = __ldg(O.kinv + static_cast<size_t>(q) * n_train + q +
                       (i - uav::packed_row(q, q0, n_train)));
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + u * kTightThreads < entries) share[i0 + u * kTightThreads] = v[u];
      }
    }
  }
  __syncthreads();
  for (int t = 0; t < P.k_ticks; ++t) {
    uav::cluster_sync();   // rank 0 has written this tick's K*
    uav::variance_share<kS, kShared, kTightThreads>(O.kinv, O.kst_ws, share, N, n_train, q0, q1,
                                                    rows, wsum, quad_out, tid);
    uav::cluster_sync();   // quad_out holds this tick's partial sums
  }
  uav::cluster_sync();     // rank 0 is done reading quad_out
}

__device__ __noinline__ void variance_worker(const TickParams& P, const TickOperands& O,
                                             float* sm, int tid) {
  const int rank = static_cast<int>(uav::cluster_rank());
  const int q0 = P.var_rows[rank - 1], q1 = P.var_rows[rank];
  const bool shared = P.var_kinv_shared != 0;
#define UAV_VAR_WORKER(S)                                                    \
  return shared ? variance_worker_ticks<S, true>(P, O, sm, tid, q0, q1)     \
                : variance_worker_ticks<S, false>(P, O, sm, tid, q0, q1)
  switch ((P.n + 3) / 4) {
    case 1: UAV_VAR_WORKER(4);
    case 2: UAV_VAR_WORKER(8);
    case 3: UAV_VAR_WORKER(12);
    case 4: UAV_VAR_WORKER(16);
    case 5: UAV_VAR_WORKER(20);
    default: UAV_VAR_WORKER(24);
  }
#undef UAV_VAR_WORKER
}

template <int kNth, bool kTighten>
__global__ void __launch_bounds__(kNth, 1)
gpmpc_multitick_kernel(const __grid_constant__ TickParams P,
                       const __grid_constant__ TickOperands Og) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int nth = kNth, gp_nth = kNth - 32;   // warps 1.. run the GP and the shift
  if constexpr (kTighten) {
    if (uav::cluster_rank() != 0) {
      variance_worker(P, Og, sm, tid);
      return;
    }
  }
  const int N = P.n, m = P.m, Nnu = N * kNu, Nnx = N * kNx, npm = m + Nnu;
  // the tightened kernel's grid is one flight's cluster
  const TickOperands O = flight_operands(Og, kTighten ? 0 : blockIdx.x, P.k_ticks, m, Nnx);
  const int m4 = (m + 3) & ~3;

  // shared memory layout (ops/tick_pallas.py shared_memory_bytes); P1, va
  // and vb start 16-byte aligned (m * m and m4 are multiples of 4)
  float* P1s = sm;
  float* va = P1s + m * m;      // ADMM matvec input, double-buffered
  float* vb = va + m4;
  float* z = vb + m4;
  float* y = z + m;
  float* p0 = y + m;
  float* lo = p0 + m;
  float* hi = lo + m;
  float* lower = hi + m;
  float* upper = lower + m;
  float* xw = upper + m;        // [x0 (6) | w (Nnx)]
  float* wv = xw + kNx;
  float* xtail = wv + Nnx;
  float* offset = xtail + Nnx;
  float* ref = offset + Nnx;
  float* dref = ref + Nnx;
  float* f = dref + Nnx;
  float* minvf = f + Nnu;
  float* U = minvf + Nnu;
  float* part = U + Nnu;        // matvec and ADMM slices: max(nth, npm)
  float* zf = part + max(nth, npm);
  float* red = zf + N * kFeat;  // the GP's group sums: 3 per group of GP threads
  float* st = red + 3 * (gp_nth / kGpGroup<kTighten>) * kGpStages<kTighten>;
  float* aux = st + 12;
  float* anchor = aux + kAux;   // x0 of the GP's stage 0
  float* sig = anchor + kNx;    // the variance section's rows (kTighten)
  float* tight = sig + Nnx;

  {
    const float4* src = reinterpret_cast<const float4*>(O.P1);
    float4* dst = reinterpret_cast<float4*>(P1s);
#pragma unroll 4
    for (int i = tid; i < (m * m) / 4; i += nth) dst[i] = __ldg(src + i);
  }
  for (int i = tid; i < m; i += nth) {
    z[i] = O.z_in[i];
    y[i] = O.y_in[i];
    lo[i] = O.lo_row[i];
    hi[i] = O.hi_row[i];
  }
  for (int i = tid; i < Nnx; i += nth) {
    xtail[i] = O.xtail_in[i];
    wv[i] = 0.0f;               // the GP's rows (zero without the GP)
  }
  if (tid < 12) st[tid] = O.state_in[tid];
  if (tid < kAux) aux[tid] = O.aux_in[tid];
  if (tid < kNx) {
    anchor[tid] = O.aux_in[tid];
    xw[tid] = O.state_in[tid];
  }
  __syncthreads();

  const uav::GPOperands gp{O.ztrT, O.sq2, O.alpha_s, O.y_mean, O.inv_ls, O.scal, P.n_train};
  const uav::CondensedOperands cops{O.SxSwT, O.SuTqT, O.PM, O.P0matT, O.SuT};
  const uav::VarianceOperands var{O.kinv, O.y_std, O.SwSqT, O.scal, P.tighten_kappa};
  const uav::TickVectors vec{P1s,   lo,    hi,     ref,  va,    vb,    z, y, p0,   lower, upper,
                             xw,    xtail, offset, dref, f,     minvf, U, part, anchor,
                             kTighten ? tight : nullptr};
  const uav::NamedBarrier gp_bar{kGPBarrier, gp_nth};
  const uav::NamedBarrier shift_bar{kShiftBarrier, nth};

  // warps 1..: the GP of the next tick (K* into kst_ws when tightened),
  // then, once warp 0 has read what the shift moves, the warm-start shift
  auto gp_and_shift = [&](bool after_scalar) {
    const int gt = tid - 32;
    SECTION_START(t_gp);
    if (P.use_gp) {
      uav::gp_horizon_rows<kGpGroup<kTighten>, kGpStages<kTighten>>(
          gp, N, anchor, xtail, z, zf, red, wv, kTighten ? O.kst_ws : nullptr, gt, gp_nth, gp_bar);
    }
    if constexpr (kTighten) uav::cluster_arrive();   // K* is written
    if (after_scalar) shift_bar();
    SECTION_START(t_shift);
    if (gt == 0) SECTION_ADD(0, t_gp);
    uav::warm_shift(z, y, va, vb, N, m, gt, gp_nth, gp_bar);
    if (gt == 0) SECTION_ADD(1, t_shift);
  };
  if (warp != 0) {
    gp_and_shift(false);
  } else if constexpr (kTighten) {
    uav::cluster_arrive();
  }
  __syncthreads();

  for (int t = 0; t < P.k_ticks; ++t) {
    SECTION_START(t_tick);
    const bool next = t + 1 < P.k_ticks;
    if constexpr (kTighten) {
      // K* of this tick was written before the arrive: the workers form
      // their partial sums, then rank 0 reads them
      uav::cluster_wait();
      uav::cluster_sync();
      uav::variance_backoff<kNth>(var, N, static_cast<int>(uav::cluster_blocks()) - 1, sm, lo,
                                  hi, sig, part, tight, tid, uav::BlockBarrier{});
      if (O.tight_out != nullptr) {
        for (int i = tid; i < m; i += nth) O.tight_out[t * m + i] = tight[i];
      }
    }
    for (int i = tid; i < Nnx; i += nth) ref[i] = O.refs[t * Nnx + i];
    SECTION_START(t_solve);
    uav::condensed_solve(cops, vec, N, m, P.rho, P.over_relax, P.one_minus_over_relax,
                         P.iterations, tid, nth, 5);
    if (tid == 0) SECTION_ADD(2, t_solve);
    if (warp == 0) {
      // this tick's scalar section beside the next tick's GP
      SECTION_START(t_scalar);
      if constexpr (kTighten) {
        if (next) uav::cluster_arrive();
      }
      const float z4[4] = {z[0], z[1], z[2], z[3]};
      const float xt3[3] = {xtail[3], xtail[4], xtail[5]};
      if (next) uav::named_arrive(kShiftBarrier, nth);
      scalar_tick_warp(P, O, t, z4, xt3, ref, st, aux, xw, lane);
      if (lane == 0) SECTION_ADD(3, t_scalar);
    } else if (next) {
      gp_and_shift(true);
    }
    __syncthreads();
    if (tid == 0) SECTION_ADD(4, t_tick);
  }
  if constexpr (kTighten) uav::cluster_sync();   // the workers exit after rank 0's last read

  for (int i = tid; i < m; i += nth) {
    O.z_out[i] = z[i];
    O.y_out[i] = y[i];
  }
  for (int i = tid; i < Nnx; i += nth) O.xtail_out[i] = xtail[i];
  if (tid < 12) O.state_out[tid] = st[tid];
  if (tid < kAux) O.aux_out[tid] = aux[tid];
}

}  // namespace

namespace {

// Raise the kernel's shared-memory limit once per size and instantiation
// (host-side call, kept out of the per-launch path and out of CUDA graph
// captures).
int configure(void (*kernel)(const TickParams, const TickOperands), int* configured,
              int smem_bytes) {
  if (smem_bytes > *configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    *configured = smem_bytes;
  }
  return 0;
}

int configured_bytes[2] = {-1, -1};

// The tightened kernel's shared memory, and clusters of more than the
// portable 8 blocks (the card's own limit applies: 16 on an H100).
int configure_tightened(int cluster, int smem_bytes) {
  const int err = configure(gpmpc_multitick_kernel<kTightThreads, true>, &configured_bytes[1],
                            smem_bytes);
  if (err != 0) return err;
  static bool non_portable = false;
  if (cluster > 8 && !non_portable) {
    const cudaError_t e = cudaFuncSetAttribute(
        gpmpc_multitick_kernel<kTightThreads, true>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    non_portable = true;
  }
  return 0;
}

}  // namespace

// One block of kThreads per flight (`flights` of them) on `stream`; with
// params->tighten one cluster of `cluster` blocks of kTightThreads (rank 0
// the tick, the others variance workers) for one flight.
extern "C" int gpmpc_multitick_launch(const TickParams* params, const TickOperands* ops,
                                      int cluster, int smem_bytes, int flights, void* stream) {
  if (flights < 1 || (params->tighten && flights != 1)) return (int)cudaErrorInvalidValue;
  if (params->tighten) {
    const int err = configure_tightened(cluster, smem_bytes);
    if (err != 0) return err;
    return uav::launch_cluster(gpmpc_multitick_kernel<kTightThreads, true>, cluster,
                               kTightThreads, cluster, smem_bytes,
                               static_cast<cudaStream_t>(stream), *params, *ops);
  }
  const int err =
      configure(gpmpc_multitick_kernel<kThreads, false>, &configured_bytes[0], smem_bytes);
  if (err != 0) return err;
  gpmpc_multitick_kernel<kThreads, false>
      <<<flights, kThreads, smem_bytes, (cudaStream_t)stream>>>(*params, *ops);
  return (int)cudaGetLastError();
}

// The section counters summed since the last call (kSections values, in
// cycles) into out, then reset; returns cudaErrorNotSupported unless built
// with -DUAV_SECTION_CLOCKS. Synchronous: call after the launches finish.
extern "C" int tick_section_cycles(unsigned long long* out) {
  return uav::read_section_cycles(out, kSections);
}

// The number of tightened K5 clusters of `cluster` blocks with `smem_bytes`
// each that the card runs at once, into *count (0: it cannot run one).
extern "C" int gpmpc_multitick_max_active_clusters(int cluster, int smem_bytes, int* count) {
  const int err = configure_tightened(cluster, smem_bytes);
  if (err != 0) return err;
  return uav::max_active_clusters(gpmpc_multitick_kernel<kTightThreads, true>, kTightThreads,
                                  cluster, smem_bytes, count);
}
