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
// (noisy_tick_kernel.cu); the matvecs, the composite-ADMM iteration
// (block_linalg.cuh) and the scalar section (plant_math.cuh
// mpc_command_plant) are those of the single-tick kernels K3, K4 and K6.
//
// Per tick, in block-wide phases separated by __syncthreads():
//   GP     features of the UNshifted previous solution -> scaled features;
//          thread (stage k, slice s) forms the cross-kernel entries of
//          stage k against every S-th training point from s, exponentiates
//          them and contracts them with alpha[:, 3:6]; the S slice sums of
//          a stage are added in a fixed order (deterministic, no atomics);
//   shift  warm start moved one stage forward (last stage repeated);
//   offset = [x0, w] @ [Sx'; Sw'],  f = (offset - ref) @ (Su'Q)',
//          box bounds, p0 = -(f @ P0mat), M^-1 f;
//   ADMM   `iterations` x one (m, m) matvec from shared memory, thread j
//          owns column j, the matvec input double-buffered so each
//          iteration needs one barrier;
//   U, X_tail, then thread 0 runs the clips, hover fallback, allocation +
//          attitude PID and the plant RK4 substeps (plant_math.cuh, the
//          same device code as K1/K2) and writes the packed row.
//
// What bounds it on an H100: at N=20, P=800 one tick is about 0.73 M
// multiply-adds (GP ~0.26 M, 10 ADMM iterations 0.4 M, the rest ~0.07 M):
// ~3 us at one SM's 128 FP32 FMA per clock. The ADMM matvec reads P1 from
// shared memory at 128 bytes per clock per SM, so each iteration costs at
// least m*m*4/128 = 1250 clocks (~0.7 us), 10 iterations ~7 us per tick;
// the per-tick L2 reads of the other operands (~340 KB) are of the same
// order. One block uses one SM of 132: the kernel is latency-bound by
// design for one flight, and a batch of flights (one block each) is what
// fills the card. Holding P1 in registers across a 1024-thread block, and
// overlapping the scalar plant section with the next tick's GP, are the
// next steps (ROADMAP.md).
//
// With tighten_kappa > 0 (the kTighten instantiation) each tick also runs
// the variance section between the GP and the solve: the GP section leaves
// K* (N x P) in a workspace in device memory, and the section forms the
// posterior variance K* K^-1 K*' from the cached K^-1 and the box back-off
// that the solve's bounds take (multitick_phases.cuh). It is N P^2
// multiply-adds per tick (12.8 M at N = 20, P = 800), ~17x the rest of the
// tick: on the tick's one SM, bound by that SM's FMA rate (~57 us per tick
// at best), it took ~247 us (H100 80GB HBM3, 700 W; PERF.md). So the
// tightened K5 launches a thread-block cluster (csrc/cluster.cuh) per
// flight: 16 blocks where the card runs such a cluster (a non-portable
// size; measured faster than 8 on the H100, PERF.md), 8 otherwise. Rank 0
// runs the tick exactly as the untightened kernel does; the other ranks
// are variance workers that loop over the launch's K ticks beside it. Per
// tick rank 0 writes K* and
// arrives at a cluster barrier (release: the workers then read K* through
// L2), warm-shifts while the workers form their partial sums over equal
// shares of K^-1's upper triangle (half of N P^2: K^-1 is symmetric; ~0.43 M
// multiply-adds each for 15 workers at N = 20, P = 800), meets them at a
// second barrier, adds their sums in rank order through distributed shared
// memory and forms the back-off. K^-1 is fixed within a launch (refits
// happen between launches): a worker keeps its share of the triangle in its
// shared memory where it fits (P = 800: ~85 KB for 15 workers) and streams
// it from L2 otherwise. K* stays in device memory (64 KB at N = 20,
// P = 800: it does not fit beside rank 0's tick). Rank 0's layout holds
// only the variance row and the back-off row, so the tightened kernel
// reaches the untightened one's horizon (N <= 23 on an H100).
//
// loop_precision: both modes compute in float32 with FMAs here.

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

constexpr int kThreads = 256;   // ops/tick_pallas.py KERNEL_THREADS
constexpr int kNu = 4;
constexpr int kNx = 6;
constexpr int kFeat = uav::kTickFeat;
constexpr int kPacked = 32;
constexpr int kAux = 9;

// The scalar section of one tick (one thread): u0 clips, hover fallback,
// allocation + attitude PID, plant RK4 substeps, the packed row and the
// state / aux carries. Not inlined: it runs once per tick on one thread, so
// it gets its own register allocation and keeps the block's loops from
// paying for its register pressure.
__device__ __noinline__ void scalar_tick(const TickParams& P, const TickOperands& O, int t,
                                         const float* z, const float* ref,
                                         const float* xtail, float* st, float* aux) {
    const uav::Plant pl = uav::load_plant(O.plant_row);
    float s[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) s[i] = st[i];
    const float integral[3] = {aux[6], aux[7], aux[8]};
    float sn[12], c[4], att_sp[3], new_int[3], accel[3];
    uav::mpc_command_plant(P, pl, z, ref, s, s, O.yaw_refs[t], integral, sn, c, att_sp,
                           new_int, accel);

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
    for (int i = 0; i < 4; ++i) row[25 + i] = z[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) row[29 + i] = xtail[3 + i];

#pragma unroll
    for (int i = 0; i < 12; ++i) st[i] = sn[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) aux[i] = s[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) aux[6 + i] = new_int[i];
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
  for (int i = tid; i < rows_pad * kS; i += kThreads) rows[i] = 0.0f;
  if (tid < uav::kMaxVarStages) quad_out[tid] = 0.0f;
  if constexpr (kShared) {
    // the share's rows packed (row q: columns q .. P - 1), eight loads in
    // flight per thread; q follows the thread's rising index
    const int entries = uav::packed_row(q1, q0, n_train);
    int q = q0;
    for (int i0 = tid; i0 < entries; i0 += 8 * kThreads) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = 0.0f;
        if (i < entries) {
          while (uav::packed_row(q + 1, q0, n_train) <= i) ++q;
          v[u] = __ldg(O.kinv + static_cast<size_t>(q) * n_train + q +
                       (i - uav::packed_row(q, q0, n_train)));
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + u * kThreads < entries) share[i0 + u * kThreads] = v[u];
      }
    }
  }
  __syncthreads();
  for (int t = 0; t < P.k_ticks; ++t) {
    uav::cluster_sync();   // rank 0 has written this tick's K*
    uav::variance_share<kS, kShared, kThreads>(O.kinv, O.kst_ws, share, N, n_train, q0, q1,
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

template <bool kTighten>
__global__ void __launch_bounds__(kThreads, 1)
gpmpc_multitick_kernel(const TickParams P, const TickOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, nth = blockDim.x;
  if constexpr (kTighten) {
    if (uav::cluster_rank() != 0) {
      variance_worker(P, O, sm, tid);
      return;
    }
  }
  const int N = P.n, m = P.m, Nnu = N * kNu, Nnx = N * kNx, npm = m + Nnu;
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
  float* part = U + Nnu;        // matvec slices: nth + npm
  float* zf = part + nth + npm;
  float* sq1 = zf + N * kFeat;
  float* red = sq1 + N;
  float* st = red + 3 * nth;
  float* aux = st + 12;
  float* sig = aux + kAux;      // the variance section's rows (kTighten)
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
  for (int i = tid; i < Nnx; i += nth) xtail[i] = O.xtail_in[i];
  if (tid < 12) st[tid] = O.state_in[tid];
  if (tid < kAux) aux[tid] = O.aux_in[tid];
  __syncthreads();

  const uav::GPOperands gp{O.ztrT, O.sq2, O.alpha_s, O.y_mean, O.inv_ls, O.scal, P.n_train};
  const uav::CondensedOperands cops{O.SxSwT, O.SuTqT, O.PM, O.P0matT, O.SuT};
  const uav::VarianceOperands var{O.kinv, O.y_std, O.SwSqT, O.scal, P.tighten_kappa};
  const uav::TickVectors vec{P1s,  lo,     hi,     ref,   va,    vb, z, y, p0, lower,
                             upper, xw,   xtail, offset, dref, f, minvf, U, part,
                             kTighten ? tight : nullptr};
  for (int t = 0; t < P.k_ticks; ++t) {
    for (int i = tid; i < Nnx; i += nth) ref[i] = O.refs[t * Nnx + i];
    if (tid < kNx) xw[tid] = st[tid];
    if (P.use_gp) {
      uav::gp_horizon_rows(gp, N, aux, xtail, z, zf, sq1, red, wv, kTighten ? O.kst_ws : nullptr,
                           tid, nth, uav::BlockBarrier{});
    } else {
      for (int i = tid; i < Nnx; i += nth) wv[i] = 0.0f;
    }
    if constexpr (kTighten) {
      // K* is in kst_ws: the workers form their partial sums while rank 0
      // shifts the warm start, then rank 0 reads them
      uav::cluster_arrive();
      uav::warm_shift(z, y, va, vb, N, m, tid, nth, uav::BlockBarrier{});
      uav::cluster_wait();
      uav::cluster_sync();
      uav::variance_backoff<kThreads>(var, N, static_cast<int>(uav::cluster_blocks()) - 1, sm, lo,
                                      hi, sig, part, tight, tid, uav::BlockBarrier{});
      if (O.tight_out != nullptr) {
        for (int i = tid; i < m; i += nth) O.tight_out[t * m + i] = tight[i];
      }
    } else {
      uav::warm_shift(z, y, va, vb, N, m, tid, nth, uav::BlockBarrier{});
    }
    uav::condensed_solve(cops, vec, N, m, P.rho, P.over_relax, P.one_minus_over_relax,
                         P.iterations, tid, nth);
    // ---- u0 clips, fallback, allocation + plant (one thread) -------------
    if (tid == 0) scalar_tick(P, O, t, z, ref, xtail, st, aux);
    __syncthreads();
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
  const int err = configure(gpmpc_multitick_kernel<true>, &configured_bytes[1], smem_bytes);
  if (err != 0) return err;
  static bool non_portable = false;
  if (cluster > 8 && !non_portable) {
    const cudaError_t e = cudaFuncSetAttribute(
        gpmpc_multitick_kernel<true>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    non_portable = true;
  }
  return 0;
}

}  // namespace

// One block on `stream`; with params->tighten one cluster of `cluster`
// blocks (rank 0 the tick, the others variance workers).
extern "C" int gpmpc_multitick_launch(const TickParams* params, const TickOperands* ops,
                                      int cluster, int smem_bytes, void* stream) {
  if (params->tighten) {
    const int err = configure_tightened(cluster, smem_bytes);
    if (err != 0) return err;
    return uav::launch_cluster(gpmpc_multitick_kernel<true>, cluster, kThreads, cluster,
                               smem_bytes, static_cast<cudaStream_t>(stream), *params, *ops);
  }
  const int err = configure(gpmpc_multitick_kernel<false>, &configured_bytes[0], smem_bytes);
  if (err != 0) return err;
  gpmpc_multitick_kernel<false><<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(*params, *ops);
  return (int)cudaGetLastError();
}

// The number of tightened K5 clusters of `cluster` blocks with `smem_bytes`
// each that the card runs at once, into *count (0: it cannot run one).
extern "C" int gpmpc_multitick_max_active_clusters(int cluster, int smem_bytes, int* count) {
  const int err = configure_tightened(cluster, smem_bytes);
  if (err != 0) return err;
  return uav::max_active_clusters(gpmpc_multitick_kernel<true>, kThreads, cluster, smem_bytes,
                                  count);
}
