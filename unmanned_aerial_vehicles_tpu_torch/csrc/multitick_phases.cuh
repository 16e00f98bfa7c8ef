// The per-tick phases of the multi-tick kernels K5 (tick_kernel.cu) and K9
// (noisy_tick_kernel.cu): the GP horizon posterior mean, the warm-start
// shift and the condensed controller solve, one device implementation for
// both kernels; and K5's GP posterior variance with the box back-off it
// sets, over a thread-block cluster (variance_share, variance_backoff).
//
// The GP and the shift take the threads they run on (tid, nth) and the
// barrier that joins them (a named barrier): the warps that run beside the
// scalar section's warp (and K9's filter warp). The solve always runs on
// the whole block. Every sum runs in a fixed order (deterministic).
#pragma once

#include <cuda_runtime.h>

#include "block_linalg.cuh"
#include "cluster.cuh"
#include "section_clocks.cuh"

namespace uav {

constexpr int kTickNu = 4;
constexpr int kTickNx = 6;
constexpr int kTickFeat = kTickNu + kTickNx;

struct BlockBarrier {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// bar.sync on barrier `id` (not 0, which __syncthreads uses) for `threads`
// threads, a multiple of 32: joins a subset of the block's warps.
struct NamedBarrier {
  int id, threads;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
  }
};

// bar.arrive on barrier `id` for `threads` threads: a warp's side of a
// named barrier that other warps wait at (NamedBarrier), without waiting.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

struct GPOperands {
  const float *ztrT, *sq2, *alpha_s, *y_mean, *inv_ls, *scal;
  int n_train;
};

// GP horizon posterior mean as disturbance rows: wv[k * 6 + 3 + j] = gain
// (mean[k, 3 + j]), wv[k * 6 + j] = 0 for j < 3. Stage k's features are the
// UNshifted previous solution's: state `anchor` (k = 0) or xtail[k - 1],
// controls z[k]. The N stages go in groups of kStages (the last group
// padded); the nth threads (a multiple of 32) form h = nth / (G ceil(N /
// kStages)) lane groups of G = kGroup lanes per stage group, S = G h slices:
// thread (stage group, slice s) loads every S-th training point from s
// once (neighbouring lanes read neighbouring points) and, for each of its
// stages k, forms the cross-kernel entry, exponentiates it and contracts it
// with alpha[:, 3:6]; a lane group's G sums of a stage meet in the xor tree
// (offsets G/2, ..., 1), and the h group sums of a stage are added in group
// order. Scratch: zf (N * 10), red (3 N h <= 3 kStages nth / G). With
// kst_out (device memory, N x n_train) each cross-kernel entry is also
// stored there for the variance section. Ends after the rows are written
// (no barrier).
template <int kGroup, int kStages, class Barrier>
__device__ __forceinline__ void gp_horizon_rows(const GPOperands& g, int N, const float* anchor,
                                                const float* xtail, const float* z, float* zf,
                                                float* red, float* wv, float* kst_out, int tid,
                                                int nth, Barrier bar) {
  const float sf2 = g.scal[0], gain = g.scal[1];
  for (int i = tid; i < N * kTickFeat; i += nth) {
    const int k = i / kTickFeat, c = i % kTickFeat;
    const float feat = c < kTickNx ? (k == 0 ? anchor[c] : xtail[(k - 1) * kTickNx + c])
                                   : z[k * kTickNu + (c - kTickNx)];
    zf[i] = feat * g.inv_ls[c] - g.inv_ls[kTickFeat + c];
  }
  bar();
  const int ntr = g.n_train, NS = (N + kStages - 1) / kStages;
  const int h = nth / (kGroup * NS), S = kGroup * h;
  const int grp = tid / kGroup, lane8 = tid % kGroup;
  const int ks = grp / h, sl = (grp % h) * kGroup + lane8;   // ks >= NS: an idle lane
  float acc[kStages][3];
  float zk[kStages][kTickFeat], q1[kStages];
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    const int k = min(ks * kStages + s, N - 1);   // a missing stage repeats the last
    q1[s] = 0.0f;
#pragma unroll
    for (int c = 0; c < kTickFeat; ++c) {
      zk[s][c] = ks < NS ? zf[k * kTickFeat + c] : 0.0f;
      q1[s] += zk[s][c] * zk[s][c];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[s][j] = 0.0f;
  }
  if (ks < NS) {
#pragma unroll 2
    for (int p = sl; p < ntr; p += S) {
      float zt[kTickFeat];
#pragma unroll
      for (int c = 0; c < kTickFeat; ++c) zt[c] = __ldg(g.ztrT + c * ntr + p);
      const float sq2 = __ldg(g.sq2 + p);
      const float a3 = __ldg(g.alpha_s + p * 6 + 3), a4 = __ldg(g.alpha_s + p * 6 + 4),
                  a5 = __ldg(g.alpha_s + p * 6 + 5);
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        float cross = 0.0f;
#pragma unroll
        for (int c = 0; c < kTickFeat; ++c) cross += zk[s][c] * zt[c];
        const float kst = sf2 * expf(-0.5f * fmaxf(q1[s] + sq2 - 2.0f * cross, 0.0f));
        const int k = ks * kStages + s;
        if (kst_out != nullptr && k < N) kst_out[k * ntr + p] = kst;
        acc[s][0] += kst * a3;
        acc[s][1] += kst * a4;
        acc[s][2] += kst * a5;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[s][j] += __shfl_xor_sync(0xffffffffu, acc[s][j], off);
    }
    const int k = ks * kStages + s;
    if (k < N && lane8 == 0) {
#pragma unroll
      for (int j = 0; j < 3; ++j) red[(k * h + grp % h) * 3 + j] = acc[s][j];
    }
  }
  bar();
  for (int i = tid; i < N * 3; i += nth) {
    const int kk = i / 3, j = i % 3;
    float acc_k = 0.0f;
    for (int gi = 0; gi < h; ++gi) acc_k += red[(kk * h + gi) * 3 + j];
    wv[kk * kTickNx + 3 + j] = gain * (acc_k + g.y_mean[3 + j]);
    wv[kk * kTickNx + j] = 0.0f;
  }
}

// ---- K5's posterior variance and box back-off (tighten_kappa > 0) ------
//
// Per tick, from the horizon's cross-kernel K* (N x P, left in device
// memory by gp_horizon_rows) and the cached K^-1 (P x P):
//   quad[k]  = K*_k K^-1 K*_k'          var_lat = max(prior - quad, 1e-10)
//   sig[k*6 + 3 + j] = gain^2 var_lat[k] y_std[3+j]^2 (0 on rows j < 3)
//   var_x    = sig @ SwSqT               tight_X = min(kappa sqrt(var_x),
//                                                  0.45 (hi - lo))
// and tight = 0 on the U-block.
//
// The quadratic form runs over a thread-block cluster beside the tick
// (tick_kernel.cu): rank 0 runs the tick, ranks 1..W are workers. K^-1 is
// symmetric, so quad[k] = sum_q K^-1_qq K*_kq^2 + 2 sum_{q<p} K*_kq
// K^-1_qp K*_kp: the upper triangle only, half the multiply-adds. Worker r
// takes the triangle's rows [rows[r-1], rows[r]), cut so that every worker
// has the same count of entries to within one row (ops/tick_pallas.py
// variance_row_shares), and leaves its partial sums of quad in its own
// shared memory (variance_share); rank 0 adds them in rank order through
// distributed shared memory and forms the back-off (variance_backoff).
// Every sum runs in a fixed order, so a second launch is bit-identical.
constexpr int kMaxVarStages = 24;   // ops/tick_pallas.py MAX_VAR_STAGES
constexpr int kVarRows = 16;        // VAR_ROWS: rows of K^-1 per task
constexpr int kMaxVarWorkers = 15;  // VAR_MAX_CLUSTER - 1: ranks 1..15 of a cluster of 16
// a worker's shared memory: its partial sums (kMaxVarStages), the warps'
// sums (8 x kMaxVarStages), then K*'s columns of its rows and, with K^-1
// in shared memory, its rows of the triangle
constexpr int kVarHead = 9 * kMaxVarStages;

struct VarianceOperands {
  const float *kinv, *y_std, *SwSqT, *scal;
  float kappa;
};

// Offset of row q's first entry (column q) in a share packed row by row
// from row q0, each row q holding columns q..P-1.
__device__ __forceinline__ int packed_row(int q, int q0, int P) {
  return (q - q0) * P - ((q - q0) * (q + q0 - 1)) / 2;
}

// A worker's partial sums quad_out[k] over the triangle rows [q0, q1), on
// kNth threads. kS: the stages rounded up to 4 (stages past N are zeros).
// kst: K* in device memory, written by rank 0 in this launch, so read
// through L2 (ld.cg), never the read-only cache; kinv: K^-1 in device
// memory (kShared false) or `share`, the rows packed in shared memory.
// rows: this share's K* columns as (row - q0, stage) pairs, kS floats a
// row, zero on the padded rows; wsum: 8 x kS.
//
// Tasks are (a block of kVarRows rows, a column p >= the block's first
// row), listed block by block and dealt to the threads round robin, so
// every thread gets the same count to within one: a task loads its
// kVarRows entries of K^-1's column p (neighbouring threads read
// neighbouring columns) and K*'s column p, and folds t[k] = sum_q w_qp
// K^-1_qp K*_kq (w = 2 off the diagonal, 1 on it, 0 below it) into
// quad[k] += t[k] K*_kp. A thread loads its next task's operands before it
// folds the current one, so their latency hides behind the arithmetic.
template <int kS, bool kShared, int kNth>
__device__ void variance_share(const float* __restrict__ kinv, const float* kst,
                               const float* share, int N, int P, int q0, int q1, float* rows,
                               float* wsum, float* quad_out, int tid) {
  static_assert(kS % 4 == 0 && kS <= kMaxVarStages, "stages in float4 rows");
  const int nq = q1 - q0;
  for (int i0 = tid; i0 < N * nq; i0 += 8 * kNth) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kNth;
      v[u] = i < N * nq ? __ldcg(kst + static_cast<size_t>(i / nq) * P + q0 + i % nq) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kNth;
      if (i < N * nq) rows[(i % nq) * kS + i / nq] = v[u];
    }
  }
  __syncthreads();
  float quad[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) quad[k] = 0.0f;
  int tasks = 0;
  for (int qc = q0; qc < q1; qc += kVarRows) tasks += P - qc;
  int block = q0, before = 0;   // the row block of the task being located, tasks before it
  auto locate = [&](int task, int& qc, int& p) {
    while (task - before >= P - block) {
      before += P - block;
      block += kVarRows;
    }
    qc = block;
    p = block + task - before;
  };
  auto fetch = [&](int qc, int p, float (&a)[kVarRows], float (&kp)[kS]) {
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      kp[k] = k < N ? __ldcg(kst + static_cast<size_t>(k) * P + p) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kVarRows; ++u) {
      const int q = qc + u;
      float v = 0.0f;
      if (q < q1 && q <= p) {
        if constexpr (kShared) v = share[packed_row(q, q0, P) + p - q];
        else v = __ldg(kinv + static_cast<size_t>(q) * P + p);
        if (q < p) v += v;
      }
      a[u] = v;
    }
  };
  float a_next[kVarRows], kp_next[kS];
  int qc_next = 0, p_next = 0;
  if (tid < tasks) {
    locate(tid, qc_next, p_next);
    fetch(qc_next, p_next, a_next, kp_next);
  }
  for (int task = tid; task < tasks; task += kNth) {
    float a[kVarRows], kp[kS];
#pragma unroll
    for (int u = 0; u < kVarRows; ++u) a[u] = a_next[u];
#pragma unroll
    for (int k = 0; k < kS; ++k) kp[k] = kp_next[k];
    const int qc = qc_next;
    if (task + kNth < tasks) {
      locate(task + kNth, qc_next, p_next);
      fetch(qc_next, p_next, a_next, kp_next);
    }
    float t[kS];
#pragma unroll
    for (int k = 0; k < kS; ++k) t[k] = 0.0f;
    // four stages at a time: the block's kVarRows rows loaded, then folded
    const float4* r4 = reinterpret_cast<const float4*>(rows + (qc - q0) * kS);
#pragma unroll
    for (int k4 = 0; k4 < kS / 4; ++k4) {
      float4 r[kVarRows];
#pragma unroll
      for (int u = 0; u < kVarRows; ++u) r[u] = r4[u * (kS / 4) + k4];
#pragma unroll
      for (int u = 0; u < kVarRows; ++u) {
        t[4 * k4] = fmaf(a[u], r[u].x, t[4 * k4]);
        t[4 * k4 + 1] = fmaf(a[u], r[u].y, t[4 * k4 + 1]);
        t[4 * k4 + 2] = fmaf(a[u], r[u].z, t[4 * k4 + 2]);
        t[4 * k4 + 3] = fmaf(a[u], r[u].w, t[4 * k4 + 3]);
      }
    }
#pragma unroll
    for (int k = 0; k < kS; ++k) quad[k] = fmaf(t[k], kp[k], quad[k]);
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    float acc = quad[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) wsum[warp * kS + k] = acc;
  }
  __syncthreads();
  if (tid < kS) {
    float s = 0.0f;
    for (int w = 0; w < kNth / 32; ++w) s += wsum[w * kS + tid];
    quad_out[tid] = s;
  }
}

// Rank 0: the workers' partial sums (at offset 0 of ranks 1..workers'
// shared memory, `slot` in this block's), added in rank order, then sig
// (N * 6), var_x through `part` (the matvec slices, >= kNth + N * 6) and
// tight (m). Ends with a barrier (bar).
template <int kNth, class Barrier>
__device__ __forceinline__ void variance_backoff(const VarianceOperands& v, int N, int workers,
                                                 float* slot, const float* lo, const float* hi,
                                                 float* sig, float* part, float* tight, int tid,
                                                 Barrier bar) {
  const int Nnu = N * kTickNu, Nnx = N * kTickNx;
  const float prior = v.scal[2], gain = v.scal[1];
  const float g2 = gain * gain;
  for (int i = tid; i < Nnx; i += kNth) {
    const int k = i / kTickNx, c = i % kTickNx;
    float s = 0.0f;
    if (c >= 3) {
      float w[kMaxVarWorkers];   // every load in flight before the sum
#pragma unroll
      for (int r = 0; r < kMaxVarWorkers; ++r) {
        w[r] = r < workers ? peer_shared(slot, r + 1)[k] : 0.0f;
      }
      float q = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxVarWorkers; ++r) q += w[r];
      const float ys = v.y_std[c];
      s = (g2 * fmaxf(prior - q, 1e-10f)) * (ys * ys);
    }
    sig[i] = s;
  }
  bar();
  matvec_partial(sig, v.SwSqT, Nnx, Nnx, Nnx, part, tid, kNth);
  bar();
  for (int i = tid; i < Nnu; i += kNth) tight[i] = 0.0f;
  for (int r = tid; r < Nnx; r += kNth) {
    const float var_x = matvec_total(part, Nnx, kNth, r);
    tight[Nnu + r] = fminf(v.kappa * sqrtf(var_x), 0.45f * (hi[Nnu + r] - lo[Nnu + r]));
  }
  bar();
}

// The warm start moved one stage forward (last stage repeated), U and X
// blocks alike: a gather into va / vb, the barrier, the write-back.
template <class Barrier>
__device__ __forceinline__ void warm_shift(float* z, float* y, float* va, float* vb, int N,
                                           int m, int tid, int nth, Barrier bar) {
  const int Nnu = N * kTickNu, Nnx = N * kTickNx;
  for (int i = tid; i < m; i += nth) {
    int src = i;
    if (i < Nnu - kTickNu) src = i + kTickNu;
    else if (i >= Nnu && i < Nnu + Nnx - kTickNx) src = i + kTickNx;
    va[i] = z[src];
    vb[i] = y[src];
  }
  bar();
  for (int i = tid; i < m; i += nth) {
    z[i] = va[i];
    y[i] = vb[i];
  }
}

struct CondensedOperands {
  const float *SxSwT, *SuTqT, *PM, *P0matT, *SuT;
};

// The vectors of one tick's solve (layouts in the kernels), in shared
// memory but for lo, hi, ref, tight and xtail, which may also lie in device
// memory (K4 reads its rows and writes X_tail there); P1s is P1, in shared
// memory or, for condensed_solve<false>, in device memory; tight (m) backs
// the boxes off (nullptr: the static boxes); anchor (6) receives x0 for the
// next tick's GP.
struct TickVectors {
  const float *P1s, *lo, *hi, *ref;
  float *va, *vb, *z, *y, *p0, *lower, *upper, *xw, *xtail, *offset, *dref, *f, *minvf, *U,
      *part, *anchor;
  const float* tight = nullptr;
};

struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};

// condensed_solve's ADMM operator, primal recovery and products. P1Operator:
// P1 (m x m) at v.P1s, in shared memory (kSharedP1) or device memory, one
// column dot a thread and step (composite_admm); U from O.P0matT in device
// memory; the products in matvec_partial's slices (K4, K5, K9).
template <bool kSharedP1>
struct P1Operator {
  // part = the slices of x A (the solve's products with the fixed operators)
  __device__ __forceinline__ void partial(const float* x, const float* A, int n_in, int n_out,
                                          float* part, int tid, int nth) const {
    matvec_partial(x, A, n_out, n_in, n_out, part, tid, nth);
  }
  __device__ __forceinline__ const float* iterate(const TickVectors& v, int N, int m, float rho,
                                                  float over_relax, float one_minus_over_relax,
                                                  int iterations, int tid, int nth) const {
    return composite_admm<kSharedP1>(v.P1s, m, v.p0, v.lower, v.upper, v.z, v.y, v.va, v.vb,
                                     rho, over_relax, one_minus_over_relax, iterations, tid,
                                     nth);
  }
  // U = -M^-1 f + (rho z - y) GM^-1 (no barrier after the last write)
  __device__ __forceinline__ void primal(const CondensedOperands& O, const TickVectors& v,
                                         const float* vsrc, int N, int m, int tid,
                                         int nth) const {
    const int Nnu = N * kTickNu;
    matvec_partial(vsrc, O.P0matT, Nnu, m, Nnu, v.part, tid, nth);
    __syncthreads();
    for (int c = tid; c < Nnu; c += nth) v.U[c] = -v.minvf[c] + matvec_total(v.part, Nnu, nth, c);
  }
};

// The operators of K3, on P1's two factors for G = [I; Su], GM^-1 (m x Nnu
// rows) and Su' (Nnu x Nnx rows); U from GM^-1 as the first half of one
// more step; the products with the fixed operators in matvec_partial's
// slices and sums, with the accumulators in registers
// (matvec_partial_static). ts: t (Nnu floats, 16-byte aligned);
// clock_base: the first of the section clocks of a step's three phases
// (factored_admm), or -1.
//
// SliceOperator: each thread's slices of both factors, loaded into
// registers from device memory when the ADMM starts
// (factored_admm_slices); kA, kB bound the slices' rows.
template <int kA, int kB>
struct SliceOperator {
  const float *GMinv, *SuT;   // in device memory
  float* ts;
  int clock_base;
  FactorSlices<kA, kB> s;
  __device__ __forceinline__ void partial(const float* x, const float* A, int n_in, int n_out,
                                          float* part, int tid, int nth) const {
    matvec_partial_static(x, A, n_out, n_in, n_out, part, tid, nth);
  }
  __device__ __forceinline__ const float* iterate(const TickVectors& v, int N, int m, float rho,
                                                  float over_relax, float one_minus_over_relax,
                                                  int iterations, int tid, int nth) {
    const int Nnu = N * kTickNu;
    load_factor_slices<false>(s, GMinv, Nnu, SuT, m, Nnu, tid, nth);
    return factored_admm_slices(s, m, Nnu, v.p0, v.lower, v.upper, v.z, v.y, v.va, v.vb, ts,
                                v.part, rho, over_relax, one_minus_over_relax, iterations, tid,
                                nth, clock_base);
  }
  __device__ __forceinline__ void primal(const CondensedOperands&, const TickVectors& v,
                                         const float* vsrc, int N, int m, int tid,
                                         int nth) const {
    slices_t(s, vsrc, N * kTickNu, v.part, tid, nth,
             [&](int c, float t) { v.U[c] = -v.minvf[c] + t; });
  }
};

// FactoredOperator: both factors read through L2 every step
// (factored_admm), where the slices exceed their bounds.
struct FactoredOperator {
  const float *GMinv, *SuT;   // in device memory
  float* ts;
  int clock_base;
  __device__ __forceinline__ void partial(const float* x, const float* A, int n_in, int n_out,
                                          float* part, int tid, int nth) const {
    matvec_partial_static(x, A, n_out, n_in, n_out, part, tid, nth);
  }
  __device__ __forceinline__ const float* iterate(const TickVectors& v, int N, int m, float rho,
                                                  float over_relax, float one_minus_over_relax,
                                                  int iterations, int tid, int nth) const {
    const int Nnu = N * kTickNu;
    return factored_admm<false>(GMinv, Nnu, SuT, m, Nnu, v.p0, v.lower, v.upper, v.z, v.y,
                                v.va, v.vb, ts, v.part, rho, over_relax, one_minus_over_relax,
                                iterations, tid, nth, clock_base);
  }
  __device__ __forceinline__ void primal(const CondensedOperands&, const TickVectors& v,
                                         const float* vsrc, int N, int m, int tid,
                                         int nth) const {
    const int Nnu = N * kTickNu;
    factor_t<false>(vsrc, GMinv, Nnu, m, Nnu, v.part, tid, nth,
                    [&](int c, float t) { v.U[c] = -v.minvf[c] + t; });
  }
};

// The condensed controller tick on the whole block, from xw = [x0 | w],
// ref and the shifted warm start z, y, the boxes backed off by v.tight (the
// caller's last write of those is separated from this call by a barrier,
// or by the first product, which reads only xw):
//   offset = [x0, w] @ [Sx'; Sw'],  f = (offset - ref) @ (Su'Q)',
//   box bounds, p0 = -(f @ P0mat), M^-1 f = f @ MinvT,
//   ADMM: `iterations` steps of `op` (P1Operator: one (m, m) matvec with P1,
//   from shared memory with kSharedP1, else through L1/L2; SliceOperator,
//   FactoredOperator: P1's two factors),
//   U = M^-1(-f + G'(rho z - y)) (op.primal),  X_tail = offset + U @ Su'
//   (O.SuT; into xtail);
// the products with the fixed operators in matvec_partial's slices (each
// column over nth / n_out threads), and x0 copied into v.anchor. Every
// thread calls before_admm() once, after the phases that do not read the
// ADMM operator (K4 waits there for P1's copy into shared memory).
// Ends with a barrier. clock_base: the first of the section clocks of its
// six phases (offset, f, p0 and M^-1 f, the ADMM, U, X_tail), or -1.
template <bool kSharedP1 = true, class BeforeAdmm = NoWait,
          class Operator = P1Operator<kSharedP1>>
__device__ __forceinline__ void condensed_solve(const CondensedOperands& O, const TickVectors& v,
                                                int N, int m, float rho, float over_relax,
                                                float one_minus_over_relax, int iterations,
                                                int tid, int nth, int clock_base,
                                                BeforeAdmm before_admm = {}, Operator op = {}) {
  const int Nnu = N * kTickNu, Nnx = N * kTickNx, npm = m + Nnu;
  [[maybe_unused]] auto section = [clock_base](int k) {
    return clock_base < 0 ? -1 : clock_base + k;
  };
  // part = slices of the product of x with A (n_in x n_out); ends with a
  // barrier
  auto product = [&](const float* x, const float* A, int n_in, int n_out) {
    op.partial(x, A, n_in, n_out, v.part, tid, nth);
    __syncthreads();
  };
  SECTION_START(t_offset);
  if (tid < kTickNx) v.anchor[tid] = v.xw[tid];
  product(v.xw, O.SxSwT, kTickNx + Nnx, Nnx);
  for (int r = tid; r < Nnx; r += nth) {
    const float off = matvec_total(v.part, Nnx, nth, r);
    v.offset[r] = off;
    v.dref[r] = off - v.ref[r];
  }
  __syncthreads();
  SECTION_START(t_f);
  if (tid == 0) SECTION_ADD(section(0), t_offset);
  product(v.dref, O.SuTqT, Nnx, Nnu);
  for (int i = tid; i < m; i += nth) {
    const float off_z = (i >= Nnu && i < Nnu + Nnx) ? v.offset[i - Nnu] : 0.0f;
    box_bounds(v.lo, v.hi, v.tight, i, off_z, v.lower + i, v.upper + i);
    v.va[i] = rho * v.z[i] - v.y[i];
  }
  for (int c = tid; c < Nnu; c += nth) v.f[c] = matvec_total(v.part, Nnu, nth, c);
  __syncthreads();
  SECTION_START(t_p0);
  if (tid == 0) SECTION_ADD(section(1), t_f);
  product(v.f, O.PM, Nnu, npm);
  for (int j = tid; j < npm; j += nth) {
    const float acc = matvec_total(v.part, npm, nth, j);
    if (j < m) v.p0[j] = -acc;
    else v.minvf[j - m] = acc;
  }
  __syncthreads();
  if (tid == 0) SECTION_ADD(section(2), t_p0);
  before_admm();
  SECTION_START(t_admm);
  const float* vsrc = op.iterate(v, N, m, rho, over_relax, one_minus_over_relax, iterations, tid,
                                 nth);
  SECTION_START(t_u);
  if (tid == 0) SECTION_ADD(section(3), t_admm);
  op.primal(O, v, vsrc, N, m, tid, nth);
  __syncthreads();
  SECTION_START(t_x);
  if (tid == 0) SECTION_ADD(section(4), t_u);
  product(v.U, O.SuT, Nnu, Nnx);
  for (int r = tid; r < Nnx; r += nth) {
    v.xtail[r] = v.offset[r] + matvec_total(v.part, Nnx, nth, r);
  }
  __syncthreads();
  if (tid == 0) SECTION_ADD(section(5), t_x);
}

}  // namespace uav
