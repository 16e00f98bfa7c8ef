// The per-tick phases of the multi-tick kernels K5 (tick_kernel.cu) and K9
// (noisy_tick_kernel.cu): the GP horizon posterior mean, the warm-start
// shift and the condensed controller solve, one device implementation for
// both kernels.
//
// The GP and the shift take the threads they run on (tid, nth) and the
// barrier that joins them: the whole block (K5), or the warps that run
// beside K9's filter warp (a named barrier). The solve always runs on the
// whole block. Every sum runs in a fixed order (deterministic).
#pragma once

#include <cuda_runtime.h>

#include "block_linalg.cuh"

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

struct GPOperands {
  const float *ztrT, *sq2, *alpha_s, *y_mean, *inv_ls, *scal;
  int n_train;
};

// GP horizon posterior mean as disturbance rows: wv[k * 6 + 3 + j] = gain
// (mean[k, 3 + j]), wv[k * 6 + j] = 0 for j < 3. Stage k's features are the
// UNshifted previous solution's: state `anchor` (k = 0) or xtail[k - 1],
// controls z[k]. Thread (stage k, slice s) forms the cross-kernel entries of
// stage k against every S-th training point from s, exponentiates them and
// contracts them with alpha[:, 3:6]; the S slice sums of a stage are added
// in a fixed order. Scratch: zf (N * 10), sq1 (N), red (3 * nth).
template <class Barrier>
__device__ __forceinline__ void gp_horizon_rows(const GPOperands& g, int N, const float* anchor,
                                                const float* xtail, const float* z, float* zf,
                                                float* sq1, float* red, float* wv, int tid,
                                                int nth, Barrier bar) {
  const float sf2 = g.scal[0], gain = g.scal[1];
  for (int i = tid; i < N * kTickFeat; i += nth) {
    const int k = i / kTickFeat, c = i % kTickFeat;
    const float feat = c < kTickNx ? (k == 0 ? anchor[c] : xtail[(k - 1) * kTickNx + c])
                                   : z[k * kTickNu + (c - kTickNx)];
    zf[i] = feat * g.inv_ls[c] - g.inv_ls[kTickFeat + c];
  }
  bar();
  for (int k = tid; k < N; k += nth) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < kTickFeat; ++c) acc += zf[k * kTickFeat + c] * zf[k * kTickFeat + c];
    sq1[k] = acc;
  }
  bar();
  // neighbouring threads read neighbouring points (coalesced)
  const int ntr = g.n_train;
  const int S = max(1, nth / N);
  for (int t = tid; t < N * S; t += nth) {
    const int k = t / S, sl = t % S;
    float zk[kTickFeat];
#pragma unroll
    for (int c = 0; c < kTickFeat; ++c) zk[c] = zf[k * kTickFeat + c];
    const float q1 = sq1[k];
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
#pragma unroll 2
    for (int p = sl; p < ntr; p += S) {
      float cross = 0.0f;
#pragma unroll
      for (int c = 0; c < kTickFeat; ++c) cross += zk[c] * __ldg(g.ztrT + c * ntr + p);
      const float kst = sf2 * expf(-0.5f * fmaxf(q1 + __ldg(g.sq2 + p) - 2.0f * cross, 0.0f));
      acc0 += kst * __ldg(g.alpha_s + p * 6 + 3);
      acc1 += kst * __ldg(g.alpha_s + p * 6 + 4);
      acc2 += kst * __ldg(g.alpha_s + p * 6 + 5);
    }
    red[t * 3 + 0] = acc0;
    red[t * 3 + 1] = acc1;
    red[t * 3 + 2] = acc2;
  }
  bar();
  for (int i = tid; i < N * 3; i += nth) {
    const int k = i / 3, j = i % 3;
    float acc = 0.0f;
    for (int sl = 0; sl < S; ++sl) acc += red[(k * S + sl) * 3 + j];
    wv[k * kTickNx + 3 + j] = gain * (acc + g.y_mean[3 + j]);
    wv[k * kTickNx + j] = 0.0f;
  }
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

// Shared-memory vectors of one tick's solve (layouts in the kernels).
struct TickVectors {
  const float *P1s, *lo, *hi, *ref;
  float *va, *vb, *z, *y, *p0, *lower, *upper, *xw, *xtail, *offset, *dref, *f, *minvf, *U,
      *part;
};

// The condensed controller tick on the whole block, from xw = [x0 | w], ref
// and the shifted warm start z, y (the caller's last write of those is
// separated from this call by a barrier, or by the first matvec, which
// reads only xw):
//   offset = [x0, w] @ [Sx'; Sw'],  f = (offset - ref) @ (Su'Q)',
//   box bounds, p0 = -(f @ P0mat), M^-1 f = f @ MinvT,
//   ADMM: `iterations` x one (m, m) matvec with P1 from shared memory,
//   U = M^-1(-f + G'(rho z - y)),  X_tail = offset + U @ Su'  (into xtail).
// Ends with a barrier.
__device__ __forceinline__ void condensed_solve(const CondensedOperands& O, const TickVectors& v,
                                                int N, int m, float rho, float over_relax,
                                                float one_minus_over_relax, int iterations,
                                                int tid, int nth) {
  const int Nnu = N * kTickNu, Nnx = N * kTickNx, npm = m + Nnu;
  matvec_partial(v.xw, O.SxSwT, Nnx, kTickNx + Nnx, Nnx, v.part, tid, nth);
  __syncthreads();
  for (int r = tid; r < Nnx; r += nth) {
    const float off = matvec_total(v.part, Nnx, nth, r);
    v.offset[r] = off;
    v.dref[r] = off - v.ref[r];
  }
  __syncthreads();
  matvec_partial(v.dref, O.SuTqT, Nnu, Nnx, Nnu, v.part, tid, nth);
  for (int i = tid; i < m; i += nth) {
    const float off_z = (i >= Nnu && i < Nnu + Nnx) ? v.offset[i - Nnu] : 0.0f;
    v.lower[i] = v.lo[i] - off_z;
    v.upper[i] = v.hi[i] - off_z;
    v.va[i] = rho * v.z[i] - v.y[i];
  }
  __syncthreads();
  for (int c = tid; c < Nnu; c += nth) v.f[c] = matvec_total(v.part, Nnu, nth, c);
  __syncthreads();
  matvec_partial(v.f, O.PM, npm, Nnu, npm, v.part, tid, nth);
  __syncthreads();
  for (int j = tid; j < npm; j += nth) {
    const float acc = matvec_total(v.part, npm, nth, j);
    if (j < m) v.p0[j] = -acc;
    else v.minvf[j - m] = acc;
  }
  __syncthreads();
  const float* vsrc = composite_admm<true>(v.P1s, m, v.p0, v.lower, v.upper, v.z, v.y, v.va,
                                           v.vb, rho, over_relax, one_minus_over_relax,
                                           iterations, tid, nth);
  matvec_partial(vsrc, O.P0matT, Nnu, m, Nnu, v.part, tid, nth);
  __syncthreads();
  for (int c = tid; c < Nnu; c += nth) v.U[c] = -v.minvf[c] + matvec_total(v.part, Nnu, nth, c);
  __syncthreads();
  matvec_partial(v.U, O.SuT, Nnx, Nnu, Nnx, v.part, tid, nth);
  __syncthreads();
  for (int r = tid; r < Nnx; r += nth) {
    v.xtail[r] = v.offset[r] + matvec_total(v.part, Nnx, nth, r);
  }
  __syncthreads();
}

}  // namespace uav
