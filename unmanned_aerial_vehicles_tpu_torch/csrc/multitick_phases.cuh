// The per-tick phases of the multi-tick kernels K5 (tick_kernel.cu) and K9
// (noisy_tick_kernel.cu): the GP horizon posterior mean, the warm-start
// shift and the condensed controller solve, one device implementation for
// both kernels; and K5's GP posterior variance with the box back-off it
// sets (gp_horizon_tightening).
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
// in a fixed order. Scratch: zf (N * 10), sq1 (N), red (3 * nth). With
// kst_out (device memory, N x n_train) each cross-kernel entry is also
// stored there for the variance section.
template <class Barrier>
__device__ __forceinline__ void gp_horizon_rows(const GPOperands& g, int N, const float* anchor,
                                                const float* xtail, const float* z, float* zf,
                                                float* sq1, float* red, float* wv,
                                                float* kst_out, int tid, int nth, Barrier bar) {
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
      if (kst_out != nullptr) kst_out[k * ntr + p] = kst;
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

// ---- K5's posterior variance and box back-off (tighten_kappa > 0) ------
//
// Per tick, from the horizon's cross-kernel K* (N x P, left in device
// memory by gp_horizon_rows) and the cached K^-1 (P x P):
//   quad[k]  = K*_k K^-1 K*_k'          var_lat = max(prior - quad, 1e-10)
//   sig[k*6 + 3 + j] = gain^2 var_lat[k] y_std[3+j]^2 (0 on rows j < 3)
//   var_x    = sig @ SwSqT               tight_X = min(kappa sqrt(var_x),
//                                                  0.45 (hi - lo))
// and tight = 0 on the U-block. Thread p owns column p of K^-1 (neighbouring
// threads read neighbouring addresses, 32 rows in flight at a time) and
// keeps r[k] = sum_q K^-1[q, p] K*[k, q] for every stage in registers, the
// stage loop unrolled to kMaxVarStages (rows past N are zeros, so no
// predicate breaks the unrolled multiply-adds); K*'s columns pass through a
// double-buffered shared tile, the next tile's loads in flight while the
// current one is used (one barrier per tile). The thread then adds r[k]
// K*[k, p] to its own quad[k]; those are reduced by a fixed shuffle tree
// and the warps' sums added in warp order: a second launch is bit
// identical. K^-1 is read once per tick (2.56 MB at P = 800, L2-resident
// across the launch's ticks).
constexpr int kVarTile = 64;        // ops/tick_pallas.py VAR_TILE
constexpr int kMaxVarStages = 24;   // ops/tick_pallas.py MAX_VAR_STAGES
constexpr int kVarTileFloats = kMaxVarStages * kVarTile;
constexpr int kVarRows = 32;        // rows of K^-1 loaded before their use

struct VarianceOperands {
  const float *kinv, *y_std, *SwSqT, *scal;
  float kappa;
};

// Thread tid's share of K*'s tile t (zeros past stage N and column P):
// element j is row (j kNth + tid) / kVarTile, column (j kNth + tid) %
// kVarTile of the tile; the shared tiles alternate between two buffers.
template <int kNth>
__device__ __forceinline__ void fetch_kst_tile(const float* kst, int N, int P, int t, int tid,
                                               float (&pre)[kVarTileFloats / kNth]) {
#pragma unroll
  for (int j = 0; j < kVarTileFloats / kNth; ++j) {
    const int i = j * kNth + tid, k = i / kVarTile, q = t * kVarTile + i % kVarTile;
    pre[j] = (k < N && q < P) ? kst[k * P + q] : 0.0f;
  }
}

template <int kNth>
__device__ __forceinline__ void put_kst_tile(float* tiles, int t, int tid,
                                             const float (&pre)[kVarTileFloats / kNth]) {
#pragma unroll
  for (int j = 0; j < kVarTileFloats / kNth; ++j) {
    tiles[(t & 1) * kVarTileFloats + j * kNth + tid] = pre[j];
  }
}

// Shared scratch: tiles (2 * kVarTileFloats, 16-byte aligned), wsum
// ((kNth / 32) * kMaxVarStages), sig (N * 6); part (the matvec slices, >=
// kNth + N * 6). Writes tight (m) and ends with a barrier (bar).
template <int kNth, class Barrier>
__device__ __forceinline__ void gp_horizon_tightening(
    const VarianceOperands& v, int N, int n_train, const float* kst, const float* lo,
    const float* hi, float* tiles, float* wsum, float* sig, float* part, float* tight, int tid,
    Barrier bar) {
  static_assert(kVarTileFloats % kNth == 0, "a tile is a whole number of loads per thread");
  constexpr int kLoads = kVarTileFloats / kNth;
  const int P = n_train, Nnu = N * kTickNu, Nnx = N * kTickNx;
  const int n_tiles = (P + kVarTile - 1) / kVarTile;
  float quad[kMaxVarStages];
#pragma unroll
  for (int k = 0; k < kMaxVarStages; ++k) quad[k] = 0.0f;
  const int rounds = (P + kNth - 1) / kNth;
  for (int rd = 0; rd < rounds; ++rd) {
    const int p = rd * kNth + tid;
    const bool active = p < P;
    float r[kMaxVarStages];
#pragma unroll
    for (int k = 0; k < kMaxVarStages; ++k) r[k] = 0.0f;
    float pre[kLoads];
    fetch_kst_tile<kNth>(kst, N, P, 0, tid, pre);
    put_kst_tile<kNth>(tiles, 0, tid, pre);   // free: their last use ended at a barrier
    bar();
    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) fetch_kst_tile<kNth>(kst, N, P, t + 1, tid, pre);
      if (active) {
        const float* buf = tiles + (t & 1) * kVarTileFloats;
        const int q0 = t * kVarTile, qn = min(kVarTile, P - q0);
        const float* col = v.kinv + static_cast<size_t>(q0) * P + p;
        for (int g = 0; g < qn; g += kVarRows) {
          float a[kVarRows];
#pragma unroll
          for (int u = 0; u < kVarRows; ++u) {
            a[u] = g + u < qn ? __ldg(col + static_cast<size_t>(g + u) * P) : 0.0f;
          }
#pragma unroll
          for (int k = 0; k < kMaxVarStages; ++k) {
            const float4* t4 = reinterpret_cast<const float4*>(buf + k * kVarTile + g);
            float acc = r[k];
#pragma unroll
            for (int qq = 0; qq < kVarRows / 4; ++qq) {
              const float4 w = t4[qq];
              acc = fmaf(a[4 * qq], w.x, acc);
              acc = fmaf(a[4 * qq + 1], w.y, acc);
              acc = fmaf(a[4 * qq + 2], w.z, acc);
              acc = fmaf(a[4 * qq + 3], w.w, acc);
            }
            r[k] = acc;
          }
        }
      }
      if (t + 1 < n_tiles) put_kst_tile<kNth>(tiles, t + 1, tid, pre);
      bar();
    }
    if (active) {
#pragma unroll
      for (int k = 0; k < kMaxVarStages; ++k) {
        if (k < N) quad[k] = fmaf(r[k], kst[k * P + p], quad[k]);
      }
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kMaxVarStages; ++k) {
    float acc = quad[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) wsum[warp * kMaxVarStages + k] = acc;
  }
  bar();
  const float prior = v.scal[2], gain = v.scal[1];
  const float g2 = gain * gain;
  for (int i = tid; i < Nnx; i += kNth) {
    const int k = i / kTickNx, c = i % kTickNx;
    float s = 0.0f;
    if (c >= 3) {
      float q = 0.0f;
      for (int w = 0; w < kNth / 32; ++w) q += wsum[w * kMaxVarStages + k];
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

// Shared-memory vectors of one tick's solve (layouts in the kernels);
// tight (m) backs the boxes off (nullptr: the static boxes).
struct TickVectors {
  const float *P1s, *lo, *hi, *ref;
  float *va, *vb, *z, *y, *p0, *lower, *upper, *xw, *xtail, *offset, *dref, *f, *minvf, *U,
      *part;
  const float* tight = nullptr;
};

// The condensed controller tick on the whole block, from xw = [x0 | w], ref
// and the shifted warm start z, y, the boxes backed off by v.tight (the caller's last write of those is
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
    box_bounds(v.lo, v.hi, v.tight, i, off_z, v.lower + i, v.upper + i);
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
