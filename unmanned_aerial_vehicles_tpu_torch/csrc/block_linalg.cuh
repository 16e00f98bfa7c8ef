// Block-wide linear algebra of the condensed-QP controller kernels, shared
// by the multi-tick kernels (tick_kernel.cu: K5; noisy_tick_kernel.cu: K9)
// and the single-tick kernels (single_tick_kernels.cu: K6, K3, K4), so all
// run one device implementation of the matvecs and the composite-ADMM
// iteration.
//
// Every sum runs in a fixed order (no atomics, fixed shuffle trees), so two
// launches on the same inputs agree bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "plant_math.cuh"

namespace uav {

// One element of a matrix that lies in shared memory (kSharedA) or in
// global memory, read through the read-only cache.
template <bool kSharedA>
__device__ __forceinline__ float load_a(const float* __restrict__ p) {
  if constexpr (kSharedA) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// sum_i v[i] * A[i * lda + j] for i < n: column j of a row-major matrix
// against a shared-memory vector. 16 loads of A are issued before their
// multiply-adds and 4 accumulators break the add chain, so a thread keeps
// 16 reads in flight instead of waiting out one L2 latency per element.
__device__ __forceinline__ float col_dot(const float* __restrict__ v,
                                         const float* __restrict__ A, int lda, int j, int n) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    float a[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) a[u] = A[(i + u) * lda + j];
#pragma unroll
    for (int u = 0; u < 16; ++u) acc[u & 3] += v[i + u] * a[u];
  }
  for (; i < n; ++i) acc[i & 3] += v[i] * A[i * lda + j];
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// col_dot for a 16-byte-aligned shared vector: the vector is read 4 floats
// per (broadcast) load, so the matrix column, not the vector, takes the
// memory bandwidth. The matrix lies in shared memory (kSharedA, the
// default) or in global memory. Same summation order as col_dot.
template <bool kSharedA = true>
__device__ __forceinline__ float col_dot_smem(const float* __restrict__ v,
                                              const float* __restrict__ A, int lda, int j,
                                              int n) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    float a[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) a[u] = load_a<kSharedA>(A + (i + u) * lda + j);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 w = v4[(i >> 2) + q];
      acc[0] += w.x * a[4 * q];
      acc[1] += w.y * a[4 * q + 1];
      acc[2] += w.z * a[4 * q + 2];
      acc[3] += w.w * a[4 * q + 3];
    }
  }
  for (; i < n; ++i) acc[i & 3] += v[i] * load_a<kSharedA>(A + i * lda + j);
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Block matrix-vector product out[j] = sum_i v[i] A[i * lda + j] for
// j < n_out, i < n_in, in two phases around a barrier: matvec_partial
// splits each column's sum into `parts` slices over the block's threads
// (so a short output uses every thread, and each thread's chain of
// dependent L2 reads is shorter); matvec_total adds the slices in a fixed
// order (deterministic).
__device__ __forceinline__ int matvec_parts(int n_out, int nth) {
  return n_out >= nth ? 1 : nth / n_out;
}

__device__ __forceinline__ void matvec_partial(const float* __restrict__ v,
                                               const float* __restrict__ A, int lda, int n_in,
                                               int n_out, float* __restrict__ part, int tid,
                                               int nth) {
  const int parts = matvec_parts(n_out, nth);
  const int chunk = (n_in + parts - 1) / parts;
  for (int t = tid; t < parts * n_out; t += nth) {
    const int j = t % n_out, q = t / n_out;
    const int i0 = min(n_in, q * chunk), i1 = min(n_in, i0 + chunk);
    part[t] = col_dot(v + i0, A + i0 * lda, lda, j, i1 - i0);
  }
}

__device__ __forceinline__ float matvec_total(const float* __restrict__ part, int n_out,
                                              int nth, int j) {
  const int parts = matvec_parts(n_out, nth);
  float acc = 0.0f;
  for (int q = 0; q < parts; ++q) acc += part[q * n_out + j];
  return acc;
}

// out[r] = sum_j A[r * lda + j] v[j] for r < n_rows, j < n: one warp per
// row (neighbouring lanes read neighbouring elements of the row), each
// lane's partial sum reduced by a fixed xor-shuffle tree. Returns nothing:
// lane 0 of the row's warp calls emit(r, sum).
template <class Emit>
__device__ __forceinline__ void row_dots_warp(const float* __restrict__ A, int lda,
                                              const float* __restrict__ v, int n, int n_rows,
                                              int tid, int nth, Emit emit) {
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;
  for (int r = warp; r < n_rows; r += n_warps) {
    const float* row = A + r * lda;
    float acc = 0.0f;
    for (int j = lane; j < n; j += 32) acc += __ldg(row + j) * v[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) emit(r, acc);
  }
}

// Row i's ADMM box: the static bounds [lo, hi] backed off by the
// tightening row (tight == nullptr: none) and shifted by the prediction
// offset off_z (zero outside the X-block). The single-tick kernel K4 and
// the multi-tick kernel K5 both form their boxes here.
__device__ __forceinline__ void box_bounds(const float* __restrict__ lo,
                                           const float* __restrict__ hi,
                                           const float* __restrict__ tight, int i, float off_z,
                                           float* lower, float* upper) {
  if (tight != nullptr) {
    const float t = tight[i];
    *lower = (lo[i] + t) - off_z;
    *upper = (hi[i] - t) - off_z;
  } else {
    *lower = lo[i] - off_z;
    *upper = hi[i] - off_z;
  }
}

// `iterations` steps of operator-composed over-relaxed ADMM, one (m, m)
// matvec with P1 = G M^-1 G' per step:
//   GU = p0 + (rho z - y) P1,  Gt = a GU + (1 - a) z,
//   z  = clip(Gt + y / rho, lower, upper),  y += rho (Gt - z).
// Thread j owns column j; the matvec input rho z - y is double-buffered in
// va / vb (16-byte aligned), so each step needs one barrier. On entry va
// holds rho z - y and a barrier has passed; returns the buffer that holds
// it for the final (z, y).
template <bool kSharedP1>
__device__ __forceinline__ float* composite_admm(const float* __restrict__ P1, int m,
                                                 const float* __restrict__ p0,
                                                 const float* __restrict__ lower,
                                                 const float* __restrict__ upper, float* z,
                                                 float* y, float* va, float* vb, float rho,
                                                 float over_relax, float one_minus_over_relax,
                                                 int iterations, int tid, int nth) {
  float* vsrc = va;
  float* vdst = vb;
  for (int it = 0; it < iterations; ++it) {
    for (int j = tid; j < m; j += nth) {
      const float GU = p0[j] + col_dot_smem<kSharedP1>(vsrc, P1, m, j, m);
      const float Gt = over_relax * GU + one_minus_over_relax * z[j];
      const float zn = clipf(Gt + y[j] / rho, lower[j], upper[j]);
      const float yn = y[j] + rho * (Gt - zn);
      z[j] = zn;
      y[j] = yn;
      vdst[j] = rho * zn - yn;
    }
    __syncthreads();
    float* tmp = vsrc;
    vsrc = vdst;
    vdst = tmp;
  }
  return vsrc;
}

// Block-wide copy of an (n,) float array from global into shared memory,
// 16 bytes per load where both ends are 16-byte aligned.
__device__ __forceinline__ void copy_floats_to_shared(float* __restrict__ dst,
                                                      const float* __restrict__ src, int n,
                                                      int tid, int nth) {
  const int n4 = n / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
  for (int i = tid; i < n4; i += nth) d4[i] = __ldg(s4 + i);
  for (int i = 4 * n4 + tid; i < n; i += nth) dst[i] = __ldg(src + i);
}

}  // namespace uav
