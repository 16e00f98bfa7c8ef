// Block-wide linear algebra of the condensed-QP controller kernels, shared
// by the multi-tick kernels (tick_kernel.cu: K5; noisy_tick_kernel.cu: K9)
// and the single-tick kernels (single_tick_kernels.cu: K6, K3, K4), so all
// run one device implementation of the matvecs and the composite-ADMM
// iteration: on P1 (composite_admm: K4, K5, K9 and K6 without Su') or on
// P1's two factors (factored_admm_slices, factored_admm: K3, and K6 given
// Su').
//
// Every sum runs in a fixed order (no atomics, fixed shuffle trees), so two
// launches on the same inputs agree bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "plant_math.cuh"
#include "section_clocks.cuh"

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

// col_dot's sum (the same order, so the same result) with every accumulator
// indexed by a constant, the tail in groups of 4 rows too, so that the
// accumulators stay in registers (col_dot's tail indexes them by i & 3,
// which puts them in local memory).
__device__ __forceinline__ float col_dot_static(const float* __restrict__ v,
                                                const float* __restrict__ A, int lda, int j,
                                                int n) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    float a[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) a[u] = A[(i + u) * lda + j];
#pragma unroll
    for (int u = 0; u < 16; ++u) acc[u & 3] += v[i + u] * a[u];
  }
  for (; i < n; i += 4) {
    const float* col = A + i * lda + j;
    acc[0] += v[i] * col[0];
    if (i + 1 < n) acc[1] += v[i + 1] * col[lda];
    if (i + 2 < n) acc[2] += v[i + 2] * col[2 * lda];
    if (i + 3 < n) acc[3] += v[i + 3] * col[3 * lda];
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// matvec_partial with col_dot_static: the same slices and sums.
__device__ __forceinline__ void matvec_partial_static(const float* __restrict__ v,
                                                      const float* __restrict__ A, int lda,
                                                      int n_in, int n_out,
                                                      float* __restrict__ part, int tid,
                                                      int nth) {
  const int parts = matvec_parts(n_out, nth);
  const int chunk = (n_in + parts - 1) / parts;
  for (int t = tid; t < parts * n_out; t += nth) {
    const int j = t % n_out, q = t / n_out;
    const int i0 = min(n_in, q * chunk), i1 = min(n_in, i0 + chunk);
    part[t] = col_dot_static(v + i0, A + i0 * lda, lda, j, i1 - i0);
  }
}

// col_dot_smem's sum (the same order) with A in device memory (read-only
// cache), every accumulator indexed by a constant and the tail in groups of
// 4 rows too, so that the accumulators stay in registers (col_dot_smem's
// tail indexes them by i & 3, which puts them in local memory). The vector
// is read 4 floats per load throughout: v is 16-byte aligned and readable
// to n rounded up to 4.
__device__ __forceinline__ float col_dot_aligned(const float* __restrict__ v,
                                                 const float* __restrict__ A, int lda, int j,
                                                 int n) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    float a[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) a[u] = __ldg(A + (i + u) * lda + j);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 w = v4[(i >> 2) + q];
      acc[0] += w.x * a[4 * q];
      acc[1] += w.y * a[4 * q + 1];
      acc[2] += w.z * a[4 * q + 2];
      acc[3] += w.w * a[4 * q + 3];
    }
  }
  for (; i < n; i += 4) {
    const float4 w = v4[i >> 2];
    const float* col = A + i * lda + j;
    acc[0] += w.x * __ldg(col);
    if (i + 1 < n) acc[1] += w.y * __ldg(col + lda);
    if (i + 2 < n) acc[2] += w.z * __ldg(col + 2 * lda);
    if (i + 3 < n) acc[3] += w.w * __ldg(col + 3 * lda);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The slices of matvec_partial_aligned: matvec_partial's count, each of a
// multiple of 4 rows, so that every slice starts 16-byte aligned. Thread
// tid's column, first row and rows (has: the thread owns a slice sum, part
// index tid).
__device__ __forceinline__ void aligned_slice(int n_in, int n_out, int tid, int nth, bool& has,
                                              int& j, int& i0, int& len) {
  const int parts = matvec_parts(n_out, nth);
  const int chunk = ((n_in + parts - 1) / parts + 3) & ~3;
  has = tid < parts * n_out;
  j = tid % n_out;
  i0 = min(n_in, (tid / n_out) * chunk);
  len = has ? min(n_in, i0 + chunk) - i0 : 0;
}

// matvec_partial for a 16-byte-aligned shared vector and A in device memory:
// aligned_slice's slices, the vector read 4 floats per (broadcast) load
// (col_dot_aligned). matvec_total adds the slices.
__device__ __forceinline__ void matvec_partial_aligned(const float* __restrict__ v,
                                                       const float* __restrict__ A, int lda,
                                                       int n_in, int n_out,
                                                       float* __restrict__ part, int tid,
                                                       int nth) {
  for (int t = tid; t < matvec_parts(n_out, nth) * n_out; t += nth) {
    bool has;
    int j, i0, len;
    aligned_slice(n_in, n_out, t, nth, has, j, i0, len);
    part[t] = col_dot_aligned(v + i0, A + i0 * lda, lda, j, len);
  }
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

// ---- the composite-ADMM step on P1's two factors -------------------------
//
// For G = [I; Su] (n_t rows of I over n_x = m - n_t rows of Su), v P1 =
// [t | t Su'] with t = v GM^-1: 64 N^2 multiply-adds a step at horizon N
// (4N controls, 6N states) against P1's 100 N^2. A step:
//   t = v GM^-1 (n_t outputs, m-term sums),  GU = p0 + [t | t Su'],
// then composite_admm's relaxation, clip and dual update in its order, with
// y / rho as y * (1 / rho). K3 and K6 hold each thread's slices of both
// factors in registers (FactorSlices); past the slices' bounds they read
// the factors through L2 (factored_admm).

// t = v GM^-1 with GM^-1 in device memory (read-only cache), in one of two
// layouts; emit(c, t_c) is called once for each output, by one thread.
// Every thread of the block calls it.
//   kRowT false: A = GM^-1 as m rows of lda >= n_t floats; the sums in
//     matvec_partial_aligned's slices (v 16-byte aligned), a barrier, then
//     matvec_total; thread c emits output c.
//   kRowT true: A = (GM^-1)' as n_t rows of lda >= m floats; warp w takes
//     rows w + qW (q < 8, W warps) at a time, lane l sums elements l, l +
//     32, ... of each row, and the eight rows meet in one xor tree (offsets
//     16, 8, 4, 2, 1) that halves the rows a lane carries at offsets 16, 8
//     and 4, so that lanes 4q..4q+3 end with row q's sum (each row's sum in
//     the order of a plain xor tree over its lanes); lane 4q emits it. No
//     barrier.
template <bool kRowT, class Emit>
__device__ __forceinline__ void factor_t(const float* __restrict__ v,
                                         const float* __restrict__ A, int lda, int m, int n_t,
                                         float* __restrict__ part, int tid, int nth, Emit emit) {
  if constexpr (!kRowT) {
    matvec_partial_aligned(v, A, lda, m, n_t, part, tid, nth);
    __syncthreads();
    for (int c = tid; c < n_t; c += nth) emit(c, matvec_total(part, n_t, nth, c));
  } else {
    const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;
    const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
    for (int c0 = warp; c0 < n_t; c0 += 8 * n_warps) {
      float acc[8];
      const float* row[8];
      bool valid[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        acc[q] = 0.0f;
        valid[q] = c0 + q * n_warps < n_t;
        row[q] = A + min(c0 + q * n_warps, n_t - 1) * lda;
      }
#pragma unroll 2
      for (int i = lane; i < m; i += 32) {
        const float x = v[i];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (valid[q]) acc[q] += __ldg(row[q] + i) * x;
        }
      }
      // offset 16: lanes 0-15 keep rows 0-3, lanes 16-31 rows 4-7
      float k4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        k4[q] = (hi16 ? acc[4 + q] : acc[q]) +
                __shfl_xor_sync(0xffffffffu, hi16 ? acc[q] : acc[4 + q], 16);
      }
      // offset 8: bit 3 keeps the upper two of the four; offset 4: bit 2
      // the upper one of the two
      float k2[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        k2[q] = (hi8 ? k4[2 + q] : k4[q]) +
                __shfl_xor_sync(0xffffffffu, hi8 ? k4[q] : k4[2 + q], 8);
      }
      float keep = (hi4 ? k2[1] : k2[0]) + __shfl_xor_sync(0xffffffffu, hi4 ? k2[0] : k2[1], 4);
      keep += __shfl_xor_sync(0xffffffffu, keep, 2);
      keep += __shfl_xor_sync(0xffffffffu, keep, 1);
      const int c = c0 + ((hi16 ? 4 : 0) + (hi8 ? 2 : 0) + (hi4 ? 1 : 0)) * n_warps;
      if ((lane & 3) == 0 && c < n_t) emit(c, keep);
    }
  }
}

// matvec_total for up to 8 slices with all their loads issued at once (the
// same sum); more slices take matvec_total's loop.
__device__ __forceinline__ float slices_total(const float* __restrict__ part, int n_out, int nth,
                                              int j) {
  const int parts = matvec_parts(n_out, nth);
  if (parts > 8) return matvec_total(part, n_out, nth, j);
  float x[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) x[q] = q < parts ? part[q * n_out + j] : 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (q < parts) acc += x[q];
  }
  return acc;
}

// `iterations` factored steps: t_phase(v, emit) forms t = v GM^-1 and calls
// emit(c, t_c) once for each output (factor_t, slices_t); x_phase() leaves
// the slices of t Su' in part (the X-block's n_x outputs), which
// slices_total adds after a barrier. ts (n_t floats, 16-byte aligned)
// holds t, part the slices (nth floats). On entry va holds rho z - y and a
// barrier has passed; returns the buffer that holds it for the final (z,
// y). clock_base: the first of the section clocks of a step's three phases
// (t and the U-block update, t Su', the X-block update), or -1.
template <class TPhase, class XPhase>
__device__ __forceinline__ float* factored_steps(TPhase t_phase, XPhase x_phase, int m, int n_t,
                                                 const float* __restrict__ p0,
                                                 const float* __restrict__ lower,
                                                 const float* __restrict__ upper, float* z,
                                                 float* y, float* va, float* vb, float* ts,
                                                 float* part, float rho, float over_relax,
                                                 float one_minus_over_relax, int iterations,
                                                 int tid, int nth, int clock_base) {
  const float inv_rho = 1.0f / rho;
  const int n_x = m - n_t;
  float* vsrc = va;
  float* vdst = vb;
  [[maybe_unused]] auto section = [clock_base](int k) {
    return clock_base < 0 ? -1 : clock_base + k;
  };
  for (int it = 0; it < iterations; ++it) {
    SECTION_START(c_t);
    auto update = [&](int j, float GU) {
      const float Gt = over_relax * GU + one_minus_over_relax * z[j];
      const float zn = clipf(Gt + y[j] * inv_rho, lower[j], upper[j]);
      const float yn = y[j] + rho * (Gt - zn);
      z[j] = zn;
      y[j] = yn;
      vdst[j] = rho * zn - yn;
    };
    t_phase(vsrc, [&](int c, float t) {
      ts[c] = t;
      update(c, p0[c] + t);
    });
    __syncthreads();
    SECTION_START(c_s);
    if (tid == 0) SECTION_ADD(section(0), c_t);
    x_phase();
    __syncthreads();
    SECTION_START(c_x);
    if (tid == 0) SECTION_ADD(section(1), c_s);
    for (int r = tid; r < n_x; r += nth) {
      update(n_t + r, p0[n_t + r] + slices_total(part, n_x, nth, r));
    }
    __syncthreads();
    if (tid == 0) SECTION_ADD(section(2), c_x);
    float* tmp = vsrc;
    vsrc = vdst;
    vdst = tmp;
  }
  return vsrc;
}

// factored_steps with both factors read through L2 every step: t by
// factor_t, t Su' in matvec_partial_aligned's slices (Su' as S, n_t rows
// of m - n_t floats). Three barriers a step (kRowT) or four.
template <bool kRowT>
__device__ __forceinline__ float* factored_admm(const float* __restrict__ A, int lda,
                                                const float* __restrict__ S, int m, int n_t,
                                                const float* __restrict__ p0,
                                                const float* __restrict__ lower,
                                                const float* __restrict__ upper, float* z,
                                                float* y, float* va, float* vb, float* ts,
                                                float* part, float rho, float over_relax,
                                                float one_minus_over_relax, int iterations,
                                                int tid, int nth, int clock_base = -1) {
  return factored_steps(
      [&](const float* v, auto emit) { factor_t<kRowT>(v, A, lda, m, n_t, part, tid, nth, emit); },
      [&] { matvec_partial_aligned(ts, S, m - n_t, n_t, m - n_t, part, tid, nth); }, m, n_t, p0,
      lower, upper, z, y, va, vb, ts, part, rho, over_relax, one_minus_over_relax, iterations,
      tid, nth, clock_base);
}

// ---- the factors' slices held in registers ------------------------------
//
// Each thread holds, for the whole launch, its aligned_slice of each
// product: of t = v GM^-1, column tid % n_t over the rows [a0, a0 + alen)
// of slice tid / n_t, and of t Su' the same for column tid % n_x. kA and kB
// (multiples of 4) bound the slices' rows (the caller picks them from the
// shape); rows past a slice's end hold 0. The sums are col_dot_aligned's,
// in the same order, so each slice sum equals matvec_partial_aligned's.
template <int kA, int kB>
struct FactorSlices {
  float a[kA], b[kB];
  int a0, alen, b0, blen;   // each slice's first row and rows
  bool has_a, has_b;        // the thread writes a slice sum (part index tid)
};

// Load thread tid's slices from device memory: GM^-1 as m rows of lda
// floats (kRowT false: element (i, j) at A[i lda + j]; neighbouring threads
// read neighbouring columns) or as its transpose (kRowT true: at
// A[j lda + i]; a thread's slice is contiguous, read 16 bytes a load where
// lda is a multiple of 4, else 8: lda even), Su' as n_t rows of n_x floats.
template <bool kRowT, int kA, int kB>
__device__ __forceinline__ void load_factor_slices(FactorSlices<kA, kB>& s,
                                                   const float* __restrict__ A, int lda,
                                                   const float* __restrict__ S, int m, int n_t,
                                                   int tid, int nth) {
  static_assert(kA % 4 == 0 && kB % 4 == 0, "slices of whole float4 groups");
  const int n_x = m - n_t;
  int j;
  aligned_slice(m, n_t, tid, nth, s.has_a, j, s.a0, s.alen);
  if constexpr (kRowT) {
    const float* row = A + j * lda + s.a0;
    if ((lda & 3) == 0) {
      const float4* a4 = reinterpret_cast<const float4*>(row);
#pragma unroll
      for (int u = 0; u < kA / 4; ++u) {
        const float4 x = 4 * u < s.alen ? __ldg(a4 + u) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        s.a[4 * u] = x.x;
        s.a[4 * u + 1] = x.y;
        s.a[4 * u + 2] = x.z;
        s.a[4 * u + 3] = x.w;
      }
    } else {
      const float2* a2 = reinterpret_cast<const float2*>(row);
#pragma unroll
      for (int u = 0; u < kA / 2; ++u) {
        const float2 x = 2 * u < s.alen ? __ldg(a2 + u) : make_float2(0.0f, 0.0f);
        s.a[2 * u] = x.x;
        s.a[2 * u + 1] = x.y;
      }
    }
  } else {
    const float* a = A + s.a0 * lda + j;
#pragma unroll
    for (int u = 0; u < kA; ++u) s.a[u] = u < s.alen ? __ldg(a + u * lda) : 0.0f;
  }
  aligned_slice(n_t, n_x, tid, nth, s.has_b, j, s.b0, s.blen);
  const float* b = S + s.b0 * n_x + j;
#pragma unroll
  for (int u = 0; u < kB; ++u) s.b[u] = u < s.blen ? __ldg(b + u * n_x) : 0.0f;
}

// sum_u v[u] a[u] for u < len in col_dot_aligned's order. v is 16-byte
// aligned and its kN floats lie in shared memory: all kN / 4 loads are
// issued at once and the elements past len enter as 0 (an added 0 leaves
// each sum as it was).
template <int kN>
__device__ __forceinline__ float slice_dot(const float (&a)[kN], const float* __restrict__ v,
                                           int len) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float4 w[kN / 4];
#pragma unroll
  for (int g = 0; g < kN / 4; ++g) w[g] = v4[g];
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int g = 0; g < kN / 4; ++g) {
    acc[0] += (4 * g < len ? w[g].x : 0.0f) * a[4 * g];
    acc[1] += (4 * g + 1 < len ? w[g].y : 0.0f) * a[4 * g + 1];
    acc[2] += (4 * g + 2 < len ? w[g].z : 0.0f) * a[4 * g + 2];
    acc[3] += (4 * g + 3 < len ? w[g].w : 0.0f) * a[4 * g + 3];
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// t = v GM^-1 from the register slices (factor_t's kRowT-false sums): the
// slice sums, a barrier, the slices added; emit(c, t_c) by thread c.
template <int kA, int kB, class Emit>
__device__ __forceinline__ void slices_t(const FactorSlices<kA, kB>& s, const float* v, int n_t,
                                         float* part, int tid, int nth, Emit emit) {
  if (s.has_a) part[tid] = slice_dot(s.a, v + s.a0, s.alen);
  __syncthreads();
  for (int c = tid; c < n_t; c += nth) emit(c, slices_total(part, n_t, nth, c));
}

// factored_steps on the register slices (four barriers a step).
template <int kA, int kB>
__device__ __forceinline__ float* factored_admm_slices(
    const FactorSlices<kA, kB>& s, int m, int n_t, const float* __restrict__ p0,
    const float* __restrict__ lower, const float* __restrict__ upper, float* z, float* y,
    float* va, float* vb, float* ts, float* part, float rho, float over_relax,
    float one_minus_over_relax, int iterations, int tid, int nth, int clock_base = -1) {
  return factored_steps(
      [&](const float* v, auto emit) { slices_t(s, v, n_t, part, tid, nth, emit); },
      [&] {
        if (s.has_b) part[tid] = slice_dot(s.b, ts + s.b0, s.blen);
      },
      m, n_t, p0, lower, upper, z, y, va, vb, ts, part, rho, over_relax, one_minus_over_relax,
      iterations, tid, nth, clock_base);
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
