// K7 (the fused GP posterior mean) and K15 (the blocked RBF Gram matrix).
//
// K15 rbf_gram_kernel replaces the JAX package's
// ops/rbf_pallas.py:rbf_kernel_matrix_pallas (pallas_call at :449, block
// _rbf_block_kernel at :29). Its plain version is the port's
// ops/rbf_pallas.py:rbf_kernel_matrix_plain (gp/kernels.py:rbf_kernel in
// float32):
//
//   out[i, j] = sigma^2 exp(-0.5 max(|z_i|^2 + |z_j|^2 - 2 z_i.z_j, 0)),
//   z = x / ls  (ls: one length scale per feature; a scalar is expanded)
//
// Design: a block owns a 64 x 64 output tile and 256 threads. It loads the
// tile's 64 rows of X1 and 64 rows of X2 (d <= 16 features), divides them by
// the length scales on load and keeps them feature-major in shared memory,
// with each row's squared norm computed once per tile. A thread computes a
// 4 x 4 micro-tile: rows ty + 16 r, columns 4 tx .. 4 tx + 3, so per
// feature it reads four broadcast row values and one 16-byte column vector
// and does 16 FMAs; the two rows of a warp are written with 16-byte stores,
// 256 contiguous bytes per row (scalar stores at a ragged edge or when n2 is
// not a multiple of 4). The distance keeps the JAX clamp at 0 exactly.
//
// What bounds K15 on an H100: bytes. The output is written once, 4 n1 n2
// bytes (1.57 GB at the 19,800-point corpus, ~0.47 ms at 3.35 TB/s); the
// arithmetic is ~2 d + 8 operations and one expf per entry.
//
// K7 rbf_posterior_mean_kernel replaces the JAX package's
// ops/rbf_pallas.py:rbf_posterior_mean_pallas
// (pallas_call at :342, row tier, and :406, packed tiers). Its plain
// version is the port's ops/rbf_pallas.py:rbf_posterior_mean_plain.
//
//   out[q] = sum_p exp(-0.5 max(|z_q|^2 + |z_p|^2 - 2 z_q.z_p, 0)) a[p] + y_mean
//   z_q = (x_q - shift) / ls,  z_p = x_p / ls,  a = sigma^2 alpha y_std
//
// Design: a block takes kQueries queries and kSlices threads per query. A
// thread keeps its query's scaled features and squared norm in registers.
// The training points stream through shared memory in chunks of kChunk
// records of 20 floats (z_p, |z_p|^2, a_p, padding; packed once per
// posterior by ops/rbf_pallas.py), copied with 16-byte loads, eight in
// flight per thread, and read back as five 16-byte loads per point; thread
// slice s takes the chunk's points s, s + kSlices, ..., and
// the kSlices partial sums of a query meet in a fixed shuffle order
// (deterministic, no atomics). The (m, P) cross-kernel matrix never leaves
// registers, so P has no limit. Masked training rows at the 1e6 sentinel
// give a distance of ~1e13 and exp(-0.5 d) = 0 exactly (no inf - inf).
// kSlices threads per query keep four times as many warps in flight as one
// thread per query: at m = 20480 one thread per query is five warps per SM.
//
// What bounds it on an H100: operations. Per (query, training point) pair
// ~38 FP32 operations (10-term dot, distance, accurate expf, 6-term
// accumulate); at m = 20480, P = 800 that is ~0.62 GFLOP, ~9 us at 67
// TFLOP/s, and 16.4 M expf. The bytes (queries, training records, outputs)
// are ~1.4 MB.

#include <cuda_runtime.h>

#include "smem_copy.cuh"

// Host-visible: laid out as ops/rbf_pallas.py's _MeanOperands and
// _GramOperands.
struct MeanOperands {
  const float *X, *rec, *y_mean, *ls, *shift;
  float* out;
};

struct GramOperands {
  const float *X1, *X2, *ls, *sig;
  float* out;
};

namespace {

constexpr int kD = 10;          // features (ops/rbf_pallas.py KERNEL_FEATURES)
constexpr int kOut = 6;         // outputs (KERNEL_OUTPUTS)
constexpr int kSlices = 4;      // threads per query
constexpr int kQueries = 32;    // queries per block
constexpr int kThreads = kQueries * kSlices;
constexpr int kRec = 20;        // floats per training record
constexpr int kChunk = 512;     // training records per shared-memory chunk (40 KB)
static_assert(kD == 10 && kOut == 6 && kRec == 20, "the record reads below assume this layout");

__global__ void __launch_bounds__(kThreads)
rbf_posterior_mean_kernel(const MeanOperands O, int m, int n_train) {
  __shared__ float4 rec4[kChunk * kRec / 4];
  const int tid = threadIdx.x;
  const int s = tid % kSlices;
  const int q = blockIdx.x * kQueries + tid / kSlices;
  const bool valid = q < m;

  float z[kD];
  float sq1 = 0.0f;
#pragma unroll
  for (int c = 0; c < kD; ++c) {
    const float x = valid ? O.X[q * kD + c] : 0.0f;
    z[c] = (x - __ldg(O.shift + c)) / __ldg(O.ls + c);
    sq1 += z[c] * z[c];
  }

  float acc[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) acc[o] = 0.0f;

  for (int base = 0; base < n_train; base += kChunk) {
    const int cnt = min(kChunk, n_train - base);
    __syncthreads();   // the previous chunk is consumed
    uav::copy_to_shared<8>(rec4, reinterpret_cast<const float4*>(O.rec) + base * (kRec / 4),
                           cnt * (kRec / 4), tid, kThreads);
    __syncthreads();
#pragma unroll 4
    for (int p = s; p < cnt; p += kSlices) {
      const float4* r = rec4 + p * (kRec / 4);
      // r0 = z0..z3, r1 = z4..z7, r2 = z8 z9 |z|^2 a0, r3 = a1..a4, r4 = a5
      const float4 r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3], r4 = r[4];
      float cross = z[0] * r0.x;
      cross = fmaf(z[1], r0.y, cross);
      cross = fmaf(z[2], r0.z, cross);
      cross = fmaf(z[3], r0.w, cross);
      cross = fmaf(z[4], r1.x, cross);
      cross = fmaf(z[5], r1.y, cross);
      cross = fmaf(z[6], r1.z, cross);
      cross = fmaf(z[7], r1.w, cross);
      cross = fmaf(z[8], r2.x, cross);
      cross = fmaf(z[9], r2.y, cross);
      const float k = expf(-0.5f * fmaxf(sq1 + r2.z - 2.0f * cross, 0.0f));
      acc[0] = fmaf(k, r2.w, acc[0]);
      acc[1] = fmaf(k, r3.x, acc[1]);
      acc[2] = fmaf(k, r3.y, acc[2]);
      acc[3] = fmaf(k, r3.z, acc[3]);
      acc[4] = fmaf(k, r3.w, acc[4]);
      acc[5] = fmaf(k, r4.x, acc[5]);
    }
  }

  // the kSlices partial sums of a query sit in adjacent lanes: add them in a
  // fixed order, (s0 + s2) + (s1 + s3)
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    acc[o] += __shfl_down_sync(0xffffffffu, acc[o], 2, kSlices);
    acc[o] += __shfl_down_sync(0xffffffffu, acc[o], 1, kSlices);
  }
  if (valid && s == 0) {
#pragma unroll
    for (int o = 0; o < kOut; ++o) O.out[q * kOut + o] = acc[o] + __ldg(O.y_mean + o);
  }
}

constexpr int kGramTile = 64;      // output rows and columns per block
constexpr int kGramMaxD = 16;      // ops/rbf_pallas.py GRAM_MAX_FEATURES
constexpr int kGramThreads = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each

__global__ void __launch_bounds__(kGramThreads)
rbf_gram_kernel(const GramOperands O, int n1, int n2, int d) {
  __shared__ __align__(16) float z1[kGramMaxD][kGramTile];
  __shared__ __align__(16) float z2[kGramMaxD][kGramTile];
  __shared__ __align__(16) float sq1[kGramTile];
  __shared__ __align__(16) float sq2[kGramTile];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.y * kGramTile, c0 = blockIdx.x * kGramTile;

  // the tile's rows, scaled on load (neighbouring threads read neighbouring
  // features of a row); rows past the edge load zeros
  for (int i = tid; i < kGramTile * d; i += kGramThreads) {
    const int row = i / d, c = i - row * d;
    const float l = __ldg(O.ls + c);
    const int a = r0 + row, b = c0 + row;
    z1[c][row] = a < n1 ? __ldg(O.X1 + (size_t)a * d + c) / l : 0.0f;
    z2[c][row] = b < n2 ? __ldg(O.X2 + (size_t)b * d + c) / l : 0.0f;
  }
  __syncthreads();
  if (tid < 2 * kGramTile) {
    float(*z)[kGramTile] = tid < kGramTile ? z1 : z2;
    const int row = tid % kGramTile;
    float s = 0.0f;
    for (int c = 0; c < d; ++c) s += z[c][row] * z[c][row];
    (tid < kGramTile ? sq1 : sq2)[row] = s;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
  for (int c = 0; c < d; ++c) {
    const float4 b = *reinterpret_cast<const float4*>(&z2[c][4 * tx]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = z1[c][ty + 16 * r];
      acc[r][0] = fmaf(a, b.x, acc[r][0]);
      acc[r][1] = fmaf(a, b.y, acc[r][1]);
      acc[r][2] = fmaf(a, b.z, acc[r][2]);
      acc[r][3] = fmaf(a, b.w, acc[r][3]);
    }
  }

  const float sig = __ldg(O.sig);
  const float4 s2 = *reinterpret_cast<const float4*>(&sq2[4 * tx]);
  const float s2v[4] = {s2.x, s2.y, s2.z, s2.w};
  const int col = c0 + 4 * tx;
  const bool vec = (n2 % 4 == 0) && col + 3 < n2;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty + 16 * r;
    if (row >= n1) continue;
    const float s1 = sq1[ty + 16 * r];
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = sig * expf(-0.5f * fmaxf(s1 + s2v[q] - 2.0f * acc[r][q], 0.0f));
    float* dst = O.out + (size_t)row * n2 + col;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < n2) dst[q] = o[q];
    }
  }
}

}  // namespace

extern "C" int rbf_posterior_mean_launch(const MeanOperands* ops, int m, int n_train,
                                         void* stream) {
  const int blocks = (m + kQueries - 1) / kQueries;
  rbf_posterior_mean_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*ops, m, n_train);
  return (int)cudaGetLastError();
}

extern "C" int rbf_gram_launch(const GramOperands* ops, int n1, int n2, int d, void* stream) {
  const dim3 grid((n2 + kGramTile - 1) / kGramTile, (n1 + kGramTile - 1) / kGramTile);
  rbf_gram_kernel<<<grid, kGramThreads, 0, (cudaStream_t)stream>>>(*ops, n1, n2, d);
  return (int)cudaGetLastError();
}
