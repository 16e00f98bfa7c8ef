// K7: the fused GP posterior mean.
//
// Replaces the JAX package's ops/rbf_pallas.py:rbf_posterior_mean_pallas
// (pallas_call at :342, row tier, and :406, packed tiers). Its plain version
// is the port's ops/rbf_pallas.py:rbf_posterior_mean_plain.
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

// Host-visible: laid out as ops/rbf_pallas.py's _MeanOperands.
struct MeanOperands {
  const float *X, *rec, *y_mean, *ls, *shift;
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

}  // namespace

extern "C" int rbf_posterior_mean_launch(const MeanOperands* ops, int m, int n_train,
                                         void* stream) {
  const int blocks = (m + kQueries - 1) / kQueries;
  rbf_posterior_mean_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*ops, m, n_train);
  return (int)cudaGetLastError();
}
