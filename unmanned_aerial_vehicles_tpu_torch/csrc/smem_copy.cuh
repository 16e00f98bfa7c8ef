// Copies from global into shared memory.
//
// copy_to_shared: a block-wide copy of float4 rows. Each thread issues
// kInFlight independent 16-byte loads before it stores any of them, so a
// block waits out a few L2 round trips for the whole copy instead of one
// per element. Both pointers must be 16-byte aligned.
//
// copy16_async / copies16_wait: one thread's 16-byte asynchronous copies
// (cp.async: the data goes to shared memory without passing through the
// thread's registers, and the thread goes on at once); copies16_wait waits
// for all of the thread's copies, and a block barrier after it makes them
// visible to the block.

#pragma once

#include <cuda_runtime.h>

namespace uav {

template <int kInFlight = 4>
__device__ __forceinline__ void copy_to_shared(float4* __restrict__ dst,
                                               const float4* __restrict__ src, int n4, int tid,
                                               int nth) {
  for (int i0 = tid; i0 < n4; i0 += kInFlight * nth) {
    float4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * nth;
      if (i < n4) v[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * nth;
      if (i < n4) dst[i] = v[u];
    }
  }
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies16_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

}  // namespace uav
