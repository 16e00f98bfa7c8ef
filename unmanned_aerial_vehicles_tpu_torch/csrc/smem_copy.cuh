// Block-wide copy of float4 rows from global into shared memory.
//
// Each thread issues kInFlight independent 16-byte loads before it stores
// any of them, so a block waits out a few L2 round trips for the whole
// copy instead of one per element. Both pointers must be 16-byte aligned.

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

}  // namespace uav
