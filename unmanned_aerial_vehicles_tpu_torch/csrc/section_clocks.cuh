// Per-section clock counters, compiled in only with -DUAV_SECTION_CLOCKS
// (the *_clocks libraries of ops/_cuda.py, which chip_smoke.py reads for
// its breakdowns): one thread of each section adds its clock64() cycles
// over the launch; the kernel's *_section_cycles entry point reads and
// resets them (read_section_cycles). Each kernel source (its own library)
// has its own counters; -1 names no section.
#pragma once

#include <cuda_runtime.h>

namespace uav {

constexpr int kMaxSections = 16;
#ifdef UAV_SECTION_CLOCKS
__device__ unsigned long long g_section_cycles[kMaxSections];
__device__ __forceinline__ void section_add(int i, long long since) {
  if (i >= 0) atomicAdd(&g_section_cycles[i], (unsigned long long)(clock64() - since));
}
#define SECTION_START(var) const long long var = clock64()
#define SECTION_ADD(i, since) uav::section_add(i, since)
#else
#define SECTION_START(var)
#define SECTION_ADD(i, since)
#endif

// The first n counters summed since the last call (cycles) into out, then
// reset; cudaErrorNotSupported unless built with -DUAV_SECTION_CLOCKS.
// Synchronous: call after the launches finish.
inline int read_section_cycles(unsigned long long* out, int n) {
#ifdef UAV_SECTION_CLOCKS
  cudaError_t err = cudaMemcpyFromSymbol(out, g_section_cycles, n * sizeof(*out));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zeros[kMaxSections] = {};
  return (int)cudaMemcpyToSymbol(g_section_cycles, zeros, sizeof(zeros));
#else
  (void)out;
  (void)n;
  return (int)cudaErrorNotSupported;
#endif
}

}  // namespace uav
