// K12: MPPI's sampling stage in one launch: K candidate control sequences
// rolled through N RK4 steps of the 12-state rigid body, each step's
// tracking cost summed, plus the terminal term; out: the (K,) costs.
//
// Replaces the JAX package's ops/mppi_pallas.py:_mppi_call (pallas_call at
// :109; mppi_rollout_costs_fused). Its plain version is the port's
// ops/mppi_pallas.py:mppi_rollout_costs_plain.
//
// What bounds it on an H100: latency. At 512 x 25 the work is ~4 M FP32
// operations and ~205 KB of candidates, under a tenth of a microsecond at
// the card's rates; each sample's 25 steps are one dependent chain of 100
// derivative evaluations, each with three accurate sines and cosines, a
// tangent, a square root and seven IEEE divisions.
//
// Design: a group of 8 lanes per sample, four samples a warp, eight a block
// of 64 threads (ops/mppi_pallas.py:mppi_launch_geometry: 64 blocks at
// K=512; 128-thread blocks measured 0.7% slower, PERF.md). Every
// lane carries the whole state; each derivative spreads its sines and
// cosines and its seven quotients over the group's lanes and shares them by
// shuffles (rigid_math.cuh rigid_rk4_warp, the same arithmetic as
// rigid_rk4), so a derivative waits for one sincosf and one division
// instead of three and seven in a row. Before its steps a group copies its
// sample's (N, 4) row of the row-major candidates into shared memory, each
// lane a share of the 16-byte loads, and the block copies the targets: no
// global load sits on a step's chain. Horizons past kChunk steps are
// staged kChunk steps at a time. A group past K reads sample K - 1 and
// writes nothing, so every lane stays in the shuffles and any K launches.
// The stage cost is the JAX kernel's, formed on every lane of the group in
// the plain version's order: position, velocity, levelness, the yaw error
// wrapped as a floor-mod (plant_math.cuh wrap_angle: fmodf plus the sign
// fix), rates and the control deviation from hover; the terminal term adds
// (terminal_weight - 1) times the last stage's position and velocity
// terms. Lane 0 writes the cost.
//
// With -DUAV_SECTION_CLOCKS (the mppi_clocks library) lane 0 of each group
// counts its cycles: the staging, each RK4 step, one more derivative per
// step at the step's end state (timed alone, its outputs waited for), and
// the whole sample (ops/mppi_pallas.py:mppi_section_cycles).

#include <cuda_runtime.h>

#include "plant_math.cuh"
#include "rigid_math.cuh"
#include "section_clocks.cuh"

// Host-visible: laid out as ops/mppi_pallas.py _MppiCost.
struct MppiCost {
  float q_pos, q_vel, q_att, q_yaw, q_rate, r0, r1, r2, r3;
  float terminal_scale;   // terminal_weight - 1
  float uh[4];            // hover control
};

namespace {

constexpr int kLanes = 8;                            // ops/mppi_pallas.py K12_LANES_PER_SAMPLE
constexpr int kMaxThreads = 64;
constexpr int kMaxGroups = kMaxThreads / kLanes;
constexpr int kChunk = 32;                           // steps staged at a time

#ifdef UAV_SECTION_CLOCKS
// wait for a result before the clock is read (an instruction that uses it)
#define K12_SETTLE(x) asm volatile("add.f32 %0, %0, 0f00000000;" : "+f"(x))
#endif

__global__ void __launch_bounds__(kMaxThreads)
mppi_costs_kernel(const float* __restrict__ x0, const float4* __restrict__ U,
                  const float* __restrict__ targets, const float* __restrict__ target_yaw,
                  float* __restrict__ costs, int K, int N, uav::RK4Step st, uav::RigidBody b,
                  MppiCost w) {
  __shared__ float4 ctrl[kMaxGroups][kChunk];
  __shared__ float tgt[3 * kChunk];
  const int lane = threadIdx.x & (kLanes - 1);
  const int g = threadIdx.x / kLanes;
  const int k_raw = blockIdx.x * (blockDim.x / kLanes) + g;
  const int k = min(k_raw, K - 1);
#ifdef UAV_SECTION_CLOCKS
  long long t_staging = 0, t_steps = 0, t_derivatives = 0;
  const long long t_whole = clock64();
#endif
  float s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = __ldg(x0 + i);
  const float yaw = __ldg(target_yaw);
  const float4* Uk = U + (size_t)k * N;
  float c = 0.0f;
  for (int i0 = 0; i0 < N; i0 += kChunk) {
#ifdef UAV_SECTION_CLOCKS
    const long long t0 = clock64();
#endif
    const int len = min(kChunk, N - i0);
    __syncthreads();   // every group is done with the last chunk
    for (int j = lane; j < len; j += kLanes) ctrl[g][j] = __ldg(Uk + i0 + j);
    for (int j = threadIdx.x; j < 3 * len; j += blockDim.x) tgt[j] = __ldg(targets + 3 * i0 + j);
    __syncthreads();
#ifdef UAV_SECTION_CLOCKS
    t_staging += clock64() - t0;
#endif
    for (int i = 0; i < len; ++i) {
      const float4 u4 = ctrl[g][i];
      const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#ifdef UAV_SECTION_CLOCKS
      const long long t1 = clock64();
#endif
      uav::rigid_rk4_warp<kLanes>(s, u, b, nullptr, st, lane);
#ifdef UAV_SECTION_CLOCKS
#pragma unroll
      for (int j = 0; j < 12; ++j) K12_SETTLE(s[j]);
      const long long t2 = clock64();
      t_steps += t2 - t1;
      float d[12];
      uav::rigid_derivative_warp<kLanes>(s, u, b, nullptr, lane, d);
#pragma unroll
      for (int j = 0; j < 12; ++j) K12_SETTLE(d[j]);
      t_derivatives += clock64() - t2;
#endif
      const float ex = s[0] - tgt[3 * i];
      const float ey = s[1] - tgt[3 * i + 1];
      const float ez = s[2] - tgt[3 * i + 2];
      const float du0 = u[0] - w.uh[0], du1 = u[1] - w.uh[1];
      const float du2 = u[2] - w.uh[2], du3 = u[3] - w.uh[3];
      const float dyaw = uav::wrap_angle(s[8] - yaw);
      c = c + (w.q_pos * (ex * ex + ey * ey + ez * ez)
               + w.q_vel * (s[3] * s[3] + s[4] * s[4] + s[5] * s[5])
               + w.q_att * (s[6] * s[6] + s[7] * s[7])
               + w.q_yaw * dyaw * dyaw
               + w.q_rate * (s[9] * s[9] + s[10] * s[10] + s[11] * s[11])
               + w.r0 * du0 * du0 + w.r1 * du1 * du1
               + w.r2 * du2 * du2 + w.r3 * du3 * du3);
    }
  }
  // the last stage's target: the last chunk, still staged
  const float* tl = tgt + 3 * ((N - 1) % kChunk);
  const float ex = s[0] - tl[0], ey = s[1] - tl[1], ez = s[2] - tl[2];
  const float cost = c + w.terminal_scale * (w.q_pos * (ex * ex + ey * ey + ez * ez)
                                             + w.q_vel * (s[3] * s[3] + s[4] * s[4] + s[5] * s[5]));
  if (lane != 0 || k_raw >= K) return;
  costs[k] = cost;
#ifdef UAV_SECTION_CLOCKS
  const unsigned long long counts[6] = {
      (unsigned long long)t_staging, (unsigned long long)t_steps,
      (unsigned long long)t_derivatives, (unsigned long long)(clock64() - t_whole),
      (unsigned long long)N, 1ull};
  for (int i = 0; i < 6; ++i) atomicAdd(&uav::g_section_cycles[i], counts[i]);
#endif
}

}  // namespace

extern "C" {

// blocks x threads from ops/mppi_pallas.py:mppi_launch_geometry: whole
// warps (the shuffles), at most kMaxThreads, every sample covered.
int mppi_costs_launch(const float* x0, const float* U, const float* targets,
                      const float* target_yaw, float* costs, int K, int N,
                      const uav::RK4Step* st, const uav::RigidBody* body,
                      const MppiCost* weights, int blocks, int threads, void* stream) {
  if (K < 1 || N < 1 || threads % 32 != 0 || threads > kMaxThreads ||
      (long long)blocks * (threads / kLanes) < K)
    return (int)cudaErrorInvalidConfiguration;
  mppi_costs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x0, reinterpret_cast<const float4*>(U), targets, target_yaw, costs, K, N, *st, *body,
      *weights);
  return (int)cudaGetLastError();
}

// The section clocks since the last call (staging, RK4 steps, the timed
// derivatives, whole samples, steps, samples), then reset;
// cudaErrorNotSupported unless built with -DUAV_SECTION_CLOCKS.
int mppi_section_cycles(unsigned long long* out) { return uav::read_section_cycles(out, 6); }

}  // extern "C"
