// K10: n sequential RK4 steps of the 12-state rigid body in one launch.
//
// Replaces the JAX package's ops/rigid_plant_pallas.py:_rollout_call
// (pallas_call at :147; rigid_body_rollout_fused, rigid_body_rk4_step_fused).
// Its plain version is the port's ops/rigid_plant_pallas.py:
// rigid_body_rollout_plain.
//
// Per step i: the controls u[i] (zero-order hold) and the optional
// derivative residuals res[i], `substeps` RK4 steps of dt / substeps
// (rigid_math.cuh), the state after the step written to out[i].
//
// What bounds it on an H100: latency. The flights call it with n = 1 (the
// plant step, 16 floats in, 12 out) and n = 20 (the LTV plan roll); each
// step is four derivative evaluations on one dependent chain, each with
// three accurate sines and cosines, a tangent, a square root and seven
// divisions. The bytes (at most ~2.5 KB) and operations (~1.5 k per RK4
// step) are nanoseconds at the card's rates; the chain's latency plus the
// launch is the time.
//
// Design: one warp carries the rollout. Each derivative spreads its sines
// and cosines and its seven quotients over a group of kLanes lanes and
// shares them by shuffles (rigid_math.cuh rigid_rk4_warp, K12's width), so
// it waits for one sincosf and one division instead of three and seven in
// a row; all four groups step the same state, because the shuffles take
// the full mask. Before the first step the warp copies the controls, and
// the residuals when given, into shared memory (kChunk steps at a time: the
// whole rollout up to 64 steps), so no global load sits on the chain;
// whether residuals are given is decided once, outside the loop
// (rollout<kRes>). Lanes 0-11 write one component each of each step's row.
// The arithmetic is rigid_rk4's, so the outputs equal the one-thread
// kernel's bit for bit.
//
// A population (loop/monte_carlo.py monte_carlo_mpc12: each member's true
// plant its own sampled body) launches a grid of one warp per member:
// block b reads member b's start, controls, residuals and body from
// device memory (rigid_rollout_batched_launch) and writes its rows, so
// each block runs the one-member arithmetic and agrees with a one-member
// launch bit for bit. The blocks are independent warps, so the card runs
// them all at once up to its resident-warp limit; the bound at B members
// is B times one member's bytes and operations.

#include <cuda_runtime.h>

#include "rigid_math.cuh"

namespace {

constexpr int kThreads = 32;   // one warp
constexpr int kLanes = 8;      // a derivative's lane group (K12's kLanes)
constexpr int kChunk = 64;     // steps staged at a time

template <bool kRes>
__device__ __forceinline__ void rollout(float s[12], const float* __restrict__ u,
                                        const float* __restrict__ res, float* __restrict__ out,
                                        int n, int substeps, const uav::RK4Step& st,
                                        const uav::RigidBody& b, int lane, float* ctrl,
                                        float* resid) {
  const int g = lane & (kLanes - 1);
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int len = min(kChunk, n - k0);
    __syncwarp();   // the last chunk's steps are done with its rows
    for (int j = lane; j < 4 * len; j += kThreads) ctrl[j] = __ldg(u + 4 * k0 + j);
    if (kRes) {
      for (int j = lane; j < 12 * len; j += kThreads) resid[j] = __ldg(res + 12 * k0 + j);
    }
    __syncwarp();
    for (int k = 0; k < len; ++k) {
      float uk[4], rk[12];
#pragma unroll
      for (int i = 0; i < 4; ++i) uk[i] = ctrl[4 * k + i];
      if (kRes) {
#pragma unroll
        for (int i = 0; i < 12; ++i) rk[i] = resid[12 * k + i];
      }
      for (int j = 0; j < substeps; ++j)
        uav::rigid_rk4_warp<kLanes>(s, uk, b, kRes ? rk : nullptr, st, g);
      float* row = out + (size_t)(k0 + k) * 12;
      float v = s[0];
#pragma unroll
      for (int i = 1; i < 12; ++i) v = lane == i ? s[i] : v;
      if (lane < 12) row[lane] = v;
    }
  }
}

// Block m rolls member m out: x0 (12), u (n x 4), res (n x 12) and out
// (n x 12) are member m's rows; its body is bodies[m], or `one` where
// `bodies` is null (a one-member launch passes its body by value).
__global__ void __launch_bounds__(kThreads)
rigid_rollout_kernel(const float* __restrict__ x0, const float* __restrict__ u,
                     const float* __restrict__ res, float* __restrict__ out, int n, int substeps,
                     uav::RK4Step st, uav::RigidBody one,
                     const uav::RigidBody* __restrict__ bodies) {
  __shared__ float ctrl[4 * kChunk];
  __shared__ float resid[12 * kChunk];
  const int lane = threadIdx.x, member = blockIdx.x;
  const uav::RigidBody b = bodies == nullptr ? one : bodies[member];
  x0 += member * 12;
  u += (size_t)member * n * 4;
  out += (size_t)member * n * 12;
  float s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = __ldg(x0 + i);
  if (res == nullptr) {
    rollout<false>(s, u, res, out, n, substeps, st, b, lane, ctrl, resid);
  } else {
    res += (size_t)member * n * 12;
    rollout<true>(s, u, res, out, n, substeps, st, b, lane, ctrl, resid);
  }
}

}  // namespace

extern "C" int rigid_rollout_launch(const float* x0, const float* u, const float* res, float* out,
                                    int n, int substeps, const uav::RK4Step* st,
                                    const uav::RigidBody* body, void* stream) {
  if (n < 0 || substeps < 0) return (int)cudaErrorInvalidValue;
  rigid_rollout_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(x0, u, res, out, n, substeps,
                                                                 *st, *body, nullptr);
  return (int)cudaGetLastError();
}

// `members` rollouts, one warp each, member m on bodies[m] (device memory,
// laid out as ops/rigid_plant_pallas.py _RigidBody): x0 (members x 12), u
// (members x n x 4), res (members x n x 12, or null), out (members x n x 12).
extern "C" int rigid_rollout_batched_launch(const float* x0, const float* u, const float* res,
                                            float* out, int n, int substeps, int members,
                                            const uav::RK4Step* st,
                                            const uav::RigidBody* bodies, void* stream) {
  if (n < 0 || substeps < 0 || members < 1 || bodies == nullptr)
    return (int)cudaErrorInvalidValue;
  rigid_rollout_kernel<<<members, kThreads, 0, (cudaStream_t)stream>>>(
      x0, u, res, out, n, substeps, *st, uav::RigidBody{}, bodies);
  return (int)cudaGetLastError();
}
