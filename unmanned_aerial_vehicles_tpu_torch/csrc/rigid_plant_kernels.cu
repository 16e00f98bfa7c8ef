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
// step is four derivative evaluations on one dependent chain, each six
// accurate sines and cosines, a tangent, a square root and seven divisions.
// The bytes (at most ~2.5 KB) and operations (~1.5 k per RK4 step) are
// nanoseconds at the card's rates; the chain's latency plus the launch is
// the time. The design is the simple one: one thread carries the state in
// registers through every step. Spreading each evaluation's sines and
// quotients over a warp (plant_math.cuh derivative_warp) is the next step.

#include <cuda_runtime.h>

#include "rigid_math.cuh"

namespace {

__global__ void rigid_rollout_kernel(const float* __restrict__ x0, const float* __restrict__ u,
                                     const float* __restrict__ res, float* __restrict__ out,
                                     int n, int substeps, uav::RK4Step st, uav::RigidBody b) {
  if (threadIdx.x != 0) return;
  float s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = x0[i];
  for (int k = 0; k < n; ++k) {
    float uk[4], rk[12];
#pragma unroll
    for (int i = 0; i < 4; ++i) uk[i] = u[k * 4 + i];
    if (res != nullptr) {
#pragma unroll
      for (int i = 0; i < 12; ++i) rk[i] = res[k * 12 + i];
    }
    for (int j = 0; j < substeps; ++j) uav::rigid_rk4(s, uk, b, res != nullptr ? rk : nullptr, st);
#pragma unroll
    for (int i = 0; i < 12; ++i) out[k * 12 + i] = s[i];
  }
}

}  // namespace

extern "C" int rigid_rollout_launch(const float* x0, const float* u, const float* res, float* out,
                                    int n, int substeps, const uav::RK4Step* st,
                                    const uav::RigidBody* body, void* stream) {
  rigid_rollout_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(x0, u, res, out, n, substeps, *st,
                                                           *body);
  return (int)cudaGetLastError();
}
