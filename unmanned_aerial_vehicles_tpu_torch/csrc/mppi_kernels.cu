// K12: MPPI's sampling stage in one launch: K candidate control sequences
// rolled through N RK4 steps of the 12-state rigid body, each step's
// tracking cost summed, plus the terminal term; out: the (K,) costs.
//
// Replaces the JAX package's ops/mppi_pallas.py:_mppi_call (pallas_call at
// :109; mppi_rollout_costs_fused). Its plain version is the port's
// ops/mppi_pallas.py:mppi_rollout_costs_plain.
//
// One thread per sample: it carries its state in registers through the N
// steps (rigid_math.cuh rigid_rk4, the math of K10), reading the step's four
// controls as one 16-byte load from the row-major (K, N, 4) candidates. The
// stage cost is the JAX kernel's: position, velocity, levelness, the yaw
// error wrapped as a floor-mod (plant_math.cuh wrap_angle: fmodf plus the
// sign fix), rates and the control deviation from hover; the terminal term
// adds (terminal_weight - 1) times the last stage's position and velocity
// terms. The tail of the last block is masked: any K.
//
// What bounds it on an H100: latency. At 512 x 25 the work is ~4 M FP32
// operations and ~205 KB of candidates, under a tenth of a microsecond at
// the card's rates; each thread's 25 steps are one dependent chain of 100
// derivative evaluations (six accurate sines and cosines, a tangent, a
// square root and seven divisions each), and 512 threads fill 4 SMs of 132.
// Spreading a sample's evaluation over several lanes (plant_math.cuh
// derivative_warp) and more samples per tick are the ways to more speed.

#include <cuda_runtime.h>

#include "plant_math.cuh"
#include "rigid_math.cuh"

// Host-visible: laid out as ops/mppi_pallas.py _MppiCost.
struct MppiCost {
  float q_pos, q_vel, q_att, q_yaw, q_rate, r0, r1, r2, r3;
  float terminal_scale;   // terminal_weight - 1
  float uh[4];            // hover control
};

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mppi_costs_kernel(const float* __restrict__ x0, const float4* __restrict__ U,
                  const float* __restrict__ targets, const float* __restrict__ target_yaw,
                  float* __restrict__ costs, int K, int N, uav::RK4Step st, uav::RigidBody b,
                  MppiCost w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = __ldg(x0 + i);
  const float yaw = __ldg(target_yaw);
  const float4* Uk = U + (size_t)k * N;
  float c = 0.0f;
  for (int i = 0; i < N; ++i) {
    const float4 u4 = __ldg(Uk + i);
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
    uav::rigid_rk4(s, u, b, nullptr, st);
    const float ex = s[0] - __ldg(targets + 3 * i);
    const float ey = s[1] - __ldg(targets + 3 * i + 1);
    const float ez = s[2] - __ldg(targets + 3 * i + 2);
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
  const float* tl = targets + 3 * (N - 1);
  const float ex = s[0] - __ldg(tl), ey = s[1] - __ldg(tl + 1), ez = s[2] - __ldg(tl + 2);
  costs[k] = c + w.terminal_scale * (w.q_pos * (ex * ex + ey * ey + ez * ez)
                                     + w.q_vel * (s[3] * s[3] + s[4] * s[4] + s[5] * s[5]));
}

}  // namespace

extern "C" int mppi_costs_launch(const float* x0, const float* U, const float* targets,
                                 const float* target_yaw, float* costs, int K, int N,
                                 const uav::RK4Step* st, const uav::RigidBody* body,
                                 const MppiCost* weights, void* stream) {
  const int blocks = (K + kThreads - 1) / kThreads;
  mppi_costs_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x0, reinterpret_cast<const float4*>(U), targets, target_yaw, costs, K, N, *st, *body,
      *weights);
  return (int)cudaGetLastError();
}
