// K13a and K13b: the VJPs of the plant kernels K1 and K2, one CUDA thread
// per state of a batch.
//
// The JAX package differentiates its plant kernels through custom VJPs
// whose backward pass is the staged twin's jax.vjp:
// K13a px4_plant_step_vjp_kernel replaces ops/tick_ad.py:_plant_ad_fn
//   (pallas_call at :409; around K1's body): the cotangents of the state,
//   the control and the plant row from the cotangent of the new state.
// K13b allocation_plant_tick_vjp_kernel replaces ops/tick_ad.py:_alloc_ad_fn
//   (pallas_call at :469; around K2's body): the cotangents of the state,
//   the command row, the attitude integral and the plant row from those of
//   the new state, the control + attitude setpoint row and the integral.
//
// Design: each thread recomputes its state's forward pass in registers with
// the forward kernels' own device math (plant_math.cuh: allocation,
// rk4_step, derivative) and runs the adjoint back through it
// (rk4_substeps_vjp, derivative_vjp, allocation_vjp): per RK4 substep the
// stage states are rebuilt and the cotangent goes back through k4 .. k1.
// The plant row's cotangent is written per state, (B, 10), and the wrapper
// sums it over the batch in a fixed order, so a launch is deterministic.
// What bounds them is latency: per state ~100 bytes in and out against
// ~4,000 dependent operations; the flight tuners launch them at B=1.
//
// The plain versions are ops/tick_ad.py: px4_plant_step_vjp_plain and
// allocation_plant_tick_vjp_plain (torch.func.vjp of K1's and K2's plain
// versions).

#include <cuda_runtime.h>

#include "plant_math.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void px4_plant_step_vjp_kernel(const float* __restrict__ state,
                                          const float* __restrict__ control,
                                          const float* __restrict__ plant_row,
                                          const float* __restrict__ ct_out,
                                          float* __restrict__ ct_state,
                                          float* __restrict__ ct_control,
                                          float* __restrict__ ct_plant, int batch, double dt,
                                          int substeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uav::Plant pl = uav::load_plant(plant_row);
  float s[12], c[4], gs[12], gc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, gp[uav::kPlantLanes];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    s[i] = state[b * 12 + i];
    gs[i] = ct_out[b * 12 + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = control[b * 4 + i];
#pragma unroll
  for (int i = 0; i < uav::kPlantLanes; ++i) gp[i] = 0.0f;
  uav::rk4_substeps_vjp(s, c, pl, dt, substeps, gs, gc, gp);
#pragma unroll
  for (int i = 0; i < 12; ++i) ct_state[b * 12 + i] = gs[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) ct_control[b * 4 + i] = gc[i];
#pragma unroll
  for (int i = 0; i < uav::kPlantLanes; ++i) ct_plant[b * uav::kPlantLanes + i] = gp[i];
}

// cmd row: ax, ay, az, yawrate, yaw, thrust_ceiling; ctrl row: control (4),
// attitude setpoint (3)
__global__ void allocation_plant_tick_vjp_kernel(
    const float* __restrict__ state, const float* __restrict__ cmd,
    const float* __restrict__ integral, const float* __restrict__ plant_row,
    const float* __restrict__ ct_state_out, const float* __restrict__ ct_ctrl,
    const float* __restrict__ ct_int, float* __restrict__ ct_state,
    float* __restrict__ ct_cmd, float* __restrict__ ct_integral, float* __restrict__ ct_plant,
    int batch, double dt, int substeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uav::Plant pl = uav::load_plant(plant_row);
  float s[12], cm[5], in[3];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = state[b * 12 + i];
#pragma unroll
  for (int i = 0; i < 5; ++i) cm[i] = cmd[b * 6 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) in[i] = integral[b * 3 + i];
  const float thrust_ceiling = cmd[b * 6 + 5];
  float c[4], att_sp[3], new_int[3];
  uav::allocation(s, cm, in, (float)dt, pl.gravity, thrust_ceiling, c, att_sp, new_int);

  // back through the plant's substeps to the state and the control
  float gs[12], gc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, gp[uav::kPlantLanes];
#pragma unroll
  for (int i = 0; i < 12; ++i) gs[i] = ct_state_out[b * 12 + i];
#pragma unroll
  for (int i = 0; i < uav::kPlantLanes; ++i) gp[i] = 0.0f;
  uav::rk4_substeps_vjp(s, c, pl, dt, substeps, gs, gc, gp);

  // then back through the allocation and attitude PID
  float g_control[4], g_att[3], g_new_int[3];
#pragma unroll
  for (int i = 0; i < 4; ++i) g_control[i] = gc[i] + ct_ctrl[b * 7 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_att[i] = ct_ctrl[b * 7 + 4 + i];
    g_new_int[i] = ct_int[b * 3 + i];
  }
  float gcmd[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gint[3] = {0.0f, 0.0f, 0.0f};
  float g_ceiling = 0.0f;
  uav::allocation_vjp(s, cm, in, (float)dt, pl.gravity, thrust_ceiling, g_control, g_att,
                      g_new_int, gs, gcmd, gint, &gp[1], &g_ceiling);
#pragma unroll
  for (int i = 0; i < 12; ++i) ct_state[b * 12 + i] = gs[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) ct_cmd[b * 6 + i] = gcmd[i];
  ct_cmd[b * 6 + 5] = g_ceiling;
#pragma unroll
  for (int i = 0; i < 3; ++i) ct_integral[b * 3 + i] = gint[i];
#pragma unroll
  for (int i = 0; i < uav::kPlantLanes; ++i) ct_plant[b * uav::kPlantLanes + i] = gp[i];
}

}  // namespace

extern "C" {

int px4_plant_step_vjp_launch(const float* state, const float* control, const float* plant_row,
                              const float* ct_out, float* ct_state, float* ct_control,
                              float* ct_plant, int batch, double dt, int substeps,
                              void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  px4_plant_step_vjp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      state, control, plant_row, ct_out, ct_state, ct_control, ct_plant, batch, dt, substeps);
  return (int)cudaGetLastError();
}

int allocation_plant_tick_vjp_launch(const float* state, const float* cmd, const float* integral,
                                     const float* plant_row, const float* ct_state_out,
                                     const float* ct_ctrl, const float* ct_int, float* ct_state,
                                     float* ct_cmd, float* ct_integral, float* ct_plant,
                                     int batch, double dt, int substeps, void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  allocation_plant_tick_vjp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      state, cmd, integral, plant_row, ct_state_out, ct_ctrl, ct_int, ct_state, ct_cmd,
      ct_integral, ct_plant, batch, dt, substeps);
  return (int)cudaGetLastError();
}

}  // extern "C"
