// K1 and K2: the plant kernels, one CUDA thread per state of a batch.
//
// K1 px4_plant_step_kernel replaces the JAX package's
//   ops/plant_pallas.py:px4_plant_step_fused (pallas_call at :400):
//   all RK4 substeps of the 12-state PX4 surrogate.
// K2 allocation_plant_tick_kernel replaces
//   ops/plant_pallas.py:allocation_plant_tick_fused (pallas_call at :351):
//   u0 command -> geometric allocation + attitude PID -> K1's substeps.
//
// What bounds them on an H100: operations, and for the batch of one that
// the flight loops pass, latency. Per state they read 16 (K1) or 25 (K2)
// floats and write 12 (K1) or 22 (K2); the work is 8 derivative
// evaluations (2 substeps x 4 RK4 stages), each 6 accurate sin/cos, a
// sqrt and 5 divisions, all on one dependent chain. The design keeps the
// whole state in registers for every substep (one global read and one
// write per lane) and puts one state on each thread, so a batch spreads
// over all SMs; a single state is one thread's dependent chain and its
// time is the chain's latency plus the launch.
//
// The plant scalars are one shared 10-lane row (plant_stride 0) or one row
// per state (plant_stride 10: the Monte Carlo population's dispersed
// plants, what JAX's vmap over traced plant rows computes); a thread reads
// its row at plant_row + b * plant_stride.
//
// The plain versions are ops/plant_pallas.py: px4_plant_step_plain and
// allocation_plant_tick_plain.

#include <cuda_runtime.h>

#include "plant_math.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void px4_plant_step_kernel(const float* __restrict__ state,
                                      const float* __restrict__ control,
                                      const float* __restrict__ plant_row,
                                      float* __restrict__ out, int batch, double dt,
                                      int substeps, int plant_stride) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uav::Plant pl = uav::load_plant(plant_row + b * plant_stride);
  float s[12], c[4];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = state[b * 12 + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = control[b * 4 + i];
  uav::rk4_substeps(s, c, pl, dt, substeps);
#pragma unroll
  for (int i = 0; i < 12; ++i) out[b * 12 + i] = s[i];
}

// cmd row: ax, ay, az, yawrate, yaw, thrust_ceiling
__global__ void allocation_plant_tick_kernel(const float* __restrict__ state,
                                             const float* __restrict__ cmd,
                                             const float* __restrict__ integral,
                                             const float* __restrict__ plant_row,
                                             float* __restrict__ out_state,
                                             float* __restrict__ out_ctrl,
                                             float* __restrict__ out_int, int batch, double dt,
                                             int substeps, int plant_stride) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uav::Plant pl = uav::load_plant(plant_row + b * plant_stride);
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
  uav::rk4_substeps(s, c, pl, dt, substeps);
#pragma unroll
  for (int i = 0; i < 12; ++i) out_state[b * 12 + i] = s[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) out_ctrl[b * 7 + i] = c[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) out_ctrl[b * 7 + 4 + i] = att_sp[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) out_int[b * 3 + i] = new_int[i];
}

}  // namespace

extern "C" {

int px4_plant_step_launch(const float* state, const float* control, const float* plant_row,
                          float* out, int batch, double dt, int substeps, int plant_stride,
                          void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  px4_plant_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      state, control, plant_row, out, batch, dt, substeps, plant_stride);
  return (int)cudaGetLastError();
}

int allocation_plant_tick_launch(const float* state, const float* cmd, const float* integral,
                                 const float* plant_row, float* out_state, float* out_ctrl,
                                 float* out_int, int batch, double dt, int substeps,
                                 int plant_stride, void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  allocation_plant_tick_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      state, cmd, integral, plant_row, out_state, out_ctrl, out_int, batch, dt, substeps,
      plant_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
