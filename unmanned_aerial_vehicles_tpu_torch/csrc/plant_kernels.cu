// K1 and K2: the plant kernels.
//
// K1 px4_plant_step_kernel replaces the JAX package's
//   ops/plant_pallas.py:px4_plant_step_fused (pallas_call at :400):
//   all RK4 substeps of the 12-state PX4 surrogate.
// K2 allocation_plant_tick_kernel replaces
//   ops/plant_pallas.py:allocation_plant_tick_fused (pallas_call at :351):
//   u0 command -> geometric allocation + attitude PID -> K1's substeps.
//
// What bounds them on an H100: for the batches the flight loops pass (1 to
// a few thousand) neither bytes nor operations but latency. Per state they
// read 16 (K1) or 25 (K2) floats and write 12 (K1) or 22 (K2); the work is
// the allocation (two arcsines, three floor-mod angle wraps) and 8
// derivative evaluations (2 substeps x 4 RK4 stages), each 6 accurate
// sin/cos, a sqrt and 5 divisions, on one dependent chain per state.
//
// K1: one thread per state: the whole state in registers for every
// substep, a batch spread over all SMs; a single state's time is its
// chain's latency plus the launch.
//
// K2: a group of 8 lanes per state, four states a warp, 16 a block. Every
// lane carries the whole state; the chain's slow, serial pieces are spread
// over the group's lanes and shared by shuffles (plant_math.cuh:
// allocation_warp, rk4_stages_warp, the same arithmetic as allocation and
// rk4_step): a derivative waits for one sincosf and one division instead
// of six and seven in a row, the allocation for one arcsine and one wrap.
// 8 lanes hold every piece a derivative spreads (three sine/cosine pairs,
// seven quotients); a whole warp per state computed the same outputs, bit
// for bit, and was slower at large batches, its 32 lanes repeating the
// state's arithmetic four times over (PERF.md).
//
// The plant scalars are one shared 10-lane row (plant_stride 0) or one row
// per state (plant_stride 10: the Monte Carlo population's dispersed
// plants, what JAX's vmap over traced plant rows computes); a state reads
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

// K2: kLanes lanes per state, blockDim.x / kLanes states a block; the
// wrapper sizes the launch (ops/plant_pallas.py:allocation_plant_geometry,
// K2_LANES_PER_STATE = kLanes). The group's lane 0 writes the outputs.
constexpr int kLanes = 8;
constexpr int kMaxThreads = 128;

// cmd row: ax, ay, az, yawrate, yaw, thrust_ceiling
__global__ void __launch_bounds__(kMaxThreads)
allocation_plant_tick_kernel(const float* __restrict__ state, const float* __restrict__ cmd,
                             const float* __restrict__ integral,
                             const float* __restrict__ plant_row, float* __restrict__ out_state,
                             float* __restrict__ out_ctrl, float* __restrict__ out_int, int batch,
                             double dt, int substeps, int plant_stride) {
  const int lane = threadIdx.x & (kLanes - 1);
  // a group past the batch reads the last state and writes nothing: every
  // lane of a warp stays in the shuffles
  const int b_raw = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  const int b = min(b_raw, batch - 1);
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
  uav::allocation_warp<kLanes>(s, cm, in, (float)dt, pl.gravity, thrust_ceiling, lane, c,
                               att_sp, new_int);
  const double h = dt / substeps;
  for (int step = 0; step < substeps; ++step) {
    float x2[12], x3[12], x4[12], xp[12];
    uav::rk4_stages_warp<kLanes>(s, c, pl, h, lane, x2, x3, x4, xp);
#pragma unroll
    for (int i = 0; i < 12; ++i) s[i] = xp[i];
  }
  if (lane != 0 || b_raw >= batch) return;
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
                                 int plant_stride, int blocks, int threads, void* stream) {
  // whole warps (the shuffles), and every state covered
  if (threads % 32 != 0 || threads > kMaxThreads || (long long)blocks * (threads / kLanes) < batch)
    return (int)cudaErrorInvalidConfiguration;
  allocation_plant_tick_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      state, cmd, integral, plant_row, out_state, out_ctrl, out_int, batch, dt, substeps,
      plant_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
