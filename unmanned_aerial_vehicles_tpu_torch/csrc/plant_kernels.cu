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
// Both run a group of 8 lanes per state, four states a warp, 16 a block
// (the wrapper sizes the launch: ops/plant_pallas.py:plant_geometry). Every
// lane carries the whole state; the chain's slow, serial pieces are spread
// over the group's lanes and shared by shuffles (plant_math.cuh:
// allocation_warp, rk4_substeps_warp, the same arithmetic as allocation
// and rk4_step): a derivative waits for one sincosf and one division instead
// of six and seven in a row, K2's allocation for one arcsine and one wrap.
// 8 lanes hold every piece a derivative spreads (three sine/cosine pairs,
// seven quotients); a whole warp per state computed the same outputs, bit
// for bit, and was slower at large batches, its 32 lanes repeating the
// state's arithmetic four times over (PERF.md). Both kernels' outputs equal
// those of a thread per state (rk4_step) bit for bit. A group past the batch
// reads the last state and writes nothing, so every lane of a warp stays in
// the shuffles; the group's lane 0 writes the outputs.
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

constexpr int kLanes = 8;          // ops/plant_pallas.py LANES_PER_STATE
constexpr int kMaxThreads = 128;

__global__ void __launch_bounds__(kMaxThreads)
px4_plant_step_kernel(const float* __restrict__ state, const float* __restrict__ control,
                      const float* __restrict__ plant_row, float* __restrict__ out, int batch,
                      double dt, int substeps, int plant_stride) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int b_raw = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  const int b = min(b_raw, batch - 1);
  const uav::Plant pl = uav::load_plant(plant_row + b * plant_stride);
  float s[12], c[4];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = state[b * 12 + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = control[b * 4 + i];
  uav::rk4_substeps_warp<kLanes>(s, c, pl, dt, substeps, lane);
  if (lane != 0 || b_raw >= batch) return;
#pragma unroll
  for (int i = 0; i < 12; ++i) out[b * 12 + i] = s[i];
}

// cmd row: ax, ay, az, yawrate, yaw, thrust_ceiling
__global__ void __launch_bounds__(kMaxThreads)
allocation_plant_tick_kernel(const float* __restrict__ state, const float* __restrict__ cmd,
                             const float* __restrict__ integral,
                             const float* __restrict__ plant_row, float* __restrict__ out_state,
                             float* __restrict__ out_ctrl, float* __restrict__ out_int, int batch,
                             double dt, int substeps, int plant_stride) {
  const int lane = threadIdx.x & (kLanes - 1);
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
  uav::rk4_substeps_warp<kLanes>(s, c, pl, dt, substeps, lane);
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

// blocks x threads from ops/plant_pallas.py:plant_geometry: whole warps
// (the shuffles), at most kMaxThreads, every state covered.
bool plant_geometry_ok(int batch, int blocks, int threads) {
  return batch >= 1 && threads % 32 == 0 && threads <= kMaxThreads &&
         (long long)blocks * (threads / kLanes) >= batch;
}

}  // namespace

extern "C" {

int px4_plant_step_launch(const float* state, const float* control, const float* plant_row,
                          float* out, int batch, double dt, int substeps, int plant_stride,
                          int blocks, int threads, void* stream) {
  if (!plant_geometry_ok(batch, blocks, threads)) return (int)cudaErrorInvalidConfiguration;
  px4_plant_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      state, control, plant_row, out, batch, dt, substeps, plant_stride);
  return (int)cudaGetLastError();
}

int allocation_plant_tick_launch(const float* state, const float* cmd, const float* integral,
                                 const float* plant_row, float* out_state, float* out_ctrl,
                                 float* out_int, int batch, double dt, int substeps,
                                 int plant_stride, int blocks, int threads, void* stream) {
  if (!plant_geometry_ok(batch, blocks, threads)) return (int)cudaErrorInvalidConfiguration;
  allocation_plant_tick_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      state, cmd, integral, plant_row, out_state, out_ctrl, out_int, batch, dt, substeps,
      plant_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
