// K13a and K13b: the VJPs of the plant kernels K1 and K2, one warp per
// state of a batch.
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
// What bounds them is latency: per state ~100 bytes in and out against
// ~4,000 operations, most of them waiting on a chain of accurate sines,
// cosines and IEEE divisions; the flight tuners launch them at B=1.
//
// Both: a warp per state, four per block, so B=1024 spreads over 256 blocks
// (ops/tick_ad.py:vjp_geometry, checked by the launchers). The lanes share
// the slow scalar work by shuffles (plant_math.cuh: rk4_stages_warp,
// derivative_warp, derivative_vjp_warp): per derivative and per derivative
// VJP the warp waits for one sincosf and one division where one thread
// waits for six and seven or fifteen in a row. The plant's forward runs
// once, each substep's start and stage states kept in the warp's shared
// memory, and the cotangent goes back through k4 .. k1 of each substep;
// every lane holds the whole state and cotangent (a 12-wide combination is
// one FMA per component on any lane). K13b first forms the control on the
// warp (allocation_warp) and after the plant's adjoint runs back through
// the allocation and the attitude PID (allocation_vjp_warp: the arcsines,
// wraps, rsqrtf and quotients one to a lane). Lane 0 writes a state's rows.
// The plant row's cotangent is written per state, (B, 10), and the wrapper
// sums it over the batch in a fixed order, so a launch is deterministic.
//
// With -DUAV_SECTION_CLOCKS (the plant_vjp_clocks library) lane 0 of each
// K13b warp counts its cycles: the forward allocation, the plant's forward,
// its adjoint, the allocation's VJP, and the whole state
// (ops/tick_ad.py:plant_vjp_section_cycles); each phase's results are
// waited for before the clock is read.
//
// The plain versions are ops/tick_ad.py: px4_plant_step_vjp_plain and
// allocation_plant_tick_vjp_plain (torch.func.vjp of K1's and K2's plain
// versions).

#include <cuda_runtime.h>

#include "plant_math.cuh"
#include "section_clocks.cuh"

namespace {

constexpr int kVjpWarps = 4;        // states (warps) per block
constexpr int kMaxVjpSubsteps = 64; // 4 warps x 64 x 48 floats = 48 KB of stages

#ifdef UAV_SECTION_CLOCKS
// wait for a result before the clock is read (an instruction that uses it)
#define K13_SETTLE(x) asm volatile("add.f32 %0, %0, 0f00000000;" : "+f"(x))
#endif

#ifdef UAV_K13A_LANE_OWNED
// An ablation of K13a's design, built only as the plant_vjp_lane_owned
// library (chip_smoke.py times it beside the shipped form): lanes 0-11 own
// one state component each for the RK4 combinations and the adjoint's
// accumulations, and each derivative and derivative VJP first gathers the
// whole state or cotangent by twelve shuffles. The derivatives themselves,
// and the cotangents of the control and the plant row, stay whole on every
// lane, as in rk4_substeps_vjp_warp().
__device__ __forceinline__ float own(const float v[12], int lane) {
  float o = v[0];
#pragma unroll
  for (int j = 1; j < 12; ++j) o = lane == j ? v[j] : o;
  return o;
}

__device__ __forceinline__ void gather(float v, float out[12]) {
#pragma unroll
  for (int j = 0; j < 12; ++j) out[j] = __shfl_sync(uav::kFullMask, v, j);
}

__device__ __forceinline__ void rk4_substeps_vjp_lanes(const float s0[12], const float c[4],
                                                       const uav::Plant& pl, double dt,
                                                       int substeps, int lane, float* stages,
                                                       float gs[12], float gc[4],
                                                       float gp[uav::kPlantLanes]) {
  const uav::Rk4Step st = uav::rk4_step_lengths(dt, substeps);
  const float kd = pl.k_drag / pl.mass;
  float v[12], k[12];
  float si = own(s0, lane);   // lanes 12-31 carry a copy of component 0, never read
  for (int step = 0; step < substeps; ++step) {
    gather(si, v);
    uav::derivative_warp(v, c, pl, lane, k);
    float acc = own(k, lane);
    const float x2 = si + st.half_h * acc;
    gather(x2, v);
    uav::derivative_warp(v, c, pl, lane, k);
    float ki = own(k, lane);
    const float x3 = si + st.half_h * ki;
    acc = acc + 2.0f * ki;
    gather(x3, v);
    uav::derivative_warp(v, c, pl, lane, k);
    ki = own(k, lane);
    const float x4 = si + st.h * ki;
    acc = acc + 2.0f * ki;
    gather(x4, v);
    uav::derivative_warp(v, c, pl, lane, k);
    ki = own(k, lane);
    if (lane < 12) {
      float* at = stages + 48 * step;
      at[lane] = si;
      at[12 + lane] = x2;
      at[24 + lane] = x3;
      at[36 + lane] = x4;
    }
    si = si + st.h6 * (acc + ki);
  }
  __syncwarp();
  float gi = own(gs, lane), xs[12], g_x[12];
  for (int step = substeps - 1; step >= 0; --step) {
    const float* at = stages + 48 * step;
    const float g_sum = st.h6 * gi;
    float g_s = gi, g_k = g_sum;
    // s' = s + h6 (k1 + 2 k2 + 2 k3 + k4), back through k4 .. k1 at the
    // stage states x4, x3, x2, s
#pragma unroll
    for (int stage = 3; stage >= 0; --stage) {
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        xs[i] = at[12 * stage + i];
        g_x[i] = 0.0f;
      }
      gather(g_k, v);
      uav::derivative_vjp_warp(xs, c, pl, kd, v, lane, g_x, gc, gp);
      const float gx = own(g_x, lane);
      g_s += gx;
      g_k = stage == 3 ? 2.0f * g_sum + st.h * gx          // x4 = s + h k3
          : stage == 2 ? 2.0f * g_sum + st.half_h * gx     // x3 = s + h/2 k2
                       : g_sum + st.half_h * gx;           // x2 = s + h/2 k1
    }
    gi = g_s;
  }
  gather(gi, gs);
}
#endif

__global__ void __launch_bounds__(32 * kVjpWarps)
px4_plant_step_vjp_kernel(const float* __restrict__ state, const float* __restrict__ control,
                          const float* __restrict__ plant_row, const float* __restrict__ ct_out,
                          float* __restrict__ ct_state, float* __restrict__ ct_control,
                          float* __restrict__ ct_plant, int batch, double dt, int substeps) {
  extern __shared__ float stages[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kVjpWarps + warp;
  if (b >= batch) return;   // the whole warp
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
#ifdef UAV_K13A_LANE_OWNED
  rk4_substeps_vjp_lanes(s, c, pl, dt, substeps, lane, stages + warp * substeps * 48, gs, gc, gp);
#else
  uav::rk4_substeps_vjp_warp(s, c, pl, dt, substeps, lane, stages + warp * substeps * 48, gs, gc,
                             gp);
#endif
  if (lane != 0) return;
#pragma unroll
  for (int i = 0; i < 12; ++i) ct_state[b * 12 + i] = gs[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) ct_control[b * 4 + i] = gc[i];
#pragma unroll
  for (int i = 0; i < uav::kPlantLanes; ++i) ct_plant[b * uav::kPlantLanes + i] = gp[i];
}

// cmd row: ax, ay, az, yawrate, yaw, thrust_ceiling; ctrl row: control (4),
// attitude setpoint (3)
__global__ void __launch_bounds__(32 * kVjpWarps)
allocation_plant_tick_vjp_kernel(
    const float* __restrict__ state, const float* __restrict__ cmd,
    const float* __restrict__ integral, const float* __restrict__ plant_row,
    const float* __restrict__ ct_state_out, const float* __restrict__ ct_ctrl,
    const float* __restrict__ ct_int, float* __restrict__ ct_state,
    float* __restrict__ ct_cmd, float* __restrict__ ct_integral, float* __restrict__ ct_plant,
    int batch, double dt, int substeps) {
  extern __shared__ float stages[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kVjpWarps + warp;
  if (b >= batch) return;   // the whole warp
#ifdef UAV_SECTION_CLOCKS
  const long long t_whole = clock64();
#endif
  const uav::Plant pl = uav::load_plant(plant_row);
  float s[12], cm[5], in[3];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = state[b * 12 + i];
#pragma unroll
  for (int i = 0; i < 5; ++i) cm[i] = cmd[b * 6 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) in[i] = integral[b * 3 + i];
  const float thrust_ceiling = cmd[b * 6 + 5];
#ifdef UAV_SECTION_CLOCKS
  const long long t0 = clock64();
#endif
  float c[4], att_sp[3], new_int[3];
  uav::allocation_warp(s, cm, in, (float)dt, pl.gravity, thrust_ceiling, lane, c, att_sp,
                       new_int);
#ifdef UAV_SECTION_CLOCKS
#pragma unroll
  for (int i = 0; i < 4; ++i) K13_SETTLE(c[i]);
  const long long t1 = clock64();
#endif

  // back through the plant's substeps to the state and the control
  float gs[12], gc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, gp[uav::kPlantLanes];
#pragma unroll
  for (int i = 0; i < 12; ++i) gs[i] = ct_state_out[b * 12 + i];
#pragma unroll
  for (int i = 0; i < uav::kPlantLanes; ++i) gp[i] = 0.0f;
#ifdef UAV_SECTION_CLOCKS
  long long t2 = 0;
  uav::rk4_substeps_vjp_warp(s, c, pl, dt, substeps, lane, stages + warp * substeps * 48, gs, gc,
                             gp, [&t2] { t2 = clock64(); });
#else
  uav::rk4_substeps_vjp_warp(s, c, pl, dt, substeps, lane, stages + warp * substeps * 48, gs, gc,
                             gp);
#endif
#ifdef UAV_SECTION_CLOCKS
#pragma unroll
  for (int i = 0; i < 12; ++i) K13_SETTLE(gs[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) K13_SETTLE(gc[i]);
  const long long t3 = clock64();
#endif

  // then back through the allocation and attitude PID
  float g_control[4], g_att[3], g_new_int[3];
#pragma unroll
  for (int i = 0; i < 4; ++i) g_control[i] = gc[i] + ct_ctrl[b * 7 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_att[i] = ct_ctrl[b * 7 + 4 + i];
    g_new_int[i] = ct_int[b * 3 + i];
  }
  float gcmd[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, gint[3] = {0.0f, 0.0f, 0.0f};
  uav::allocation_vjp_warp(s, cm, in, (float)dt, pl.gravity, thrust_ceiling, g_control, g_att,
                           g_new_int, lane, gs, gcmd, gint, &gp[1], &gcmd[5]);
#ifdef UAV_SECTION_CLOCKS
#pragma unroll
  for (int i = 0; i < 12; ++i) K13_SETTLE(gs[i]);
#pragma unroll
  for (int i = 0; i < 6; ++i) K13_SETTLE(gcmd[i]);
  const long long t4 = clock64();
  if (lane == 0) {
    const unsigned long long counts[6] = {
        (unsigned long long)(t1 - t0), (unsigned long long)(t2 - t1),
        (unsigned long long)(t3 - t2), (unsigned long long)(t4 - t3),
        (unsigned long long)(t4 - t_whole), 1ull};
    for (int i = 0; i < 6; ++i) atomicAdd(&uav::g_section_cycles[i], counts[i]);
  }
#endif
  if (lane != 0) return;
#pragma unroll
  for (int i = 0; i < 12; ++i) ct_state[b * 12 + i] = gs[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) ct_cmd[b * 6 + i] = gcmd[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) ct_integral[b * 3 + i] = gint[i];
#pragma unroll
  for (int i = 0; i < uav::kPlantLanes; ++i) ct_plant[b * uav::kPlantLanes + i] = gp[i];
}

// blocks x threads from ops/tick_ad.py:vjp_geometry: a warp per state,
// kVjpWarps a block, every state covered; at most kMaxVjpSubsteps substeps
// (the warp's stage states in dynamic shared memory).
bool vjp_launch_ok(int batch, int substeps, int blocks, int threads) {
  return batch >= 0 && substeps >= 0 && substeps <= kMaxVjpSubsteps &&
         threads == 32 * kVjpWarps && (long long)blocks * kVjpWarps >= batch &&
         (long long)(blocks - 1) * kVjpWarps < batch;
}

}  // namespace

extern "C" {

int px4_plant_step_vjp_launch(const float* state, const float* control, const float* plant_row,
                              const float* ct_out, float* ct_state, float* ct_control,
                              float* ct_plant, int batch, double dt, int substeps, int blocks,
                              int threads, void* stream) {
  if (!vjp_launch_ok(batch, substeps, blocks, threads)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kVjpWarps * substeps * 48;
  px4_plant_step_vjp_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      state, control, plant_row, ct_out, ct_state, ct_control, ct_plant, batch, dt, substeps);
  return (int)cudaGetLastError();
}

int allocation_plant_tick_vjp_launch(const float* state, const float* cmd, const float* integral,
                                     const float* plant_row, const float* ct_state_out,
                                     const float* ct_ctrl, const float* ct_int, float* ct_state,
                                     float* ct_cmd, float* ct_integral, float* ct_plant,
                                     int batch, double dt, int substeps, int blocks, int threads,
                                     void* stream) {
  if (!vjp_launch_ok(batch, substeps, blocks, threads)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kVjpWarps * substeps * 48;
  allocation_plant_tick_vjp_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      state, cmd, integral, plant_row, ct_state_out, ct_ctrl, ct_int, ct_state, ct_cmd,
      ct_integral, ct_plant, batch, dt, substeps);
  return (int)cudaGetLastError();
}

// K13b's section clocks since the last call (forward allocation, plant
// forward, plant adjoint, allocation VJP, whole states, states), then
// reset; cudaErrorNotSupported unless built with -DUAV_SECTION_CLOCKS.
int plant_vjp_section_cycles(unsigned long long* out) { return uav::read_section_cycles(out, 6); }

}  // extern "C"
