// K9: K whole noisy GP-MPC control ticks of one flight in one launch, with
// the state estimator inside: the 12-state EKF, or the 15-state
// disturbance observer (state [x12, d3]).
//
// Replaces the JAX package's ops/tick_pallas.py:gpmpc_noisy_multitick_fused
// (pallas_call at :1305). Its plain version is the port's
// ops/tick_pallas.py:noisy_multitick_staged.
//
// Per tick: the filter predicts one RK4 step at dt from the estimate and
// the previously applied control (process model: this tick's plant row, or
// the nominal row in observer mode, which adds the disturbance's exact
// injection 0.5 dt^2 d / dt d), propagates P <- P + Fd P + (Fd P)' +
// Fd P Fd' + Q with the RK4 chain rule Fd = dt/6 (K1 + 2K2 + 2K3 + K4),
// K_{i+1} = J(x_{i+1}) + c_i dt J(x_{i+1}) K_i from the closed-form
// Jacobian at the stage states (plus bdist in observer mode), and fuses the
// 9 measured lanes (truth + noise) one scalar update at a time, yaw
// innovation and attitude estimates wrapped. Then K5's tick runs on the
// estimate: the GP horizon mean, the shifted warm start, the condensed
// solve, and the clips, fallback and allocation on the estimate while the
// plant integrates the truth.
//
// Design: K5's block (tick_kernel.cu: one block of 512 threads per flight,
// the K ticks a loop inside it, P1 in shared memory, the GP, shift and
// solve from multitick_phases.cuh) with a filter warp. After the solve of
// tick t, warp 0 runs tick t's scalar section, warp 1 tick t+1's filter
// and warps 2-15 tick t+1's GP (two stages a thread) and shift, and one
// block barrier joins them before the next solve. The GP of tick t+1 reads
// only tick t's solve (x0 = the estimate, X_tail, the unshifted slack). The
// filter's predict, relinearisation and propagation need only tick t's
// control, which warp 0 hands over (aux[9:13], a named barrier) as soon as
// its allocation has it; its fusions need the plant's new truth, handed
// over (st, a second named barrier) after the plant's substeps. On the
// warps, the scalar section (mpc_command_plant_warp), the RK4 stages and
// the four stage Jacobians are warp-cooperative (plant_math.cuh: the sines,
// cosines and divisions spread over lanes, shared by shuffles), and the
// 12 x 12 chain products, the n x n propagation and each fusion's rank-one
// update are spread over the 32 lanes (n = 12 or 15), P kept in registers
// across the nine fusions. Tick 0's filter and GP run before the loop. With
// relinearize_every "dispatch" the filter warp forms Fd once at launch
// entry from the entry estimate and control (row 0's plant, or the nominal
// row).
//
// What bounds it on an H100: the filter adds ~24k FP32 operations per tick
// at n = 12 (~36k at n = 15; the chain products and the propagation) to
// K5's ~1.46 M, and ~5 KB of operands per launch (noise, P, the rows):
// the bound stays ~0.45 us per launch of 20 ticks (operations), and the
// kernel stays latency-bound like K5, one block on one SM. Beside the
// solve (K5's), the filter warp's chain sets the overlap's length: it
// waits for the allocation, and its predict and fusions share their
// schedulers with the GP warps. -DUAV_SECTION_CLOCKS builds count the
// cycles of each section (chip_smoke.py prints them). Every sum runs in a
// fixed order (deterministic).
//
// loop_precision and cov_precision: every mode computes in float32 with
// FMAs here (the bfloat16 modes were TPU matrix-unit choices).

#include <cuda_runtime.h>

#include "multitick_phases.cuh"
#include "plant_math.cuh"

// Host-visible (external linkage): laid out as ops/tick_pallas.py's
// _NoisyTickParams / _NoisyTickOperands.
struct NoisyTickParams {
  int k_ticks, n, m, n_train, use_gp, iterations, substeps, use_fallback;
  int n_est, use_dob, relin_per_tick, plant_rows;
  double dt;
  float rho, over_relax, one_minus_over_relax, yawrate_limit;
  float fallback_error_sq, fallback_thrust_ceiling;
  float accel_lo[3], accel_hi[3], fallback_lo[3], fallback_hi[3];
};

struct NoisyTickOperands {
  const float *SxSwT, *SuTqT, *PM, *P1, *P0matT, *SuT, *lo_row, *hi_row;
  const float *ztrT, *sq2, *alpha_s, *y_mean, *inv_ls, *scal;
  const float *state_in, *est_in, *P_in, *aux_in, *xtail_in, *z_in, *y_in, *refs, *yaw_refs;
  const float *noise, *plant_rows, *q_diag, *r_diag, *nominal_row, *bdist;
  float *packed, *state_out, *est_out, *P_out, *aux_out, *xtail_out, *z_out, *y_out;
};

namespace {

constexpr int kThreads = 512;                // ops/tick_pallas.py NOISY_KERNEL_THREADS
constexpr int kGPThreads = kThreads - 64;    // warps 2..
constexpr int kGpGroup = 8;   // the GP's lanes whose sums meet in a shuffle tree (GP_GROUP)
constexpr int kGpStages = 2;  // the GP's stages per thread (NOISY_GP_STAGES)
constexpr int kGPBarrier = 1;     // named barrier of the GP warps (0 is __syncthreads)
constexpr int kShiftBarrier = 2;  // warp 0 has read z[0:4] and X_tail: warps 2.. may shift
constexpr int kControlBarrier = 3;  // warp 0 has the control: warp 1's filter may predict
constexpr int kTruthBarrier = 4;    // warp 0 has the plant's new truth: warp 1 may fuse
constexpr int kNu = uav::kTickNu;
constexpr int kNx = uav::kTickNx;
constexpr int kPacked = 47;     // K5's 32 lanes | estimate 32:44 | disturbance 44:47
constexpr int kAux = 13;        // estimate x0 (6) | integral (3) | applied control (4)
constexpr int kMeas = 9;
constexpr int kDobStates = 15;

// Per-section clock counters (multitick_phases.cuh; the library
// noisy_tick_clocks, which chip_smoke.py times for its breakdown). Sections
// (ops/tick_pallas.py NOISY_SECTIONS): the filter warp's predict,
// relinearise, propagate and fuse; warp 0's scalar section; the filter
// warp's whole chain, its waits included; the GP warps' GP and shift; the
// solve; the whole tick; the solve's six phases (offset, f, p0 and M^-1 f,
// the ADMM, U, X_tail).
constexpr int kSections = 15;

// EKF_MEAS_IDX (0, 1, 2, 6, ..., 11): the measured state lane of entry jm
__device__ __forceinline__ int measured_lane(int jm) { return jm < 3 ? jm : jm + 3; }

__device__ __forceinline__ uav::Plant plant_at(const NoisyTickParams& P,
                                               const NoisyTickOperands& O, int t) {
  return uav::load_plant(O.plant_rows + (P.plant_rows > 1 ? t : 0) * uav::kPlantLanes);
}

// The filter's device functions take their shared arrays as __restrict__
// pointer arguments (registers): a pointer read back from a stack copy
// would have to be reloaded after every store to shared memory.

// Kout = Jb + scale * Jb @ Kin (12 x 12), spread over the warp.
__device__ __forceinline__ void chain_step(const float* __restrict__ Jb,
                                           const float* __restrict__ Kin,
                                           float* __restrict__ Kout, float scale, int lane) {
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const int idx = lane + 32 * r;
    if (idx < 144) {
      const int i = idx / 12, k = idx % 12;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 12; ++j) acc += Jb[i * 12 + j] * Kin[j * 12 + k];
      Kout[idx] = Jb[idx] + scale * acc;
    }
  }
}

// One RK4 step of the filter's process model from the estimate, on the
// whole warp (rk4_stages_warp): the stage states into xs (estimate, x2, x3,
// x4), the prediction into xrow and, in observer mode, the disturbance's
// exact injection (0.5 dt^2 d on positions, dt d on velocities) with d
// itself carried in xrow[12:15]. Ends with a warp barrier.
__device__ __noinline__ void predict(const float* __restrict__ est, float4 c, uav::Plant pl,
                                     double dt, int use_dob, float* __restrict__ xs,
                                     float* __restrict__ xrow, int lane) {
  const float cc[4] = {c.x, c.y, c.z, c.w};
  float e[12], x2[12], x3[12], x4[12], xp[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) e[i] = est[i];
  uav::rk4_stages_warp(e, cc, pl, dt, lane, x2, x3, x4, xp);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      xs[i] = e[i];
      xs[12 + i] = x2[i];
      xs[24 + i] = x3[i];
      xs[36 + i] = x4[i];
    }
    if (use_dob) {
      const float hh = (float)(0.5 * dt * dt), hf = (float)dt;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float d = est[12 + j];
        xp[j] += hh * d;
        xp[3 + j] += hf * d;
        xrow[12 + j] = d;
      }
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) xrow[i] = xp[i];
  }
  __syncwarp();
}

// Fd = F - I (NE x NE) of the filter's RK4 step from the stage states xs:
// the four stage Jacobians (jacobians_warp) into J, the chain K2, K3, K4
// into J[4:7], then Fd = dt/6 (K1 + 2 K2 + 2 K3 + K4) (+ bdist in observer
// mode). J's structural zeros were written once at launch. Ends with a
// warp barrier.
template <int NE>
__device__ __noinline__ void transition_fd(const float* __restrict__ xs, float4 c,
                                           uav::Plant pl, double dt,
                                           const float* __restrict__ bdist,
                                           float* __restrict__ J, float* __restrict__ Fd,
                                           int lane) {
  const float cc[4] = {c.x, c.y, c.z, c.w};
  uav::jacobians_warp(xs, cc, pl, lane, J);
  __syncwarp();
  const float half_h = (float)(0.5 * dt), hf = (float)dt, h6 = (float)(dt / 6.0);
  chain_step(J + 144, J, J + 4 * 144, half_h, lane);
  __syncwarp();
  chain_step(J + 2 * 144, J + 4 * 144, J + 5 * 144, half_h, lane);
  __syncwarp();
  chain_step(J + 3 * 144, J + 5 * 144, J + 6 * 144, hf, lane);
  __syncwarp();
  constexpr int NN = NE * NE;
#pragma unroll
  for (int r = 0; r < (NN + 31) / 32; ++r) {
    const int idx = lane + 32 * r;
    if (idx < NN) {
      const int i = idx / NE, k = idx % NE;
      float v = 0.0f;
      if (i < 12 && k < 12) {
        const int e = i * 12 + k;
        v = h6 * (((J[e] + 2.0f * J[4 * 144 + e]) + 2.0f * J[5 * 144 + e]) + J[6 * 144 + e]);
      }
      if (NE > 12) v += bdist[idx];
      Fd[idx] = v;
    }
  }
  __syncwarp();
}

// P <- P + Fd P + (Fd P)' + Fd P Fd' + Q, then (once wait_truth returns)
// the 9 sequential scalar fusions of the measured lanes of the truth st
// plus this tick's noise
// (yaw innovation wrapped), the attitude estimates wrapped, the estimate
// into est and its x0 into xw; NE = 12 (EKF) or 15 (observer). Lane l keeps
// the P entries l, l + 32, ... in registers across the fusions, which read
// the previous P from one of two shared buffers (Pm, FdP) and write the
// other: one warp barrier per fusion. Lane i < NE keeps x[i]. qr holds
// q_diag at 0 and r_diag at 16. Ends with a warp barrier.
template <int NE, class WaitTruth>
__device__ __noinline__ void propagate_and_fuse(
    const float* __restrict__ Fd, float* __restrict__ Pm, float* __restrict__ FdP,
    const float* __restrict__ xrow, const float* __restrict__ qr,
    const float* __restrict__ st, const float* __restrict__ noise_t, float* __restrict__ est,
    float* __restrict__ xw, int lane, WaitTruth wait_truth) {
  constexpr int NN = NE * NE, R = (NN + 31) / 32;
  SECTION_START(t_prop);
  float nz[kMeas];   // this tick's noise: the loads overlap the propagation
#pragma unroll
  for (int jm = 0; jm < kMeas; ++jm) nz[jm] = __ldg(noise_t + jm);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = lane + 32 * r;
    if (idx < NN) {
      const int i = idx / NE, k = idx % NE;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NE; ++j) acc += Fd[i * NE + j] * Pm[j * NE + k];
      FdP[idx] = acc;
    }
  }
  __syncwarp();
  float p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = lane + 32 * r;
    p[r] = 0.0f;
    if (idx < NN) {
      const int i = idx / NE, k = idx % NE;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NE; ++j) acc += FdP[i * NE + j] * Fd[k * NE + j];
      float v = ((Pm[idx] + FdP[idx]) + FdP[k * NE + i]) + acc;
      if (i == k) v += qr[i];
      p[r] = v;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = lane + 32 * r;
    if (idx < NN) Pm[idx] = p[r];
  }
  float x = lane < NE ? xrow[lane] : 0.0f;
  __syncwarp();
  SECTION_START(t_fuse);
  if (lane == 0) SECTION_ADD(2, t_prop);
  wait_truth();   // st holds this tick's truth
#pragma unroll
  for (int jm = 0; jm < kMeas; ++jm) {
    const int j = measured_lane(jm);
    const float* src = (jm % 2 == 0) ? Pm : FdP;
    float* dst = (jm % 2 == 0) ? FdP : Pm;
    const float S = src[j * NE + j] + qr[16 + jm];
    const float xj = __shfl_sync(uav::kFullMask, x, j);
    float innov = (st[j] + nz[jm]) - xj;
    if (j == 8) innov = uav::wrap_angle(innov);   // yaw seam
    // lane i < NE divides column j's and row j's entry i by S; the column
    // reaches the rank-one update by shuffles
    const int li = lane < NE ? lane : NE - 1;
    const float col_s = src[li * NE + j] / S, row_s = src[j * NE + li] / S;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = lane + 32 * r;
      const int i = idx / NE, k = idx % NE;
      const float ci = __shfl_sync(uav::kFullMask, col_s, i < NE ? i : 0);
      if (idx < NN) p[r] -= ci * src[j * NE + k];
    }
    if (lane < NE) x += innov * row_s;
    if (jm + 1 < kMeas) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int idx = lane + 32 * r;
        if (idx < NN) dst[idx] = p[r];
      }
      __syncwarp();
    }
  }
  // the last fusion read Pm: every lane has passed it before any writes
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = lane + 32 * r;
    if (idx < NN) Pm[idx] = p[r];
  }
  if (lane < NE) {
    if (lane >= 6 && lane < 9) x = uav::wrap_angle(x);
    est[lane] = x;
    if (lane < kNx) xw[lane] = x;
  }
  __syncwarp();
  if (lane == 0) SECTION_ADD(3, t_fuse);
}

// The scalar section of tick t on warp 0: clips, fallback and allocation
// on the estimate, the plant's substeps on the truth
// (mpc_command_plant_warp), then lane 0 writes the packed row and the truth
// / aux carries. With `next`, the control goes into aux[9:13] as soon as
// the allocation has it and the truth into st after the plant, each
// followed by an arrive at the barrier warp 1's filter of the next tick
// waits at. z4 and xt3 (the slack's first stage, X_tail[3:6]) were read
// before the shift could move them. Ends with a warp barrier.
__device__ __forceinline__ void scalar_tick_warp(const NoisyTickParams& P,
                                                 const NoisyTickOperands& O, int t, bool next,
                                                 const float z4[4], const float xt3[3],
                                                 const float* ref, const float* est, float* st,
                                                 float* aux, int lane) {
  const uav::Plant pl = plant_at(P, O, t);
  float s[12], sc[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    s[i] = st[i];
    sc[i] = est[i];
  }
  const float integral[3] = {aux[6], aux[7], aux[8]};
  const float ref3[3] = {ref[0], ref[1], ref[2]};
  const float yaw_ref = O.yaw_refs[t];
  __syncwarp();   // every lane has read st and aux before lane 0 rewrites them
  auto hand_over_control = [&](const float* ctl) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) aux[9 + i] = ctl[i];
    }
    if (next) uav::named_arrive(kControlBarrier, 64);
  };
  float sn[12], c[4], att_sp[3], new_int[3], accel[3];
  uav::mpc_command_plant_warp(P, pl, z4, ref3, sc, s, yaw_ref, integral, lane, sn, c, att_sp,
                              new_int, accel, hand_over_control);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 12; ++i) st[i] = sn[i];
  }
  if (next) uav::named_arrive(kTruthBarrier, 64);
  if (lane == 0) {
    float* row = O.packed + t * kPacked;
#pragma unroll
    for (int i = 0; i < 12; ++i) row[i] = s[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) row[12 + i] = c[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) row[16 + i] = att_sp[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) row[19 + i] = new_int[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) row[22 + i] = accel[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) row[25 + i] = z4[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) row[29 + i] = xt3[i];
#pragma unroll
    for (int i = 0; i < 12; ++i) row[32 + i] = sc[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) row[44 + i] = P.use_dob ? est[12 + i] : 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) aux[i] = sc[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) aux[6 + i] = new_int[i];
  }
  __syncwarp();
}

// The filter of tick t on warp 1: once wait_control returns, predict from
// the applied control (aux[9:13]), relinearise (per tick), propagate P;
// once wait_truth returns, fuse tick t's measurement of the truth st; the
// estimate into est and its x0 into xw.
template <class WaitControl, class WaitTruth>
__device__ __forceinline__ void filter_tick(const NoisyTickParams& P, const NoisyTickOperands& O,
                                            int t, float* est, float* xrow, const float* qr,
                                            float* xs, float* Pm, float* Fd, float* FdP,
                                            float* Jm, const float* st, const float* aux,
                                            float* xw, int lane, WaitControl wait_control,
                                            WaitTruth wait_truth) {
  wait_control();
  SECTION_START(t_predict);
  const uav::Plant pl = P.use_dob ? uav::load_plant(O.nominal_row) : plant_at(P, O, t);
  const float4 c = make_float4(aux[9], aux[10], aux[11], aux[12]);
  predict(est, c, pl, P.dt, P.use_dob, xs, xrow, lane);
  SECTION_START(t_relin);
  if (lane == 0) SECTION_ADD(0, t_predict);
  const float* noise_t = O.noise + t * kMeas;
  if (P.n_est == kDobStates) {
    if (P.relin_per_tick) transition_fd<kDobStates>(xs, c, pl, P.dt, O.bdist, Jm, Fd, lane);
    if (lane == 0) SECTION_ADD(1, t_relin);
    propagate_and_fuse<kDobStates>(Fd, Pm, FdP, xrow, qr, st, noise_t, est, xw, lane,
                                   wait_truth);
  } else {
    if (P.relin_per_tick) transition_fd<12>(xs, c, pl, P.dt, nullptr, Jm, Fd, lane);
    if (lane == 0) SECTION_ADD(1, t_relin);
    propagate_and_fuse<12>(Fd, Pm, FdP, xrow, qr, st, noise_t, est, xw, lane, wait_truth);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gpmpc_noisy_multitick_kernel(const __grid_constant__ NoisyTickParams P,
                             const __grid_constant__ NoisyTickOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int N = P.n, m = P.m, Nnu = N * kNu, Nnx = N * kNx, npm = m + Nnu;
  const int m4 = (m + 3) & ~3;
  const int n = P.n_est;

  // shared memory layout (ops/tick_pallas.py noisy_shared_memory_bytes):
  // K5's up to `red`, then the filter's arrays
  float* P1s = sm;
  float* va = P1s + m * m;
  float* vb = va + m4;
  float* z = vb + m4;
  float* y = z + m;
  float* p0 = y + m;
  float* lo = p0 + m;
  float* hi = lo + m;
  float* lower = hi + m;
  float* upper = lower + m;
  float* xw = upper + m;        // [x0 (6) | w (Nnx)]
  float* wv = xw + kNx;
  float* xtail = wv + Nnx;
  float* offset = xtail + Nnx;
  float* ref = offset + Nnx;
  float* dref = ref + Nnx;
  float* f = dref + Nnx;
  float* minvf = f + Nnu;
  float* U = minvf + Nnu;
  float* part = U + Nnu;        // matvec and ADMM slices: max(nth, npm)
  float* zf = part + max(nth, npm);
  float* red = zf + N * uav::kTickFeat;
  float* st = red + 3 * (kGPThreads / kGpGroup) * kGpStages;   // the truth (12)
  float* aux = st + 12;         // (16)
  float* anchor = aux + 16;     // (8) x0 of the GP's stage 0
  // the filter's arrays (ops/tick_pallas.py _FILTER_FLOATS)
  float* est = anchor + 8;      // (16) estimate [x12 | d3]
  float* xrow = est + 16;       // (16) prediction
  float* qr = xrow + 16;        // (32) q_diag (n) | r_diag (9) at 16
  float* xs = qr + 32;          // (48) RK4 stage states: estimate, x2, x3, x4
  float* Pm = xs + 48;          // (15 x 15, stride n) covariance
  float* Fd = Pm + kDobStates * kDobStates;    // (15 x 15, stride n) F - I
  float* FdP = Fd + kDobStates * kDobStates;   // (15 x 15, stride n)
  float* Jm = FdP + kDobStates * kDobStates;   // 7 x 144: J(est) = K1, J(x2..x4), K2..K4

  {
    const float4* src = reinterpret_cast<const float4*>(O.P1);
    float4* dst = reinterpret_cast<float4*>(P1s);
#pragma unroll 4
    for (int i = tid; i < (m * m) / 4; i += nth) dst[i] = __ldg(src + i);
  }
  for (int i = tid; i < m; i += nth) {
    z[i] = O.z_in[i];
    y[i] = O.y_in[i];
    lo[i] = O.lo_row[i];
    hi[i] = O.hi_row[i];
  }
  for (int i = tid; i < Nnx; i += nth) {
    xtail[i] = O.xtail_in[i];
    wv[i] = 0.0f;               // the GP's rows (zero without the GP)
  }
  for (int i = tid; i < n * n; i += nth) Pm[i] = O.P_in[i];
  if (tid < 12) st[tid] = O.state_in[tid];
  if (tid < kAux) aux[tid] = O.aux_in[tid];
  if (tid < kNx) anchor[tid] = O.aux_in[tid];
  if (tid < n) {
    est[tid] = O.est_in[tid];
    qr[tid] = O.q_diag[tid];
  }
  if (tid < kMeas) qr[16 + tid] = O.r_diag[tid];
  for (int i = tid; i < 4 * 144; i += nth) Jm[i] = 0.0f;   // J's structural zeros
  __syncthreads();

  const uav::GPOperands gp{O.ztrT, O.sq2, O.alpha_s, O.y_mean, O.inv_ls, O.scal, P.n_train};
  const uav::CondensedOperands cops{O.SxSwT, O.SuTqT, O.PM, O.P0matT, O.SuT};
  const uav::TickVectors vec{P1s,   lo,    hi,     ref,  va, vb,    z, y, p0,   lower, upper,
                             xw,    xtail, offset, dref, f,  minvf, U, part, anchor};
  const uav::NamedBarrier gp_bar{kGPBarrier, kGPThreads};
  const uav::NamedBarrier shift_bar{kShiftBarrier, 32 + kGPThreads};   // warps 0, 2..

  // warps 2..: the GP of the next tick, then, once warp 0 has read what the
  // shift moves, the warm-start shift
  auto gp_and_shift = [&](bool after_scalar) {
    SECTION_START(t_gp);
    const int gt = tid - 64;
    if (P.use_gp) {
      uav::gp_horizon_rows<kGpGroup, kGpStages>(gp, N, anchor, xtail, z, zf, red, wv, nullptr,
                                                gt, kGPThreads, gp_bar);
    }
    if (after_scalar) shift_bar();
    uav::warm_shift(z, y, va, vb, N, m, gt, kGPThreads, gp_bar);
    if (gt == 0) SECTION_ADD(6, t_gp);
  };
  // warp 1: the filter of tick t, waiting for warp 0's control and truth
  // (ready at once for tick 0)
  auto filter = [&](int t, bool wait) {
    const uav::NamedBarrier control{kControlBarrier, 64}, truth{kTruthBarrier, 64};
    SECTION_START(t_filter);
    if (wait) {
      filter_tick(P, O, t, est, xrow, qr, xs, Pm, Fd, FdP, Jm, st, aux, xw, lane, control, truth);
    } else {
      filter_tick(P, O, t, est, xrow, qr, xs, Pm, Fd, FdP, Jm, st, aux, xw, lane, [] {}, [] {});
    }
    if (lane == 0) SECTION_ADD(5, t_filter);
  };

  if (warp == 1) {
    if (!P.relin_per_tick) {
      // "dispatch": one Fd for the launch, at the entry estimate and control
      const uav::Plant pl = P.use_dob ? uav::load_plant(O.nominal_row) : plant_at(P, O, 0);
      const float4 c = make_float4(aux[9], aux[10], aux[11], aux[12]);
      predict(est, c, pl, P.dt, P.use_dob, xs, xrow, lane);
      if (n == kDobStates) transition_fd<kDobStates>(xs, c, pl, P.dt, O.bdist, Jm, Fd, lane);
      else transition_fd<12>(xs, c, pl, P.dt, nullptr, Jm, Fd, lane);
    }
    filter(0, false);
  } else if (warp > 1) {
    gp_and_shift(false);
  }
  __syncthreads();

  for (int t = 0; t < P.k_ticks; ++t) {
    SECTION_START(t_tick);
    const bool next = t + 1 < P.k_ticks;
    if (P.use_dob) {
      // the observer's acceleration, summed with the GP's rows
      const float hf = (float)P.dt;
      for (int i = tid; i < N * 3; i += nth) {
        const int k = i / 3, j = i % 3;
        float* w = wv + k * kNx + 3 + j;
        *w = (P.use_gp ? *w : 0.0f) + hf * est[12 + j];
      }
      __syncthreads();
    }
    for (int i = tid; i < Nnx; i += nth) ref[i] = O.refs[t * Nnx + i];
    SECTION_START(t_solve);
    uav::condensed_solve(cops, vec, N, m, P.rho, P.over_relax, P.one_minus_over_relax,
                         P.iterations, tid, nth, 9);
    if (tid == 0) SECTION_ADD(7, t_solve);
    if (warp == 0) {
      // this tick's scalar section beside the next tick's filter and GP
      SECTION_START(t_scalar);
      const float z4[4] = {z[0], z[1], z[2], z[3]};
      const float xt3[3] = {xtail[3], xtail[4], xtail[5]};
      if (next) uav::named_arrive(kShiftBarrier, 32 + kGPThreads);
      scalar_tick_warp(P, O, t, next, z4, xt3, ref, est, st, aux, lane);
      if (lane == 0) SECTION_ADD(4, t_scalar);
    } else if (next) {
      if (warp == 1) filter(t + 1, true);
      else gp_and_shift(true);
    }
    __syncthreads();
    if (tid == 0) SECTION_ADD(8, t_tick);
  }

  for (int i = tid; i < m; i += nth) {
    O.z_out[i] = z[i];
    O.y_out[i] = y[i];
  }
  for (int i = tid; i < Nnx; i += nth) O.xtail_out[i] = xtail[i];
  for (int i = tid; i < n * n; i += nth) O.P_out[i] = Pm[i];
  if (tid < 12) O.state_out[tid] = st[tid];
  if (tid < kAux) O.aux_out[tid] = aux[tid];
  if (tid < n) O.est_out[tid] = est[tid];
}

}  // namespace

extern "C" int gpmpc_noisy_multitick_launch(const NoisyTickParams* params,
                                            const NoisyTickOperands* ops, int smem_bytes,
                                            void* stream) {
  // raise the block's shared-memory limit once per size (host-side call,
  // kept out of the per-launch path and out of CUDA graph captures)
  static int configured_bytes = -1;
  if (smem_bytes > configured_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        gpmpc_noisy_multitick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    configured_bytes = smem_bytes;
  }
  gpmpc_noisy_multitick_kernel<<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(*params, *ops);
  return (int)cudaGetLastError();
}

// The section counters summed since the last call (kSections values, in
// cycles) into out, then reset; returns cudaErrorNotSupported unless built
// with -DUAV_SECTION_CLOCKS. Synchronous: call after the launches finish.
extern "C" int noisy_tick_section_cycles(unsigned long long* out) {
  return uav::read_section_cycles(out, kSections);
}
