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
// solve, and one thread's clips, fallback and allocation on the estimate
// while the plant integrates the truth.
//
// Design: K5's block (tick_kernel.cu: one block per flight, the K ticks a
// loop inside it, P1 in shared memory, the GP, shift and solve from
// multitick_phases.cuh) with a filter warp. The GP of tick t reads only
// tick t-1's results (the anchor, X_tail and the unshifted slack), never
// tick t's estimate, so the filter and the GP are independent within a
// tick: warp 0 runs the whole filter (__syncwarp between its steps) while
// warps 1-7 run the GP and the shift (a named barrier among them), and one
// block barrier joins them before the solve. On the warp, the RK4 stages
// and the four stage Jacobians are warp-cooperative (plant_math.cuh: the
// sines, cosines and divisions spread over lanes, shared by shuffles), and
// the 12 x 12 chain products, the n x n propagation and each fusion's
// rank-one update are spread over the 32 lanes (n = 12 or 15), P kept in
// registers across the nine fusions. With relinearize_every "dispatch" the
// warp forms Fd once at launch entry from the entry estimate and control
// (row 0's plant, or the nominal row).
//
// What bounds it on an H100: the filter adds ~24k FP32 operations per tick
// at n = 12 (~36k at n = 15; the chain products and the propagation) to
// K5's ~1.46 M, and ~5 KB of operands per launch (noise, P, the rows):
// the bound stays ~0.45 us per launch of 20 ticks (operations), and the
// kernel stays latency-bound like K5, one block on one SM. The filter warp
// costs nothing where its serial chain (four warp-wide derivative
// evaluations, the Jacobians, ~20 warp barriers) is shorter than the GP
// it runs beside; -DUAV_SECTION_CLOCKS builds count the cycles of each
// section (chip_smoke.py prints them). Every sum runs in a fixed order
// (deterministic).
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

constexpr int kThreads = 256;   // ops/tick_pallas.py KERNEL_THREADS
constexpr int kGPThreads = kThreads - 32;   // warps 1-7
constexpr int kGPBarrier = 1;   // named barrier of the GP warps (0 is __syncthreads)
constexpr int kNu = uav::kTickNu;
constexpr int kNx = uav::kTickNx;
constexpr int kPacked = 47;     // K5's 32 lanes | estimate 32:44 | disturbance 44:47
constexpr int kAux = 13;        // estimate x0 (6) | integral (3) | applied control (4)
constexpr int kMeas = 9;
constexpr int kDobStates = 15;

// Per-section clock counters, compiled in only with -DUAV_SECTION_CLOCKS
// (the library noisy_tick_clocks, which chip_smoke.py times for its
// breakdown): one lane of each section adds its clock64() cycles over the
// launch's ticks; noisy_tick_section_cycles reads and resets them. Sections
// (ops/tick_pallas.py NOISY_SECTIONS): the filter's predict, relinearise,
// propagate and fuse; the GP warps' GP and shift; the solve; the scalar
// section; the whole tick.
constexpr int kSections = 8;
#ifdef UAV_SECTION_CLOCKS
__device__ unsigned long long g_section_cycles[kSections];
#define SECTION_START(var) const long long var = clock64()
#define SECTION_ADD(i, since) \
  atomicAdd(&g_section_cycles[i], (unsigned long long)(clock64() - (since)))
#else
#define SECTION_START(var)
#define SECTION_ADD(i, since)
#endif

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

// P <- P + Fd P + (Fd P)' + Fd P Fd' + Q, then the 9 sequential scalar
// fusions of the measured lanes of the truth st plus this tick's noise
// (yaw innovation wrapped), the attitude estimates wrapped, the estimate
// into est and its x0 into xw; NE = 12 (EKF) or 15 (observer). Lane l keeps
// the P entries l, l + 32, ... in registers across the fusions, which read
// the previous P from one of two shared buffers (Pm, FdP) and write the
// other: one warp barrier per fusion. Lane i < NE keeps x[i]. qr holds
// q_diag at 0 and r_diag at 16. Ends with a warp barrier.
template <int NE>
__device__ __noinline__ void propagate_and_fuse(
    const float* __restrict__ Fd, float* __restrict__ Pm, float* __restrict__ FdP,
    const float* __restrict__ xrow, const float* __restrict__ qr,
    const float* __restrict__ st, const float* __restrict__ noise_t, float* __restrict__ est,
    float* __restrict__ xw, int lane) {
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

// The scalar section of one tick (one thread): clips, fallback and
// allocation on the estimate, the plant's substeps on the truth, the packed
// row and the truth / aux carries.
__device__ __noinline__ void scalar_tick(const NoisyTickParams& P, const NoisyTickOperands& O,
                                         int t, const float* z, const float* ref,
                                         const float* xtail, const float* est, float* st,
                                         float* aux) {
  const uav::Plant pl = plant_at(P, O, t);
  float s[12], sc[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    s[i] = st[i];
    sc[i] = est[i];
  }
  const float integral[3] = {aux[6], aux[7], aux[8]};
  float sn[12], c[4], att_sp[3], new_int[3], accel[3];
  uav::mpc_command_plant(P, pl, z, ref, sc, s, O.yaw_refs[t], integral, sn, c, att_sp, new_int,
                         accel);

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
  for (int i = 0; i < 4; ++i) row[25 + i] = z[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) row[29 + i] = xtail[3 + i];
#pragma unroll
  for (int i = 0; i < 12; ++i) row[32 + i] = sc[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) row[44 + i] = P.use_dob ? est[12 + i] : 0.0f;

#pragma unroll
  for (int i = 0; i < 12; ++i) st[i] = sn[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) aux[i] = sc[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) aux[6 + i] = new_int[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) aux[9 + i] = c[i];
}

__global__ void __launch_bounds__(kThreads, 1)
gpmpc_noisy_multitick_kernel(const NoisyTickParams P, const NoisyTickOperands O) {
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
  float* part = U + Nnu;        // matvec slices: nth + npm
  float* zf = part + nth + npm;
  float* sq1 = zf + N * uav::kTickFeat;
  float* red = sq1 + N;
  float* st = red + 3 * nth;    // the truth (12)
  float* aux = st + 12;         // (16)
  // the filter's arrays (ops/tick_pallas.py _FILTER_FLOATS)
  float* est = aux + 16;        // (16) estimate [x12 | d3]
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
  for (int i = tid; i < Nnx; i += nth) xtail[i] = O.xtail_in[i];
  for (int i = tid; i < n * n; i += nth) Pm[i] = O.P_in[i];
  if (tid < 12) st[tid] = O.state_in[tid];
  if (tid < kAux) aux[tid] = O.aux_in[tid];
  if (tid < n) {
    est[tid] = O.est_in[tid];
    qr[tid] = O.q_diag[tid];
  }
  if (tid < kMeas) qr[16 + tid] = O.r_diag[tid];
  for (int i = tid; i < 4 * 144; i += nth) Jm[i] = 0.0f;   // J's structural zeros
  __syncthreads();

  if (!P.relin_per_tick && warp == 0) {
    // "dispatch": one Fd for the launch, at the entry estimate and control
    const uav::Plant pl = P.use_dob ? uav::load_plant(O.nominal_row) : plant_at(P, O, 0);
    const float4 c = make_float4(aux[9], aux[10], aux[11], aux[12]);
    predict(est, c, pl, P.dt, P.use_dob, xs, xrow, lane);
    if (n == kDobStates) transition_fd<kDobStates>(xs, c, pl, P.dt, O.bdist, Jm, Fd, lane);
    else transition_fd<12>(xs, c, pl, P.dt, nullptr, Jm, Fd, lane);
  }

  const uav::GPOperands gp{O.ztrT, O.sq2, O.alpha_s, O.y_mean, O.inv_ls, O.scal, P.n_train};
  const uav::CondensedOperands cops{O.SxSwT, O.SuTqT, O.PM, O.P0matT, O.SuT};
  const uav::TickVectors vec{P1s,  lo,     hi,     ref,   va,    vb, z, y, p0, lower,
                             upper, xw,   xtail, offset, dref, f, minvf, U, part};
  const uav::NamedBarrier gp_bar{kGPBarrier, kGPThreads};
  for (int t = 0; t < P.k_ticks; ++t) {
    SECTION_START(t_tick);
    for (int i = tid; i < Nnx; i += nth) ref[i] = O.refs[t * Nnx + i];
    if (warp == 0) {
      // the filter: predict from the applied control, relinearise,
      // propagate P, fuse this tick's measurement
      SECTION_START(t_predict);
      const uav::Plant pl = P.use_dob ? uav::load_plant(O.nominal_row) : plant_at(P, O, t);
      const float4 c = make_float4(aux[9], aux[10], aux[11], aux[12]);
      predict(est, c, pl, P.dt, P.use_dob, xs, xrow, lane);
      SECTION_START(t_relin);
      if (lane == 0) SECTION_ADD(0, t_predict);
      const float* noise_t = O.noise + t * kMeas;
      if (n == kDobStates) {
        if (P.relin_per_tick) transition_fd<kDobStates>(xs, c, pl, P.dt, O.bdist, Jm, Fd, lane);
        if (lane == 0) SECTION_ADD(1, t_relin);
        propagate_and_fuse<kDobStates>(Fd, Pm, FdP, xrow, qr, st, noise_t, est, xw, lane);
      } else {
        if (P.relin_per_tick) transition_fd<12>(xs, c, pl, P.dt, nullptr, Jm, Fd, lane);
        if (lane == 0) SECTION_ADD(1, t_relin);
        propagate_and_fuse<12>(Fd, Pm, FdP, xrow, qr, st, noise_t, est, xw, lane);
      }
    } else {
      // the GP horizon mean and the warm-start shift on warps 1-7
      SECTION_START(t_gp);
      const int gt = tid - 32;
      if (P.use_gp) {
        uav::gp_horizon_rows(gp, N, aux, xtail, z, zf, sq1, red, wv, nullptr, gt, kGPThreads,
                             gp_bar);
      } else {
        for (int i = gt; i < Nnx; i += kGPThreads) wv[i] = 0.0f;
      }
      uav::warm_shift(z, y, va, vb, N, m, gt, kGPThreads, gp_bar);
      if (tid == 32) SECTION_ADD(4, t_gp);
    }
    __syncthreads();
    if (P.use_dob) {
      // the observer's acceleration, summed with the GP's rows
      const float hf = (float)P.dt;
      for (int i = tid; i < N * 3; i += nth) {
        const int k = i / 3, j = i % 3;
        wv[k * kNx + 3 + j] += hf * est[12 + j];
      }
      __syncthreads();
    }
    SECTION_START(t_solve);
    uav::condensed_solve(cops, vec, N, m, P.rho, P.over_relax, P.one_minus_over_relax,
                         P.iterations, tid, nth);
    SECTION_START(t_scalar);
    if (tid == 0) {
      SECTION_ADD(5, t_solve);
      scalar_tick(P, O, t, z, ref, xtail, est, st, aux);
      SECTION_ADD(6, t_scalar);
    }
    __syncthreads();
    if (tid == 0) SECTION_ADD(7, t_tick);
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
#ifdef UAV_SECTION_CLOCKS
  cudaError_t err = cudaMemcpyFromSymbol(out, g_section_cycles, sizeof(g_section_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zeros[kSections] = {};
  return (int)cudaMemcpyToSymbol(g_section_cycles, zeros, sizeof(zeros));
#else
  (void)out;
  return (int)cudaErrorNotSupported;
#endif
}
