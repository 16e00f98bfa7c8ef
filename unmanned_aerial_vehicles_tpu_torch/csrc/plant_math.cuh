// Device math of the PX4 surrogate plant and the geometric allocation,
// warp-cooperative, shared by the plant kernels (plant_kernels.cu: K1, K2), the
// multi-tick tick kernels (tick_kernel.cu: K5; noisy_tick_kernel.cu: K9),
// the single-tick tick kernel (single_tick_kernels.cu: K4) and the plant
// VJP kernels (plant_vjp_kernels.cu: K13a, K13b).
//
// A transcription of the JAX package's ops/plant_pallas.py scalar
// functions (_derivative, _rk4_substeps, _jacobian_rows, _allocation), which the port's
// plain versions (ops/plant_pallas.py) mirror, and of their VJPs. All
// float32, no fast math: sincosf/asinf/sqrtf are the accurate library
// versions. The compiler contracts a*b+c into FMAs, so results agree with
// the plain versions to float32 rounding, not bit for bit. There is one
// device implementation of each piece of math: the one-thread forms went
// with their last callers.
#pragma once

#include <math.h>

namespace uav {

constexpr int kPlantLanes = 10;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// plant row lanes: mass, gravity, k_drag_linear, tau_roll, tau_pitch,
// tau_yaw, thrust_gain, wind_x, wind_y, wind_z
struct Plant {
  float mass, gravity, k_drag, tau_r, tau_p, tau_y, thrust_gain, wx, wy, wz;
};

__device__ __forceinline__ Plant load_plant(const float* row) {
  Plant p;
  p.mass = row[0];
  p.gravity = row[1];
  p.k_drag = row[2];
  p.tau_r = row[3];
  p.tau_p = row[4];
  p.tau_y = row[5];
  p.thrust_gain = row[6];
  p.wx = row[7];
  p.wy = row[8];
  p.wz = row[9];
  return p;
}

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Floor-mod wrap to [-pi, pi): (a + pi) mod 2pi - pi, with the remainder
// taking the divisor's sign. fmodf is exact; the sign fix makes it the
// floor-mod that jnp.remainder and torch.remainder compute, bit for bit
// (the form a - 2pi floor((a + pi) / 2pi) rounds differently).
__device__ __forceinline__ float wrap_angle(float a) {
  float x = a + kPi;
  float m = fmodf(x, kTwoPi);
  if (m != 0.0f && m < 0.0f) m += kTwoPi;
  return m - kPi;
}

// The step lengths of one RK4 substep of dt / substeps, rounded to float
// once as the plain versions round them.
struct Rk4Step {
  float h, half_h, h6;
};

__device__ __forceinline__ Rk4Step rk4_step_lengths(double dt, int substeps) {
  const double h = dt / substeps;
  return Rk4Step{(float)h, (float)(0.5 * h), (float)(h / 6.0)};
}

// The warp-cooperative forms below (K9's filter warp, K13a and K13b, K5's
// and K9's scalar sections, and K1 and K2 on groups of 8 lanes) spread the
// slow, serial pieces of the derivative, the allocation, the closed-form
// Jacobian and their VJPs (the accurate sines, cosines and arcsines, the
// wraps and the IEEE divisions, each behind a slow-path branch) over the
// lanes of one warp and share the results by shuffles: for a derivative
// the warp waits for one sincosf and one division where a single thread
// would wait for six and seven in a row. Every lane must call them with
// the same arguments (all 32 lanes active).
constexpr unsigned kFullMask = 0xffffffffu;

// d(state)/dt of the rate-tracking surrogate (mixed-NED thrust, airspeed
// drag, guarded Euler-rate transform, first-order body-rate lags) on a
// whole warp; every lane gets the whole out. Lanes 0-2 form the sine and
// cosine of one Euler angle each, lanes 0-6 one quotient each.
// kWidth < 32 runs it on each aligned group of kWidth lanes (at least 8),
// lane being the lane's index in its group.
template <int kWidth = 32>
__device__ __forceinline__ void derivative_warp(const float s[12], const float c[4],
                                                const Plant& pl, int lane, float out[12]) {
  float sn, cs;
  sincosf(s[6 + lane % 3], &sn, &cs);
  auto from = [](float v, int src) { return __shfl_sync(kFullMask, v, src, kWidth); };
  const float cphi = from(cs, 0), sphi = from(sn, 0);
  const float cth = from(cs, 1), sth = from(sn, 1);
  const float cpsi = from(cs, 2), spsi = from(sn, 2);
  const float vx = s[3], vy = s[4], vz = s[5];
  const float p = s[9], q = s[10], r = s[11];
  const float cth_safe = fabsf(cth) < 1e-6f ? (cth < 0.0f ? -1e-6f : 1e-6f) : cth;

  // one quotient per lane: tan, the two psi_dot terms, the three rate lags, k/m
  const int k = lane & 7;
  const float num = k == 0 ? sth : k == 1 ? q * sphi : k == 2 ? r * cphi : k == 3 ? c[1] - p
                  : k == 4 ? c[2] - q : k == 5 ? c[3] - r : pl.k_drag;
  const float den = k == 0 ? cth : k < 3 ? cth_safe : k == 3 ? pl.tau_r : k == 4 ? pl.tau_p
                  : k == 5 ? pl.tau_y : pl.mass;
  const float quo = num / den;
  const float tth = from(quo, 0);
  const float psi_q = from(quo, 1), psi_r = from(quo, 2);
  const float p_dot = from(quo, 3), q_dot = from(quo, 4);
  const float r_dot = from(quo, 5), kd = from(quo, 6);

  const float t0 = -(cphi * sth * cpsi + sphi * spsi);
  const float t1 = -(cphi * sth * spsi - sphi * cpsi);
  const float t2 = cphi * cth;
  const float a_thrust = c[0] * pl.thrust_gain;
  const float avx = vx - pl.wx, avy = vy - pl.wy, avz = vz - pl.wz;
  const float sq = avx * avx + avy * avy + avz * avz;
  const float speed = sq > 0.0f ? sqrtf(sq) : 0.0f;
  out[0] = vx;
  out[1] = vy;
  out[2] = vz;
  out[3] = a_thrust * t0 - kd * speed * avx;
  out[4] = a_thrust * t1 - kd * speed * avy;
  out[5] = a_thrust * t2 - kd * speed * avz - pl.gravity;
  out[6] = p + q * sphi * tth + r * cphi * tth;
  out[7] = q * cphi - r * sphi;
  out[8] = psi_q + psi_r;
  out[9] = p_dot;
  out[10] = q_dot;
  out[11] = r_dot;
}

// One RK4 step of length dt from s on a whole warp (the noisy tick's filter
// prediction): the stage states x2, x3, x4 (the linearisation points of the
// transition Jacobian) and the predicted state xp, the same on every lane
// (of each group of kWidth lanes, as derivative_warp).
template <int kWidth = 32>
__device__ __forceinline__ void rk4_stages_warp(const float s[12], const float c[4],
                                                const Plant& pl, double dt, int lane,
                                                float x2[12], float x3[12], float x4[12],
                                                float xp[12]) {
  const float hf = (float)dt, half_h = (float)(0.5 * dt), h6 = (float)(dt / 6.0);
  float k[12], acc[12];
  derivative_warp<kWidth>(s, c, pl, lane, acc);
#pragma unroll
  for (int i = 0; i < 12; ++i) x2[i] = s[i] + half_h * acc[i];
  derivative_warp<kWidth>(x2, c, pl, lane, k);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    x3[i] = s[i] + half_h * k[i];
    acc[i] = acc[i] + 2.0f * k[i];
  }
  derivative_warp<kWidth>(x3, c, pl, lane, k);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    x4[i] = s[i] + hf * k[i];
    acc[i] = acc[i] + 2.0f * k[i];
  }
  derivative_warp<kWidth>(x4, c, pl, lane, k);
#pragma unroll
  for (int i = 0; i < 12; ++i) xp[i] = s[i] + h6 * (acc[i] + k[i]);
}

// `substeps` RK4 steps of length dt / substeps in place on s, on each group
// of kWidth lanes (rk4_stages_warp; K1, K2).
template <int kWidth = 32>
__device__ __forceinline__ void rk4_substeps_warp(float s[12], const float c[4], const Plant& pl,
                                                  double dt, int substeps, int lane) {
  const double h = dt / substeps;
  for (int step = 0; step < substeps; ++step) {
    float x2[12], x3[12], x4[12], xp[12];
    rk4_stages_warp<kWidth>(s, c, pl, h, lane, x2, x3, x4, xp);
#pragma unroll
    for (int i = 0; i < 12; ++i) s[i] = xp[i];
  }
}

// d(derivative)/d(state) in closed form at the four RK4 stage states xs
// (4 x 12) on a whole warp, row-major into J + 144 g for stage g (12 x 12
// each): identity from velocity to position, the airspeed drag -(k/m)(speed
// I + av av' / speed) (zero at zero airspeed), the thrust direction's
// Euler-angle derivatives on the acceleration rows, the Euler-rate
// transform's derivatives on the attitude rows, -1/tau on the rate rows.
// Only the entries that are not structurally zero are written: the caller
// zeroes J once. Unlike derivative_warp, the phi row uses the guarded tangent
// sin / cth_safe (the same for any bounded attitude). A transcription of
// the JAX package's ops/plant_pallas.py:_jacobian_rows: lanes 0-11 form the
// sine and cosine of one angle of one stage and a quotient each (per stage
// 1 / cth_safe, sth / cth_safe, 1 / |airspeed|), lanes 12-15 k/m and the
// three -1/tau; lane g < 4 then writes stage g's entries.
__device__ __forceinline__ void jacobians_warp(const float* xs, const float c[4],
                                               const Plant& pl, int lane, float* J) {
  const int l12 = lane < 12 ? lane : 11, g3 = 3 * (l12 / 3);
  const float* sg = xs + 12 * (l12 / 3);   // this lane's stage state
  float sn, cs;
  sincosf(sg[6 + lane % 3], &sn, &cs);
  // lanes 0-11: the quotients of stage lane / 3; lanes 12-15 the plant's
  const float cth = __shfl_sync(kFullMask, cs, g3 + 1), sth = __shfl_sync(kFullMask, sn, g3 + 1);
  const float cth_safe = fabsf(cth) < 1e-6f ? (cth < 0.0f ? -1e-6f : 1e-6f) : cth;
  const float avx = sg[3] - pl.wx, avy = sg[4] - pl.wy, avz = sg[5] - pl.wz;
  const float sq = avx * avx + avy * avy + avz * avz;
  const int w = lane < 12 ? lane % 3 : lane - 9;   // 3: k/m, 4-6: the rate lags
  const float num = w == 0 ? 1.0f : w == 1 ? sth : w == 2 ? 1.0f : w == 3 ? pl.k_drag : -1.0f;
  const float den = w < 2 ? cth_safe : w == 2 ? (sq > 0.0f ? sqrtf(sq) : 1.0f)
                  : w == 3 ? pl.mass : w == 4 ? pl.tau_r : w == 5 ? pl.tau_p : pl.tau_y;
  float quo = num / den;
  if (w == 2 && !(sq > 0.0f)) quo = 0.0f;
  const int g = lane & 3, b = 3 * g;   // lane g < 4 writes stage g
  const float cphi = __shfl_sync(kFullMask, cs, b), sphi = __shfl_sync(kFullMask, sn, b);
  const float cth_g = __shfl_sync(kFullMask, cs, b + 1), sth_g = __shfl_sync(kFullMask, sn, b + 1);
  const float cpsi = __shfl_sync(kFullMask, cs, b + 2), spsi = __shfl_sync(kFullMask, sn, b + 2);
  const float sec = __shfl_sync(kFullMask, quo, b), tth = __shfl_sync(kFullMask, quo, b + 1);
  const float inv_speed = __shfl_sync(kFullMask, quo, b + 2);
  const float kd = __shfl_sync(kFullMask, quo, 12), nr = __shfl_sync(kFullMask, quo, 13);
  const float np = __shfl_sync(kFullMask, quo, 14), ny = __shfl_sync(kFullMask, quo, 15);
  if (lane >= 4) return;

  const float* s = xs + 12 * g;
  const float q = s[10], r = s[11];
  const float sec2 = sec * sec;
  const float av[3] = {s[3] - pl.wx, s[4] - pl.wy, s[5] - pl.wz};
  const float sqg = av[0] * av[0] + av[1] * av[1] + av[2] * av[2];
  const float speed = sqg * inv_speed;
  const float a = c[0] * pl.thrust_gain;
  const float dphi[3] = {a * (sphi * sth_g * cpsi - cphi * spsi),
                         a * (sphi * sth_g * spsi + cphi * cpsi), a * (-sphi * cth_g)};
  const float dth[3] = {a * (-cphi * cth_g * cpsi), a * (-cphi * cth_g * spsi),
                        a * (-cphi * sth_g)};
  const float dpsi[3] = {a * (cphi * sth_g * spsi - sphi * cpsi),
                         a * (-(cphi * sth_g * cpsi + sphi * spsi)), 0.0f};
  float* Jg = J + 144 * g;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Jg[i * 12 + 3 + i] = 1.0f;
    float* row = Jg + (3 + i) * 12;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      row[3 + j] = -kd * ((i == j ? speed : 0.0f) + av[i] * av[j] * inv_speed);
    row[6] = dphi[i];
    row[7] = dth[i];
    row[8] = dpsi[i];
  }
  float* r6 = Jg + 6 * 12;
  r6[6] = q * cphi * tth - r * sphi * tth;
  r6[7] = (q * sphi + r * cphi) * sec2;
  r6[9] = 1.0f;
  r6[10] = sphi * tth;
  r6[11] = cphi * tth;
  float* r7 = Jg + 7 * 12;
  r7[6] = -q * sphi - r * cphi;
  r7[10] = cphi;
  r7[11] = -sphi;
  float* r8 = Jg + 8 * 12;
  r8[6] = (q * cphi - r * sphi) * sec;
  r8[7] = (q * sphi + r * cphi) * sth_g * sec2;
  r8[10] = sphi * sec;
  r8[11] = cphi * sec;
  Jg[9 * 12 + 9] = nr;
  Jg[10 * 12 + 10] = np;
  Jg[11 * 12 + 11] = ny;
}

// Geometric allocation + attitude PID (Kp 3.2, Ki 0.6, Kd 0.6, integral
// clip 0.3) on a whole warp (the multi-tick kernels' scalar section, K2,
// K13b). cmd = ax, ay, az, yawrate, yaw. Writes control (thrust, p, q, r),
// att_sp (roll, pitch, yaw) and the new integral. Lanes 0 and 1 form the
// pitch and roll arcsines, lanes 0-2 one wrapped attitude error each
// (fmodf), shared by shuffles; every lane gets the whole output. Every
// lane must call it with the same arguments (all 32 lanes active); kWidth
// as in derivative_warp.
template <int kWidth = 32>
__device__ __forceinline__ void allocation_warp(const float s[12], const float cmd[5],
                                                const float integral[3], float dt, float gravity,
                                                float thrust_ceiling, int lane, float control[4],
                                                float att_sp[3], float new_int[3]) {
  const float kp = 3.2f, ki = 0.6f, kd = 0.6f, integral_max = 0.3f;
  const float tvx = cmd[0], tvy = cmd[1], tvz = cmd[2] + gravity;
  const float tmag = sqrtf(tvx * tvx + tvy * tvy + tvz * tvz);
  const float thrust = fminf(fmaxf(tmag / gravity, 0.25f), thrust_ceiling);
  const float inv = 1.0f / fmaxf(tmag, 1e-9f);
  const float tilt = asinf(clipf(((lane & 1) ? tvy : tvx) * inv, -0.4f, 0.4f));
  float pitch_cmd = -__shfl_sync(kFullMask, tilt, 0, kWidth);
  float roll_cmd = __shfl_sync(kFullMask, tilt, 1, kWidth);
  if (tmag <= 0.1f) {
    pitch_cmd = 0.0f;
    roll_cmd = 0.0f;
  }
  const float target_yaw = cmd[4];
  const int w = lane % 3;
  const float err = wrap_angle((w == 0 ? roll_cmd : w == 1 ? pitch_cmd : target_yaw) - s[6 + w]);
  const float e0 = __shfl_sync(kFullMask, err, 0, kWidth);
  const float e1 = __shfl_sync(kFullMask, err, 1, kWidth);
  const float e2 = __shfl_sync(kFullMask, err, 2, kWidth);
  const float i0 = clipf(integral[0] + e0 * dt, -integral_max, integral_max);
  const float i1 = clipf(integral[1] + e1 * dt, -integral_max, integral_max);
  const float i2 = clipf(integral[2] + e2 * dt, -integral_max, integral_max);
  control[0] = thrust;
  control[1] = clipf(kp * e0 + ki * i0 - kd * s[9], -1.2f, 1.2f);
  control[2] = clipf(kp * e1 + ki * i1 - kd * s[10], -1.2f, 1.2f);
  control[3] = clipf(cmd[3] + kp * e2 + ki * i2 - kd * s[11], -0.8f, 0.8f);
  att_sp[0] = roll_cmd;
  att_sp[1] = pitch_cmd;
  att_sp[2] = target_yaw;
  new_int[0] = i0;
  new_int[1] = i1;
  new_int[2] = i2;
}

// The scalar section of one fused MPC tick on a whole warp (K5, K9 and
// K4): the first stage of the slack's U-block z4 clipped to the
// acceleration and yaw-rate limits; the hover fallback when the controller
// state sc is farther than the threshold from ref3 (PD law a = 1.5 e -
// 0.8 v with widened clips, yaw rate 0, raised thrust ceiling); `Params` is
// any struct with the fields read below (TickParams, NoisyTickParams,
// SingleTickParams). The clips and the fallback run on every lane, then
// allocation_warp (allocation + attitude PID on sc), after_control(c) (K9
// hands the control to its filter warp there), and the plant's `substeps`
// RK4 steps from s as rk4_stages_warp at dt / substeps (its step lengths
// rounded from that double as rk4_step_lengths rounds them). ref3 is the
// first stage's position reference. Every lane gets the whole output; all
// 32 lanes must call it.
template <class Params, class AfterControl>
__device__ __forceinline__ void mpc_command_plant_warp(const Params& P, const Plant& pl,
                                                       const float z4[4], const float ref3[3],
                                                       const float sc[12], const float s[12],
                                                       float yaw_ref, const float integral[3],
                                                       int lane, float sn[12], float c[4],
                                                       float att_sp[3], float new_int[3],
                                                       float accel[3],
                                                       AfterControl after_control) {
  float ax = clipf(z4[0], P.accel_lo[0], P.accel_hi[0]);
  float ay = clipf(z4[1], P.accel_lo[1], P.accel_hi[1]);
  float az = clipf(z4[2], P.accel_lo[2], P.accel_hi[2]);
  float yr = clipf(z4[3], -P.yawrate_limit, P.yawrate_limit);
  float thrust_hi = 1.2f;
  if (P.use_fallback) {
    const float ex = ref3[0] - sc[0], ey = ref3[1] - sc[1], ez = ref3[2] - sc[2];
    if (ex * ex + ey * ey + ez * ez > P.fallback_error_sq) {
      ax = clipf(1.5f * ex - 0.8f * sc[3], P.fallback_lo[0], P.fallback_hi[0]);
      ay = clipf(1.5f * ey - 0.8f * sc[4], P.fallback_lo[1], P.fallback_hi[1]);
      az = clipf(1.5f * ez - 0.8f * sc[5], P.fallback_lo[2], P.fallback_hi[2]);
      yr = 0.0f;
      thrust_hi = P.fallback_thrust_ceiling;
    }
  }
  const float cmd[5] = {ax, ay, az, yr, yaw_ref};
  allocation_warp(sc, cmd, integral, (float)P.dt, pl.gravity, thrust_hi, lane, c, att_sp,
                  new_int);
  after_control(c);
#pragma unroll
  for (int i = 0; i < 12; ++i) sn[i] = s[i];
  const double h = P.dt / P.substeps;
  for (int step = 0; step < P.substeps; ++step) {
    float x2[12], x3[12], x4[12], xp[12];
    rk4_stages_warp(sn, c, pl, h, lane, x2, x3, x4, xp);
#pragma unroll
    for (int i = 0; i < 12; ++i) sn[i] = xp[i];
  }
  accel[0] = ax;
  accel[1] = ay;
  accel[2] = az;
}


// ---------------------------------------------------------------------------
// Reverse mode (the K13 VJP kernels, plant_vjp_kernels.cu). Each function
// recomputes its forward intermediates as the code above forms them and runs the
// adjoint back through them, with PyTorch autograd's rules at the kinks of
// the plain versions (ops/plant_pallas.py): torch.clamp passes the gradient
// on its closed interval, torch.minimum splits it equally at a tie,
// torch.where sends it to the branch taken, torch.remainder has slope 1,
// the guarded sqrt of the drag has no gradient at zero airspeed, and the
// cos(theta) guard passes it only where it does not bind. Cotangents are
// added into the outputs (the caller zeroes them).
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool in_closed(float x, float lo, float hi) {
  return x >= lo && x <= hi;
}

// derivative_warp()'s VJP on a whole warp (K13a, K13b): from the cotangent
// g of its output, gs += J_s' g, gc += J_c' g, gp += J_p' g (gp has the
// plant row's 10 lanes); every lane gets the whole update. Lanes 0-2 form
// the sine and cosine of one Euler angle each and lanes 0-13 one quotient
// each, shared by shuffles, so the warp waits for one sincosf and one
// division where one thread would wait for six and fifteen. kd is the
// plant's k_drag / mass, formed once by the caller. Every lane must call
// it with the same arguments.
__device__ __forceinline__ void derivative_vjp_warp(const float s[12], const float c[4],
                                                    const Plant& pl, float kd, const float g[12],
                                                    int lane, float gs[12], float gc[4],
                                                    float gp[kPlantLanes]) {
  float sn, cs;
  sincosf(s[6 + lane % 3], &sn, &cs);
  const float cphi = __shfl_sync(kFullMask, cs, 0), sphi = __shfl_sync(kFullMask, sn, 0);
  const float cth = __shfl_sync(kFullMask, cs, 1), sth = __shfl_sync(kFullMask, sn, 1);
  const float cpsi = __shfl_sync(kFullMask, cs, 2), spsi = __shfl_sync(kFullMask, sn, 2);
  const float vx = s[3], vy = s[4], vz = s[5];
  const float p = s[9], q = s[10], r = s[11];
  const float t0 = -(cphi * sth * cpsi + sphi * spsi);
  const float t1 = -(cphi * sth * spsi - sphi * cpsi);
  const float t2 = cphi * cth;
  const float a_thrust = c[0] * pl.thrust_gain;
  const float avx = vx - pl.wx, avy = vy - pl.wy, avz = vz - pl.wz;
  const float sq = avx * avx + avy * avy + avz * avz;
  const bool moving = sq > 0.0f;
  const float speed = moving ? sqrtf(sq) : 0.0f;
  const bool guarded = fabsf(cth) < 1e-6f;
  const float cth_safe = guarded ? (cth < 0.0f ? -1e-6f : 1e-6f) : cth;
  const float g_kd_speed = -(g[3] * avx + g[4] * avy + g[5] * avz);
  const float g_kd = g_kd_speed * speed;
  // q sphi rounded, then r cphi fused into it: the rounding the one-thread
  // form's compiled code made (the first VJP kernels'). Left to the
  // compiler, the warp form fused q sphi instead, which moved g_sth and
  // g_cth by a rounding in 7% of states (PERF.md §6)
  const float qr = __fmaf_rn(r, cphi, __fmul_rn(q, sphi));
  const float g_tth = g[6] * qr;

  // one quotient per lane: tan, the drag's three, the attitude rows' four,
  // the rate rows' six (lanes 14-15 and 16-31 repeat; a quotient of a
  // branch not taken, as x / 0 at zero airspeed, is never read)
  const int k = lane & 15;
  float num, den;
  switch (k) {
    case 0: num = sth; den = cth; break;
    case 1: num = g_kd_speed * kd; den = 2.0f * speed; break;
    case 2: num = g_kd; den = pl.mass; break;
    case 3: num = g_kd * pl.k_drag; den = pl.mass * pl.mass; break;
    case 4: num = g_tth; den = cth; break;
    case 5: num = g_tth * sth; den = cth * cth; break;
    case 6: num = g[8]; den = cth_safe; break;
    case 7: num = g[8] * qr; den = cth_safe * cth_safe; break;
    case 8: num = g[9]; den = pl.tau_r; break;
    case 9: num = g[10]; den = pl.tau_p; break;
    case 10: num = g[11]; den = pl.tau_y; break;
    case 11: num = g[9] * (c[1] - p); den = pl.tau_r * pl.tau_r; break;
    case 12: num = g[10] * (c[2] - q); den = pl.tau_p * pl.tau_p; break;
    case 13: num = g[11] * (c[3] - r); den = pl.tau_y * pl.tau_y; break;
    default: num = 0.0f; den = 1.0f; break;
  }
  const float quo = num / den;
  const float tth = __shfl_sync(kFullMask, quo, 0), g_sq = __shfl_sync(kFullMask, quo, 1);
  const float g_kd_m = __shfl_sync(kFullMask, quo, 2), g_kd_mm = __shfl_sync(kFullMask, quo, 3);
  const float g_sth_t = __shfl_sync(kFullMask, quo, 4), g_cth_t = __shfl_sync(kFullMask, quo, 5);
  const float g8 = __shfl_sync(kFullMask, quo, 6), g_cth_8 = __shfl_sync(kFullMask, quo, 7);
  const float g_p = __shfl_sync(kFullMask, quo, 8), g_q = __shfl_sync(kFullMask, quo, 9);
  const float g_r = __shfl_sync(kFullMask, quo, 10), g_tr = __shfl_sync(kFullMask, quo, 11);
  const float g_tp = __shfl_sync(kFullMask, quo, 12), g_ty = __shfl_sync(kFullMask, quo, 13);

  // position rows: d(x)/dt = v
  gs[3] += g[0];
  gs[4] += g[1];
  gs[5] += g[2];

  // acceleration rows: a_thrust t - kd speed av - gravity e_z
  const float g_at = g[3] * t0 + g[4] * t1 + g[5] * t2;
  const float g_t0 = g[3] * a_thrust, g_t1 = g[4] * a_thrust, g_t2 = g[5] * a_thrust;
  gc[0] += g_at * pl.thrust_gain;
  gp[6] += g_at * c[0];
  const float kd_speed = kd * speed;
  float g_av[3] = {-kd_speed * g[3], -kd_speed * g[4], -kd_speed * g[5]};
  if (moving) {
    g_av[0] += 2.0f * avx * g_sq;
    g_av[1] += 2.0f * avy * g_sq;
    g_av[2] += 2.0f * avz * g_sq;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gs[3 + i] += g_av[i];
    gp[7 + i] -= g_av[i];
  }
  gp[2] += g_kd_m;
  gp[0] -= g_kd_mm;
  gp[1] -= g[5];

  // the thrust direction's trigonometric factors
  float g_cphi = 0.0f, g_sphi = 0.0f, g_cth = 0.0f, g_sth = 0.0f, g_cpsi = 0.0f, g_spsi = 0.0f;
  g_cphi -= g_t0 * sth * cpsi;
  g_sth -= g_t0 * cphi * cpsi;
  g_cpsi -= g_t0 * cphi * sth;
  g_sphi -= g_t0 * spsi;
  g_spsi -= g_t0 * sphi;
  g_cphi -= g_t1 * sth * spsi;
  g_sth -= g_t1 * cphi * spsi;
  g_spsi -= g_t1 * cphi * sth;
  g_sphi += g_t1 * cpsi;
  g_cpsi += g_t1 * sphi;
  g_cphi += g_t2 * cth;
  g_cth += g_t2 * cphi;

  // attitude rows: the Euler-rate transform (phi row unguarded, psi row guarded)
  gs[9] += g[6];
  gs[10] += g[6] * sphi * tth;
  gs[11] += g[6] * cphi * tth;
  g_sphi += g[6] * q * tth;
  g_cphi += g[6] * r * tth;
  g_sth += g_sth_t;
  g_cth -= g_cth_t;
  gs[10] += g[7] * cphi;
  gs[11] -= g[7] * sphi;
  g_cphi += g[7] * q;
  g_sphi -= g[7] * r;
  gs[10] += g8 * sphi;
  gs[11] += g8 * cphi;
  g_sphi += g8 * q;
  g_cphi += g8 * r;
  if (!guarded) g_cth -= g_cth_8;

  // rate rows: (command - rate) / tau
  gc[1] += g_p;
  gc[2] += g_q;
  gc[3] += g_r;
  gs[9] -= g_p;
  gs[10] -= g_q;
  gs[11] -= g_r;
  gp[3] -= g_tr;
  gp[4] -= g_tp;
  gp[5] -= g_ty;

  gs[6] += g_sphi * cphi - g_cphi * sphi;
  gs[7] += g_sth * cth - g_cth * sth;
  gs[8] += g_spsi * cpsi - g_cpsi * spsi;
}

// A hook that does nothing (rk4_substeps_vjp_warp's default AfterForward).
struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

// The VJP of `substeps` RK4 steps of length dt / substeps on a whole warp
// (K13a, K13b): on entry gs holds the cotangent of the state after the
// substeps, on return the cotangent of the state s0 before them; the
// control's and the plant row's are added into gc and gp. The forward runs
// once through rk4_stages_warp, each substep's start state and stage states
// x2, x3, x4 stored in the warp's stages (substeps x 48 floats of shared
// memory, lane 0 writing); then after_forward() (K13b's clocks build reads
// the clock there), and the adjoint runs back through each substep's
// k4 .. k1 at those states with derivative_vjp_warp. Every lane ends with
// the whole gs, gc, gp.
template <class AfterForward = NoHook>
__device__ __forceinline__ void rk4_substeps_vjp_warp(const float s0[12], const float c[4],
                                                      const Plant& pl, double dt, int substeps,
                                                      int lane, float* stages, float gs[12],
                                                      float gc[4], float gp[kPlantLanes],
                                                      AfterForward after_forward = AfterForward()) {
  const Rk4Step st = rk4_step_lengths(dt, substeps);
  const float kd = pl.k_drag / pl.mass;
  float s[12], x2[12], x3[12], x4[12], xp[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = s0[i];
  for (int step = 0; step < substeps; ++step) {
    rk4_stages_warp(s, c, pl, dt / substeps, lane, x2, x3, x4, xp);
    if (lane == 0) {
      float* at = stages + 48 * step;
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        at[i] = s[i];
        at[12 + i] = x2[i];
        at[24 + i] = x3[i];
        at[36 + i] = x4[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) s[i] = xp[i];
  }
  __syncwarp();
  after_forward();
  for (int step = substeps - 1; step >= 0; --step) {
    const float* at = stages + 48 * step;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      s[i] = at[i];
      x2[i] = at[12 + i];
      x3[i] = at[24 + i];
      x4[i] = at[36 + i];
    }
    // s' = s + h6 (k1 + 2 k2 + 2 k3 + k4), back through k4 .. k1
    float g_sum[12], g_k[12], g_x[12], g_s[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      g_sum[i] = st.h6 * gs[i];
      g_s[i] = gs[i];
      g_x[i] = 0.0f;
    }
    derivative_vjp_warp(x4, c, pl, kd, g_sum, lane, g_x, gc, gp);   // k4 = f(x4)
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      g_s[i] += g_x[i];
      g_k[i] = 2.0f * g_sum[i] + st.h * g_x[i];      // x4 = s + h k3
      g_x[i] = 0.0f;
    }
    derivative_vjp_warp(x3, c, pl, kd, g_k, lane, g_x, gc, gp);     // k3 = f(x3)
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      g_s[i] += g_x[i];
      g_k[i] = 2.0f * g_sum[i] + st.half_h * g_x[i]; // x3 = s + h/2 k2
      g_x[i] = 0.0f;
    }
    derivative_vjp_warp(x2, c, pl, kd, g_k, lane, g_x, gc, gp);     // k2 = f(x2)
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      g_s[i] += g_x[i];
      g_k[i] = g_sum[i] + st.half_h * g_x[i];        // x2 = s + h/2 k1
    }
    derivative_vjp_warp(s, c, pl, kd, g_k, lane, g_s, gc, gp);      // k1 = f(s)
#pragma unroll
    for (int i = 0; i < 12; ++i) gs[i] = g_s[i];
  }
}

// allocation_warp()'s VJP on a whole warp (K13b): from the cotangents of
// control (4), att_sp (3) and new_int (3), add those of s (12), cmd (5),
// integral (3), gravity and the thrust ceiling; every lane gets the whole
// update. The allocation is recomputed, its serial pieces one to a lane in
// three rounds and shared by shuffles (the lane table is ops/tick_ad.py
// ALLOC_VJP_LANES; the other lanes repeat a neighbour's work, unread):
// lanes 0 and 1 divide tmag / gravity and 1 / max(tmag, 1e-9); then lane 0
// forms the pitch's arcsine and the rsqrtf of its derivative and the
// thrust's g_x / gravity, lane 1 the roll's and g_x tmag / gravity^2; then
// lanes 0-2 one wrapped attitude error each (roll, pitch, yaw). The last
// quotient, g_tmag / (2 tmag), is alone in its round and every lane forms
// it (a shuffle would only add its latency). So the warp waits for about
// four of these in a row where one thread would wait for about twenty.
// The rules at the kinks are PyTorch autograd's (above): the clamps pass
// the gradient on their closed interval, the tilt's is zero when
// degenerate (tmag <= 0.1), min(max(tmag / g, 0.25), ceiling) splits it at
// a tie with the ceiling, and the wrap has slope 1.
__device__ __forceinline__ void allocation_vjp_warp(const float s[12], const float cmd[5],
                                                    const float integral[3], float dt,
                                                    float gravity, float thrust_ceiling,
                                                    const float g_control[4], const float g_att[3],
                                                    const float g_new_int[3], int lane,
                                                    float gs[12], float gcmd[5], float gint[3],
                                                    float* g_gravity, float* g_ceiling) {
  auto from = [](float v, int src) { return __shfl_sync(kFullMask, v, src); };
  const float kp = 3.2f, ki = 0.6f, kd = 0.6f, integral_max = 0.3f;
  const float tvx = cmd[0], tvy = cmd[1], tvz = cmd[2] + gravity;
  const float tmag = sqrtf(tvx * tvx + tvy * tvy + tvz * tvz);
  const bool odd = (lane & 1) != 0;   // lane 0: the pitch's pieces, lane 1: the roll's

  // round 1: lane 0 x = tmag / gravity, lane 1 inv = 1 / max(tmag, 1e-9)
  const float q1 = (odd ? 1.0f : tmag) / (odd ? fmaxf(tmag, 1e-9f) : gravity);
  const float x = from(q1, 0), inv = from(q1, 1);
  const float x_lo = fmaxf(x, 0.25f);
  const float sin_pitch = tvx * inv, sin_roll = tvy * inv;
  const float sin_pitch_c = clipf(sin_pitch, -0.4f, 0.4f);
  const float sin_roll_c = clipf(sin_roll, -0.4f, 0.4f);
  const bool degenerate = tmag <= 0.1f;
  // thrust = min(max(tmag / g, 0.25), ceiling): a tie splits the gradient
  float g_x_lo = 0.0f;
  if (x_lo < thrust_ceiling) {
    g_x_lo = g_control[0];
  } else if (x_lo > thrust_ceiling) {
    *g_ceiling += g_control[0];
  } else {
    g_x_lo = 0.5f * g_control[0];
    *g_ceiling += 0.5f * g_control[0];
  }
  const float g_x = x >= 0.25f ? g_x_lo : 0.0f;

  // round 2: the tilt's arcsine and the rsqrtf of its derivative, and the
  // thrust's two quotients (lane 0 g_x / gravity, lane 1 g_x tmag / g^2)
  const float sin_c = odd ? sin_roll_c : sin_pitch_c;
  const float tilt = asinf(sin_c);
  const float rs = rsqrtf(1.0f - sin_c * sin_c);
  const float q2 = (odd ? g_x * tmag : g_x) / (odd ? gravity * gravity : gravity);
  const float pitch_cmd = degenerate ? 0.0f : -from(tilt, 0);
  const float roll_cmd = degenerate ? 0.0f : from(tilt, 1);
  const float rs_pitch = from(rs, 0), rs_roll = from(rs, 1);
  const float g_x_g = from(q2, 0), g_x_gg = from(q2, 1);

  // round 3: lanes 0-2 one wrapped attitude error each
  const int w = lane % 3;
  const float err = wrap_angle((w == 0 ? roll_cmd : w == 1 ? pitch_cmd : cmd[4])
                               - (w == 0 ? s[6] : w == 1 ? s[7] : s[8]));
  const float e[3] = {from(err, 0), from(err, 1), from(err, 2)};
  float u[3], in[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u[i] = integral[i] + e[i] * dt;
    in[i] = clipf(u[i], -integral_max, integral_max);
  }
  const float v0 = kp * e[0] + ki * in[0] - kd * s[9];
  const float v1 = kp * e[1] + ki * in[1] - kd * s[10];
  const float v2 = cmd[3] + kp * e[2] + ki * in[2] - kd * s[11];

  // the rate commands' clips, the PID, the integral's clip
  const float g_v[3] = {in_closed(v0, -1.2f, 1.2f) ? g_control[1] : 0.0f,
                        in_closed(v1, -1.2f, 1.2f) ? g_control[2] : 0.0f,
                        in_closed(v2, -0.8f, 0.8f) ? g_control[3] : 0.0f};
  gcmd[3] += g_v[2];
  float g_e[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gs[9 + i] -= kd * g_v[i];
    g_e[i] = kp * g_v[i];
    const float g_in = ki * g_v[i] + g_new_int[i];
    const float g_u = in_closed(u[i], -integral_max, integral_max) ? g_in : 0.0f;
    gint[i] += g_u;
    g_e[i] += dt * g_u;
    gs[6 + i] -= g_e[i];   // the wrap has slope 1
  }
  const float g_roll = g_att[0] + g_e[0];
  const float g_pitch = g_att[1] + g_e[1];
  gcmd[4] += g_att[2] + g_e[2];

  // the tilt: asin of the clipped direction, zero when degenerate
  float g_tvx = 0.0f, g_tvy = 0.0f, g_tvz = 0.0f, g_inv = 0.0f;
  if (!degenerate) {
    if (in_closed(sin_roll, -0.4f, 0.4f)) {
      const float g_arg = g_roll * rs_roll;
      g_tvy += g_arg * inv;
      g_inv += g_arg * tvy;
    }
    if (in_closed(sin_pitch, -0.4f, 0.4f)) {
      const float g_arg = -g_pitch * rs_pitch;
      g_tvx += g_arg * inv;
      g_inv += g_arg * tvx;
    }
  }
  float g_tmag = tmag >= 1e-9f ? -g_inv * inv * inv : 0.0f;
  g_tmag += g_x_g;
  *g_gravity -= g_x_gg;

  // round 4, on every lane
  const float g_sq = g_tmag / (2.0f * tmag);
  g_tvx += 2.0f * tvx * g_sq;
  g_tvy += 2.0f * tvy * g_sq;
  g_tvz += 2.0f * tvz * g_sq;
  gcmd[0] += g_tvx;
  gcmd[1] += g_tvy;
  gcmd[2] += g_tvz;
  *g_gravity += g_tvz;
}

}  // namespace uav
