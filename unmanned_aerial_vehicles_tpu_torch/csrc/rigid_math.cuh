// Scalar device math of the 12-state torque-input rigid body, shared by the
// rigid-plant kernel (rigid_plant_kernels.cu: K10), the rigid plant of the
// direct-rate multi-tick kernel (rigid_tick_kernel.cu: K11) and the MPPI
// sampling kernel (mppi_kernels.cu: K12), so the model cannot drift between
// them. The MPPI kernel and K10 run the warp-cooperative forms at the end
// of the file (rigid_derivative_warp, rigid_rk4_warp); K11 keeps one
// thread per state.
//
// A transcription of the JAX package's ops/rigid_plant_pallas.py:
// make_plant_math, which the port's plain versions mirror
// (ops/rigid_plant_pallas.py:make_plant_math): ZYX thrust column, airspeed
// quadratic drag with the gradient-safe norm, the Euler-rate transform with
// the |cos(theta)| >= 1e-6 guard, gyroscopic omega x (I omega) and angular
// drag. The physics constants are kernel arguments (RigidBody), not
// compile-time constants. float32, no fast math; the compiler contracts
// a*b+c into FMAs, so results agree with the plain versions to float32
// rounding, not bit for bit.
#pragma once

#include <math.h>

namespace uav {

// Host-visible layout (ops/rigid_plant_pallas.py _RigidBody).
struct RigidBody {
  float mass, gravity, k_lin, k_ang, ix, iy, iz, wx, wy, wz;
};

// RK4 step lengths, rounded to float32 from the host's double arithmetic
// exactly as the JAX kernel's Python constants are: h, h / 2, h / 6.
struct RK4Step {
  float h, half_h, h6;
};

// d(state)/dt; `res` (12 derivative residuals) may be null.
__device__ __forceinline__ void rigid_derivative(const float s[12], const float u[4],
                                                 const RigidBody& b, const float* res,
                                                 float d[12]) {
  const float vx = s[3], vy = s[4], vz = s[5];
  const float phi = s[6], th = s[7], psi = s[8];
  const float p = s[9], q = s[10], r = s[11];
  const float T = u[0];
  const float sphi = sinf(phi), cphi = cosf(phi);
  const float sth = sinf(th), cth = cosf(th);
  const float spsi = sinf(psi), cpsi = cosf(psi);
  // R[:, 2] of Rz Ry Rx
  const float r02 = cphi * sth * cpsi + sphi * spsi;
  const float r12 = cphi * sth * spsi - sphi * cpsi;
  const float r22 = cphi * cth;
  const float ax = vx - b.wx, ay = vy - b.wy, az = vz - b.wz;
  const float sq = ax * ax + ay * ay + az * az;
  const float speed = sq > 0.0f ? sqrtf(sq) : 0.0f;
  const float cth_safe = fabsf(cth) < 1e-6f ? (cth < 0.0f ? -1e-6f : 1e-6f) : cth;
  const float tth = tanf(th);
  const float gyx = q * (b.iz * r) - r * (b.iy * q);
  const float gyy = r * (b.ix * p) - p * (b.iz * r);
  const float gyz = p * (b.iy * q) - q * (b.ix * p);
  d[0] = vx;
  d[1] = vy;
  d[2] = vz;
  d[3] = (T * r02 - b.k_lin * speed * ax) / b.mass;
  d[4] = (T * r12 - b.k_lin * speed * ay) / b.mass;
  d[5] = (T * r22 - b.k_lin * speed * az) / b.mass - b.gravity;
  d[6] = p + q * sphi * tth + r * cphi * tth;
  d[7] = q * cphi - r * sphi;
  d[8] = (q * sphi + r * cphi) / cth_safe;
  d[9] = (u[1] - gyx - b.k_ang * p) / b.ix;
  d[10] = (u[2] - gyy - b.k_ang * q) / b.iy;
  d[11] = (u[3] - gyz - b.k_ang * r) / b.iz;
  if (res != nullptr) {
#pragma unroll
    for (int i = 0; i < 12; ++i) d[i] += res[i];
  }
}

// One classic RK4 step of length st.h, in place on s.
__device__ __forceinline__ void rigid_rk4(float s[12], const float u[4], const RigidBody& b,
                                          const float* res, const RK4Step& st) {
  float k1[12], k2[12], k3[12], k4[12], x[12];
  rigid_derivative(s, u, b, res, k1);
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = s[i] + st.half_h * k1[i];
  rigid_derivative(x, u, b, res, k2);
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = s[i] + st.half_h * k2[i];
  rigid_derivative(x, u, b, res, k3);
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = s[i] + st.h * k3[i];
  rigid_derivative(x, u, b, res, k4);
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = s[i] + st.h6 * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
}

// The warp-cooperative forms below spread the slow, serial pieces of
// rigid_derivative() (the accurate sines and cosines and the seven IEEE
// divisions, each behind a slow-path branch) over the lanes of a group of
// kWidth lanes (at least 8, aligned, every lane active) and share the
// results by shuffles, as plant_math.cuh:derivative_warp does for the PX4
// surrogate: a derivative waits for one sincosf (beside the tangent and
// the square root, which every lane forms from the same operand) and one
// division, where rigid_derivative() waits for three, one, one and seven
// in a row. Every lane of a group carries the whole state and gets the
// whole result. The lane table (ops/mppi_pallas.py RIGID_SINCOS_LANES,
// RIGID_QUOTIENT_LANES): lane i < 3 forms the sine and cosine of Euler
// angle i (phi, theta, psi); lane i < 7 forms quotient i: the three
// accelerations over the mass, psi_dot over cth_safe, the three angular
// accelerations over ix, iy, iz (lane 7 repeats lane 6's). The same
// numerators and denominators as rigid_derivative(), no reciprocal, and
// the same roundings: its outputs equal rigid_derivative()'s bit for bit.
template <int kWidth = 32>
__device__ __forceinline__ void rigid_derivative_warp(const float s[12], const float u[4],
                                                      const RigidBody& b, const float* res,
                                                      int lane, float d[12]) {
  auto from = [](float v, int src) { return __shfl_sync(0xffffffffu, v, src, kWidth); };
  const float vx = s[3], vy = s[4], vz = s[5];
  const float th = s[7];
  const float p = s[9], q = s[10], r = s[11];
  const float T = u[0];
  float sn, cs;
  sincosf(s[6 + lane % 3], &sn, &cs);
  const float tth = tanf(th);
  const float ax = vx - b.wx, ay = vy - b.wy, az = vz - b.wz;
  const float sq = ax * ax + ay * ay + az * az;
  const float speed = sq > 0.0f ? sqrtf(sq) : 0.0f;
  const float sphi = from(sn, 0), cphi = from(cs, 0);
  const float sth = from(sn, 1), cth = from(cs, 1);
  const float spsi = from(sn, 2), cpsi = from(cs, 2);
  // R[:, 2] of Rz Ry Rx
  const float r02 = cphi * sth * cpsi + sphi * spsi;
  const float r12 = cphi * sth * spsi - sphi * cpsi;
  const float r22 = cphi * cth;
  const float cth_safe = fabsf(cth) < 1e-6f ? (cth < 0.0f ? -1e-6f : 1e-6f) : cth;
  const float gyx = q * (b.iz * r) - r * (b.iy * q);
  const float gyy = r * (b.ix * p) - p * (b.iz * r);
  const float gyz = p * (b.iy * q) - q * (b.ix * p);
  // one quotient per lane. psi_dot's numerator rounds both products before
  // the add, as rigid_derivative's compiled code does (the products also
  // feed d[6], and the compiler fuses neither there); left to the compiler
  // here it becomes an FMA, one rounding off in a fifth of states, which
  // MPPI's softmax carries into another flight (PERF.md)
  const int k = lane & 7;
  const float num = k == 0 ? T * r02 - b.k_lin * speed * ax
                  : k == 1 ? T * r12 - b.k_lin * speed * ay
                  : k == 2 ? T * r22 - b.k_lin * speed * az
                  : k == 3 ? __fadd_rn(__fmul_rn(q, sphi), __fmul_rn(r, cphi))
                  : k == 4 ? u[1] - gyx - b.k_ang * p
                  : k == 5 ? u[2] - gyy - b.k_ang * q : u[3] - gyz - b.k_ang * r;
  const float den = k < 3 ? b.mass : k == 3 ? cth_safe : k == 4 ? b.ix : k == 5 ? b.iy : b.iz;
  const float quo = num / den;
  d[0] = vx;
  d[1] = vy;
  d[2] = vz;
  d[3] = from(quo, 0);
  d[4] = from(quo, 1);
  d[5] = from(quo, 2) - b.gravity;
  d[6] = p + q * sphi * tth + r * cphi * tth;
  d[7] = q * cphi - r * sphi;
  d[8] = from(quo, 3);
  d[9] = from(quo, 4);
  d[10] = from(quo, 5);
  d[11] = from(quo, 6);
  if (res != nullptr) {
#pragma unroll
    for (int i = 0; i < 12; ++i) d[i] += res[i];
  }
}

// rigid_rk4() on each group of kWidth lanes (rigid_derivative_warp): the
// same stages and the same sums, k1 + 2 k2 + 2 k3 + k4 accumulated left to
// right as rigid_rk4's expression rounds them.
template <int kWidth = 32>
__device__ __forceinline__ void rigid_rk4_warp(float s[12], const float u[4], const RigidBody& b,
                                               const float* res, const RK4Step& st, int lane) {
  float k[12], acc[12], x[12];
  rigid_derivative_warp<kWidth>(s, u, b, res, lane, acc);
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = s[i] + st.half_h * acc[i];
  rigid_derivative_warp<kWidth>(x, u, b, res, lane, k);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    x[i] = s[i] + st.half_h * k[i];
    acc[i] = acc[i] + 2.0f * k[i];
  }
  rigid_derivative_warp<kWidth>(x, u, b, res, lane, k);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    x[i] = s[i] + st.h * k[i];
    acc[i] = acc[i] + 2.0f * k[i];
  }
  rigid_derivative_warp<kWidth>(x, u, b, res, lane, k);
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = s[i] + st.h6 * (acc[i] + k[i]);
}

}  // namespace uav
