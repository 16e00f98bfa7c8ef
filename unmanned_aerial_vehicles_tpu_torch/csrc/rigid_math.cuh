// Scalar device math of the 12-state torque-input rigid body, shared by the
// rigid-plant kernel (rigid_plant_kernels.cu: K10), the rigid plant of the
// direct-rate multi-tick kernel (rigid_tick_kernel.cu: K11) and the MPPI
// sampling kernel (mppi_kernels.cu: K12), so the model cannot drift between
// them.
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

}  // namespace uav
