// K11: K whole ticks of the 12-state SQP family's multi-tick tier in one
// launch.
//
// Replaces the JAX package's ops/rigid_tick_pallas.py:
// direct_rate_multitick_kernel (pallas_call at :255). Its plain version is
// the port's ops/rigid_tick_pallas.py:direct_rate_multitick_plain.
//
// The operands are the dispatch's relinearisation (loop/rigid_loop.py), all
// in the dispatch's equilibrated space, semantic shapes (m = N (nu + nx)):
//   Sx (N nx, 12), Sc (N nx), SuT_q (N nu, N nx), f0 (N nu),
//   GMinvT_s (N nu, m), P1 (m, m), d (N nu), e, ie, ce, ice, lo, hi (m),
//   refs (K, N nx), and the carries x (12), z, y (m).
// Per tick, in block-wide phases separated by __syncthreads():
//   shift   the warm start one stage forward per block (U by nu, X by nx,
//           the last stage repeated), z times ce, y times ice (the
//           equilibration's per-lane correction e / blockroll(e));
//   offset  = Sx x + Sc (one thread per row);
//   f       = SuT_q (offset - ref) + f0 (one warp per row, a fixed
//           shuffle tree), fs = f d; the box bounds (lo - [0 | offset]) e
//           and the first ADMM input rho z - y;
//   p0      = -fs GMinvT_s (thread j owns column j);
//   ADMM    `iterations` composite steps, one (m, m) matvec with P1 each
//           (block_linalg.cuh composite_admm, the K3/K4/K6 loop);
//   plant   thread 0: u0 = z[0:nu] ie, the row (pre-plant state, u0), then
//           `substeps` Euler steps of the direct-rate model or RK4 steps of
//           the torque-input rigid body (rigid_math.cuh, K10's math).
//
// What bounds it on an H100: latency, on one SM. At the direct-rate width
// (N=20, m=320) P1 alone is 409,600 bytes and at the rigid width (N=15,
// m=240) 230,400, so neither fits a block's 232,448 bytes of shared memory
// beside the vectors: the wrapper then takes the variant that reads P1
// through L1/L2 (16 loads in flight per thread), as K3/K4/K6 do at N=25;
// small horizons get the variant with P1 in shared memory. Each ADMM step is
// then one L2 pass over P1 behind one barrier; SuT_q and GMinvT_s are read
// through L2 too. The card's rates bound a launch at under a microsecond
// (~6 M FP32 operations per direct-rate tick); a 2-CTA cluster holding half
// of P1 each in distributed shared memory, or the low-rank product
// v P1 = (v Gs) GMinvT_s, are the next steps (ROADMAP.md).
//
// Every sum runs in a fixed order, so two launches agree bit for bit.

#include <cuda_runtime.h>

#include "block_linalg.cuh"
#include "rigid_math.cuh"

// Host-visible: laid out as ops/rigid_tick_pallas.py's _RigidTickParams /
// _RigidTickOperands.
struct RigidTickParams {
  int k_ticks, n, m, iterations, substeps, rigid_plant;
  float rho, over_relax, one_minus_over_relax;
  uav::RK4Step step;           // the plant substep: h (Euler), h, h/2, h/6 (RK4)
  float gravity, tau0, tau1, tau2;
  uav::RigidBody body;
};

struct RigidTickOperands {
  const float *x_in, *z_in, *y_in, *refs;
  const float *Sx, *Sc, *SuT_q, *f0, *GMinvT_s, *P1, *d, *e, *ie, *ce, *ice, *lo, *hi;
  float *out, *x_out, *z_out, *y_out;
};

namespace {

constexpr int kThreads = 384;
constexpr int kNu = 4;
constexpr int kNx = 12;
constexpr int kOut = 16;        // per tick: pre-plant state (12), u0 (4)

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// One forward-Euler substep of the direct-rate model with zero residual
// (control/mpc_rigid.py direct_rate_step in the JAX kernel's form: tan as
// sin / cos), in place.
__device__ __forceinline__ void direct_rate_substep(float s[12], const float u[4],
                                                    const RigidTickParams& P) {
  const float g = P.gravity, h = P.step.h;
  const float a = u[3] * g;
  const float sr = sinf(s[6]), cr = cosf(s[6]);
  const float sp = sinf(s[7]), cp = cosf(s[7]);
  const float sy = sinf(s[8]), cy = cosf(s[8]);
  const float tp = sp / cp;
  float d[12];
  d[0] = s[3];
  d[1] = s[4];
  d[2] = s[5];
  d[3] = a * (sr * sy + cr * cy * sp);
  d[4] = a * (-sr * cy + cr * sy * sp);
  d[5] = a * cr * cp - g;
  d[6] = s[9] + s[10] * sr * tp + s[11] * cr * tp;
  d[7] = s[10] * cr - s[11] * sr;
  d[8] = s[10] * sr / cp + s[11] * cr / cp;
  d[9] = (u[0] - s[9]) / P.tau0;
  d[10] = (u[1] - s[10]) / P.tau1;
  d[11] = (u[2] - s[11]) / P.tau2;
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = s[i] + h * d[i];
}

// Thread 0's section of tick t: u0, the output row, the plant substeps on
// st. Not inlined, so its registers stay out of the block loops'.
__device__ __noinline__ void plant_section(const RigidTickParams& P, const RigidTickOperands& O,
                                           int t, const float* z, float* st) {
  float u[kNu], s[12];
#pragma unroll
  for (int j = 0; j < kNu; ++j) u[j] = z[j] * O.ie[j];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = st[i];
  float* row = O.out + t * kOut;
#pragma unroll
  for (int i = 0; i < 12; ++i) row[i] = s[i];
#pragma unroll
  for (int j = 0; j < kNu; ++j) row[12 + j] = u[j];
  for (int k = 0; k < P.substeps; ++k) {
    if (P.rigid_plant) {
      uav::rigid_rk4(s, u, P.body, nullptr, P.step);
    } else {
      direct_rate_substep(s, u, P);
    }
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) st[i] = s[i];
}

template <bool kSharedP1>
__global__ void __launch_bounds__(kThreads, 1)
rigid_multitick_kernel(const RigidTickParams P, const RigidTickOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int N = P.n, m = P.m, Nnu = N * kNu, Nnx = N * kNx;
  const int m4 = round4(m);
  const float rho = P.rho;

  // shared memory layout (ops/rigid_tick_pallas.py shared_memory_bytes); P1,
  // va, vb and fs start 16-byte aligned
  float* P1s = sm;
  float* va = P1s + (kSharedP1 ? round4(m * m) : 0);   // ADMM matvec input,
  float* vb = va + m4;                                 // double-buffered
  float* fs = vb + m4;
  float* z = fs + round4(Nnu);
  float* y = z + m;
  float* p0 = y + m;
  float* lower = p0 + m;
  float* upper = lower + m;
  float* lo = upper + m;
  float* hi = lo + m;
  float* e = hi + m;
  float* ce = e + m;
  float* ice = ce + m;
  float* offset = ice + m;
  float* dref = offset + Nnx;
  float* ref = dref + Nnx;
  float* st = ref + Nnx;

  if constexpr (kSharedP1) uav::copy_floats_to_shared(P1s, O.P1, m * m, tid, nth);
  for (int i = tid; i < m; i += nth) {
    z[i] = O.z_in[i];
    y[i] = O.y_in[i];
    lo[i] = O.lo[i];
    hi[i] = O.hi[i];
    e[i] = O.e[i];
    ce[i] = O.ce[i];
    ice[i] = O.ice[i];
  }
  if (tid < 12) st[tid] = O.x_in[tid];
  __syncthreads();

  for (int t = 0; t < P.k_ticks; ++t) {
    // ---- warm-start shift in equilibrated space (a gather) ---------------
    for (int i = tid; i < m; i += nth) {
      int src = i;
      if (i < Nnu - kNu) src = i + kNu;
      else if (i >= Nnu && i < Nnu + Nnx - kNx) src = i + kNx;
      va[i] = z[src] * ce[i];
      vb[i] = y[src] * ice[i];
    }
    for (int i = tid; i < Nnx; i += nth) ref[i] = O.refs[t * Nnx + i];
    __syncthreads();
    for (int i = tid; i < m; i += nth) {
      z[i] = va[i];
      y[i] = vb[i];
    }
    // ---- offset = Sx x + Sc ------------------------------------------------
    for (int r = tid; r < Nnx; r += nth) {
      const float* row = O.Sx + r * kNx;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kNx; ++i) acc += __ldg(row + i) * st[i];
      const float off = acc + __ldg(O.Sc + r);
      offset[r] = off;
      dref[r] = off - ref[r];
    }
    __syncthreads();
    // ---- fs = (SuT_q (offset - ref) + f0) d; bounds; ADMM input -----------
    uav::row_dots_warp(O.SuT_q, Nnx, dref, Nnx, Nnu, tid, nth, [&](int c, float acc) {
      fs[c] = (acc + __ldg(O.f0 + c)) * __ldg(O.d + c);
    });
    for (int i = tid; i < m; i += nth) {
      const float off_z = (i >= Nnu && i < Nnu + Nnx) ? offset[i - Nnu] : 0.0f;
      lower[i] = (lo[i] - off_z) * e[i];
      upper[i] = (hi[i] - off_z) * e[i];
      va[i] = rho * z[i] - y[i];
    }
    __syncthreads();
    // ---- p0 = -fs GMinvT_s ---------------------------------------------------
    for (int j = tid; j < m; j += nth) p0[j] = -uav::col_dot_smem<false>(fs, O.GMinvT_s, m, j, Nnu);
    __syncthreads();
    // ---- composite ADMM ------------------------------------------------------
    uav::composite_admm<kSharedP1>(kSharedP1 ? P1s : O.P1, m, p0, lower, upper, z, y, va, vb,
                                   rho, P.over_relax, P.one_minus_over_relax, P.iterations, tid,
                                   nth);
    // ---- u0, the output row, the plant (one thread) -------------------------
    if (tid == 0) plant_section(P, O, t, z, st);
    __syncthreads();
  }

  for (int i = tid; i < m; i += nth) {
    O.z_out[i] = z[i];
    O.y_out[i] = y[i];
  }
  if (tid < 12) O.x_out[tid] = st[tid];
}

template <bool kSharedP1>
int launch(const RigidTickParams* params, const RigidTickOperands* ops, int smem_bytes,
           void* stream) {
  // raise the block's shared-memory limit once per size (host-side call,
  // kept out of the per-launch path and out of CUDA graph captures)
  static int configured_bytes = -1;
  if (smem_bytes > configured_bytes) {
    cudaError_t err = cudaFuncSetAttribute(rigid_multitick_kernel<kSharedP1>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    configured_bytes = smem_bytes;
  }
  rigid_multitick_kernel<kSharedP1><<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(*params,
                                                                                       *ops);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rigid_multitick_launch(const RigidTickParams* params, const RigidTickOperands* ops,
                                      int p1_shared, int smem_bytes, void* stream) {
  return p1_shared ? launch<true>(params, ops, smem_bytes, stream)
                   : launch<false>(params, ops, smem_bytes, stream);
}
