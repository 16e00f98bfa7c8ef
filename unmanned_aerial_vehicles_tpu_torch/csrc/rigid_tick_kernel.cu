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
//   GMinvT_s (N nu, m), Gs (m, N nu), d (N nu), e, ie, ce, ice, lo, hi (m),
//   refs (K, N nx), and the carries x (12), z, y (m).
// The ADMM operator P1 = Gs GMinvT_s (m, m) has rank N nu = m / 4, so the
// kernel never forms it: v P1 = (v Gs) GMinvT_s. Gs = [diag(gd); GsL] (the
// condensed constraints are [I; Su], equilibrated by diagonal scalings), so
// only its diagonal gd and its lower N nx rows GsL are read.
// Per tick, in block-wide phases separated by __syncthreads():
//   shift   the warm start one stage forward per block (U by nu, X by nx,
//           the last stage repeated), z times ce, y times ice (the
//           equilibration's per-lane correction e / blockroll(e));
//   offset  = Sx x + Sc (one thread per row);
//   f       = SuT_q (offset - ref) + f0 (one warp per row, a fixed
//           shuffle tree), fs = f d; the box bounds (lo - [0 | offset]) e
//           and the first ADMM input v = rho z - y;
//   p0      = -fs GMinvT_s (thread j owns column j);
//   ADMM    `iterations` composite steps of two products and two barriers:
//             w  = v Gs = v[:N nu] gd + v[N nu:] GsL   (N nu sums of N nx),
//             GU = p0 + w GMinvT_s, then the z, y update (thread j owns j);
//   plant   thread 0: u0 = z[0:nu] ie, the row (pre-plant state, u0), then
//           `substeps` Euler steps of the direct-rate model or RK4 steps of
//           the torque-input rigid body (rigid_math.cuh, K10's math).
//
// What bounds it on an H100: one SM's shared-memory bandwidth. The two
// factors (GsL transposed, GMinvT_s: 4 N nu (N nx + 4 + m) bytes, 180 KB at
// the direct-rate width N=20, 102 KB at the rigid width N=15) are copied into
// shared memory once per launch and read once per ADMM step, against the
// (m, m) P1, which fits no block at these widths (409.6 KB at N=20) and
// would stream through L2 every step, at the ~65 GB/s one SM draws. The first product gives each warp whole groups of four
// columns: the lanes split a column's N nx terms (float4 loads of GsL' and
// of the lane's slice of v, held in registers across the warp's groups)
// and a transposed shuffle reduction leaves each column's sum on one lane
// (six shuffles per four columns). The second is column-owned, as the
// composite ADMM of K3/K4/K6 runs it. Where the factors and vectors do not
// fit one block (N > 21 on an H100) the wrapper takes the variant that reads
// both factors through L2 (half of P1's bytes), with the first product's
// columns split over the block's threads and added in order behind a third
// barrier. The card's rates bound a launch at under a microsecond; the
// one-thread plant section and the per-tick gradient through L2 come next
// (chip_smoke.py prints each section's share from the build with section
// clocks).
//
// Every sum runs in a fixed order, so two launches agree bit for bit.

#include <cuda_runtime.h>

#include "block_linalg.cuh"
#include "rigid_math.cuh"
#include "smem_copy.cuh"

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
  const float *Sx, *Sc, *SuT_q, *f0, *GMinvT_s, *Gs, *d, *e, *ie, *ce, *ice, *lo, *hi;
  float *out, *x_out, *z_out, *y_out;
};

namespace {

constexpr int kThreads = 640;   // ops/rigid_tick_pallas.py KERNEL_THREADS
constexpr int kNu = 4;
constexpr int kNx = 12;
constexpr int kOut = 16;        // per tick: pre-plant state (12), u0 (4)
constexpr unsigned kFull = 0xffffffffu;

// Per-section clock counters, compiled in only with -DUAV_SECTION_CLOCKS
// (the library rigid_tick_clocks, which chip_smoke.py reads for K11's
// breakdown): thread 0 counts the clock64() cycles between the barriers that
// close each section in registers and adds them to g_section_cycles at the
// end of the launch; rigid_tick_section_cycles reads and resets them.
// Sections (ops/rigid_tick_pallas.py RIGID_SECTIONS): shift and offset;
// gradient and bounds; p0; ADMM; plant; the whole tick; and the ADMM's two
// halves, w = v Gs and GU with the update.
constexpr int kSections = 8;
#ifdef UAV_SECTION_CLOCKS
__device__ unsigned long long g_section_cycles[kSections];
#define SECTION_LAP(i, since)                                           \
  if (tid == 0) {                                                       \
    const long long now_ = clock64();                                   \
    lap_cycles[i] += now_ - (since);                                    \
    since = now_;                                                       \
  }
#else
#define SECTION_LAP(i, since)
#endif

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

// The first ADMM product with GsL' in shared memory: w[c] = v[c] gd[c] +
// sum_i v[N nu + i] GsLT[c ldg + i]. Warp g of the block takes the groups
// of four columns g, g + warps, ...; lane l holds v's rows N nu + 4 l + 128 k
// (k = 0, 1: N nx <= 256) in registers and sums its part of each column of
// the group; the transposed reduction (xor 16 and 8 exchange halves of the
// group, xor 4, 2, 1 finish each sum) leaves column 4 g + (l >> 3) on lanes
// l & 7 == 0.
__device__ __forceinline__ void factor_product_shared(const float* __restrict__ v,
                                                      const float* __restrict__ GsLT,
                                                      const float* __restrict__ gd, int Nnu,
                                                      int Nnx, int ldg, float* __restrict__ w,
                                                      int tid, int nth) {
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;
  const bool in0 = 4 * lane < Nnx, in1 = 4 * lane + 128 < Nnx;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* v4 = reinterpret_cast<const float4*>(v + Nnu);
  const float4 va = in0 ? v4[lane] : zero, vb = in1 ? v4[lane + 32] : zero;
  const bool hi16 = lane & 16, hi8 = lane & 8;
  for (int g = warp; 4 * g < Nnu; g += n_warps) {
    float acc[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4* row = reinterpret_cast<const float4*>(GsLT + (4 * g + cc) * ldg);
      const float4 a = in0 ? row[lane] : zero, b = in1 ? row[lane + 32] : zero;
      acc[cc] = ((va.x * a.x + va.y * a.y) + (va.z * a.z + va.w * a.w)) +
                ((vb.x * b.x + vb.y * b.y) + (vb.z * b.z + vb.w * b.w));
    }
    float k0 = hi16 ? acc[2] : acc[0], k1 = hi16 ? acc[3] : acc[1];
    k0 += __shfl_xor_sync(kFull, hi16 ? acc[0] : acc[2], 16);
    k1 += __shfl_xor_sync(kFull, hi16 ? acc[1] : acc[3], 16);
    float sum = hi8 ? k1 : k0;
    sum += __shfl_xor_sync(kFull, hi8 ? k0 : k1, 8);
    sum += __shfl_xor_sync(kFull, sum, 4);
    sum += __shfl_xor_sync(kFull, sum, 2);
    sum += __shfl_xor_sync(kFull, sum, 1);
    if ((lane & 7) == 0) {
      const int c = 4 * g + (lane >> 3);
      w[c] = v[c] * gd[c] + sum;
    }
  }
}

// The second ADMM product and the update (thread j owns column j):
//   GU = p0 + w GMinvT_s,  Gt = a GU + (1 - a) z,
//   z  = clip(Gt + y / rho, lower, upper),  y += rho (Gt - z),  v = rho z - y,
// with y / rho taken as y times inv_rho = 1 / rho, formed once per launch
// (the plain version divides: within an ulp of it, and an IEEE division,
// with its slow-path check, on every column of every step sits on the
// step's critical path).
template <bool kShared>
__device__ __forceinline__ void factor_update(const float* __restrict__ w,
                                              const float* __restrict__ GMT, int m, int Nnu,
                                              const float* __restrict__ p0,
                                              const float* __restrict__ lower,
                                              const float* __restrict__ upper, float* z, float* y,
                                              float* v, float rho, float inv_rho, float over_relax,
                                              float one_minus_over_relax, int tid, int nth) {
  for (int j = tid; j < m; j += nth) {
    const float GU = p0[j] + uav::col_dot_smem<kShared>(w, GMT, m, j, Nnu);
    const float Gt = over_relax * GU + one_minus_over_relax * z[j];
    const float zn = uav::clipf(Gt + y[j] * inv_rho, lower[j], upper[j]);
    const float yn = y[j] + rho * (Gt - zn);
    z[j] = zn;
    y[j] = yn;
    v[j] = rho * zn - yn;
  }
}

template <bool kSharedFactors>
__global__ void __launch_bounds__(kThreads, 1)
rigid_multitick_kernel(const RigidTickParams P, const RigidTickOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int N = P.n, m = P.m, Nnu = N * kNu, Nnx = N * kNx;
  const int ldg = Nnx + 4;   // GsL' row stride (16-byte aligned, and 8 columns x 4 rows of
                             // the transposing copy land in distinct banks at N=20)
  const float rho = P.rho, inv_rho = 1.0f / P.rho;

  // shared memory layout (ops/rigid_tick_pallas.py shared_memory_bytes);
  // GsLT, GMT, gd / part, v, w and fs start 16-byte aligned (Nnu, Nnx and m
  // are multiples of 4)
  float* GsLT = sm;                                          // (Nnu, ldg)
  float* GMT = GsLT + (kSharedFactors ? Nnu * ldg : 0);      // (Nnu, m)
  float* gd = GMT + (kSharedFactors ? Nnu * m : 0);          // (Nnu,)
  float* part = gd + (kSharedFactors ? Nnu : 0);             // the L2 variant's partial sums
  float* v = part + (kSharedFactors ? 0 : max(kThreads, Nnu));
  float* w = v + m;
  float* fs = w + Nnu;
  float* z = fs + Nnu;
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

  if constexpr (kSharedFactors) {
    // GsL transposed, eight columns by four rows per warp (coalesced 32-byte
    // reads of Gs, conflict-free stores), eight loads in flight per thread
    const int n_cols8 = (Nnu + 7) / 8, total = 8 * n_cols8 * Nnx;
    for (int base = tid; base < total; base += 8 * nth) {
      float val[8];
      int dst[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * nth;
        const int i = (idx >> 3) % Nnx, c = 8 * ((idx >> 3) / Nnx) + (idx & 7);
        const bool ok = idx < total && c < Nnu;
        dst[u] = ok ? c * ldg + i : -1;
        val[u] = ok ? __ldg(O.Gs + (Nnu + i) * Nnu + c) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (dst[u] >= 0) GsLT[dst[u]] = val[u];
    }
    uav::copy_to_shared<8>(reinterpret_cast<float4*>(GMT),
                           reinterpret_cast<const float4*>(O.GMinvT_s), Nnu * m / 4, tid, nth);
    for (int c = tid; c < Nnu; c += nth) gd[c] = __ldg(O.Gs + c * Nnu + c);
  }
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
  const float* GM = kSharedFactors ? GMT : O.GMinvT_s;
#ifdef UAV_SECTION_CLOCKS
  long long since = clock64(), tick_start = since, since_admm = since;
  long long lap_cycles[kSections] = {};
#endif

  for (int t = 0; t < P.k_ticks; ++t) {
    // ---- warm-start shift in equilibrated space (a gather; v and p0 as
    // scratch) ---------------------------------------------------------------
    for (int i = tid; i < m; i += nth) {
      int src = i;
      if (i < Nnu - kNu) src = i + kNu;
      else if (i >= Nnu && i < Nnu + Nnx - kNx) src = i + kNx;
      v[i] = z[src] * ce[i];
      p0[i] = y[src] * ice[i];
    }
    for (int i = tid; i < Nnx; i += nth) ref[i] = O.refs[t * Nnx + i];
    __syncthreads();
    for (int i = tid; i < m; i += nth) {
      z[i] = v[i];
      y[i] = p0[i];
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
    SECTION_LAP(0, since);
    // ---- fs = (SuT_q (offset - ref) + f0) d; bounds; ADMM input -----------
    uav::row_dots_warp(O.SuT_q, Nnx, dref, Nnx, Nnu, tid, nth, [&](int c, float acc) {
      fs[c] = (acc + __ldg(O.f0 + c)) * __ldg(O.d + c);
    });
    for (int i = tid; i < m; i += nth) {
      const float off_z = (i >= Nnu && i < Nnu + Nnx) ? offset[i - Nnu] : 0.0f;
      lower[i] = (lo[i] - off_z) * e[i];
      upper[i] = (hi[i] - off_z) * e[i];
      v[i] = rho * z[i] - y[i];
    }
    __syncthreads();
    SECTION_LAP(1, since);
    // ---- p0 = -fs GMinvT_s ---------------------------------------------------
    for (int j = tid; j < m; j += nth)
      p0[j] = -uav::col_dot_smem<kSharedFactors>(fs, GM, m, j, Nnu);
    __syncthreads();
    SECTION_LAP(2, since);
    // ---- composite ADMM on the factors --------------------------------------
#ifdef UAV_SECTION_CLOCKS
    since_admm = since;
#endif
    for (int it = 0; it < P.iterations; ++it) {
      if constexpr (kSharedFactors) {
        factor_product_shared(v, GsLT, gd, Nnu, Nnx, ldg, w, tid, nth);
      } else {
        uav::matvec_partial(v + Nnu, O.Gs + Nnu * Nnu, Nnu, Nnx, Nnu, part, tid, nth);
        __syncthreads();
        for (int c = tid; c < Nnu; c += nth)
          w[c] = v[c] * __ldg(O.Gs + c * Nnu + c) + uav::matvec_total(part, Nnu, nth, c);
      }
      __syncthreads();
      SECTION_LAP(6, since_admm);
      factor_update<kSharedFactors>(w, GM, m, Nnu, p0, lower, upper, z, y, v, rho, inv_rho,
                                    P.over_relax, P.one_minus_over_relax, tid, nth);
      __syncthreads();
      SECTION_LAP(7, since_admm);
    }
    SECTION_LAP(3, since);
    // ---- u0, the output row, the plant (one thread) -------------------------
    if (tid == 0) plant_section(P, O, t, z, st);
    __syncthreads();
    SECTION_LAP(4, since);
    SECTION_LAP(5, tick_start);
  }

  for (int i = tid; i < m; i += nth) {
    O.z_out[i] = z[i];
    O.y_out[i] = y[i];
  }
  if (tid < 12) O.x_out[tid] = st[tid];
#ifdef UAV_SECTION_CLOCKS
  if (tid == 0)
    for (int i = 0; i < kSections; ++i) g_section_cycles[i] += (unsigned long long)lap_cycles[i];
#endif
}

template <bool kSharedFactors>
int launch(const RigidTickParams* params, const RigidTickOperands* ops, int smem_bytes,
           void* stream) {
  // raise the block's shared-memory limit once per size (host-side call,
  // kept out of the per-launch path and out of CUDA graph captures)
  static int configured_bytes = -1;
  if (smem_bytes > configured_bytes) {
    cudaError_t err = cudaFuncSetAttribute(rigid_multitick_kernel<kSharedFactors>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    configured_bytes = smem_bytes;
  }
  rigid_multitick_kernel<kSharedFactors><<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      *params, *ops);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rigid_multitick_launch(const RigidTickParams* params, const RigidTickOperands* ops,
                                      int factors_shared, int smem_bytes, void* stream) {
  return factors_shared ? launch<true>(params, ops, smem_bytes, stream)
                        : launch<false>(params, ops, smem_bytes, stream);
}

// The section counters summed since the last call (kSections values, in
// cycles) into out, then reset; returns cudaErrorNotSupported unless built
// with -DUAV_SECTION_CLOCKS. Synchronous: call after the launches finish.
extern "C" int rigid_tick_section_cycles(unsigned long long* out) {
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
