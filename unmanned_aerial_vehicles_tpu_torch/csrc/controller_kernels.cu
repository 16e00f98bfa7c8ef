// K8 (the structured batched controller) and K16 (the fused controller for a
// batch of flights): one MPC tick for B flights per launch.
//
// K16 fused_batched_kernel replaces the JAX package's
// ops/controller_pallas.py:gpmpc_controller_fused_batched (pallas_call at
// :283, body _make_batched_kernel at :195): K3's controller tick
// (single_tick_kernels.cu) for every flight of a batch, with the warm-start
// shift inside, z0 = Z0 ShiftT and y0 = Y0 ShiftT (dense products, so any
// shift matrix works). Its plain version is the port's
// ops/controller_pallas.py:gpmpc_controller_fused_batched_plain.
//
// Design: a block owns a tile of two flights (the tail tile is masked: any
// batch) and keeps every vector of the tile in shared memory: z, y, the
// double-buffered ADMM input rho z - y, p0, the bounds, [x0 | w], the
// offset, f, M^-1 f and U. Each ADMM iteration is then a (2 x m)(m x m)
// product: thread j owns column j of P1 for both flights, reads each P1
// element once and uses it twice, and reads the flights' inputs as 16-byte
// broadcasts. P1 lies in shared memory (kSharedP1: 160,000 bytes at N=20)
// or is read through L1/L2 with 32 loads in flight per thread (the package
// default N=25 has 250,000 bytes, more than one block holds); the wrapper
// picks the variant. The shift and the set-up products read ShiftT,
// SxSwT, SuTqT, PM, P0matT and SuT once per launch from global memory.
// Every sum runs in a fixed order, so two launches agree bit for bit.
//
// What bounds K16 on an H100: operations. Per flight-tick 2 m^2 (shift) +
// iterations m^2 (ADMM) multiply-adds plus the set-up, ~5.2 M at N=25 with
// 80 iterations; ~2.7 GFLOP for the 256-flight population, ~40 us at
// 67 TFLOP/s. At B=256 the 128 blocks hold 128 of the 132 SMs, one each;
// per iteration a thread issues two shared loads per two multiply-adds
// and waits on its P1 column, and the blocks re-read P1 from L2 (32 MB per
// iteration at N=25): load traffic, not the FMA rate, sets the pace.
//
// K8 structured_batched_kernel replaces the JAX package's
// ops/controller_pallas.py:gpmpc_controller_structured_batched
// (_structured_batched_impl, pallas_call at :541). Its plain version is the
// port's ops/controller_pallas.py:gpmpc_controller_structured_batched_plain.
//
// Per flight: warm-start shift of the split slack/dual planes, prediction
// offset = x0 Sx' + w Sw', gradient f = (offset - ref) (Su'Q)', box bounds,
// `iterations` ADMM steps of
//     t = v_U + v_X SuRow,  U = (t - f) MinvT,  G_X = U SuT,
//     over-relaxation, box projections, dual updates,
// then the primal refresh U = (v_U + v_X SuRow - f) MinvT and
// X_tail = offset + U SuT.
//
// Design: a block owns a tile of kFlights flights (the tail tile is masked,
// so any batch works and nothing is padded). SuRow, MinvT and SuT (100 KB
// at N=20) are copied into shared memory once per launch and serve every
// iteration of every flight of the tile; the tile's iterates (slack, dual,
// matvec inputs, bounds, offset) live in shared memory too. SxT, SwT and
// SuTqT are used once per launch and are read from global memory (L2).
// The operators are copied in with 16-byte loads, eight in flight per
// thread, and every matrix-vector product keeps 16 matrix loads in flight.
// A thread owns one output column for kGroup flights: it reads each matrix
// element once and uses it for kGroup flights, and reads the flights'
// vectors as 16-byte broadcasts. Every sum runs in a fixed order (no
// atomics), so two launches agree bit for bit. Each ADMM iteration is three
// block-wide phases: t (U columns), U with the U-space projection (U
// columns), G_X with the X-space projection (X columns).
//
// What bounds it on an H100: operations. At N=20 a flight-tick is about
// 0.13 M multiply-adds (setup 24,720, each iteration 25,600, the refresh
// 25,600) plus ~12 elementwise operations per constraint lane and iteration;
// at B=1024 with 10 iterations that is ~0.6 GFLOP, ~9 us at the card's
// 67 TFLOP/s FP32 rate. This design is held by shared-memory traffic
// instead: per 4 multiply-adds a thread issues two shared loads (one matrix
// element, one 16-byte vector), where the SM's FMA rate would balance about
// one load per 16; with eight warps per SM it measures ~73 us at B=1024
// (PERF.md). Register blocking over more flights per thread, or tensor
// cores (3xTF32 wgmma with the flight tile as M), are the later steps.

#include <cuda_runtime.h>

#include "smem_copy.cuh"

// Host-visible (external linkage): laid out as ops/controller_pallas.py's
// _StructuredParams / _StructuredOperands.
struct StructuredParams {
  int batch, n, nu, nx, iterations;
  int w_stride, ref_stride;   // 0: one row broadcast to every flight
  float rho, over_relax, one_minus_over_relax;
};

struct StructuredOperands {
  const float *X0, *W, *REF, *ZU, *ZX, *YU, *YX;
  const float *SxT, *SwT, *SuTqT, *SuT, *SuRow, *MinvT, *u_lo, *u_hi, *x_lo, *x_hi;
  float *zu_out, *zx_out, *yu_out, *yx_out, *u_out, *xtail_out;
};

// K16 (ops/controller_pallas.py _FusedBatchedParams / _FusedBatchedOperands)
struct FusedBatchedParams {
  int batch, n, m, iterations;
  int w_stride, ref_stride;   // 0: one row shared by every flight
  float rho, over_relax, one_minus_over_relax;
};

struct FusedBatchedOperands {
  const float *ShiftT, *SxSwT, *SuTqT, *PM, *P1, *P0matT, *SuT, *lo_row, *hi_row;
  const float *X0, *W, *REF, *Z0, *Y0;
  float *z_out, *y_out, *u_out, *xtail_out;
};

namespace {

constexpr int kThreads = 256;
constexpr int kFlights = 8;     // ops/controller_pallas.py FLIGHTS_PER_BLOCK
constexpr int kGroup = 4;       // flights per thread item
constexpr int kGroups = kFlights / kGroup;

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// acc[g] += sum_i v[g * ldv + i] * A[i * lda + j] for i0 <= i < i0 + kStep
// and the kG flights g of one item: kStep matrix loads are issued before
// their multiply-adds. v: 16-byte-aligned shared rows (ldv and i0 multiples
// of 4); A in shared memory (kGlobal false) or global memory (read through
// the read-only cache).
template <int kG, bool kGlobal, int kStep>
__device__ __forceinline__ void tile_dot_step(const float* __restrict__ v, int ldv,
                                              const float* __restrict__ A, int lda, int j,
                                              int i0, float acc[kG]) {
  float a[kStep];
#pragma unroll
  for (int u = 0; u < kStep; ++u) {
    if constexpr (kGlobal) a[u] = __ldg(A + (i0 + u) * lda + j);
    else a[u] = A[(i0 + u) * lda + j];
  }
#pragma unroll
  for (int q = 0; q < kStep / 4; ++q) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float4 w = *reinterpret_cast<const float4*>(v + g * ldv + i0 + 4 * q);
      acc[g] = fmaf(w.x, a[4 * q], acc[g]);
      acc[g] = fmaf(w.y, a[4 * q + 1], acc[g]);
      acc[g] = fmaf(w.z, a[4 * q + 2], acc[g]);
      acc[g] = fmaf(w.w, a[4 * q + 3], acc[g]);
    }
  }
}

// acc[g] = sum_i v[g * ldv + i] * A[i * lda + j] for i < n and kG flights,
// each summed in order of i whatever kStep is, with kStep matrix loads in
// flight per thread (a block holds only eight warps, so each thread must
// hide its own load latency: 16 suit shared memory, more hide L2's).
template <int kG, bool kGlobal, int kStep>
__device__ __forceinline__ void tile_dot(const float* __restrict__ v, int ldv,
                                         const float* __restrict__ A, int lda, int j, int n,
                                         float acc[kG]) {
#pragma unroll
  for (int g = 0; g < kG; ++g) acc[g] = 0.0f;
  int i = 0;
  for (; i + kStep <= n; i += kStep) tile_dot_step<kG, kGlobal, kStep>(v, ldv, A, lda, j, i, acc);
  for (; i + 4 <= n; i += 4) tile_dot_step<kG, kGlobal, 4>(v, ldv, A, lda, j, i, acc);
  auto load = [&](int idx) {
    if constexpr (kGlobal) return __ldg(A + idx);
    else return A[idx];
  };
  for (; i < n; ++i) {
    const float a = load(i * lda + j);
#pragma unroll
    for (int g = 0; g < kG; ++g) acc[g] = fmaf(v[g * ldv + i], a, acc[g]);
  }
}

// K8's products: kGroup flights per item, 16 loads in flight.
template <bool kGlobal>
__device__ __forceinline__ void group_dot(const float* __restrict__ v, int ldv,
                                          const float* __restrict__ A, int lda, int j, int n,
                                          float acc[kGroup]) {
  tile_dot<kGroup, kGlobal, 16>(v, ldv, A, lda, j, n, acc);
}

__global__ void __launch_bounds__(kThreads, 1)
structured_batched_kernel(const StructuredParams P, const StructuredOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int N = P.n, nu = P.nu, nx = P.nx, Nnu = N * nu, Nnx = N * nx;
  const int ldu = round4(Nnu), ldx = round4(Nnx), ld0 = round4(nx);
  const int b0 = blockIdx.x * kFlights;
  const float rho = P.rho, a = P.over_relax, am = P.one_minus_over_relax;

  // shared memory layout (ops/controller_pallas.py
  // structured_shared_memory_bytes); every block starts 16-byte aligned
  float* SuRow = sm;                    // (Nnx, Nnu)
  float* MinvT = SuRow + Nnx * Nnu;     // (Nnu, Nnu)
  float* SuT = MinvT + Nnu * Nnu;       // (Nnu, Nnx)
  float* loU = SuT + Nnu * Nnx;
  float* hiU = loU + ldu;
  float* zU = hiU + ldu;                // U-space rows, kFlights x ldu each
  float* yU = zU + kFlights * ldu;
  float* vU = yU + kFlights * ldu;      // rho zU - yU
  float* tf = vU + kFlights * ldu;      // G'v - f
  float* Ub = tf + kFlights * ldu;      // U
  float* fv = Ub + kFlights * ldu;      // f
  float* zX = fv + kFlights * ldu;      // X-space rows, kFlights x ldx each
  float* yX = zX + kFlights * ldx;
  float* vX = yX + kFlights * ldx;      // w at setup, then rho zX - yX
  float* loX = vX + kFlights * ldx;
  float* hiX = loX + kFlights * ldx;
  float* off = hiX + kFlights * ldx;
  float* dref = off + kFlights * ldx;   // offset - ref
  float* x0s = dref + kFlights * ldx;   // kFlights x ld0

  // ---- load: operators, bounds, the tile's shifted planes, x0 and w -------
  // (the operator sizes are multiples of 4: Nnu = 4N)
  auto fill = [&](float* dst, const float* src, int n) {
    uav::copy_to_shared<8>(reinterpret_cast<float4*>(dst),
                           reinterpret_cast<const float4*>(src), n / 4, tid, nth);
  };
  fill(SuRow, O.SuRow, Nnx * Nnu);
  fill(SuT, O.SuT, Nnu * Nnx);
  fill(MinvT, O.MinvT, Nnu * Nnu);
  for (int i = tid; i < Nnu; i += nth) {
    loU[i] = __ldg(O.u_lo + i);
    hiU[i] = __ldg(O.u_hi + i);
  }
  // warm-start shift as an index remap: stage k takes stage k+1, the last
  // stage keeps its own values; flights past the batch load zeros
  for (int i = tid; i < kFlights * Nnu; i += nth) {
    const int fl = i / Nnu, c = i % Nnu, b = b0 + fl;
    const int src = c < Nnu - nu ? c + nu : c;
    const bool ok = b < P.batch;
    zU[fl * ldu + c] = ok ? O.ZU[b * Nnu + src] : 0.0f;
    yU[fl * ldu + c] = ok ? O.YU[b * Nnu + src] : 0.0f;
  }
  for (int i = tid; i < kFlights * Nnx; i += nth) {
    const int fl = i / Nnx, r = i % Nnx, b = b0 + fl;
    const int src = r < Nnx - nx ? r + nx : r;
    const bool ok = b < P.batch;
    zX[fl * ldx + r] = ok ? O.ZX[b * Nnx + src] : 0.0f;
    yX[fl * ldx + r] = ok ? O.YX[b * Nnx + src] : 0.0f;
    vX[fl * ldx + r] = ok ? O.W[b * P.w_stride + r] : 0.0f;
  }
  for (int i = tid; i < kFlights * nx; i += nth) {
    const int fl = i / nx, c = i % nx, b = b0 + fl;
    x0s[fl * ld0 + c] = b < P.batch ? O.X0[b * nx + c] : 0.0f;
  }
  __syncthreads();

  // ---- offset = x0 SxT + w SwT; X-space bounds; offset - ref --------------
  for (int t = tid; t < Nnx * kGroups; t += nth) {
    const int r = t % Nnx, f0 = (t / Nnx) * kGroup;
    float ax[kGroup], aw[kGroup];
    group_dot<true>(x0s + f0 * ld0, ld0, O.SxT, Nnx, r, nx, ax);
    group_dot<true>(vX + f0 * ldx, ldx, O.SwT, Nnx, r, Nnx, aw);
    const float xlo = __ldg(O.x_lo + r), xhi = __ldg(O.x_hi + r);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int fl = f0 + g, b = b0 + fl;
      const float o = ax[g] + aw[g];
      const float ref = b < P.batch ? O.REF[b * P.ref_stride + r] : 0.0f;
      off[fl * ldx + r] = o;
      loX[fl * ldx + r] = xlo - o;
      hiX[fl * ldx + r] = xhi - o;
      dref[fl * ldx + r] = o - ref;
    }
  }
  __syncthreads();

  // ---- f = (offset - ref) SuTqT; the first matvec inputs -------------------
  for (int t = tid; t < Nnu * kGroups; t += nth) {
    const int c = t % Nnu, f0 = (t / Nnu) * kGroup;
    float acc[kGroup];
    group_dot<true>(dref + f0 * ldx, ldx, O.SuTqT, Nnu, c, Nnx, acc);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int k = (f0 + g) * ldu + c;
      fv[k] = acc[g];
      vU[k] = rho * zU[k] - yU[k];
    }
  }
  for (int i = tid; i < kFlights * Nnx; i += nth) {
    const int k = (i / Nnx) * ldx + i % Nnx;
    vX[k] = rho * zX[k] - yX[k];
  }
  __syncthreads();

  // t - f = v_U + v_X SuRow - f (U columns)
  auto phase_t = [&]() {
    for (int t = tid; t < Nnu * kGroups; t += nth) {
      const int c = t % Nnu, f0 = (t / Nnu) * kGroup;
      float acc[kGroup];
      group_dot<false>(vX + f0 * ldx, ldx, SuRow, Nnu, c, Nnx, acc);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int k = (f0 + g) * ldu + c;
        tf[k] = (vU[k] + acc[g]) - fv[k];
      }
    }
  };

  // ---- ADMM iterations: three phases each -----------------------------------
  for (int it = 0; it < P.iterations; ++it) {
    phase_t();
    __syncthreads();
    // U = (t - f) MinvT, then the U-space over-relaxation and projection
    for (int t = tid; t < Nnu * kGroups; t += nth) {
      const int c = t % Nnu, f0 = (t / Nnu) * kGroup;
      float acc[kGroup];
      group_dot<false>(tf + f0 * ldu, ldu, MinvT, Nnu, c, Nnu, acc);
      const float lo = loU[c], hi = hiU[c];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int k = (f0 + g) * ldu + c;
        const float U = acc[g];
        const float Gt = a * U + am * zU[k];
        const float zn = clipf(Gt + yU[k] / rho, lo, hi);
        const float yn = yU[k] + rho * (Gt - zn);
        Ub[k] = U;
        zU[k] = zn;
        yU[k] = yn;
        vU[k] = rho * zn - yn;
      }
    }
    __syncthreads();
    // G_X = U SuT, then the X-space over-relaxation and projection
    for (int t = tid; t < Nnx * kGroups; t += nth) {
      const int r = t % Nnx, f0 = (t / Nnx) * kGroup;
      float acc[kGroup];
      group_dot<false>(Ub + f0 * ldu, ldu, SuT, Nnx, r, Nnu, acc);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int k = (f0 + g) * ldx + r;
        const float Gt = a * acc[g] + am * zX[k];
        const float zn = clipf(Gt + yX[k] / rho, loX[k], hiX[k]);
        const float yn = yX[k] + rho * (Gt - zn);
        zX[k] = zn;
        yX[k] = yn;
        vX[k] = rho * zn - yn;
      }
    }
    __syncthreads();
  }

  // ---- primal refresh from the last (z, y), X_tail, outputs ---------------
  phase_t();
  __syncthreads();
  for (int t = tid; t < Nnu * kGroups; t += nth) {
    const int c = t % Nnu, f0 = (t / Nnu) * kGroup;
    float acc[kGroup];
    group_dot<false>(tf + f0 * ldu, ldu, MinvT, Nnu, c, Nnu, acc);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int fl = f0 + g, b = b0 + fl, k = fl * ldu + c;
      Ub[k] = acc[g];
      if (b < P.batch) {
        O.u_out[b * Nnu + c] = acc[g];
        O.zu_out[b * Nnu + c] = zU[k];
        O.yu_out[b * Nnu + c] = yU[k];
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < Nnx * kGroups; t += nth) {
    const int r = t % Nnx, f0 = (t / Nnx) * kGroup;
    float acc[kGroup];
    group_dot<false>(Ub + f0 * ldu, ldu, SuT, Nnx, r, Nnu, acc);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int fl = f0 + g, b = b0 + fl, k = fl * ldx + r;
      if (b < P.batch) {
        O.xtail_out[b * Nnx + r] = off[k] + acc[g];
        O.zx_out[b * Nnx + r] = zX[k];
        O.yx_out[b * Nnx + r] = yX[k];
      }
    }
  }
}

// K16's flights per block (ops/controller_pallas.py FUSED_FLIGHTS_PER_BLOCK).
// A block's time grows with its flights (each thread's multiply-adds and
// shared loads); fewer flights per block spread the work over more SMs but
// read P1 from L2 more often per flight. Two was the fastest of 1, 2, 4, 8
// and 16 on the H100 at B=256 (PERF.md).
constexpr int kTile = 2;
constexpr int kStepGlobal = 32;   // matrix loads in flight per thread from L2
constexpr int kNx = 6, kNu = 4;

template <bool kSharedP1>
__global__ void __launch_bounds__(kThreads, 1)
fused_batched_kernel(const FusedBatchedParams P, const FusedBatchedOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int N = P.n, m = P.m, Nnu = N * kNu, Nnx = N * kNx, npm = m + Nnu, nxw = kNx + Nnx;
  const int ldm = round4(m), ldw = round4(nxw), ldx = round4(Nnx), ldu = round4(Nnu);
  const int b0 = blockIdx.x * kTile;
  const float rho = P.rho, a = P.over_relax, am = P.one_minus_over_relax;

  // shared memory layout (ops/controller_pallas.py
  // fused_batched_shared_memory_bytes); every row starts 16-byte aligned
  float* P1s = sm;
  float* z = P1s + (kSharedP1 ? round4(m * m) : 0);   // kTile rows of ldm each
  float* y = z + kTile * ldm;
  float* va = y + kTile * ldm;      // ADMM input rho z - y, double-buffered;
  float* vb = va + kTile * ldm;     // Z0 and Y0 before the shift
  float* p0 = vb + kTile * ldm;
  float* lower = p0 + kTile * ldm;
  float* upper = lower + kTile * ldm;
  float* xw = upper + kTile * ldm;  // [x0 | w], kTile rows of ldw
  float* off = xw + kTile * ldw;    // offset, kTile rows of ldx
  float* dref = off + kTile * ldx;  // ref, then offset - ref
  float* f = dref + kTile * ldx;    // kTile rows of ldu
  float* minvf = f + kTile * ldu;
  float* U = minvf + kTile * ldu;

  // ---- load: P1, the tile's unshifted warm start, [x0 | w], ref ----------
  // (flights past the batch load zeros)
  if constexpr (kSharedP1) {
    uav::copy_to_shared<8>(reinterpret_cast<float4*>(P1s), reinterpret_cast<const float4*>(O.P1),
                           m * m / 4, tid, nth);
  }
  for (int i = tid; i < kTile * m; i += nth) {
    const int fl = i / m, c = i % m, b = b0 + fl;
    const bool ok = b < P.batch;
    va[fl * ldm + c] = ok ? O.Z0[(size_t)b * m + c] : 0.0f;
    vb[fl * ldm + c] = ok ? O.Y0[(size_t)b * m + c] : 0.0f;
  }
  for (int i = tid; i < kTile * nxw; i += nth) {
    const int fl = i / nxw, c = i % nxw, b = b0 + fl;
    float v = 0.0f;
    if (b < P.batch) v = c < kNx ? O.X0[b * kNx + c] : O.W[(size_t)b * P.w_stride + c - kNx];
    xw[fl * ldw + c] = v;
  }
  for (int i = tid; i < kTile * Nnx; i += nth) {
    const int fl = i / Nnx, r = i % Nnx, b = b0 + fl;
    dref[fl * ldx + r] = b < P.batch ? O.REF[(size_t)b * P.ref_stride + r] : 0.0f;
  }
  __syncthreads();

  // ---- warm-start shift z = Z0 ShiftT, y = Y0 ShiftT ----------------------
  for (int j = tid; j < m; j += nth) {
    float az[kTile], ay[kTile];
    tile_dot<kTile, true, kStepGlobal>(va, ldm, O.ShiftT, m, j, m, az);
    tile_dot<kTile, true, kStepGlobal>(vb, ldm, O.ShiftT, m, j, m, ay);
#pragma unroll
    for (int g = 0; g < kTile; ++g) {
      z[g * ldm + j] = az[g];
      y[g * ldm + j] = ay[g];
    }
  }
  // ---- prediction offset = [x0, w] @ [Sx'; Sw'], offset - ref -------------
  for (int r = tid; r < Nnx; r += nth) {
    float acc[kTile];
    tile_dot<kTile, true, kStepGlobal>(xw, ldw, O.SxSwT, Nnx, r, nxw, acc);
#pragma unroll
    for (int g = 0; g < kTile; ++g) {
      off[g * ldx + r] = acc[g];
      dref[g * ldx + r] = acc[g] - dref[g * ldx + r];
    }
  }
  __syncthreads();
  // ---- condensed gradient f, box bounds, the first ADMM input -------------
  for (int c = tid; c < Nnu; c += nth) {
    float acc[kTile];
    tile_dot<kTile, true, kStepGlobal>(dref, ldx, O.SuTqT, Nnu, c, Nnx, acc);
#pragma unroll
    for (int g = 0; g < kTile; ++g) f[g * ldu + c] = acc[g];
  }
  for (int i = tid; i < kTile * m; i += nth) {
    const int fl = i / m, j = i % m, k = fl * ldm + j;
    const float off_z = j >= Nnu ? off[fl * ldx + j - Nnu] : 0.0f;
    lower[k] = __ldg(O.lo_row + j) - off_z;
    upper[k] = __ldg(O.hi_row + j) - off_z;
    va[k] = rho * z[k] - y[k];
  }
  __syncthreads();
  // ---- p0 = -(f @ P0mat), M^-1 f = f @ MinvT --------------------------------
  for (int j = tid; j < npm; j += nth) {
    float acc[kTile];
    tile_dot<kTile, true, kStepGlobal>(f, ldu, O.PM, npm, j, Nnu, acc);
#pragma unroll
    for (int g = 0; g < kTile; ++g) {
      if (j < m) p0[g * ldm + j] = -acc[g];
      else minvf[g * ldu + j - m] = acc[g];
    }
  }
  __syncthreads();
  // ---- composite ADMM: GU = p0 + (rho z - y) P1 for the four flights --------
  const float* P1 = kSharedP1 ? P1s : O.P1;
  float* vsrc = va;
  float* vdst = vb;
  for (int it = 0; it < P.iterations; ++it) {
    for (int j = tid; j < m; j += nth) {
      float acc[kTile];
      if constexpr (kSharedP1) tile_dot<kTile, false, 16>(vsrc, ldm, P1, m, j, m, acc);
      else tile_dot<kTile, true, kStepGlobal>(vsrc, ldm, P1, m, j, m, acc);
#pragma unroll
      for (int g = 0; g < kTile; ++g) {
        const int k = g * ldm + j;
        const float GU = p0[k] + acc[g];
        const float Gt = a * GU + am * z[k];
        const float zn = clipf(Gt + y[k] / rho, lower[k], upper[k]);
        const float yn = y[k] + rho * (Gt - zn);
        z[k] = zn;
        y[k] = yn;
        vdst[k] = rho * zn - yn;
      }
    }
    __syncthreads();
    float* tmp = vsrc;
    vsrc = vdst;
    vdst = tmp;
  }
  // ---- primal U = -M^-1 f + (rho z - y) G M^-1, then X_tail ----------------
  for (int c = tid; c < Nnu; c += nth) {
    float acc[kTile];
    tile_dot<kTile, true, kStepGlobal>(vsrc, ldm, O.P0matT, Nnu, c, m, acc);
#pragma unroll
    for (int g = 0; g < kTile; ++g) {
      const float u = -minvf[g * ldu + c] + acc[g];
      U[g * ldu + c] = u;
      if (b0 + g < P.batch) O.u_out[(size_t)(b0 + g) * Nnu + c] = u;
    }
  }
  __syncthreads();
  for (int r = tid; r < Nnx; r += nth) {
    float acc[kTile];
    tile_dot<kTile, true, kStepGlobal>(U, ldu, O.SuT, Nnx, r, Nnu, acc);
#pragma unroll
    for (int g = 0; g < kTile; ++g)
      if (b0 + g < P.batch) O.xtail_out[(size_t)(b0 + g) * Nnx + r] = off[g * ldx + r] + acc[g];
  }
  for (int i = tid; i < kTile * m; i += nth) {
    const int fl = i / m, j = i % m, b = b0 + fl;
    if (b < P.batch) {
      O.z_out[(size_t)b * m + j] = z[fl * ldm + j];
      O.y_out[(size_t)b * m + j] = y[fl * ldm + j];
    }
  }
}

}  // namespace

extern "C" int structured_batched_launch(const StructuredParams* params,
                                         const StructuredOperands* ops, int smem_bytes,
                                         void* stream) {
  // raise the block's shared-memory limit once per size (host-side call,
  // kept out of the per-launch path and out of CUDA graph captures)
  static int configured_bytes = -1;
  if (smem_bytes > configured_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        structured_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    configured_bytes = smem_bytes;
  }
  const int blocks = (params->batch + kFlights - 1) / kFlights;
  structured_batched_kernel<<<blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(*params,
                                                                                    *ops);
  return (int)cudaGetLastError();
}

extern "C" int fused_batched_launch(const FusedBatchedParams* params,
                                    const FusedBatchedOperands* ops, int p1_shared,
                                    int smem_bytes, void* stream) {
  // raise the block's shared-memory limit once per size and variant
  static int configured_bytes[2] = {-1, -1};
  auto kernel = p1_shared ? fused_batched_kernel<true> : fused_batched_kernel<false>;
  int* configured = &configured_bytes[p1_shared ? 0 : 1];
  if (smem_bytes > *configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    *configured = smem_bytes;
  }
  const int blocks = (params->batch + kTile - 1) / kTile;
  kernel<<<blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(*params, *ops);
  return (int)cudaGetLastError();
}
