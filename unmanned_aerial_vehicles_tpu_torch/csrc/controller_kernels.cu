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
// What bounds K16 on an H100: operations. Per flight-tick 2 m^2 (shift) +
// iterations m^2 (ADMM) multiply-adds plus the set-up, ~5.2 M at N=25 with
// 80 iterations; ~2.7 GFLOP for the 256-flight population, ~40 us at
// 67 TFLOP/s. What held its first design back was the operator, not the
// arithmetic: one block per two flights, 128 blocks each re-reading P1
// (250 KB at N=25, more than a block holds) from L2 in every one of the 80
// iterations, ~2.56 GB per launch, with one shared load per multiply-add.
//
// Design: a thread-block cluster (csrc/cluster.cuh) of C blocks owns a tile
// of 16 flights (the tail tile is masked: any batch). Block r keeps columns
// [r m / C, (r + 1) m / C) of P1 in its shared memory for the whole launch
// (32 KB at N=25, C=8) and holds the tile's whole matvec input v =
// rho z - y (m x 16, double-buffered). An ADMM iteration is: each block
// forms its column slice of GU = p0 + v P1 (float32 multiply-adds, 4 x 4
// register tiles), runs the over-relaxation, box projection and dual update
// on its own columns (z, y, p0 and the bounds stay in registers), writes its
// slice of the new v into every block of the cluster through distributed
// shared memory, and meets the others at one cluster barrier. The shift,
// the offset, f, p0, M^-1 f, the primal refresh and X_tail are split over
// the cluster by output columns the same way, whole rows exchanged where
// the next product needs them. So every operand (ShiftT, SxSwT, SuTqT, PM,
// P1, P0matT, SuT) is read from global memory once per cluster per launch:
// P1 16 x 250 KB = 4 MB at B=256, N=25, where the first design read
// ~2.56 GB. One design serves every horizon whose slices fit a block (N=20
// and N=25 alike). C is the largest of 8 down to 1 whose clusters for the
// batch all run at once (an H100 runs 15 clusters of 8 at once, not the 16
// that 256 flights need); the wrapper asks for at least half an SM's shared
// memory, so no SM runs two blocks of a cluster that meets at a barrier
// every iteration.
//
// Tensor cores did not pay here (PERF.md, section 6). TF32 keeps about three
// digits, so the product needs three of them (3xTF32: a_hi b_hi + a_hi b_lo
// + a_lo b_hi) to hold the plain version's float32 sums; on the H100
// mma.sync.m16n8k8 in TF32 ran at about the float32 FMA rate, so the three
// cost more than the FMAs, and wgmma.m64n16k8 (P1's slice as the 64-row A,
// the 16 flights as N) ran slower still, its 16-column tile too narrow to
// fill the tensor cores, with sums near the check's tolerance. What bounds
// this design is the shared-memory loads of the products' 4 x 4 tiles (two
// 16-byte loads per 16 multiply-adds) and the per-iteration exchange.

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

#include "cluster.cuh"
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

// ---- K16 ---------------------------------------------------------------------
//
// A cluster of C blocks owns a tile of kTileFlights flights; block r owns
// the column slice [r m / C, (r + 1) m / C) of every m-wide product and the
// matching slices of the Nnu- and Nnx-wide ones (balanced to within one
// column; ops/controller_pallas.py fused_column_slices mirrors them). Every
// vector that a product reads is held flight-minor, [k][16] (the matvec
// input v, Z0 and Y0, [x0 | w], offset - ref, f, U): a thread loads the
// flights of a row with 16-byte loads, and a block's slice of a vector is
// one contiguous run of 64-byte rows.
//
// slice_product: the block's 256 threads form T = swp tiles of 4 flights x
// 4 columns (swp: the slice width rounded up to 4) times R = 256 / T ranges
// of the K rows; thread (tile, range) accumulates its 16 products over its
// rows in order, and slice_total adds the R ranges' sums in order. So the
// sums are fixed for a given slice width, and two launches agree bit for
// bit. The operand is P1's slice in shared memory (the ADMM) or one read
// from device memory once per cluster (the set-up).

constexpr int kNx = 6, kNu = 4;
constexpr int kTileFlights = 16;   // FUSED_TILE_FLIGHTS
constexpr int kPartRow = 20;       // a partial column's 16 flights, padded: conflict-free stores
constexpr int kMaxPairs = 2;       // flight pairs per thread: slices of at most
                                   // FUSED_MAX_SLICE = 64 columns

__host__ __device__ __forceinline__ int part_begin(int n, int parts, int r) {
  return static_cast<int>(static_cast<long long>(r) * n / parts);
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// part[(range swp + c) kPartRow + f] = sum over the range's rows k of
// inT[k 16 + f] A[k lda + c0 + c] for the slice's columns c < w (zero up to
// swp); A lies in shared memory ([k][swp], zero-padded: kSharedA) or in
// device memory; eight rows of loads in flight.
template <bool kSharedA>
__device__ __forceinline__ void slice_product(const float* inT, int K,
                                              const float* __restrict__ A, int lda, int c0,
                                              int w, int swp, float* part, int tid) {
  const int T = swp, R = kThreads / swp;
  if (tid >= R * T) return;
  const int tile = tid % T, range = tid / T, fg = tile & 3, col = 4 * (tile >> 2);
  const int k0 = part_begin(K, R, range), k1 = part_begin(K, R, range + 1);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  auto row = [&](int k, float (&a)[4]) {
    if constexpr (kSharedA) {
      const float4 v = *reinterpret_cast<const float4*>(A + k * lda + col);
      a[0] = v.x;
      a[1] = v.y;
      a[2] = v.z;
      a[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = col + j < w ? __ldg(A + static_cast<size_t>(k) * lda + c0 + col + j) : 0.0f;
      }
    }
  };
  auto fold = [&](const float4 v, const float (&a)[4]) {
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], a[j], acc[i][j]);
    }
  };
  int k = k0;
  for (; k + 8 <= k1; k += 8) {
    float a[8][4];
    float4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      row(k + u, a[u]);
      x[u] = *reinterpret_cast<const float4*>(inT + (k + u) * kTileFlights + 4 * fg);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) fold(x[u], a[u]);
  }
  for (; k < k1; ++k) {
    float a[4];
    row(k, a);
    fold(*reinterpret_cast<const float4*>(inT + k * kTileFlights + 4 * fg), a);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(part + (range * swp + col + j) * kPartRow + 4 * fg) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
  }
}

// The product at slice column c for flights 2 fp and 2 fp + 1: the
// ranges' partial sums in range order (R = 256 / swp ranges).
__device__ __forceinline__ float2 slice_total(const float* part, int swp, int c, int fp) {
  const int R = kThreads / swp;
  float2 s = *reinterpret_cast<const float2*>(part + c * kPartRow + 2 * fp);
#pragma unroll 8
  for (int r = 1; r < R; ++r) {
    const float2 v = *reinterpret_cast<const float2*>(part + (r * swp + c) * kPartRow + 2 * fp);
    s.x += v.x;
    s.y += v.y;
  }
  return s;
}

// slice_total at every pair of the thread (column e / 8, flights 2 (e % 8)
// and + 1, e = tid + j kThreads), the pairs' loads interleaved; a pair past
// the slice's 8 w reads the last one's.
__device__ __forceinline__ void pair_totals(const float* part, int swp, int w, int tid,
                                            float2 (&s)[kMaxPairs]) {
  const int R = kThreads / swp;
  int at[kMaxPairs];
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    const int e = min(tid + j * kThreads, 8 * w - 1);
    at[j] = (e / 8) * kPartRow + 2 * (e % 8);
    s[j] = *reinterpret_cast<const float2*>(part + at[j]);
  }
#pragma unroll 4
  for (int r = 1; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(part + r * swp * kPartRow + at[j]);
      s[j].x += v.x;
      s[j].y += v.y;
    }
  }
}

// Writes `value` into row `row` (16 flights) at flights 2 fp, 2 fp + 1 of
// `buf` in every block of the cluster.
__device__ __forceinline__ void put_pair(float* buf, int row, int fp, float2 value, int C) {
  for (int r = 0; r < C; ++r) {
    *reinterpret_cast<float2*>(uav::peer_shared(buf, r) + row * kTileFlights + 2 * fp) = value;
  }
}

// dst(i) = load(i) for i < n over the block, eight loads in flight per thread.
template <class Load, class Store>
__device__ __forceinline__ void gather(int n, int tid, Load load, Store store) {
  for (int i0 = tid; i0 < n; i0 += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = i0 + u * kThreads < n ? load(i0 + u * kThreads) : 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (i0 + u * kThreads < n) store(i0 + u * kThreads, v[u]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_batched_kernel(const FusedBatchedParams P, const FusedBatchedOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x;
  const int C = static_cast<int>(uav::cluster_blocks());
  const int rank = static_cast<int>(uav::cluster_rank());
  const int N = P.n, m = P.m, Nnu = N * kNu, Nnx = N * kNx, npm = m + Nnu, nxw = kNx + Nnx;
  const int b0 = static_cast<int>(blockIdx.x) / C * kTileFlights;
  const float rho = P.rho, a = P.over_relax, am = P.one_minus_over_relax;
  constexpr int F = kTileFlights;

  // this block's slices (begin, width, width rounded up to 4): the m columns
  // of the ADMM, Nnu of U, Nnx of X
  const int c0 = part_begin(m, C, rank), w = part_begin(m, C, rank + 1) - c0;
  const int u0 = part_begin(Nnu, C, rank), uw = part_begin(Nnu, C, rank + 1) - u0;
  const int x0 = part_begin(Nnx, C, rank), xw = part_begin(Nnx, C, rank + 1) - x0;
  const int swp = 4 * ceil_div(w, 4), uswp = 4 * ceil_div(uw, 4), xswp = 4 * ceil_div(xw, 4);

  // shared memory layout (ops/controller_pallas.py
  // fused_batched_shared_memory_bytes); every array starts 16-byte aligned
  unsigned long long* full = reinterpret_cast<unsigned long long*>(sm);   // 2 mbarriers
  float* P1s = sm + 4;                      // [m][swp]: P1's column slice
  float* vbuf = P1s + m * swp;              // 2 x [m][16]: Z0, Y0; then v, double-buffered
  float* part = vbuf + 2 * m * F;           // 256 partial columns of kPartRow
  float* xwv = part + kThreads * kPartRow;  // [nxw][16]: [x0 | w]; then offset - ref
  float* off = xwv + nxw * F;               // [Nnx][16]: the offset (exchanged)
  float* fv = off + Nnx * F;                // [Nnu][16]: f, then U (exchanged)
  float* minvf = fv + Nnu * F;              // [uw][16]: M^-1 f on the U slice

  // ---- P1's slice (read once per cluster; first read by the ADMM: its copy
  // runs asynchronously behind the set-up, cp.async, waited for before the
  // first iteration)
  for (int i = tid; i < m * swp; i += kThreads) {
    const int c = i % swp;
    if (c < w) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(uav::shared_address(P1s + i)),
                   "l"(O.P1 + static_cast<size_t>(i / swp) * m + c0 + c)
                   : "memory");
    } else {
      P1s[i] = 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");

  // ---- load: the tile's unshifted warm start and [x0 | w] (flights past the
  // batch load zeros)
  if (tid == 0) {
    uav::barrier_init(full, 1);
    uav::barrier_init(full + 1, 1);
    uav::fence_barrier_init();
  }
  // (element j: plane, then runs of 8 rows x 4 flights with the rows
  // fastest, so a warp reads 4 runs of 8 consecutive floats)
  const int runs = ceil_div(m, 8);
  auto warm_row = [&](int j) { return (j / 32 % runs) * 8 + j % 8; };
  auto warm_flight = [&](int j) { return j / (32 * runs) % 4 * 4 + j % 32 / 8; };
  gather(2 * runs * 32 * 4, tid,
         [&](int j) {
           const int plane = j / (runs * 128), k = warm_row(j), b = b0 + warm_flight(j);
           return b < P.batch && k < m ? (plane ? O.Y0 : O.Z0)[static_cast<size_t>(b) * m + k]
                                       : 0.0f;
         },
         [&](int j, float v) {
           const int k = warm_row(j);
           if (k < m) vbuf[j / (runs * 128) * m * F + k * F + warm_flight(j)] = v;
         });
  gather(nxw * F, tid,
         [&](int i) {
           const int k = i / F, b = b0 + i % F;
           if (b >= P.batch) return 0.0f;
           return k < kNx ? O.X0[b * kNx + k] : O.W[static_cast<size_t>(b) * P.w_stride + k - kNx];
         },
         [&](int i, float v) { xwv[i] = v; });
  __syncthreads();
  uav::cluster_arrive();   // every block has started; waited on before the first remote write

  // ---- warm-start shift z = Z0 ShiftT, y = Y0 ShiftT on this block's columns;
  // thread pair j is (column e / 8, flights 2 (e % 8) and +1), e = tid + j kThreads
  float z[kMaxPairs][2], y[kMaxPairs][2], p0[kMaxPairs][2], lower[kMaxPairs][2],
      upper[kMaxPairs][2];
  auto pair_on = [&](int j) { return tid + j * kThreads < 8 * w; };
#pragma unroll
  for (int plane = 0; plane < 2; ++plane) {
    slice_product<false>(vbuf + plane * m * F, m, O.ShiftT, m, c0, w, swp, part, tid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const int e = tid + j * kThreads;
      const float2 s = pair_on(j) ? slice_total(part, swp, e / 8, e % 8) : make_float2(0.f, 0.f);
      if (plane == 0) {
        z[j][0] = s.x;
        z[j][1] = s.y;
      } else {
        y[j][0] = s.x;
        y[j][1] = s.y;
      }
    }
    __syncthreads();
  }
  // ---- prediction offset = [x0, w] [Sx'; Sw'] on this block's X columns -----
  slice_product<false>(xwv, nxw, O.SxSwT, Nnx, x0, xw, xswp, part, tid);
  __syncthreads();
  uav::cluster_wait();
  for (int e = tid; e < 8 * xw; e += kThreads) {
    put_pair(off, x0 + e / 8, e % 8, slice_total(part, xswp, e / 8, e % 8), C);
  }
  uav::cluster_sync();   // whole offset rows in every block; every block is done with Z0, Y0

  // ---- offset - ref (into xwv); f on this block's U columns; the first input
  gather(Nnx * F, tid,
         [&](int i) {
           const int b = b0 + i % F;
           const float ref =
               b < P.batch ? O.REF[static_cast<size_t>(b) * P.ref_stride + i / F] : 0.0f;
           return off[i] - ref;
         },
         [&](int i, float v) { xwv[i] = v; });
  __syncthreads();
  slice_product<false>(xwv, Nnx, O.SuTqT, Nnu, u0, uw, uswp, part, tid);
  __syncthreads();
  for (int e = tid; e < 8 * uw; e += kThreads) {
    put_pair(fv, u0 + e / 8, e % 8, slice_total(part, uswp, e / 8, e % 8), C);
  }
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    if (pair_on(j)) {
      const int e = tid + j * kThreads;
      put_pair(vbuf, c0 + e / 8, e % 8,
               make_float2(rho * z[j][0] - y[j][0], rho * z[j][1] - y[j][1]), C);
    }
  }
  uav::cluster_sync();   // whole f rows and the first input rows in every block

  // ---- p0 = -(f P0mat) and the box bounds on this block's columns, M^-1 f on
  // its U columns
  slice_product<false>(fv, Nnu, O.PM, npm, c0, w, swp, part, tid);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    const int e = tid + j * kThreads, jc = c0 + e / 8;
    const float2 s = pair_on(j) ? slice_total(part, swp, e / 8, e % 8) : make_float2(0.f, 0.f);
    p0[j][0] = -s.x;
    p0[j][1] = -s.y;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lower[j][h] = upper[j][h] = 0.0f;
      if (pair_on(j)) {
        const float off_z = jc >= Nnu ? off[(jc - Nnu) * F + 2 * (e % 8) + h] : 0.0f;
        lower[j][h] = __ldg(O.lo_row + jc) - off_z;
        upper[j][h] = __ldg(O.hi_row + jc) - off_z;
      }
    }
  }
  __syncthreads();
  slice_product<false>(fv, Nnu, O.PM, npm, m + u0, uw, uswp, part, tid);
  __syncthreads();
  for (int e = tid; e < 8 * uw; e += kThreads) {
    *reinterpret_cast<float2*>(minvf + (e / 8) * F + 2 * (e % 8)) =
        slice_total(part, uswp, e / 8, e % 8);
  }
  __syncthreads();

  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // ---- composite ADMM: GU = p0 + (rho z - y) P1 on this block's columns ----
  // Each block writes its slice of the new input v into its own copy of the
  // other buffer, then thread r copies that run of rows into block r with a
  // bulk copy, whose bytes complete on the receiver's
  // transaction barrier for that buffer; the receiver waits on it before
  // its next product. A block overwrites a buffer only after it has every
  // block's slice of the iteration that last read it, so the two buffers
  // need no other barrier.
  const unsigned slice_bytes = static_cast<unsigned>(w * F * 4);
  const unsigned peer_bytes = static_cast<unsigned>((m - w) * F * 4);
  for (int it = 0; it < P.iterations; ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    if (it > 0) uav::barrier_wait(full + cur, ((it - 1) >> 1) & 1);
    const float* vin = vbuf + cur * m * F;
    float* vout = vbuf + nxt * m * F;
    slice_product<true>(vin, m, P1s, swp, 0, w, swp, part, tid);
    // this buffer's slice was last copied out two iterations ago
    if (tid < C) uav::copies_wait_read<1>();
    __syncthreads();
    float2 sums[kMaxPairs];
    pair_totals(part, swp, w, tid, sums);
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      if (pair_on(j)) {
        const int e = tid + j * kThreads;
        const float gu[2] = {sums[j].x, sums[j].y};
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float Gt = a * (p0[j][h] + gu[h]) + am * z[j][h];
          const float zn = clipf(Gt + y[j][h] / rho, lower[j][h], upper[j][h]);
          const float yn = y[j][h] + rho * (Gt - zn);
          z[j][h] = zn;
          y[j][h] = yn;
          v[h] = rho * zn - yn;
        }
        *reinterpret_cast<float2*>(vout + (c0 + e / 8) * F + 2 * (e % 8)) =
            make_float2(v[0], v[1]);
      }
    }
    uav::fence_for_copies();
    __syncthreads();
    if (tid == 0) uav::barrier_expect(full + nxt, peer_bytes);
    if (tid < C) {
      if (tid != rank) {
        uav::copy_to_peer(vout + c0 * F, vout + c0 * F, slice_bytes, full + nxt, tid);
      }
      uav::copies_commit();
    }
  }
  if (P.iterations > 0) {
    uav::barrier_wait(full + (P.iterations & 1), ((P.iterations - 1) >> 1) & 1);
  } else {
    uav::cluster_sync();   // every block is done reading f
  }

  // ---- primal U = -M^-1 f + (rho z - y) P0mat' on this block's U columns ----
  slice_product<false>(vbuf + (P.iterations & 1) * m * F, m, O.P0matT, Nnu, u0, uw, uswp, part,
                       tid);
  __syncthreads();
  for (int e = tid; e < 8 * uw; e += kThreads) {
    const int c = e / 8, fp = e % 8;
    const float2 s = slice_total(part, uswp, c, fp);
    const float2 mf = *reinterpret_cast<const float2*>(minvf + c * F + 2 * fp);
    const float2 u = make_float2(-mf.x + s.x, -mf.y + s.y);
    put_pair(fv, u0 + c, fp, u, C);
    if (b0 + 2 * fp < P.batch) O.u_out[static_cast<size_t>(b0 + 2 * fp) * Nnu + u0 + c] = u.x;
    if (b0 + 2 * fp + 1 < P.batch) {
      O.u_out[static_cast<size_t>(b0 + 2 * fp + 1) * Nnu + u0 + c] = u.y;
    }
  }
  // whole U rows in every block; the last remote access of the launch (every
  // bulk copy has landed: each block waited for its last buffer), so no
  // block exits while a peer still writes its shared memory
  uav::cluster_sync();
  // ---- X_tail = offset + U Su' on this block's X columns; the slack, dual --
  slice_product<false>(fv, Nnu, O.SuT, Nnx, x0, xw, xswp, part, tid);
  __syncthreads();
  for (int e = tid; e < 8 * xw; e += kThreads) {
    const int c = e / 8, fp = e % 8;
    const float2 s = slice_total(part, xswp, c, fp);
    const float xs[2] = {s.x, s.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + 2 * fp + h;
      if (b < P.batch) {
        O.xtail_out[static_cast<size_t>(b) * Nnx + x0 + c] =
            off[(x0 + c) * F + 2 * fp + h] + xs[h];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    const int e = tid + j * kThreads;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + 2 * (e % 8) + h;
      if (pair_on(j) && b < P.batch) {
        O.z_out[static_cast<size_t>(b) * m + c0 + e / 8] = z[j][h];
        O.y_out[static_cast<size_t>(b) * m + c0 + e / 8] = y[j][h];
      }
    }
  }
}

int fused_configured_bytes = -1;

// Raise the kernel's shared-memory limit once per size (host-side call,
// kept out of the per-launch path and out of CUDA graph captures).
int configure_fused(int smem_bytes) {
  if (smem_bytes > fused_configured_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_configured_bytes = smem_bytes;
  }
  return 0;
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
                                    const FusedBatchedOperands* ops, int cluster,
                                    int smem_bytes, void* stream) {
  const int err = configure_fused(smem_bytes);
  if (err != 0) return err;
  const int clusters = (params->batch + kTileFlights - 1) / kTileFlights;
  return uav::launch_cluster(fused_batched_kernel, clusters * cluster, kThreads, cluster,
                             smem_bytes, static_cast<cudaStream_t>(stream), *params, *ops);
}

// The number of K16 clusters of `cluster` blocks with `smem_bytes` each
// that the card runs at once, into *count.
extern "C" int fused_batched_max_active_clusters(int cluster, int smem_bytes, int* count) {
  const int err = configure_fused(smem_bytes);
  if (err != 0) return err;
  return uav::max_active_clusters(fused_batched_kernel, kThreads, cluster, smem_bytes, count);
}
