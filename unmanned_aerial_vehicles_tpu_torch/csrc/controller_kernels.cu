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
// Design: a block of 512 threads owns a tile of kFlights = 8 flights (the
// tail tile is masked, so any batch works and nothing is padded; 128 blocks
// at B=1024, one wave on 132 SMs). SuRow, MinvT and SuT (100 KB at N=20)
// stay in shared memory for the launch, their rows at a stride of 4 mod 8
// floats. The threads issue them as 16-byte asynchronous copies (cp.async)
// at the kernel's start and wait for them only before the first ADMM phase,
// so they land while the set-up reads SxT, SwT and SuTqT from L2 (SuT's
// rows are copied by the threads where they are not 16-byte multiples, odd
// N). The tile's iterates live in shared memory, flight-major
// ([flight][index], rows at a stride of 16 mod 32 floats).
//
// Every product out[f][o] = sum_k v[f][k] A[k][o] (A row-major: SuRow,
// MinvT, SuT, and the set-up's SwT and SuTqT) runs on register tiles: a
// lane owns 4 outputs for all 8 flights (32 accumulators) and one of 8
// slices of the contraction, the chunks of 4 rows s, s + 8, s + 16, ...; per
// chunk it loads the 4 rows' float4 of its outputs and the 8 flights'
// float4 of the vector: 12 16-byte loads for 128 multiply-adds, where a
// column a thread for 4 flights (the first design) took 2 for 4. A warp is
// 4 tiles x 8 slices: a quarter warp reads 64 contiguous bytes of two rows
// (the padded stride puts them on disjoint banks) and two vector chunks
// that it broadcasts. The 8 slices' sums meet in a fixed xor tree (lane
// offsets 16, 8, 1: ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7)))
// that also scatters them: slice s's lane ends with its tile's 4 outputs
// of flight s and runs their elementwise update itself, with 16-byte
// accesses. So each ADMM phase is one product, the tree, the update and one
// barrier, on ceil(n_out / 16) warps (N=20: 5 for t and U, 8 for G_X).
// Every sum runs in a fixed order (no atomics), so two launches agree bit
// for bit.
//
// What bounds it on an H100: at N=20 a flight-tick is about 0.13 M
// multiply-adds (set-up 24,720, each iteration 25,600, the refresh 25,600);
// at B=1024 with 10 iterations ~0.6 GFLOP, ~9 us at the card's 67 TFLOP/s
// FP32 rate. One block per SM, so an iteration costs its SM's issue of the
// products' loads and multiply-adds on 5 to 8 warps, the trees and three
// barriers: ~6,900 cycles at N=20 against the first design's 11,500, by the
// section clocks (the controller_clocks build; PERF.md). The set-up (a
// quarter of a launch) waits on L2: each block reads ~200 KB of operators.
// Measured on the card and not kept (PERF.md): each tile's contraction
// split over two warps, the next chunk's loads issued ahead and 256 threads
// (slower); one bulk copy per operator row (no faster, and one warp issuing
// them all slower).

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "section_clocks.cuh"
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

constexpr int kThreads = 256;     // K16's blocks
constexpr int kK8Threads = 512;   // ops/controller_pallas.py STRUCTURED_THREADS
constexpr int kFlights = 8;       // ops/controller_pallas.py FLIGHTS_PER_BLOCK
constexpr int kSlices = 8;        // lanes sharing one tile's contraction
constexpr int kTileOut = 4;       // outputs per tile
constexpr int kWarpOut = 16;      // outputs per warp: 4 tiles
constexpr int kPlaneLoads = 3;    // plane rows a thread loads at once
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// A row stride of at least n floats, a multiple of 4 and 4 mod 8 (ops/
// controller_pallas.py _stride48): rows k and k + 4 lie 16 banks apart.
__host__ __device__ __forceinline__ int stride48(int n) {
  const int r = round4(n);
  return (r & 7) ? r : r + 4;
}

// A row stride of at least n floats, 16 mod 32 (_stride16): rows f and
// f + 1 lie 16 banks apart.
__host__ __device__ __forceinline__ int stride16(int n) {
  return n <= 16 ? 16 : 16 + (n - 16 + 31) / 32 * 32;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void arr4(const float4& q, float v[4]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ void fma4(float acc[kTileOut], float s, const float4& a) {
  acc[0] = fmaf(s, a.x, acc[0]);
  acc[1] = fmaf(s, a.y, acc[1]);
  acc[2] = fmaf(s, a.z, acc[2]);
  acc[3] = fmaf(s, a.w, acc[3]);
}

// acc[f][j] = sum over this lane's chunks ch = s, s + 8, ... < nch, in
// order, of sum_{kk < 4} v[f * ldv + 4 ch + kk] * row4(4 ch + kk)[j]: the
// 4 rows of a chunk and its 8 vector chunks are loaded before its 128
// multiply-adds. kPrefetchRows (the set-up's operators, read from L2): the
// next chunk's rows are loaded while this one's multiply-adds run.
template <bool kPrefetchRows, class Row4>
__device__ __forceinline__ void tile_product(Row4 row4, int nch, const float* __restrict__ v,
                                             int ldv, int s, float acc[kFlights][kTileOut]) {
  float4 a[4];
  if constexpr (kPrefetchRows) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a[kk] = row4(4 * s + kk);
  }
  for (int ch = s; ch < nch; ch += kSlices) {
    float4 w[kFlights], an[4];
    if constexpr (kPrefetchRows) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) an[kk] = row4(4 * (ch + kSlices) + kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a[kk] = row4(4 * ch + kk);
    }
#pragma unroll
    for (int l = 0; l < kFlights; ++l) w[l] = ld4(v + (l ^ s) * ldv + 4 * ch);
#pragma unroll
    for (int l = 0; l < kFlights; ++l) {
      fma4(acc[l], w[l].x, a[0]);
      fma4(acc[l], w[l].y, a[1]);
      fma4(acc[l], w[l].z, a[2]);
      fma4(acc[l], w[l].w, a[3]);
    }
    if constexpr (kPrefetchRows) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a[kk] = an[kk];
    }
  }
}

// The 8 slices' sums of one tile (the lanes 16, 8 and 1 apart) in the xor
// tree, scattered by flight. Slice s's lane holds flight l ^ s in its
// accumulator l, so each round keeps its accumulators' lower half and sends
// the upper half, which the partner (slice s ^ 4, ^ 2, ^ 1) holds the same
// flights in: slice s's lane returns the 4 outputs of flight s, ((a_s +
// a_s^4) + (a_s^2 + a_s^6)) + ((a_s^1 + a_s^5) + (a_s^3 + a_s^7)) with a_q
// slice q's sum (each pair added in either order: the same float).
__device__ __forceinline__ void tile_reduce(const float acc[kFlights][kTileOut],
                                            float out[kTileOut]) {
  float r1[4][kTileOut], r2[2][kTileOut];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
#pragma unroll
    for (int j = 0; j < kTileOut; ++j) {
      r1[l][j] = acc[l][j] + __shfl_xor_sync(kFull, acc[4 + l][j], 16);
    }
  }
#pragma unroll
  for (int l = 0; l < 2; ++l) {
#pragma unroll
    for (int j = 0; j < kTileOut; ++j) r2[l][j] = r1[l][j] + __shfl_xor_sync(kFull, r1[2 + l][j], 8);
  }
#pragma unroll
  for (int j = 0; j < kTileOut; ++j) out[j] = r2[0][j] + __shfl_xor_sync(kFull, r2[1][j], 1);
}

// One product with its update: warps w, w + 16, ... < ceil(n_out / 16) take
// 4 tiles each; lane = 8 (s >> 1) + 2 (tile) + (s & 1). A lane whose tile
// starts at o0 < n_out forms its sums from row4(k, o0); every lane of such a
// warp joins the tree (its shuffles need the whole warp); then
// update(o0, f, out) for the tile's 4 outputs of flight f.
template <bool kPrefetchRows = false, class Row4, class Update>
__device__ __forceinline__ void product_phase(int n_out, int nch, const float* __restrict__ v,
                                              int ldv, int warp, int lane, Row4 row4,
                                              Update update) {
  const int warps = (n_out + kWarpOut - 1) / kWarpOut;
  const int s = 2 * (lane >> 3) + (lane & 1);
  for (int w = warp; w < warps; w += kK8Threads / 32) {
    const int o0 = w * kWarpOut + kTileOut * ((lane >> 1) & 3);
    float acc[kFlights][kTileOut] = {};
    if (o0 < n_out) {
      tile_product<kPrefetchRows>([&](int k) { return row4(k, o0); }, nch, v, ldv, s, acc);
    }
    float out[kTileOut];
    tile_reduce(acc, out);
    if (o0 < n_out) update(o0, s, out);
  }
}

// Outputs o0 .. o0 + 3 of row k of a row-major operand in device memory
// (K rows of n_out, row stride ld): one 16-byte load where the row is
// 16-byte aligned and the 4 outputs exist, else one load per output;
// zeros past the last row or output.
__device__ __forceinline__ float4 global_row4(const float* __restrict__ A, int ld, int K,
                                              int n_out, int k, int o0) {
  if (k >= K) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* p = A + static_cast<size_t>(k) * ld + o0;
  if ((ld & 3) == 0 && o0 + 4 <= n_out) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), o0 + 1 < n_out ? __ldg(p + 1) : 0.0f,
                     o0 + 2 < n_out ? __ldg(p + 2) : 0.0f, o0 + 3 < n_out ? __ldg(p + 3) : 0.0f);
}

__global__ void __launch_bounds__(kK8Threads, 1)
structured_batched_kernel(const __grid_constant__ StructuredParams P,
                          const __grid_constant__ StructuredOperands O) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int nth = kK8Threads;
  const int N = P.n, nu = P.nu, nx = P.nx, Nnu = N * nu, Nnx = N * nx;
  const int ldu = stride16(Nnu), ldx = stride16(Nnx);   // the iterates' rows
  const int lau = stride48(Nnu), lax = stride48(Nnx);   // the operators' rows
  const int rows_x = round4(Nnx);   // SuRow's rows, the padded ones zero
  const int b0 = blockIdx.x * kFlights;
  const float rho = P.rho, a = P.over_relax, am = P.one_minus_over_relax;
  // y / rho as a multiply: the IEEE division cost more than the rest of an update
  const float inv_rho = 1.0f / rho;
  SECTION_START(t_whole);

  // shared memory layout (ops/controller_pallas.py
  // structured_shared_memory_bytes); every array starts 16-byte aligned
  float* SuRow = sm;                        // (rows_x, lau)
  float* MinvT = SuRow + rows_x * lau;      // (Nnu, lau)
  float* SuT = MinvT + Nnu * lau;           // (Nnu, lax)
  float* loU = SuT + Nnu * lax;             // (ldu) each
  float* hiU = loU + ldu;
  float* xlo = hiU + ldu;                   // (ldx) each
  float* xhi = xlo + ldx;
  float* zU = xhi + ldx;                    // U-space iterates, (kFlights, ldu) each
  float* yU = zU + kFlights * ldu;
  float* vU = yU + kFlights * ldu;          // rho zU - yU
  float* fv = vU + kFlights * ldu;          // f
  float* tf = fv + kFlights * ldu;          // G'v - f
  float* Ub = tf + kFlights * ldu;          // U
  float* zX = Ub + kFlights * ldu;          // X-space iterates, (kFlights, ldx) each
  float* yX = zX + kFlights * ldx;
  float* vX = yX + kFlights * ldx;          // w at set-up, then rho zX - yX
  float* off = vX + kFlights * ldx;         // offset
  float* dref = off + kFlights * ldx;       // offset - ref; X_tail at the end
  float* x0s = dref + kFlights * ldx;       // (kFlights, 8)

  // ---- the operators' rows, 16 bytes per asynchronous copy (SuT's by the
  // threads where its rows are not 16-byte multiples, odd N) ------------------
  const int qu = Nnu / 4, qx = Nnx / 4;     // 16-byte units per row
  const bool sut_async = (Nnx & 3) == 0;
  for (int i = tid; i < (Nnx + Nnu) * qu + (sut_async ? Nnu * qx : 0); i += nth) {
    if (i < Nnx * qu) {
      uav::copy16_async(SuRow + (i / qu) * lau + 4 * (i % qu), O.SuRow + 4 * i);
    } else if (i < (Nnx + Nnu) * qu) {
      const int e = i - Nnx * qu;
      uav::copy16_async(MinvT + (e / qu) * lau + 4 * (e % qu), O.MinvT + 4 * e);
    } else {
      const int e = i - (Nnx + Nnu) * qu;
      uav::copy16_async(SuT + (e / qx) * lax + 4 * (e % qx), O.SuT + 4 * e);
    }
  }
  if (!sut_async) {
    for (int i = tid; i < Nnu * Nnx; i += nth) SuT[(i / Nnx) * lax + i % Nnx] = __ldg(O.SuT + i);
  }
  for (int i = tid; i < (rows_x - Nnx) * lau; i += nth) SuRow[Nnx * lau + i] = 0.0f;
  // SuT's padded columns, which G_X's last tile reads at odd N
  const int sut_pad = lax - Nnx;
  for (int i = tid; i < Nnu * sut_pad; i += nth) SuT[(i / sut_pad) * lax + Nnx + i % sut_pad] = 0.0f;

  // ---- bounds, the tile's shifted planes, x0 and w; zeros past the batch
  // and on the rows' padding --------------------------------------------------
  for (int i = tid; i < ldu; i += nth) {
    loU[i] = i < Nnu ? __ldg(O.u_lo + i) : 0.0f;
    hiU[i] = i < Nnu ? __ldg(O.u_hi + i) : 0.0f;
  }
  for (int i = tid; i < ldx; i += nth) {
    xlo[i] = i < Nnx ? __ldg(O.x_lo + i) : 0.0f;
    xhi[i] = i < Nnx ? __ldg(O.x_hi + i) : 0.0f;
  }
  // warm-start shift as an index remap: stage k takes stage k+1, the last
  // stage keeps its own values; every load of a thread in flight before its
  // stores (kPlaneLoads rows per thread cover N <= 26)
  for (int i0 = tid; i0 < kFlights * ldu; i0 += kPlaneLoads * nth) {
    float z[kPlaneLoads], y[kPlaneLoads];
#pragma unroll
    for (int u = 0; u < kPlaneLoads; ++u) {
      const int i = i0 + u * nth, f = i / ldu, c = i % ldu, b = b0 + f;
      const int src = b * Nnu + (c < Nnu - nu ? c + nu : c);
      const bool ok = i < kFlights * ldu && b < P.batch && c < Nnu;
      z[u] = ok ? O.ZU[src] : 0.0f;
      y[u] = ok ? O.YU[src] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kPlaneLoads; ++u) {
      const int i = i0 + u * nth;
      if (i < kFlights * ldu) {
        zU[i] = z[u];
        yU[i] = y[u];
      }
    }
  }
  for (int i0 = tid; i0 < kFlights * ldx; i0 += kPlaneLoads * nth) {
    float z[kPlaneLoads], y[kPlaneLoads], w[kPlaneLoads];
#pragma unroll
    for (int u = 0; u < kPlaneLoads; ++u) {
      const int i = i0 + u * nth, f = i / ldx, r = i % ldx, b = b0 + f;
      const int src = b * Nnx + (r < Nnx - nx ? r + nx : r);
      const bool ok = i < kFlights * ldx && b < P.batch && r < Nnx;
      z[u] = ok ? O.ZX[src] : 0.0f;
      y[u] = ok ? O.YX[src] : 0.0f;
      w[u] = ok ? O.W[b * P.w_stride + r] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kPlaneLoads; ++u) {
      const int i = i0 + u * nth;
      if (i < kFlights * ldx) {
        zX[i] = z[u];
        yX[i] = y[u];
        vX[i] = w[u];
        off[i] = 0.0f;
        dref[i] = 0.0f;
      }
    }
  }
  for (int i = tid; i < kFlights * 8; i += nth) {
    const int f = i / 8, c = i % 8, b = b0 + f;
    x0s[i] = b < P.batch && c < nx ? O.X0[b * nx + c] : 0.0f;
  }
  __syncthreads();
  SECTION_START(t_offset);
  if (tid == 0) SECTION_ADD(1, t_whole);

  // ---- offset = x0 SxT + w SwT; offset - ref ---------------------------------
  product_phase<true>(
      Nnx, rows_x / 4, vX, ldx, warp, lane,
      [&](int k, int o0) { return global_row4(O.SwT, Nnx, Nnx, Nnx, k, o0); },
      [&](int o0, int f, const float* aw) {
        const int b = b0 + f;
        float ax[kTileOut] = {};
#pragma unroll
        for (int k = 0; k < 8; ++k) {   // nx <= 8: every row's load in flight at once
          if (k >= nx) break;
          const float4 s4 = global_row4(O.SxT, Nnx, nx, Nnx, k, o0);
          const float x = x0s[f * 8 + k];
          ax[0] = fmaf(x, s4.x, ax[0]);
          ax[1] = fmaf(x, s4.y, ax[1]);
          ax[2] = fmaf(x, s4.z, ax[2]);
          ax[3] = fmaf(x, s4.w, ax[3]);
        }
        float o[kTileOut], d[kTileOut];
#pragma unroll
        for (int j = 0; j < kTileOut; ++j) {
          const int r = o0 + j;
          const bool in = r < Nnx;
          const float ref = in && b < P.batch ? O.REF[b * P.ref_stride + r] : 0.0f;
          o[j] = in ? ax[j] + aw[j] : 0.0f;
          d[j] = in ? o[j] - ref : 0.0f;
        }
        st4(off + f * ldx + o0, o);
        st4(dref + f * ldx + o0, d);
      });
  __syncthreads();
  SECTION_START(t_f);
  if (tid == 0) SECTION_ADD(2, t_offset);

  // ---- f = (offset - ref) SuTqT; the first matvec inputs ---------------------
  product_phase<true>(
      Nnu, rows_x / 4, dref, ldx, warp, lane,
      [&](int k, int o0) { return global_row4(O.SuTqT, Nnu, Nnx, Nnu, k, o0); },
      [&](int o0, int f, const float* acc) { st4(fv + f * ldu + o0, acc); });
  for (int i = tid; i < kFlights * ldu; i += nth) vU[i] = rho * zU[i] - yU[i];
  for (int i = tid; i < kFlights * ldx; i += nth) {
    vX[i] = i % ldx < Nnx ? rho * zX[i] - yX[i] : 0.0f;   // the padding stays zero
  }
  SECTION_START(t_wait);
  if (tid == 0) SECTION_ADD(3, t_f);
  uav::copies16_wait();   // this thread's rows of SuRow, MinvT and SuT have landed
  __syncthreads();
  if (tid == 0) SECTION_ADD(0, t_wait);

  const auto smem_rows = [](const float* A, int ld) {
    return [=](int k, int o0) { return ld4(A + k * ld + o0); };
  };
  // t - f = v_U + v_X SuRow - f on the U outputs
  const auto phase_t = [&] {
    product_phase(Nnu, rows_x / 4, vX, ldx, warp, lane, smem_rows(SuRow, lau),
                  [&](int o0, int f, const float* acc) {
                    const int k = f * ldu + o0;
                    float vu[4], fk[4], t[4];
                    arr4(ld4(vU + k), vu);
                    arr4(ld4(fv + k), fk);
#pragma unroll
                    for (int j = 0; j < kTileOut; ++j) t[j] = (vu[j] + acc[j]) - fk[j];
                    st4(tf + k, t);
                  });
  };

  // ---- ADMM iterations: three phases each -------------------------------------
  for (int it = 0; it < P.iterations; ++it) {
    SECTION_START(t_t);
    phase_t();
    __syncthreads();
    SECTION_START(t_u);
    if (tid == 0) SECTION_ADD(4, t_t);
    // U = (t - f) MinvT, then the U-space over-relaxation and projection
    product_phase(Nnu, Nnu / 4, tf, ldu, warp, lane, smem_rows(MinvT, lau),
                  [&](int o0, int f, const float* acc) {
                    const int k = f * ldu + o0;
                    float z[4], y[4], lo[4], hi[4], zn[4], yn[4], vn[4];
                    arr4(ld4(zU + k), z);
                    arr4(ld4(yU + k), y);
                    arr4(ld4(loU + o0), lo);
                    arr4(ld4(hiU + o0), hi);
#pragma unroll
                    for (int j = 0; j < kTileOut; ++j) {
                      const float Gt = a * acc[j] + am * z[j];
                      zn[j] = clipf(Gt + y[j] * inv_rho, lo[j], hi[j]);
                      yn[j] = y[j] + rho * (Gt - zn[j]);
                      vn[j] = rho * zn[j] - yn[j];
                    }
                    st4(Ub + k, acc);
                    st4(zU + k, zn);
                    st4(yU + k, yn);
                    st4(vU + k, vn);
                  });
    __syncthreads();
    SECTION_START(t_gx);
    if (tid == 0) SECTION_ADD(5, t_u);
    // G_X = U SuT, then the X-space over-relaxation and projection (the
    // padding of an odd horizon's last tile keeps v_X zero)
    product_phase(Nnx, Nnu / 4, Ub, ldu, warp, lane, smem_rows(SuT, lax),
                  [&](int o0, int f, const float* acc) {
                    const int k = f * ldx + o0;
                    float z[4], y[4], o[4], lo[4], hi[4], zn[4], yn[4], vn[4];
                    arr4(ld4(zX + k), z);
                    arr4(ld4(yX + k), y);
                    arr4(ld4(off + k), o);
                    arr4(ld4(xlo + o0), lo);
                    arr4(ld4(xhi + o0), hi);
#pragma unroll
                    for (int j = 0; j < kTileOut; ++j) {
                      const float Gt = a * acc[j] + am * z[j];
                      zn[j] = clipf(Gt + y[j] * inv_rho, lo[j] - o[j], hi[j] - o[j]);
                      yn[j] = y[j] + rho * (Gt - zn[j]);
                      vn[j] = o0 + j < Nnx ? rho * zn[j] - yn[j] : 0.0f;
                    }
                    st4(zX + k, zn);
                    st4(yX + k, yn);
                    st4(vX + k, vn);
                  });
    __syncthreads();
    if (tid == 0) SECTION_ADD(6, t_gx);
  }

  // ---- primal refresh from the last (z, y), X_tail (into dref), outputs ------
  SECTION_START(t_refresh);
  phase_t();
  __syncthreads();
  product_phase(Nnu, Nnu / 4, tf, ldu, warp, lane, smem_rows(MinvT, lau),
                [&](int o0, int f, const float* acc) { st4(Ub + f * ldu + o0, acc); });
  __syncthreads();
  product_phase(Nnx, Nnu / 4, Ub, ldu, warp, lane, smem_rows(SuT, lax),
                [&](int o0, int f, const float* acc) {
                  const int k = f * ldx + o0;
                  float o[4], xt[4];
                  arr4(ld4(off + k), o);
#pragma unroll
                  for (int j = 0; j < kTileOut; ++j) xt[j] = o[j] + acc[j];
                  st4(dref + k, xt);
                });
  __syncthreads();
  for (int i = tid; i < kFlights * Nnu; i += nth) {
    const int f = i / Nnu, c = i % Nnu, b = b0 + f, k = f * ldu + c;
    if (b < P.batch) {
      O.u_out[b * Nnu + c] = Ub[k];
      O.zu_out[b * Nnu + c] = zU[k];
      O.yu_out[b * Nnu + c] = yU[k];
    }
  }
  for (int i = tid; i < kFlights * Nnx; i += nth) {
    const int f = i / Nnx, r = i % Nnx, b = b0 + f, k = f * ldx + r;
    if (b < P.batch) {
      O.xtail_out[b * Nnx + r] = dref[k];
      O.zx_out[b * Nnx + r] = zX[k];
      O.yx_out[b * Nnx + r] = yX[k];
    }
  }
  if (tid == 0) {
    SECTION_ADD(7, t_refresh);
    SECTION_ADD(8, t_whole);
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
  structured_batched_kernel<<<blocks, kK8Threads, smem_bytes, (cudaStream_t)stream>>>(*params,
                                                                                      *ops);
  return (int)cudaGetLastError();
}

// K8's section counters (ops/controller_pallas.py STRUCTURED_SECTIONS),
// summed over the blocks since the last call, then reset
// (section_clocks.cuh).
extern "C" int structured_section_cycles(unsigned long long* out) {
  return uav::read_section_cycles(out, 9);
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
