// K7 (the fused GP posterior mean) and K15 (the blocked RBF Gram matrix).
//
// K15 rbf_gram_kernel replaces the JAX package's
// ops/rbf_pallas.py:rbf_kernel_matrix_pallas (pallas_call at :449, block
// _rbf_block_kernel at :29). Its plain version is the port's
// ops/rbf_pallas.py:rbf_kernel_matrix_plain (gp/kernels.py:rbf_kernel in
// float32):
//
//   out[i, j] = sigma^2 exp(-0.5 max(|z_i|^2 + |z_j|^2 - 2 z_i.z_j, 0)),
//   z = x / ls  (ls: one length scale per feature; a scalar is expanded)
//
// What bounds K15 on an H100: bytes. The output is written once, 4 n1 n2
// bytes (1.57 GB at the 19,800-point corpus, 468 us at 3.35 TB/s; a plain
// fill of that buffer takes ~480 us on an H100), the inputs are read once.
// The first design (one block per 64 x 64 tile, 96,100 blocks at the
// corpus; expf's full sequence, ~30 instructions an entry) ran 813 us
// there, near the SMs' issue limit as well as the bytes', and at the
// refit's 800 points left 169 blocks each loading, dividing and passing two
// barriers before its first store (6.22 us).
//
// Design: persistent blocks, three of 256 threads on each SM (no more than
// the tiles), each walking an even share of the 64 x 64 output tiles in
// row-major order (ops/rbf_pallas.py gram_geometry), so a block scales its
// 64 rows of X1 once per tile row and the X2 columns of each tile once:
// - every thread divides its share of a tile's elements by the length
//   scales (z = x / l) into shared memory, the next-but-one tile's loaded
//   into registers under the current tile's stores; threads 0-63 then take
//   each column's half norm h = 0.5 sum_k w_k z_k, w = log2(e) z (one FMA
//   chain over the features), a tile ahead; one barrier a tile (X2's
//   scaled tiles triple-buffered, their norms double-buffered);
// - a tile row's X1 is held as w in shared memory with its half norms;
// - an entry is then its dot (sum_k w1_k z2_k, the same FMA chain as the
//   half norms), two adds, the clamp and one ex2.approx, then sigma^2:
//
//     out = sigma^2 2^min((dot - h1) - h2, 0),  (dot - h1) - h2 = -0.5 log2(e) dist
//
//   For coincident points (z1 = z2) the dot equals 2 h1 = 2 h2 bit for bit,
//   so the exponent is 0 exactly and the entry exactly sigma^2 (the JAX
//   clamp at 0; the Gram's diagonal). One add more than folding h1 into
//   the chain's start would take, which would lose that exactness;
// - each thread computes a 4 x 4 micro-tile (rows 4 ty + r, columns 4 tx +
//   q): per feature two 16-byte shared loads and 16 FMAs; rows go out as
//   16-byte streaming stores (st.global.cs: the output does not stay in
//   L2), scalar ones at a ragged edge or where n2 is not a multiple of 4.
// Features are padded to a multiple of 4 past 10 (zeros on both sides add
// exact zeros).
//
// K7 rbf_posterior_mean_kernel replaces the JAX package's
// ops/rbf_pallas.py:rbf_posterior_mean_pallas
// (pallas_call at :342, row tier, and :406, packed tiers). Its plain
// version is the port's ops/rbf_pallas.py:rbf_posterior_mean_plain.
//
//   out[q] = sum_p exp(-0.5 max(|z_q|^2 + |z_p|^2 - 2 z_q.z_p, 0)) a[p] + y_mean
//   z_q = (x_q - shift) / ls,  z_p = x_p / ls,  a = sigma^2 alpha y_std
//
// Two matrix products with an exp between them (a flash-attention shape
// with a head width of 10 and a value width of 6), both on the tensor
// cores with mma.sync in 3xTF32 (hi.hi + hi.lo + lo.hi, each operand split
// into two TF32 parts), the exp tile passed from the first product's
// accumulators to the second's A operand in registers:
//
// - The cross product: with c = -0.5 log2(e) folded into the operands, one
//   m16n8k8 (features 0-7) and one m16n8k4 (features 8, 9 and a column that
//   carries c |z_p|^2 against a query column of ones) per 16-query x
//   8-point tile and part (the k4 part's two small parts go as one k8), the
//   accumulator starting at c |z_q|^2: it ends at
//   c (|z_q|^2 + |z_p|^2 - 2 z_q.z_p), so the clamp at 0 is a min and the
//   exp one ex2.approx on the SFU. The training side is packed once per
//   posterior (ops/rbf_pallas.py:pack_posterior_tiles) in the fragments'
//   lane order: a lane reads its B fragments of a tile as two 16-byte and
//   one 8-byte load.
// - The value product: one m16n8k8 per tile (k = the tile's 8 points, n =
//   the 6 outputs padded to 8). The cross product's accumulator holds the
//   exp tile's columns (2t, 2t + 1) in lane t of a quad, the value
//   product's A operand wants columns (t, t + 4): the points of the value
//   operand are packed in that permuted order, so each lane's four exps are
//   its A fragment as they stand. The exps are split with Dekker's product
//   (round-to-nearest, no fused multiply-add).
// - Work: one launch is one wave, a block of 8 warps on each SM, each block
//   an even share of the 16-query tiles, in rounds of 10 (5 a warp). Warp w
//   takes query tiles (w / 4) + 2i of the round and point tiles w % 4,
//   w % 4 + 4, ...: the four warp columns split the points, and their sums
//   meet in shared memory in a fixed order, ((c0 + c1) + (c2 + c3)), then
//   y_mean: a second launch is bit-identical.
// - The queries: each round's rows are loaded once per block (coalesced,
//   every load in flight), scaled once per element, and c |z_q|^2 summed
//   once per row into shared memory, where each warp reads its fragments.
// - The training set: chunks of 4 point tiles (32 points, 5 KB), each a
//   bulk copy (cp.async.bulk, the SM's copy engine) completing on its own
//   transaction barrier, issued when the block starts by a lane of each
//   warp, so the first chunks arrive while the warps stage their queries
//   and later ones while they compute. Up to 1312 points the whole set
//   stays resident for the launch (P = 800: 25 chunks, 148,736 bytes); past
//   that the chunks stream through a ring of stages whose two halves are
//   refilled in turns (double-buffered), so P has no limit.
//   ops/rbf_pallas.py:posterior_mean_layout computes the layout.
// - Masked training rows at the 1e6 sentinel carry c |z_p|^2 ~ -1e13 (the
//   packing clamps it at -1e34, so its TF32 parts stay finite): the
//   accumulator is hugely negative and ex2 returns 0 exactly. Zero points
//   pad the last chunk; their value rows are 0.
//
// What bounds it on an H100: in the plain form, operations. Per (query,
// training point) pair the work is ~38 FP32 operations (10-term dot,
// distance, exp, 6-term accumulate); at m = 20480, P = 800 that is ~0.62
// GFLOP, 9.3 us at 67 TFLOP/s. On the units this design uses: the
// products' 32 of those operations at the TF32 tensor rate, tripled for
// 3xTF32 (3.2 us), the 16.4 M exps at the SFU's 16 a clock per SM (3.9
// us), the clamp and the rest of the distance on the FP32 pipe (1.2 us);
// the bytes (queries, the packed training set, outputs) are ~1.5 MB. What
// it meets in practice is the rate at which mma.sync issues TF32 products
// (cycles per block by section: chip_smoke.py, the rbf_clocks build); the
// 5 cross-product and 3 value-product instructions per 16 x 8 tile carry
// the padding to 12 features and 8 outputs.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "section_clocks.cuh"

// Host-visible: laid out as ops/rbf_pallas.py's _MeanOperands and
// _GramOperands.
struct MeanOperands {
  const float *X, *tiles, *y_mean, *ls, *shift;
  float* out;
};

struct GramOperands {
  const float *X1, *X2, *ls, *sig;
  float* out;
};

namespace {

constexpr int kD = 10;            // features (ops/rbf_pallas.py KERNEL_FEATURES)
constexpr int kOut = 6;           // outputs (KERNEL_OUTPUTS)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColumns = 4;       // warps splitting a chunk's point tiles (WARP_COLUMNS)
constexpr int kTilesPerWarp = 5;  // 16-query tiles a warp holds
constexpr int kRoundTiles = (kWarps / kColumns) * kTilesPerWarp;   // ROUND_TILES
constexpr int kTileFloats = 320;  // one 8-point tile's fragments (TILE_FLOATS)
constexpr int kChunkTiles = 4;    // CHUNK_TILES
constexpr int kChunkFloats = kChunkTiles * kTileFloats;
constexpr unsigned kChunkBytes = 4u * kChunkFloats;
constexpr int kReduceFloats = kColumns * kRoundTiles * 16 * 8;   // REDUCE_BYTES / 4
constexpr float kExp2Scale = -0.72134752044448170f;   // -0.5 log2(e) (EXP2_SCALE)
static_assert(kChunkTiles == kColumns, "a chunk gives each warp column one point tile");
static_assert(kD == 10 && kOut <= 8, "the fragments below assume 10 features, 8 outputs");
static_assert(kRoundTiles * 16 * (kD + 1) <= kReduceFloats,
              "a round's staged queries fit the reduction's buffer");

// x rounded to TF32 (10-bit mantissa), to nearest with ties away from
// zero: cvt.rna.tf32.f32 on the float32 bits.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d = a b + c on the tensor cores, TF32 operands, float32 accumulators.
// Fragments (lane = 4 g + t): a (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4); b (8 x 8) b0 (t, g), b1 (t + 4, g); c, d (16
// x 8) (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_k8(float d[4], const unsigned a[4], unsigned b0, unsigned b1,
                                       const float c[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// The same for k = 4: a (16 x 4) a0 (g, t), a1 (g + 8, t); b (4 x 8) b0 (t, g).
__device__ __forceinline__ void mma_k4(float d[4], const unsigned a[2], unsigned b0,
                                       const float c[4]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%7,%8,%9,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One 16-query tile of a warp: its A fragments of the cross product (hi
// and lo parts; the k4 columns are features 8, 9, then 1 against c |z_p|^2
// and 0), c |z_q|^2 as the accumulator's start, and the value sums.
struct QueryTile {
  unsigned a8h[4], a8l[4], a4h[2], a4l[2];
  float csq[4];
  float o[4];
};

// A tile's fragments from the round's staged queries: z (row-major, kD a
// row) and c |z|^2 a row.
__device__ __forceinline__ void load_query_tile(const float* zs, const float* csq, int row0,
                                                int g, int t, QueryTile& Q) {
  float z[2][3];   // rows g, g + 8; features t, t + 4, 8 + t (t < 2)
  float sq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* zr = zs + (row0 + g + 8 * r) * kD;
    z[r][0] = zr[t];
    z[r][1] = zr[t + 4];
    z[r][2] = t < 2 ? zr[8 + t] : 0.0f;
    sq[r] = csq[row0 + g + 8 * r];
  }
  const unsigned one = __float_as_uint(1.0f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const unsigned hi = tf32_rna(z[r][f]);
      Q.a8h[r + 2 * f] = hi;
      Q.a8l[r + 2 * f] = tf32_rna(z[r][f] - __uint_as_float(hi));
    }
    const unsigned hi = tf32_rna(z[r][2]);
    Q.a4h[r] = t < 2 ? hi : t == 2 ? one : 0u;
    Q.a4l[r] = t < 2 ? tf32_rna(z[r][2] - __uint_as_float(hi)) : 0u;
    Q.csq[2 * r] = Q.csq[2 * r + 1] = sq[r];
    Q.o[2 * r] = Q.o[2 * r + 1] = 0.0f;
  }
}

#ifdef UAV_SECTION_CLOCKS
// The clocks build waits for a phase's results before it reads the clock
// (an instruction that uses them), so each phase is charged its own time.
#define K7_SETTLE(x) asm volatile("add.f32 %0, %0, 0f00000000;" : "+f"(x))
#define K7_CLOCK(var) const long long var = clock64()
#define K7_CHARGE(i, from, to) clocks[i] += (to) - (from)
#else
#define K7_SETTLE(x)
#define K7_CLOCK(var)
#define K7_CHARGE(i, from, to)
#endif

// One chunk of the training set against a warp's first kQ query tiles of
// the round (the valid ones, a prefix: no branch between the tiles' MMA
// chains, which the scheduler interleaves), phase by phase.
template <int kQ>
__device__ __forceinline__ void chunk_tile(QueryTile (&Q)[kTilesPerWarp], const float* tile,
                                           int lane, long long (&clocks)[9]) {
  (void)clocks;
  K7_CLOCK(c1);
  const float4 cr = reinterpret_cast<const float4*>(tile)[lane];
  const float4 va = reinterpret_cast<const float4*>(tile + 128)[lane];
  const float2 k4 = reinterpret_cast<const float2*>(tile + 256)[lane];
  const unsigned b8h0 = __float_as_uint(cr.x), b8h1 = __float_as_uint(cr.y);
  const unsigned b8l0 = __float_as_uint(cr.z), b8l1 = __float_as_uint(cr.w);
  const unsigned b4h = __float_as_uint(k4.x), b4l = __float_as_uint(k4.y);
  const unsigned vh0 = __float_as_uint(va.x), vh1 = __float_as_uint(va.y);
  const unsigned vl0 = __float_as_uint(va.z), vl1 = __float_as_uint(va.w);

  // the cross product: c (|z_q|^2 + |z_p|^2 - 2 z_q.z_p), the small parts
  // first; features 8-11's two small parts as one k = 8 product, [lo | hi]
  // against [hi ; lo] (the registers as they stand: a lane's k4 pair is
  // its B fragment's rows t and t + 4)
  float s[kTilesPerWarp][4];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const unsigned a4[4] = {Q[q].a4l[0], Q[q].a4l[1], Q[q].a4h[0], Q[q].a4h[1]};
    mma_k8(s[q], Q[q].a8l, b8h0, b8h1, Q[q].csq);
    mma_k8(s[q], Q[q].a8h, b8l0, b8l1, s[q]);
    mma_k8(s[q], a4, b4h, b4l, s[q]);
    mma_k8(s[q], Q[q].a8h, b8h0, b8h1, s[q]);
    mma_k4(s[q], Q[q].a4h, b4h, s[q]);
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) K7_SETTLE(s[q][3]);
  K7_CLOCK(c2);
  K7_CHARGE(1, c1, c2);

  // the clamp at 0, the exp, and the split of each exp (Dekker's, no fused
  // multiply-add): the accumulator's (2t, 2t + 1) columns are the value
  // product's A columns (t, t + 4) as the points are packed
  unsigned kh[kTilesPerWarp][4], kl[kTilesPerWarp][4];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float k = ex2_approx(fminf(s[q][e], 0.0f));
      const float c = __fmul_rn(k, 8193.0f);
      const float hi = __fsub_rn(c, __fsub_rn(c, k));
      const int a = e == 0 ? 0 : e == 1 ? 2 : e == 2 ? 1 : 3;   // A fragment slot
      kh[q][a] = __float_as_uint(hi);
      kl[q][a] = __float_as_uint(__fsub_rn(k, hi));
    }
  }
#ifdef UAV_SECTION_CLOCKS
#pragma unroll
  for (int q = 0; q < kQ; ++q) K7_SETTLE(*reinterpret_cast<float*>(&kl[q][3]));
#endif
  K7_CLOCK(c3);
  K7_CHARGE(2, c2, c3);

  // the value product, the small parts first
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    mma_k8(Q[q].o, kl[q], vh0, vh1, Q[q].o);
    mma_k8(Q[q].o, kh[q], vl0, vl1, Q[q].o);
    mma_k8(Q[q].o, kh[q], vh0, vh1, Q[q].o);
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) K7_SETTLE(Q[q].o[3]);
  K7_CLOCK(c4);
  K7_CHARGE(3, c3, c4);
}

__global__ void __launch_bounds__(kThreads, 1)
rbf_posterior_mean_kernel(const MeanOperands O, int m, int chunks, int stages, int resident) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  float* red = reinterpret_cast<float*>(smem + (8 * stages + 127) / 128 * 128);
  float* slots = red + kReduceFloats;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col = warp % kColumns, row_group = warp / kColumns;
  long long clocks[9] = {};   // the clocks build's sections
  (void)clocks;
  K7_CLOCK(t_start);

  // this block's even share of the 16-query tiles, in rounds of kRoundTiles
  const int query_tiles = (m + 15) / 16;
  const int T0 = (int)((long long)blockIdx.x * query_tiles / gridDim.x);
  const int T1 = (int)((long long)(blockIdx.x + 1) * query_tiles / gridDim.x);
  const int rounds = (T1 - T0 + kRoundTiles - 1) / kRoundTiles;
  // the chunks the block reads: once if they stay resident, else once a round
  const int total = resident ? chunks : rounds * chunks;
  const int half = stages / 2;

  auto issue = [&](int n, int slot) {   // chunk n of the stream into stage slot
    uav::barrier_expect(bars + slot, kChunkBytes);
    uav::copy_from_global(slots + slot * kChunkFloats, O.tiles + (n % chunks) * kChunkFloats,
                          kChunkBytes, bars + slot);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) uav::barrier_init(bars + s, 1);
    uav::fence_barrier_init();
  }
  __syncthreads();
  // the first copies, a lane of each warp issuing its share
  if (lane == 0)
    for (int n = warp; n < stages && n < total; n += kWarps) issue(n, n);
  K7_CLOCK(t_issued);
  K7_CHARGE(8, t_start, t_issued);

  int slot = 0, n = 0;   // the next chunk's stage, and how many were read
  unsigned parity = 0;   // the phase of that stage's barrier
  for (int round = 0; round < rounds; ++round) {
    K7_CLOCK(r0);
    const int q_base = (T0 + round * kRoundTiles) * 16;
    const int nq = min(min(m, T1 * 16) - q_base, kRoundTiles * 16);
    // the round's queries, each scaled once, into shared memory (red, free
    // until the round ends), every load in flight at once: z = (x - shift)
    // / ls, then c |z|^2 a row, summed as a quad of lanes would, (s0 + s1)
    // + (s2 + s3) with lane t's s = z_t^2 + z_(t+4)^2 (+ z_(8+t)^2)
    constexpr int kRows = kRoundTiles * 16;
    constexpr int kRowLoads = (kRows * kD + kThreads - 1) / kThreads;
    float* zs = red;
    float* csq = red + kRows * kD;
    float x[kRowLoads];
#pragma unroll
    for (int k = 0; k < kRowLoads; ++k) {
      const int e = tid + k * kThreads;
      x[k] = e < nq * kD ? __ldg(O.X + (size_t)q_base * kD + e) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kRowLoads; ++k) {
      const int e = tid + k * kThreads, c = e % kD;
      if (e < kRows * kD)
        zs[e] = e < nq * kD ? (x[k] - __ldg(O.shift + c)) / __ldg(O.ls + c) : 0.0f;
    }
    __syncthreads();
    if (tid < kRows) {
      const float* zr = zs + tid * kD;
      float part[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        part[q] = zr[q] * zr[q];
        part[q] = fmaf(zr[q + 4], zr[q + 4], part[q]);
        if (q < 2) part[q] = fmaf(zr[8 + q], zr[8 + q], part[q]);
      }
      csq[tid] = kExp2Scale * ((part[0] + part[1]) + (part[2] + part[3]));
    }
    __syncthreads();
    // the warp's tiles of the round: row_group + 2i, the valid ones a prefix
    const int first = T0 + round * kRoundTiles + row_group;
    const int valid = max(0, min(kTilesPerWarp, (T1 - first + 1) / 2));
    QueryTile Q[kTilesPerWarp];
#pragma unroll
    for (int i = 0; i < kTilesPerWarp; ++i)
      load_query_tile(zs, csq, (row_group + 2 * (i < valid ? i : 0)) * 16, g, t, Q[i]);
    __syncthreads();   // red is free again
    K7_CLOCK(r1);
    K7_CHARGE(6, r0, r1);
    if (resident) slot = 0, parity = 0;   // the same chunks again

    for (int i = 0; i < chunks; ++i) {
      K7_CLOCK(c0);
      uav::barrier_wait(bars + slot, parity);
      K7_CLOCK(c1);
      K7_CHARGE(0, c0, c1);
      const float* tile = slots + slot * kChunkFloats + col * kTileFloats;
      switch (valid) {
        case 5: chunk_tile<5>(Q, tile, lane, clocks); break;
        case 4: chunk_tile<4>(Q, tile, lane, clocks); break;
        case 3: chunk_tile<3>(Q, tile, lane, clocks); break;
        case 2: chunk_tile<2>(Q, tile, lane, clocks); break;
        case 1: chunk_tile<1>(Q, tile, lane, clocks); break;
        default: break;
      }
      ++n;
      if (++slot == stages) slot = 0, parity ^= 1u;

      // past the resident set: once every warp is through a half of the
      // ring, refill it while the other half is computed
      if (!resident && (slot == 0 || slot == half) && n - half + stages < total) {
        __syncthreads();
        if (tid == 0) {
          uav::fence_for_copies();
          const int first_slot = slot == 0 ? half : 0;
          for (int k = 0; k < half && n - half + stages + k < total; ++k)
            issue(n - half + stages + k, first_slot + k);
        }
      }
    }

    // the four warp columns' sums meet in a fixed order, then y_mean
    K7_CLOCK(c5);
#pragma unroll
    for (int q = 0; q < kTilesPerWarp; ++q) {
      if (q >= valid) break;
      float* dst = red + (col * kRoundTiles * 16 + (row_group + 2 * q) * 16 + g) * 8 + 2 * t;
      *reinterpret_cast<float2*>(dst) = make_float2(Q[q].o[0], Q[q].o[1]);
      *reinterpret_cast<float2*>(dst + 64) = make_float2(Q[q].o[2], Q[q].o[3]);
    }
    __syncthreads();
    K7_CLOCK(c6);
    K7_CHARGE(4, c5, c6);
    constexpr int kColFloats = kRoundTiles * 16 * 8;
    for (int e = tid; e < nq * kOut; e += kThreads) {
      const int ql = e / kOut, o = e - ql * kOut;
      const float* r = red + ql * 8 + o;
      const float v = (r[0] + r[kColFloats]) + (r[2 * kColFloats] + r[3 * kColFloats]);
      O.out[(size_t)q_base * kOut + e] = v + __ldg(O.y_mean + o);
    }
    __syncthreads();   // red is free for the next round
    K7_CLOCK(c7);
    K7_CHARGE(5, c6, c7);
  }
#ifdef UAV_SECTION_CLOCKS
  if (tid == 0) {
    clocks[7] = clock64() - t_start;
    for (int i = 0; i < 9; ++i) atomicAdd(&uav::g_section_cycles[i], (unsigned long long)clocks[i]);
    atomicAdd(&uav::g_section_cycles[9], 1ull);
  }
#endif
}

// ---- K15 -----------------------------------------------------------------

constexpr int kGramMaxD = 16;          // ops/rbf_pallas.py GRAM_MAX_FEATURES
constexpr int kGramTile = 64;          // GRAM_TILE: output rows and columns per tile
constexpr int kGramThreads = 256;      // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kGramBlocksPerSM = 3;    // GRAM_BLOCKS_PER_SM
constexpr float kLog2e = 1.4426950408889634f;

// One block walks the output tiles [t0, t1) of the row-major order of 64 x
// 64 tiles; kD is the features d, or d rounded up to a multiple of 4 (the
// padded features are 0 on both sides and add nothing). Thread (ty, tx)
// computes rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of a tile;
// a warp's 16-byte stores cover two rows of 256 contiguous bytes.
template <int kD>
__global__ void __launch_bounds__(kGramThreads, kGramBlocksPerSM)
rbf_gram_kernel(const GramOperands O, int n1, int n2, int d, int ls_stride) {
  constexpr int kRaw = (kGramTile * kD + kGramThreads - 1) / kGramThreads;   // a thread's X2 elements
  __shared__ __align__(16) float z2s[3][kD][kGramTile];   // X2 tiles, scaled, by feature
  __shared__ __align__(16) float h2s[2][kGramTile];       // their columns' half norms
  __shared__ __align__(16) float w1s[kD][kGramTile];      // the tile row's X1, log2(e) z
  __shared__ __align__(16) float h1s[kGramTile];          // its rows' half norms
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tiles_c = (n2 + kGramTile - 1) / kGramTile;
  const long long tiles = (long long)tiles_c * ((n1 + kGramTile - 1) / kGramTile);
  const int t0 = (int)(blockIdx.x * tiles / gridDim.x);
  const int t1 = (int)((blockIdx.x + 1) * tiles / gridDim.x);
  const float sig = __ldg(O.sig);

  // z = x / l, elementwise over all threads (X's own order, a point's
  // features together); w = log2(e) z. A point's half norm 0.5 sum_k w_k z_k
  // and a pair's dot sum_k w1_k z2_k are the same FMA chain over the
  // features (one thread's), so for coincident points the exponent below is
  // 0 exactly.
  auto fetch = [&](int t, float (&raw)[kRaw]) {
    const int c0 = (t % tiles_c) * kGramTile;
#pragma unroll
    for (int e = 0; e < kRaw; ++e) {
      const int i = tid + e * kGramThreads, c = i / kD, k = i - c * kD;
      raw[e] = i < kGramTile * kD && c0 + c < n2 && k < d
                   ? __ldg(O.X2 + (size_t)(c0 + c) * d + k)
                   : 0.0f;
    }
  };
  auto scale = [&](const float (&raw)[kRaw], int buf) {
#pragma unroll
    for (int e = 0; e < kRaw; ++e) {
      const int i = tid + e * kGramThreads, c = i / kD, k = i - c * kD;
      if (i < kGramTile * kD) z2s[buf][k][c] = k < d ? raw[e] / __ldg(O.ls + k * ls_stride) : 0.0f;
    }
  };
  auto norms = [&](int buf3, int buf2, int thread) {   // columns by threads thread .. + 63
    const int c = tid - thread;
    if (c >= 0 && c < kGramTile) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const float z = z2s[buf3][k][c];
        s = fmaf(kLog2e * z, z, s);
      }
      h2s[buf2][c] = 0.5f * s;
    }
  };
  auto scale_rows = [&](int tr) {   // then a barrier, then chain_rows
    for (int i = tid; i < kGramTile * kD; i += kGramThreads) {
      const int r = i / kD, k = i - r * kD, row = tr * kGramTile + r;
      w1s[k][r] = row < n1 && k < d
                      ? __ldg(O.X1 + (size_t)row * d + k) / __ldg(O.ls + k * ls_stride)
                      : 0.0f;
    }
  };
  auto chain_rows = [&] {   // rows by threads 0-63, then a barrier
    if (tid < kGramTile) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const float z = w1s[k][tid], w = kLog2e * z;
        s = fmaf(w, z, s);
        w1s[k][tid] = w;
      }
      h1s[tid] = 0.5f * s;
    }
  };

  if (t0 >= t1) return;
  float raw[kRaw], raw1[kRaw];
  fetch(t0, raw);
  if (t0 + 1 < t1) fetch(t0 + 1, raw1);
  int row_tile = t0 / tiles_c;
  scale_rows(row_tile);
  scale(raw, 0);
  if (t0 + 1 < t1) scale(raw1, 1);
  __syncthreads();
  chain_rows();
  norms(0, 0, kGramTile);
  __syncthreads();
  // tile t: z2s[t % 3], h2s[t % 2]; tile t + 1's z2s scaled, its norms
  // taken here; tile t + 2's elements loaded under this tile's stores
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0;
    if (t + 2 < t1) fetch(t + 2, raw);
    if (t + 1 < t1) norms((i + 1) % 3, (i + 1) & 1, 0);
    const int tr = t / tiles_c, tc = t - tr * tiles_c;
    if (tr != row_tile) {   // the same for the whole block
      row_tile = tr;
      scale_rows(tr);
      __syncthreads();
      chain_rows();
      __syncthreads();
    }
    const int b3 = i % 3, b2 = i & 1;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&w1s[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&z2s[b3][k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(av[r], b.x, acc[r][0]);
        acc[r][1] = fmaf(av[r], b.y, acc[r][1]);
        acc[r][2] = fmaf(av[r], b.z, acc[r][2]);
        acc[r][3] = fmaf(av[r], b.w, acc[r][3]);
      }
    }
    // log2(e) (-0.5 the squared distance) = (dot - h1) - h2, clamped at 0
    // (the distance's clamp), one ex2, then sigma^2; streaming stores
    const float4 h1 = *reinterpret_cast<const float4*>(&h1s[4 * ty]);
    const float4 h2 = *reinterpret_cast<const float4*>(&h2s[b2][4 * tx]);
    const float h1v[4] = {h1.x, h1.y, h1.z, h1.w}, h2v[4] = {h2.x, h2.y, h2.z, h2.w};
    const int col = tc * kGramTile + 4 * tx;
    const bool vec = (n2 & 3) == 0 && col < n2;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = tr * kGramTile + 4 * ty + r;
      if (row >= n1) continue;
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = sig * ex2_approx(fminf((acc[r][q] - h1v[r]) - h2v[q], 0.0f));
      float* dst = O.out + (size_t)row * n2 + col;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(dst), make_float4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < n2) __stcs(dst + q, o[q]);
      }
    }
    if (t + 2 < t1) scale(raw, (i + 2) % 3);
    __syncthreads();
  }
}

}  // namespace

extern "C" int rbf_posterior_mean_launch(const MeanOperands* ops, int m, int chunks,
                                         int stages, int resident, int grid, int smem_bytes,
                                         void* stream) {
  static int opted = 0;
  if (smem_bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        rbf_posterior_mean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    opted = smem_bytes;
  }
  rbf_posterior_mean_kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      *ops, m, chunks, stages, resident);
  return (int)cudaGetLastError();
}

// The per-section clock cycles since the last call (the sections, the
// whole block, the copies' issue, the blocks counted; ops/rbf_pallas.py:
// posterior_mean_section_cycles), then reset.
extern "C" int rbf_posterior_mean_section_cycles(unsigned long long* out) {
  return uav::read_section_cycles(out, 10);
}

// K15 on `grid` blocks (ops/rbf_pallas.py gram_geometry: at most
// kGramBlocksPerSM per SM, no more than the tiles), d <= kGramMaxD; the
// length scales ls[k ls_stride] (ls_stride 0: one for every feature).
extern "C" int rbf_gram_launch(const GramOperands* ops, int n1, int n2, int d, int ls_stride,
                               int grid, void* stream) {
  if (d < 1 || d > kGramMaxD) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const GramOperands O = *ops;
  if (d <= 4) {
    rbf_gram_kernel<4><<<grid, kGramThreads, 0, s>>>(O, n1, n2, d, ls_stride);
  } else if (d <= 8) {
    rbf_gram_kernel<8><<<grid, kGramThreads, 0, s>>>(O, n1, n2, d, ls_stride);
  } else if (d <= 10) {
    rbf_gram_kernel<10><<<grid, kGramThreads, 0, s>>>(O, n1, n2, d, ls_stride);
  } else if (d <= 12) {
    rbf_gram_kernel<12><<<grid, kGramThreads, 0, s>>>(O, n1, n2, d, ls_stride);
  } else {
    rbf_gram_kernel<16><<<grid, kGramThreads, 0, s>>>(O, n1, n2, d, ls_stride);
  }
  return (int)cudaGetLastError();
}
