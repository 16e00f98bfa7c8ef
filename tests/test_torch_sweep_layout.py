"""The host-side layout of the structured batched controller K8
(``gpmpc_controller_structured_batched``) on its register tiles, and the
arithmetic of its summation order, on the CPU (no card or ``nvcc``):

- K8's block (8 flights) fits one H100 block (232,448 bytes) up to N=26,
  not N=27; the operators' row strides put the two rows a quarter warp
  reads on disjoint banks; the operators' rows are copied 16 bytes at a
  time where they are whole 16-byte units;
- the xor tree that meets a tile's 8 slice sums leaves slice s's lane with
  flight s's sums, each ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7)),
  the same in every lane that holds it (lanes simulated bit for bit);
- a float32 emulation of the kernel's sums (each product's contraction in
  chunks of 4 rows dealt to 8 slices, fused multiply-adds in order within
  a slice, the slices in the tree) holds
  ``gpmpc_controller_structured_batched_plain`` within ``K8_TOL`` (1e-4,
  ``chip_smoke.py``), the bar the card check holds K8 to, at an even and
  an odd horizon and a batch with a tail tile.
"""

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.ops import controller_pallas

torch.set_num_threads(1)

SMEM_LIMIT = 232448   # one H100 block's opt-in shared memory
K8_TOL = 1e-4
NU, NX = 4, 6
SLICES = 8            # csrc/controller_kernels.cu kSlices
r4 = lambda n: (n + 3) // 4 * 4


@pytest.mark.parametrize("N", [20, 21, 22, 23, 24, 25, 26])
def test_k8_block_fits_to_horizon_26(N):
    Nnu, Nnx = N * NU, N * NX
    lau, lax = controller_pallas._stride48(Nnu), controller_pallas._stride48(Nnx)
    ldu, ldx = controller_pallas._stride16(Nnu), controller_pallas._stride16(Nnx)
    F = controller_pallas.FLIGHTS_PER_BLOCK
    # SuRow (rows rounded up to 4), MinvT, SuT; the U and X bounds; six
    # U-space and five X-space rows per flight and x0
    floats = (r4(Nnx) * lau + Nnu * lau + Nnu * lax + 2 * ldu + 2 * ldx
              + F * (6 * ldu + 5 * ldx + 8))
    assert controller_pallas.structured_shared_memory_bytes(N) == 4 * floats <= SMEM_LIMIT
    assert controller_pallas.structured_shared_memory_bytes(27) > SMEM_LIMIT


@pytest.mark.parametrize("N", range(1, 27))
def test_k8_operator_rows_and_copies(N):
    Nnu, Nnx = N * NU, N * NX
    for n in (Nnu, Nnx):
        ld = controller_pallas._stride48(n)
        # a multiple of 4 (16-byte rows), 4 mod 8: rows k and k + 4 lie 16
        # banks apart, so a quarter warp's two 64-byte runs share no bank
        assert ld >= n and ld % 4 == 0 and ld % 8 == 4 and (4 * ld) % 32 == 16
        # the per-flight rows: flights f and f + 1 lie 16 banks apart, with
        # room for the last tile's 4 outputs
        ldv = controller_pallas._stride16(n)
        assert ldv >= r4(n) and ldv % 32 == 16 and ldv - r4(n) < 32
    # SuRow and MinvT rows (Nnu floats) always go 16 bytes at a time, SuT's
    # (Nnx floats) where they are whole 16-byte units (even N)
    assert (4 * Nnu) % 16 == 0
    assert (Nnx % 4 == 0) == ((4 * Nnx) % 16 == 0) == (N % 2 == 0)
    # warps of 16 outputs: every output in exactly one tile
    for n_out in (Nnu, Nnx):
        tiles = [o0 for w in range(-(-n_out // 16)) for o0 in range(16 * w, 16 * w + 16, 4)
                 if o0 < n_out]
        assert sorted({o0 + j for o0 in tiles for j in range(4) if o0 + j < n_out}) == \
            list(range(n_out))


def tree(a):
    """The tree order of 8 slice sums (axis 0), float32."""
    return ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]))


def tile_reduce_lanes(acc):
    """``tile_reduce`` on a warp, lane by lane: acc (32 lanes, 8 flights, 4
    outputs) float32, each lane's sums by flight; the lane of slice s holds
    flight l ^ s in its accumulator l, keeps the lower half and receives the
    partner's upper half in each round (xor 16, 8, 1). Returns each lane's 4
    outputs, with the lane's slice."""
    slice_of = lambda lane: 2 * (lane >> 3) + (lane & 1)
    lanes = range(32)
    local = np.stack([acc[lane, [l ^ slice_of(lane) for l in range(8)]] for lane in lanes])
    r1 = np.stack([local[lane, :4] + local[lane ^ 16, 4:] for lane in lanes])
    r2 = np.stack([r1[lane, :2] + r1[lane ^ 8, 2:] for lane in lanes])
    out = np.stack([r2[lane, 0] + r2[lane ^ 1, 1] for lane in lanes])
    return out, [slice_of(lane) for lane in lanes]


def test_tile_reduce_scatters_flight_s_to_slice_s():
    rng = np.random.default_rng(0)
    acc = rng.normal(size=(32, 8, 4)).astype(np.float32) * np.float32(1e3) ** rng.integers(
        -1, 2, size=(32, 8, 4)).astype(np.float32)
    out, slices = tile_reduce_lanes(acc)
    assert sorted(slices) == [s for s in range(8) for _ in range(4)]
    for lane in range(32):
        tile = (lane >> 1) & 3
        group = [q for q in range(32) if (q >> 1) & 3 == tile]   # the tile's 8 lanes
        by_slice = np.stack([acc[q] for q in sorted(group, key=lambda q: slices[q])])
        want = tree(by_slice[:, slices[lane]])   # flight = the lane's slice
        assert np.array_equal(out[lane], want), lane


def fma(a, b, c):
    """float32 fused multiply-add (the product is exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def product_order(v, A):
    """``sum_k v[:, k] A[k]`` as the kernel forms it: the contraction padded
    to chunks of 4 rows, chunk ch in slice ch % 8, each slice's chunks in
    order with fused multiply-adds row by row, the 8 slices in the tree."""
    B, K = v.shape
    K4 = r4(K)
    vp = np.zeros((B, K4), np.float32)
    vp[:, :K] = v
    Ap = np.zeros((K4, A.shape[1]), np.float32)
    Ap[:K] = A
    acc = np.zeros((SLICES, B, A.shape[1]), np.float32)
    for ch in range(K4 // 4):
        s = ch % SLICES
        for k in range(4 * ch, 4 * ch + 4):
            acc[s] = fma(vp[:, k:k + 1], Ap[k][None, :], acc[s])
    return tree(acc)


def structured_order(sd, X0, W, REF, ZU, ZX, YU, YX, rho, iterations, over_relax):
    """``gpmpc_controller_structured_batched_plain`` with the kernel's sums
    (float32 numpy): the offset's x0 part in order with fused
    multiply-adds, every other product in ``product_order``."""
    g = lambda t: t.numpy().astype(np.float32)
    N, nu, nx = sd.horizon, sd.nu, sd.nx
    shift = lambda v, width: np.concatenate([v[:, width:N * width], v[:, (N - 1) * width:]], 1)
    f32 = np.float32
    rho, a, am = f32(rho), f32(over_relax), f32(1.0 - over_relax)
    inv_rho = f32(1.0) / rho   # y / rho as a multiply
    X0, W, REF = g(X0), g(W), g(REF)
    zU, yU, zX, yX = shift(g(ZU), nu), shift(g(YU), nu), shift(g(ZX), nx), shift(g(YX), nx)
    SxT, SwT, SuTqT, SuT, SuRow, MinvT = (g(t) for t in (sd.SxT, sd.SwT, sd.SuTqT, sd.SuT,
                                                         sd.SuRow, sd.MinvT))
    loU, hiU, xlo, xhi = g(sd.u_lo), g(sd.u_hi), g(sd.x_lo), g(sd.x_hi)
    B = X0.shape[0]
    W = np.broadcast_to(W, (B, W.shape[1]))
    REF = np.broadcast_to(REF, (B, REF.shape[1]))
    ax = np.zeros((B, SxT.shape[1]), np.float32)
    for k in range(nx):
        ax = fma(X0[:, k:k + 1], SxT[k][None, :], ax)
    off = ax + product_order(W, SwT)
    fv = product_order(off - REF, SuTqT)
    vU, vX = rho * zU - yU, rho * zX - yX
    clip = lambda v, lo, hi: np.minimum(np.maximum(v, lo), hi)
    for _ in range(iterations):
        tf = (vU + product_order(vX, SuRow)) - fv
        U = product_order(tf, MinvT)
        Gt = a * U + am * zU
        zn = clip(Gt + yU * inv_rho, loU, hiU)
        yU = yU + rho * (Gt - zn)
        zU, vU = zn, rho * zn - yU
        GX = product_order(U, SuT)
        Gt = a * GX + am * zX
        zn = clip(Gt + yX * inv_rho, xlo - off, xhi - off)
        yX = yX + rho * (Gt - zn)
        zX, vX = zn, rho * zn - yX
    U = product_order((vU + product_order(vX, SuRow)) - fv, MinvT)
    return zU, zX, yU, yX, U, off + product_order(U, SuT)


@pytest.mark.parametrize("N,B", [(8, 9), (20, 16), (25, 3)])
def test_k8_kernel_order_holds_plain(N, B):
    rng = np.random.default_rng(N)
    mpc = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=10, use_fused_controller=True),
                    device="cpu")
    sd = controller_pallas.build_structured_batch_data(
        mpc._fc_data, N, NU, NX, mpc._u_lo, mpc._u_hi, mpc._x_lo, mpc._x_hi, device="cpu")
    t = lambda *shape, scale=1.0: torch.tensor(scale * rng.normal(size=shape), dtype=torch.float32)
    X0 = t(B, NX)
    X0[:, 2] += 3.0
    ref = torch.tensor([0.8, 0.3, 3.0, 0.0, 0.0, 0.0], dtype=torch.float32).repeat(N)[None]
    args = (sd, X0, t(B, N * NX, scale=0.02), ref, t(B, N * NU, scale=3.0), t(B, N * NX),
            t(B, N * NU), t(B, N * NX), 8.0, 10, 1.6)
    want = controller_pallas.gpmpc_controller_structured_batched_plain(*args)
    got = structured_order(*args)
    errs = [float(np.abs(g_ - w.numpy()).max()) for g_, w in zip(got, want)]
    assert all(np.isfinite(g_).all() for g_ in got)
    assert max(errs) <= K8_TOL, errs
    # some slacks sit on their boxes: the projections did work
    assert float(np.abs(got[0]).max()) > 1.0
