"""The host-side layout of the GP posterior-mean kernel K7
(``rbf_posterior_mean_pallas``) on the tensor cores, and the arithmetic of
its sums, on the CPU (no card or ``nvcc``); and K2's launch geometry:

- the TF32 split rounds to nearest (ties away from zero) to a 10-bit
  mantissa, both parts exact TF32 values, their sum within 2^-22 of x;
- K7's shared memory fits one H100 block (232,448 bytes): the whole
  training set resident up to 1312 points (P = 800: 148,736 bytes), a ring
  of stages refilled half at a time past that;
- a float32 emulation of the kernel's sums, built lane by lane from the
  packed operand and the ``mma.sync`` fragment layouts (the 3xTF32 splits,
  the hi/lo products in the kernel's order, the value operand's permuted
  points, the warp columns meeting in a fixed order), holds
  ``rbf_posterior_mean_plain`` within ``K7_TOL`` (1e-5, ``chip_smoke.py``),
  the bar the card check holds K7 to, at P = 800 and at a P that streams in
  chunks (2000), a quarter of the queries near training points;
- masked ring rows at the 1e6 sentinel pack to finite operands and
  contribute exactly 0, even with a large value row;
- K2 runs a group of 8 lanes per state, four states a warp, 16 a block.
"""

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
    ResidualDataset,
    ResidualGPConfig,
    fit_residual_gp,
    fit_residual_gp_masked,
)
from unmanned_aerial_vehicles_tpu_torch.ops import plant_pallas, rbf_pallas

torch.set_num_threads(1)

SMEM_LIMIT = 232448   # one H100 block's opt-in shared memory
K7_TOL = 1e-5
f32 = np.float32


def trunc(x):
    """The tensor cores read a TF32 operand's top 19 bits."""
    return (np.asarray(x, f32).view(np.int32) & np.int32(~0x1FFF)).view(f32)


def rna(x):
    b = np.asarray(x, f32).view(np.int32)
    return ((b + np.int32(0x1000)) & np.int32(~0x1FFF)).view(f32)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.0, 1e6, 1e13])
def test_tf32_split_rounds_to_nearest(scale):
    rng = np.random.default_rng(1)
    x = (scale * rng.normal(size=4096)).astype(f32)
    x[:4] = np.array([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11), 0.0]) * scale
    hi, lo = (t.numpy() for t in rbf_pallas.tf32_split(torch.from_numpy(x)))
    for part in (hi, lo):
        assert np.all(part.view(np.int32) & 0x1FFF == 0)   # 10-bit mantissas
    # hi is the nearest TF32 value, a tie going away from zero
    xd, hd = x.astype(np.float64), hi.astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(np.where(x == 0, 1, xd)))) - 10)
    assert np.all(np.abs(xd - hd) <= 0.5 * ulp)
    ties = np.abs(np.abs(xd - hd) - 0.5 * ulp) == 0
    assert np.all(np.abs(hd[ties]) > np.abs(xd[ties]))
    assert np.all(np.abs(xd - hd - lo.astype(np.float64)) <= 2.0 ** -22 * np.abs(xd))


@pytest.mark.parametrize("P", [1, 32, 300, 800, 1312, 1313, 2000, 19800])
def test_k7_layout_fits_one_block(P):
    lay = rbf_pallas.posterior_mean_layout(P, SMEM_LIMIT)
    assert lay["chunks"] == -(-P // 32) and lay["bytes"] <= SMEM_LIMIT
    assert lay["bytes"] == (-(-8 * lay["stages"] // 128) * 128 + rbf_pallas.REDUCE_BYTES
                            + rbf_pallas.CHUNK_BYTES * lay["stages"])
    if P <= 1312:   # the whole training set stays for the launch (41 chunks)
        assert lay["resident"] and lay["stages"] == lay["chunks"]
    else:           # a ring whose two halves are refilled in turns
        assert not lay["resident"] and lay["stages"] == 40 and lay["stages"] < lay["chunks"]
    if P == 800:
        assert lay["bytes"] == 148736


def emulate(ops, X, tiles):
    """``rbf_posterior_mean_pallas`` as the kernel forms it, float32 numpy:
    the queries' scaled features and |z|^2 as each quad of lanes sums them,
    their TF32 splits; each 8-point tile's fragments read lane by lane from
    ``tiles`` (``pack_posterior_tiles``'s operand) and placed by the
    ``mma.sync`` layouts; per tile the
    cross product's five MMAs (small parts first, features 8-11's two as
    one k = 8 product), min, exp and Dekker's
    split of each exp, the value product's A operand taken from the
    accumulator's registers as they stand, its three MMAs; point tile j in
    warp column j % 4, the columns' sums meeting as ((c0 + c1) + (c2 + c3))
    + y_mean. An MMA is a float32 rounding of its exact sum."""
    c = f32(rbf_pallas.EXP2_SCALE)
    m = X.shape[0]
    QT = -(-m // 16)
    Xp = np.zeros((QT * 16, 10), f32)
    Xp[:m] = X
    z = ((Xp - ops.shift.numpy()) / ops.ls.numpy()).astype(f32)
    z[m:] = 0
    fma = lambda a, b, acc: (a.astype(np.float64) * b + acc).astype(f32)
    part = []
    for t in range(4):   # lane t of a quad: features t, t + 4 and (t < 2) 8 + t
        s = z[:, t] * z[:, t]
        s = fma(z[:, t + 4], z[:, t + 4], s)
        if t < 2:
            s = fma(z[:, 8 + t], z[:, 8 + t], s)
        part.append(s)
    csq = c * ((part[0] + part[1]) + (part[2] + part[3]))
    zh = rna(z)
    zl = rna(z - zh)
    one, zero = np.ones((QT * 16, 1), f32), np.zeros((QT * 16, 1), f32)
    rs = lambda a: a.reshape(QT, 16, -1)
    A8h, A8l = rs(zh[:, :8]), rs(zl[:, :8])
    A4h = rs(np.concatenate([zh[:, 8:10], one, zero], 1))
    A4l = rs(np.concatenate([zl[:, 8:10], zero, zero], 1))
    C0 = np.repeat(csq.reshape(QT, 16, 1), 8, 2)

    def mma(acc, A, B):
        return (acc.astype(np.float64) + np.einsum("xqk,kn->xqn", trunc(A).astype(np.float64),
                                                    trunc(B).astype(np.float64))).astype(f32)

    T = tiles.numpy().reshape(-1, rbf_pallas.TILE_FLOATS)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    O = np.zeros((rbf_pallas.WARP_COLUMNS, QT, 16, 8), f32)
    for j in range(T.shape[0]):
        cr, va = T[j, :128].reshape(32, 4), T[j, 128:256].reshape(32, 4)
        k4 = T[j, 256:].reshape(32, 2)
        B8h, B8l, V_h, V_l = (np.zeros((8, 8), f32) for _ in range(4))
        B4h, B4l = np.zeros((4, 8), f32), np.zeros((4, 8), f32)
        # b0 (t, g), b1 (t + 4, g)
        B8h[t, g], B8h[t + 4, g], B8l[t, g], B8l[t + 4, g] = cr.T
        V_h[t, g], V_h[t + 4, g], V_l[t, g], V_l[t + 4, g] = va.T
        B4h[t, g], B4l[t, g] = k4.T
        S = mma(C0, A8l, B8h)
        S = mma(S, A8h, B8l)
        S = mma(S, np.concatenate([A4l, A4h], 2), np.concatenate([B4h, B4l], 0))
        S = mma(S, A8h, B8h)
        S = mma(S, A4h, B4h)
        k = np.exp2(np.minimum(S, 0).astype(np.float64)).astype(f32)
        cc = k * f32(8193.0)
        kh = cc - (cc - k)
        kl = k - kh
        # lane (g, t) holds S columns 2t, 2t + 1 as its A slots t, t + 4
        Ah, Al = np.zeros_like(kh), np.zeros_like(kl)
        Ah[:, :, t], Ah[:, :, t + 4] = kh[:, :, 2 * t], kh[:, :, 2 * t + 1]
        Al[:, :, t], Al[:, :, t + 4] = kl[:, :, 2 * t], kl[:, :, 2 * t + 1]
        col = j % rbf_pallas.WARP_COLUMNS
        o = mma(O[col], Al, V_h)
        o = mma(o, Ah, V_l)
        O[col] = mma(o, Ah, V_h)
    tot = ((O[0] + O[1]) + (O[2] + O[3])).reshape(QT * 16, 8)[:m, :6]
    return (tot + ops.y_mean.numpy()).astype(f32)


def posterior(P, shift=False):
    rng = np.random.default_rng(P)
    X = torch.tensor(rng.normal(size=(P, 10)), dtype=torch.float32)
    Y = torch.tensor(0.05 * rng.normal(size=(P, 6)) + 0.02, dtype=torch.float32)
    post = fit_residual_gp(X, Y, ResidualGPConfig())
    if shift:
        post = post._replace(x_shift=torch.tensor(0.3 * rng.normal(size=10), dtype=torch.float32))
    return post, rng


def queries(post, rng, m):
    """m queries, a quarter within 0.2 of a training point (as
    ``chip_smoke.py``'s K7 check)."""
    Xt = post.X_train.numpy()
    near = Xt[rng.integers(0, Xt.shape[0], m // 4)] + 0.2 * rng.normal(size=(m // 4, 10))
    return np.concatenate([near, rng.normal(size=(m - m // 4, 10))]).astype(f32)


@pytest.mark.parametrize("P,m,shift", [(800, 2048, False), (800, 1000, True), (2000, 1536, False)])
def test_k7_kernel_order_holds_plain(P, m, shift):
    post, rng = posterior(P, shift)
    ops = rbf_pallas.posterior_mean_operands(post)
    assert ops.tiles is None   # packed only for a posterior on the card
    tiles = rbf_pallas.pack_posterior_tiles(ops.ztr, ops.sq2, ops.a)
    lay = rbf_pallas.posterior_mean_layout(P, SMEM_LIMIT)
    assert tiles.shape == (lay["chunks"] * rbf_pallas.CHUNK_TILES * rbf_pallas.TILE_FLOATS,)
    assert lay["resident"] == (P <= 1312)
    Xq = queries(post, rng, m)
    want = rbf_pallas.rbf_posterior_mean_plain(ops, torch.from_numpy(Xq)).numpy()
    got = emulate(ops, Xq, tiles)
    assert np.all(np.isfinite(got))
    err = float(np.abs(got - want).max())
    assert err <= K7_TOL, err
    # the near queries see the training data
    assert float(np.abs(want[: m // 4] - ops.y_mean.numpy()).max()) > 1e-3
    # the plain form's properties are what they were
    assert torch.equal(ops.ztr, post.X_train / ops.ls)
    assert ops.a.shape == (P, 6) and ops.sq2.shape == (P,)


def test_k7_sentinel_rows_contribute_exactly_zero():
    rng = np.random.default_rng(5)
    cap, count = 300, 180
    ds = ResidualDataset(X=torch.tensor(rng.normal(size=(cap, 10)), dtype=torch.float32),
                         Y=torch.tensor(0.05 * rng.normal(size=(cap, 6)), dtype=torch.float32),
                         head=torch.tensor(count), count=torch.tensor(count))
    post = fit_residual_gp_masked(ds, ResidualGPConfig())
    assert float(post.X_train.max()) == 1e6
    ops = rbf_pallas.posterior_mean_operands(post)
    tiles = rbf_pallas.pack_posterior_tiles(ops.ztr, ops.sq2, ops.a)
    assert torch.isfinite(tiles).all()
    Xq = queries(post._replace(X_train=post.X_train[:count]), rng, 640)
    want = rbf_pallas.rbf_posterior_mean_plain(ops, torch.from_numpy(Xq)).numpy()
    assert float(np.abs(emulate(ops, Xq, tiles) - want).max()) <= K7_TOL
    # a large value row at every sentinel, none at the valid rows: the
    # sentinels' exps are 0, so the mean is y_mean exactly
    a = torch.where(torch.arange(cap)[:, None] < count, 0.0, 1e3 * torch.ones(cap, 6))
    probe = rbf_pallas.pack_posterior_tiles(ops.ztr, ops.sq2, a)
    assert np.array_equal(emulate(ops, Xq, probe), np.broadcast_to(ops.y_mean.numpy(), (640, 6)))


@pytest.mark.parametrize("d,out", [(8, 6), (10, 4), (10, 8)])
def test_k7_packing_rejects_other_shapes(d, out):
    z = torch.zeros(40, d)
    with pytest.raises(ValueError, match="built for 10 features and 6 outputs"):
        rbf_pallas.pack_posterior_tiles(z, torch.zeros(40), torch.zeros(40, out))


@pytest.mark.parametrize("B", [1, 256, 1024, 4096])
def test_k2_launch_geometry(B):
    """The launch ``_allocation_plant_rows`` (K2) and ``_px4_plant_rows``
    (K1) pass to their kernels, one shared shape: whole warps (the
    shuffles), at most 128 threads (the launch bounds), and the blocks
    cover the batch with fewer than a block's states to spare."""
    blocks, threads = plant_pallas.plant_geometry(B)
    assert threads == 128 and threads % 32 == 0
    per_block = threads // plant_pallas.LANES_PER_STATE   # 8 lanes per state
    assert per_block == 16 and (blocks - 1) * per_block < B <= blocks * per_block
    assert blocks == {1: 1, 256: 16, 1024: 64, 4096: 256}[B]


# ---------------------------------------------------------------------------
# K15: the persistent Gram kernel's walk and its folded exponent
# ---------------------------------------------------------------------------

SMS = 132             # an H100's SMs
GRAM_TOL = 5e-5       # chip_smoke.py: K15 against its plain version, of sigma^2
TILE = 64
LOG2E = f32(1.4426950408889634)


@pytest.mark.parametrize("n1,n2", [(800, 800), (19800, 19800), (300, 257), (801, 257), (1, 1)])
def test_k15_tile_walk_covers_every_entry_once(n1, n2):
    """The blocks' tile ranges partition the tiles in row-major order, the
    tiles (cut at the ragged edges) and each tile's 16 x 16 threads' 4 x 4
    micro-tiles partition the output; the grid is three blocks an SM, never
    more than the tiles, and leaves no SM idle where the tiles suffice.
    Reckoned on the host: the corpus's output is not allocated."""
    geo = rbf_pallas.gram_geometry(n1, n2, SMS)
    assert (geo.tiles_r, geo.tiles_c) == (-(-n1 // TILE), -(-n2 // TILE))
    assert geo.grid == min(geo.tiles, 3 * SMS) and geo.grid >= min(geo.tiles, SMS)
    # block b walks tiles [b T // grid, (b + 1) T // grid) (csrc/rbf_kernels.cu)
    walks = [range(b * geo.tiles // geo.grid, (b + 1) * geo.tiles // geo.grid)
             for b in range(geo.grid)]
    assert walks[0].start == 0 and walks[-1].stop == geo.tiles
    assert all(a.stop == b.start and len(a) >= 1 for a, b in zip(walks, walks[1:]))
    lengths = {len(w) for w in walks}
    assert max(lengths) - min(lengths) <= 1   # an even share
    # each tile's entries: rows and columns cut at the edges
    t = np.arange(geo.tiles)
    tr, tc = t // geo.tiles_c, t % geo.tiles_c
    rows = np.minimum(n1, TILE * tr + TILE) - TILE * tr
    cols = np.minimum(n2, TILE * tc + TILE) - TILE * tc
    assert int((rows * cols).sum()) == n1 * n2 and rows.min() >= 1 and cols.min() >= 1
    if n1 * n2 <= 10**6:
        # thread (ty, tx) writes rows 4 ty + r and columns 4 tx + q of its tile
        hits = np.zeros((n1, n2), np.int32)
        ty, tx, r, q = np.meshgrid(*(np.arange(k) for k in (16, 16, 4, 4)), indexing="ij")
        for w in walks:
            for tile in w:
                R = (tile // geo.tiles_c) * TILE + 4 * ty + r
                C = (tile % geo.tiles_c) * TILE + 4 * tx + q
                keep = (R < n1) & (C < n2)
                np.add.at(hits, (R[keep], C[keep]), 1)
        assert np.all(hits == 1)


def fma32(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def gram_order(X1, X2, ls, sig):
    """K15's arithmetic in float32: z = x / l, w = log2(e) z, half norms
    0.5 sum_k w_k z_k and dots sum_k w1_k z2_k as one FMA chain over the
    features, then sigma^2 2^min((dot - h1) - h2, 0)."""
    L = torch.tensor(LOG2E)

    def side(X):
        z = X / ls
        w = L * z
        s = torch.zeros(X.shape[0])
        for k in range(X.shape[1]):
            s = fma32(w[:, k], z[:, k], s)
        return z, w, torch.tensor(0.5, dtype=torch.float32) * s

    z1, w1, h1 = side(X1)
    z2, _, h2 = side(X2)
    dot = torch.zeros(X1.shape[0], X2.shape[0])
    for k in range(X1.shape[1]):
        dot = fma32(w1[:, k, None], z2[None, :, k], dot)
    e = (dot - h1[:, None]) - h2[None, :]
    return sig * torch.exp2(torch.clamp(e, max=0.0))


@pytest.mark.parametrize("case", ["isotropic", "ard", "near"])
def test_k15_folded_exponent_holds_plain(case):
    """The exponent folded into the scaled operands (one ex2) against
    ``rbf_kernel_matrix_plain`` within GRAM_TOL, on the JAX tests' shapes
    and on points near one another (where the exp is far from 0)."""
    rng = np.random.default_rng(15)
    if case == "isotropic":
        X1 = rng.normal(size=(300, 10)).astype(f32)
        X2 = rng.normal(size=(257, 10)).astype(f32)
        ls, sig = torch.tensor(0.5), torch.tensor(1.3)
    elif case == "ard":
        X1 = X2 = rng.normal(size=(100, 6)).astype(f32)
        ls, sig = torch.tensor([0.3, 0.5, 1.0, 2.0, 0.7, 1.5]), torch.tensor(1.0)
    else:
        X1 = rng.normal(size=(200, 10)).astype(f32)
        X2 = (X1 + 0.05 * rng.normal(size=X1.shape)).astype(f32)
        ls, sig = torch.tensor(0.5), torch.tensor(1.3)
    X1, X2 = torch.from_numpy(X1), torch.from_numpy(X2)
    got = gram_order(X1, X2, ls, sig)
    want = rbf_pallas.rbf_kernel_matrix_plain(X1, X2, ls, sig)
    assert float((got - want).abs().max()) <= GRAM_TOL * float(sig)
    if case == "near":
        assert float(want.diagonal().min()) > 0.5   # the exps are not all ~0


def test_k15_folded_exponent_is_exact_on_coincident_points():
    """Coincident points give exactly sigma^2: the dot and the two half
    norms are the same FMA chain, so the exponent is 0 exactly."""
    rng = np.random.default_rng(16)
    X = torch.from_numpy((30.0 * rng.normal(size=(64, 10))).astype(f32))
    X[7] = X[3]
    ls = torch.from_numpy(rng.uniform(0.3, 1.5, size=10).astype(f32))
    K = gram_order(X, X, ls, torch.tensor(1.7))
    assert torch.all(K.diagonal() == torch.tensor(1.7)) and K[3, 7] == K[7, 3] == K[3, 3]
