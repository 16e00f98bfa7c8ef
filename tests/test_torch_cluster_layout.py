"""The host-side layout of the two kernels that run over a thread-block
cluster, K16 (``gpmpc_controller_fused_batched``) and K5's variance section
(``gpmpc_multitick_fused`` with ``tighten_kappa > 0``), and the arithmetic
they use, on the CPU (no card, ``nvcc`` or ``triton``):

- K16's column slices and flight tiles cover every column and flight
  exactly once, balanced to within one column; K5's workers' shares of
  K^-1's upper triangle cover every entry exactly once, balanced to within
  one row; every block's shared memory fits one H100 block (232,448 bytes).
- K16's products in the kernel's order (ranges of rows summed in order, in
  float32) against float64 and the plain float32 product; the 3xTF32 split
  that tensor cores would need (one-pass TF32 keeps about three digits).
- The symmetric upper-triangle quadratic form of K5's workers against
  ``tightening_row``'s full product, on K* and K^-1 from the JAX package's
  posterior carried across with ``convert``.

Tolerances: 1e-6 relative for float32 sums of ~250 terms against float64
(~sqrt(250) 6e-8 each); 2e-6 relative for 3xTF32, whose dropped lo x lo
term is ~2^-22 of each product; 1e-12 relative for the quadratic form in
float64; TICK_TOL (1e-4 of scale, ``chip_smoke.py``) on the back-off row in
float32, the bar the card check holds the kernel's row to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig as JGPCfg
from unmanned_aerial_vehicles_tpu.gp.residual_gp import fit_residual_gp as j_fit
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.ops import controller_pallas, tick_pallas

torch.set_num_threads(1)

SMEM_LIMIT = 232448   # one H100 block's opt-in shared memory
TICK_TOL = 1e-4


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# K16's slices and tiles, K5's triangle shares, shared memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cluster", [8, 6, 4])
@pytest.mark.parametrize("width", [80, 200, 250])
def test_k16_column_slices_cover_every_column_once(width, cluster):
    slices = controller_pallas.fused_column_slices(width, cluster)
    assert len(slices) == cluster
    owned = np.concatenate([np.arange(a, b) for a, b in slices])
    np.testing.assert_array_equal(owned, np.arange(width))
    sizes = [b - a for a, b in slices]
    assert max(sizes) - min(sizes) <= 1
    assert max(sizes) <= controller_pallas.fused_slice_pad(width // 10, cluster)


@pytest.mark.parametrize("batch", [1, 15, 16, 17, 256, 257])
def test_k16_flight_tiles_cover_every_flight_once(batch):
    tiles = controller_pallas.fused_flight_tiles(batch)
    assert len(tiles) == -(-batch // controller_pallas.FUSED_TILE_FLIGHTS)
    owned = np.concatenate([np.arange(a, b) for a, b in tiles])
    np.testing.assert_array_equal(owned, np.arange(batch))
    assert all(b - a == controller_pallas.FUSED_TILE_FLIGHTS for a, b in tiles[:-1])


@pytest.mark.parametrize("workers", [tick_pallas.VAR_WORKERS, tick_pallas.VAR_MAX_CLUSTER - 1])
@pytest.mark.parametrize("n_train", [1, 37, 800, 1000])
def test_variance_shares_cover_the_upper_triangle_once(n_train, workers):
    bounds = tick_pallas.variance_row_shares(n_train, workers)
    assert len(bounds) == workers + 1 and bounds[0] == 0 and bounds[-1] == n_train
    assert all(a <= b for a, b in zip(bounds[:-1], bounds[1:]))
    counts = np.zeros((n_train, n_train), np.int64)
    for q0, q1 in zip(bounds[:-1], bounds[1:]):
        for q in range(q0, q1):
            counts[q, q:] += 1   # row q holds columns q .. P-1
    np.testing.assert_array_equal(counts, np.triu(np.ones_like(counts)))
    share = [sum(n_train - q for q in range(a, b)) for a, b in zip(bounds[:-1], bounds[1:])]
    ideal = n_train * (n_train + 1) / 2 / workers
    assert max(abs(s - ideal) for s in share) < n_train   # within one row of the ideal


@pytest.mark.parametrize("horizon", [20, 25])
def test_every_cluster_block_fits_one_h100_block(horizon):
    for cluster in range(1, controller_pallas.FUSED_CLUSTER_BLOCKS + 1):
        if controller_pallas.fused_slice_pad(horizon, cluster) <= controller_pallas.FUSED_MAX_SLICE:
            assert controller_pallas.fused_batched_shared_memory_bytes(horizon, cluster) <= SMEM_LIMIT
    assert controller_pallas.fused_slice_pad(horizon, 8) <= controller_pallas.FUSED_MAX_SLICE
    for workers in (tick_pallas.VAR_WORKERS, tick_pallas.VAR_MAX_CLUSTER - 1):
        for shared in (True, False):
            assert tick_pallas.variance_worker_bytes(horizon, 800, shared, workers) <= SMEM_LIMIT


def test_tightened_k5_fits_at_horizon_23():
    # rank 0 keeps only the variance row and the back-off row beside the
    # tick's layout on its 256 threads, the GP's sums one per slice (the
    # workers hold the quadratic form's scratch)
    n, m, Nnx = 23, 230, 138
    tight = tick_pallas.shared_memory_bytes(n, tighten=True)
    threads = tick_pallas.TIGHT_KERNEL_THREADS
    vectors = tick_pallas._vector_floats(n, 4, 6, threads, threads - 32,
                                         tick_pallas.TIGHT_GP_GROUP, 1)
    assert tight == 4 * (vectors + 12 + 9 + 6 + Nnx + m) == 230260
    assert tight <= SMEM_LIMIT
    assert tick_pallas.MAX_VAR_STAGES >= n
    assert tick_pallas.shared_memory_bytes(24, tighten=True) > SMEM_LIMIT


# ---------------------------------------------------------------------------
# K16's arithmetic
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def admm_inputs():
    """P1 of the package default LinearMPC (N=25) and the ADMM's input
    v = rho z - y for 16 flights after two plain warm-started ticks."""
    N, B = 25, 16
    mpc = LinearMPC(LinearMPCConfig(horizon=N, use_fused_controller=True), device="cpu")
    data = mpc._tick_data
    rng = np.random.default_rng(16)
    X0 = torch.tensor(rng.normal(size=(B, 6)) * [1, 1, 1, 0.5, 0.5, 0.5] + [0, 0, 3, 0, 0, 0],
                      dtype=torch.float32)
    W = torch.tensor(0.02 * rng.normal(size=(B, 6 * N)), dtype=torch.float32)
    REF = torch.tensor([3.0, 0.0, 3.0, 0.0, 0.0, 0.0]).repeat(N)[None]
    Z = torch.zeros(B, 10 * N)
    Y = torch.zeros(B, 10 * N)
    for _ in range(2):
        Z, Y, _, _ = controller_pallas.gpmpc_controller_fused_batched_plain(
            data, data.ShiftT, X0, W, REF, Z, Y, 8.0, 80, 1.6)
    v = (8.0 * (Z @ data.ShiftT) - Y @ data.ShiftT).numpy()
    return data.P1.numpy(), v


@pytest.mark.parametrize("cluster", [8, 6])
def test_k16_slice_sums_hold_the_plain_product(admm_inputs, cluster):
    """Every column of GU = v P1 summed as the kernel sums it: rows split
    into 256 // (slice width rounded up to 4) ranges, each accumulated in
    order with float32 multiply-adds, the ranges added in order."""
    P1, v = admm_inputs
    m = P1.shape[0]
    exact = v.astype(np.float64) @ P1.astype(np.float64)
    got = np.zeros_like(exact, dtype=np.float32)
    for c0, c1 in controller_pallas.fused_column_slices(m, cluster):
        ranges = 256 // (4 * -(-(c1 - c0) // 4))
        total = None
        for r in range(ranges):
            k0, k1 = r * m // ranges, (r + 1) * m // ranges
            acc = np.zeros((v.shape[0], c1 - c0), np.float32)
            for k in range(k0, k1):
                prod = v[:, k:k + 1].astype(np.float64) * P1[k, c0:c1].astype(np.float64)
                acc = (prod + acc).astype(np.float32)   # one fused multiply-add
            total = acc if total is None else (total + acc).astype(np.float32)
        got[:, c0:c1] = total
    assert rel(got, exact) <= 1e-6
    assert rel(got, v @ P1) <= 2e-6


def tf32(a):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on int32 views: what ``cvt.rna.tf32.f32`` does."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((bits + np.int32(0x1000)) & np.int32(-0x2000)).view(np.float32)


def test_3xtf32_product_holds_float32_digits_and_tf32_alone_does_not(admm_inputs):
    P1, v = admm_inputs
    exact = v.astype(np.float64) @ P1.astype(np.float64)
    v_hi, p_hi = tf32(v), tf32(P1)
    v_lo, p_lo = tf32(v - v_hi), tf32(P1 - p_hi)
    f64 = lambda a: a.astype(np.float64)
    three = (f64(v_hi) @ f64(p_hi) + f64(v_hi) @ f64(p_lo) + f64(v_lo) @ f64(p_hi))
    assert rel(three.astype(np.float32), exact) <= 2e-6
    assert rel(f64(v_hi) @ f64(p_hi), exact) > 2e-6 * 10


# ---------------------------------------------------------------------------
# K5's quadratic form over the workers' triangle shares
# ---------------------------------------------------------------------------

QN, QP = 20, 37


@pytest.fixture(scope="module")
def variance_case():
    """K* (N x P) of a horizon of features against a GP fitted by the JAX
    package on P points, and that posterior's K^-1, carried across with
    ``convert``: float64, and as the kernel's float32 GP rows."""
    rng = np.random.default_rng(5)
    X = (2.0 * rng.normal(size=(QP, 10))).astype(np.float32)
    Y = (4.0 * rng.normal(size=(QP, 6))).astype(np.float32)
    jpost = j_fit(jnp.asarray(X), jnp.asarray(Y), JGPCfg())
    post = convert.gp_posterior_from_numpy(
        np.asarray(jpost.X_train), np.asarray(jpost.chol), np.asarray(jpost.alpha),
        np.asarray(jpost.y_mean), np.asarray(jpost.y_std),
        np.asarray(jpost.params.length_scale), np.asarray(jpost.params.signal_variance),
        np.asarray(jpost.params.noise_variance), device="cpu",
    )
    gp = tick_pallas.build_gp_rows(post, 1.0, with_variance=True)
    feats = X[rng.integers(0, QP, QN)] + 0.3 * rng.normal(size=(QN, 10))
    Zf = feats * gp.inv_ls[0].numpy().astype(np.float64) - gp.inv_ls[1].numpy()
    d = (np.sum(Zf * Zf, 1)[:, None] + gp.sq2.numpy()[None, :] - 2.0 * Zf @ gp.ztrT.numpy())
    kst = float(gp.scal[0]) * np.exp(-0.5 * np.maximum(d, 0.0))
    eye = torch.eye(QP, dtype=torch.float64)
    kinv64 = torch.cholesky_solve(eye, post.chol.to(torch.float64)).numpy()
    kinv64 = 0.5 * (kinv64 + kinv64.T)   # the kernel reads the upper triangle of a symmetric K^-1
    mpc = LinearMPC(LinearMPCConfig(horizon=QN, admm_iterations=10, use_fused_controller=True),
                    device="cpu")
    return kst, kinv64, gp, mpc._tick_data


def triangle_quad(kst, kinv, workers, dtype):
    """quad[k] = K*_k K^-1 K*_k' as the workers form it: worker r takes the
    triangle rows of ``variance_row_shares``, in blocks of VAR_ROWS rows,
    each block's t[k][p] = sum_q w_qp K^-1_qp K*_kq (w = 2 off the
    diagonal, 1 on it, 0 below it) folded into quad[k] += t[k][p] K*_kp;
    the workers' sums added in rank order."""
    P = kst.shape[1]
    kst, kinv = kst.astype(dtype), kinv.astype(dtype)
    bounds = tick_pallas.variance_row_shares(P, workers)
    weight = (np.triu(np.ones((P, P)), 1) * 2 + np.eye(P)).astype(dtype)
    total = np.zeros(kst.shape[0], dtype)
    for q0, q1 in zip(bounds[:-1], bounds[1:]):
        part = np.zeros(kst.shape[0], dtype)
        for qc in range(q0, q1, tick_pallas.VAR_ROWS):
            rows = slice(qc, min(q1, qc + tick_pallas.VAR_ROWS))
            t = kst[:, rows] @ (weight[rows] * kinv[rows])
            part = (part + np.sum(t * kst, axis=1, dtype=dtype)).astype(dtype)
        total = (total + part).astype(dtype)
    return total


def test_triangle_quadratic_form_equals_the_full_product_in_float64(variance_case):
    kst, kinv64, _, _ = variance_case
    full = np.sum((kst @ kinv64) * kst, axis=1)
    for workers in (tick_pallas.VAR_WORKERS, tick_pallas.VAR_MAX_CLUSTER - 1):
        tri = triangle_quad(kst, kinv64, workers, np.float64)
        assert rel(tri, full) <= 1e-12


def test_back_off_row_from_the_triangle_form_holds_tightening_row_in_float32(variance_case):
    kst, _, gp, data = variance_case
    kappa = 2.0
    kst32 = torch.tensor(kst, dtype=torch.float32)
    want = tick_pallas.tightening_row(data, gp, kst32, kappa)
    # tightening_row after its quadratic form, fed the workers' float32 form
    quad = torch.tensor(triangle_quad(kst32.numpy(), gp.kinv.numpy(), tick_pallas.VAR_WORKERS,
                                      np.float32))
    var_lat = torch.clamp(gp.scal[2] - quad, min=1e-10)
    sig_acc = (gp.scal[1] ** 2) * var_lat[:, None] * (gp.y_std[3:6] ** 2)[None, :]
    sig = torch.cat([torch.zeros_like(sig_acc), sig_acc], dim=1).reshape(-1)
    Nnu = data.Nnu
    cap = 0.45 * (data.hi_row[Nnu:] - data.lo_row[Nnu:])
    got = torch.cat([torch.zeros(Nnu), torch.minimum(kappa * torch.sqrt(sig @ data.SwSqT), cap)])
    assert float(want[Nnu:].abs().max()) > 0.0
    torch.testing.assert_close(got, want, rtol=0,
                               atol=TICK_TOL * max(1.0, float(want.abs().max())))
