"""Port parity for the last three TPU kernels and the per-flight plant
block: the plain versions of K14 (``admm_box_qp_fused``), K15
(``rbf_kernel_matrix_pallas``) and K16 (``gpmpc_controller_fused_batched``),
which the wrappers run for CPU tensors, against the JAX package's Pallas
kernels in interpret mode from identical operands carried across with
``convert``; K1 and K2 on a ``(B, 10)`` plant block against the JAX kernels
vmapped over per-flight plant scalars.

Tolerances:
- K14 against the JAX kernel and against ``admm_box_qp`` 2e-5 on U and z
  (the JAX test's own bar is 2e-4, ``tests/test_pallas_ops.py:198``):
  float32 on both sides over 300 iterations; the iterates settle at a
  fixed point, so rounding in the three products does not accumulate past
  ~1e-6 of O(1) values. The padded lanes stay exactly 0.
- K15 5e-6 absolute (the JAX test's bar, ``test_pallas_ops.py:156``).
- K16 1e-5 of each output's scale: float32 products summed in other orders
  (~1e-7 relative each), 20 ADMM iterations amplify that by at most ~10x.
- The plant block 2e-6 (the JAX plant tests' bar,
  ``test_pallas_ops.py:258``); the shared row and a block of equal rows
  bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.kernels import rbf_kernel_diag as j_rbf_diag
from unmanned_aerial_vehicles_tpu.ops.admm_pallas import admm_box_qp_fused as j_k14
from unmanned_aerial_vehicles_tpu.ops.controller_pallas import (
    gpmpc_controller_fused_batched as j_k16,
)
from unmanned_aerial_vehicles_tpu.ops.plant_pallas import (
    allocation_plant_tick_fused as j_k2,
    px4_plant_step_fused as j_k1,
)
from unmanned_aerial_vehicles_tpu.ops.qp import admm_box_qp as j_admm
from unmanned_aerial_vehicles_tpu.ops.rbf_pallas import rbf_kernel_matrix_pallas as j_k15
from unmanned_aerial_vehicles_tpu.ops.tick_pallas import build_shift_matrix as j_shift
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.gp.kernels import rbf_kernel_diag
from unmanned_aerial_vehicles_tpu_torch.loop import plant_block
from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.models.px4_surrogate import RateLoopParams
from unmanned_aerial_vehicles_tpu_torch.ops import (
    admm_pallas,
    controller_pallas,
    plant_pallas,
    qp,
    rbf_pallas,
    tick_ad,
)

torch.set_num_threads(1)

t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# K14
# ---------------------------------------------------------------------------

K14_N, K14_M, K14_ITERS, K14_RHO, PAD = 24, 40, 300, 10.0, 128


@pytest.fixture(scope="module")
def k14_case():
    """``test_pallas_ops.py``'s QP: n=24, m=40, 300 iterations, padded to
    128 lanes for the JAX kernel."""
    rng = np.random.default_rng(14)
    n, m = K14_N, K14_M
    Q = rng.normal(size=(n, n))
    H = (Q @ Q.T + n * np.eye(n)).astype(np.float32)
    G = np.vstack([np.eye(n), rng.normal(size=(m - n, n))]).astype(np.float32)
    f = (rng.normal(size=n) * 50).astype(np.float32)
    lo, hi = -0.5 * np.ones(m, np.float32), 0.5 * np.ones(m, np.float32)
    M_inv = np.linalg.inv(H + K14_RHO * G.T @ G).astype(np.float32)
    Mp = np.zeros((PAD, PAD), np.float32)
    Mp[:n, :n] = M_inv
    Gp = np.zeros((PAD, PAD), np.float32)
    Gp[:m, :n] = G
    pad = lambda v: np.concatenate([v, np.zeros(PAD - len(v), np.float32)])
    zeros = np.zeros((1, PAD), np.float32)
    want = j_k14(jnp.asarray(Mp), jnp.asarray(Gp), jnp.asarray(Gp.T.copy()),
                 jnp.asarray(pad(f))[None], jnp.asarray(pad(lo))[None], jnp.asarray(pad(hi))[None],
                 jnp.asarray(zeros), jnp.asarray(zeros), K14_RHO, K14_ITERS, interpret=True)
    ref = j_admm(jnp.asarray(M_inv), jnp.asarray(G), jnp.asarray(f), jnp.asarray(lo),
                 jnp.asarray(hi), jnp.zeros(m, jnp.float32), jnp.zeros(m, jnp.float32),
                 K14_RHO, K14_ITERS)
    return dict(M_inv=M_inv, G=G, f=f, lo=lo, hi=hi, Mp=Mp, Gp=Gp, pad=pad,
                want=[np.asarray(w)[0] for w in want], ref=ref)


def test_k14_plain_matches_jax_kernel_interpret(k14_case):
    c = k14_case
    zeros = torch.zeros(K14_M)
    got = admm_pallas.admm_box_qp_fused(t(c["M_inv"]), t(c["G"]), t(c["G"].T), t(c["f"]),
                                        t(c["lo"]), t(c["hi"]), zeros, zeros, K14_RHO, K14_ITERS)
    for name, g, w, k in zip(("U", "z", "y"), got, c["want"], (K14_N, K14_M, K14_M)):
        close(g, w[:k], 2e-5 * max(1.0, np.abs(w).max()), name)
    close(got[0], np.asarray(c["ref"].primal), 2e-5, "U against JAX admm_box_qp")
    close(got[1], np.asarray(c["ref"].slack), 2e-5, "z against JAX admm_box_qp")
    # the solve is not trivial: slacks sit on their boxes
    assert np.any(np.isclose(got[1].numpy(), c["hi"]) | np.isclose(got[1].numpy(), c["lo"]))


def test_k14_padded_operands_keep_zero_lanes(k14_case):
    """Any n and m: the JAX test's 128-lane padding gives the same solve and
    exact zeros in the padded lanes."""
    c = k14_case
    zeros = torch.zeros(PAD)
    U, z, y = admm_pallas.admm_box_qp_fused(
        t(c["Mp"]), t(c["Gp"]), t(c["Gp"].T), t(c["pad"](c["f"])), t(c["pad"](c["lo"])),
        t(c["pad"](c["hi"])), zeros, zeros, K14_RHO, K14_ITERS)
    close(U[:K14_N], c["want"][0][:K14_N], 2e-5, "U")
    close(z[:K14_M], c["want"][1][:K14_M], 2e-5, "z")
    assert torch.all(U[K14_N:] == 0) and torch.all(z[K14_M:] == 0) and torch.all(y[K14_M:] == 0)


def test_k14_plain_matches_port_admm_box_qp(k14_case):
    """The kernel's plain version (row form, G for both products) and the
    port's ``ops.qp.admm_box_qp`` (column form) are one function."""
    c = k14_case
    zeros = torch.zeros(K14_M)
    got = admm_pallas.admm_box_qp_fused_plain(t(c["M_inv"]), t(c["G"]), t(c["G"].T), t(c["f"]),
                                              t(c["lo"]), t(c["hi"]), zeros, zeros, K14_RHO,
                                              K14_ITERS)
    ref = qp.admm_box_qp(t(c["M_inv"]), t(c["G"]), t(c["f"]), t(c["lo"]), t(c["hi"]), zeros,
                         zeros, K14_RHO, K14_ITERS)
    for name, g, w in zip(("U", "z", "y"), got, ref):
        close(g, w, 2e-5 * max(1.0, float(w.abs().max())), name)


def test_k14_wrapper_checks_operands(k14_case):
    c = k14_case
    zeros = torch.zeros(K14_M)
    args = [t(c["M_inv"]), t(c["G"]), t(c["G"].T), t(c["f"]), t(c["lo"]), t(c["hi"]), zeros,
            zeros, K14_RHO, 5]
    with pytest.raises(ValueError, match="GT"):
        admm_pallas.admm_box_qp_fused(*args[:2], t(c["G"]), *args[3:])
    with pytest.raises(ValueError, match="float32"):
        admm_pallas.admm_box_qp_fused(args[0].double(), *args[1:])
    limit = 232448   # H100: the most dynamic shared memory one block may opt into
    for N in (20, 25):   # the staged MPC's QP: M^-1 and G fit one block at both widths
        assert admm_pallas.explicit_shared_memory_bytes(4 * N, 10 * N) <= limit
    assert admm_pallas.explicit_shared_memory_bytes(200, 500) > limit
    # past that, the vectors alone (among them the two 16-row tables of the
    # products' partial sums, 33,792 bytes here) fit one block with room
    assert admm_pallas.explicit_shared_memory_bytes(200, 500, shared=False) < limit // 4


# ---------------------------------------------------------------------------
# K15
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["isotropic", "ard"])
def test_k15_plain_matches_jax_kernel_interpret(case):
    rng = np.random.default_rng(15)
    if case == "isotropic":
        X1 = rng.normal(size=(300, 10)).astype(np.float32)
        X2 = rng.normal(size=(257, 10)).astype(np.float32)
        ls, sig = 0.5, 1.3
    else:
        X1 = X2 = rng.normal(size=(100, 6)).astype(np.float32)
        ls, sig = np.asarray([0.3, 0.5, 1.0, 2.0, 0.7, 1.5], np.float32), 1.0
    want = j_k15(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(ls), jnp.float32(sig),
                 interpret=True)
    got = rbf_pallas.rbf_kernel_matrix_pallas(t(X1), t(X2), torch.as_tensor(ls), sig)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    close(got, want, 5e-6, case)
    # the plain version is gp.kernels.rbf_kernel in float32, clamp included
    assert torch.all(got <= sig * (1 + 1e-6)) and torch.all(got >= 0)


def test_k15_clamps_cancelled_distances_and_checks_operands():
    """Coincident points give a distance of exactly 0 after the clamp (the
    Gram's diagonal is sigma^2), never above; d > 16 features raise only on
    the card, other shapes and dtypes raise everywhere."""
    X = torch.full((5, 3), 1e3)
    K = rbf_pallas.rbf_kernel_matrix_pallas(X, X, 1.0, 2.0)
    assert torch.all(K == 2.0)
    with pytest.raises(ValueError, match="float32"):
        rbf_pallas.rbf_kernel_matrix_pallas(X.double(), X, 1.0, 2.0)
    with pytest.raises(ValueError, match="X2"):
        rbf_pallas.rbf_kernel_matrix_pallas(X, torch.zeros(5, 4), 1.0, 2.0)


def test_rbf_kernel_diag_matches_jax():
    X = np.random.default_rng(3).normal(size=(7, 4))
    for sig in (1.0, 0.37):
        want = np.asarray(j_rbf_diag(jnp.asarray(X), sig))
        got = rbf_kernel_diag(torch.from_numpy(X), sig)
        assert got.dtype == torch.float64 and tuple(got.shape) == (7,)
        np.testing.assert_array_equal(got.numpy(), want)
    got = rbf_kernel_diag(torch.zeros(2, 3, 4, dtype=torch.float32), torch.tensor(0.5))
    assert tuple(got.shape) == (2, 3) and torch.all(got == 0.5)


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------

K16_B = 6


@pytest.fixture(scope="module", params=[5, 8], ids=["N5", "N8"])
def k16_case(request):
    N = request.param
    jm = JMPC(JCfg(horizon=N, admm_iterations=20, use_fused_controller=True))
    d = jm._fc_data
    n_pad, m_pad = d.SxT.shape[0], d.P1.shape[0]
    m, Nnx, Nnu = 10 * N, 6 * N, 4 * N
    rng = np.random.default_rng(N)
    rows = lambda k, width, scale: np.pad((scale * rng.normal(size=(K16_B, k))).astype(np.float32),
                                          ((0, 0), (0, width - k)))
    X0 = rows(6, n_pad, 1.0)
    X0[:, 2] += 3.0
    W, Z0, Y0 = rows(Nnx, n_pad, 0.02), rows(m, m_pad, 0.3), rows(m, m_pad, 0.1)
    REF = np.pad(np.tile(np.asarray([0.7, 0.2, 3.0, 0.1, 0.0, 0.0], np.float32), (K16_B, N)),
                 ((0, 0), (0, n_pad - Nnx)))
    S = j_shift(N, 4, 6, m_pad)
    want = j_k16(d, S, *(jnp.asarray(a) for a in (X0, W, REF, Z0, Y0)), 8.0, 20, 1.6,
                 interpret=True, block=K16_B)
    data = convert.fused_tick_data_from_numpy(d._asdict(), N, device="cpu")
    cut = lambda a, k: convert.rows_from_numpy(a, k, device="cpu")
    ops = (cut(X0, 6), cut(W, Nnx), cut(REF, Nnx), cut(Z0, m), cut(Y0, m))
    want = [cut(w, k) for w, k in zip(want, (m, m, Nnu, Nnx))]
    return N, data, convert.square_from_numpy(S, m, device="cpu"), ops, want


def test_k16_plain_matches_jax_kernel_interpret(k16_case):
    N, data, S, ops, want = k16_case
    got = controller_pallas.gpmpc_controller_fused_batched(data, S, *ops, 8.0, 20, 1.6)
    for name, g, w in zip(("Z", "Y", "U", "X_tail"), got, want):
        assert g.shape == w.shape
        close(g, w, 1e-5 * max(1.0, float(w.abs().max())), f"N={N}: {name}")


def test_k16_is_k3_on_every_flight(k16_case):
    """K16 = K3 on each flight after the shift; the port's own shift matrix
    is the JAX package's, and a one-row REF is shared by every flight."""
    N, data, S, (X0, W, REF, Z0, Y0), _ = k16_case
    assert torch.equal(S, data.ShiftT)
    got = controller_pallas.gpmpc_controller_fused_batched(data, S, X0, W, REF[:1], Z0, Y0,
                                                           8.0, 20, 1.6)
    for b in range(K16_B):
        one = controller_pallas.gpmpc_controller_fused(
            data, X0[b].contiguous(), W[b].contiguous(), REF[0].contiguous(),
            (Z0[b] @ S).contiguous(), (Y0[b] @ S).contiguous(), 8.0, 20, 1.6)
        for g, w in zip(got, one):
            close(g[b], w, 1e-5 * max(1.0, float(w.abs().max())), f"flight {b}")


def test_k16_wrapper_checks_operands(k16_case):
    N, data, S, (X0, W, REF, Z0, Y0), _ = k16_case
    with pytest.raises(ValueError, match="Z0"):
        controller_pallas.gpmpc_controller_fused_batched(data, S, X0, W, REF, Z0[:, 1:], Y0,
                                                         8.0, 1)
    with pytest.raises(ValueError, match="ShiftT"):
        controller_pallas.gpmpc_controller_fused_batched(data, S[1:], X0, W, REF, Z0, Y0, 8.0, 1)
    # P1 split over a cluster's blocks: every horizon up to the package
    # default fits a block of 8, and a block of 1 holds P1 whole only where
    # it is small
    limit = 232448
    for n in (20, 23, 25):
        assert controller_pallas.fused_batched_shared_memory_bytes(n) <= limit
    assert controller_pallas.fused_slice_pad(25, 8) == 32
    assert controller_pallas.fused_slice_pad(25, 1) > controller_pallas.FUSED_MAX_SLICE


# ---------------------------------------------------------------------------
# K1 and K2 on a per-flight plant block
# ---------------------------------------------------------------------------

PLANT_B = 5


@pytest.fixture(scope="module")
def dispersed():
    """Per-flight bodies and rate loops, the states and commands of a batch."""
    rng = np.random.default_rng(21)
    B = PLANT_B
    mass = (0.5 * np.exp(0.1 * rng.normal(size=B))).astype(np.float32)
    kdl = (0.25 * np.exp(0.3 * rng.normal(size=B))).astype(np.float32)
    taus = (np.asarray([0.05, 0.05, 0.08]) * np.exp(0.2 * rng.normal(size=(B, 3)))).astype(np.float32)
    hover = np.exp(0.03 * rng.normal(size=B)).astype(np.float32)
    wind = (0.8 * rng.normal(size=(B, 3))).astype(np.float32)
    s = (0.3 * rng.normal(size=(B, 12))).astype(np.float32)
    c = np.column_stack([np.ones(B), 0.1 * rng.normal(size=(B, 3))]).astype(np.float32)
    accel = rng.normal(size=(B, 3)).astype(np.float32)
    integ = (0.05 * rng.normal(size=(B, 3))).astype(np.float32)
    bodies = RigidBodyParams(mass=t(mass), gravity=torch.full((B,), 9.81), k_drag_linear=t(kdl),
                             wind=tuple(t(w) for w in wind.T))
    rates = RateLoopParams(tau_roll=t(taus[:, 0]), tau_pitch=t(taus[:, 1]), tau_yaw=t(taus[:, 2]),
                           hover_thrust_norm=t(hover))
    return dict(mass=mass, kdl=kdl, taus=taus, hover=hover, wind=wind, s=s, c=c, accel=accel,
                integ=integ, block=plant_block(bodies, rates, B, device="cpu"))


def test_plant_block_k1_matches_vmapped_jax_k1(dispersed):
    d = dispersed
    want = jax.vmap(lambda s, c, m, k, tau, h, w: j_k1(
        s, c, m, jnp.float32(9.81), k, (tau[0], tau[1], tau[2]), 0.02, 2,
        thrust_gain=jnp.float32(9.81) / h, wind=(w[0], w[1], w[2]), interpret=True,
    ))(*(jnp.asarray(d[k]) for k in ("s", "c", "mass", "kdl", "taus", "hover", "wind")))
    got = plant_pallas._px4_plant_rows(t(d["s"]), t(d["c"]), d["block"], 0.02, 2)
    close(got, want, 2e-6, "K1 state")


def test_plant_block_k2_matches_vmapped_jax_k2(dispersed):
    d = dispersed
    yawrate, yaw = np.float32(0.2), np.float32(0.1)
    want = jax.vmap(lambda s, a, i, m, k, tau, h, w: j_k2(
        s, a, yawrate, yaw, i, m, jnp.float32(9.81), k, (tau[0], tau[1], tau[2]), 0.02, 2,
        thrust_gain=jnp.float32(9.81) / h, wind=(w[0], w[1], w[2]), interpret=True,
    ))(*(jnp.asarray(d[k]) for k in ("s", "accel", "integ", "mass", "kdl", "taus", "hover",
                                     "wind")))
    B = PLANT_B
    cmd = torch.cat([t(d["accel"]), torch.full((B, 1), 0.2), torch.full((B, 1), 0.1),
                     torch.full((B, 1), 1.2)], dim=1)
    state, ctrl, integral = plant_pallas._allocation_plant_rows(t(d["s"]), cmd, t(d["integ"]),
                                                                d["block"], 0.02, 2)
    close(state, want[0], 2e-6, "K2 state")
    close(ctrl[:, 0:4], want[1], 2e-6, "K2 control")
    close(ctrl[:, 4:7], want[2], 2e-6, "K2 attitude setpoint")
    close(integral, want[3], 2e-6, "K2 integral")


def test_plant_block_of_equal_rows_is_the_shared_row(dispersed):
    d = dispersed
    row = d["block"][2]
    block = row.expand(PLANT_B, -1).contiguous()
    s, c = t(d["s"]), t(d["c"])
    assert torch.equal(plant_pallas._px4_plant_rows(s, c, block, 0.02, 2),
                       plant_pallas._px4_plant_rows(s, c, row, 0.02, 2))
    cmd = torch.cat([t(d["accel"]), torch.zeros(PLANT_B, 2), torch.full((PLANT_B, 1), 1.2)], 1)
    for a, b in zip(plant_pallas._allocation_plant_rows(s, cmd, t(d["integ"]), block, 0.02, 2),
                    plant_pallas._allocation_plant_rows(s, cmd, t(d["integ"]), row, 0.02, 2)):
        assert torch.equal(a, b)
    # a block of the wrong height raises; the autodiff routes keep the shared row
    with pytest.raises(ValueError, match="plant_row"):
        plant_pallas._px4_plant_rows(s, c, block[:2].contiguous(), 0.02, 2)
    with pytest.raises(ValueError, match="shared plant row"):
        tick_ad.px4_plant_rows_ad(s, c, block, 0.02, 2)
    with pytest.raises(ValueError, match="shared plant row"):
        tick_ad.allocation_plant_rows_ad(s, cmd, t(d["integ"]), block, 0.02, 2)


def test_plant_block_packs_the_plant_rows(dispersed):
    """``plant_block`` has ``build_plant_row``'s lanes, a shared number
    broadcast to every flight and the thrust gain divided in float32."""
    d = dispersed
    assert tuple(d["block"].shape) == (PLANT_B, 10) and d["block"].dtype == torch.float32
    np.testing.assert_array_equal(d["block"][:, 0].numpy(), d["mass"])
    np.testing.assert_array_equal(d["block"][:, 6].numpy(), np.float32(9.81) / d["hover"])
    np.testing.assert_array_equal(d["block"][:, 7:10].numpy(), d["wind"])
    shared = plant_block(RigidBodyParams(), RateLoopParams(), 3, device="cpu")
    row = plant_pallas.build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81, device="cpu")
    assert torch.equal(shared, row.expand(3, -1))
