"""Port parity for the K13 autodiff routes (``ops.tick_ad``) against the
JAX package on the CPU, where every route's forward is its kernel's plain
version and the plant VJPs are ``torch.func.vjp`` of K1's and K2's plain
versions (the kernels K13a/K13b are held against those on the card by
``chip_smoke.py``).

* ``admm_box_qp_chol`` against JAX: 1e-5 in float32, 1e-10 in float64.
* The traced operand builders against ``build_tick_data`` on the same
  weights: 1e-6.
* ``px4_plant_step_ad`` and ``allocation_plant_tick_ad``: the forward
  bit-equal to the wrappers without a VJP rule; every cotangent (state,
  control or command, integral, plant row) against the JAX custom VJP
  (``_plant_ad_fn``, ``_alloc_ad_fn``, interpret mode) within rtol 1e-4,
  around hover, with the tilt, integral, rate and thrust clamps binding,
  and at zero airspeed.
* ``gpmpc_multitick_ad`` at the JAX tests' widths (N=6, K=2, 8 ticks) with
  no GP, a frozen GP (P=32) and kappa 2: the flight bit-equal with
  ``fused_tick_ad`` on and off; the loss within 1e-5 relative and every
  leaf of the weight gradient within 1e-3 norm-relative of JAX's
  ``value_and_grad`` through its fused tier (no GP and the frozen GP; the
  JAX kappa-2 gradient is NaN, fault F13, and its loss is compared in
  ``tests/test_torch_tuning.py``); the gradient against autograd straight
  through the plain version, and with no GP against the staged tier,
  within 1e-5 (the JAX package's own fused-vs-staged bar,
  ``tests/test_tuning.py``); the gradient reaching every flattened
  ``FusedTickData`` field.
* The F12 guard: a kernel wrapper fed an operand that requires grad raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig as JGPCfg, fit_residual_gp as j_fit
from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig as JLoopCfg, mpc_flight_rollout as j_rollout
from unmanned_aerial_vehicles_tpu.ops.plant_pallas import PAD as J_PAD, build_plant_row as j_plant_row
from unmanned_aerial_vehicles_tpu.ops.qp import admm_box_qp_chol as j_admm_chol
from unmanned_aerial_vehicles_tpu.ops.tick_ad import _alloc_ad_fn, _plant_ad_fn
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference as j_circle_ref
from unmanned_aerial_vehicles_tpu.tuning.autotune import (
    _TracedWeightMPC as JTwin,
    _tracking_loss as j_tracking_loss,
    mpc_weights_theta as j_theta,
)
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig, mpc_flight_rollout
from unmanned_aerial_vehicles_tpu_torch.ops import plant_pallas, tick_ad, tick_pallas
from unmanned_aerial_vehicles_tpu_torch.ops.controller_pallas import (
    build_fused_controller_data,
    gpmpc_controller_fused,
)
from unmanned_aerial_vehicles_tpu_torch.ops.qp import admm_box_qp_chol
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference
from unmanned_aerial_vehicles_tpu_torch.tuning import mpc_weights_theta
from unmanned_aerial_vehicles_tpu_torch.tuning.autotune import _TracedWeightMPC, _tracking_loss

torch.set_num_threads(1)

DT, SUBSTEPS = 0.02, 2
TAUS = (0.05, 0.05, 0.08)
WIND = (0.8, 0.4, 0.0)
PLANT = (0.5, 9.81, 0.25, TAUS, 9.81 / 0.7, WIND)    # mass, g, k_drag, taus, thrust gain, wind
VJP_RTOL, VJP_ATOL = 1e-4, 1e-6
AD_N, AD_K, AD_T, AD_P = 6, 2, 8, 32
LOSS_RTOL, GRAD_NORM_RTOL, FUSED_STAGED_RTOL = 1e-5, 1e-3, 1e-5


def t_circle(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


def j_circle(t):
    pos, _, yaw = j_circle_ref(t, amplitude=2.0, height=3.0)
    return pos, yaw


# ---------------------------------------------------------------------------
# admm_box_qp_chol and the traced operand builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-10)])
def test_admm_box_qp_chol_matches_jax(dtype, tol):
    rng = np.random.default_rng(3)
    n, m = 12, 20
    A = rng.normal(size=(n, n))
    G = np.vstack([np.eye(n), rng.normal(size=(m - n, n))])
    M = A @ A.T + n * np.eye(n) + 4.0 * G.T @ G
    L = np.linalg.cholesky(M)
    f = rng.normal(size=n)
    lower, upper = -0.3 - rng.random(m), 0.3 + rng.random(m)
    z0, y0 = 0.1 * rng.normal(size=m), 0.1 * rng.normal(size=m)
    args = [a.astype(dtype) for a in (L, G, f, lower, upper, z0, y0)]
    want = j_admm_chol(*(jnp.asarray(a) for a in args), 4.0, 40, 1.6)
    got = admm_box_qp_chol(*(torch.tensor(a) for a in args), 4.0, 40, 1.6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)


def test_traced_builders_match_build_tick_data():
    """The tensor builders give the numpy builders' operands (float64 inputs
    on both sides, rounded to float32 once)."""
    mpc = LinearMPC(LinearMPCConfig(horizon=AD_N), dtype=torch.float64, device="cpu")
    ops = (mpc._Sx, mpc._Su, mpc._Sw, mpc._SuT_q, mpc._M_inv, mpc._G, mpc._u_lo, mpc._u_hi,
           mpc._x_lo, mpc._x_hi)
    want = tick_pallas.build_tick_data(
        build_fused_controller_data(*(t.numpy() for t in ops)), AD_N, 4, 6, device="cpu")
    got = tick_ad.build_tick_data_traced(tick_ad.build_fused_controller_data_traced(*ops),
                                         AD_N, 4, 6)
    assert (got.Nnu, got.Nnx) == (want.Nnu, want.Nnx)
    for name in tick_ad.TICK_DATA_TENSORS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == torch.float32 and g.is_contiguous(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=name)
    for name, w in want.ctrl._asdict().items():
        np.testing.assert_allclose(getattr(got.ctrl, name).numpy(), w, rtol=0, atol=1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# K1 / K2 with VJP rules against the JAX custom VJPs
# ---------------------------------------------------------------------------


def plant_cases():
    """``(label, state, control)``: around hover with wind, and at zero
    airspeed (the velocity equal to the wind)."""
    rng = np.random.default_rng(0)
    cases = []
    for i in range(3):
        s = 0.3 * rng.normal(size=12)
        s[2] += 3.0
        c = np.array([1.0 / 0.7 + 0.1 * rng.normal(), *(0.3 * rng.normal(size=3))])
        cases.append((f"hover{i}", s, c))
    s = 0.3 * rng.normal(size=12)
    s[3:6] = WIND
    cases.append(("zero_airspeed", s, np.array([1.2, 0.1, -0.2, 0.05])))
    return [(lab, s.astype(np.float32), c.astype(np.float32)) for lab, s, c in cases]


def alloc_cases():
    """``(label, state, cmd (6,), integral)``: random around hover, every
    clamp binding (tilt, integral, the three rate clips and the thrust
    ceiling), and zero airspeed."""
    rng = np.random.default_rng(1)
    cases = []
    for i in range(3):
        s = 0.3 * rng.normal(size=12)
        cmd = np.array([*(0.8 * rng.normal(size=3)), 0.2 * rng.normal(), 0.3, 1.2])
        cases.append((f"random{i}", s, cmd, 0.05 * rng.normal(size=3)))
    s = np.zeros(12)
    s[6:12] = [0.9, -0.9, 2.0, 2.0, -2.0, 1.5]
    cases.append(("clamps", s, np.array([5.0, -5.0, 9.0, 0.5, -1.0, 1.2]),
                  np.array([0.299, -0.299, 0.299])))
    s = 0.2 * rng.normal(size=12)
    s[3:6] = WIND
    cases.append(("zero_airspeed", s, np.array([0.3, -0.2, 0.4, 0.1, 0.2, 1.2]), np.zeros(3)))
    return [(lab, *(a.astype(np.float32) for a in arrs)) for lab, *arrs in cases]


def plant_row_pair():
    mass, g, kd, taus, tg, wind = PLANT
    return (j_plant_row(mass, g, kd, taus, tg, wind),
            plant_pallas.build_plant_row(mass, g, kd, taus, tg, wind, device="cpu"))


def j_row(v):
    return jnp.zeros((1, J_PAD), jnp.float32).at[0, : v.shape[0]].set(jnp.asarray(v))


def leaf(a):
    return torch.tensor(a)[None].requires_grad_(True)


def jax_value_and_vjp(f):
    def run(ops, ct):
        out, vjp = jax.vjp(f, ops)
        return out, vjp(ct)[0]

    return jax.jit(run)


@pytest.fixture(scope="module")
def j_plant_vjp():
    return jax_value_and_vjp(_plant_ad_fn((DT, SUBSTEPS, True)))


@pytest.fixture(scope="module")
def j_alloc_vjp():
    return jax_value_and_vjp(_alloc_ad_fn((DT, SUBSTEPS, True)))


@pytest.mark.parametrize("case", plant_cases(), ids=lambda c: c[0])
def test_px4_plant_step_ad_matches_jax_vjp(case, j_plant_vjp):
    _, s, c = case
    jprow, prow = plant_row_pair()
    ct = np.random.default_rng(5).normal(size=12).astype(np.float32)
    j_out, (jg_s, jg_c, jg_p) = j_plant_vjp((j_row(s), j_row(c), jprow), jnp.asarray(ct))

    state, control, plant_row = leaf(s), leaf(c), prow.clone().requires_grad_(True)
    out = tick_ad.px4_plant_rows_ad(state, control, plant_row, DT, SUBSTEPS)
    with torch.no_grad():
        raw = plant_pallas._px4_plant_rows(state, control, plant_row, DT, SUBSTEPS)
    assert torch.equal(out, raw)
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(j_out), rtol=0, atol=1e-5)
    got = torch.autograd.grad(out, (state, control, plant_row), torch.tensor(ct)[None])
    for g, w, n in zip(got, (jg_s[0, :12], jg_c[0, :4], jg_p[0, :10]), (12, 4, 10)):
        np.testing.assert_allclose(g.reshape(-1).numpy(), np.asarray(w)[:n], rtol=VJP_RTOL,
                                   atol=VJP_ATOL)


def test_px4_plant_step_ad_signature_keeps_plant_gradients():
    """The drop-in signature: tensor plant scalars keep their gradient and
    match the row route's plant-row cotangent."""
    _, s, c = plant_cases()[0]
    mass = torch.tensor(0.5, requires_grad=True)
    out = tick_ad.px4_plant_step_ad(torch.tensor(s), torch.tensor(c), mass, 9.81, 0.25, TAUS, DT,
                                    thrust_gain=9.81 / 0.7, wind=WIND)
    g_mass, = torch.autograd.grad(out.sum(), mass)
    _, prow = plant_row_pair()
    prow.requires_grad_(True)
    out_rows = tick_ad.px4_plant_rows_ad(torch.tensor(s)[None], torch.tensor(c)[None], prow, DT,
                                         SUBSTEPS)
    g_row, = torch.autograd.grad(out_rows.sum(), prow)
    assert torch.equal(out, out_rows[0])
    assert float(g_mass) == float(g_row[0]) and float(g_mass) != 0.0


@pytest.mark.parametrize("case", alloc_cases(), ids=lambda c: c[0])
def test_allocation_plant_tick_ad_matches_jax_vjp(case, j_alloc_vjp):
    _, s, cmd, integ = case
    jprow, prow = plant_row_pair()
    rng = np.random.default_rng(6)
    cts = [rng.normal(size=n).astype(np.float32) for n in (12, 4, 3, 3)]
    j_out, (jg_s, jg_cmd, jg_int, jg_p) = j_alloc_vjp(
        (j_row(s), j_row(cmd), j_row(integ), jprow), tuple(jnp.asarray(a) for a in cts))

    state, c_row, i_row = leaf(s), leaf(cmd), leaf(integ)
    plant_row = prow.clone().requires_grad_(True)
    outs = tick_ad.allocation_plant_rows_ad(state, c_row, i_row, plant_row, DT, SUBSTEPS)
    with torch.no_grad():
        raw = plant_pallas._allocation_plant_rows(state, c_row, i_row, plant_row, DT, SUBSTEPS)
    for o, r in zip(outs, raw):
        assert torch.equal(o, r)
    np.testing.assert_allclose(outs[0][0].detach().numpy(), np.asarray(j_out[0]), rtol=0,
                               atol=1e-5)
    ct_ctrl = torch.tensor(np.concatenate([cts[1], cts[2]]))[None]
    got = torch.autograd.grad(outs, (state, c_row, i_row, plant_row),
                              (torch.tensor(cts[0])[None], ct_ctrl, torch.tensor(cts[3])[None]))
    wants = (jg_s[0, :12], jg_cmd[0, :6], jg_int[0, :3], jg_p[0, :10])
    for g, w, n in zip(got, wants, (12, 6, 3, 10)):
        np.testing.assert_allclose(g.reshape(-1).numpy(), np.asarray(w)[:n], rtol=VJP_RTOL,
                                   atol=VJP_ATOL)


def test_allocation_plant_tick_ad_signature_matches_rows():
    _, s, cmd, integ = alloc_cases()[0]
    accel = torch.tensor(cmd[:3], requires_grad=True)
    outs = tick_ad.allocation_plant_tick_ad(
        torch.tensor(s), accel, float(cmd[3]), float(cmd[4]), torch.tensor(integ), 0.5, 9.81,
        0.25, TAUS, DT, thrust_gain=9.81 / 0.7, wind=WIND, thrust_ceiling=float(cmd[5]))
    g_accel, = torch.autograd.grad(outs[0].sum() + outs[1].sum(), accel)
    _, prow = plant_row_pair()
    c_row = torch.tensor(cmd)[None].requires_grad_(True)
    rows = tick_ad.allocation_plant_rows_ad(torch.tensor(s)[None], c_row, torch.tensor(integ)[None],
                                            prow, DT, SUBSTEPS)
    g_row, = torch.autograd.grad(rows[0].sum() + rows[1][:, 0:4].sum(), c_row)
    assert torch.equal(outs[0], rows[0][0])
    torch.testing.assert_close(g_accel, g_row[0, :3], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K5 with a VJP rule: whole flights through the fused multi-tick tier
# ---------------------------------------------------------------------------

GP_CASES = ("none", "frozen", "tightened")
# JAX's kappa-2 gradient is NaN (fault F13), so its case is held against
# JAX in tests/test_torch_tuning.py on the loss alone
JAX_GRAD_CASES = ("none", "frozen")


def gp_training_set():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(AD_P, 10))
    X[:, 2] += 3.0
    return X, 0.5 * rng.normal(size=(AD_P, 6))


@pytest.fixture(scope="module")
def posteriors():
    X, Y = gp_training_set()
    jpost = j_fit(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), JGPCfg())
    post = convert.gp_posterior_from_numpy(
        np.asarray(jpost.X_train), np.asarray(jpost.chol), np.asarray(jpost.alpha),
        np.asarray(jpost.y_mean), np.asarray(jpost.y_std),
        np.asarray(jpost.params.length_scale), np.asarray(jpost.params.signal_variance),
        np.asarray(jpost.params.noise_variance), device="cpu",
    )
    return jpost, post


def case_config(case):
    kappa = 2.0 if case == "tightened" else 0.0
    return (JCfg(horizon=AD_N, use_fused_controller=True, tightening_factor=kappa),
            LinearMPCConfig(horizon=AD_N, use_fused_controller=True, tightening_factor=kappa))


AD_LOOP = FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=AD_K, fused_tick_ad=True)


def port_loss(theta, case, post, loop=AD_LOOP, plain=False, base=None):
    base = base if base is not None else case_config(case)[1]
    gp = dict(gp_posterior=post, gp_gain=1.0) if case != "none" else {}
    outs = mpc_flight_rollout(_TracedWeightMPC(theta, base), t_circle, AD_T, cfg=loop,
                              device="cpu", plain_kernels=plain, **gp)
    return _tracking_loss(outs, 2, 1e-3), outs


def port_value_and_grad(theta0, case, post, **kw):
    theta = {k: v.clone().requires_grad_(True) for k, v in theta0.items()}
    loss, _ = port_loss(theta, case, post, **kw)
    grads = torch.autograd.grad(loss, list(theta.values()))
    return float(loss.detach()), dict(zip(theta, grads))


@pytest.fixture(scope="module")
def jax_fused_grads(posteriors):
    """JAX's loss and weight gradient through its fused tier (Pallas in
    interpret mode forward, staged-twin VJP backward), per GP case."""
    jpost, _ = posteriors
    out = {}
    for case in JAX_GRAD_CASES:
        jbase = case_config(case)[0]
        gp = dict(gp_posterior=jpost, gp_gain=1.0) if case != "none" else {}

        def loss(theta, jbase=jbase, gp=gp):
            outs = j_rollout(JTwin(theta, jbase), j_circle, AD_T,
                             cfg=JLoopCfg(use_fused_tick=True, ticks_per_dispatch=AD_K,
                                          fused_tick_ad=True), **gp)
            return j_tracking_loss(outs, 2, 1e-3)

        theta0 = j_theta(jbase)
        value, grads = jax.jit(jax.value_and_grad(loss))(theta0)
        out[case] = ({k: np.asarray(v) for k, v in theta0.items()}, float(value),
                     {k: np.asarray(v) for k, v in grads.items()})
    return out


@pytest.mark.parametrize("case", GP_CASES)
def test_fused_tick_ad_flight_is_bit_identical(case, posteriors):
    _, post = posteriors
    base = case_config(case)[1]
    mpc = LinearMPC(base, device="cpu")
    gp = dict(gp_posterior=post, gp_gain=1.0) if case != "none" else {}
    fly = lambda ad: mpc_flight_rollout(mpc, t_circle, AD_T, device="cpu", **gp,
                                        cfg=FlightLoopConfig(use_fused_tick=True,
                                                             ticks_per_dispatch=AD_K,
                                                             fused_tick_ad=ad))
    on, off = fly(True), fly(False)
    for key in off:
        assert torch.equal(on[key], off[key]), key


@pytest.mark.parametrize("case", JAX_GRAD_CASES)
def test_fused_tick_gradient_matches_jax(case, posteriors, jax_fused_grads):
    _, post = posteriors
    jtheta, j_value, j_grads = jax_fused_grads[case]
    theta0 = convert.mpc_theta_from_numpy(jtheta, device="cpu")
    value, grads = port_value_and_grad(theta0, case, post)
    assert abs(value - j_value) <= LOSS_RTOL * abs(j_value)
    for k, w in j_grads.items():
        g = grads[k].numpy()
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= GRAD_NORM_RTOL, f"{case} {k}: gradient norm-relative gap {rel}"


@pytest.mark.parametrize("case", GP_CASES)
def test_fused_tick_gradient_matches_plain_route(case, posteriors):
    """The K5 route (kernel forward, staged-twin VJP) against autograd
    straight through the plain version (``plain_kernels=True``); with no GP
    also against the staged tier (the JAX package's fused-vs-staged bar)."""
    _, post = posteriors
    theta0 = mpc_weights_theta(case_config(case)[1], device="cpu")
    value, grads = port_value_and_grad(theta0, case, post)
    refs = [port_value_and_grad(theta0, case, post, plain=True)]
    if case == "none":
        staged = LinearMPCConfig(horizon=AD_N)
        refs.append(port_value_and_grad(theta0, case, post, loop=FlightLoopConfig(), base=staged))
    for ref_value, ref_grads in refs:
        np.testing.assert_allclose(value, ref_value, rtol=FUSED_STAGED_RTOL)
        for k, b in ref_grads.items():
            a, b = grads[k].numpy(), b.numpy()
            rel = np.max(np.abs(a - b) / (np.abs(b) + 1e-8))
            assert rel < FUSED_STAGED_RTOL, f"{case} {k}: rel err {rel}"


def test_gradient_reaches_every_tick_data_field(posteriors):
    """Every flattened ``FusedTickData`` tensor of a tightened launch gets a
    nonzero gradient (``Function.apply`` sees only positional tensors)."""
    _, post = posteriors
    mpc = LinearMPC(LinearMPCConfig(horizon=AD_N, admm_iterations=20,
                                    use_fused_controller=True,
                                    state_lower=(-5.0, -5.0, 2.0, -2.5, -2.5, -1.0),
                                    state_upper=(5.0, 5.0, 4.0, 2.5, 2.5, 1.0)), device="cpu")
    fields = ("P1", "PM", "SuTqT", "SxSwT", "P0matT", "SuT", "lo_row", "hi_row", "SwSqT")
    leaves = {f: getattr(mpc._tick_data, f).clone().requires_grad_(True) for f in fields}
    data = mpc._tick_data._replace(**leaves)
    gp = tick_pallas.build_gp_rows(post, 1.0, with_variance=True)
    m, Nnx = mpc.n_constraints, AD_N * 6
    x0 = torch.zeros(12)
    x0[:6] = torch.tensor([0.2, -0.1, 2.9, 2.3, 0.3, -0.1])   # near the 2.5 m/s box
    refs = torch.tensor([3.0, 0.0, 3.0, 4.0, 0.0, 0.0]).repeat(AD_K, AD_N).contiguous()
    _, prow = plant_row_pair()
    statics = dict(k_ticks=AD_K, use_gp=True, rho=8.0, iterations=20, over_relax=1.6, dt=DT,
                   substeps=SUBSTEPS, accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0),
                   yawrate_limit=0.8, n=AD_N, tighten_kappa=2.0)
    outs = tick_ad.gpmpc_multitick_ad(
        data, gp, x0, torch.cat([x0[:6], torch.zeros(3)]), x0[:6].repeat(AD_N).contiguous(),
        torch.zeros(m), torch.zeros(m), refs, torch.zeros(AD_K), prow, **statics)
    loss = sum((o * torch.linspace(0.5, 1.5, o.numel()).reshape(o.shape)).sum() for o in outs)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for f, g in zip(fields, grads):
        assert g is not None and bool(torch.isfinite(g).all()), f
        assert float(g.abs().max()) > 0.0, f"{f} got no gradient"


# ---------------------------------------------------------------------------
# F12: a kernel wrapper never cuts a gradient silently
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K5"])
def test_wrapper_refuses_operands_that_require_grad(kernel):
    _, prow = plant_row_pair()
    s = torch.zeros(1, 12)
    s[0, 2] = 3.0
    mpc = LinearMPC(LinearMPCConfig(horizon=AD_N, use_fused_controller=True), device="cpu")
    data, m = mpc._tick_data, mpc.n_constraints
    statics = dict(k_ticks=AD_K, use_gp=False, rho=8.0, iterations=5, over_relax=1.6, dt=DT,
                   substeps=SUBSTEPS, accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0),
                   yawrate_limit=0.8, n=AD_N)
    calls = {
        "K1": lambda x: plant_pallas._px4_plant_rows(x, torch.ones(1, 4), prow, DT, SUBSTEPS),
        "K2": lambda x: plant_pallas._allocation_plant_rows(
            x, torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.0, 1.2]]), torch.zeros(1, 3), prow, DT,
            SUBSTEPS),
        "K3": lambda x: gpmpc_controller_fused(
            data, x[0, :6], torch.zeros(6 * AD_N), torch.zeros(6 * AD_N), torch.zeros(m),
            torch.zeros(m), 8.0, 5, 1.6),
        "K5": lambda x: tick_pallas.gpmpc_multitick_fused(
            data, None, x[0], torch.zeros(9), torch.zeros(6 * AD_N), torch.zeros(m),
            torch.zeros(m), torch.zeros(AD_K, 6 * AD_N), torch.zeros(AD_K), prow, **statics),
    }
    x = s.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_tick_ad=True"):
        calls[kernel](x)
    with torch.no_grad():
        calls[kernel](x)          # outside grad mode nothing is cut
    calls[kernel](s)
