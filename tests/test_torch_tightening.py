"""Port parity for GP-variance constraint tightening against the JAX package
on the CPU: the plain version of K5's variance branch
(``ops.tick_pallas.multitick_staged`` with ``tighten_kappa > 0``, which the
wrapper runs for CPU tensors) against the JAX kernel in interpret mode and
its staged twin, and the tightened flights on every tier that tightens: the
staged tier (``uncertainty_fn``, through the plain ADMM and through K6), the
frozen-GP and online multi-tick tiers; the staged output correction; and
every ``ValueError`` route the JAX package takes.

All of it runs where the tightened bounds bind: a GP with large targets
(so a large posterior std), tight state boxes and a reference that drives
the velocity to them (``tests/test_online_fused.py``'s regime).

Tolerances: 1e-4 on K5's packed lanes and carries, relative to each
array's largest value where that exceeds 1 (float32 on both sides; the
variance's 32-term quadratic form and the ADMM sums round in another order;
the duals of the bounds that bind reach ~1e4, where float32 keeps ~1e-3);
position gap 1e-4 m on the flights (the port's flight bar).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unmanned_aerial_vehicles_tpu.ops.admm_pallas as j_admm_module
from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    OutputCorrectionConfig as JOCCfg,
    ResidualGPConfig as JGPCfg,
    build_horizon_residuals as j_residuals,
    build_horizon_uncertainty as j_uncertainty,
    fit_residual_gp as j_fit,
    make_output_correction_fn as j_oc_fn,
)
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig as JLoopCfg,
    OnlineFusedGPConfig as JOnline,
    mpc_flight_rollout as j_rollout,
)
from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams as JBody
from unmanned_aerial_vehicles_tpu.ops.plant_pallas import build_plant_row as j_plant_row
from unmanned_aerial_vehicles_tpu.ops.tick_ad import multitick_staged as j_staged
from unmanned_aerial_vehicles_tpu.ops.tick_pallas import (
    build_gp_rows as j_gp_rows,
    build_tick_data as j_tick_data,
    gpmpc_multitick_fused as j_kernel,
)
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
    ResidualGPConfig,
    build_horizon_residuals,
    build_horizon_uncertainty,
    make_output_correction_fn,
)
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    OnlineFusedGPConfig,
    mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.ops import tick_pallas

torch.set_num_threads(1)

N, K, P = 8, 4, 32
KAPPA = 3.0
TIGHT_TOL = 1e-4
FLIGHT_TOL_M = 1e-4
BOXES = dict(state_lower=(-5.0, -5.0, 2.0, -2.5, -2.5, -1.0),
             state_upper=(5.0, 5.0, 4.0, 2.5, 2.5, 1.0))
WIND = (0.8, 0.4, 0.0)


def j_ref(t):
    return jnp.stack([2.0 * jnp.sin(t), 2.0 * jnp.cos(t), 3.0 + 0.0 * t]), jnp.float32(0.0)


def t_ref(t):
    return torch.stack([2.0 * torch.sin(t), 2.0 * torch.cos(t), 3.0 + 0.0 * t], dim=-1), 0.0 * t


def training_set(seed=0, n=P):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 10)) * 2.0
    X[:, 2] += 3.0
    return X.astype(np.float32), (4.0 * rng.normal(size=(n, 6))).astype(np.float32)


@pytest.fixture(scope="module")
def posterior_pair():
    X, Y = training_set()
    jpost = j_fit(jnp.asarray(X), jnp.asarray(Y), JGPCfg())
    post = convert.gp_posterior_from_numpy(
        np.asarray(jpost.X_train), np.asarray(jpost.chol), np.asarray(jpost.alpha),
        np.asarray(jpost.y_mean), np.asarray(jpost.y_std),
        np.asarray(jpost.params.length_scale), np.asarray(jpost.params.signal_variance),
        np.asarray(jpost.params.noise_variance), device="cpu",
    )
    return jpost, post


# ---------------------------------------------------------------------------
# K5's variance branch: one launch, from JAX-built operands
# ---------------------------------------------------------------------------


def statics(kappa):
    return dict(
        k_ticks=K, use_gp=True, rho=8.0, iterations=20, over_relax=1.6, dt=0.02, substeps=2,
        accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0), yawrate_limit=0.8,
        loop_precision="highest", n=N, nu=4, nx=6, tighten_kappa=kappa,
        fallback_error_m=0.0, fallback_thrust_ceiling=1.5, fallback_accel_scale=1.5,
    )


@pytest.fixture(scope="module")
def k5_case(posterior_pair):
    """Operands of one launch flying at 2.3 m/s toward a reference that
    pulls past the 2.5 m/s box, built by the JAX package's own functions."""
    jpost, _ = posterior_pair
    rng = np.random.default_rng(1)
    jm = JMPC(JCfg(horizon=N, admm_iterations=20, use_fused_controller=True, **BOXES))
    data = j_tick_data(jm._fc_data, N, 4, 6)
    gp = j_gp_rows(jpost, 1.0, with_variance=True)
    n_pad, m_pad = jm._fc_data.SxT.shape[0], jm._fc_data.P1.shape[0]
    m = jm.n_constraints
    x0 = np.zeros(12, np.float32)
    x0[:6] = [0.1, 2.0, 3.0, 2.3, 0.1, 0.0]

    def row(v, size):
        r = np.zeros((1, size), np.float32)
        r[0, : len(v)] = v
        return jnp.asarray(r)

    aux = np.zeros(11, np.float32)
    aux[:6] = x0[:6]
    xtail = np.tile(x0[:6], N) + 0.02 * rng.normal(size=N * 6).astype(np.float32)
    z0 = np.zeros(m, np.float32)
    z0[: N * 4] = 0.5 * rng.normal(size=N * 4)
    y0 = (0.1 * rng.normal(size=m)).astype(np.float32)
    refs = np.zeros((K, n_pad), np.float32)
    for k in range(K):
        refs[k, : N * 6] = np.tile([1.5 + 0.1 * k, 2.0, 3.0, 4.0, 0.0, 0.0], N)
    rows = (row(x0, n_pad), row(aux, n_pad), row(xtail, n_pad), row(z0, m_pad),
            row(y0, m_pad), jnp.asarray(refs),
            j_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81, WIND))
    pdata = convert.fused_tick_data_from_numpy(jm._fc_data._asdict(), N, device="cpu")
    pgp = convert.gp_rows_from_numpy(*(np.asarray(a) for a in gp), device="cpu")
    carry = convert.multitick_carry_from_numpy(*(np.asarray(r) for r in rows[:5]), N,
                                               device="cpu")
    prefs = torch.from_numpy(np.ascontiguousarray(refs[:, : N * 6]))
    pyaw = torch.from_numpy(np.ascontiguousarray(refs[:, n_pad - 1]))
    pplant = torch.from_numpy(np.asarray(rows[6])[0, :10].copy())
    port_args = (pdata, pgp, *carry, prefs, pyaw, pplant)
    return data, gp, rows, port_args


def port_view(jax_out):
    packed, state, aux, xtail, z, y = (np.asarray(a) for a in jax_out)
    m = N * 10
    return (packed[:, :32], state[0, :12], np.concatenate([aux[0, :6], aux[0, 8:11]]),
            xtail[0, : N * 6], z[0, :m], y[0, :m])


@pytest.mark.parametrize("against", ["kernel_interpret", "staged_twin"])
def test_k5_tightened_plain_matches_jax(k5_case, against):
    data, gp, rows, port_args = k5_case
    st = statics(KAPPA)
    if against == "kernel_interpret":
        want = j_kernel(data, gp, *rows, interpret=True, **st)
    else:
        want = j_staged(data, gp, *rows, **st)
    got = tick_pallas.gpmpc_multitick_fused(*port_args, **st)
    for name, g, w in zip(("packed", "state", "aux", "xtail", "z", "y"), got, port_view(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TIGHT_TOL * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)
    # the back-off binds here: the same launch without it flies otherwise
    loose = tick_pallas.gpmpc_multitick_fused(*port_args, **statics(0.0))
    assert float((loose[0][:, 25:29] - got[0][:, 25:29]).abs().max()) > 1e-2


def test_tightening_row_caps_and_spares_the_controls(k5_case):
    data, gp, rows, port_args = k5_case
    pdata, pgp = port_args[0], port_args[1]
    # far from the data (K* = 0) the variance is the prior's
    tight = tick_pallas.tightening_row(pdata, pgp, torch.zeros(N, P), 1e6)
    cap = (0.45 * (pdata.hi_row - pdata.lo_row))[N * 4:].reshape(N, 6)
    assert torch.all(tight[: N * 4] == 0.0)
    # a huge kappa: every state row the GP's variance reaches sits at 45% of
    # its box (every velocity row), the others stay at 0
    tight_x = tight[N * 4:].reshape(N, 6)
    torch.testing.assert_close(tight_x[:, 3:], cap[:, 3:], rtol=0, atol=0)
    assert torch.all((tight_x == 0.0) | (tight_x == cap))


# ---------------------------------------------------------------------------
# Tightened flights
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_fused_admm_interpreted(monkeypatch):
    """The JAX MPC calls its K6 without an interpret switch; route it
    through the interpreter on the CPU."""
    monkeypatch.setattr(j_admm_module, "admm_box_qp_fused_composite",
                        functools.partial(j_admm_module.admm_box_qp_fused_composite,
                                          interpret=True))


def assert_flights_agree(got, want):
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
    assert np.all(np.isfinite(got["state"].numpy()))
    gap = np.max(np.abs(got["state"][:, 0:3].numpy() - np.asarray(want["state"][:, 0:3])))
    assert gap <= FLIGHT_TOL_M, gap


@pytest.mark.parametrize("solver", ["admm", "use_fused_admm"])
def test_staged_tightened_flight_matches_jax(posterior_pair, solver, jax_fused_admm_interpreted):
    jpost, post = posterior_pair
    T = 40
    cfg = dict(horizon=N, admm_iterations=40, tightening_factor=KAPPA, **BOXES,
               use_fused_admm=solver == "use_fused_admm")
    gcfg, jgcfg = ResidualGPConfig(), JGPCfg()
    want = j_rollout(
        JMPC(JCfg(**cfg)), j_ref, T, body=JBody(wind=WIND),
        residual_fn=lambda Xg, Ug: j_residuals(jpost, Xg, Ug, jgcfg),
        uncertainty_fn=lambda Xg, Ug: j_uncertainty(jpost, Xg, Ug, jgcfg),
    )
    kw = dict(body=RigidBodyParams(wind=WIND), device="cpu",
              residual_fn=lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gcfg))
    tm = LinearMPC(LinearMPCConfig(**cfg), device="cpu")
    got = mpc_flight_rollout(tm, t_ref, T,
                             uncertainty_fn=lambda Xg, Ug: build_horizon_uncertainty(
                                 post, Xg, Ug, gcfg), **kw)
    assert_flights_agree(got, want)
    loose = mpc_flight_rollout(tm, t_ref, T, **kw)
    assert float((loose["state"][:, 0:3] - got["state"][:, 0:3]).abs().max()) > 1e-2


def test_frozen_gp_multitick_tightened_flight_matches_jax(posterior_pair):
    jpost, post = posterior_pair
    T = 40
    cfg = dict(horizon=N, admm_iterations=40, use_fused_controller=True, **BOXES)
    loop = dict(use_fused_tick=True, ticks_per_dispatch=K)
    flights = {}
    for kappa in (0.0, KAPPA):
        want = j_rollout(JMPC(JCfg(tightening_factor=kappa, **cfg)), j_ref, T,
                         body=JBody(wind=WIND), gp_posterior=jpost, gp_gain=0.1,
                         cfg=JLoopCfg(**loop))
        got = mpc_flight_rollout(
            LinearMPC(LinearMPCConfig(tightening_factor=kappa, **cfg), device="cpu"), t_ref, T,
            body=RigidBodyParams(wind=WIND), gp_posterior=post, gp_gain=0.1,
            cfg=FlightLoopConfig(**loop), device="cpu")
        assert_flights_agree(got, want)
        flights[kappa] = got["state"][:, 0:3]
    assert float((flights[KAPPA] - flights[0.0]).abs().max()) > 1e-2   # the back-off binds


def test_online_multitick_tightened_flight_matches_jax():
    T = 48
    cfg = dict(horizon=N, admm_iterations=40, use_fused_controller=True,
               tightening_factor=KAPPA, **BOXES)
    loop = dict(use_fused_tick=True, ticks_per_dispatch=K, fallback_error_m=1.5)
    want = j_rollout(
        JMPC(JCfg(**cfg)), j_ref, T, body=JBody(wind=(1.5, 0.8, 0.0)), cfg=JLoopCfg(**loop),
        online_gp=JOnline(gp=JGPCfg(max_data_points=32, residual_gain=1.0), refit_every=16,
                          min_samples=4),
        gp_gain=1.0, preview=True,
    )
    got = mpc_flight_rollout(
        LinearMPC(LinearMPCConfig(**cfg), device="cpu"), t_ref, T,
        body=RigidBodyParams(wind=(1.5, 0.8, 0.0)), cfg=FlightLoopConfig(**loop),
        online_gp=OnlineFusedGPConfig(gp=ResidualGPConfig(max_data_points=32, residual_gain=1.0),
                                      refit_every=16, min_samples=4),
        gp_gain=1.0, preview=True, device="cpu",
    )
    np.testing.assert_array_equal(got["gp_count"].numpy(), np.asarray(want["gp_count"]))
    assert int(got["gp_count"][-1]) > 4
    assert_flights_agree(got, want)


def test_staged_output_correction_flight_matches_jax(posterior_pair):
    jpost, post = posterior_pair
    T = 40
    fields = dict(min_train_samples=16, confidence_threshold=10.0, correction_gain=0.05)
    cfg = dict(horizon=N, admm_iterations=40)
    want = j_rollout(JMPC(JCfg(**cfg)), j_ref, T, body=JBody(wind=WIND),
                     output_correction_fn=j_oc_fn(jpost, P, JOCCfg(**fields)))
    occ = convert.output_correction_config_from_fields(fields)
    kw = dict(body=RigidBodyParams(wind=WIND), device="cpu")
    tm = LinearMPC(LinearMPCConfig(**cfg), device="cpu")
    got = mpc_flight_rollout(tm, t_ref, T,
                             output_correction_fn=make_output_correction_fn(post, P, occ), **kw)
    assert_flights_agree(got, want)
    np.testing.assert_allclose(got["u_mpc"].numpy(), np.asarray(want["u_mpc"]), rtol=0,
                               atol=1e-4)
    plain = mpc_flight_rollout(tm, t_ref, T, **kw)
    assert float((plain["u_mpc"] - got["u_mpc"]).abs().max()) > 1e-3   # the correction applied


# ---------------------------------------------------------------------------
# The ValueError routes of the JAX package
# ---------------------------------------------------------------------------

ROUTES = ("uncertainty_fn_on_multitick", "output_correction_on_multitick",
          "tightening_on_single_tick", "fused_controller_with_uncertainty",
          "resume_on_staged_tier")


@pytest.mark.parametrize("route", ROUTES)
def test_tightening_routes_raise_value_error_as_jax(posterior_pair, route):
    jpost, post = posterior_pair
    cfg = dict(horizon=N, use_fused_controller=True, tightening_factor=1.0)
    multi = dict(use_fused_tick=True, ticks_per_dispatch=K)
    unc_j = lambda Xg, Ug: j_uncertainty(jpost, Xg, Ug, JGPCfg())
    unc_t = lambda Xg, Ug: build_horizon_uncertainty(post, Xg, Ug, ResidualGPConfig())
    if route == "uncertainty_fn_on_multitick":
        jkw, tkw = dict(loop=multi, uncertainty_fn=unc_j), dict(loop=multi, uncertainty_fn=unc_t)
    elif route == "output_correction_on_multitick":
        jkw = dict(loop=multi, output_correction_fn=j_oc_fn(jpost, P))
        tkw = dict(loop=multi, output_correction_fn=make_output_correction_fn(post, P))
    elif route == "tightening_on_single_tick":
        jkw, tkw = dict(loop=dict(use_fused_tick=True)), dict(loop=dict(use_fused_tick=True))
    elif route == "fused_controller_with_uncertainty":
        jkw, tkw = dict(loop={}, uncertainty_fn=unc_j), dict(loop={}, uncertainty_fn=unc_t)
    else:
        jkw, tkw = dict(loop={}, return_resume=True), dict(loop={}, return_resume=True)
    jloop, tloop = jkw.pop("loop"), tkw.pop("loop")
    with pytest.raises(ValueError):
        j_rollout(JMPC(JCfg(**cfg)), j_ref, K, cfg=JLoopCfg(**jloop), **jkw)
    with pytest.raises(ValueError):
        mpc_flight_rollout(LinearMPC(LinearMPCConfig(**cfg), device="cpu"), t_ref, K,
                           cfg=FlightLoopConfig(**tloop), device="cpu", **tkw)


def test_tightening_kernel_without_variance_rows_raises_as_jax(k5_case):
    data, gp, rows, port_args = k5_case
    with pytest.raises(ValueError, match="with_variance"):
        j_kernel(data, gp._replace(kinv=None, y_std_row=None), *rows, interpret=True,
                 **statics(KAPPA))
    with pytest.raises(ValueError, match="with_variance"):
        tick_pallas.gpmpc_multitick_fused(port_args[0], port_args[1]._replace(kinv=None),
                                          *port_args[2:], **statics(KAPPA))
