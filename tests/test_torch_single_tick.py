"""Port parity for the single-tick fused tier and the fused MPC solves: the
plain versions of K6 (fused composite ADMM), K3 (fused controller) and K4
(whole tick), which the wrappers run for CPU tensors, against the JAX
package's Pallas kernels in interpret mode from identical operands carried
across with ``convert``; ``LinearMPC.solve`` with ``use_fused_controller``
and ``use_fused_admm``; the single-tick flight; and trajectory preview on
all three tiers.

Tolerances:
- K6, K3, K4 plain against the interpret-mode kernels 1e-5: float32 on
  both sides, products summed in other orders (~1e-7 relative each), 20
  ADMM iterations amplify that by at most ~10x on O(1) iterates.
- The fused solves over three warm-started ticks 1e-4 (the JAX package's
  own bar for its fused solves against the staged ones,
  ``tests/test_pallas_ops.py:99``, ``:211``).
- Flights through float32 kernels (single-tick, multi-tick) 1e-4 m in
  position, the online flight test's bar; the staged float64 preview
  flight 1e-9 m (only summation order differs, as for the staged flight).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unmanned_aerial_vehicles_tpu.ops.admm_pallas as j_admm_module
from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    ResidualGPConfig as JGPCfg,
    build_horizon_residuals as j_residuals,
    fit_residual_gp as j_fit,
)
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig as JLoopCfg,
    OnlineFusedGPConfig as JOnline,
    mpc_flight_rollout as j_rollout,
)
from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams as JBody
from unmanned_aerial_vehicles_tpu.ops.controller_pallas import gpmpc_controller_fused as j_k3
from unmanned_aerial_vehicles_tpu.ops.plant_pallas import build_plant_row as j_plant_row
from unmanned_aerial_vehicles_tpu.ops.tick_pallas import (
    build_tick_data as j_tick_data,
    gpmpc_tick_fused as j_k4,
)
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference as j_fig8
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
    ResidualGPConfig,
    build_horizon_residuals,
)
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    OnlineFusedGPConfig,
    mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.ops import admm_pallas, controller_pallas, tick_pallas
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

torch.set_num_threads(1)

N = 10
WIND = (0.8, 0.4, 0.0)
STATICS = dict(rho=8.0, iterations=20, over_relax=1.6)
PLANT = dict(dt=0.02, substeps=2, accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0),
             yawrate_limit=0.8, fallback_thrust_ceiling=1.5, fallback_accel_scale=1.5)


def j_ref(t):
    pos, yaw = j_fig8(t, 6.0, 0.02)
    return pos + jnp.asarray([0.0, 0.0, 3.0], pos.dtype), yaw


def t_ref(t):
    pos, yaw = ramped_figure8_reference(t, 6.0, 0.02)
    return pos + torch.tensor([0.0, 0.0, 3.0], dtype=pos.dtype), yaw


def jrow(v, size):
    r = np.zeros((1, size), np.float32)
    r[0, : len(v)] = v
    return jnp.asarray(r)


def close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[10, 25], ids=["N10", "N25"])
def k6_case(request):
    horizon = request.param
    rng = np.random.default_rng(horizon)
    jm = JMPC(JCfg(horizon=horizon, use_fused_admm=True))
    m, n = jm.n_constraints, jm.n_primal
    m_pad, n_pad = jm._m_pad, jm._n_pad
    f32 = lambda a: np.asarray(a, np.float32)
    f = rng.normal(size=n)                      # a condensed gradient
    p0 = f32(-np.asarray(jm._GMinv, np.float64) @ f)
    minvf = f32(np.asarray(jm._M_inv, np.float64) @ f)
    lower = f32(np.concatenate([np.asarray(jm._u_lo), -rng.uniform(0.001, 0.02, m - n)]))
    upper = f32(np.concatenate([np.asarray(jm._u_hi), rng.uniform(0.001, 0.02, m - n)]))
    z0, y0 = f32(0.3 * rng.normal(size=m)), f32(0.1 * rng.normal(size=m))
    want = j_admm_module.admm_box_qp_fused_composite(
        jm._P1_pad, jrow(p0, m_pad), jm._GMinvT_pad, jrow(minvf, n_pad), jrow(lower, m_pad),
        jrow(upper, m_pad), jrow(z0, m_pad), jrow(y0, m_pad), 8.0, 20, 1.6, interpret=True,
    )
    P1, GMinvT = convert.composite_admm_operands_from_numpy(jm._P1_pad, jm._GMinvT_pad, horizon,
                                                            device="cpu")
    t = lambda a: torch.from_numpy(a)
    got = admm_pallas.admm_box_qp_fused_composite(P1, t(p0), GMinvT, t(minvf), t(lower),
                                                   t(upper), t(z0), t(y0), 8.0, 20, 1.6)
    want = tuple(convert.row_from_numpy(w, k, device="cpu")
                 for w, k in zip(want, (n, m, m)))
    return horizon, got, want, (lower, upper)


def test_k6_plain_matches_jax_kernel_interpret(k6_case):
    horizon, got, want, (lower, upper) = k6_case
    for name, g, w in zip(("U", "z", "y"), got, want):
        close(g, w, 1e-5, f"N={horizon}: {name}")
    # the solve is not trivial: some slacks sit on their boxes
    z = got[1].numpy()
    assert np.any(np.isclose(z, lower) | np.isclose(z, upper))


def test_k6_shared_memory_variants():
    limit = 232448   # H100: the most dynamic shared memory one block may opt into
    assert admm_pallas.shared_memory_bytes(200) <= limit            # N=20: P1 in shared memory
    assert admm_pallas.shared_memory_bytes(250) > limit             # N=25: P1 through L2
    assert admm_pallas.shared_memory_bytes(250, p1_shared=False) < 8192
    # K3 keeps P1's factors in registers or device memory: its vectors only
    for n in (20, 25, 30):
        assert controller_pallas.controller_shared_memory_bytes(n) < 16384


# ---------------------------------------------------------------------------
# K3 and K4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jm_fused():
    jm = JMPC(JCfg(horizon=N, admm_iterations=20, use_fused_controller=True))
    pdata = convert.fused_tick_data_from_numpy(jm._fc_data._asdict(), N, device="cpu")
    return jm, pdata


def tick_inputs(seed):
    rng = np.random.default_rng(seed)
    m, Nnx = N * 10, N * 6
    state = np.zeros(12, np.float32)
    state[:3] = [0.2, -0.1, 2.7]
    state[3:9] = [0.3, 0.1, -0.2, 0.05, -0.04, 0.3]
    w = (0.02 * rng.normal(size=Nnx)).astype(np.float32)
    ref = np.tile(np.asarray([0.7, 0.2, 3.0, 0.1, 0.0, 0.0], np.float32), N)
    z0 = (0.3 * rng.normal(size=m)).astype(np.float32)
    y0 = (0.1 * rng.normal(size=m)).astype(np.float32)
    return state, w, ref, z0, y0


def test_k3_plain_matches_jax_kernel_interpret(jm_fused):
    jm, pdata = jm_fused
    n_pad, m_pad = jm._fc_data.SxT.shape[0], jm._fc_data.P1.shape[0]
    state, w, ref, z0, y0 = tick_inputs(3)
    want = j_k3(jm._fc_data, jrow(state[:6], n_pad), jrow(w, n_pad), jrow(ref, n_pad),
                jrow(z0, m_pad), jrow(y0, m_pad), 8.0, 20, 1.6, interpret=True)
    t = torch.from_numpy
    got = controller_pallas.gpmpc_controller_fused(pdata, t(state[:6].copy()), t(w), t(ref),
                                                   t(z0), t(y0), 8.0, 20, 1.6)
    for name, g, w_, k in zip(("z", "y", "U", "X_tail"), got, want,
                              (N * 10, N * 10, N * 4, N * 6)):
        close(g, convert.row_from_numpy(w_, k, device="cpu"), 1e-5, name)


K4_CASES = {
    "plain": dict(fallback_error_m=0.0, estimate=False, tight=False),
    "estimate_tight": dict(fallback_error_m=0.0, estimate=True, tight=True),
    "estimate_tight_fallback": dict(fallback_error_m=0.3, estimate=True, tight=True),
}


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_plain_matches_jax_kernel_interpret(jm_fused, case):
    jm, pdata = jm_fused
    spec = K4_CASES[case]
    n_pad, m_pad = jm._fc_data.SxT.shape[0], jm._fc_data.P1.shape[0]
    m = N * 10
    state, w, ref, z0, y0 = tick_inputs(4)
    rng = np.random.default_rng(5)
    cstate = state.copy()
    if spec["estimate"]:
        cstate += (0.05 * rng.normal(size=12)).astype(np.float32)
    tight = np.zeros(m, np.float32)
    if spec["tight"]:
        tight[N * 4:] = rng.uniform(0.0, 0.4, N * 6)
    misc = np.asarray([0.1, 0.02, -0.01, 0.05], np.float32)
    jplant = j_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81, WIND)
    fb = spec["fallback_error_m"]
    want = j_k4(
        j_tick_data(jm._fc_data, N, 4, 6), jrow(state, n_pad), jrow(w, n_pad), jrow(ref, n_pad),
        jrow(misc, n_pad), jrow(z0, m_pad), jrow(y0, m_pad), jplant,
        interpret=True, nnu=N * 4, nnx=N * 6, fallback_error_m=fb,
        ctrl_state_row=jrow(cstate, n_pad), tight_row=jrow(tight, m_pad), **STATICS,
        **{k: v for k, v in PLANT.items()},
    )
    t = lambda a: torch.from_numpy(np.array(a))
    got = tick_pallas.gpmpc_tick_fused(
        pdata, t(state), t(w), t(ref), t(misc), t(z0), t(y0),
        t(np.asarray(jplant)[0, :10]), n=N, fallback_error_m=fb,
        ctrl_state=t(cstate) if spec["estimate"] else None,
        tight=t(tight) if spec["tight"] else None, **STATICS, **PLANT,
    )
    for name, g, w_, k in zip(("packed", "z", "y", "U", "X_tail"), got, want,
                              (25, m, m, N * 4, N * 6)):
        close(g, convert.row_from_numpy(w_, k, device="cpu"), 1e-5, f"{case}: {name}")
    packed = got[0].numpy()
    mpc_cmd = np.clip(got[1].numpy()[0:3], PLANT["accel_lo"], PLANT["accel_hi"])
    engaged = np.max(np.abs(packed[22:25] - mpc_cmd)) > 1e-3
    assert engaged == (fb > 0.0), "the hover fallback engages exactly when asked"


def test_k4_wrapper_checks_operands(jm_fused):
    _, pdata = jm_fused
    m = N * 10
    args = [torch.zeros(12), torch.zeros(N * 6), torch.zeros(N * 6), torch.zeros(4),
            torch.zeros(m), torch.zeros(m), torch.zeros(10)]
    kw = dict(**STATICS, **PLANT)
    with pytest.raises(ValueError, match="shape"):
        tick_pallas.gpmpc_tick_fused(pdata, torch.zeros(11), *args[1:], **kw)
    with pytest.raises(ValueError, match="float32"):
        tick_pallas.gpmpc_tick_fused(pdata, *args[:4], torch.zeros(m).double(), *args[5:], **kw)
    with pytest.raises(ValueError, match="shape"):
        tick_pallas.gpmpc_tick_fused(pdata, *args, tight=torch.zeros(m - 1), **kw)
    with pytest.raises(ValueError, match="horizon"):
        tick_pallas.gpmpc_tick_fused(pdata, *args, n=N + 1, **kw)
    out = tick_pallas.gpmpc_tick_fused(pdata, *args, **kw)
    assert [tuple(o.shape) for o in out] == [(25,), (m,), (m,), (N * 4,), (N * 6,)]


# ---------------------------------------------------------------------------
# LinearMPC.solve through K3 and K6
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_fused_admm_interpreted(monkeypatch):
    """The JAX MPC calls its K6 without an interpret switch; route it
    through the interpreter on the CPU, as ``tests/test_pallas_ops.py``
    runs the kernel."""
    monkeypatch.setattr(j_admm_module, "admm_box_qp_fused_composite",
                        functools.partial(j_admm_module.admm_box_qp_fused_composite,
                                          interpret=True))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("mode", ["use_fused_controller", "use_fused_admm"])
def test_fused_solves_match_jax(mode, dtype, jax_fused_admm_interpreted):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.float64, torch.float64)
    cfg = dict(horizon=N, admm_iterations=20, **{mode: True})
    jm = JMPC(JCfg(**cfg), dtype=jdt)
    tm = LinearMPC(LinearMPCConfig(**cfg), dtype=tdt, device="cpu")
    rng = np.random.default_rng(7)
    x = np.asarray([0.3, -0.2, 2.8, 0.4, 0.1, -0.1])
    target = np.asarray([0.8, 0.3, 3.0])
    jc, tc = jm.init_carry(jnp.asarray(x, jdt)), tm.init_carry(torch.tensor(x, dtype=tdt))
    for tick in range(3):
        res = 0.5 * rng.normal(size=(N, 6))
        refs = (np.tile(np.concatenate([target, np.zeros(3)]), (N, 1))
                + 0.1 * rng.normal(size=(N, 6))) if tick == 2 else None
        ju, jX, jc = jm.solve(jc, jnp.asarray(x, jdt), jnp.asarray(target, jdt),
                              jnp.asarray(res, jdt),
                              reference_states=None if refs is None else jnp.asarray(refs, jdt))
        tu, tX, tc = tm.solve(tc, torch.tensor(x, dtype=tdt), torch.tensor(target, dtype=tdt),
                              torch.tensor(res, dtype=tdt),
                              reference_states=None if refs is None else torch.tensor(refs, dtype=tdt))
        assert tu.dtype == tdt and tX.dtype == tdt and tc.slack.dtype == tdt
        for name, g, w in (("u0", tu, ju), ("X_opt", tX, jX), ("slack", tc.slack, jc.slack),
                           ("dual", tc.dual, jc.dual), ("U_prev", tc.U_prev, jc.U_prev)):
            close(g.numpy(), w, 1e-4, f"{mode} {dtype} tick {tick}: {name}")
        x = np.asarray(jX[1])     # fly to the predicted next state


# ---------------------------------------------------------------------------
# Flights: the single-tick tier, and preview on every tier
# ---------------------------------------------------------------------------


def posterior_pair(seed=1, n=48):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 10)) * 0.5
    X[:, 2] += 3.0
    Y = 0.05 * rng.normal(size=(n, 6)) + 0.02
    jpost = j_fit(jnp.asarray(X), jnp.asarray(Y), JGPCfg())
    post = convert.gp_posterior_from_numpy(
        np.asarray(jpost.X_train), np.asarray(jpost.chol), np.asarray(jpost.alpha),
        np.asarray(jpost.y_mean), np.asarray(jpost.y_std),
        np.asarray(jpost.params.length_scale), np.asarray(jpost.params.signal_variance),
        np.asarray(jpost.params.noise_variance), device="cpu",
    )
    return jpost, post


def assert_flights_agree(got, want, pos_tol):
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
        if got[key].is_floating_point():
            assert got[key].dtype == torch.float32, key
    gap = np.max(np.abs(got["state"][:, 0:3].numpy() - np.asarray(want["state"][:, 0:3])))
    assert gap <= pos_tol, gap
    assert np.all(np.isfinite(got["state"].numpy()))


SINGLE_TICK_CASES = {
    "gp": dict(preview=False, fallback_error_m=0.0),
    "gp_preview": dict(preview=True, fallback_error_m=0.0),
    "gp_fallback": dict(preview=False, fallback_error_m=0.2),
}


@pytest.mark.parametrize("case", sorted(SINGLE_TICK_CASES))
def test_single_tick_flight_matches_jax(case):
    spec = SINGLE_TICK_CASES[case]
    T = 30
    jpost, post = posterior_pair()
    jg, tg = JGPCfg(residual_gain=1.0), ResidualGPConfig(residual_gain=1.0)
    cfg = dict(horizon=N, admm_iterations=20, use_fused_controller=True)
    loop = dict(use_fused_tick=True, fallback_error_m=spec["fallback_error_m"])
    # start 0.37 m off the reference: the fallback case engages at once
    x0 = np.zeros(12, np.float32)
    x0[:3] = [0.3, -0.2, 2.9]
    want = j_rollout(JMPC(JCfg(**cfg)), j_ref, T, body=JBody(wind=WIND), cfg=JLoopCfg(**loop),
                     initial_state=jnp.asarray(x0),
                     residual_fn=lambda X, U: j_residuals(jpost, X, U, jg),
                     preview=spec["preview"])
    got = mpc_flight_rollout(LinearMPC(LinearMPCConfig(**cfg), device="cpu"), t_ref, T,
                             body=RigidBodyParams(wind=WIND), cfg=FlightLoopConfig(**loop),
                             initial_state=torch.from_numpy(x0),
                             residual_fn=lambda X, U: build_horizon_residuals(post, X, U, tg),
                             preview=spec["preview"], device="cpu")
    assert_flights_agree(got, want, 1e-4)
    for key in ("u_mpc", "vel_ref", "accel_cmd", "thrust"):
        close(got[key].numpy(), want[key], 1e-4, f"{case}: {key}")
    if spec["fallback_error_m"] > 0.0:
        mpc_cmd = np.clip(got["u_mpc"].numpy()[:, 0:3], PLANT["accel_lo"], PLANT["accel_hi"])
        assert np.any(np.abs(got["accel_cmd"].numpy() - mpc_cmd).max(axis=1) > 1e-3)


def test_staged_preview_flight_matches_jax_f64():
    cfg = dict(horizon=N, admm_iterations=20)
    T = 40
    want = j_rollout(JMPC(JCfg(**cfg), dtype=jnp.float64), j_ref, T, preview=True,
                     dtype=jnp.float64)
    got = mpc_flight_rollout(LinearMPC(LinearMPCConfig(**cfg), dtype=torch.float64,
                                       device="cpu"), t_ref, T, preview=True,
                             dtype=torch.float64, device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
    close(got["state"][:, 0:3].numpy(), want["state"][:, 0:3], 1e-9, "position")
    close(got["vel_ref"].numpy(), want["vel_ref"], 1e-8, "vel_ref")
    # preview changes the flight: the point-target flight lags behind it
    point = mpc_flight_rollout(LinearMPC(LinearMPCConfig(**cfg), dtype=torch.float64,
                                         device="cpu"), t_ref, T, dtype=torch.float64,
                               device="cpu")
    assert np.max(np.abs(point["state"].numpy() - got["state"].numpy())) > 1e-3


@pytest.mark.parametrize("gp_mode", ["frozen", "online"])
def test_multitick_preview_flight_matches_jax(gp_mode):
    K, T = 4, 24
    cfg = dict(horizon=N, admm_iterations=20, use_fused_controller=True)
    loop = dict(use_fused_tick=True, ticks_per_dispatch=K)
    if gp_mode == "frozen":
        jpost, post = posterior_pair()
        jkw, tkw = dict(gp_posterior=jpost, gp_gain=1.0), dict(gp_posterior=post, gp_gain=1.0)
    else:
        jkw = dict(online_gp=JOnline(gp=JGPCfg(max_data_points=32, residual_gain=1.0),
                                     refit_every=8, min_samples=4), gp_gain=1.0)
        tkw = dict(online_gp=OnlineFusedGPConfig(
            gp=ResidualGPConfig(max_data_points=32, residual_gain=1.0), refit_every=8,
            min_samples=4), gp_gain=1.0)
    want = j_rollout(JMPC(JCfg(**cfg)), j_ref, T, body=JBody(wind=WIND), cfg=JLoopCfg(**loop),
                     preview=True, **jkw)
    got = mpc_flight_rollout(LinearMPC(LinearMPCConfig(**cfg), device="cpu"), t_ref, T,
                             body=RigidBodyParams(wind=WIND), cfg=FlightLoopConfig(**loop),
                             preview=True, device="cpu", **tkw)
    if gp_mode == "online":
        np.testing.assert_array_equal(got["gp_count"].numpy(), np.asarray(want["gp_count"]))
    assert_flights_agree(got, want, 1e-4)
