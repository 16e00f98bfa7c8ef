"""Port parity for the estimation tier: the closed-form Jacobians, the
staged filter steps and the staged noisy flight against the JAX package on
the CPU, and the noisy loop's routing.

Tolerances: the Jacobians against ``torch.func.jacfwd`` 1e-10 in float64
(the same derivative, closed form against automatic differentiation); the
filter steps 1e-10 in float64 (the same algebra, a 9x9 solve in another
library); the staged noisy flight 1e-9 m in float64 over 50 ticks (the same
draws through ``noise=``; the staged MPC flight's own float64 bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.estimation import disturbance as j_dist, ekf as j_ekf
from unmanned_aerial_vehicles_tpu.estimation.noisy_loop import noisy_mpc_flight_rollout as j_noisy
from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams as JBody
from unmanned_aerial_vehicles_tpu.models.px4_surrogate import RateLoopParams as JRate
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference as j_fig8
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.estimation import (
    DisturbanceEKFConfig,
    DisturbanceEKFState,
    EKFConfig,
    EKFState,
    dekf_step,
    disturbance_residual_rows,
    disturbance_residual_rows12,
    ekf_step,
    noisy_mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig, OnlineFusedGPConfig
from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.models.px4_surrogate import (
    RateLoopParams,
    _derivative,
    derivative_jacobian,
    px4_rate_tracking_step,
    px4_step_jacobian,
)
from unmanned_aerial_vehicles_tpu_torch.ops import plant_pallas
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

torch.set_num_threads(1)

HORIZON, T_STAGED = 10, 50
WIND, GUST = (0.8, 0.4, 0.0), (1.5, 0.8, 0.0)
f64 = torch.float64


def j_ref(t):
    pos, yaw = j_fig8(t, 6.0, 0.02)
    return pos + jnp.asarray([0.0, 0.0, 3.0], pos.dtype), yaw


def t_ref(t):
    pos, yaw = ramped_figure8_reference(t, 6.0, 0.02)
    return pos + torch.tensor([0.0, 0.0, 3.0], dtype=pos.dtype), yaw


def jax_normals(T, dtype, seed=0):
    """The JAX noisy loop's sensor draws: split(key, T), 9 standard normals
    per tick (``estimation/ekf.py:measure``)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), T)
    return np.array(jax.vmap(lambda k: jax.random.normal(k, (9,), dtype))(keys))


def state_and_control(seed, zero_airspeed=False):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=12)
    s[6:9] = rng.uniform(-1.0, 1.0, 3)
    s[8] = 3.1                              # yaw next to the seam
    if zero_airspeed:
        s[3:6] = WIND
    u = np.concatenate([[0.6 + 0.7 * rng.random()], rng.normal(size=3)])
    return s, u


@pytest.mark.parametrize("case", ["random_0", "random_1", "zero_airspeed"])
def test_closed_form_jacobians_match_jacfwd(case):
    s, u = state_and_control(int(case[-1]) if case != "zero_airspeed" else 2,
                             zero_airspeed=case == "zero_airspeed")
    st, ut = torch.tensor(s, dtype=f64), torch.tensor(u, dtype=f64)
    body, rates = RigidBodyParams(wind=WIND), RateLoopParams()
    J = derivative_jacobian(st, ut, body, rates)
    J_ad = torch.func.jacfwd(lambda x: _derivative(x, ut, body, rates))(st)
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), rtol=0, atol=1e-10)
    F = px4_step_jacobian(st, ut, body, rates, 0.02)
    F_ad = torch.func.jacfwd(lambda x: px4_rate_tracking_step(x, ut, body, rates, 0.02))(st)
    np.testing.assert_allclose(F.numpy(), F_ad.numpy(), rtol=0, atol=1e-10)
    # the kernel's elementwise Jacobian (the plain version of the device
    # code in csrc/plant_math.cuh) on the same plant row, in float64
    row = torch.tensor([body.mass, body.gravity, body.k_drag_linear, rates.tau_roll,
                        rates.tau_pitch, rates.tau_yaw, body.gravity / rates.hover_thrust_norm,
                        *WIND], dtype=f64)
    J_rows = plant_pallas._jacobian(tuple(st), tuple(ut), plant_pallas._read_plant(row))
    np.testing.assert_allclose(J_rows.numpy(), J.numpy(), rtol=0, atol=1e-10)


def filter_inputs(observer, seed=5):
    rng = np.random.default_rng(seed)
    n = 15 if observer else 12
    s, u = state_and_control(seed)
    x = np.concatenate([s, [0.4, -0.2, 0.1]])[:n]
    A = 0.05 * rng.normal(size=(n, n))
    P = np.diag(np.linspace(0.02, 0.004, n)) + A @ A.T
    z = s[list(j_ekf.MEASURED_IDX)] + 0.03 * rng.normal(size=9)
    z[5] = -3.1                             # the yaw sample across the seam
    return x, P, u, z


@pytest.mark.parametrize("observer", [False, True], ids=["ekf", "observer"])
def test_filter_step_matches_jax_f64(observer):
    x, P, u, z = filter_inputs(observer)
    J = lambda a: jnp.asarray(a, jnp.float64)
    T = lambda a: torch.tensor(a, dtype=f64)
    # jitted: the eager JAX step dispatches its Jacobian op by op (~10 s)
    if observer:
        jc, w, d = jax.jit(lambda c, u, z: j_dist.dekf_step(
            c, u, z, JBody(), JRate(), 0.02, j_dist.DisturbanceEKFConfig()))(
            j_dist.DisturbanceEKFState(x=J(x), P=J(P)), J(u), J(z))
        tc, wt, dt_ = dekf_step(DisturbanceEKFState(x=T(x), P=T(P)), T(u), T(z),
                                RigidBodyParams(), RateLoopParams(), 0.02,
                                DisturbanceEKFConfig())
        np.testing.assert_allclose(dt_.numpy(), np.asarray(d), rtol=0, atol=1e-10)
    else:
        jc, w = jax.jit(lambda c, u, z: j_ekf.ekf_step(
            c, u, z, JBody(wind=WIND), JRate(), 0.02, j_ekf.EKFConfig()))(
            j_ekf.EKFState(x=J(x), P=J(P)), J(u), J(z))
        tc, wt = ekf_step(EKFState(x=T(x), P=T(P)), T(u), T(z), RigidBodyParams(wind=WIND),
                          RateLoopParams(), 0.02, EKFConfig())
    np.testing.assert_allclose(wt.numpy(), np.asarray(w), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tc.x.numpy(), np.asarray(jc.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tc.P.numpy(), np.asarray(jc.P), rtol=0, atol=1e-10)
    assert torch.equal(tc.P, tc.P.T)
    assert abs(float(tc.x[8])) <= np.pi         # the yaw estimate wrapped


def test_disturbance_rows():
    d = torch.tensor([0.3, -0.1, 0.2])
    rows = disturbance_residual_rows(d, 4)
    assert tuple(rows.shape) == (4, 6) and torch.equal(rows[:, 3:6], d.expand(4, 3))
    assert torch.all(rows[:, 0:3] == 0)
    rows12 = disturbance_residual_rows12(d, 4)
    assert tuple(rows12.shape) == (4, 12) and torch.equal(rows12[:, 3:6], d.expand(4, 3))
    assert float(rows12.abs().sum()) == pytest.approx(4 * float(d.abs().sum()))


STAGED_CASES = {
    "ekf": dict(),
    "observer_gust": dict(disturbance_observer=True),
}


@pytest.mark.parametrize("case", sorted(STAGED_CASES))
def test_staged_noisy_flight_matches_jax_f64(case):
    cfg = dict(horizon=HORIZON, admm_iterations=20)
    normals = jax_normals(T_STAGED, jnp.float64)
    jkw, tkw = dict(STAGED_CASES[case]), dict(STAGED_CASES[case])
    if case == "observer_gust":
        # the wind steps up at t = 0.4 s (tick 20)
        jkw["wind_fn"] = lambda t: jnp.where(t >= 0.4, jnp.asarray(GUST), jnp.asarray(WIND))
        tkw["wind_fn"] = lambda t: torch.where((t >= 0.4)[:, None], torch.tensor(GUST, dtype=t.dtype),
                                               torch.tensor(WIND, dtype=t.dtype))
    want = j_noisy(JMPC(JCfg(**cfg), dtype=jnp.float64), j_ref, T_STAGED, jax.random.PRNGKey(0),
                   body=JBody(wind=WIND), dtype=jnp.float64, **jkw)
    got = noisy_mpc_flight_rollout(LinearMPC(LinearMPCConfig(**cfg), dtype=f64, device="cpu"),
                                   t_ref, T_STAGED, noise=torch.from_numpy(normals),
                                   body=RigidBodyParams(wind=WIND), dtype=f64, device="cpu",
                                   **tkw)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
    for key in ("state", "state_est", "meas_pos"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-9,
                                   err_msg=key)
    np.testing.assert_allclose(got["final_covariance"].numpy(),
                               np.asarray(want["final_covariance"]), rtol=0, atol=1e-10)
    if case == "observer_gust":
        np.testing.assert_allclose(got["disturbance_est"].numpy(),
                                   np.asarray(want["disturbance_est"]), rtol=0, atol=1e-9)


def test_noise_from_a_generator_is_drawn_once_per_flight():
    """``generator=`` draws the flight's (T, 9) standard normals once; the
    same draws handed in as ``noise=`` fly the same flight."""
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=10), device="cpu")
    T = 6
    a = noisy_mpc_flight_rollout(mpc, t_ref, T, generator=torch.Generator().manual_seed(3),
                                 device="cpu")
    draws = torch.randn(T, 9, generator=torch.Generator().manual_seed(3))
    b = noisy_mpc_flight_rollout(mpc, t_ref, T, noise=draws, device="cpu")
    assert torch.equal(a["state"], b["state"]) and torch.equal(a["meas_pos"], b["meas_pos"])
    r_pos = EKFConfig().r_pos
    np.testing.assert_allclose((b["meas_pos"] - b["state"][:, 0:3]).numpy(),
                               (r_pos * draws[:, 0:3]).numpy(), rtol=1e-6, atol=1e-7)


def _routing_kwargs(case):
    multi = FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=4)
    single = FlightLoopConfig(use_fused_tick=True)
    online = OnlineFusedGPConfig(gp=ResidualGPConfig(max_data_points=32), refit_every=8)
    resid = lambda X, U: torch.zeros(HORIZON, 6)
    return {
        "online_gp_needs_multitick": dict(cfg=single, online_gp=online),
        "initial_dataset_needs_online_gp": dict(cfg=multi, initial_dataset=object()),
        "observer_refused_single_tick": dict(cfg=single, disturbance_observer=True),
        "wind_fn_refused_single_tick": dict(cfg=single, wind_fn=lambda t: torch.zeros(len(t), 3)),
        "multitick_refuses_residual_fn": dict(cfg=multi, residual_fn=resid),
        "bad_relinearize_every": dict(cfg=multi, ekf_cfg=EKFConfig(relinearize_every="often")),
        "bad_cov_precision": dict(cfg=multi, ekf_cfg=EKFConfig(cov_precision="fp8")),
        "steps_not_divisible_by_k": dict(cfg=multi, num_steps=6),
        "online_gp_refuses_gp_posterior": dict(cfg=multi, online_gp=online,
                                               gp_posterior=object()),
        "refit_every_below_k": dict(cfg=multi, online_gp=OnlineFusedGPConfig(refit_every=2)),
        "no_noise_source": dict(generator=None),
    }[case]


@pytest.mark.parametrize("case", [
    "online_gp_needs_multitick", "initial_dataset_needs_online_gp",
    "observer_refused_single_tick", "wind_fn_refused_single_tick",
    "multitick_refuses_residual_fn", "bad_relinearize_every", "bad_cov_precision",
    "steps_not_divisible_by_k", "online_gp_refuses_gp_posterior", "refit_every_below_k",
    "no_noise_source",
])
def test_noisy_loop_refuses_what_jax_refuses(case):
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON, use_fused_controller=True), device="cpu")
    kw = dict(generator=torch.Generator().manual_seed(0), num_steps=8)
    kw.update(_routing_kwargs(case))
    T = kw.pop("num_steps")
    with pytest.raises(ValueError):
        noisy_mpc_flight_rollout(mpc, t_ref, T, device="cpu", **kw)


def test_noisy_entry_point_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        noisy_mpc_flight_rollout(mpc, t_ref, 4, generator=torch.Generator())
