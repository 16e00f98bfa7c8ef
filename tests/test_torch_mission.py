"""Port parity for the mission phase machine (``loop.mission``) against the
JAX package on the CPU: the staged mission in float64 and, in float32,
through the port's K3 and K1 routes (their plain versions on the CPU)
against the JAX package's staged float32 mission; the noisy missions on
the JAX package's own sensor draws (the 12-state EKF, the 15-state
observer under a steady wind, a time-varying wind); the guards; the
phase boundaries' float32 times.

The missions fly at ``control_dt=0.05`` for 23 s: 460 ticks reach all five
phases (prepare, arm, take-off, hover, trajectory from 20 s).

Tolerances: float64 positions within 1e-8 m of the JAX package at every
tick, phases equal; float32 within 1e-4 m (the online flight's bar in
``test_torch_flight.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    ResidualGPConfig as JGPCfg,
    build_horizon_residuals as j_residuals,
    fit_residual_gp as j_fit,
)
from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig as JLoopCfg, mission_rollout as j_mission
from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams as JBody
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference as j_fig8
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig, build_horizon_residuals
from unmanned_aerial_vehicles_tpu_torch.loop import (
    HOVER_END,
    FlightLoopConfig,
    mission_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.loop.mission import _tick_times
from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

torch.set_num_threads(1)

DT, DURATION, HORIZON, ITERS = 0.05, 23.0, 10, 20
T = int(DURATION / DT)
WIND = (1.5, 0.8, 0.0)
F64_TOL_M, F32_TOL_M = 1e-8, 1e-4
DTYPES = {"float64": (torch.float64, jnp.float64), "float32": (torch.float32, jnp.float32)}


def j_ref(t):
    pos, yaw = j_fig8(t, 3.0, 0.05)
    return pos + jnp.asarray([0.0, 0.0, 3.0], pos.dtype), yaw


def t_ref(t):
    pos, yaw = ramped_figure8_reference(t, 3.0, 0.05)
    return pos + torch.tensor([0.0, 0.0, 3.0], dtype=pos.dtype), yaw


def j_mpc(dtype, **kw):
    return JMPC(JCfg(horizon=HORIZON, admm_iterations=ITERS, dt=DT, **kw), dtype=dtype)


def t_mpc(dtype, **kw):
    return LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ITERS, dt=DT, **kw),
                     dtype=dtype, device="cpu")


def jax_normals(seed, dtype):
    """The JAX noisy mission's per-tick sensor draws: ``normal(k, (9,))`` in
    the flight's dtype for each key of ``split(PRNGKey(seed), T)``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), T)
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.normal(k, (9,), dtype))(keys)))


def j_fly(dtype, loop=None, **kw):
    return jax.jit(lambda: j_mission(j_mpc(dtype), j_ref, duration=DURATION,
                                     cfg=JLoopCfg(control_dt=DT, **(loop or {})), dtype=dtype,
                                     **kw))()


def gap(got, want, key="state"):
    return float(np.max(np.abs(got[key].numpy() - np.asarray(want[key]))))


@pytest.fixture(scope="module")
def staged():
    return {name: j_fly(jd) for name, (_, jd) in DTYPES.items()}


def test_mission_float64_matches_jax_per_tick(staged):
    want = staged["float64"]
    got = mission_rollout(t_mpc(torch.float64), t_ref, duration=DURATION,
                          cfg=FlightLoopConfig(control_dt=DT), dtype=torch.float64, device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
    np.testing.assert_array_equal(got["phase"].numpy(), np.asarray(want["phase"]))
    np.testing.assert_array_equal(got["in_trajectory"].numpy(), np.asarray(want["in_trajectory"]))
    assert set(np.unique(got["phase"].numpy())) == {0, 1, 2, 3, 4}
    for key in ("state", "target", "thrust", "final_state"):
        assert gap(got, want, key) <= F64_TOL_M, key


@pytest.mark.parametrize("route", ["staged", "kernels"])
def test_mission_float32_matches_jax(staged, route):
    """Float32: the staged port, and the port's kernel routes (K3 solve, K1
    plant; their plain versions on the CPU), against the JAX package's
    staged float32 mission."""
    kernels = route == "kernels"
    got = mission_rollout(t_mpc(torch.float32, use_fused_controller=kernels), t_ref,
                          duration=DURATION,
                          cfg=FlightLoopConfig(control_dt=DT, use_pallas_plant=kernels),
                          device="cpu")
    want = staged["float32"]
    assert got["state"].dtype == torch.float32
    np.testing.assert_array_equal(got["phase"].numpy(), np.asarray(want["phase"]))
    assert gap(got, want) <= F32_TOL_M


@pytest.mark.parametrize("case", ["ekf_wind_fn", "observer_wind"])
def test_noisy_mission_float64_matches_jax(case):
    """The noisy mission flies the JAX package's own draws (``noise=``):
    every phase on the 12-state EKF's estimate with a wind that steps at
    21 s (per-time ``wind_fn``: the truth and the filter's prediction), or
    on the 15-state observer's under a steady wind."""
    if case == "observer_wind":
        jkw = dict(body=JBody(wind=WIND), disturbance_observer=True)
        tkw = dict(body=RigidBodyParams(wind=WIND), disturbance_observer=True)
    else:
        jkw = dict(wind_fn=lambda t: jnp.where(t >= 21.0, jnp.asarray(WIND), 0.0))
        tkw = dict(wind_fn=lambda t: torch.where(t >= 21.0, torch.tensor(WIND, dtype=t.dtype),
                                                 0.0))
    want = j_fly(jnp.float64, key=jax.random.PRNGKey(3), **jkw)
    got = mission_rollout(t_mpc(torch.float64), t_ref, duration=DURATION,
                          cfg=FlightLoopConfig(control_dt=DT), dtype=torch.float64, device="cpu",
                          noise=jax_normals(3, jnp.float64), **tkw)
    assert set(got) == set(want)
    for key in want:
        if key not in ("phase", "in_trajectory"):
            assert gap(got, want, key) <= F64_TOL_M, key
    if case == "observer_wind":
        assert tuple(got["disturbance_est"].shape) == (T, 3)
        tail = got["disturbance_est"][-40:].mean(dim=0)
        assert float(tail[0]) > 0 and float(tail[1]) > 0     # into the wind


def test_noisy_mission_generator_draws_once():
    """A seeded generator gives the same mission twice; its draws handed
    in as ``noise=`` give it a third time."""
    fly = lambda **kw: mission_rollout(t_mpc(torch.float64), t_ref, duration=2.0,
                                       cfg=FlightLoopConfig(control_dt=DT), dtype=torch.float64,
                                       device="cpu", **kw)
    a = fly(generator=torch.Generator().manual_seed(5))
    b = fly(generator=torch.Generator().manual_seed(5))
    draws = torch.randn(int(2.0 / DT), 9, generator=torch.Generator().manual_seed(5),
                        dtype=torch.float64)
    c = fly(noise=draws)
    assert torch.equal(a["state"], b["state"]) and torch.equal(a["state"], c["state"])
    assert not torch.equal(a["state_est"], a["state"])


def test_mission_with_residual_fn_matches_jax():
    """A frozen GP's horizon rows as ``residual_fn`` in every tick's solve."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(48, 10)) * 0.5
    X[:, 2] += 3.0
    Y = 0.05 * rng.normal(size=(48, 6)) + 0.02
    jpost = j_fit(jnp.asarray(X), jnp.asarray(Y), JGPCfg())
    post = convert.gp_posterior_from_numpy(
        np.asarray(jpost.X_train), np.asarray(jpost.chol), np.asarray(jpost.alpha),
        np.asarray(jpost.y_mean), np.asarray(jpost.y_std),
        np.asarray(jpost.params.length_scale), np.asarray(jpost.params.signal_variance),
        np.asarray(jpost.params.noise_variance), device="cpu")
    want = j_fly(jnp.float64, residual_fn=lambda Xg, Ug: j_residuals(jpost, Xg, Ug, JGPCfg()))
    got = mission_rollout(
        t_mpc(torch.float64), t_ref, duration=DURATION, cfg=FlightLoopConfig(control_dt=DT),
        residual_fn=lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, ResidualGPConfig()),
        dtype=torch.float64, device="cpu")
    assert gap(got, want) <= F64_TOL_M


@pytest.mark.parametrize("kw", [dict(disturbance_observer=True),
                                dict(wind_fn=lambda t: torch.zeros(3))])
def test_mission_guards(kw):
    """The observer and a time-varying wind need the noisy mission; the
    MPC must live on the mission's device."""
    with pytest.raises(ValueError, match="noisy mission"):
        mission_rollout(t_mpc(torch.float32), t_ref, duration=1.0, device="cpu", **kw)


def test_mission_device_guard():
    mpc = t_mpc(torch.float32)
    mpc.device = torch.device("meta")
    with pytest.raises(ValueError, match="lives on"):
        mission_rollout(mpc, t_ref, duration=1.0, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tick_times_match_jax(dtype):
    """The phase boundaries fall on the JAX package's ticks: each tick's
    time is ``i`` in the flight's dtype times ``dt``, rounded in that
    dtype (20.0 s is tick 1000 at 50 Hz in float32)."""
    td, jd = DTYPES[dtype]
    n = 1500
    got = _tick_times(n, 0.02, td)
    want = np.asarray(jax.jit(lambda: jnp.arange(n).astype(jd) * 0.02)())
    np.testing.assert_array_equal(got, want)
    assert int(np.argmax(got >= HOVER_END)) == int(np.argmax(want >= HOVER_END))
