"""Port parity for the Monte Carlo robustness study (``loop.monte_carlo``):
the port's populations flown on the JAX package's own ``jax.random``
conditions (``convert.monte_carlo_conditions_from_numpy``) against
``monte_carlo_pid`` and ``monte_carlo_mpc`` of the JAX package, whose
kernels run in interpret mode; ``robustness_stats`` on the same positions;
``sample_conditions``' shapes and dispersion.

Tolerances:
- Per-flight RMS 1e-4 m (the flight tests' bar), success flags equal.
  Both packages fly float32; the two agree to ~2e-7 m at this length.
- ``robustness_stats`` 1e-6 on the same positions (float32 reductions in
  other orders); NaN where the JAX package gives NaN.
"""

import dataclasses

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
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig as JLoopCfg,
    MonteCarloConfig as JMCCfg,
    monte_carlo_mpc as j_mc_mpc,
    monte_carlo_pid as j_mc_pid,
    sample_conditions as j_sample,
)
from unmanned_aerial_vehicles_tpu.loop.monte_carlo import robustness_stats as j_stats
from unmanned_aerial_vehicles_tpu.models.px4_surrogate import PID_CAMPAIGN_RATE_LOOP as J_PID_RL
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference as j_circle
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
    ResidualGPConfig,
    build_horizon_residuals,
)
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    MonteCarloConfig,
    monte_carlo_mpc,
    monte_carlo_mpc12,
    monte_carlo_pid,
    robustness_stats,
    sample_conditions,
)
from unmanned_aerial_vehicles_tpu_torch.models import PID_CAMPAIGN_RATE_LOOP
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

torch.set_num_threads(1)

B, T, N, ITERS = 6, 120, 5, 20
MC = dict(n_rollouts=B, settle_steps=30, wind_std=0.8)
RMS_TOL_M = 1e-4


def j_ref(t):
    pos, _, yaw = j_circle(t, amplitude=2.0, height=3.0)
    return pos, yaw


def t_ref(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


def port_conditions(bodies, rate_loops, x0):
    body = {f.name: (tuple(np.asarray(w) for w in bodies.wind) if f.name == "wind"
                     else np.asarray(getattr(bodies, f.name)))
            for f in dataclasses.fields(bodies)}
    rates = {f.name: np.asarray(getattr(rate_loops, f.name))
             for f in dataclasses.fields(rate_loops)}
    return convert.monte_carlo_conditions_from_numpy(body, rates, np.asarray(x0), device="cpu")


@pytest.fixture(scope="module")
def conditions():
    """The JAX package's draw for seed 0, and the PID campaign's (the same
    draws around the 0.7 hover calibration)."""
    jmc = JMCCfg(**MC)
    key = jax.random.PRNGKey(jmc.seed)
    return (port_conditions(*j_sample(key, jmc)),
            port_conditions(*j_sample(key, jmc, rate_loop=J_PID_RL)))


def assert_populations_agree(got, want):
    np.testing.assert_array_equal(got["success"].numpy(), np.asarray(want["success"]))
    ok = np.asarray(want["success"])
    np.testing.assert_allclose(got["rms_pos"].numpy()[ok], np.asarray(want["rms_pos"])[ok],
                               rtol=0, atol=RMS_TOL_M)
    for key in ("rms_mean", "rms_p50", "rms_p90", "success_rate"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=0, atol=RMS_TOL_M,
                                   err_msg=key)


MPC_CASES = {
    "default": (dict(), dict()),
    "fused_controller_pallas_plant": (dict(use_fused_controller=True),
                                      dict(use_pallas_plant=True)),
    "fused_controller": (dict(use_fused_controller=True), dict()),
    "fallback": (dict(), dict(fallback_error_m=0.5)),
}


@pytest.mark.parametrize("case", sorted(MPC_CASES))
def test_monte_carlo_mpc_matches_jax(conditions, case):
    """The default tier (batched composite ADMM), the fused controller (K16's
    plain version against the JAX package's vmapped K3), with K2's plant
    block, and the hover fallback (0.5 m: it engages on the ramp)."""
    mpc_kw, loop_kw = MPC_CASES[case]
    jm = JMPC(JCfg(horizon=N, admm_iterations=ITERS, **mpc_kw), dtype=jnp.float32)
    tm = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=ITERS, **mpc_kw), device="cpu")
    want = jax.jit(lambda: j_mc_mpc(jm, j_ref, T, mc=JMCCfg(**MC),
                                    loop_cfg=JLoopCfg(**loop_kw)))()
    got = monte_carlo_mpc(tm, t_ref, T, mc=MonteCarloConfig(**MC),
                          loop_cfg=FlightLoopConfig(**loop_kw), conditions=conditions[0],
                          device="cpu")
    assert_populations_agree(got, want)


def test_monte_carlo_mpc_with_gp_and_preview_matches_jax(conditions):
    """``residual_fn`` mapped over the flights and ``preview``."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(40, 10))
    X[:, 2] += 3.0
    Y = 0.05 * rng.normal(size=(40, 6)) + 0.02
    jpost = j_fit(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), JGPCfg())
    post = convert.gp_posterior_from_numpy(
        np.asarray(jpost.X_train), np.asarray(jpost.chol), np.asarray(jpost.alpha),
        np.asarray(jpost.y_mean), np.asarray(jpost.y_std),
        np.asarray(jpost.params.length_scale), np.asarray(jpost.params.signal_variance),
        np.asarray(jpost.params.noise_variance), device="cpu",
    )
    jm = JMPC(JCfg(horizon=N, admm_iterations=ITERS), dtype=jnp.float32)
    tm = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=ITERS), device="cpu")
    want = jax.jit(lambda: j_mc_mpc(
        jm, j_ref, T, mc=JMCCfg(**MC), preview=True,
        residual_fn=lambda Xg, Ug: j_residuals(jpost, Xg, Ug, JGPCfg())))()
    got = monte_carlo_mpc(tm, t_ref, T, mc=MonteCarloConfig(**MC), preview=True,
                          residual_fn=lambda Xg, Ug: build_horizon_residuals(
                              post, Xg, Ug, ResidualGPConfig()),
                          conditions=conditions[0], device="cpu")
    assert_populations_agree(got, want)


@pytest.mark.parametrize("pallas_plant", [False, True], ids=["staged_plant", "pallas_plant"])
def test_monte_carlo_pid_matches_jax(conditions, pallas_plant):
    """The cascade-PID population on the campaign's rate loop; with
    ``use_pallas_plant`` K1's plain version on the plant block."""
    want = jax.jit(lambda: j_mc_pid(j_ref, T, mc=JMCCfg(**MC), rate_loop=J_PID_RL,
                                    loop_cfg=JLoopCfg(use_pallas_plant=pallas_plant)))()
    got = monte_carlo_pid(t_ref, T, mc=MonteCarloConfig(**MC), rate_loop=PID_CAMPAIGN_RATE_LOOP,
                          loop_cfg=FlightLoopConfig(use_pallas_plant=pallas_plant),
                          conditions=conditions[1], device="cpu")
    assert_populations_agree(got, want)


def test_robustness_stats_match_jax():
    """Crashed (beyond ``crash_error_m``), NaN and infinite flights, and a
    population where every flight failed."""
    rng = np.random.default_rng(5)
    Tn = 60
    pos_ref = rng.normal(size=(Tn, 3)).astype(np.float32)
    pos = (pos_ref[None] + 0.5 * rng.normal(size=(7, Tn, 3))).astype(np.float32)
    pos[1, 40:] += 30.0          # crashed: beyond 10 m
    pos[2, 50:] = np.nan         # diverged to NaN
    pos[3, 55, 1] = np.inf
    cases = {"mixed": pos, "all_failed": pos[1:4]}
    for label, p in cases.items():
        want = j_stats(jnp.asarray(p), jnp.asarray(pos_ref), 10, 10.0)
        got = robustness_stats(torch.from_numpy(p), torch.from_numpy(pos_ref), 10, 10.0)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                       atol=1e-6, equal_nan=True, err_msg=f"{label}: {key}")
    assert np.isnan(float(got["rms_p50"])) and float(got["success_rate"]) == 0.0


def test_sample_conditions_shapes_and_dispersion():
    mc = MonteCarloConfig(n_rollouts=4096, seed=3)
    bodies, rates, x0 = sample_conditions(None, mc, device="cpu")
    assert tuple(x0.shape) == (4096, 12) and x0.dtype == torch.float32
    for leaf in [getattr(bodies, f.name) for f in dataclasses.fields(bodies) if f.name != "wind"]:
        assert tuple(leaf.shape) == (4096,) and leaf.dtype == torch.float32
    assert len(bodies.wind) == 3 and all(tuple(w.shape) == (4096,) for w in bodies.wind)
    for f in dataclasses.fields(rates):
        assert tuple(getattr(rates, f.name).shape) == (4096,)
    # log-normal jitters: log(param / nominal) ~ N(0, pct^2)
    for value, nominal, pct in ((bodies.mass, 0.5, 0.10), (bodies.k_drag_linear, 0.25, 0.30),
                                (rates.tau_yaw, 0.08, 0.20), (rates.hover_thrust_norm, 1.0, 0.03)):
        logs = torch.log(value / nominal)
        assert abs(float(logs.mean())) < 4 * pct / 64 and abs(float(logs.std()) / pct - 1) < 0.05
    wind = torch.stack(bodies.wind, 1)
    assert abs(float(wind.std()) / 0.8 - 1) < 0.05
    assert abs(float((x0[:, 0:3] - torch.tensor([0.0, 0.0, 3.0])).std()) / 0.3 - 1) < 0.05
    assert abs(float(x0[:, 3:6].std()) / 0.1 - 1) < 0.05 and torch.all(x0[:, 6:] == 0)
    assert torch.all(bodies.gravity == 9.81)
    # the draw is a function of the seed; the PID campaign's shifts the hover only
    again = sample_conditions(None, mc, device="cpu")
    assert torch.equal(again[2], x0) and torch.equal(again[0].mass, bodies.mass)
    pid = sample_conditions(None, mc, rate_loop=PID_CAMPAIGN_RATE_LOOP, device="cpu")
    torch.testing.assert_close(pid[1].hover_thrust_norm, 0.7 * rates.hover_thrust_norm)


@pytest.mark.parametrize("path", ["fused_tick", "fused_admm", "polish", "mpc12"])
def test_queued_population_tiers_raise_and_point_at_the_roadmap(path):
    tm = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=2,
                                   use_fused_admm=path == "fused_admm", polish=path == "polish",
                                   use_fused_controller=path == "fused_tick"), device="cpu")
    mc = MonteCarloConfig(n_rollouts=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if path == "mpc12":
            monte_carlo_mpc12(None, t_ref, 4, mc=mc)
        else:
            monte_carlo_mpc(tm, t_ref, 4, mc=mc, device="cpu",
                            loop_cfg=FlightLoopConfig(use_fused_tick=path == "fused_tick",
                                                      ticks_per_dispatch=2))


def test_populations_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    tm = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=2), device="cpu")
    mc = MonteCarloConfig(n_rollouts=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        monte_carlo_mpc(tm, t_ref, 4, mc=mc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        monte_carlo_pid(t_ref, 4, mc=mc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_conditions(None, mc)
