"""Port parity for the Monte Carlo robustness study (``loop.monte_carlo``):
the port's populations flown on the JAX package's own ``jax.random``
conditions (``convert.monte_carlo_conditions_from_numpy``,
``convert.rigid_conditions_from_numpy``) against ``monte_carlo_pid``,
``monte_carlo_mpc`` and ``monte_carlo_mpc12`` of the JAX package, whose
kernels run in interpret mode: every tier (staged, the fused controller,
K6, polish, the fused single-tick and multi-tick tiers, the fallback);
``robustness_stats`` on the same positions; ``sample_conditions``' shapes
and dispersion.

Tolerances:
- Per-flight RMS 1e-4 m (the flight tests' bar), success flags equal.
  Both packages fly float32; the two agree to ~2e-7 m at this length.
- ``monte_carlo_mpc12``: per-member RMS 1e-4 m. The JAX truth is the
  model's RK4 step, the port's K10's plain version (``make_plant_math``,
  the same expressions in another association), and the SQP engine's
  float32 relinearisation and ADMM run through both frameworks' batched
  products; at 32 ticks they agree to ~1e-6 m.
- ``robustness_stats`` 1e-6 on the same positions (float32 reductions in
  other orders); NaN where the JAX package gives NaN.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unmanned_aerial_vehicles_tpu.ops.admm_pallas as j_admm_module
from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.control.mpc_rigid import RigidBodyMPC as JRigidBodyMPC
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    ResidualGPConfig as JGPCfg,
    build_horizon_residuals as j_residuals,
    fit_residual_gp as j_fit,
)
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig as JLoopCfg,
    MonteCarloConfig as JMCCfg,
    monte_carlo_mpc as j_mc_mpc,
    monte_carlo_mpc12 as j_mc_mpc12,
    monte_carlo_pid as j_mc_pid,
    sample_conditions as j_sample,
)
from unmanned_aerial_vehicles_tpu.loop.monte_carlo import robustness_stats as j_stats
from unmanned_aerial_vehicles_tpu.models import X500_PARAMS as J_X500
from unmanned_aerial_vehicles_tpu.models.px4_surrogate import (
    PID_CAMPAIGN_RATE_LOOP as J_PID_RL,
    RateLoopParams as JRateLoopParams,
)
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference as j_circle
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.control.mpc_rigid import RigidBodyMPC
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


def port_rigid_conditions(bodies, x0):
    body = {f.name: (tuple(np.asarray(w) for w in bodies.wind) if f.name == "wind"
                     else np.asarray(getattr(bodies, f.name)))
            for f in dataclasses.fields(bodies)}
    return convert.rigid_conditions_from_numpy(body, np.asarray(x0), device="cpu")


@pytest.fixture
def jax_fused_admm_interpreted(monkeypatch):
    """The JAX MPC calls its K6 without an interpret switch; route it
    through the interpreter on the CPU, as ``tests/test_pallas_ops.py``
    runs the kernel."""
    monkeypatch.setattr(j_admm_module, "admm_box_qp_fused_composite",
                        functools.partial(j_admm_module.admm_box_qp_fused_composite,
                                          interpret=True))


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
    "fused_tick_k4": (dict(use_fused_controller=True),
                      dict(use_fused_tick=True, ticks_per_dispatch=4)),
    "fused_tick_fallback": (dict(use_fused_controller=True),
                            dict(use_fused_tick=True, fallback_error_m=0.5)),
    "fused_admm_pallas_plant": (dict(use_fused_admm=True), dict(use_pallas_plant=True)),
}


def fly_both(conditions, mpc_kw, loop_kw):
    """One tier's population through the JAX package (its kernels in
    interpret mode) and through the port (their plain versions)."""
    jm = JMPC(JCfg(horizon=N, admm_iterations=ITERS, **mpc_kw), dtype=jnp.float32)
    tm = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=ITERS, **mpc_kw), device="cpu")
    want = jax.jit(lambda: j_mc_mpc(jm, j_ref, T, mc=JMCCfg(**MC),
                                    loop_cfg=JLoopCfg(**loop_kw)))()
    got = monte_carlo_mpc(tm, t_ref, T, mc=MonteCarloConfig(**MC),
                          loop_cfg=FlightLoopConfig(**loop_kw), conditions=conditions[0],
                          device="cpu")
    return got, want


@pytest.mark.parametrize("case", sorted(MPC_CASES))
def test_monte_carlo_mpc_matches_jax(conditions, case, jax_fused_admm_interpreted):
    """The default tier (batched composite ADMM), the fused controller (K16's
    plain version against the JAX package's vmapped K3), with K2's plant
    block, the hover fallback (0.5 m: it engages on the ramp), the
    multi-tick population (K5's plain version, K=4, against the JAX
    package's vmapped K5), the single-tick population with the fallback
    (K4's) and K6's with K2's plant block."""
    got, want = fly_both(conditions, *MPC_CASES[case])
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


MC12_B, MC12_T, MC12_K = 3, 32, 8
MC12_RMS_TOL_M = 1e-4


@pytest.mark.parametrize("path", ["fused_tick", "fused_admm", "polish", "mpc12"])
def test_queued_population_tiers_raise_and_point_at_the_roadmap(conditions, path,
                                                                jax_fused_admm_interpreted):
    """The population tiers that were queued (they raised until the
    population tier was ported) fly against the JAX package: the
    single-tick population (K4's plain version against the JAX package's
    vmapped K4), K6's population (its plain version against the vmapped
    interpret-mode K6), the polished one (each flight's active-set polish)
    and ``monte_carlo_mpc12`` on the JAX package's draw (the torque SQP
    engine on its nominal model against X500 members with 15% mass jitter,
    K=8, 32 ticks)."""
    if path == "mpc12":
        jmc = JMCCfg(n_rollouts=MC12_B, mass_jitter_pct=0.15, settle_steps=8)
        bodies, _, x0 = j_sample(jax.random.PRNGKey(jmc.seed), jmc, J_X500, JRateLoopParams())
        want = jax.jit(lambda: j_mc_mpc12(JRigidBodyMPC(), lambda t: j_ref(t), MC12_T, mc=jmc,
                                          ticks_per_dispatch=MC12_K))()
        got = monte_carlo_mpc12(RigidBodyMPC(device="cpu"), t_ref, MC12_T,
                                mc=MonteCarloConfig(n_rollouts=MC12_B, mass_jitter_pct=0.15,
                                                    settle_steps=8),
                                ticks_per_dispatch=MC12_K,
                                conditions=port_rigid_conditions(bodies, x0), device="cpu")
        np.testing.assert_array_equal(got["success"].numpy(), np.asarray(want["success"]))
        np.testing.assert_allclose(got["rms_pos"].numpy(), np.asarray(want["rms_pos"]), rtol=0,
                                   atol=MC12_RMS_TOL_M)
        return
    mpc_kw = dict(fused_tick=dict(use_fused_controller=True),
                  fused_admm=dict(use_fused_admm=True), polish=dict(polish=True))[path]
    loop_kw = dict(use_fused_tick=True) if path == "fused_tick" else {}
    got, want = fly_both(conditions, mpc_kw, loop_kw)
    assert_populations_agree(got, want)


def test_monte_carlo_mpc12_zero_jitter_members_are_identical():
    """Without dispersion every member flies the same flight bit for bit
    (the batched relinearisation, ADMM and plant treat each member alike),
    and a mass jitter spreads the members' RMS."""
    zero = MonteCarloConfig(n_rollouts=3, mass_jitter_pct=0.0, drag_jitter_pct=0.0,
                            tau_jitter_pct=0.0, hover_thrust_jitter_pct=0.0, wind_std=0.0,
                            initial_pos_std=0.0, initial_vel_std=0.0, settle_steps=8)
    eng = RigidBodyMPC(device="cpu")
    same = monte_carlo_mpc12(eng, t_ref, 16, mc=zero, device="cpu")
    assert torch.isfinite(same["rms_pos"]).all()
    assert torch.equal(same["rms_pos"], same["rms_pos"][:1].expand(3))
    spread = monte_carlo_mpc12(eng, t_ref, 16, device="cpu",
                               mc=dataclasses.replace(zero, mass_jitter_pct=0.15))
    assert float(spread["rms_pos"].std()) > 0.0


def test_population_tier_checks():
    """The tiers' refusals: a multi-tick population takes no residual_fn
    (its GP belongs in the kernel), a single-tick population no tightening,
    and a batched K5 no tightening either."""
    tm = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=2, use_fused_controller=True),
                   device="cpu")
    mc = MonteCarloConfig(n_rollouts=2)
    with pytest.raises(ValueError, match="gp_posterior"):
        monte_carlo_mpc(tm, t_ref, 4, mc=mc, device="cpu", residual_fn=lambda X, U: X[1:],
                        loop_cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=2))
    tight = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=2, use_fused_controller=True,
                                      tightening_factor=2.0), device="cpu")
    with pytest.raises(ValueError, match="tightening"):
        monte_carlo_mpc(tight, t_ref, 4, mc=mc, device="cpu",
                        loop_cfg=FlightLoopConfig(use_fused_tick=True))
    from unmanned_aerial_vehicles_tpu_torch.ops.tick_pallas import GPRows, gpmpc_multitick_fused

    zeros = lambda *shape: torch.zeros(*shape)
    rows = GPRows(*(zeros(1) for _ in range(6)), kinv=zeros(1, 1), y_std=zeros(6))
    m, Nnx = 10 * N, 6 * N
    with pytest.raises(ValueError, match="one flight"):
        gpmpc_multitick_fused(tm._tick_data, rows, zeros(2, 12), zeros(2, 9), zeros(2, Nnx),
                              zeros(2, m), zeros(2, m), zeros(2, Nnx), zeros(2), zeros(2, 10),
                              k_ticks=2, use_gp=True, rho=8.0, iterations=2, over_relax=1.6,
                              dt=0.02, substeps=2, accel_lo=(-3.5,) * 3, accel_hi=(3.5,) * 3,
                              yawrate_limit=0.8, n=N, tighten_kappa=2.0)


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
