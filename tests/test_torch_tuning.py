"""Port parity for the auto-tuners (``tuning.autotune``) against the JAX
package on the CPU.

* ``_TracedWeightMPC`` against the deployment ``LinearMPC`` (5e-4, the JAX
  package's own bar) and against the JAX twin (1e-5), three warm-started
  ticks.
* ``tune_parameters`` on a quadratic: the loss trace equal to JAX's
  (``optax.adam`` there, ``torch.optim.Adam`` here) within 1e-6.
* ``tune_cascade_gains`` at 250 ticks and 3 iterations: the initial loss
  within 1e-5 relative of JAX's, the loss trace within 1e-3 relative, and
  the JAX tests' properties (it improves, the gains stay positive, the
  safety limits are untouched); the same run with the plant through K1's
  autodiff route against the staged plant.
* The multi-start picks the best start, and one start is the single run.
* ``tune_mpc_weights`` on the staged tier, the staged tier with K2's
  autodiff route and the fused multi-tick tier: runs and improves.
* The kappa-2 fused flight's loss within 1e-5 relative of JAX's; there
  JAX's weight gradient is NaN (fault F13: ``sqrt`` of a zero variance) and
  the port's is finite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig as JGPCfg, fit_residual_gp as j_fit
from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig as JLoopCfg, mpc_flight_rollout as j_rollout
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference as j_circle_ref
from unmanned_aerial_vehicles_tpu.tuning import (
    TuneConfig as JTuneConfig,
    mpc_weights_theta as j_theta,
    tune_cascade_gains as j_tune_cascade,
    tune_parameters as j_tune_parameters,
)
from unmanned_aerial_vehicles_tpu.tuning.autotune import (
    _TracedWeightMPC as JTwin,
    _tracking_loss as j_tracking_loss,
)
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.cascade_pid import CascadePidGains
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig, mpc_flight_rollout
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference
from unmanned_aerial_vehicles_tpu_torch.tuning import (
    TuneConfig,
    mpc_config_from_theta,
    mpc_weights_theta,
    tune_cascade_gains,
    tune_cascade_gains_multistart,
    tune_mpc_weights,
    tune_parameters,
)
from unmanned_aerial_vehicles_tpu_torch.tuning.autotune import _TracedWeightMPC, _tracking_loss

torch.set_num_threads(1)

PID_T, PID_ITERS = 250, 3
PID_CFG = dict(iterations=PID_ITERS, learning_rate=0.08, settle_steps=50, effort_weight=1e-3)


def t_circle(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


def j_circle(t):
    pos, _, yaw = j_circle_ref(t, amplitude=2.0, height=3.0)
    return pos, yaw


def rms(outs):
    err = outs["state"][:, 0:3] - outs["pos_ref"]
    return float(torch.sqrt(torch.mean(torch.sum(err**2, dim=1))))


# ---------------------------------------------------------------------------
# the traced-weight MPC twin
# ---------------------------------------------------------------------------


def test_traced_weight_mpc_matches_linear_mpc_and_jax_twin():
    base = LinearMPCConfig(horizon=8, admm_iterations=200)
    jbase = JCfg(horizon=8, admm_iterations=200)
    jtheta = j_theta(jbase)
    twin = _TracedWeightMPC(convert.mpc_theta_from_numpy(
        {k: np.asarray(v) for k, v in jtheta.items()}, device="cpu"), base)
    ref = LinearMPC(base, device="cpu")
    jtwin = JTwin(jtheta, jbase)
    state = torch.tensor([1.0, -2.0, 2.0, 0.5, 0.0, -0.1])
    target = torch.tensor([0.0, 0.0, 3.0])
    ca, cb = ref.init_carry(state), twin.init_carry(state)
    cj = jtwin.init_carry(jnp.asarray(state.numpy()))
    jsolve = jax.jit(jtwin.solve)
    for _ in range(3):
        ua, Xa, ca = ref.solve(ca, state, target)
        ub, Xb, cb = twin.solve(cb, state, target)
        uj, Xj, cj = jsolve(cj, jnp.asarray(state.numpy()), jnp.asarray(target.numpy()))
    torch.testing.assert_close(ub, ua, rtol=0, atol=5e-4)
    torch.testing.assert_close(Xb, Xa, rtol=0, atol=5e-4)
    for got, want in ((ub, uj), (Xb, Xj), (cb.slack, cj.slack), (cb.dual, cj.dual)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the optimiser loop
# ---------------------------------------------------------------------------


def test_tune_parameters_quadratic_matches_jax():
    target = [1.0, -2.0, 0.5]

    def j_loss(p):
        return jnp.sum((p["x"] - jnp.asarray(target, jnp.float32)) ** 2)

    def t_loss(p):
        return torch.sum((p["x"] - torch.tensor(target)) ** 2)

    jp, jl, jf = j_tune_parameters(j_loss, {"x": jnp.zeros(3, jnp.float32)}, iterations=400,
                                   learning_rate=0.05)
    tp, tl, tf = tune_parameters(t_loss, {"x": torch.zeros(3)}, iterations=400,
                                 learning_rate=0.05)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)
    assert float(tf) < 1e-4 and float(tl[-1]) < float(tl[0])
    np.testing.assert_allclose(tp["x"].numpy(), target, atol=1e-2)
    np.testing.assert_allclose(float(tf), float(jf), rtol=0, atol=1e-6)


def test_tune_parameters_zeroes_non_finite_gradients_and_keeps_the_best():
    """A NaN gradient leaf is zeroed (the finite leaves still step), and the
    best params are those that produced the best loss."""
    def loss(p):
        return torch.sum(p["x"] ** 2) + 0.0 * torch.sqrt(-torch.abs(p["y"]))

    params, losses, best = tune_parameters(
        loss, {"x": torch.ones(2), "y": torch.ones(1)}, iterations=5,
        optimizer=lambda leaves: torch.optim.SGD(leaves, lr=0.1))
    assert torch.equal(params["y"], torch.ones(1))
    assert not torch.isfinite(best)       # every loss was NaN: nothing is "best"
    params, losses, best = tune_parameters(lambda p: torch.sum(p["x"] ** 2),
                                           {"x": torch.ones(2)}, iterations=5,
                                           optimizer=lambda leaves: torch.optim.SGD(leaves, lr=0.1))
    torch.testing.assert_close(losses, 2.0 * 0.64 ** torch.arange(5.0), rtol=1e-6, atol=0)
    assert float(best) == pytest.approx(2.0 * 0.64**5, rel=1e-6)   # the final evaluation won
    torch.testing.assert_close(params["x"], torch.full((2,), 0.8**5))


# ---------------------------------------------------------------------------
# the cascade-PID tuner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_cascade_run():
    result = j_tune_cascade(j_circle, PID_T, tune_cfg=JTuneConfig(**PID_CFG))
    return (float(result.initial_loss), np.asarray(result.losses), float(result.final_loss),
            [np.asarray(v) for v in jax.tree_util.tree_leaves(result.params)])


@pytest.fixture(scope="module")
def port_cascade_run():
    return tune_cascade_gains(t_circle, PID_T, tune_cfg=TuneConfig(**PID_CFG), device="cpu")


def test_tune_cascade_gains_matches_jax(jax_cascade_run, port_cascade_run):
    j_initial, j_losses, j_final, j_leaves = jax_cascade_run
    result = port_cascade_run
    assert abs(float(result.initial_loss) - j_initial) <= 1e-5 * abs(j_initial)
    np.testing.assert_allclose(result.losses.numpy(), j_losses, rtol=1e-3, atol=0)
    np.testing.assert_allclose(float(result.final_loss), j_final, rtol=1e-3)
    tuned = convert.cascade_gains_from_numpy(j_leaves, device="cpu")
    for layer in ("position", "velocity", "attitude"):
        for k in ("kp", "ki", "kd"):
            np.testing.assert_allclose(getattr(getattr(result.params, layer), k).numpy(),
                                       getattr(getattr(tuned, layer), k).numpy(), rtol=1e-3)


def test_tune_cascade_gains_improves_and_keeps_limits(port_cascade_run):
    result = port_cascade_run
    assert bool(torch.isfinite(result.losses).all())
    assert float(result.final_loss) < float(result.initial_loss)
    default = CascadePidGains.default(device="cpu")
    for layer in ("position", "velocity", "attitude"):
        pid, ref_pid = getattr(result.params, layer), getattr(default, layer)
        for k in ("kp", "ki", "kd"):
            assert bool((getattr(pid, k) > 0).all())
        assert torch.equal(pid.max_output, ref_pid.max_output)
        assert torch.equal(pid.max_integral, ref_pid.max_integral)
    for f in ("hover_thrust", "thrust_min", "thrust_max", "max_rate"):
        assert getattr(result.params, f) == getattr(default, f)


def test_tune_cascade_gains_through_k1_autodiff_route():
    """The plant through K1's route (forward K1, backward K13a; their plain
    versions here) tunes as the staged plant does: same loss trace within
    1e-4 relative (the two plants round differently)."""
    T, cfg = 80, TuneConfig(iterations=2, learning_rate=0.08, settle_steps=30)
    fused = tune_cascade_gains(t_circle, T, tune_cfg=cfg, device="cpu",
                               loop_cfg=FlightLoopConfig(use_pallas_plant=True, fused_tick_ad=True))
    staged = tune_cascade_gains(t_circle, T, tune_cfg=cfg, device="cpu")
    torch.testing.assert_close(fused.losses, staged.losses, rtol=1e-4, atol=0)
    assert float(fused.final_loss) < float(fused.initial_loss)


def test_multistart_picks_the_best_and_one_start_is_the_single_run():
    T, cfg = 60, TuneConfig(iterations=2, learning_rate=0.08, settle_steps=20)
    single = tune_cascade_gains(t_circle, T, tune_cfg=cfg, device="cpu")
    one = tune_cascade_gains_multistart(t_circle, T, n_starts=1, tune_cfg=cfg, device="cpu")
    assert torch.equal(one.losses, single.losses)
    assert torch.equal(one.final_loss, single.final_loss)
    assert torch.equal(one.initial_loss, single.initial_loss)
    three = tune_cascade_gains_multistart(t_circle, T, n_starts=3, jitter=0.2, tune_cfg=cfg,
                                          device="cpu")
    assert np.isfinite(float(three.final_loss))
    assert float(three.final_loss) <= float(single.final_loss)
    assert torch.equal(three.initial_loss, single.initial_loss)


# ---------------------------------------------------------------------------
# the MPC-weight tuner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["staged", "staged_k2"])
def test_tune_mpc_weights_improves_tracking(route):
    steps = 100
    base = LinearMPCConfig(horizon=8, admm_iterations=30)
    detuned = dataclasses.replace(base, q_pos=(5.0, 5.0, 8.0), r_control=(20.0, 20.0, 10.0, 8.0))
    loop = FlightLoopConfig(use_pallas_plant=route == "staged_k2")
    cfg = TuneConfig(iterations=2, learning_rate=0.15, settle_steps=30)
    result, tuned = tune_mpc_weights(t_circle, steps, base_config=detuned, tune_cfg=cfg,
                                     loop_cfg=loop, device="cpu")
    assert float(result.final_loss) < float(result.initial_loss)
    fly = lambda c: mpc_flight_rollout(LinearMPC(c, device="cpu"), t_circle, steps,
                                       cfg=FlightLoopConfig(), device="cpu")
    assert rms(fly(tuned)) < rms(fly(detuned))
    assert isinstance(tuned.q_pos[0], float)


def test_tune_mpc_weights_runs_on_the_fused_tier():
    base = LinearMPCConfig(horizon=6, use_fused_controller=True)
    cfg = TuneConfig(iterations=2, learning_rate=0.1, settle_steps=2)
    result, tuned = tune_mpc_weights(
        t_circle, 8, base_config=base, tune_cfg=cfg, device="cpu",
        loop_cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=2))
    assert np.isfinite(float(result.final_loss))
    assert float(result.final_loss) <= float(result.initial_loss) + 1e-6
    assert isinstance(tuned.q_pos[0], float) and tuned.use_fused_controller
    with pytest.raises(ValueError, match="ticks_per_dispatch"):
        tune_mpc_weights(t_circle, 8, base_config=base, tune_cfg=cfg, device="cpu",
                         loop_cfg=FlightLoopConfig(use_fused_tick=True))


def test_mpc_config_from_theta_round_trips():
    base = LinearMPCConfig(horizon=8)
    config = mpc_config_from_theta(mpc_weights_theta(base, device="cpu"), base)
    for f in ("q_pos", "q_vel", "r_control"):
        np.testing.assert_allclose(getattr(config, f), getattr(base, f), rtol=1e-6)
    assert config.horizon == base.horizon


def test_tightened_fused_loss_matches_jax_and_the_port_gradient_is_finite():
    """kappa 2 through the fused tier with a frozen GP (P=32): the loss
    within 1e-5 relative of JAX's. JAX's weight gradient is NaN (its
    tightening takes ``sqrt`` of a variance that is exactly 0 on the first
    stage's position rows); the port's ``guarded_sqrt`` gives 0 there, so
    its gradient is finite."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(32, 10))
    X[:, 2] += 3.0
    Y = 0.5 * rng.normal(size=(32, 6))
    jpost = j_fit(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), JGPCfg())
    post = convert.gp_posterior_from_numpy(
        np.asarray(jpost.X_train), np.asarray(jpost.chol), np.asarray(jpost.alpha),
        np.asarray(jpost.y_mean), np.asarray(jpost.y_std),
        np.asarray(jpost.params.length_scale), np.asarray(jpost.params.signal_variance),
        np.asarray(jpost.params.noise_variance), device="cpu",
    )
    jbase = JCfg(horizon=6, use_fused_controller=True, tightening_factor=2.0)
    base = LinearMPCConfig(horizon=6, use_fused_controller=True, tightening_factor=2.0)

    def j_loss(theta):
        outs = j_rollout(JTwin(theta, jbase), j_circle, 8, gp_posterior=jpost, gp_gain=1.0,
                         cfg=JLoopCfg(use_fused_tick=True, ticks_per_dispatch=2,
                                      fused_tick_ad=True))
        return j_tracking_loss(outs, 2, 1e-3)

    jtheta = j_theta(jbase)
    j_value, j_grads = jax.jit(jax.value_and_grad(j_loss))(jtheta)
    theta = {k: v.requires_grad_(True) for k, v in convert.mpc_theta_from_numpy(
        {k: np.asarray(v) for k, v in jtheta.items()}, device="cpu").items()}
    outs = mpc_flight_rollout(_TracedWeightMPC(theta, base), t_circle, 8, gp_posterior=post,
                              gp_gain=1.0, device="cpu",
                              cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=2,
                                                   fused_tick_ad=True))
    loss = _tracking_loss(outs, 2, 1e-3)
    grads = torch.autograd.grad(loss, list(theta.values()))
    assert abs(float(loss.detach()) - float(j_value)) <= 1e-5 * abs(float(j_value))
    assert not any(np.isfinite(np.asarray(g)).all() for g in j_grads.values())
    assert all(bool(torch.isfinite(g).all()) for g in grads)
