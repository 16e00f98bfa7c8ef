"""Port parity for the noisy flights on the multi-tick tier against the
JAX package on the CPU: the filter inside K9 (whose plain version the
wrapper runs for CPU tensors) with a frozen GP and preview, and with the
disturbance observer and a time-varying wind; the staged observer flight
with a gust given in either calling form of ``wind_fn``; and an MPC with
``tightening_factor > 0`` on the noisy tiers, which (as in the JAX package)
fly it untightened: K9 has no variance branch and the staged noisy loop
passes no uncertainty. Both packages fly the JAX package's own sensor draws
(``noise=``). ``test_torch_online_noisy.py`` holds the single-tick tier and
online learning from the estimates, with the helpers below.

Tolerance: position gap <= 1e-4 m over 48 ticks (both fly float32; the
online flight's bar in ``test_torch_flight.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.estimation.noisy_loop import noisy_mpc_flight_rollout as j_noisy
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    ResidualGPConfig as JGPCfg,
    fit_residual_gp as j_fit,
)
from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig as JLoopCfg, OnlineFusedGPConfig as JOnline
from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams as JBody
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference as j_fig8
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.estimation import noisy_mpc_flight_rollout
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
    ResidualGPConfig,
)
from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig, OnlineFusedGPConfig
from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

torch.set_num_threads(1)

HORIZON, K, T = 10, 4, 48
WIND, GUST = (0.8, 0.4, 0.0), (1.5, 0.8, 0.0)


def j_ref(t):
    pos, yaw = j_fig8(t, 6.0, 0.02)
    return pos + jnp.asarray([0.0, 0.0, 3.0], pos.dtype), yaw


def t_ref(t):
    pos, yaw = ramped_figure8_reference(t, 6.0, 0.02)
    return pos + torch.tensor([0.0, 0.0, 3.0], dtype=pos.dtype), yaw


def jax_normals():
    """The JAX fused noisy tiers' float32 sensor draws for PRNGKey(0)."""
    keys = jax.random.split(jax.random.PRNGKey(0), T)
    draws = jax.vmap(lambda k: jax.random.normal(k, (9,), jnp.float32))(keys)
    return torch.from_numpy(np.array(draws))


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


def fly_both(loop, jkw, tkw, **mpc_kw):
    cfg = dict(horizon=HORIZON, admm_iterations=20, use_fused_controller=True, **mpc_kw)
    want = j_noisy(JMPC(JCfg(**cfg)), j_ref, T, jax.random.PRNGKey(0), body=JBody(wind=WIND),
                   cfg=JLoopCfg(**loop), **jkw)
    got = noisy_mpc_flight_rollout(LinearMPC(LinearMPCConfig(**cfg), device="cpu"), t_ref, T,
                                   noise=jax_normals(), body=RigidBodyParams(wind=WIND),
                                   cfg=FlightLoopConfig(**loop), device="cpu", **tkw)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
    assert np.all(np.isfinite(got["state"].numpy()))
    for key in ("state", "state_est", "meas_pos"):
        gap = np.max(np.abs(got[key][:, 0:3].numpy() - np.asarray(want[key][:, 0:3])))
        assert gap <= 1e-4, (key, gap)
    return got, want


def test_multitick_noisy_flight_gp_preview_matches_jax():
    jpost, post = posterior_pair()
    got, want = fly_both(dict(use_fused_tick=True, ticks_per_dispatch=K),
                         dict(gp_posterior=jpost, gp_gain=1.0, preview=True),
                         dict(gp_posterior=post, gp_gain=1.0, preview=True))
    np.testing.assert_allclose(got["final_covariance"].numpy(), np.asarray(want["final_covariance"]),
                               rtol=0, atol=1e-5 * float(np.abs(want["final_covariance"]).max()))


def test_multitick_noisy_flight_observer_wind_fn_matches_jax():
    got, want = fly_both(
        dict(use_fused_tick=True, ticks_per_dispatch=K),
        dict(disturbance_observer=True,
             wind_fn=lambda t: jnp.where(t >= 0.4, jnp.asarray(GUST), jnp.asarray(WIND))),
        dict(disturbance_observer=True,
             wind_fn=lambda t: torch.where((t >= 0.4)[:, None], torch.tensor(GUST),
                                           torch.tensor(WIND))),
    )
    np.testing.assert_allclose(got["disturbance_est"].numpy(), np.asarray(want["disturbance_est"]),
                               rtol=0, atol=1e-4)
    assert tuple(got["final_covariance"].shape) == (15, 15)


def gust_per_time(t):
    """The JAX package's calling form: one time in, the (3,) wind out."""
    return torch.where(t >= 0.4, torch.tensor(GUST), torch.tensor(WIND))


def gust_whole_flight(t):
    return torch.where((t >= 0.4)[:, None], torch.tensor(GUST), torch.tensor(WIND))


def test_staged_observer_gust_flight_takes_either_wind_fn_form():
    got, want = fly_both(
        dict(),
        dict(disturbance_observer=True,
             wind_fn=lambda t: jnp.where(t >= 0.4, jnp.asarray(GUST), jnp.asarray(WIND))),
        dict(disturbance_observer=True, wind_fn=gust_per_time),
    )
    np.testing.assert_allclose(got["disturbance_est"].numpy(), np.asarray(want["disturbance_est"]),
                               rtol=0, atol=1e-4)
    whole = noisy_mpc_flight_rollout(
        LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=20, use_fused_controller=True),
                  device="cpu"), t_ref, T, noise=jax_normals(), body=RigidBodyParams(wind=WIND),
        device="cpu", disturbance_observer=True, wind_fn=gust_whole_flight)
    for key in got:
        assert torch.equal(got[key], whole[key]), key


def test_flight_winds_checks_the_shape():
    from unmanned_aerial_vehicles_tpu_torch.estimation.noisy_loop import flight_winds

    t = 0.02 * torch.arange(T, dtype=torch.float32)
    assert torch.equal(flight_winds(gust_per_time, t), flight_winds(gust_whole_flight, t))
    assert tuple(flight_winds(gust_per_time, t).shape) == (T, 3)
    for bad in (lambda t: torch.zeros(2), lambda t: torch.zeros(t.shape[0], 2),
                lambda t: torch.zeros(3, t.shape[0])):
        with pytest.raises(ValueError, match="wind_fn"):
            flight_winds(bad, t)


@pytest.mark.parametrize("tier", ["staged", "multitick"])
def test_noisy_tiers_fly_a_tightening_mpc_as_jax(tier):
    """The noisy loops take no uncertainty: a tightening MPC flies as the
    JAX package flies it, untightened."""
    jpost, post = posterior_pair()
    loop = dict(use_fused_tick=True, ticks_per_dispatch=K) if tier == "multitick" else {}
    gp_kw = (dict(gp_posterior=jpost, gp_gain=1.0), dict(gp_posterior=post, gp_gain=1.0)) \
        if tier == "multitick" else ({}, {})
    got, _ = fly_both(loop, *gp_kw, tightening_factor=2.0)
    loose = noisy_mpc_flight_rollout(
        LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=20, use_fused_controller=True),
                  device="cpu"), t_ref, T, noise=jax_normals(), body=RigidBodyParams(wind=WIND),
        cfg=FlightLoopConfig(**loop), device="cpu", **gp_kw[1])
    assert torch.equal(got["state"], loose["state"])
