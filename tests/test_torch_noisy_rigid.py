"""Port parity for the 12-state family's noisy loops against the JAX
package on the CPU, both flying the JAX package's own float32 sensor draws
(``noise=``): ``noisy_rigid_mpc_rollout`` with the iLQR engine (RK4, the
truth through K10's wrapper, which takes its plain version for CPU
tensors), with the SQP engine and a time-varying truth, and with the
direct-rate engine and the disturbance observer; ``noisy_ltv_rollout``
(4 control ticks of 10 sensor substeps, an obstacle row) with and without
the observer; the argument checks both packages make; and the generator
path.

Tolerance: position gap <= 1e-4 m on the truth, the estimate and the
measurement (both fly float32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control import ilqr as jilqr
from unmanned_aerial_vehicles_tpu.control import mpc_rigid as jmr
from unmanned_aerial_vehicles_tpu.control.mpc_sqp import SQPConfig as JSQPConfig
from unmanned_aerial_vehicles_tpu.estimation import noisy_loop as jnl
from unmanned_aerial_vehicles_tpu.models import GZ_QUADROTOR_PARAMS as JGZ
from unmanned_aerial_vehicles_tpu.models import X500_PARAMS as JX500
from unmanned_aerial_vehicles_tpu.models import rigid_body_rk4_step as j_rk4
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference as j_circle
from unmanned_aerial_vehicles_tpu_torch.control import ilqr as tilqr
from unmanned_aerial_vehicles_tpu_torch.control import mpc_rigid as tmr
from unmanned_aerial_vehicles_tpu_torch.control.mpc_sqp import SQPConfig
from unmanned_aerial_vehicles_tpu_torch.estimation import noisy_ltv_rollout, noisy_rigid_mpc_rollout
from unmanned_aerial_vehicles_tpu_torch.models import GZ_QUADROTOR_PARAMS, X500_PARAMS
from unmanned_aerial_vehicles_tpu_torch.models.rigid_body import rigid_body_rk4_step
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

torch.set_num_threads(1)

T_RIGID = 30
LTV_TICKS, LTV_SUB, LTV_N, LDT = 4, 10, 6, 0.1
OBSTACLE = [[0.35, 0.05, 1.0, 0.1]]
GAP_M = 1e-4
PUSH = (0.0, 0.0, 0.0, 0.6, -0.4, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def jax_normals(shape, seed=0):
    """The JAX loops' float32 sensor draws: ``split(key, prod(shape[:-1]))``
    then 9 standard normals per key (``estimation/ekf.py:measure``)."""
    n = int(np.prod(shape[:-1]))
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    draws = jax.vmap(lambda k: jax.random.normal(k, (9,), jnp.float32))(keys)
    return torch.from_numpy(np.array(draws).reshape(shape))


def j_reference(t):
    pos, _, yaw = j_circle(t, amplitude=2.0, height=3.0)
    return pos, yaw


def t_reference(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


def compare(got, want, keys=("state", "state_est", "meas_pos")):
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
    assert bool(torch.isfinite(got["state"]).all())
    for key in keys:
        gap = np.max(np.abs(got[key][..., 0:3].numpy() - np.asarray(want[key])[..., 0:3]))
        assert gap <= GAP_M, (key, gap)


def ilqr_engines():
    kw = dict(horizon=8, iterations=2, integrator="rk4")
    return jilqr.ILQRRigidBodyMPC(**kw), tilqr.ILQRRigidBodyMPC(**kw, device="cpu")


def sqp_engines():
    return (jmr.RigidBodyMPC(config=JSQPConfig(horizon=6, admm_iterations=40, admm_rho=0.05)),
            tmr.RigidBodyMPC(config=SQPConfig(horizon=6, admm_iterations=40, admm_rho=0.05),
                             device="cpu"))


def direct_rate_engines():
    return (jmr.DirectRateMPC(config=JSQPConfig(horizon=6, admm_iterations=40, admm_rho=0.05)),
            tmr.DirectRateMPC(config=SQPConfig(horizon=6, admm_iterations=40, admm_rho=0.05),
                              device="cpu"))


@pytest.mark.parametrize("case", ["ilqr_rk4", "sqp_time_varying_truth", "direct_rate_observer"])
def test_noisy_rigid_flight_matches_jax(case):
    normals = jax_normals((T_RIGID, 9))
    jkw, tkw = {}, {}
    if case == "ilqr_rk4":
        jeng, teng = ilqr_engines()
    elif case == "sqp_time_varying_truth":
        # the wind steps to a gust at 0.2 s; the filter keeps the still-air model
        jeng, teng = sqp_engines()
        jgust = JX500.replace(wind=(1.5, -0.8, 0.0))
        tgust = dataclasses.replace(X500_PARAMS, wind=(1.5, -0.8, 0.0))
        jkw = dict(plant_step_tfn=lambda x, u, t: jnp.where(
                       t >= 0.2, j_rk4(x, u, jgust, 0.02), j_rk4(x, u, JX500, 0.02)),
                   process_step_fn=lambda x, u: j_rk4(x, u, JX500, 0.02))
        tkw = dict(plant_step_tfn=lambda x, u, t: (
                       rigid_body_rk4_step(x, u, tgust, 0.02) if float(t) >= 0.2
                       else rigid_body_rk4_step(x, u, X500_PARAMS, 0.02)),
                   process_step_fn=lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, 0.02))
    else:
        # a constant push on the truth that the nominal model lacks
        jeng, teng = direct_rate_engines()
        push_j, push_t = jnp.asarray(PUSH, jnp.float32), torch.tensor(PUSH)
        jkw = dict(yaw_channel=False, disturbance_observer=True,
                   plant_step_fn=lambda x, u: jmr.direct_rate_step(x, u, push_j),
                   process_step_fn=lambda x, u: jmr.direct_rate_step(x, u, jnp.zeros(12, x.dtype)))
        tkw = dict(yaw_channel=False, disturbance_observer=True,
                   plant_step_fn=lambda x, u: tmr.direct_rate_step(x, u, push_t),
                   process_step_fn=lambda x, u: tmr.direct_rate_step(x, u, torch.zeros(12)))
    want = jnl.noisy_rigid_mpc_rollout(jeng, j_reference, T_RIGID, jax.random.PRNGKey(0), **jkw)
    got = noisy_rigid_mpc_rollout(teng, t_reference, T_RIGID, noise=normals, device="cpu", **tkw)
    compare(got, want)
    scale = float(np.abs(want["final_covariance"]).max())
    np.testing.assert_allclose(got["final_covariance"].numpy(), np.asarray(want["final_covariance"]),
                               rtol=0, atol=1e-5 * scale)
    if case == "direct_rate_observer":
        np.testing.assert_allclose(got["disturbance_est"].numpy(),
                                   np.asarray(want["disturbance_est"]), rtol=0, atol=1e-4)
        assert tuple(got["final_covariance"].shape) == (15, 15)


def j_window(i):
    t = LDT * (i + jnp.arange(LTV_N + 1)).astype(jnp.float32)
    x = jnp.clip(0.3 * t, 0.0, 3.0)
    r = jnp.zeros((LTV_N + 1, 12), jnp.float32)
    return r.at[:, 0].set(x).at[:, 2].set(1.0).at[:, 3].set(jnp.where(x < 3.0, 0.3, 0.0))


def t_window(i):
    t = LDT * (i + torch.arange(LTV_N + 1)).to(torch.float32)
    x = torch.clamp(0.3 * t, 0.0, 3.0)
    r = torch.zeros(LTV_N + 1, 12)
    r[:, 0], r[:, 2] = x, 1.0
    r[:, 3] = torch.where(x < 3.0, 0.3, 0.0)
    return r


@pytest.mark.parametrize("observer", [False, True])
def test_noisy_ltv_flight_matches_jax(observer):
    """The LTV MPC at 10 Hz over a 100 Hz filter, an obstacle beside the
    line; with the observer the truth has wind the nominal body lacks."""
    jcfg = JSQPConfig(horizon=LTV_N, admm_iterations=100, admm_rho=0.02)
    tcfg = SQPConfig(horizon=LTV_N, admm_iterations=100, admm_rho=0.02)
    jeng = jmr.LTVTrackingMPC(config=jcfg, num_obstacles=1, obstacle_margin=0.1)
    teng = tmr.LTVTrackingMPC(config=tcfg, num_obstacles=1, obstacle_margin=0.1, device="cpu")
    jkw, tkw = {}, {}
    if observer:
        wind = (0.8, -0.5, 0.0)
        jkw = dict(disturbance_observer=True, body=JGZ.replace(wind=wind))
        tkw = dict(disturbance_observer=True, body=dataclasses.replace(GZ_QUADROTOR_PARAMS,
                                                                       wind=wind))
    want = jnl.noisy_ltv_rollout(jeng, j_window, LTV_TICKS, jax.random.PRNGKey(1),
                                 obstacles=jnp.asarray(OBSTACLE, jnp.float32),
                                 substeps_per_tick=LTV_SUB, **jkw)
    got = noisy_ltv_rollout(teng, t_window, LTV_TICKS,
                            noise=jax_normals((LTV_TICKS, LTV_SUB, 9), seed=1),
                            obstacles=torch.tensor(OBSTACLE), substeps_per_tick=LTV_SUB,
                            device="cpu", **tkw)
    compare(got, want)
    np.testing.assert_allclose(got["pos_ref"].numpy(), np.asarray(want["pos_ref"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["final_state"].numpy(), np.asarray(want["final_state"]),
                               rtol=0, atol=GAP_M)
    if observer:
        np.testing.assert_allclose(got["disturbance_est"].numpy(),
                                   np.asarray(want["disturbance_est"]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["both_truths", "time_varying_without_process",
                                  "observer_with_yaw", "noise_shape", "no_noise_source"])
def test_noisy_rigid_loop_refuses_what_jax_refuses(case):
    """The JAX package's three argument checks (both packages raise), and
    the port's own noise checks."""
    jeng, teng = sqp_engines()
    step_j = lambda x, u: j_rk4(x, u, JX500, 0.02)
    step_t = lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, 0.02)
    jkw = dict()
    tkw = dict(noise=torch.zeros(4, 9))
    if case == "both_truths":
        jkw.update(plant_step_fn=step_j, plant_step_tfn=lambda x, u, t: step_j(x, u))
        tkw.update(plant_step_fn=step_t, plant_step_tfn=lambda x, u, t: step_t(x, u))
    elif case == "time_varying_without_process":
        jkw.update(plant_step_tfn=lambda x, u, t: step_j(x, u))
        tkw.update(plant_step_tfn=lambda x, u, t: step_t(x, u))
    elif case == "observer_with_yaw":
        jkw.update(disturbance_observer=True)
        tkw.update(disturbance_observer=True)
    elif case == "noise_shape":
        tkw["noise"] = torch.zeros(4, 3)
    else:
        tkw.pop("noise")
    if case not in ("noise_shape", "no_noise_source"):
        with pytest.raises(ValueError):
            jnl.noisy_rigid_mpc_rollout(jeng, j_reference, 4, jax.random.PRNGKey(0), **jkw)
    with pytest.raises(ValueError):
        noisy_rigid_mpc_rollout(teng, t_reference, 4, device="cpu", **tkw)


def test_noisy_loops_draw_once_from_a_generator():
    """A generator's draws, taken once before the first tick, fly the same
    flight as those draws handed in; the LTV loop's shape is (T,
    substeps, 9). Without a card the default device raises."""
    _, teng = ilqr_engines()
    T = 4
    a = noisy_rigid_mpc_rollout(teng, t_reference, T, generator=torch.Generator().manual_seed(7),
                                device="cpu")
    draws = torch.randn(T, 9, generator=torch.Generator().manual_seed(7))
    b = noisy_rigid_mpc_rollout(teng, t_reference, T, noise=draws, device="cpu")
    assert torch.equal(a["state_est"], b["state_est"])
    teng_ltv = tmr.LTVTrackingMPC(config=SQPConfig(horizon=LTV_N, admm_iterations=20,
                                                   admm_rho=0.02), device="cpu")
    c = noisy_ltv_rollout(teng_ltv, t_window, 2, generator=torch.Generator().manual_seed(3),
                          substeps_per_tick=3, device="cpu")
    draws = torch.randn(2, 3, 9, generator=torch.Generator().manual_seed(3))
    d = noisy_ltv_rollout(teng_ltv, t_window, 2, noise=draws, substeps_per_tick=3, device="cpu")
    assert torch.equal(c["state_est"], d["state_est"])
    with pytest.raises(ValueError, match="noise"):
        noisy_ltv_rollout(teng_ltv, t_window, 2, noise=draws[:, :2], substeps_per_tick=3,
                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            noisy_rigid_mpc_rollout(teng, t_reference, T, noise=draws[0])
