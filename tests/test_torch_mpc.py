"""Port parity: condensed linear MPC, composite ADMM and the staged
closed loops against the JAX package, on the CPU.

Tolerances: the MPC operands come from the same float64 NumPy build and are
held to 1e-12. The ADMM and the staged float64 flights are held to 1e-9 in
position: only summation order differs, and 50 ticks of a contracting
closed loop do not amplify 1e-16 rounding to that level. Flights through
the float32 plant kernels (K1, K2 plain versions against the JAX Pallas
kernels in interpret mode) are held to 1e-4 m: float32 rounding of the
RK4 chain, ~1e-6 per tick, compounds over 30 closed-loop ticks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
    LinearMPC as JMPC,
    LinearMPCConfig as JCfg,
)
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    ResidualGPConfig as JGPCfg,
    build_horizon_residuals as j_residuals,
    fit_residual_gp as j_fit,
)
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig as JLoopCfg,
    mpc_flight_rollout as j_mpc_rollout,
    pid_flight_rollout as j_pid_rollout,
)
from unmanned_aerial_vehicles_tpu.ops.qp import admm_box_qp_composite as j_admm
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference as j_fig8
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
    ResidualGPConfig,
    build_horizon_residuals,
)
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    mpc_flight_rollout,
    pid_flight_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.ops.qp import admm_box_qp_composite
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

torch.set_num_threads(1)

HORIZON = 10


def j_ref(t):
    pos, yaw = j_fig8(t, 6.0, 0.02)
    return pos + jnp.asarray([0.0, 0.0, 3.0], pos.dtype), yaw


def t_ref(t):
    pos, yaw = ramped_figure8_reference(t, 6.0, 0.02)
    return pos + torch.tensor([0.0, 0.0, 3.0], dtype=pos.dtype), yaw


def posterior_pair(seed=0, n=64):
    """A frozen GP fitted by JAX (float64) and carried across."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 10))
    X[:, 2] += 3.0
    Y = 0.05 * rng.normal(size=(n, 6))
    jpost = j_fit(jnp.asarray(X), jnp.asarray(Y), JGPCfg())
    post = convert.gp_posterior_from_numpy(
        np.asarray(jpost.X_train), np.asarray(jpost.chol), np.asarray(jpost.alpha),
        np.asarray(jpost.y_mean), np.asarray(jpost.y_std),
        np.asarray(jpost.params.length_scale), np.asarray(jpost.params.signal_variance),
        np.asarray(jpost.params.noise_variance), device="cpu",
    )
    return jpost, post


def test_linear_mpc_operands_match_jax_f64():
    cfg = dict(horizon=HORIZON, admm_iterations=20)
    jm = JMPC(JCfg(**cfg), dtype=jnp.float64)
    tm = LinearMPC(LinearMPCConfig(**cfg), dtype=torch.float64, device="cpu")
    for name in ("_Sx", "_Su", "_Sw", "_H", "_G", "_M_inv", "_P1", "_GMinv", "_SuT_q",
                 "_u_lo", "_u_hi", "_x_lo", "_x_hi"):
        np.testing.assert_allclose(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    assert tm.n_constraints == jm.n_constraints == HORIZON * 10


def test_fused_controller_data_matches_jax_unpadded():
    jm = JMPC(JCfg(horizon=HORIZON, use_fused_controller=True))
    tm = LinearMPC(LinearMPCConfig(horizon=HORIZON, use_fused_controller=True), device="cpu")
    carried = convert.fused_controller_data_from_numpy(jm._fc_data._asdict(), HORIZON)
    for name, got in tm._fc_data._asdict().items():
        np.testing.assert_array_equal(got, getattr(carried, name), err_msg=name)
    # the fused operands solve (through K3's plain version on the CPU)
    u0, X_opt, carry = tm.solve(tm.init_carry(), torch.zeros(6), torch.tensor([0.5, 0.0, 1.0]))
    assert u0.shape == (4,) and X_opt.shape == (HORIZON + 1, 6)
    assert carry.slack.shape == (HORIZON * 10,) and bool(torch.isfinite(X_opt).all())


def test_admm_composite_matches_jax_f64():
    rng = np.random.default_rng(3)
    jm = JMPC(JCfg(horizon=HORIZON), dtype=jnp.float64)
    m, n = jm.n_constraints, jm.n_primal
    f = rng.normal(size=n)
    lower = np.concatenate([np.asarray(jm._u_lo), -rng.uniform(0.5, 2, m - n)])
    upper = np.concatenate([np.asarray(jm._u_hi), rng.uniform(0.5, 2, m - n)])
    z0, y0 = rng.normal(size=m) * 0.1, rng.normal(size=m) * 0.1
    args = (np.asarray(jm._P1), -np.asarray(jm._GMinv) @ f, np.asarray(jm._GMinv).T,
            np.asarray(jm._M_inv) @ f, lower, upper, z0, y0)
    want = j_admm(*map(jnp.asarray, args), 8.0, 40, 1.6)
    got = admm_box_qp_composite(*map(torch.from_numpy, args), 8.0, 40, 1.6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-9)


def test_staged_frozen_gp_flight_matches_jax_f64():
    jpost, post = posterior_pair()
    jcfg, tcfg = JGPCfg(residual_gain=1.0), ResidualGPConfig(residual_gain=1.0)
    cfg = dict(horizon=HORIZON, admm_iterations=20)
    T = 50
    want = j_mpc_rollout(
        JMPC(JCfg(**cfg), dtype=jnp.float64), j_ref, T,
        residual_fn=lambda X, U: j_residuals(jpost, X, U, jcfg), dtype=jnp.float64,
    )
    got = mpc_flight_rollout(
        LinearMPC(LinearMPCConfig(**cfg), dtype=torch.float64, device="cpu"), t_ref, T,
        residual_fn=lambda X, U: build_horizon_residuals(post, X, U, tcfg),
        dtype=torch.float64, device="cpu",
    )
    assert set(got) == set(want)
    np.testing.assert_allclose(got["state"][:, 0:3].numpy(),
                               np.asarray(want["state"][:, 0:3]), rtol=0, atol=1e-9)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-8,
                                   err_msg=key)


def test_staged_flight_through_k2_plain_matches_jax_kernel():
    cfg = dict(horizon=HORIZON, admm_iterations=20)
    T = 30
    kw = dict(fallback_error_m=0.5)   # engages the hover fallback on the way up
    want = j_mpc_rollout(JMPC(JCfg(**cfg)), j_ref, T,
                         cfg=JLoopCfg(use_pallas_plant=True, **kw))
    got = mpc_flight_rollout(LinearMPC(LinearMPCConfig(**cfg), device="cpu"), t_ref, T,
                             cfg=FlightLoopConfig(use_pallas_plant=True, **kw), device="cpu")
    np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["thrust"].numpy(), np.asarray(want["thrust"]),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("pallas_plant", [False, True])
def test_pid_flight_matches_jax(pallas_plant):
    """The cascade-PID flight; with the fused plant it runs through K1."""
    T = 40
    if pallas_plant:
        want = j_pid_rollout(j_ref, T, cfg=JLoopCfg(use_pallas_plant=True))
        got = pid_flight_rollout(t_ref, T, cfg=FlightLoopConfig(use_pallas_plant=True),
                                 device="cpu")
        tol = 1e-5
    else:
        want = j_pid_rollout(j_ref, T, dtype=jnp.float64)
        got = pid_flight_rollout(t_ref, T, dtype=torch.float64, device="cpu")
        tol = 1e-9
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=tol,
                                   err_msg=key)
