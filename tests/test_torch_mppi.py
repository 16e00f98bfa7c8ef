"""Port parity for MPPI against the JAX package on the CPU: kernel K12's
plain version (which the wrapper runs for CPU tensors) against the JAX
sampling kernel in interpret mode and against the JAX controller's vmapped
rollout cost, ``MPPIController.solve`` over five warm-started ticks flying
the JAX package's own exploration draws (``eps=``), the circle task at
full width on those draws, and ``solve`` as a function of its carry.

Tolerances: the costs to 1e-5 relative (float32; the sines of two libraries
differ in the last bit over 9 RK4 steps); the solve's controls to 1e-9 in
float64 and 1e-4 in float32 (the softmax at temperature 0.3 amplifies the
costs' rounding); the circle flight's RMS position error within 5e-3 m of
the JAX flight's over 50 ticks on equal draws (the 12-state family's bar
against the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control import MPPIConfig as JCfg, MPPIController as JMPPI
from unmanned_aerial_vehicles_tpu.models import X500_PARAMS as JX500
from unmanned_aerial_vehicles_tpu.models import rigid_body_rk4_step as j_rk4
from unmanned_aerial_vehicles_tpu.ops.mppi_pallas import mppi_rollout_costs_fused as j_k12
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control import MPPIConfig, MPPIController
from unmanned_aerial_vehicles_tpu_torch.models import X500_PARAMS
from unmanned_aerial_vehicles_tpu_torch.models.rigid_body import rigid_body_rk4_step
from unmanned_aerial_vehicles_tpu_torch.ops import mppi_pallas as tk12

torch.set_num_threads(1)

K_SAMPLES, N = 128, 9
COST_RTOL = 1e-5


@pytest.fixture(scope="module")
def k12_case():
    """One sampling stage: a perturbed hover state, clipped candidates
    around hover, a moving target with a yaw across the wrap, and the JAX
    costs from the kernel (interpret mode) and from the vmapped rollout."""
    rng = np.random.default_rng(3)
    ctrl = JMPPI(JCfg(horizon=N, num_samples=K_SAMPLES))
    x0 = np.zeros(12, np.float32)
    x0[2] = 3.0
    x0 += (0.1 * rng.normal(size=12)).astype(np.float32)
    x0[8] = 3.0
    eps = rng.normal(size=(K_SAMPLES, N, 4)) * np.asarray(ctrl.config.noise_std)
    U = np.clip(np.asarray(ctrl.u_hover) + eps, np.asarray(ctrl.u_lo), np.asarray(ctrl.u_hi))
    U = U.astype(np.float32)
    targets = (np.array([0.5, -0.3, 3.2]) + 0.05 * np.arange(N)[:, None]).astype(np.float32)
    yaw = np.float32(-3.0)
    cfg = ctrl.config
    weights = (cfg.q_pos, cfg.q_vel, cfg.q_att, cfg.q_yaw, cfg.q_rate, *cfg.r_control,
               cfg.terminal_weight)
    kernel = np.asarray(j_k12(jnp.asarray(x0), jnp.asarray(U), jnp.asarray(targets), yaw, JX500,
                              cfg.dt, ctrl.u_hover, weights, interpret=True))
    vmapped = np.asarray(jax.vmap(lambda Us: ctrl._rollout_cost(
        jnp.asarray(x0), Us, jnp.asarray(targets), jnp.float32(yaw)))(jnp.asarray(U)))
    return dict(x0=x0, U=U, targets=targets, yaw=yaw, weights=weights, kernel=kernel,
                vmapped=vmapped, u_hover=np.asarray(ctrl.u_hover))


@pytest.mark.parametrize("against", ["kernel", "vmapped"])
def test_k12_plain_matches_jax(k12_case, against):
    c = k12_case
    got = tk12.mppi_rollout_costs_fused(
        torch.tensor(c["x0"]), torch.tensor(c["U"]), torch.tensor(c["targets"]),
        torch.tensor(c["yaw"]), X500_PARAMS, 0.02, torch.tensor(c["u_hover"]), c["weights"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (K_SAMPLES,)
    want = c[against]
    assert np.isfinite(want).all() and float(want.std()) > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=COST_RTOL, atol=0)


@pytest.mark.parametrize("K,N", [(128, 1), (256, 7)])
def test_k12_plain_matches_jax_kernel_other_shapes(K, N):
    """K12's plain version against the JAX kernel in interpret mode at a
    one-step horizon and at two 128-sample rows (the JAX kernel takes K in
    multiples of 128), the same draws through both."""
    rng = np.random.default_rng(K + N)
    ctrl = JMPPI(JCfg(horizon=N, num_samples=K))
    cfg = ctrl.config
    x0 = np.zeros(12, np.float32)
    x0[2] = 3.0
    x0 += (0.1 * rng.normal(size=12)).astype(np.float32)
    x0[8] = -3.1
    eps = rng.normal(size=(K, N, 4)) * np.asarray(cfg.noise_std)
    U = np.clip(np.asarray(ctrl.u_hover) + eps, np.asarray(ctrl.u_lo),
                np.asarray(ctrl.u_hi)).astype(np.float32)
    targets = (np.array([0.2, 0.4, 2.9]) + 0.05 * np.arange(N)[:, None]).astype(np.float32)
    yaw = np.float32(3.0)
    weights = (cfg.q_pos, cfg.q_vel, cfg.q_att, cfg.q_yaw, cfg.q_rate, *cfg.r_control,
               cfg.terminal_weight)
    want = np.asarray(j_k12(jnp.asarray(x0), jnp.asarray(U), jnp.asarray(targets), yaw, JX500,
                            cfg.dt, ctrl.u_hover, weights, interpret=True))
    got = tk12.mppi_rollout_costs_fused(
        torch.tensor(x0), torch.tensor(U), torch.tensor(targets), torch.tensor(yaw), X500_PARAMS,
        cfg.dt, torch.tensor(np.asarray(ctrl.u_hover)), weights)
    assert tuple(got.shape) == (K,) and np.isfinite(want).all() and float(want.std()) > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=COST_RTOL, atol=0)


def jax_draws(seed, ticks, dtype):
    """The JAX controller's exploration draws: the carry key split once per
    tick, standard normals from the subkey."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(ticks):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (K_SAMPLES, N, 4), dtype)))
    return out


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-4)])
def test_solve_five_ticks_matches_jax(dtype, tol):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jctrl = JMPPI(JCfg(horizon=N, num_samples=K_SAMPLES), dtype=jdt)
    tctrl = MPPIController(MPPIConfig(horizon=N, num_samples=K_SAMPLES), dtype=tdt, device="cpu")
    x = np.zeros(12)
    x[2] = 3.0
    jx, tx = jnp.asarray(x, jdt), torch.tensor(x, dtype=tdt)
    jc, tc = jctrl.init_carry(jx, seed=7), tctrl.init_carry(tx, seed=7)
    for tick, eps in enumerate(jax_draws(7, 5, jdt)):
        target = np.array([0.3 + 0.05 * tick, -0.2, 3.1])
        ju, _, jc = jctrl.solve(jc, jx, jnp.asarray(target, jdt), 0.1)
        tu, X_nom, tc = tctrl.solve(tc, tx, torch.tensor(target, dtype=tdt), 0.1,
                                    eps=convert.mppi_noise_from_numpy(eps, tdt, "cpu"))
        assert tu.dtype == tdt and X_nom is None
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=tol,
                                   err_msg=f"u0 tick {tick}")
        np.testing.assert_allclose(tc.U_nom.numpy(), np.asarray(jc.U_nom), rtol=0,
                                   atol=tol, err_msg=f"U_nom tick {tick}")
        jx = j_rk4(jx, ju, JX500, 0.02)
        tx = rigid_body_rk4_step(tx, tu, X500_PARAMS, 0.02)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=tol)


def test_solve_draws_from_the_carried_generator():
    """Without ``eps`` the tick draws from the random stream whose state the
    carry holds, and ``solve`` is a function of its carry: two solves from
    one carry give the same control and the same new carry, the old carry
    is left as it was, the new carry's stream state differs from the old
    one's; two controllers seeded alike agree, another seed differs, and
    the fused and plain sampling stages give the same tick."""
    cfg = MPPIConfig(horizon=N, num_samples=K_SAMPLES)
    x = torch.zeros(12)
    x[2] = 3.0
    target = torch.tensor([0.3, 0.0, 3.0])
    ctrl = MPPIController(cfg, device="cpu")
    carry = ctrl.init_carry(x, seed=4)
    before = carry.rng_state.clone()
    u1, _, new1 = ctrl.solve(carry, x, target)
    u2, _, new2 = ctrl.solve(carry, x, target)
    assert torch.equal(u1, u2) and torch.equal(new1.U_nom, new2.U_nom)
    assert torch.equal(new1.rng_state, new2.rng_state)
    assert torch.equal(carry.rng_state, before)
    assert not torch.equal(new1.rng_state, carry.rng_state)
    u3, _, _ = ctrl.solve(new1, x, target)
    assert not torch.equal(u3, u1)             # the next tick draws new noise
    runs = {}
    for label, seed, fused in (("a", 1, True), ("b", 1, True), ("c", 2, True), ("plain", 1, False)):
        ctrl = MPPIController(MPPIConfig(horizon=N, num_samples=K_SAMPLES, fused_rollouts=fused),
                              device="cpu")
        carry = ctrl.init_carry(x, seed=seed)
        us = []
        for _ in range(2):
            u, _, carry = ctrl.solve(carry, x, target)
            us.append(u)
        runs[label] = torch.stack(us)
    assert torch.equal(runs["a"], runs["b"]) and torch.equal(runs["a"], runs["plain"])
    assert not torch.equal(runs["a"], runs["c"])
    ctrl = MPPIController(MPPIConfig(horizon=N, num_samples=K_SAMPLES, return_trajectory=True),
                          device="cpu")
    _, X_nom, _ = ctrl.solve(ctrl.init_carry(x), x, target)
    assert tuple(X_nom.shape) == (N + 1, 12) and torch.equal(X_nom[0], x) and cfg.horizon == N


def test_circle_flight_on_jax_draws_matches_jax():
    """The MPPI bar where equal draws make it hold: the port's MPPI (the
    plain versions of K12 and K10) flies the circle task
    (``ramped_circle_reference``, 2 m, 3 m high, 50 Hz, 512 x 25) on the
    JAX flight's own exploration draws, obtained as
    ``jax_reference_rms.py`` obtains them: 50 ticks, within 5e-3 m of the
    JAX flight's RMS position error."""
    from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference as j_circle
    from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import rigid_body_rk4_step_fast
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

    T = 50
    jctrl = JMPPI()
    cfg = jctrl.config

    def step(c, i):
        st, mc = c
        pos_ref, _, yaw_ref = j_circle(i.astype(jnp.float32) * 0.02, amplitude=2.0, height=3.0)
        u, _, mc = jctrl.solve(mc, st, pos_ref, yaw_ref)
        st = j_rk4(st, u, JX500, 0.02)
        return (st, mc), st

    jx0 = jnp.zeros(12, jnp.float32).at[2].set(3.0)
    _, jstates = jax.jit(lambda: jax.lax.scan(step, (jx0, jctrl.init_carry(jx0, seed=0)),
                                              jnp.arange(T)))()

    def draw(key, _):
        key, sub = jax.random.split(key)
        return key, jax.random.normal(sub, (cfg.num_samples, cfg.horizon, 4), jnp.float32)

    draws = np.asarray(jax.lax.scan(draw, jax.random.PRNGKey(0), None, length=T)[1])
    ctrl = MPPIController(device="cpu")
    pos, _, yaw = ramped_circle_reference(torch.arange(T, dtype=torch.float32) * 0.02,
                                          amplitude=2.0, height=3.0)
    x = torch.zeros(12)
    x[2] = 3.0
    carry, states = ctrl.init_carry(x, seed=0), []
    for i in range(T):
        u, _, carry = ctrl.solve(carry, x, pos[i], yaw[i],
                                 eps=convert.mppi_noise_from_numpy(draws[i], device="cpu"))
        x = rigid_body_rk4_step_fast(x, u, X500_PARAMS, 0.02)
        states.append(x)
    states = torch.stack(states).numpy()
    rms = lambda s: float(np.sqrt(np.mean(np.sum((s[:, 0:3] - pos.numpy()) ** 2, axis=1))))
    jrms = rms(np.asarray(jstates))
    assert np.isfinite(states).all() and jrms > 0.0
    assert abs(rms(states) - jrms) <= 5e-3, (rms(states), jrms)
