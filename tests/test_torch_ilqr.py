"""Port parity for the iLQR engine against the JAX package on the CPU: the
sequential and the log-depth Riccati solvers (float64, 1e-10 and 1e-8, at
horizons that are and are not powers of two), ``ilqr_solve`` on both
Riccati engines and ``ilqr_optimality`` (float64, 1e-9),
``ILQRRigidBodyMPC.solve`` for both integrators (float32, 1e-5; float64,
1e-9) and the policy tier ``ilqr_multitick_rollout`` on the circle task
(float32, 1e-4 m per tick).

The float32 solves run one iteration. From the second iteration on, the
best-iterate choice compares two nearly converged iterates whose costs
agree to float32's resolution, so a rounding decides it: at two iterations
the JAX package's own float32 solve differs from its float64 solve by the
order of 1e-4 on a torque, and so do the two packages' float32 solves. The
float64 solves hold the choice itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control import ilqr as jilqr
from unmanned_aerial_vehicles_tpu.loop import rigid_loop as jloop
from unmanned_aerial_vehicles_tpu.models import X500_PARAMS as JX500
from unmanned_aerial_vehicles_tpu.models import rigid_body_rk4_step as j_rk4
from unmanned_aerial_vehicles_tpu.ops import parallel_riccati as jpr
from unmanned_aerial_vehicles_tpu.ops import riccati as jr
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference as j_circle
from unmanned_aerial_vehicles_tpu_torch.control import ilqr as tilqr
from unmanned_aerial_vehicles_tpu_torch.loop import rigid_loop as tloop
from unmanned_aerial_vehicles_tpu_torch.models import X500_PARAMS
from unmanned_aerial_vehicles_tpu_torch.models.rigid_body import rigid_body_rk4_step
from unmanned_aerial_vehicles_tpu_torch.ops import parallel_riccati as tpr
from unmanned_aerial_vehicles_tpu_torch.ops import riccati as tr
from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import rigid_body_rollout_plain
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

torch.set_num_threads(1)

F64 = torch.float64
HORIZON, DT, H = 8, 0.02, 3.0


def close(got, want, tol, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol, err_msg=what)


def lqr_problem(rng, N, nx=12, nu=4):
    A = np.eye(nx) + 0.05 * rng.normal(size=(N, nx, nx))
    B = 0.1 * rng.normal(size=(N, nx, nu))
    c = 0.1 * rng.normal(size=(N, nx))
    q = rng.uniform(0.5, 2.0, size=(N + 1, nx))
    r = rng.uniform(0.1, 1.0, size=nu)
    return [A, B, c, q, r, rng.normal(size=(N + 1, nx)), rng.normal(size=(N, nu)),
            rng.normal(size=nx)]


@pytest.mark.parametrize("solver,tol", [("sequential", 1e-10), ("parallel", 1e-8)])
@pytest.mark.parametrize("N", [1, 2, 3, 7, 16, 33])
def test_riccati_matches_jax(rng, solver, tol, N):
    args = lqr_problem(rng, N)
    if solver == "sequential":
        want = jr.lqr_tracking_solve(*map(jnp.asarray, args))
        got = tr.lqr_tracking_solve(*map(torch.tensor, args))
    else:
        want = jpr.lqr_tracking_solve_parallel(*map(jnp.asarray, args))
        got = tpr.lqr_tracking_solve_parallel(*map(torch.tensor, args))
    assert isinstance(got, tr.LQRSolution)
    for name in ("U", "X", "gains", "feedforward"):
        w = getattr(want, name)
        close(getattr(got, name), w, tol * max(1.0, float(np.abs(w).max())), name)


@pytest.mark.parametrize("L", [1, 5, 8, 13])
@pytest.mark.parametrize("reverse", [False, True])
def test_inclusive_scan_is_the_serial_fold(L, reverse):
    """The hand-written scan against a serial fold of a non-commutative
    combine (2x2 matrix products, earlier element first)."""
    mats = torch.randn(L, 2, 2, generator=torch.Generator().manual_seed(L), dtype=F64)
    combine = lambda a, b: (b[0] @ a[0],)
    (got,) = tpr.inclusive_scan(combine, (mats,), reverse=reverse)
    for k in range(L):
        span = range(k, L) if reverse else range(k + 1)
        want = torch.eye(2, dtype=F64)
        for i in span:
            want = mats[i] @ want
        close(got[k], want.numpy(), 1e-12, f"element {k}")


def rigid_task(dtype):
    """``(step, x0, U_init, q, r, x_ref, u_ref, lo, hi)`` of the 12-state
    task for both packages: RK4 rigid body, hover warm start, a target
    0.5 m off."""
    jd = jnp.float64 if dtype == F64 else jnp.float32
    jeng = jilqr.ILQRRigidBodyMPC(horizon=HORIZON, integrator="rk4", dtype=jd)
    x0 = np.zeros(12)
    x0[2], x0[3], x0[7] = H, 0.2, 0.05
    x_ref = np.tile(np.concatenate([[0.5, -0.3, H + 0.2], np.zeros(9)]), (HORIZON + 1, 1))
    U_init = np.tile(np.asarray(jeng.u_hover), (HORIZON, 1))
    base = [x0, U_init, np.asarray(jeng.q_diag), np.asarray(jeng.r_diag), x_ref, U_init]
    bounds = [np.asarray(jeng.u_lower), np.asarray(jeng.u_upper)]
    J = [jnp.asarray(a, jd) for a in base + bounds]
    T = [torch.tensor(a, dtype=dtype) for a in base + bounds]
    j_step = lambda x, u: j_rk4(x, u, JX500, DT)
    t_step = lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, DT)
    return (j_step, J), (t_step, T)


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("rollout", ["step_fn", "rollout_fn"])
def test_ilqr_solve_matches_jax(parallel, rollout):
    """Three iterations on both Riccati engines; ``rollout_fn`` replaced
    by K10's plain version in float64 (``rigid_body_rollout_plain``, the
    kernel's own expressions) on the port and by a serial loop of the RK4
    step in JAX."""
    (j_step, J), (t_step, T) = rigid_task(F64)
    kw = dict(iterations=3, reg=1e-2, parallel=parallel)
    jkw, tkw = dict(kw), dict(kw)
    if rollout == "rollout_fn":
        tkw["rollout_fn"] = lambda x, U: rigid_body_rollout_plain(x, U, X500_PARAMS, DT)
        jkw["rollout_fn"] = lambda x, U: jax.lax.scan(lambda c, u: (j_step(c, u),) * 2, x, U)[1]
    want = jilqr.ilqr_solve(j_step, J[0], J[1], *J[2:6], u_lower=J[6], u_upper=J[7], **jkw)
    got = tilqr.ilqr_solve(t_step, T[0], T[1], *T[2:6], u_lower=T[6], u_upper=T[7], **tkw)
    for name in ("U", "X", "gains"):
        w = getattr(want, name)
        close(getattr(got, name), w, 1e-9 * max(1.0, float(np.abs(w).max())), name)
    close(got.cost, want.cost, 1e-9 * max(1.0, float(want.cost)), "cost")


@pytest.mark.parametrize("bounds", ["inactive", "binding"])
def test_ilqr_optimality_matches_jax(bounds):
    """At an early iterate (large residual) and with a bound moved onto
    the iterate so the projected components engage."""
    (j_step, J), (t_step, T) = rigid_task(F64)
    sol = jilqr.ilqr_solve(j_step, J[0], J[1], *J[2:6], iterations=1, u_lower=J[6],
                           u_upper=J[7])
    U = np.asarray(sol.U)
    lo, hi = np.asarray(J[6]), np.asarray(J[7])
    if bounds == "binding":
        hi = hi.copy()
        hi[1] = U[0, 1]
        lo = lo.copy()
        lo[2] = U[1, 2]
    want = jilqr.ilqr_optimality(j_step, J[0], jnp.asarray(U), *J[2:6], u_lower=jnp.asarray(lo),
                                 u_upper=jnp.asarray(hi))
    got = tilqr.ilqr_optimality(t_step, T[0], torch.tensor(U), *T[2:6], u_lower=torch.tensor(lo),
                                u_upper=torch.tensor(hi))
    close(got, want, 1e-9 * max(1.0, float(want)))
    assert float(got) > 0.0


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ilqr_rigid_body_mpc_solve_matches_jax(rng, integrator, dtype):
    """Three warm-started ticks with a moving target and yaw; the state
    steps through JAX's float64 plant under JAX's control."""
    f64 = dtype == "float64"
    jd, td = (jnp.float64, F64) if f64 else (jnp.float32, torch.float32)
    iterations, tol = (2, 1e-9) if f64 else (1, 1e-5)
    jeng = jilqr.ILQRRigidBodyMPC(horizon=HORIZON, iterations=iterations,
                                  integrator=integrator, dtype=jd)
    teng = tilqr.ILQRRigidBodyMPC(horizon=HORIZON, iterations=iterations,
                                  integrator=integrator, dtype=td, device="cpu")
    assert teng.rollout_fn is None       # the kernel's rollouts are for CUDA states
    x = np.zeros(12)
    x[2] = H
    x = x + 0.05 * rng.normal(size=12)
    jc, tc = jeng.init_carry(jnp.asarray(x, jd)), teng.init_carry(torch.tensor(x, dtype=td))
    for tick in range(3):
        target = np.array([0.3 + 0.1 * tick, -0.2, H + 0.1])
        ju, jX, jc = jeng.solve(jc, jnp.asarray(x, jd), jnp.asarray(target, jd), 0.2)
        tu, tX, tc = teng.solve(tc, torch.tensor(x, dtype=td), torch.tensor(target, dtype=td), 0.2)
        assert tu.dtype == td
        close(tu, ju, tol, f"u0 tick {tick}")
        close(tX, jX, tol, f"X tick {tick}")
        close(tc.U_prev, jc.U_prev, tol, f"U_prev tick {tick}")
        x = np.asarray(j_rk4(jnp.asarray(x), jnp.asarray(np.asarray(ju), jnp.float64), JX500, DT))


def j_circle_refs(ticks):
    return jax.vmap(lambda t: j_circle(t, amplitude=2.0, height=H)[0])(
        ticks.astype(jnp.float32) * DT)


def t_circle_refs(ticks):
    return ramped_circle_reference(ticks.to(torch.float32) * DT, amplitude=2.0, height=H)[0]


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_ilqr_multitick_rollout_matches_jax(integrator):
    """The policy tier on the circle task, K=2, two iterations, 40 ticks in
    float32: the state and control of every tick and the final carry."""
    T = 40
    jeng = jilqr.ILQRRigidBodyMPC(horizon=HORIZON, iterations=2, integrator=integrator)
    teng = tilqr.ILQRRigidBodyMPC(horizon=HORIZON, iterations=2, integrator=integrator,
                                  device="cpu")
    x0 = np.zeros(12, np.float32)
    x0[2] = H
    want = jloop.ilqr_multitick_rollout(jeng, j_circle_refs, lambda x, u: j_rk4(x, u, JX500, DT),
                                        jnp.asarray(x0), T, 2)
    got = tloop.ilqr_multitick_rollout(
        teng, t_circle_refs, lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, DT),
        torch.tensor(x0), T, 2)
    assert tuple(got["state"].shape) == (T, 12) and tuple(got["u"].shape) == (T, 4)
    gap = np.abs(got["state"][:, 0:3].numpy() - np.asarray(want["state"])[:, 0:3]).max(axis=1)
    assert float(gap.max()) <= 1e-4, gap
    close(got["u"], want["u"], 1e-3, "u")
    close(got["carry"].U_prev, want["carry"].U_prev, 1e-3, "U_prev")


def test_ilqr_entry_points_refuse_bad_input():
    teng = tilqr.ILQRRigidBodyMPC(horizon=HORIZON, device="cpu")
    with pytest.raises(ValueError, match="multiple of K"):
        tloop.ilqr_multitick_rollout(teng, t_circle_refs, lambda x, u: x, torch.zeros(12), 5, 2)
    with pytest.raises(ValueError, match="integrator"):
        tilqr.ILQRRigidBodyMPC(integrator="midpoint", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tilqr.ILQRRigidBodyMPC()
