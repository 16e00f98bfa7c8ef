"""Port parity for the 12-state SQP family against the JAX package on the
CPU, all in float64: the LTV condensation (serial and by doubling), the
per-tick ``SQPMPC.solve`` of the three engines over warm-started ticks,
the multi-tick tier ``sqp_multitick_rollout`` (nonlinear, linear and
custom plan re-anchors; obstacle rows with the attitude-recovery
fallback), the fallback law, and the errors both packages raise.

Tolerances: condensation 1e-10 relative; solves and flights 1e-8 (the same
algebra in float64; products and the Cholesky factor round differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control import mpc_rigid as jmr
from unmanned_aerial_vehicles_tpu.loop import rigid_loop as jloop
from unmanned_aerial_vehicles_tpu.models import GZ_QUADROTOR_PARAMS as JGZ
from unmanned_aerial_vehicles_tpu.models import X500_PARAMS as JX500
from unmanned_aerial_vehicles_tpu.models import rigid_body_rk4_step as j_rk4
from unmanned_aerial_vehicles_tpu.ops import qp as jqp
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference as j_circle
from unmanned_aerial_vehicles_tpu_torch.control import mpc_rigid as tmr
from unmanned_aerial_vehicles_tpu_torch.control.mpc_sqp import SQPConfig
from unmanned_aerial_vehicles_tpu_torch.loop import rigid_loop as tloop
from unmanned_aerial_vehicles_tpu_torch.models import GZ_QUADROTOR_PARAMS, X500_PARAMS
from unmanned_aerial_vehicles_tpu_torch.models.rigid_body import rigid_body_rk4_step
from unmanned_aerial_vehicles_tpu_torch.ops import qp as tqp
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

torch.set_num_threads(1)

F64 = torch.float64
DT, H = 0.02, 3.0
LDT = 0.1                       # the LTV engine's 10 Hz
OBSTACLE = [[1.5, 0.0, 1.0, 0.4]]
TOL = 1e-8


def close(got, want, tol=TOL, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("name", ["condense_ltv", "condense_ltv_doubling"])
def test_condensation_matches_jax(rng, name):
    N, nx, nu = 13, 12, 4
    A = np.eye(nx) + 0.1 * rng.normal(size=(N, nx, nx))
    B = rng.normal(size=(N, nx, nu))
    c = rng.normal(size=(N, nx))
    want = getattr(jqp, name)(jnp.asarray(A), jnp.asarray(B), jnp.asarray(c))
    got = getattr(tqp, name)(torch.tensor(A), torch.tensor(B), torch.tensor(c))
    for g, w in zip(got, want):
        scale = max(1.0, float(np.abs(w).max()))
        close(g, w, 1e-10 * scale)


def ltv_ref(t):
    """The LTV tests' straight line through the obstacle (x at 0.3 m/s to
    3 m, height 1 m)."""
    x = np.clip(0.3 * t, 0.0, 3.0)
    r = np.zeros(np.shape(t) + (12,))
    r[..., 0], r[..., 2] = x, 1.0
    r[..., 3] = np.where(x < 3.0, 0.3, 0.0)
    return r


def engines(kind):
    """``(jax engine, port engine, plant on numpy (x, u) -> x)`` in float64."""
    if kind == "rigid":
        return (jmr.RigidBodyMPC(dtype=jnp.float64), tmr.RigidBodyMPC(dtype=F64, device="cpu"),
                lambda x, u: np.asarray(j_rk4(jnp.asarray(x), jnp.asarray(u), JX500, DT)))
    if kind == "direct_rate":
        return (jmr.DirectRateMPC(dtype=jnp.float64), tmr.DirectRateMPC(dtype=F64, device="cpu"),
                lambda x, u: np.asarray(jmr.direct_rate_step(jnp.asarray(x), jnp.asarray(u),
                                                             jnp.zeros(12), dt=DT)))
    return (jmr.LTVTrackingMPC(num_obstacles=1, obstacle_margin=0.2, dtype=jnp.float64),
            tmr.LTVTrackingMPC(num_obstacles=1, obstacle_margin=0.2, dtype=F64, device="cpu"),
            lambda x, u: np.asarray(j_rk4(jnp.asarray(x), jnp.asarray(u), JGZ, LDT)))


@pytest.mark.parametrize("kind", ["rigid", "direct_rate", "ltv_obstacle"])
def test_solve_three_ticks_matches_jax(rng, kind):
    jeng, teng, plant = engines(kind)
    N = teng.mpc.config.horizon
    x = np.zeros(12)
    x[2] = H
    if kind == "ltv_obstacle":
        x = ltv_ref(0.0)
    x = x + 0.02 * rng.normal(size=12)
    jc, tc = jeng.init_carry(jnp.asarray(x)), teng.init_carry(torch.tensor(x))
    for tick in range(3):
        target = np.array([0.4 + 0.1 * tick, -0.2, H + 0.1])
        if kind == "rigid":
            ju, jX, jc = jeng.solve(jc, jnp.asarray(x), jnp.asarray(target), 0.3)
            tu, tX, tc = teng.solve(tc, torch.tensor(x), torch.tensor(target), 0.3)
        elif kind == "direct_rate":
            res = 0.05 * rng.normal(size=(N, 12))
            ju, jX, jc = jeng.solve(jc, jnp.asarray(x), jnp.asarray(target), jnp.asarray(res))
            tu, tX, tc = teng.solve(tc, torch.tensor(x), torch.tensor(target), torch.tensor(res))
        else:
            window = ltv_ref(LDT * (tick + np.arange(N + 1)))
            obs = np.asarray(OBSTACLE)
            ju, jX, jc = jeng.solve(jc, jnp.asarray(x), jnp.asarray(window),
                                    obstacles=jnp.asarray(obs))
            tu, tX, tc = teng.solve(tc, torch.tensor(x), torch.tensor(window),
                                    obstacles=torch.tensor(obs))
        assert tu.dtype == F64
        close(tu, ju, what=f"u0 tick {tick}")
        close(tX, jX, what=f"X tick {tick}")
        for name in ("slack", "dual", "X_prev", "U_prev"):
            close(getattr(tc, name), getattr(jc, name), what=f"{name} tick {tick}")
        x = plant(x, np.asarray(ju))


# ---- the multi-tick tier -------------------------------------------------

MT_N, MT_K, MT_T = 8, 4, 24


def circle_refs_jax(N):
    def reference_fn(ticks):
        pos, _, _ = jax.vmap(lambda t: j_circle(t, amplitude=2.0, height=H))(
            ticks.astype(jnp.float64) * DT)
        stage = jnp.concatenate([pos, jnp.zeros((ticks.shape[0], 9))], axis=1)
        return jnp.tile(stage[:, None, :], (1, N, 1))
    return reference_fn


def circle_refs_torch(N):
    def reference_fn(ticks):
        pos, _, _ = ramped_circle_reference(ticks.to(F64) * DT, amplitude=2.0, height=H)
        stage = torch.cat([pos, torch.zeros(ticks.shape[0], 9, dtype=F64)], dim=1)
        return stage[:, None, :].repeat(1, N, 1)
    return reference_fn


def line_refs(N, framework):
    """``reference_fn`` of the line: stages 1..N after each tick."""
    xp = jnp if framework == "jax" else torch

    def reference_fn(ticks):
        k = ticks[:, None] + 1 + xp.arange(N)[None, :]
        t = (k.astype(jnp.float64) if xp is jnp else k.to(F64)) * LDT
        x = xp.clip(0.3 * t, 0.0, 3.0)
        zero = xp.zeros_like(x)
        vx = xp.where(x < 3.0, 0.3 + zero, zero)
        return xp.stack([x, zero, 1.0 + zero, vx] + [zero] * 8, -1)
    return reference_fn


def fly_multitick(mode):
    """The same multi-tick flight through both packages: ``(jax outs, port
    outs)``."""
    if mode in ("nonlinear", "linear"):
        jeng = jmr.RigidBodyMPC(horizon=MT_N, dtype=jnp.float64)
        teng = tmr.RigidBodyMPC(horizon=MT_N, dtype=F64, device="cpu")
        x0 = np.zeros(12)
        x0[2] = H
        jargs = dict(plant_step=lambda x, u: j_rk4(x, u, JX500, DT), plan_roll=mode)
        targs = dict(plant_step=lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, DT),
                     plan_roll=mode)
        jref, tref = circle_refs_jax(MT_N), circle_refs_torch(MT_N)
        iters = 30
    else:
        # the obstacle line with a custom re-anchor (the plant's own RK4) and
        # the fallback at a tilt limit the flight crosses
        jeng = jmr.LTVTrackingMPC(horizon=MT_N, num_obstacles=1, obstacle_margin=0.2,
                                  dtype=jnp.float64)
        teng = tmr.LTVTrackingMPC(horizon=MT_N, num_obstacles=1, obstacle_margin=0.2, dtype=F64,
                                  device="cpu")
        x0 = ltv_ref(0.0)

        def j_roll(x, U, residuals):
            return jax.lax.scan(lambda c, u: (j_rk4(c, u, JGZ, LDT),) * 2, x, U)[1]

        def t_roll(x, U, residuals):
            out = []
            for u in U:
                x = rigid_body_rk4_step(x, u, GZ_QUADROTOR_PARAMS, LDT)
                out.append(x)
            return torch.stack(out)

        jargs = dict(plant_step=lambda x, u: j_rk4(x, u, JGZ, LDT),
                     obstacles=jnp.asarray(OBSTACLE), plan_roll_fn=j_roll,
                     fallback_fn=jloop.make_attitude_recovery_fallback(JGZ, tilt_limit=0.005))
        targs = dict(plant_step=lambda x, u: rigid_body_rk4_step(x, u, GZ_QUADROTOR_PARAMS, LDT),
                     obstacles=torch.tensor(OBSTACLE, dtype=F64), plan_roll_fn=t_roll,
                     fallback_fn=tloop.make_attitude_recovery_fallback(GZ_QUADROTOR_PARAMS,
                                                                       tilt_limit=0.005))
        jref, tref = line_refs(MT_N, "jax"), line_refs(MT_N, "torch")
        iters = 60
    common = dict(ticks_per_dispatch=MT_K, admm_iterations=iters)
    want = jax.jit(lambda x: jloop.sqp_multitick_rollout(
        jeng.mpc, jeng.cost, jref, x0=x, num_steps=MT_T, u_init=jeng.u_hover, **jargs,
        **common))(jnp.asarray(x0))
    got = tloop.sqp_multitick_rollout(teng.mpc, teng.cost, tref, x0=torch.tensor(x0),
                                      num_steps=MT_T, u_init=teng.u_hover, **targs, **common)
    return want, got


@pytest.mark.parametrize("mode", ["nonlinear", "linear", "obstacle_fallback_roll_fn"])
def test_sqp_multitick_rollout_matches_jax(mode):
    want, got = fly_multitick(mode)
    assert got["state"].shape == (MT_T, 12) and got["u"].shape == (MT_T, 4)
    close(got["state"], want["state"], what="state")
    close(got["u"], want["u"], what="u")
    for name in ("state", "X_plan", "U_plan", "z", "y"):
        close(getattr(got["carry"], name), getattr(want["carry"], name), what=name)
    if mode == "obstacle_fallback_roll_fn":
        # the fallback engaged on some ticks: their thrust is mg / cos(tilt)
        mg = GZ_QUADROTOR_PARAMS.mass * GZ_QUADROTOR_PARAMS.gravity
        s = got["state"]
        fb = (s[:, 6].abs() > 0.005) | (s[:, 7].abs() > 0.005)
        assert 0 < int(fb.sum()) < MT_T
        cos_t = torch.clamp(torch.cos(s[fb, 6]) * torch.cos(s[fb, 7]), 0.3, 1.0)
        close(got["u"][fb, 0], mg / cos_t, 1e-12)


def test_attitude_recovery_fallback_cases():
    """The emergency law engages on a tipped state, passes a level state's
    command through, and matches the JAX law on both."""
    fb = tloop.make_attitude_recovery_fallback(GZ_QUADROTOR_PARAMS)
    jfb = jloop.make_attitude_recovery_fallback(JGZ)
    mg = GZ_QUADROTOR_PARAMS.mass * GZ_QUADROTOR_PARAMS.gravity
    x_bad = np.zeros(12)
    x_bad[2], x_bad[6], x_bad[9] = 1.0, 1.3, 2.0
    x_ok = np.zeros(12)
    x_ok[2] = 1.0
    cases = ((x_bad, [0.0, -0.1, 0.1, 0.1]), (x_ok, [4.9, 0.01, -0.01, 0.0]),
             (x_ok, [np.nan, 0.0, 0.0, 0.0]))
    for x, u in cases:
        got, bad = fb(torch.tensor(x), torch.tensor(u, dtype=F64))
        want, jbad = jfb(jnp.asarray(x), jnp.asarray(u))
        assert bool(bad) == bool(jbad)
        close(got, want, 0.0)
    got, bad = fb(torch.tensor(x_bad), torch.tensor(cases[0][1], dtype=F64))
    assert bool(bad) and float(got[0]) > mg and float(got[1]) < 0.0
    got, bad = fb(torch.tensor(x_ok), torch.tensor(cases[1][1], dtype=F64))
    assert not bool(bad)
    close(got, cases[1][1], 0.0)
    # closed loop from the tipped state with hover passthrough: no
    # inversion, the tumble rate killed
    x, u_hover = torch.tensor(x_bad), torch.tensor([mg, 0.0, 0.0, 0.0], dtype=F64)
    tilt = []
    for _ in range(200):
        u, _ = fb(x, u_hover)
        tilt.append(float(x[6:8].abs().max()))
        x = rigid_body_rk4_step(x, u, GZ_QUADROTOR_PARAMS, 0.02)
    assert max(tilt) < 1.5
    assert abs(float(x[9])) < 0.5 and abs(float(x[10])) < 0.5 and abs(float(x[6])) < 1.0


def _raise_cases():
    rigid = tmr.RigidBodyMPC(horizon=5, device="cpu")
    ltv = tmr.LTVTrackingMPC(horizon=5, num_obstacles=1, device="cpu")
    rigid64 = tmr.RigidBodyMPC(horizon=5, dtype=F64, device="cpu")
    refs = lambda t: torch.zeros(t.shape[0], 5, 12)
    plant = lambda x, u: x
    x0 = torch.zeros(12)
    staged = tloop.sqp_multitick_rollout
    fused = tloop.direct_rate_multitick_fused
    return {
        "plan_roll": (lambda: staged(rigid.mpc, rigid.cost, refs, plant, x0, 8, 4,
                                     plan_roll="quadratic"), "plan_roll"),
        "obstacles without rows": (lambda: staged(rigid.mpc, rigid.cost, refs, plant, x0, 8, 4,
                                                  obstacles=torch.zeros(1, 4)), "num_obstacles=0"),
        "num_steps % K": (lambda: staged(rigid.mpc, rigid.cost, refs, plant, x0, 10, 4),
                          "multiple"),
        "fused f64": (lambda: fused(rigid64.mpc, rigid64.cost, refs, x0, 8, 4), "f32-only"),
        "fused obstacle rows": (lambda: fused(ltv.mpc, ltv.cost, refs, x0, 8, 4),
                                "no obstacle rows"),
        "fused plant": (lambda: fused(rigid.mpc, rigid.cost, refs, x0, 8, 4, plant="euler"),
                        "in-kernel plant"),
        "fused rigid without body": (lambda: fused(rigid.mpc, rigid.cost, refs, x0, 8, 4,
                                                   plant="rigid"), "body"),
        "fused plan_roll": (lambda: fused(rigid.mpc, rigid.cost, refs, x0, 8, 4,
                                          plan_roll="quadratic"), "plan_roll"),
        "fused num_steps % K": (lambda: fused(rigid.mpc, rigid.cost, refs, x0, 10, 4),
                                "multiple"),
    }


@pytest.mark.parametrize("case", list(_raise_cases()))
def test_multitick_value_errors(case):
    call, match = _raise_cases()[case]
    with pytest.raises(ValueError, match=match):
        call()
