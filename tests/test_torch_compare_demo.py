"""Port parity for the comparison harness (``loop.compare``, the comparison
PID of ``control.cascade_pid``) and the demo MPCs (``control.mpc_demo``)
against the JAX package on the CPU.

* The harness over the reference's 30 s at 10 Hz, every trajectory type:
  per-step errors within 1e-5 m in float32 (1e-10 in float64) and the
  winner equal, except where the reference's PID is chaotic (the moving
  references: see ``test_comparison_matches_jax``); the references and
  single PID steps within 1e-14 in float64.
* ``RK4DemoMPC``: ``u0`` and ``X_opt`` within 1e-5 of the JAX package over
  20 warm-started float32 solves (K14's plain version, which its wrapper
  runs for CPU tensors), within 1e-10 in float64 (the plain float64 loop).
* ``AttitudeMPC``: 10 closed-loop ticks on the SQP engine, the plans within
  1e-5 and ``u0`` within 1e-5 of its size in float32 (1e-10 in float64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control import (
    AttitudeMPC as JAttitudeMPC,
    ComparisonPidParams as JPidParams,
    RK4DemoMPC as JDemo,
    comparison_pid_init as j_pid_init,
    comparison_pid_step as j_pid_step,
)
from unmanned_aerial_vehicles_tpu.control.mpc_demo import attitude_mpc_step as j_att_step
from unmanned_aerial_vehicles_tpu.loop.compare import (
    comparison_reference as j_reference,
    comparison_summary as j_summary,
    run_comparison as j_run,
)
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control import (
    AttitudeMPC,
    RK4DemoMPC,
    comparison_pid_init,
    comparison_pid_step,
)
from unmanned_aerial_vehicles_tpu_torch.control.mpc_demo import attitude_mpc_step
from unmanned_aerial_vehicles_tpu_torch.loop import (
    TRAJECTORY_TYPES,
    comparison_reference,
    comparison_summary,
    run_comparison,
    run_full_comparison,
)

torch.set_num_threads(1)

COMPARE_TOL_M = 1e-5
PID_CHAOS_STEPS = 25          # the moving references' PID flights part after ~30 steps
MPC_F32_MOVING_TOL_M = 1e-4
PID_AVG_MOVING_TOL_M = 1e-3   # the chaotic PID's average error over 30 s
DEMO_SOLVES, DEMO_F32_TOL, DEMO_F64_TOL = 20, 1e-5, 1e-10
ATT_TICKS, ATT_TOL = 10, 1e-5


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("traj", TRAJECTORY_TYPES)
def test_comparison_matches_jax(traj, dtype):
    """Per-step errors of both controllers against the JAX package's jitted
    harness. On the moving references the reference's PID is chaotic: it
    writes its clipped torque into the attitude, so the attitude map
    ``att' = clip(5 (des - att), +-0.1)`` multiplies a rounding difference
    5-fold a step until the clip catches it, and XLA's fused float32 ops
    and arcsin round differently from PyTorch's in the last bit; the two
    PID flights part after ~30 steps in float32 (~40 in float64) and end
    ~2e-2 m apart in either precision. There the PID is held per step over
    its first ``PID_CHAOS_STEPS`` and by its average error after."""
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.float64, torch.float64)
    tol = COMPARE_TOL_M if dtype == "float32" else 1e-10
    want = jax.jit(lambda: j_run(traj, 30.0, 0.1, dtype=jd))()
    got = run_comparison(traj, 30.0, 0.1, dtype=td, device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
        assert got[key].dtype == td, key
    gap = {key: np.abs(got[key].numpy() - np.asarray(want[key]))
           for key in ("pid_error", "mpc_error")}
    moving = traj in ("circle", "figure8")
    pid_steps = PID_CHAOS_STEPS if moving else None
    assert gap["pid_error"][:pid_steps].max() <= tol
    # the stand-in MPC is not chaotic; in float32 it carries a rounding
    # ~1e3-fold on the moving references (5.2e-5 m on the circle)
    assert gap["mpc_error"].max() <= (MPC_F32_MOVING_TOL_M if moving and dtype == "float32"
                                      else tol)
    s_got, s_want = comparison_summary(got), j_summary(want)
    assert s_got["winner"] == s_want["winner"]
    assert abs(s_got["pid_avg_error"] - s_want["pid_avg_error"]) <= (
        PID_AVG_MOVING_TOL_M if moving else tol)


def test_comparison_reference_matches_jax():
    times = np.linspace(0.0, 12.0, 121)
    for traj in TRAJECTORY_TYPES:
        want = np.stack([np.asarray(j_reference(t, traj)) for t in times])
        got = comparison_reference(torch.tensor(times), traj)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match="unknown trajectory"):
        comparison_reference(torch.zeros(1), "spiral")


def test_comparison_pid_step_matches_jax():
    """One PID tick from random states, the JAX parameters carried across
    (``convert.comparison_pid_params_from_fields``)."""
    jparams = JPidParams(kp_pos=12.0, max_integral=1.5)
    params = convert.comparison_pid_params_from_fields(dataclasses.asdict(jparams))
    assert params.max_thrust == pytest.approx(jparams.max_thrust)
    rng = np.random.default_rng(2)
    z_j, z_t = j_pid_init(jnp.float64), comparison_pid_init(torch.float64, "cpu")
    for _ in range(5):
        state, ref = rng.normal(size=12) * 0.5, rng.normal(size=12)
        u_j, z_j = j_pid_step(jparams, z_j, jnp.asarray(state), jnp.asarray(ref), 0.1)
        u_t, z_t = comparison_pid_step(params, z_t, torch.tensor(state), torch.tensor(ref), 0.1)
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-14)
        assert abs(float(z_t) - float(z_j)) <= 1e-14


def test_full_comparison_summary():
    results = run_full_comparison(duration=3.0, dt=0.1, device="cpu")
    assert list(results) == list(TRAJECTORY_TYPES)
    for summary in results.values():
        assert summary["winner"] in ("GP-MPC", "PID")
        assert np.isfinite([summary[k] for k in summary if k != "winner"]).all()


def demo_reference(mpc_N, i, dt=0.1):
    """The JAX test's moving NED reference, ``(N+1, 6)``, as numpy."""
    ts = i * dt + dt * np.arange(mpc_N + 1)
    return np.stack([2.0 * np.sin(0.3 * ts), 2.0 * np.cos(0.3 * ts), np.full_like(ts, -2.0),
                     0.6 * np.cos(0.3 * ts), -0.6 * np.sin(0.3 * ts), np.zeros_like(ts)], axis=1)


@pytest.fixture(scope="module", params=["float32", "float64"])
def demo_flights(request):
    """JAX and port: ``DEMO_SOLVES`` warm-started solves each from the JAX
    flight's state (the exact discrete model propagating the JAX control)."""
    jd, td = (jnp.float32, torch.float32) if request.param == "float32" else (jnp.float64,
                                                                               torch.float64)
    jmpc, mpc = JDemo(dtype=jd), RK4DemoMPC(dtype=td, device="cpu")
    jsolve = jax.jit(jmpc.solve)
    state = np.array([0.0, 2.0, -2.0, 0.6, 0.0, 0.0])
    jc, tc = jmpc.init_carry(), mpc.init_carry()
    rows = []
    for i in range(DEMO_SOLVES):
        ref = demo_reference(mpc.N, i)
        u_j, X_j, jc = jsolve(jc, jnp.asarray(state, jd), jnp.asarray(ref, jd))
        u_t, X_t, tc = mpc.solve(tc, torch.tensor(state, dtype=td), torch.tensor(ref, dtype=td))
        rows.append((np.asarray(u_j), np.asarray(X_j), u_t.numpy(), X_t.numpy()))
        u = np.asarray(u_j, np.float64)
        state = state.copy()
        state[0:3] += 0.1 * state[3:6] + 0.005 * u
        state[3:6] += 0.1 * u
    return request.param, rows


def test_rk4_demo_mpc_matches_jax(demo_flights):
    dtype, rows = demo_flights
    tol = DEMO_F32_TOL if dtype == "float32" else DEMO_F64_TOL
    for u_j, X_j, u_t, X_t in rows:
        assert u_t.shape == (3,) and X_t.shape == (11, 6)
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=tol)
        np.testing.assert_allclose(X_t, X_j, rtol=0, atol=tol * max(1.0, np.abs(X_j).max()))
    assert np.abs(rows[-1][2]).max() <= 2.5 + 1e-6


def test_rk4_demo_mpc_routes():
    """Float32 on the CPU goes through K14's wrapper (its plain version for
    CPU tensors): equal to ``plain_kernels=True``; a float64 MPC keeps the
    float64 loop, within 1e-5 of the float32 solve."""
    ref = torch.tensor(demo_reference(10, 0))
    state = torch.tensor([0.0, 2.0, -2.0, 0.6, 0.0, 0.0])
    mpc = RK4DemoMPC(device="cpu")
    a = mpc.solve(mpc.init_carry(), state, ref)
    b = mpc.solve(mpc.init_carry(), state, ref, plain_kernels=True)
    assert all(torch.equal(x, y) for x, y in zip((a[0], a[1], *a[2]), (b[0], b[1], *b[2])))
    mpc64 = RK4DemoMPC(dtype=torch.float64, device="cpu")
    c = mpc64.solve(mpc64.init_carry(), state.double(), ref)
    assert c[0].dtype == torch.float64 and mpc64._use_fused() is False
    np.testing.assert_allclose(c[0].numpy(), a[0].numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_attitude_mpc_matches_jax(dtype):
    """Ten closed-loop hover ticks on the SQP engine, each from the JAX
    flight's state; the hover command of the JAX test (uT = 16.328 N)."""
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.float64, torch.float64)
    jmpc, mpc = JAttitudeMPC(dtype=jd), AttitudeMPC(dtype=td, device="cpu")
    target = np.zeros(9)
    target[2] = 2.0
    state = target.copy()
    state[0] = 0.3
    jsolve = jax.jit(jmpc.solve)
    jc, tc = jmpc.init_carry(jnp.asarray(state, jd)), mpc.init_carry(torch.tensor(state, dtype=td))
    for _ in range(ATT_TICKS):
        u_j, X_j, jc = jsolve(jc, jnp.asarray(state, jd), jnp.asarray(target, jd))
        u_t, X_t, tc = mpc.solve(tc, torch.tensor(state, dtype=td), torch.tensor(target, dtype=td))
        # u0 relative to its size (the thrust, ~14 N): float32 rounds it
        # to ~2e-5 N; the plan within 1e-5 m
        tol = ATT_TOL if dtype == "float32" else 1e-10
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                                   atol=tol * np.abs(np.asarray(u_j)).max())
        np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), rtol=0, atol=tol)
        state = np.asarray(j_att_step(jnp.asarray(state), jnp.asarray(u_j, jnp.float64),
                                      jnp.zeros(9)))
    hover = AttitudeMPC(dtype=torch.float64, device="cpu")
    x = torch.tensor(target)
    u0, _, _ = hover.solve(hover.init_carry(x), x, x)
    assert abs(float(u0[0]) - 16.328082636) < 1e-5 and abs(float(u0[1])) < 1e-6


def test_attitude_step_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(4):
        x, u, d = rng.normal(size=9) * 0.3, rng.normal(size=4), rng.normal(size=9) * 0.01
        u[0] += 14.7
        want = np.asarray(j_att_step(jnp.asarray(x), jnp.asarray(u), jnp.asarray(d)))
        got = attitude_mpc_step(torch.tensor(x), torch.tensor(u), torch.tensor(d))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
    hover = attitude_mpc_step(torch.zeros(9, dtype=torch.float64),
                              torch.tensor([1.5 * 9.81, 0.0, 0.0, 0.0], dtype=torch.float64),
                              torch.zeros(9, dtype=torch.float64))
    assert float(hover.abs().max()) <= 1e-12
