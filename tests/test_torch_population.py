"""The population tier's pieces on the CPU: the batched wrappers of K4, K5,
K6 and K10 (their plain versions with a leading flight or member axis)
against one-flight calls, the rigid fallback decided per member, the
cascade-PID population with a gain set per flight, the 12-state SQP
population against its members flown one at a time, and the batched
multi-start tuner against the JAX package's ``vmap`` of
``tune_parameters`` on the same starts.

Tolerances:
- Batched plain versions against one-flight calls 1e-6 (K10's elementwise
  math: exactly equal): the mapped products round as the single ones up to
  the summation order of a batched matrix product.
- The SQP population against its members 1e-5 m: the batched
  relinearisation and ADMM run batched products.
- The multi-start tuner against the JAX package: the loss traces and the
  best losses within 1e-4 relative (both float32; the two frameworks' PID
  and plant round differently, as ``tests/test_torch_tuning.py`` finds
  for one start).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.cascade_pid import CascadePidGains as JGains
from unmanned_aerial_vehicles_tpu.loop import pid_flight_rollout as j_pid_rollout
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference as j_circle_ref
from unmanned_aerial_vehicles_tpu.tuning import tune_parameters as j_tune_parameters
from unmanned_aerial_vehicles_tpu.tuning.autotune import (
    _cascade_gains as j_cascade_gains,
    _cascade_theta as j_cascade_theta,
    _tracking_loss as j_tracking_loss,
)
from unmanned_aerial_vehicles_tpu_torch.control.cascade_pid import CascadePidGains
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.control.mpc_rigid import RigidBodyMPC
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    MonteCarloConfig,
    batched_pid_flight_rollout,
    make_attitude_recovery_fallback,
    pid_flight_rollout,
    plant_block,
    sample_conditions,
    sqp_multitick_population,
    sqp_multitick_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.models.params import (
    GZ_QUADROTOR_PARAMS,
    X500_PARAMS,
    RigidBodyParams,
)
from unmanned_aerial_vehicles_tpu_torch.models.px4_surrogate import RateLoopParams
from unmanned_aerial_vehicles_tpu_torch.ops import admm_pallas, rigid_plant_pallas, tick_pallas
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference
from unmanned_aerial_vehicles_tpu_torch.tuning import TuneConfig, tune_cascade_gains_multistart
from unmanned_aerial_vehicles_tpu_torch.tuning.autotune import (
    _cascade_population_loss_fn,
    _cascade_theta,
    _f32_gains,
    _multistart_thetas,
    _tune_stacked,
)

torch.set_num_threads(1)

B, N = 4, 5
BATCH_TOL = 1e-6
STATICS = dict(rho=8.0, iterations=20, over_relax=1.6, dt=0.02, substeps=2,
               accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0), yawrate_limit=0.8)


def t_circle(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


def j_circle(t):
    pos, _, yaw = j_circle_ref(t, amplitude=2.0, height=3.0)
    return pos, yaw


@pytest.fixture(scope="module")
def flights():
    """B flights' dispersed plant block and starts."""
    bodies, rates, x0 = sample_conditions(None, MonteCarloConfig(n_rollouts=B, wind_std=0.8),
                                          device="cpu")
    return plant_block(bodies, rates, B, "cpu"), x0


def assert_rows_agree(batched, rows, tol=BATCH_TOL):
    for b, row in enumerate(rows):
        for got, want in zip(batched, row):
            torch.testing.assert_close(got[b], want, rtol=0, atol=tol)


def test_k4_batch_matches_one_flight_calls(flights):
    block, x0 = flights
    g = torch.Generator().manual_seed(1)
    mpc = LinearMPC(LinearMPCConfig(horizon=N, use_fused_controller=True), device="cpu")
    m, Nnx = mpc.n_constraints, 6 * N
    w = 0.02 * torch.randn(B, Nnx, generator=g)
    ref = torch.tensor([0.5, 1.0, 3.0, 0.0, 0.0, 0.0]).repeat(N)
    misc = torch.cat([torch.full((B, 1), 0.1), 0.02 * torch.randn(B, 3, generator=g)], 1)
    z, y = 0.3 * torch.randn(B, m, generator=g), 0.1 * torch.randn(B, m, generator=g)
    kw = dict(STATICS, n=N, fallback_error_m=1.0)
    got = tick_pallas.gpmpc_tick_fused(mpc._tick_data, x0, w, ref, misc, z, y, block, **kw)
    assert [tuple(t.shape) for t in got] == [(B, 25), (B, m), (B, m), (B, 4 * N), (B, Nnx)]
    assert_rows_agree(got, [tick_pallas.gpmpc_tick_fused(
        mpc._tick_data, x0[b], w[b], ref, misc[b], z[b], y[b], block[b], **kw) for b in range(B)])


def test_k5_batch_matches_one_flight_calls(flights):
    block, x0 = flights
    g = torch.Generator().manual_seed(2)
    mpc = LinearMPC(LinearMPCConfig(horizon=N, use_fused_controller=True), device="cpu")
    m, Nnx, K = mpc.n_constraints, 6 * N, 3
    aux = torch.cat([x0[:, 0:6], 0.02 * torch.randn(B, 3, generator=g)], 1)
    xtail = x0[:, 0:6].repeat(1, N) + 0.05 * torch.randn(B, Nnx, generator=g)
    z, y = 0.3 * torch.randn(B, m, generator=g), 0.1 * torch.randn(B, m, generator=g)
    refs = torch.tensor([0.5, 1.0, 3.0, 0.0, 0.0, 0.0]).repeat(K, N)
    yaw = torch.zeros(K)
    kw = dict(STATICS, k_ticks=K, use_gp=False, n=N)
    got = tick_pallas.gpmpc_multitick_fused(mpc._tick_data, None, x0, aux, xtail, z, y, refs,
                                            yaw, block, **kw)
    assert tuple(got[0].shape) == (B, K, 32)
    assert_rows_agree(got, [tick_pallas.gpmpc_multitick_fused(
        mpc._tick_data, None, x0[b], aux[b], xtail[b], z[b], y[b], refs, yaw, block[b], **kw)
        for b in range(B)])


def test_k6_batch_matches_one_qp_calls():
    g = torch.Generator().manual_seed(3)
    am = LinearMPC(LinearMPCConfig(horizon=N, use_fused_admm=True), device="cpu")
    m, n = am.n_constraints, am.n_primal
    f = torch.randn(B, n, generator=g)
    off = 0.3 * torch.randn(B, 6 * N, generator=g)
    p0, minv_f = -(f @ am._GMinv.T), f @ am._M_inv.T
    lower = torch.cat([am._u_lo.expand(B, n), am._x_lo - off], 1)
    upper = torch.cat([am._u_hi.expand(B, n), am._x_hi - off], 1)
    z, y = 0.3 * torch.randn(B, m, generator=g), 0.1 * torch.randn(B, m, generator=g)
    args = lambda b: (p0[b], am._GMinvT_f32, minv_f[b], lower[b], upper[b], z[b], y[b])
    got = admm_pallas.admm_box_qp_fused_composite(am._P1_f32, *args(slice(None)), 8.0, 20, 1.6,
                                                  SuT=am._SuT_f32)
    assert [tuple(t.shape) for t in got] == [(B, n), (B, m), (B, m)]
    assert_rows_agree(got, [admm_pallas.admm_box_qp_fused_composite(
        am._P1_f32, *args(b), 8.0, 20, 1.6, SuT=am._SuT_f32) for b in range(B)])
    with pytest.raises(ValueError, match="SuT"):
        admm_pallas.admm_box_qp_fused_composite(am._P1_f32, *args(slice(None)), 8.0, 20, 1.6)


@pytest.mark.parametrize("with_res", [False, True], ids=["plain", "residuals"])
def test_k10_members_match_one_member_calls(with_res):
    """Each member on its own body (mass, drag and wind dispersed): equal to
    a one-member rollout on that body, bit for bit."""
    g = torch.Generator().manual_seed(4)
    bodies, _, x0 = sample_conditions(None, MonteCarloConfig(n_rollouts=B, mass_jitter_pct=0.15),
                                      body=GZ_QUADROTOR_PARAMS, device="cpu")
    x0 = x0 + 0.2 * torch.randn(B, 12, generator=g)
    n = 5
    U = (bodies.mass * bodies.gravity)[:, None, None] * torch.tensor([1.0, 0, 0, 0]) \
        + 1e-3 * torch.randn(B, n, 4, generator=g)
    res = 0.1 * torch.randn(B, n, 12, generator=g) if with_res else None
    got = rigid_plant_pallas.rigid_body_rollout_fused(x0, U, bodies, 0.05, substeps=2,
                                                      residuals=res)
    assert tuple(got.shape) == (B, n, 12)
    for b in range(B):
        body = RigidBodyParams(mass=float(bodies.mass[b]), k_drag_linear=float(
            bodies.k_drag_linear[b]), k_drag_angular=float(bodies.k_drag_angular[b]),
            wind=tuple(float(w[b]) for w in bodies.wind))
        one = rigid_plant_pallas.rigid_body_rollout_fused(
            x0[b], U[b], body, 0.05, substeps=2, residuals=None if res is None else res[b])
        assert torch.equal(got[b], one)
    step = rigid_plant_pallas.rigid_body_rk4_step_fused(x0, U[:, 0], bodies, 0.05)
    torch.testing.assert_close(step, rigid_plant_pallas.rigid_body_rollout_fused(
        x0, U[:, :1], bodies, 0.05)[:, 0], rtol=0, atol=0)


def test_rigid_fallback_decides_per_member():
    """One member with a non-finite control and one tipped past the tilt
    limit engage; the others keep their controls exactly, and a single
    state's decision is unchanged."""
    fb = make_attitude_recovery_fallback(X500_PARAMS, thrust_max=1.2 * 2.0 * 9.81)
    x = torch.zeros(4, 12)
    x[:, 2] = 3.0
    x[2, 6] = 1.0                                   # rolled past 0.9 rad
    u0 = torch.tensor([[19.6, 0.01, 0.0, 0.0]]).repeat(4, 1)
    u0[1, 2] = float("nan")
    u, bad = fb(x, u0)
    assert bad.tolist() == [False, True, True, False]
    assert torch.equal(u[[0, 3]], u0[[0, 3]])
    assert torch.isfinite(u).all()
    for b in range(4):
        one, one_bad = fb(x[b], u0[b])
        assert bool(one_bad) == bool(bad[b]) and torch.equal(one, u[b])


def test_pid_population_with_gains_per_flight_matches_single_flights():
    """The batched cascade-PID flight with a gain set per flight (kp, ki, kd
    of shape (B, 3)) equals each flight flown alone with its gains."""
    g = torch.Generator().manual_seed(5)
    base = CascadePidGains.default(device="cpu")
    scale = lambda: torch.exp(0.2 * torch.randn(B, 3, generator=g))
    layers = {layer: getattr(base, layer)._replace(kp=getattr(base, layer).kp * scale(),
                                                   ki=getattr(base, layer).ki * scale(),
                                                   kd=getattr(base, layer).kd * scale())
              for layer in ("position", "velocity", "attitude")}
    gains = base._replace(**layers)
    x0 = torch.zeros(B, 12)
    x0[:, 2] = 3.0
    T = 40
    cfg = FlightLoopConfig(use_pallas_plant=True)
    batched = batched_pid_flight_rollout(t_circle, T, RigidBodyParams(), RateLoopParams(), x0,
                                         gains=gains, cfg=cfg, device="cpu")
    for b in range(B):
        one = base._replace(**{layer: getattr(gains, layer)._replace(
            kp=getattr(gains, layer).kp[b], ki=getattr(gains, layer).ki[b],
            kd=getattr(gains, layer).kd[b]) for layer in ("position", "velocity", "attitude")})
        single = pid_flight_rollout(t_circle, T, gains=one, cfg=cfg, initial_state=x0[b],
                                    device="cpu")
        torch.testing.assert_close(batched["state"][b], single["state"], rtol=0, atol=1e-6)


def test_sqp_population_matches_its_members_flown_alone():
    """Three members from their own starts on their own true plants (K10's
    plain version with a body per member) against each flown alone by
    ``sqp_multitick_rollout``, with the fallback armed."""
    eng = RigidBodyMPC(device="cpu")
    bodies, _, x0 = sample_conditions(None, MonteCarloConfig(n_rollouts=3, mass_jitter_pct=0.15),
                                      body=X500_PARAMS, device="cpu")
    Nh = eng.mpc.config.horizon

    def ref_ticks(ticks):
        pos, _ = t_circle(ticks.to(torch.float32) * 0.02)
        return torch.cat([pos, torch.zeros(ticks.shape[0], 9)], 1)[:, None, :].repeat(1, Nh, 1)

    fb = make_attitude_recovery_fallback(X500_PARAMS, thrust_max=1.2 * 2.0 * 9.81)
    T = 16
    plant = lambda x, u: rigid_plant_pallas.rigid_body_rollout_fused(x, u[:, None], bodies,
                                                                     0.02)[:, 0]
    pop = sqp_multitick_population(eng.mpc, eng.cost, ref_ticks, plant, x0, T,
                                   u_init=eng.u_hover, fallback_fn=fb)
    assert tuple(pop["state"].shape) == (3, T, 12) and tuple(pop["u"].shape) == (3, T, 4)
    for b in range(3):
        body = RigidBodyParams(mass=float(bodies.mass[b]), inertia_xx=X500_PARAMS.inertia_xx,
                               inertia_yy=X500_PARAMS.inertia_yy,
                               inertia_zz=X500_PARAMS.inertia_zz, k_drag_linear=0.0,
                               k_drag_angular=0.0)
        one = sqp_multitick_rollout(
            eng.mpc, eng.cost, ref_ticks,
            lambda x, u, body=body: rigid_plant_pallas.rigid_body_rollout_fused(
                x, u[None], body, 0.02)[0],
            x0[b], T, u_init=eng.u_hover, fallback_fn=fb)
        torch.testing.assert_close(pop["state"][b], one["state"], rtol=0, atol=1e-5)
        torch.testing.assert_close(pop["u"][b], one["u"], rtol=0, atol=1e-4)


MS_T, MS_ITERS, MS_STARTS, MS_LR, MS_SETTLE = 60, 2, 3, 0.08, 20
MS_RTOL = 1e-4


def test_multistart_tuner_matches_jax_vmapped_runs():
    """The stacked runs (one batch of flights, one Adam, each run's best
    kept by ``torch.where``) against the JAX package's ``vmap`` of
    ``tune_parameters`` over the same starts (numpy draws around the
    default gains' log-parameters), the staged plant; the public tuner
    returns the best start."""
    rng = np.random.default_rng(9)
    template = _f32_gains(CascadePidGains.default(device="cpu"), "cpu")
    theta0 = _cascade_theta(template)
    noise = {k: 0.2 * rng.normal(size=(MS_STARTS, 3)).astype(np.float32) for k in theta0}
    for k in noise:
        noise[k][0] = 0.0
    thetas = {k: v[None] + torch.from_numpy(noise[k]) for k, v in theta0.items()}
    cfg = TuneConfig(iterations=MS_ITERS, learning_rate=MS_LR, settle_steps=MS_SETTLE)
    loss = _cascade_population_loss_fn(t_circle, MS_T, template, cfg, RigidBodyParams(),
                                       RateLoopParams(), FlightLoopConfig(), "cpu", False)
    _, losses, best = _tune_stacked(loss, thetas, MS_ITERS, MS_LR)

    j_template = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), JGains.default())
    j_theta0 = j_cascade_theta(j_template)

    def j_loss(theta):
        outs = j_pid_rollout(j_circle, MS_T, gains=j_cascade_gains(theta, j_template))
        return j_tracking_loss(outs, MS_SETTLE, cfg.effort_weight)

    j_thetas = {k: v[None] + jnp.asarray(noise[k]) for k, v in j_theta0.items()}
    _, j_losses, j_best = jax.vmap(lambda th: j_tune_parameters(j_loss, th, MS_ITERS, MS_LR))(
        j_thetas)
    np.testing.assert_allclose(losses.numpy().T, np.asarray(j_losses), rtol=MS_RTOL)
    np.testing.assert_allclose(best.numpy(), np.asarray(j_best), rtol=MS_RTOL)

    result = tune_cascade_gains_multistart(t_circle, MS_T, n_starts=MS_STARTS, jitter=0.2,
                                           tune_cfg=cfg, device="cpu")
    _, losses, finals = _tune_stacked(loss, _multistart_thetas(theta0, MS_STARTS, 0.2, 0),
                                      MS_ITERS, MS_LR)
    assert float(result.final_loss) == float(finals.min())
    assert torch.equal(result.losses, losses[:, int(torch.argmin(finals))])
