"""Monte Carlo robustness studies: populations of flights under dispersed
plants, winds and start states (port of ``loop/monte_carlo.py``).

``sample_conditions`` draws the population from an explicit
``torch.Generator`` seeded with ``mc.seed``: log-normal jitters of mass,
drag, rate-loop lags and the hover-thrust calibration, a steady Gaussian
wind per world axis and jittered start states. The JAX package vmaps one
flight over the population; the port's kernel launches cannot pass under
``torch.func.vmap``, so the population flies as one batch on the kernels'
flight axis (``loop.closed_loop.batched_mpc_flight_rollout`` and
``batched_pid_flight_rollout``): with ``LinearMPCConfig(
use_fused_controller=True)`` every tick is one launch of K16 for all
flights, and ``FlightLoopConfig(use_pallas_plant=True)`` one launch of K2
(MPC) or K1 (PID) with one plant row per flight.

``monte_carlo_mpc`` routes every tier: the fused tiers
(``loop_cfg.use_fused_tick``) fly one launch of K4 per tick
(``ticks_per_dispatch=1``) or of K5 per K ticks for all flights, one block
per flight; ``use_fused_admm`` one launch of K6 per tick for all flights;
``polish`` each flight's active-set polish. ``monte_carlo_mpc12`` flies the
12-state SQP engine on its nominal model against dispersed true plants
(``loop.rigid_loop.sqp_multitick_population``), every member's truth
stepped by one launch of K10 a tick with a body per member.

``monte_carlo_pid`` and ``monte_carlo_mpc`` take ``conditions=(bodies,
rate_loops, x0)`` in place of the draw, ``monte_carlo_mpc12``
``conditions=(bodies, x0)``, so a test can fly another package's
population (``convert.monte_carlo_conditions_from_numpy``,
``convert.rigid_conditions_from_numpy``). ``robustness_stats`` gives the
campaign's dispersion statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .._device import resolve_device
from ..control.cascade_pid import CascadePidGains
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams
from .closed_loop import (
    FlightLoopConfig,
    batched_mpc_flight_rollout,
    batched_pid_flight_rollout,
    plant_block,
)

__all__ = [
    "MonteCarloConfig", "sample_conditions", "plant_block", "robustness_stats",
    "monte_carlo_flights", "monte_carlo_pid", "monte_carlo_mpc", "monte_carlo_mpc12",
]


@dataclass(frozen=True)
class MonteCarloConfig:
    """Dispersion model. Multiplicative jitters are log-normal
    (``param * exp(pct * N(0, 1))``), wind is additive Gaussian per world
    axis, the start is jittered around the nominal take-off state."""

    n_rollouts: int = 256
    seed: int = 0
    mass_jitter_pct: float = 0.10
    drag_jitter_pct: float = 0.30
    tau_jitter_pct: float = 0.20
    hover_thrust_jitter_pct: float = 0.03
    wind_std: float = 0.8            # m/s, steady world-frame wind per axis
    initial_pos_std: float = 0.3     # m
    initial_vel_std: float = 0.1     # m/s
    settle_steps: int = 250          # ticks left out of the RMS (take-off ramp)
    crash_error_m: float = 10.0      # max |pos err| beyond which a flight crashed


def sample_conditions(
    generator: torch.Generator | None,
    mc: MonteCarloConfig,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    takeoff_height: float = 3.0,
    device=None,
):
    """Draw ``mc.n_rollouts`` flights' ``(bodies, rate_loops, x0)``: every
    field of ``bodies`` and ``rate_loops`` a ``(B,)`` float32 tensor (the
    wind a tuple of three), ``x0 (B, 12)``. The draws come from
    ``generator`` in the JAX package's order (the JAX key's place; None: a
    CPU ``torch.Generator`` seeded with ``mc.seed``, so the card and the CPU
    fly the same population); the two packages' random streams differ."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(mc.seed)
    n = mc.n_rollouts
    normal = lambda *shape: torch.randn(*shape, generator=gen, dtype=torch.float32)
    logn = lambda pct, *shape: torch.exp(pct * normal(*(shape or (n,))))
    on = lambda t: t.to(dev)
    full = lambda v: torch.full((n,), float(v), dtype=torch.float32, device=dev)

    mass = body.mass * logn(mc.mass_jitter_pct)
    kdl = body.k_drag_linear * logn(mc.drag_jitter_pct)
    kda = body.k_drag_angular * logn(mc.drag_jitter_pct)
    wind = mc.wind_std * normal(n, 3)
    bodies = RigidBodyParams(
        mass=on(mass), gravity=full(body.gravity), inertia_xx=full(body.inertia_xx),
        inertia_yy=full(body.inertia_yy), inertia_zz=full(body.inertia_zz),
        k_drag_linear=on(kdl), k_drag_angular=on(kda), wind=tuple(on(wind).unbind(1)),
    )
    taus = logn(mc.tau_jitter_pct, n, 3)
    hover = rate_loop.hover_thrust_norm * logn(mc.hover_thrust_jitter_pct)
    rate_loops = RateLoopParams(
        tau_roll=on(rate_loop.tau_roll * taus[:, 0]), tau_pitch=on(rate_loop.tau_pitch * taus[:, 1]),
        tau_yaw=on(rate_loop.tau_yaw * taus[:, 2]), hover_thrust_norm=on(hover),
    )
    x0 = torch.zeros(n, 12, dtype=torch.float32)
    x0[:, 2] = takeoff_height
    x0[:, 0:3] += mc.initial_pos_std * normal(n, 3)
    x0[:, 3:6] += mc.initial_vel_std * normal(n, 3)
    return bodies, rate_loops, on(x0)


def robustness_stats(
    positions: torch.Tensor,     # (B, T, 3)
    pos_ref: torch.Tensor,       # (T, 3)
    settle_steps: int,
    crash_error_m: float,
) -> dict:
    """Population dispersion statistics: per-flight RMS (after
    ``settle_steps``) and max position error, success (finite and never
    beyond ``crash_error_m``), the success rate, and the mean and
    percentiles of the successful flights' RMS (NaN when none succeeded;
    ``torch.nanquantile`` with linear interpolation, as
    ``jnp.nanpercentile``)."""
    err = torch.linalg.vector_norm(positions - pos_ref[None], dim=-1)   # (B, T)
    rms = torch.sqrt(torch.mean(err[:, settle_steps:] ** 2, dim=1))
    max_err = torch.amax(err, dim=1)
    finite = torch.isfinite(positions).all(dim=2).all(dim=1)
    success = finite & (max_err < crash_error_m)
    rms_ok = torch.where(success, rms, torch.nan)
    pct = lambda q: torch.nanquantile(rms_ok, q / 100.0, interpolation="linear")
    return {
        "rms_pos": rms,
        "max_pos": max_err,
        "success": success,
        "success_rate": torch.mean(success.to(torch.float32)),
        "rms_mean": torch.nanmean(rms_ok),
        "rms_p50": pct(50.0),
        "rms_p90": pct(90.0),
        "rms_p99": pct(99.0),
        "worst_max_pos": torch.amax(torch.where(finite, max_err, torch.inf)),
    }


def monte_carlo_flights(
    flight_fn: Callable,
    reference_fn: Callable,
    num_steps: int,
    mc: MonteCarloConfig = MonteCarloConfig(),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
    conditions=None,
    device=None,
) -> dict:
    """The generic engine: ``flight_fn(bodies, rate_loops, x0) -> states
    (B, T, 12)`` flies the whole population at once (a batched flight, not
    one flight mapped); returns ``robustness_stats``. ``conditions=(bodies,
    rate_loops, x0)`` replaces the draw."""
    dev = resolve_device(device)
    if conditions is None:
        conditions = sample_conditions(None, mc, body, rate_loop, loop_cfg.takeoff_height,
                                       device=dev)
    states = flight_fn(*conditions)
    ts = torch.arange(num_steps, device=dev).to(torch.float32) * loop_cfg.control_dt
    pos_ref, _ = reference_fn(ts)
    return robustness_stats(states[:, :, 0:3].to(torch.float32), pos_ref.to(torch.float32),
                            mc.settle_steps, mc.crash_error_m)


def monte_carlo_pid(
    reference_fn: Callable,
    num_steps: int,
    mc: MonteCarloConfig = MonteCarloConfig(),
    gains: CascadePidGains | None = None,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
    conditions=None,
    device=None,
    plain_kernels: bool = False,
) -> dict:
    """Cascade-PID population study (``batched_pid_flight_rollout``; with
    ``loop_cfg.use_pallas_plant`` one K1 launch per tick). ``device``
    defaults to ``cuda``; ``plain_kernels=True`` flies the plain versions."""
    dev = resolve_device(device)

    def flight(bodies, rate_loops, x0):
        return batched_pid_flight_rollout(reference_fn, num_steps, bodies, rate_loops, x0,
                                          gains=gains, cfg=loop_cfg, device=dev,
                                          plain_kernels=plain_kernels)["state"]

    return monte_carlo_flights(flight, reference_fn, num_steps, mc, body, rate_loop, loop_cfg,
                               conditions, dev)


def monte_carlo_mpc(
    mpc,
    reference_fn: Callable,
    num_steps: int,
    mc: MonteCarloConfig = MonteCarloConfig(),
    residual_fn: Callable | None = None,
    preview: bool = False,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
    conditions=None,
    device=None,
    plain_kernels: bool = False,
) -> dict:
    """(GP-)MPC population study on any tier (``batched_mpc_flight_rollout``):
    staged, K16 per tick for an MPC built with ``use_fused_controller``, K6
    with ``use_fused_admm``, the batched composite ADMM otherwise (with
    ``polish``, polished per flight); K2 per tick with
    ``loop_cfg.use_pallas_plant``; ``loop_cfg.use_fused_tick`` K4 per tick
    or K5 per ``ticks_per_dispatch`` ticks for all flights. ``device``
    defaults to ``cuda`` and must match the MPC's."""
    dev = resolve_device(device)

    def flight(bodies, rate_loops, x0):
        return batched_mpc_flight_rollout(mpc, reference_fn, num_steps, bodies, rate_loops, x0,
                                          cfg=loop_cfg, residual_fn=residual_fn, preview=preview,
                                          device=dev, plain_kernels=plain_kernels)["state"]

    return monte_carlo_flights(flight, reference_fn, num_steps, mc, body, rate_loop, loop_cfg,
                               conditions, dev)


def monte_carlo_mpc12(
    engine,
    reference_fn: Callable,
    num_steps: int,
    mc: MonteCarloConfig = MonteCarloConfig(),
    body: RigidBodyParams | None = None,
    ticks_per_dispatch: int = 8,
    admm_iterations: int = 30,
    dt: float = 0.02,
    takeoff_height: float = 3.0,
    use_fallback: bool = True,
    conditions=None,
    device=None,
    plain_kernels: bool = False,
) -> dict:
    """12-state-family population study: the multi-tick SQP tier under a
    dispersed true plant.

    ``engine`` is a nominal-model controller (``control.mpc_rigid.
    RigidBodyMPC``, on ``device``); each member's true plant is its own
    jittered ``RigidBodyParams`` (mass, drag and wind log-normal or Gaussian
    per ``mc``, around ``body``, default ``X500_PARAMS``) while the
    controller keeps flying its nominal model. The population flies as one
    batch (``loop.rigid_loop.sqp_multitick_population``): per tick every
    member's true RK4 step is one launch of K10 with a body per member
    (``plain_kernels=True``: its plain version). ``X500_PARAMS`` has no
    drag, so the wind (which enters through the airspeed drag) is inert
    there. ``use_fallback`` arms ``make_attitude_recovery_fallback`` per
    member, with the nominal mass's gravity compensation and the engine's
    1.2 x nominal thrust ceiling. ``conditions=(bodies, x0)`` replaces the
    draw (the rate loops of ``sample_conditions`` are not used).

    ``reference_fn(t (T,)) -> (pos (T, 3), yaw (T,))``; returns
    ``robustness_stats``."""
    from ..models.params import X500_PARAMS
    from ..ops.rigid_plant_pallas import rigid_body_rollout_fused, rigid_body_rollout_plain
    from .rigid_loop import make_attitude_recovery_fallback, sqp_multitick_population

    dev = resolve_device(device)
    if body is None:
        body = X500_PARAMS
    N = engine.mpc.config.horizon
    if conditions is None:
        bodies, _, x0 = sample_conditions(None, mc, body, RateLoopParams(), takeoff_height,
                                          device=dev)
    else:
        bodies, x0 = conditions

    def ref_ticks(ticks):
        pos, _ = reference_fn(ticks.to(torch.float32) * dt)
        stage = torch.cat([pos.to(torch.float32),
                           torch.zeros(ticks.shape[0], 9, dtype=torch.float32, device=dev)], dim=1)
        return stage[:, None, :].repeat(1, N, 1)

    rollout = rigid_body_rollout_plain if plain_kernels else rigid_body_rollout_fused
    plant = lambda x, u: rollout(x, u[:, None, :], bodies, dt)[:, 0]
    fallback = (make_attitude_recovery_fallback(body, thrust_max=1.2 * body.mass * body.gravity)
                if use_fallback else None)
    outs = sqp_multitick_population(engine.mpc, engine.cost, ref_ticks, plant, x0, num_steps,
                                    ticks_per_dispatch=ticks_per_dispatch,
                                    admm_iterations=admm_iterations, u_init=engine.u_hover,
                                    fallback_fn=fallback)
    ts = torch.arange(num_steps, device=dev).to(torch.float32) * dt
    pos_ref, _ = reference_fn(ts)
    return robustness_stats(outs["state"][:, :, 0:3].to(torch.float32),
                            pos_ref.to(torch.float32), mc.settle_steps, mc.crash_error_m)
