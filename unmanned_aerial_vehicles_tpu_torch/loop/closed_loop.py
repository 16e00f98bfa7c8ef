"""Closed-loop flights (port of ``loop/closed_loop.py``).

``mpc_flight_rollout`` flies linear MPC @ 50 Hz -> acceleration clip ->
geometric allocation -> body rates + thrust -> PX4-surrogate plant, in
three tiers:

* staged: one Python loop step per tick of PyTorch ops on the device
  (``use_pallas_plant`` sends allocation + plant through kernel K2; an MPC
  built with ``use_fused_controller`` or ``use_fused_admm`` solves through
  K3 or K6);
* single-tick fused (``use_fused_tick=True``, ``ticks_per_dispatch=1``):
  one launch of kernel K4 per tick (shift, controller, allocation, plant),
  the ``residual_fn`` GP computed by PyTorch ops between launches;
* multi-tick (``use_fused_tick=True`` with ``ticks_per_dispatch > 1`` or a
  GP): K whole ticks per launch of kernel K5 with the GP posterior inside
  the kernel; with ``online_gp=`` the GP learns in flight — each launch's K
  transitions go into the ring buffer, and every ``refit_every`` ticks a
  masked Cholesky refit rebuilds the kernel's GP operands. With
  ``tightening_factor > 0`` the kernel also forms the GP's posterior
  variance and backs the state boxes off. ``return_resume=True`` returns a
  ``FlightResumeState`` at the flight's last launch boundary, and
  ``resume=`` continues a flight from one (``io.checkpoint`` saves and
  loads them).

The staged tier takes ``uncertainty_fn(X_prev, U_prev)`` (the stage-wise
GP std that tightens the boxes, ``gp.build_horizon_uncertainty``) and
``output_correction_fn(state6, u_opt, pos_ref)`` (the post-solve GP
correction, ``gp.make_output_correction_fn``).

``preview=True`` (every tier) gives the MPC per-stage references along the
horizon, position at ``t + dt (1..N)`` and finite-difference velocity,
instead of one point target per tick.

``pid_flight_rollout`` flies the cascade PID; with ``use_pallas_plant`` its
plant substeps go through kernel K1.

``FlightLoopConfig(fused_tick_ad=True)`` makes the kernel tiers
differentiable (the tuner's route, ``tuning.autotune``): K1, K2 and K5
launch through the ``ops.tick_ad`` autograd functions, whose forward is
the same kernel (the flight is bit-identical) and whose backward is the VJP
kernel K13a/K13b or, for K5, the VJP of its plain twin. Without it a loss
that reaches a kernel operand raises (``ops._cuda.require``).

``batched_mpc_flight_sweep`` is the throughput mode: B flights in lockstep,
one launch each of K8 (controller), K7 (GP posterior mean) and K2
(allocation + plant) per tick for the whole batch.

``batched_mpc_flight_rollout`` and ``batched_pid_flight_rollout`` fly a
population of B flights in lockstep on the staged tier, each flight with
its own plant (``bodies`` and ``rate_loops`` whose fields are ``(B,)``
tensors or shared numbers) and start: per flight what ``mpc_flight_rollout``
and ``pid_flight_rollout`` fly (the JAX package's ``vmap`` of them, which
``loop.monte_carlo`` runs). An MPC built with ``use_fused_controller``
solves every tick in one launch of K16 for all flights, one built with
``use_fused_admm`` runs every flight's ADMM in one launch of K6, the
default one runs the composite ADMM as batched PyTorch ops (then, with
``polish``, each flight's active-set polish); ``use_pallas_plant`` sends
allocation + plant through K2 (MPC) or the plant through K1 (PID), one
launch per tick with one plant row per flight. The fused tiers
(``use_fused_tick``) fly one launch of K4 per tick or of K5 per K ticks
for all flights, one block per flight.

A loop returns a dict of per-tick tensors on its device. ``reference_fn``
maps a tensor of times ``(T,)`` to ``(pos (T, 3), yaw (T,))``; the loops
evaluate it once for the whole flight.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Tuple

import torch

from .._device import full_f32_matmul, resolve_device
from ..control.allocation import AttitudeLoopState, attitude_loop_init, geometric_control_allocation
from ..control.cascade_pid import CascadePidGains, CascadeState, cascade_init, cascade_pid_step
from ..control.mpc_linear import LinearMPC
from ..control.pid import PIDGains, PIDState
from ..gp.residual_gp import ResidualGPConfig
from ..models.double_integrator import CONTROL_DIM, STATE_DIM
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams, px4_rate_tracking_step

class FlightResumeState(NamedTuple):
    """Mid-flight checkpoint of the multi-tick tier: the whole loop state at
    a launch boundary, from which a flight continues bit for bit.

    ``carry = (state (12,), aux (9,), xtail (Nnx,), z (m,), y (m,), dataset,
    gp)``: K5's carries, the online ring buffer (``ResidualDataset``, None
    for a frozen GP) and the kernel's GP rows (``GPRows`` or None). ``tick``
    is the next tick to fly. ``meta = (horizon, K, GP capacity, variance,
    scaled inputs)`` fingerprints the configuration: a resume under another
    one raises."""

    carry: tuple
    tick: int
    meta: tuple = ()


@dataclass(frozen=True)
class FlightLoopConfig:
    control_dt: float = 0.02      # 50 Hz control loop
    plant_substeps: int = 2       # plant RK4 at 100 Hz
    takeoff_height: float = 3.0
    accel_lower: Tuple[float, float, float] = (-3.5, -3.5, -4.0)
    accel_upper: Tuple[float, float, float] = (3.5, 3.5, 6.0)
    yawrate_limit: float = 0.8
    use_pallas_plant: bool = False
    use_fused_tick: bool = False
    fused_tick_loop_precision: str = "highest"
    ticks_per_dispatch: int = 1
    # differentiable kernel tiers: K1, K2 and K5 launch through the
    # ops.tick_ad autograd functions (same forward, VJP backward)
    fused_tick_ad: bool = False
    fallback_error_m: float = 0.0
    fallback_accel_scale: float = 1.5
    fallback_thrust_ceiling: float = 1.5


@dataclass(frozen=True)
class OnlineFusedGPConfig:
    """Online (in-flight) GP learning on the multi-tick path: every tick's
    transition goes into the ring buffer (quality filters included), and
    every ``refit_every`` ticks the masked refit rebuilds the kernel's GP."""

    gp: ResidualGPConfig = field(default_factory=ResidualGPConfig)
    refit_every: int = 250
    min_samples: int = 30
    standardize_inputs: bool = False


def _plant_row(body: RigidBodyParams, rate_loop: RateLoopParams, device):
    from ..ops.plant_pallas import build_plant_row

    return build_plant_row(
        body.mass, body.gravity, body.k_drag_linear,
        (rate_loop.tau_roll, rate_loop.tau_pitch, rate_loop.tau_yaw),
        body.gravity / rate_loop.hover_thrust_norm, body.wind, device=device,
    )


_WIND = ("wind_x", "wind_y", "wind_z")
_PLANT_FIELDS = ("mass", "gravity", "k_drag_linear", *_WIND, "tau_roll", "tau_pitch", "tau_yaw",
                 "hover_thrust_norm")


def _flight_columns(bodies: RigidBodyParams, rate_loops: RateLoopParams, batch: int,
                    device) -> dict:
    """Every plant field the surrogate reads, as a ``(batch,)`` float32
    column (a number is shared by every flight)."""
    col = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device).expand(batch)
    cols = dict(mass=bodies.mass, gravity=bodies.gravity, k_drag_linear=bodies.k_drag_linear,
                tau_roll=rate_loops.tau_roll, tau_pitch=rate_loops.tau_pitch,
                tau_yaw=rate_loops.tau_yaw, hover_thrust_norm=rate_loops.hover_thrust_norm,
                **dict(zip(_WIND, bodies.wind)))
    return {k: col(v) for k, v in cols.items()}


def plant_block(bodies: RigidBodyParams, rate_loops: RateLoopParams, batch: int,
                device=None) -> torch.Tensor:
    """The ``(batch, 10)`` float32 plant block of K1 and K2, one row per
    flight (``ops.plant_pallas.build_plant_row``'s lanes; the thrust gain
    ``gravity / hover_thrust_norm`` is divided in float32, as in the JAX
    package's vmapped flights)."""
    c = _flight_columns(bodies, rate_loops, batch, resolve_device(device))
    return torch.stack([
        c["mass"], c["gravity"], c["k_drag_linear"], c["tau_roll"], c["tau_pitch"], c["tau_yaw"],
        c["gravity"] / c["hover_thrust_norm"], c["wind_x"], c["wind_y"], c["wind_z"],
    ], dim=1).contiguous()


def _population_plant(states, controls, cols: dict, cfg: FlightLoopConfig):
    """The surrogate's RK4 substeps per flight, each on its own plant: the
    staged plant mapped over the flights with ``torch.func.vmap``."""
    dt_sub = cfg.control_dt / cfg.plant_substeps

    def one(s, c, mass, gravity, kdl, wx, wy, wz, tr, tp, ty, hover):
        body = RigidBodyParams(mass=mass, gravity=gravity, k_drag_linear=kdl, wind=(wx, wy, wz))
        rates = RateLoopParams(tau_roll=tr, tau_pitch=tp, tau_yaw=ty, hover_thrust_norm=hover)
        for _ in range(cfg.plant_substeps):
            s = px4_rate_tracking_step(s, c, body, rates, dt_sub)
        return s

    return torch.func.vmap(one)(states, controls,
                                *(cols[k].to(states.dtype) for k in _PLANT_FIELDS))


def _plant_substeps(state, control, body, rate_loop, cfg: FlightLoopConfig, plain=False):
    if cfg.use_pallas_plant:
        from ..ops.plant_pallas import _px4_plant_rows, px4_plant_step_plain
        from ..ops.tick_ad import px4_plant_rows_ad

        step = (px4_plant_step_plain if plain
                else px4_plant_rows_ad if cfg.fused_tick_ad else _px4_plant_rows)
        out = step(state.to(torch.float32)[None].contiguous(),
                   control.to(torch.float32)[None].contiguous(),
                   _plant_row(body, rate_loop, state.device),
                   cfg.control_dt, cfg.plant_substeps)
        return out[0].to(state.dtype)
    dt_sub = cfg.control_dt / cfg.plant_substeps
    for _ in range(cfg.plant_substeps):
        state = px4_rate_tracking_step(state, control, body, rate_loop, dt_sub)
    return state


def _times(num_steps: int, dt: float, dtype, device, first: int = 0):
    """The times of ticks ``first .. first + num_steps - 1``."""
    return torch.arange(first, first + num_steps, device=device).to(dtype) * dt


def _references(reference_fn, num_steps, cfg, dtype, device, first=0):
    pos, yaw = reference_fn(_times(num_steps, cfg.control_dt, dtype, device, first))
    return pos.to(dtype), yaw.to(dtype)


def _preview_references(reference_fn, num_steps, N, cfg, dtype, device, first=0):
    """``(T, N nx)`` per-stage state references of every tick: position at
    ``t + dt k`` for k = 1..N and the finite-difference velocity to the
    next sample (JAX ``closed_loop.py:362-369``)."""
    t = _times(num_steps, cfg.control_dt, dtype, device, first)
    ts = t[:, None] + cfg.control_dt * torch.arange(1, N + 2, dtype=dtype, device=device)
    pos, _ = reference_fn(ts.reshape(-1))
    pos = pos.to(dtype).reshape(num_steps, N + 1, 3)
    vel = (pos[:, 1:] - pos[:, :-1]) / cfg.control_dt
    return torch.cat([pos[:, :-1], vel], dim=2).reshape(num_steps, -1)


def _tick_references(reference_fn, num_steps, N, cfg, preview, dtype, device, first=0):
    """``(pos_refs (T, 3), yaw_refs (T,), refs (T, N nx))`` of ticks
    ``first ..``: the point targets, and the state references the fused
    tiers hand their kernels (the point target repeated over the horizon,
    or the preview)."""
    pos_refs, yaw_refs = _references(reference_fn, num_steps, cfg, dtype, device, first)
    if preview:
        refs = _preview_references(reference_fn, num_steps, N, cfg, dtype, device, first)
    else:
        zeros3 = torch.zeros(num_steps, 3, dtype=dtype, device=device)
        refs = torch.cat([pos_refs, zeros3], dim=1).repeat(1, N)
    return pos_refs, yaw_refs, refs.contiguous()


def _stack_outs(rows: list[dict]) -> dict:
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def pid_flight_rollout(
    reference_fn: Callable,
    num_steps: int,
    gains: CascadePidGains | None = None,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    cfg: FlightLoopConfig = FlightLoopConfig(),
    initial_state: torch.Tensor | None = None,
    dtype=torch.float32,
    device=None,
    plain_kernels: bool = False,
):
    """Closed-loop cascade-PID flight; with ``cfg.use_pallas_plant`` the
    plant substeps run as kernel K1 (``plain_kernels=True`` flies K1's
    plain version instead, on any device)."""
    dev = resolve_device(device)
    if gains is None:
        gains = CascadePidGains.default(dtype=dtype, device=dev)
    if initial_state is None:
        initial_state = torch.zeros(12, dtype=dtype, device=dev)
        initial_state[2] = cfg.takeoff_height
    state = initial_state.to(dtype=dtype, device=dev)
    pos_refs, yaw_refs = _references(reference_fn, num_steps, cfg, dtype, dev)
    pid_state = cascade_init(dtype, dev)
    rows = []
    for i in range(num_steps):
        control, pid_state, aux = cascade_pid_step(
            gains, pid_state, state, pos_refs[i], yaw_refs[i], cfg.control_dt
        )
        new_state = _plant_substeps(state, control, body, rate_loop, cfg, plain=plain_kernels)
        rows.append({
            "state": state,
            "pos_ref": pos_refs[i],
            "vel_ref": aux["velocity_setpoint"],
            "att_ref": aux["attitude_setpoint"],
            "thrust": control[0],
            "rates_cmd": control[1:4],
        })
        state = new_state
    outs = _stack_outs(rows)
    outs["final_state"] = state
    return outs


def mpc_flight_rollout(
    mpc: LinearMPC,
    reference_fn: Callable,
    num_steps: int,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    cfg: FlightLoopConfig = FlightLoopConfig(),
    initial_state: torch.Tensor | None = None,
    residual_fn: Callable | None = None,
    output_correction_fn: Callable | None = None,
    preview: bool = False,
    gp_posterior=None,
    gp_gain: float = 0.1,
    gp_dt: float = 0.02,
    online_gp: OnlineFusedGPConfig | None = None,
    initial_dataset=None,
    uncertainty_fn: Callable | None = None,
    resume=None,
    return_resume: bool = False,
    dtype=torch.float32,
    device=None,
    plain_kernels: bool = False,
):
    """Closed-loop linear-MPC flight (optionally GP-enhanced).

    ``residual_fn(X_guess, U_guess)`` produces the ``(N, 6)`` stage
    residuals from the MPC's warm-start trajectory (staged and single-tick
    tiers). ``gp_posterior=`` / ``online_gp=`` put the GP inside the
    multi-tick kernel. ``preview=True`` tracks per-stage references along
    the horizon. ``device`` defaults to ``cuda`` and must match the MPC's.
    ``plain_kernels=True`` flies the kernels' plain PyTorch versions
    instead (the reference a kernel flight is held against on the card).
    ``uncertainty_fn(X_prev, U_prev)`` (staged tier) gives the ``(N, 6)``
    stage-wise GP std that backs the state boxes off when the MPC's
    ``tightening_factor`` is > 0; on the multi-tick tier the kernel forms
    that std itself. ``output_correction_fn(state6, u_opt, pos_ref)``
    (staged tier) corrects the solved control after the solve.
    ``return_resume=True`` (multi-tick tier) also returns a
    ``FlightResumeState``, and ``resume=`` continues from one.
    Returns a dict of stacked per-tick tensors; the fused tiers return
    float32 whatever ``dtype`` is."""
    dev = resolve_device(device)
    if mpc.device != dev:
        raise ValueError(f"the MPC lives on {mpc.device}, the flight on {dev}")
    if initial_state is None:
        initial_state = torch.zeros(12, dtype=dtype, device=dev)
        initial_state[2] = cfg.takeoff_height
    initial_state = initial_state.to(device=dev)
    full_f32_matmul()

    if online_gp is not None and not cfg.use_fused_tick:
        raise ValueError(
            "online_gp= is the fused multi-tick online-learning path (use_fused_tick=True)"
        )
    if initial_dataset is not None and online_gp is None:
        raise ValueError("initial_dataset= only makes sense with online_gp=")
    resuming = resume is not None or return_resume
    if resuming and not cfg.use_fused_tick:
        raise ValueError("mid-flight checkpoint/resume runs on the fused multi-tick path "
                         "(use_fused_tick=True)")
    if cfg.use_fused_tick:
        if uncertainty_fn is not None:
            raise ValueError(
                "uncertainty_fn is a staged-path hook; on the fused paths the kernel "
                "computes the posterior variance itself"
            )
        if output_correction_fn is not None:
            raise ValueError(
                "output_correction_fn (the post-solve GP generation) is not supported on "
                "the fused-tick paths; use the staged rollout (use_fused_tick=False)"
            )
        if online_gp is not None:
            if gp_posterior is not None or residual_fn is not None:
                raise ValueError(
                    "online_gp= builds its posterior in flight from the ring "
                    "buffer; don't also pass gp_posterior/residual_fn"
                )
            return _multitick_rollout(
                mpc, reference_fn, num_steps, body, rate_loop, cfg, initial_state,
                None, gp_gain, online_gp.gp.dt, preview, online_gp=online_gp,
                initial_dataset=initial_dataset, resume=resume, return_resume=return_resume,
                plain_kernels=plain_kernels,
            )
        if cfg.ticks_per_dispatch > 1 or gp_posterior is not None:
            if residual_fn is not None and gp_posterior is None:
                raise ValueError(
                    "ticks_per_dispatch > 1 computes the GP inside the kernel: "
                    "pass the raw posterior via gp_posterior= instead of residual_fn"
                )
            return _multitick_rollout(
                mpc, reference_fn, num_steps, body, rate_loop, cfg, initial_state,
                gp_posterior, gp_gain, gp_dt, preview, resume=resume,
                return_resume=return_resume, plain_kernels=plain_kernels,
            )
        if mpc.config.tightening_factor > 0.0:
            raise ValueError(
                "uncertainty tightening on the fused single-tick path needs the staged "
                "rollout or the multi-tick kernel (the GP and its variance run in-kernel there)"
            )
        if resuming:
            raise ValueError("checkpoint/resume runs on the multi-tick path "
                             "(ticks_per_dispatch > 1, or pass gp_posterior=/online_gp=)")
        return _fused_tick_rollout(mpc, reference_fn, num_steps, body, rate_loop, cfg,
                                   initial_state, residual_fn, preview, plain_kernels)
    if gp_posterior is not None:
        raise ValueError(
            "gp_posterior is only consumed by the multi-tick kernel path "
            "(use_fused_tick=True); pass a residual_fn on the staged path"
        )
    return _staged_rollout(mpc, reference_fn, num_steps, body, rate_loop, cfg, initial_state,
                           residual_fn, uncertainty_fn, output_correction_fn, preview, dtype,
                           plain_kernels)


def batched_mpc_flight_sweep(
    mpc: LinearMPC,
    reference_fn: Callable,
    num_steps: int,
    initial_states: torch.Tensor,          # (B, 12)
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    cfg: FlightLoopConfig = FlightLoopConfig(),
    residual_fn: Callable | None = None,
    gp_every: int = 1,
    gp_posterior=None,
    gp_cfg: ResidualGPConfig | None = None,
    gp_fused_precision: str = "high",
    device=None,
    plain_kernels: bool = False,
):
    """Throughput mode: B GP-MPC flights advance in lockstep.

    Each tick is one launch of the structured batched controller K8
    (``ops.controller_pallas.gpmpc_controller_structured_batched``) and one
    launch of K2 for allocation, attitude PID and plant of all B flights
    (``ops.plant_pallas``). Requires ``mpc`` built with
    ``use_fused_controller=True``; any B works (no padding).

    ``residual_fn(X_guess, U_guess)`` (one flight's ``(N, 6)`` residuals,
    e.g. ``gp.build_horizon_residuals``) is mapped over the flights with
    ``torch.func.vmap``. ``gp_posterior`` instead sends the GP through the
    fused posterior-mean kernel K7 (``gp.residual_gp.
    build_horizon_residuals_batched_fused``, configured by ``gp_cfg``); the
    two are mutually exclusive. ``gp_fused_precision`` is accepted for the
    JAX signature: K7 computes in float32 for every tier. ``gp_every``: the
    GP runs on every ``gp_every``-th tick and its disturbances are held in
    between. A flight farther than ``cfg.fallback_error_m`` from its
    reference flies the hover fallback law that tick.

    ``device`` defaults to ``cuda`` and must match the MPC's.
    ``plain_kernels=True`` flies the plain versions of K8, K7 and K2 on any
    device (the reference a kernel sweep is held against on the card).

    Returns ``{"state": (T, B, 12), "pos_ref": (T, 3), "thrust": (T, B)}``;
    ``state`` is the state at the start of each tick."""
    from ..gp.residual_gp import build_horizon_residuals_batched_fused
    from ..models.double_integrator import CONTROL_DIM, STATE_DIM
    from ..ops.controller_pallas import (
        build_structured_batch_data,
        gpmpc_controller_structured_batched,
        gpmpc_controller_structured_batched_plain,
    )
    from ..ops.plant_pallas import _allocation_plant_rows, allocation_plant_tick_plain
    from ..ops.rbf_pallas import posterior_mean_operands

    dev = resolve_device(device)
    if mpc.device != dev:
        raise ValueError(f"the MPC lives on {mpc.device}, the sweep on {dev}")
    if not mpc.config.use_fused_controller:
        raise ValueError("batched_mpc_flight_sweep requires "
                         "LinearMPCConfig.use_fused_controller=True")
    if gp_posterior is not None and residual_fn is not None:
        raise ValueError("pass gp_posterior OR residual_fn, not both")
    if gp_every < 1:
        raise ValueError(f"gp_every must be >= 1, got {gp_every}")
    full_f32_matmul()

    f32 = dict(dtype=torch.float32, device=dev)
    states = initial_states.to(**f32).contiguous()
    B = states.shape[0]
    N, nu, nx = mpc.config.horizon, CONTROL_DIM, STATE_DIM
    Nnu, Nnx = N * nu, N * nx
    sdata = build_structured_batch_data(mpc._fc_data, N, nu, nx, mpc._u_lo, mpc._u_hi,
                                        mpc._x_lo, mpc._x_hi, device=dev)
    controller = (gpmpc_controller_structured_batched_plain if plain_kernels
                  else gpmpc_controller_structured_batched)
    alloc_plant = allocation_plant_tick_plain if plain_kernels else _allocation_plant_rows
    plant_row = _plant_row(body, rate_loop, dev)
    gp_ops = posterior_mean_operands(gp_posterior) if gp_posterior is not None else None
    gp_cfg = gp_cfg if gp_cfg is not None else ResidualGPConfig()

    accel_lo = torch.tensor(cfg.accel_lower, **f32)
    accel_hi = torch.tensor(cfg.accel_upper, **f32)
    pos_refs, yaw_refs = _references(reference_fn, num_steps, cfg, torch.float32, dev)
    refs_all = torch.cat([pos_refs, torch.zeros(num_steps, 3, **f32)], dim=1).repeat(1, N)

    ZU = torch.zeros(B, Nnu, **f32)
    YU = torch.zeros(B, Nnu, **f32)
    ZX = torch.zeros(B, Nnx, **f32)
    YX = torch.zeros(B, Nnx, **f32)
    X_prev = states[:, None, 0:6].repeat(1, N + 1, 1)
    U_prev = torch.zeros(B, N, nu, **f32)
    att_int = torch.zeros(B, 3, **f32)
    W = torch.zeros(1, Nnx, **f32)     # one zero row, broadcast to every flight
    ceiling = torch.full((B,), 1.2, **f32)

    state_rows, thrust_rows = [], []
    for i in range(num_steps):
        if (residual_fn is not None or gp_ops is not None) and i % gp_every == 0:
            # the tick index is known on the host: held ticks skip the GP
            if gp_ops is not None:
                residuals = build_horizon_residuals_batched_fused(
                    gp_ops, X_prev, U_prev, gp_cfg, precision=gp_fused_precision,
                    plain_kernels=plain_kernels,
                )
            else:
                residuals = torch.func.vmap(residual_fn)(X_prev, U_prev)
            W = (cfg.control_dt * residuals).to(torch.float32).reshape(B, Nnx).contiguous()

        ref = refs_all[i : i + 1]
        ZU, ZX, YU, YX, _, X_tail = controller(
            sdata, states[:, 0:6].contiguous(), W, ref, ZU, ZX, YU, YX,
            mpc.config.admm_rho, mpc.config.admm_iterations, mpc.config.admm_over_relax,
        )
        U_blk = ZU.reshape(B, N, nu)
        accel_des = torch.minimum(torch.maximum(U_blk[:, 0, 0:3], accel_lo), accel_hi)
        yawrate_des = torch.clamp(U_blk[:, 0, 3], -cfg.yawrate_limit, cfg.yawrate_limit)
        thrust_ceiling = ceiling
        if cfg.fallback_error_m > 0.0:
            # divergence guard per flight: fallback PD hover law with
            # recovery headroom
            e = pos_refs[i][None, :] - states[:, 0:3]
            diverged = torch.sum(e * e, dim=1) > cfg.fallback_error_m**2
            k = cfg.fallback_accel_scale
            a_fb = torch.minimum(torch.maximum(1.5 * e - 0.8 * states[:, 3:6], k * accel_lo),
                                 k * accel_hi)
            accel_des = torch.where(diverged[:, None], a_fb, accel_des)
            yawrate_des = torch.where(diverged, 0.0, yawrate_des)
            thrust_ceiling = torch.where(diverged, cfg.fallback_thrust_ceiling, ceiling)

        cmd = torch.cat([accel_des, yawrate_des[:, None], yaw_refs[i].expand(B, 1),
                         thrust_ceiling[:, None]], dim=1)
        new_states, ctrl, att_int = alloc_plant(states, cmd, att_int, plant_row,
                                                cfg.control_dt, cfg.plant_substeps)
        X_prev = torch.cat([states[:, None, 0:6], X_tail.reshape(B, N, nx)], dim=1)
        U_prev = U_blk
        state_rows.append(states)
        thrust_rows.append(ctrl[:, 0])
        states = new_states
    return {
        "state": torch.stack(state_rows),
        "pos_ref": pos_refs,
        "thrust": torch.stack(thrust_rows),
    }


def _stack_population(rows: list[dict], pos_refs, final_states) -> dict:
    outs = {k: torch.stack([r[k] for r in rows], dim=1) for k in rows[0]}
    outs["pos_ref"] = pos_refs
    outs["final_state"] = final_states
    return outs


def batched_pid_flight_rollout(
    reference_fn: Callable,
    num_steps: int,
    bodies: RigidBodyParams,
    rate_loops: RateLoopParams,
    initial_states: torch.Tensor,            # (B, 12)
    gains: CascadePidGains | None = None,
    cfg: FlightLoopConfig = FlightLoopConfig(),
    dtype=torch.float32,
    device=None,
    plain_kernels: bool = False,
):
    """B cascade-PID flights in lockstep, each on its own plant and start:
    per flight ``pid_flight_rollout``. With ``cfg.use_pallas_plant`` the
    plant substeps of all flights are one launch of K1 per tick, one plant
    row per flight (``plain_kernels=True`` flies K1's plain version); with
    ``cfg.fused_tick_ad`` too, K1 runs through its autodiff route (K13a
    backward), which takes one plant shared by every flight. The gains'
    ``kp``, ``ki`` and ``kd`` may carry a leading flight axis (``(B, 3)``:
    each flight its own gains, as the batched multi-start tuner flies).

    Returns ``(B, T, .)`` per-tick tensors (``state`` at the start of each
    tick, ``vel_ref``, ``att_ref``, ``thrust``, ``rates_cmd``), ``pos_ref
    (T, 3)`` and ``final_state (B, 12)``."""
    from ..ops.plant_pallas import _px4_plant_rows, px4_plant_step_plain
    from ..ops.tick_ad import px4_plant_rows_ad

    dev = resolve_device(device)
    if gains is None:
        gains = CascadePidGains.default(dtype=dtype, device=dev)
    states = initial_states.to(dtype=dtype, device=dev)
    B = states.shape[0]
    cols = _flight_columns(bodies, rate_loops, B, dev)
    block = None
    if cfg.use_pallas_plant:
        block = (_plant_row(bodies, rate_loops, dev) if cfg.fused_tick_ad
                 else plant_block(bodies, rate_loops, B, dev))
    plant_step = (px4_plant_step_plain if plain_kernels
                  else px4_plant_rows_ad if cfg.fused_tick_ad else _px4_plant_rows)
    f32 = lambda v: v.to(torch.float32).contiguous()
    pos_refs, yaw_refs = _references(reference_fn, num_steps, cfg, dtype, dev)
    per_flight = lambda leaf: leaf.expand(B, *leaf.shape).clone()
    pid_state = CascadeState(*(PIDState(*map(per_flight, layer))
                               for layer in cascade_init(dtype, dev)))
    # per-flight gains map over the flights, shared ones (and the floats) not
    gain_dims = gains._replace(
        **{layer: PIDGains(*(0 if v.ndim == 2 else None for v in getattr(gains, layer)))
           for layer in ("position", "velocity", "attitude")},
        hover_thrust=None, thrust_min=None, thrust_max=None, max_rate=None)
    step = torch.func.vmap(
        lambda g, carry, s, pos_ref, yaw_ref: cascade_pid_step(g, carry, s, pos_ref, yaw_ref,
                                                               cfg.control_dt),
        in_dims=(gain_dims, 0, 0, None, None))
    rows = []
    for i in range(num_steps):
        control, pid_state, aux = step(gains, pid_state, states, pos_refs[i], yaw_refs[i])
        if block is None:
            new_states = _population_plant(states, control, cols, cfg)
        else:
            new_states = plant_step(f32(states), f32(control), block, cfg.control_dt,
                                    cfg.plant_substeps).to(dtype)
        rows.append({
            "state": states,
            "vel_ref": aux["velocity_setpoint"],
            "att_ref": aux["attitude_setpoint"],
            "thrust": control[:, 0],
            "rates_cmd": control[:, 1:4],
        })
        states = new_states
    return _stack_population(rows, pos_refs, states)


def _batched_composite_solve(mpc: LinearMPC, Z, Y, x0, W, ref, plain_kernels: bool = False):
    """``LinearMPC.solve``'s staged composite ADMM for B flights in row
    form: the warm-start shift, offset, gradient, bounds and loop (one
    launch of K6 for all flights with ``use_fused_admm``, its plain version
    with ``plain_kernels``), then with ``polish`` each flight's active-set
    polish (``ops.qp.active_set_polish`` mapped over the flights). Returns
    ``(slack (B, m), dual (B, m), X_tail (B, N nx))``."""
    from ..ops.controller_pallas import _shift_plane

    cfg = mpc.config
    N = cfg.horizon
    Nnu = N * CONTROL_DIM
    rho, a = cfg.admm_rho, cfg.admm_over_relax
    shift = lambda v: torch.cat([_shift_plane(v[:, :Nnu], N, CONTROL_DIM),
                                 _shift_plane(v[:, Nnu:], N, STATE_DIM)], dim=1)
    z, y = shift(Z), shift(Y)
    offset = x0 @ mpc._Sx.T + W @ mpc._Sw.T
    f = (offset - ref) @ mpc._SuT_q.T
    B = x0.shape[0]
    lower = torch.cat([mpc._u_lo.expand(B, Nnu), mpc._x_lo - offset], dim=1)
    upper = torch.cat([mpc._u_hi.expand(B, Nnu), mpc._x_hi - offset], dim=1)
    p0 = -(f @ mpc._GMinv.T)
    minv_f = f @ mpc._M_inv.T
    if cfg.use_fused_admm:
        from ..ops.admm_pallas import (
            admm_box_qp_fused_composite,
            admm_box_qp_fused_composite_plain,
        )

        admm = (admm_box_qp_fused_composite_plain if plain_kernels
                else functools.partial(admm_box_qp_fused_composite, SuT=mpc._SuT_f32))
        f32 = lambda v: v.to(torch.float32).contiguous()
        U, z, y = (v.to(x0.dtype) for v in admm(
            mpc._P1_f32, f32(p0), mpc._GMinvT_f32, f32(minv_f), f32(lower), f32(upper), f32(z),
            f32(y), rho, cfg.admm_iterations, a))
        return z, y, offset + U @ mpc._Su.T
    P1T = mpc._P1.T
    for _ in range(cfg.admm_iterations):
        Gt = a * (p0 + (rho * z - y) @ P1T) + (1.0 - a) * z
        z_new = torch.minimum(torch.maximum(Gt + y / rho, lower), upper)
        y = y + rho * (Gt - z_new)
        z = z_new
    U = -minv_f + (rho * z - y) @ mpc._GMinv
    if cfg.polish:
        from ..ops.qp import AdmmState, active_set_polish

        polish = lambda f_, lo, hi, u, zz, yy: active_set_polish(
            mpc._H, mpc._G, f_, lo, hi, AdmmState(u, zz, yy), tol=cfg.polish_tol,
            passes=cfg.polish_passes)[:2]
        U, y = torch.func.vmap(polish)(f, lower, upper, U, z, y)
        # slack = G U: G = [I; Su], so its U-block is U
        z = U @ mpc._G.T
    return z, y, offset + U @ mpc._Su.T


def batched_mpc_flight_rollout(
    mpc: LinearMPC,
    reference_fn: Callable,
    num_steps: int,
    bodies: RigidBodyParams,
    rate_loops: RateLoopParams,
    initial_states: torch.Tensor,            # (B, 12)
    cfg: FlightLoopConfig = FlightLoopConfig(),
    residual_fn: Callable | None = None,
    preview: bool = False,
    dtype=torch.float32,
    device=None,
    plain_kernels: bool = False,
):
    """B linear-MPC flights in lockstep on the staged tier, each on its own
    plant and start: per flight ``mpc_flight_rollout`` with the same
    ``cfg``, ``residual_fn`` (mapped over the flights with
    ``torch.func.vmap``), ``preview`` and ``fallback_error_m``.

    An MPC built with ``use_fused_controller`` solves every tick in one
    launch of K16 (``ops.controller_pallas.gpmpc_controller_fused_batched``,
    the warm-start shift inside); the default MPC runs the composite ADMM
    as batched PyTorch ops. ``cfg.use_pallas_plant`` sends allocation,
    attitude PID and plant through one launch of K2 per tick with one plant
    row per flight. ``use_fused_admm`` runs the ADMM of every flight in one
    launch of K6 per tick, ``polish`` polishes each flight's iterate.

    The fused tiers (``cfg.use_fused_tick``, an MPC built with
    ``use_fused_controller``) fly each tick as one launch of K4 for all
    flights (``ticks_per_dispatch == 1``, ``residual_fn`` mapped over the
    flights between launches), or K ticks per launch of K5 for all flights
    (``ticks_per_dispatch = K > 1``, without a GP), one block per flight.
    ``plain_kernels=True`` flies the kernels' plain versions.

    Returns ``(B, T, .)`` per-tick tensors (``state`` at the start of each
    tick, ``vel_ref``, ``att_ref``, ``thrust``, ``rates_cmd``,
    ``accel_cmd``, ``u_mpc``), ``pos_ref (T, 3)`` and ``final_state
    (B, 12)``; the fused tiers return float32 whatever ``dtype`` is."""
    from ..ops.controller_pallas import (
        gpmpc_controller_fused_batched,
        gpmpc_controller_fused_batched_plain,
    )
    from ..ops.plant_pallas import _allocation_plant_rows, allocation_plant_tick_plain

    dev = resolve_device(device)
    if mpc.device != dev:
        raise ValueError(f"the MPC lives on {mpc.device}, the population on {dev}")
    mcfg = mpc.config
    full_f32_matmul()
    if cfg.use_fused_tick:
        return _batched_fused_tick_rollout(mpc, reference_fn, num_steps, bodies, rate_loops,
                                           initial_states.to(device=dev), cfg, residual_fn,
                                           preview, plain_kernels)
    states = initial_states.to(dtype=dtype, device=dev)
    B = states.shape[0]
    cols = _flight_columns(bodies, rate_loops, B, dev)
    block = plant_block(bodies, rate_loops, B, dev) if cfg.use_pallas_plant else None
    N, nu, nx = mcfg.horizon, CONTROL_DIM, STATE_DIM
    Nnu, Nnx, m = N * nu, N * nx, mpc.n_constraints
    kw = dict(dtype=dtype, device=dev)
    accel_lo = torch.tensor(cfg.accel_lower, **kw)
    accel_hi = torch.tensor(cfg.accel_upper, **kw)
    pos_refs, yaw_refs, refs = _tick_references(reference_fn, num_steps, N, cfg, preview, dtype,
                                                dev)
    f32 = lambda v: v.to(torch.float32).contiguous()
    fused = mcfg.use_fused_controller
    controller = (gpmpc_controller_fused_batched_plain if plain_kernels
                  else gpmpc_controller_fused_batched)
    alloc_plant = allocation_plant_tick_plain if plain_kernels else _allocation_plant_rows
    data = mpc._tick_data if fused else None

    slack = torch.zeros(B, m, **kw)
    dual = torch.zeros(B, m, **kw)
    X_prev = states[:, None, 0:6].repeat(1, N + 1, 1)
    U_prev = torch.zeros(B, N, nu, **kw)
    integral = torch.zeros(B, 3, **kw)
    ceiling = torch.full((B,), 1.2, **kw)
    W = torch.zeros(1, Nnx, **kw)     # one zero row, shared by every flight
    allocate = torch.func.vmap(
        lambda i, acc, yaw, yawrate, att, omega, top: geometric_control_allocation(
            AttitudeLoopState(integral=i), acc, yaw, yawrate, att, omega,
            dt_attitude=cfg.control_dt, thrust_ceiling=top),
        in_dims=(0, 0, None, 0, 0, 0, 0))

    rows = []
    for i in range(num_steps):
        x0 = states[:, 0:6]
        if residual_fn is not None:
            res = torch.func.vmap(residual_fn)(X_prev, U_prev)
            W = (mcfg.dt * res.to(dtype)).reshape(B, Nnx)
        ref = refs[i : i + 1]
        if fused:
            Z, Y, _, X_tail = controller(data, data.ShiftT, f32(x0), f32(W), f32(ref), f32(slack),
                                         f32(dual), mcfg.admm_rho, mcfg.admm_iterations,
                                         mcfg.admm_over_relax)
            slack, dual, X_tail = Z.to(dtype), Y.to(dtype), X_tail.to(dtype)
        else:
            slack, dual, X_tail = _batched_composite_solve(mpc, slack, dual, x0, W, ref,
                                                           plain_kernels)
        # controls come from the slack's U-block (LinearMPC.solve); the
        # predicted states feed only the next tick's residual_fn
        U_prev = slack[:, :Nnu].reshape(B, N, nu)
        if residual_fn is not None:
            X_prev = torch.cat([x0[:, None], X_tail.reshape(B, N, nx)], dim=1)
        u_opt = U_prev[:, 0]

        accel_des = torch.minimum(torch.maximum(u_opt[:, 0:3], accel_lo), accel_hi)
        yawrate_des = torch.clamp(u_opt[:, 3], -cfg.yawrate_limit, cfg.yawrate_limit)
        thrust_ceiling = ceiling
        if cfg.fallback_error_m > 0.0:
            # divergence guard per flight: fallback PD hover law with
            # recovery headroom
            e = pos_refs[i][None, :] - states[:, 0:3]
            diverged = torch.sum(e * e, dim=1) > cfg.fallback_error_m**2
            k = cfg.fallback_accel_scale
            a_fb = torch.minimum(torch.maximum(1.5 * e - 0.8 * states[:, 3:6], k * accel_lo),
                                 k * accel_hi)
            accel_des = torch.where(diverged[:, None], a_fb, accel_des)
            yawrate_des = torch.where(diverged, 0.0, yawrate_des)
            thrust_ceiling = torch.where(diverged, cfg.fallback_thrust_ceiling, ceiling)

        if block is not None:
            # allocation + attitude PID + all plant substeps in one launch
            cmd = torch.cat([accel_des, yawrate_des[:, None], yaw_refs[i].expand(B, 1),
                             thrust_ceiling[:, None]], dim=1)
            new_states, ctrl, new_int = alloc_plant(f32(states), f32(cmd), f32(integral), block,
                                                    cfg.control_dt, cfg.plant_substeps)
            new_states, integral = new_states.to(dtype), new_int.to(dtype)
            ctrl = ctrl.to(dtype)
            thrust, rate_cmd, att_sp = ctrl[:, 0], ctrl[:, 1:4], ctrl[:, 4:7]
        else:
            thrust, rate_cmd, att_sp, att = allocate(integral, accel_des, yaw_refs[i],
                                                     yawrate_des, states[:, 6:9],
                                                     states[:, 9:12], thrust_ceiling)
            integral = att.integral
            control = torch.cat([thrust[:, None], rate_cmd], dim=1)
            new_states = _population_plant(states, control, cols, cfg)
        rows.append({
            "state": states,
            "vel_ref": X_tail[:, 3:6],
            "att_ref": att_sp,
            "thrust": thrust,
            "rates_cmd": rate_cmd,
            "accel_cmd": accel_des,
            "u_mpc": u_opt,
        })
        states = new_states
    return _stack_population(rows, pos_refs, states)


def _staged_rollout(mpc, reference_fn, num_steps, body, rate_loop, cfg, initial_state,
                    residual_fn, uncertainty_fn, output_correction_fn, preview, dtype,
                    plain_kernels):
    from ..ops.plant_pallas import _allocation_plant_rows, allocation_plant_tick_plain
    from ..ops.tick_ad import allocation_plant_rows_ad

    dev = initial_state.device
    kw = dict(dtype=dtype, device=dev)
    accel_lo = torch.tensor(cfg.accel_lower, **kw)
    accel_hi = torch.tensor(cfg.accel_upper, **kw)
    pos_refs, yaw_refs = _references(reference_fn, num_steps, cfg, dtype, dev)
    N = mpc.config.horizon
    ref_states = (_preview_references(reference_fn, num_steps, N, cfg, dtype, dev)
                  .reshape(num_steps, N, 6) if preview else None)
    plant_row = _plant_row(body, rate_loop, dev) if cfg.use_pallas_plant else None
    alloc_plant = (allocation_plant_tick_plain if plain_kernels
                   else allocation_plant_rows_ad if cfg.fused_tick_ad else _allocation_plant_rows)

    state = initial_state.to(dtype)
    mpc_carry = mpc.init_carry(state[0:6])
    att_carry = attitude_loop_init(dtype, dev)
    rows = []
    for i in range(num_steps):
        pos_ref, yaw_ref = pos_refs[i], yaw_refs[i]
        residuals = (
            residual_fn(mpc_carry.X_prev, mpc_carry.U_prev) if residual_fn is not None else None
        )
        # the stage-wise GP std for the box back-off
        uncertainty = (
            uncertainty_fn(mpc_carry.X_prev, mpc_carry.U_prev)
            if uncertainty_fn is not None else None
        )
        u_opt, X_opt, mpc_carry = mpc.solve(
            mpc_carry, state[0:6], pos_ref, residuals,
            reference_states=ref_states[i] if preview else None, uncertainty=uncertainty,
            plain_kernels=plain_kernels,
        )
        if output_correction_fn is not None:
            u_opt = output_correction_fn(state[0:6], u_opt, pos_ref)

        accel_des = torch.minimum(torch.maximum(u_opt[0:3], accel_lo), accel_hi)
        yawrate_des = torch.clamp(u_opt[3], -cfg.yawrate_limit, cfg.yawrate_limit)
        thrust_ceiling = 1.2
        if cfg.fallback_error_m > 0.0:
            # divergence guard: fallback PD hover law with recovery headroom
            e = pos_ref - state[0:3]
            diverged = torch.sum(e * e) > cfg.fallback_error_m**2
            k = cfg.fallback_accel_scale
            a_fb = torch.minimum(torch.maximum(1.5 * e - 0.8 * state[3:6], k * accel_lo),
                                 k * accel_hi)
            accel_des = torch.where(diverged, a_fb, accel_des)
            yawrate_des = torch.where(diverged, 0.0, yawrate_des)
            thrust_ceiling = torch.where(diverged, cfg.fallback_thrust_ceiling,
                                         torch.tensor(1.2, **kw))

        if cfg.use_pallas_plant:
            # allocation + attitude PID + all plant substeps in one kernel
            f32 = dict(dtype=torch.float32, device=dev)
            cmd = torch.cat([
                accel_des.to(torch.float32), yawrate_des.reshape(1).to(torch.float32),
                yaw_ref.reshape(1).to(torch.float32),
                torch.as_tensor(thrust_ceiling, **f32).reshape(1),
            ])[None]
            new_state, ctrl, new_int = alloc_plant(
                state.to(torch.float32)[None].contiguous(), cmd,
                att_carry.integral.to(torch.float32)[None].contiguous(), plant_row,
                cfg.control_dt, cfg.plant_substeps,
            )
            new_state = new_state[0].to(dtype)
            att_carry = AttitudeLoopState(integral=new_int[0].to(dtype))
            control = ctrl[0, 0:4].to(dtype)
            att_sp = ctrl[0, 4:7].to(dtype)
            thrust, rate_cmd = control[0], control[1:4]
        else:
            thrust, rate_cmd, att_sp, att_carry = geometric_control_allocation(
                att_carry, accel_des, yaw_ref, yawrate_des, state[6:9], state[9:12],
                dt_attitude=cfg.control_dt, thrust_ceiling=thrust_ceiling,
            )
            control = torch.cat([thrust[None], rate_cmd])
            new_state = _plant_substeps(state, control, body, rate_loop, cfg)

        rows.append({
            "state": state,
            "pos_ref": pos_ref,
            "vel_ref": X_opt[1, 3:6],
            "att_ref": att_sp,
            "thrust": thrust,
            "rates_cmd": rate_cmd,
            "accel_cmd": accel_des,
            "u_mpc": u_opt,
        })
        state = new_state
    outs = _stack_outs(rows)
    outs["final_state"] = state
    return outs


class _OnlineGP:
    """In-flight learning on the multi-tick tiers: the ring buffer, the
    masked refit every ``refit_every`` ticks and the gain that stays 0
    until ``min_samples`` transitions are in. ``rows`` are the kernel's
    current GP operands (with the variance operands when
    ``with_variance``). ``resumed = (dataset, rows)`` continues a flight
    from a ``FlightResumeState`` instead of fitting afresh."""

    def __init__(self, online_gp: OnlineFusedGPConfig, initial_dataset, gp_gain: float,
                 control_dt: float, device, with_variance: bool = False, resumed=None):
        from ..gp.residual_gp import empty_dataset

        self.cfg, self.gain, self.control_dt = online_gp, gp_gain, control_dt
        self.with_variance = with_variance
        self.counts = []
        if resumed is not None:
            self.dataset, self.rows = resumed
            return
        self.dataset = (
            initial_dataset if initial_dataset is not None
            else empty_dataset(online_gp.gp.max_data_points, torch.float32, device)
        )
        gain0 = gp_gain if int(self.dataset.count) >= online_gp.min_samples else 0.0
        self.rows = self._fit(gain0)

    def _fit(self, gain):
        from ..gp.residual_gp import fit_residual_gp_masked, masked_input_stats, standardized_params
        from ..ops.tick_pallas import build_gp_rows

        ds, gcfg = self.dataset, self.cfg.gp
        if self.cfg.standardize_inputs:
            shift, std = masked_input_stats(ds)
            post = fit_residual_gp_masked(
                ds, gcfg, params=standardized_params(ds, gcfg, std=std), x_shift=shift)
        else:
            post = fit_residual_gp_masked(ds, gcfg)
        return build_gp_rows(post, gain, control_dt=self.control_dt, gp_dt=gcfg.dt,
                             with_variance=self.with_variance)

    def capture(self, states, controls, states_next, launch: int, K: int) -> None:
        """Insert one launch's transitions, record the count for its K
        ticks, and refit where the retrain timer is due: the host-known
        tick arithmetic is tested first, the count is read only then."""
        from ..gp.residual_gp import add_training_samples_batch

        self.dataset = add_training_samples_batch(self.dataset, states, controls, states_next,
                                                  self.cfg.gp)
        self.counts.append(self.dataset.count.expand(K))
        if ((launch + 1) * K) % self.cfg.refit_every < K and (
            int(self.dataset.count) >= self.cfg.min_samples
        ):
            self.rows = self._fit(self.gain)


def _applied_controls(packed, refs, ctrl_pos, cfg: FlightLoopConfig):
    """The command the allocation consumed on each tick of a launch: the
    clipped MPC acceleration and yaw rate, the yaw rate 0 on ticks where the
    controller's position ``ctrl_pos`` (K, 3) tripped the hover fallback."""
    yr = torch.clamp(packed[:, 28], -cfg.yawrate_limit, cfg.yawrate_limit)
    if cfg.fallback_error_m > 0.0:
        err2 = torch.sum((refs[:, 0:3] - ctrl_pos) ** 2, dim=1)
        yr = torch.where(err2 > cfg.fallback_error_m**2, 0.0, yr)
    return torch.cat([packed[:, 22:25], yr[:, None]], dim=1)


def _multitick_rollout(
    mpc, reference_fn, num_steps, body, rate_loop, cfg, initial_state,
    posterior, gp_gain, gp_dt, preview,
    online_gp: OnlineFusedGPConfig | None = None,
    initial_dataset=None,
    resume: FlightResumeState | None = None,
    return_resume: bool = False,
    plain_kernels: bool = False,
):
    """K ticks per launch of kernel K5, GP posterior inside the kernel; with
    the MPC's ``tightening_factor`` > 0 the GP rows carry the variance
    operands and every tick backs the state boxes off in the kernel.

    The host loop never waits on the card except where a refit is due
    (once per ``refit_every`` ticks it reads the ring buffer's count to
    decide whether enough samples were captured)."""
    from ..models.double_integrator import CONTROL_DIM, STATE_DIM
    from ..ops.tick_ad import gpmpc_multitick_ad
    from ..ops.tick_pallas import build_gp_rows, gpmpc_multitick_fused, multitick_staged

    if not mpc.config.use_fused_controller:
        raise ValueError("use_fused_tick requires LinearMPCConfig.use_fused_controller=True")
    K = cfg.ticks_per_dispatch
    if num_steps % K != 0:
        raise ValueError(f"num_steps={num_steps} not divisible by ticks_per_dispatch={K}")
    N = mpc.config.horizon
    dev = initial_state.device
    f32 = torch.float32
    data = mpc._tick_data
    online = online_gp is not None
    if online and online_gp.refit_every < K:
        raise ValueError(
            f"online_gp.refit_every={online_gp.refit_every} must be >= "
            f"ticks_per_dispatch={K} (refits happen at launch boundaries)"
        )
    plant_row = _plant_row(body, rate_loop, dev)
    tick = (multitick_staged if plain_kernels
            else gpmpc_multitick_ad if cfg.fused_tick_ad else gpmpc_multitick_fused)
    kappa = float(mpc.config.tightening_factor)
    with_variance = kappa > 0.0
    # (horizon, K, GP capacity, variance, scaled inputs), as the JAX package
    # fingerprints its resume states
    meta = (N, K, int(online_gp.gp.max_data_points) if online else 0, with_variance,
            bool(online_gp.standardize_inputs) if online else False)

    if resume is not None:
        if resume.meta and tuple(resume.meta) != meta:
            raise ValueError(
                f"resume checkpoint config mismatch: saved {tuple(resume.meta)}, current "
                f"(horizon, K, gp_capacity, variance, scaled) = {meta}")
        if resume.tick % K != 0:
            raise ValueError(f"resume tick {resume.tick} is not a dispatch boundary "
                             f"(ticks_per_dispatch={K})")
        state, aux, xtail, z, y, dataset, gp = resume.carry
        start = resume.tick // K
    else:
        x0 = initial_state.to(f32)
        state = x0.clone()
        aux = torch.cat([x0[0:6], torch.zeros(3, dtype=f32, device=dev)])  # prev x0; integral 0
        xtail = x0[0:6].repeat(N).contiguous()
        z = torch.zeros(mpc.n_constraints, dtype=f32, device=dev)
        y = torch.zeros(mpc.n_constraints, dtype=f32, device=dev)
        dataset = None
        gp = (
            build_gp_rows(posterior, gp_gain, control_dt=cfg.control_dt, gp_dt=gp_dt,
                          with_variance=with_variance)
            if posterior is not None else None
        )
        start = 0
    if online:
        learner = _OnlineGP(online_gp, initial_dataset, gp_gain, cfg.control_dt, dev,
                            with_variance=with_variance,
                            resumed=(dataset, gp) if resume is not None else None)
    statics = dict(
        k_ticks=K, use_gp=online or posterior is not None,
        rho=mpc.config.admm_rho,
        iterations=mpc.config.admm_iterations,
        over_relax=mpc.config.admm_over_relax,
        dt=cfg.control_dt, substeps=cfg.plant_substeps,
        accel_lo=tuple(cfg.accel_lower), accel_hi=tuple(cfg.accel_upper),
        yawrate_limit=cfg.yawrate_limit,
        fallback_error_m=cfg.fallback_error_m,
        fallback_thrust_ceiling=cfg.fallback_thrust_ceiling,
        fallback_accel_scale=cfg.fallback_accel_scale,
        loop_precision=cfg.fused_tick_loop_precision,
        n=N, nu=CONTROL_DIM, nx=STATE_DIM, tighten_kappa=kappa,
    )

    pos_refs, yaw_refs, refs_all = _tick_references(reference_fn, num_steps, N, cfg, preview,
                                                    f32, dev, first=start * K)

    packed_chunks = []
    for i in range(num_steps // K):
        sl = slice(i * K, (i + 1) * K)
        refs = refs_all[sl]
        packed, state, aux, xtail, z, y = tick(
            data, learner.rows if online else gp, state, aux, xtail, z, y, refs,
            yaw_refs[sl].contiguous(), plant_row, **statics,
        )
        packed_chunks.append(packed)
        if online:
            # transitions: state at tick k (pre-plant) -> state at tick k+1
            # (the next packed row; the last tick's is the carried state)
            states_next = torch.cat([packed[1:, 0:12], state[None]], dim=0)
            learner.capture(packed[:, 0:12], _applied_controls(packed, refs, packed[:, 0:3], cfg),
                            states_next, start + i, K)

    packed = torch.cat(packed_chunks, dim=0)
    outs = {
        "state": packed[:, 0:12],
        "pos_ref": pos_refs,
        "vel_ref": packed[:, 29:32],
        "att_ref": packed[:, 16:19],
        "thrust": packed[:, 12],
        "rates_cmd": packed[:, 13:16],
        "accel_cmd": packed[:, 22:25],
        "u_mpc": packed[:, 25:29],
    }
    if online:
        outs["gp_count"] = torch.cat(learner.counts)
    outs["final_state"] = state
    if return_resume:
        carry = (state, aux, xtail, z, y, *((learner.dataset, learner.rows) if online
                                            else (None, gp)))
        return outs, FlightResumeState(carry=carry, tick=(start * K + num_steps), meta=meta)
    return outs


def _fused_tick_rollout(mpc, reference_fn, num_steps, body, rate_loop, cfg, initial_state,
                        residual_fn, preview, plain_kernels):
    """One launch of kernel K4 per tick (JAX ``closed_loop.py:455-566``):
    the warm-start shift, the controller, the clips and fallback,
    allocation and the plant run in the kernel; the ``residual_fn`` GP runs
    as PyTorch ops on the same device between launches. Flies float32."""
    from ..models.double_integrator import CONTROL_DIM, STATE_DIM
    from ..ops.tick_pallas import gpmpc_tick_fused, gpmpc_tick_fused_plain

    if not mpc.config.use_fused_controller:
        raise ValueError("use_fused_tick requires LinearMPCConfig.use_fused_controller=True")
    N = mpc.config.horizon
    dev = initial_state.device
    f32 = torch.float32
    tick = gpmpc_tick_fused_plain if plain_kernels else gpmpc_tick_fused
    statics = dict(
        rho=mpc.config.admm_rho,
        iterations=mpc.config.admm_iterations,
        over_relax=mpc.config.admm_over_relax,
        dt=cfg.control_dt, substeps=cfg.plant_substeps,
        accel_lo=tuple(cfg.accel_lower), accel_hi=tuple(cfg.accel_upper),
        yawrate_limit=cfg.yawrate_limit,
        fallback_error_m=cfg.fallback_error_m,
        fallback_thrust_ceiling=cfg.fallback_thrust_ceiling,
        fallback_accel_scale=cfg.fallback_accel_scale,
        loop_precision=cfg.fused_tick_loop_precision,
        n=N, nu=CONTROL_DIM, nx=STATE_DIM,
    )
    data = mpc._tick_data
    plant_row = _plant_row(body, rate_loop, dev)
    pos_refs, yaw_refs, refs = _tick_references(reference_fn, num_steps, N, cfg, preview, f32,
                                                dev)
    w = torch.zeros(N * STATE_DIM, dtype=f32, device=dev)

    state = initial_state.to(f32)
    init = mpc.init_carry(state[0:6])
    slack, dual = init.slack.to(f32), init.dual.to(f32)
    X_prev, U_prev = init.X_prev.to(f32), init.U_prev.to(f32)
    integral = torch.zeros(3, dtype=f32, device=dev)
    rows = []
    for i in range(num_steps):
        if residual_fn is not None:
            w = (cfg.control_dt * residual_fn(X_prev, U_prev).to(f32)).reshape(-1)
        misc = torch.cat([yaw_refs[i : i + 1], integral])
        packed, slack, dual, _, X_tail = tick(data, state, w, refs[i], misc, slack, dual,
                                              plant_row, **statics)
        U_prev = slack[: N * CONTROL_DIM].reshape(N, CONTROL_DIM)
        X_prev = torch.cat([state[None, 0:6], X_tail.reshape(N, STATE_DIM)], dim=0)
        rows.append({
            "state": state,
            "pos_ref": pos_refs[i],
            "vel_ref": X_prev[1, 3:6],
            "att_ref": packed[16:19],
            "thrust": packed[12],
            "rates_cmd": packed[13:16],
            "accel_cmd": packed[22:25],
            "u_mpc": U_prev[0],
        })
        state = packed[0:12]
        integral = packed[19:22]
    outs = _stack_outs(rows)
    outs["final_state"] = state
    return outs


def _batched_fused_tick_rollout(mpc, reference_fn, num_steps, bodies, rate_loops,
                                initial_states, cfg, residual_fn, preview, plain_kernels):
    """The fused tiers of ``batched_mpc_flight_rollout``: K4 for all
    flights per tick (``ticks_per_dispatch == 1``) or K5 for all flights per
    K ticks, one block per flight, each flight on its own plant row
    (``plant_block``). Flies float32."""
    from ..ops.tick_pallas import (
        gpmpc_multitick_fused,
        gpmpc_tick_fused,
        gpmpc_tick_fused_plain,
        multitick_staged,
    )

    mcfg = mpc.config
    if not mcfg.use_fused_controller:
        raise ValueError("use_fused_tick requires LinearMPCConfig.use_fused_controller=True")
    K = cfg.ticks_per_dispatch
    if K > 1 and residual_fn is not None:
        raise ValueError(
            "ticks_per_dispatch > 1 computes the GP inside the kernel: "
            "pass the raw posterior via gp_posterior= instead of residual_fn"
        )
    if K == 1 and mcfg.tightening_factor > 0.0:
        raise ValueError(
            "uncertainty tightening on the fused single-tick path needs the staged "
            "rollout or the multi-tick kernel (the GP and its variance run in-kernel there)"
        )
    if num_steps % K != 0:
        raise ValueError(f"num_steps={num_steps} not divisible by ticks_per_dispatch={K}")
    dev = initial_states.device
    f32 = torch.float32
    N, nu, nx = mcfg.horizon, CONTROL_DIM, STATE_DIM
    B, m = initial_states.shape[0], mpc.n_constraints
    statics = dict(
        rho=mcfg.admm_rho, iterations=mcfg.admm_iterations, over_relax=mcfg.admm_over_relax,
        dt=cfg.control_dt, substeps=cfg.plant_substeps,
        accel_lo=tuple(cfg.accel_lower), accel_hi=tuple(cfg.accel_upper),
        yawrate_limit=cfg.yawrate_limit, fallback_error_m=cfg.fallback_error_m,
        fallback_thrust_ceiling=cfg.fallback_thrust_ceiling,
        fallback_accel_scale=cfg.fallback_accel_scale,
        loop_precision=cfg.fused_tick_loop_precision, n=N, nu=nu, nx=nx,
    )
    data = mpc._tick_data
    block = plant_block(bodies, rate_loops, B, dev)
    pos_refs, yaw_refs, refs = _tick_references(reference_fn, num_steps, N, cfg, preview, f32,
                                                dev)
    states = initial_states.to(f32).contiguous()
    zeros = lambda *shape: torch.zeros(B, *shape, dtype=f32, device=dev)
    slack, dual = zeros(m), zeros(m)

    if K > 1:
        tick = multitick_staged if plain_kernels else gpmpc_multitick_fused
        aux = torch.cat([states[:, 0:nx], zeros(3)], dim=1)   # prev x0; integral 0
        xtail = states[:, 0:nx].repeat(1, N).contiguous()
        chunks = []
        for i in range(num_steps // K):
            sl = slice(i * K, (i + 1) * K)
            packed, states, aux, xtail, slack, dual = tick(
                data, None, states, aux, xtail, slack, dual, refs[sl], yaw_refs[sl].contiguous(),
                block, k_ticks=K, use_gp=False, tighten_kappa=0.0, **statics)
            chunks.append(packed)
        packed = torch.cat(chunks, dim=1)
        return {
            "state": packed[..., 0:12], "vel_ref": packed[..., 29:32],
            "att_ref": packed[..., 16:19], "thrust": packed[..., 12],
            "rates_cmd": packed[..., 13:16], "accel_cmd": packed[..., 22:25],
            "u_mpc": packed[..., 25:29], "pos_ref": pos_refs, "final_state": states,
        }

    tick = gpmpc_tick_fused_plain if plain_kernels else gpmpc_tick_fused
    W = zeros(N * nx)
    X_prev = states[:, None, 0:nx].repeat(1, N + 1, 1)
    U_prev = zeros(N, nu)
    integral = zeros(3)
    rows = []
    for i in range(num_steps):
        if residual_fn is not None:
            res = torch.func.vmap(residual_fn)(X_prev, U_prev)
            W = (cfg.control_dt * res.to(f32)).reshape(B, N * nx).contiguous()
        misc = torch.cat([yaw_refs[i].expand(B, 1), integral], dim=1)
        packed, slack, dual, _, X_tail = tick(data, states, W, refs[i], misc, slack, dual,
                                              block, **statics)
        U_prev = slack[:, : N * nu].reshape(B, N, nu)
        X_prev = torch.cat([states[:, None, 0:nx], X_tail.reshape(B, N, nx)], dim=1)
        rows.append({
            "state": states,
            "vel_ref": X_tail[:, 3:6],
            "att_ref": packed[:, 16:19],
            "thrust": packed[:, 12],
            "rates_cmd": packed[:, 13:16],
            "accel_cmd": packed[:, 22:25],
            "u_mpc": U_prev[:, 0],
        })
        states = packed[:, 0:12].contiguous()
        integral = packed[:, 19:22].contiguous()
    return _stack_population(rows, pos_refs, states)
