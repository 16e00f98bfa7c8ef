"""The whole mission: the flight node's phase machine (port of
``loop/mission.py``).

Prepare (t < 2 s), arm (t < 4 s), take off (t < 8 s), hover (t < 20 s),
then the trajectory phase. The phases differ in which controller drives
the vehicle:

* prepare and arm hold the ground point, take off and hover climb to the
  take-off point, all with the node's fallback PD law (``a = 1.5 e_pos -
  0.8 v``, clipped);
* the trajectory phase flies the MPC through the geometric allocation.

The MPC is solved on every tick, the PD phases included, and its command
is used only in the trajectory phase, as in the JAX package (which selects
with ``where``): the warm start evolves from tick 0. The loop runs on the
host, one Python step a tick; the phase of every tick is known there
before the flight, so selecting a command reads nothing from the device.
An MPC built with ``use_fused_controller`` solves each tick in one launch
of K3, and ``FlightLoopConfig(use_pallas_plant=True)`` steps the plant in
one launch of K1; ``plain_kernels=True`` flies their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .._device import full_f32_matmul, resolve_device
from ..control.allocation import attitude_loop_init, geometric_control_allocation
from ..control.mpc_linear import LinearMPC
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams
from .closed_loop import FlightLoopConfig, _plant_substeps, _stack_outs

# phase boundaries in seconds
PREPARE_END = 2.0
ARM_END = 4.0
TAKEOFF_END = 8.0
HOVER_END = 20.0


def _tick_times(num_steps: int, dt: float, dtype) -> np.ndarray:
    """Each tick's time as the JAX package forms it, ``i`` cast to the
    flight's dtype times ``dt`` in that dtype: in float32, 20.0 s falls on
    tick 1000 only when the product is rounded as float32."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return np.arange(num_steps).astype(np_dtype) * np_dtype(dt)


def mission_rollout(
    mpc: LinearMPC,
    reference_fn: Callable,
    duration: float = 60.0,
    cfg: FlightLoopConfig = FlightLoopConfig(),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    residual_fn: Callable | None = None,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    ekf_cfg=None,
    disturbance_observer=None,
    wind_fn: Callable | None = None,
    dtype=torch.float32,
    device=None,
    plain_kernels: bool = False,
):
    """Ground -> arm -> take-off -> hover -> trajectory, from the origin on
    the ground.

    ``reference_fn(flight_time (T,)) -> (pos (T, 3), yaw (T,))`` is the
    trajectory phase's reference, fed the time since that phase began
    (``t - 20``, 0 before it); it is evaluated once for the whole flight.

    ``generator`` (a ``torch.Generator``) or ``noise`` (``(T, 9)`` standard
    normals, e.g. another package's draws) makes the mission noisy: every
    phase flies the estimate of the 12-state EKF, or with
    ``disturbance_observer=`` (``True`` or a ``DisturbanceEKFConfig``) of
    the 15-state observer, whose acceleration estimate reaches the MPC as
    residual rows; the true plant integrates ``body``, its wind varied by
    ``wind_fn`` (``wind_fn(t) -> (3,)`` per tick, or ``wind_fn(t (T,)) ->
    (T, 3)``). Adds ``state_est`` (and ``disturbance_est``) to the outputs.

    Returns per-tick ``state``, ``target``, ``phase`` (0..4), ``thrust``,
    ``in_trajectory`` and ``final_state``."""
    from ..estimation.noisy_loop import _noise_draws, flight_winds

    noisy = generator is not None or noise is not None
    if (disturbance_observer or wind_fn is not None) and not noisy:
        raise ValueError(
            "disturbance_observer=/wind_fn= require the noisy mission "
            "(pass generator= or noise=): the observer fuses drawn sensor samples"
        )
    dev = resolve_device(device)
    if mpc.device != dev:
        raise ValueError(f"the MPC lives on {mpc.device}, the mission on {dev}")
    full_f32_matmul()
    dob_cfg = None
    if noisy:
        from ..estimation import (
            DisturbanceEKFConfig,
            EKFConfig,
            dekf_init,
            dekf_step,
            disturbance_residual_rows,
            ekf_init,
            ekf_step,
            measure,
        )

        if ekf_cfg is None:
            ekf_cfg = EKFConfig()
        if disturbance_observer is not None and disturbance_observer is not False:
            dob_cfg = (DisturbanceEKFConfig(base=ekf_cfg) if disturbance_observer is True
                       else disturbance_observer)
            nominal_body = dataclasses.replace(body, wind=(0.0, 0.0, 0.0))
        meas_cfg = dob_cfg.base if dob_cfg is not None else ekf_cfg

    num_steps = int(duration / cfg.control_dt)
    kw = dict(dtype=dtype, device=dev)
    t_host = _tick_times(num_steps, cfg.control_dt, dtype)
    in_traj = t_host >= HOVER_END
    phases = sum((t_host >= b).astype(np.int32)
                 for b in (PREPARE_END, ARM_END, TAKEOFF_END, HOVER_END)).astype(np.int32)
    times = torch.from_numpy(t_host).to(dev)
    pos_refs, yaw_refs = reference_fn(torch.clamp(times - HOVER_END, min=0.0))
    pos_refs, yaw_refs = pos_refs.to(dtype), yaw_refs.to(dtype)
    # the true wind of every tick, read to the host once
    winds = (flight_winds(wind_fn, times).to(dtype).tolist() if wind_fn is not None else None)
    if noisy:
        noise = _noise_draws(noise, generator, (num_steps, 9), dtype, dev)

    accel_lo = torch.tensor(cfg.accel_lower, **kw)
    accel_hi = torch.tensor(cfg.accel_upper, **kw)
    pd_lo = torch.tensor([-3.0, -3.0, -4.0], **kw)
    pd_hi = torch.tensor([3.0, 3.0, 5.0], **kw)
    ground = torch.zeros(3, **kw)
    takeoff_target = torch.tensor([0.0, 0.0, cfg.takeoff_height], **kw)
    zero = torch.zeros((), **kw)

    state = torch.zeros(12, **kw)    # on the ground
    mpc_carry = mpc.init_carry(state[0:6])
    att_carry = attitude_loop_init(dtype, dev)
    if noisy:
        ekf = (dekf_init(state, dob_cfg, dtype) if dob_cfg is not None
               else ekf_init(state, ekf_cfg, dtype))
        prev_control = torch.zeros(4, **kw)   # grounded: no thrust
    rows = []
    for i in range(num_steps):
        trajectory = bool(in_traj[i])
        target = pos_refs[i] if trajectory else (
            ground if t_host[i] < PREPARE_END else takeoff_target)
        yaw_t = yaw_refs[i] if trajectory else zero
        body_t = body if winds is None else dataclasses.replace(body, wind=tuple(winds[i]))

        if noisy:
            z = measure(state, noise[i], meas_cfg)
            if dob_cfg is not None:
                ekf, x_ctl, d_est = dekf_step(ekf, prev_control, z, nominal_body, rate_loop,
                                              cfg.control_dt, dob_cfg)
            else:
                ekf, x_ctl = ekf_step(ekf, prev_control, z, body_t, rate_loop, cfg.control_dt,
                                      ekf_cfg)
        else:
            x_ctl = state

        residuals = (residual_fn(mpc_carry.X_prev, mpc_carry.U_prev)
                     if residual_fn is not None else None)
        if dob_cfg is not None:
            dob_rows = disturbance_residual_rows(d_est, mpc.config.horizon, dtype)
            residuals = dob_rows if residuals is None else residuals + dob_rows
        # solved on every tick: the warm start evolves through the PD phases
        u_opt, _, mpc_carry = mpc.solve(mpc_carry, x_ctl[0:6], target, residuals,
                                        plain_kernels=plain_kernels)
        if trajectory:
            accel_des = torch.minimum(torch.maximum(u_opt[0:3], accel_lo), accel_hi)
            yawrate_des = torch.clamp(u_opt[3], -cfg.yawrate_limit, cfg.yawrate_limit)
        else:
            pd = 1.5 * (target - x_ctl[0:3]) - 0.8 * x_ctl[3:6]
            accel_des = torch.minimum(torch.maximum(pd, pd_lo), pd_hi)
            yawrate_des = zero

        thrust, rate_cmd, _, att_carry = geometric_control_allocation(
            att_carry, accel_des, yaw_t, yawrate_des, x_ctl[6:9], x_ctl[9:12],
            dt_attitude=cfg.control_dt,
        )
        control = torch.cat([thrust[None], rate_cmd])
        new_state = _plant_substeps(state, control, body_t, rate_loop, cfg, plain=plain_kernels)
        row = {"state": state, "target": target, "thrust": thrust}
        if noisy:
            row["state_est"] = x_ctl
            if dob_cfg is not None:
                row["disturbance_est"] = d_est
            prev_control = control
        rows.append(row)
        state = new_state
    outs = _stack_outs(rows)
    outs["phase"] = torch.from_numpy(phases).to(dev)
    outs["in_trajectory"] = torch.from_numpy(in_traj).to(dev)
    outs["final_state"] = state
    return outs
