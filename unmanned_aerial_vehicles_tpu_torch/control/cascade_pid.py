"""The PX4 flight node's 9-loop cascade PID (port of
``control/cascade_pid.py``: ``cascade_pid_step``): position PIDs ->
velocity setpoints -> velocity PIDs -> attitude/thrust -> attitude PIDs ->
body-rate commands, as three vectorised PID triples."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .pid import PIDGains, PIDState, pid_init, pid_step


def _triple(kp, ki, kd, max_output, max_integral, dtype, device) -> PIDGains:
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return PIDGains(kp=t(kp), ki=t(ki), kd=t(kd), max_output=t(max_output),
                    max_integral=t(max_integral))


class CascadePidGains(NamedTuple):
    """Per-layer vectorised gains (the flight node's defaults)."""

    position: PIDGains
    velocity: PIDGains
    attitude: PIDGains
    hover_thrust: float = 0.7
    thrust_min: float = 0.1
    thrust_max: float = 1.15
    max_rate: float = 0.7

    @classmethod
    def default(cls, dtype=torch.float32, device=None) -> "CascadePidGains":
        kw = dict(dtype=dtype, device=device)
        return cls(
            position=_triple(
                kp=[0.3, 0.3, 0.8], ki=[0.01, 0.01, 0.04], kd=[0.05, 0.05, 0.12],
                max_output=[1.0, 1.0, 2.0], max_integral=[0.3, 0.3, 0.8], **kw,
            ),
            velocity=_triple(
                kp=[0.35, 0.35, 0.3], ki=[0.01, 0.01, 0.01], kd=[0.03, 0.03, 0.02],
                max_output=[0.36, 0.36, 0.8], max_integral=[0.3, 0.3, 1.0], **kw,
            ),
            attitude=_triple(
                kp=[0.5, 0.5, 0.3], ki=[0.02, 0.02, 0.01], kd=[0.05, 0.05, 0.02],
                max_output=[0.5, 0.5, 0.3], max_integral=[0.1, 0.1, 0.05], **kw,
            ),
        )


class CascadeState(NamedTuple):
    position: PIDState
    velocity: PIDState
    attitude: PIDState


def cascade_init(dtype=torch.float32, device=None) -> CascadeState:
    return CascadeState(
        position=pid_init((3,), dtype, device),
        velocity=pid_init((3,), dtype, device),
        attitude=pid_init((3,), dtype, device),
    )


def cascade_pid_step(gains: CascadePidGains, carry: CascadeState, state12: torch.Tensor,
                     position_setpoint: torch.Tensor, yaw_setpoint: torch.Tensor, dt: float):
    """One 50 Hz cascade tick. Returns ``(control4, new_carry, aux)`` with
    control ``[thrust_normalized, p_cmd, q_cmd, r_cmd]``."""
    pos, vel, att = state12[0:3], state12[3:6], state12[6:9]

    vel_sp, pos_pid = pid_step(gains.position, carry.position, position_setpoint, pos, dt)

    vel_out, vel_pid = pid_step(gains.velocity, carry.velocity, vel_sp, vel, dt)
    pitch_cmd = -vel_out[0]   # forward velocity -> pitch down
    roll_cmd = vel_out[1]     # rightward velocity -> roll right
    thrust_norm = torch.clamp(gains.hover_thrust + vel_out[2], gains.thrust_min, gains.thrust_max)

    att_sp = torch.stack([roll_cmd, pitch_cmd, yaw_setpoint])

    rate_cmd, att_pid = pid_step(gains.attitude, carry.attitude, att_sp, att, dt)
    rate_cmd = torch.clamp(rate_cmd, -gains.max_rate, gains.max_rate)

    control = torch.cat([thrust_norm[None], rate_cmd])
    new_carry = CascadeState(position=pos_pid, velocity=vel_pid, attitude=att_pid)
    aux = {"velocity_setpoint": vel_sp, "attitude_setpoint": att_sp}
    return control, new_carry, aux
