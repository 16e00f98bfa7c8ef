"""The PX4 flight node's 9-loop cascade PID (port of
``control/cascade_pid.py``: ``cascade_pid_step``): position PIDs ->
velocity setpoints -> velocity PIDs -> attitude/thrust -> attitude PIDs ->
body-rate commands, as three vectorised PID triples; and the comparison
harness's simpler cascade (``comparison_pid_step``), position PD with a
z integral over an attitude PD that outputs torques."""

from __future__ import annotations

import math
from dataclasses import dataclass
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


# ---------------------------------------------------------------------------
# The standalone comparison harness's controller (loop.compare)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ComparisonPidParams:
    mass: float = 1.225
    gravity: float = 9.81
    kp_pos: float = 15.0
    kd_pos: float = 8.0
    ki_pos: float = 2.0
    kp_att: float = 5.0
    kd_att: float = 2.0
    max_integral: float = 2.0
    max_torque: float = 0.1
    max_tilt: float = math.pi / 4

    @property
    def max_thrust(self) -> float:
        return 2.0 * self.mass * self.gravity


def comparison_pid_init(dtype=torch.float32, device=None) -> torch.Tensor:
    """The carry is the z-axis integral only."""
    return torch.zeros((), dtype=dtype, device=device)


def comparison_pid_step(params: ComparisonPidParams, z_integral: torch.Tensor,
                        state12: torch.Tensor, reference12: torch.Tensor, dt: float):
    """One control tick; returns ``([thrust, tau3], z_integral)``."""
    pos, vel = state12[0:3], state12[3:6]
    attitude, rates = state12[6:9], state12[9:12]
    pos_error = reference12[0:3] - pos

    z_integral = torch.clamp(z_integral + pos_error[2] * dt, -params.max_integral,
                             params.max_integral)
    accel_z_cmd = (params.kp_pos * pos_error[2] + params.kd_pos * (-vel[2])
                   + params.ki_pos * z_integral + params.gravity)
    accel_xy_cmd = params.kp_pos * pos_error[0:2] + params.kd_pos * (-vel[0:2])

    thrust_total = params.mass * accel_z_cmd

    phi_input = torch.clamp(accel_xy_cmd[1] / (accel_z_cmd + 1e-6), -0.99, 0.99)
    theta_input = torch.clamp(accel_xy_cmd[0] / (accel_z_cmd + 1e-6), -0.99, 0.99)
    phi_des = torch.clamp(-torch.arcsin(phi_input), -params.max_tilt, params.max_tilt)
    theta_des = torch.clamp(torch.arcsin(theta_input), -params.max_tilt, params.max_tilt)
    psi_des = reference12[8]

    att_error = torch.stack([phi_des - attitude[0], theta_des - attitude[1],
                             psi_des - attitude[2]])
    tau_cmd = torch.clamp(params.kp_att * att_error + params.kd_att * (-rates),
                          -params.max_torque, params.max_torque)
    thrust_cmd = torch.clamp(thrust_total, 0.0, params.max_thrust)
    return torch.cat([thrust_cmd[None], tau_cmd]), z_integral
