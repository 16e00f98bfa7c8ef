"""Control allocation (port of ``control/allocation.py``).

``geometric_control_allocation``: desired world acceleration + yaw ->
normalized thrust, attitude setpoint and body-rate command through an
attitude PID (Kp=3.2, Ki=0.6, Kd=0.6) whose clipped error integral is the
carried state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..utils.rotations import wrap_angle


class AttitudeLoopState(NamedTuple):
    integral: torch.Tensor  # (3,) attitude-error integral


def attitude_loop_init(dtype=torch.float32, device=None) -> AttitudeLoopState:
    return AttitudeLoopState(integral=torch.zeros(3, dtype=dtype, device=resolve_device(device)))


def geometric_control_allocation(
    carry: AttitudeLoopState,
    accel_des: torch.Tensor,
    target_yaw: torch.Tensor,
    yawrate_des: torch.Tensor,
    current_attitude: torch.Tensor,
    current_angular_velocity: torch.Tensor,
    dt_attitude: float = 0.02,
    kp: float = 3.2,
    ki: float = 0.6,
    kd: float = 0.6,
    integral_max: float = 0.3,
    gravity: float = 9.81,
    thrust_ceiling=1.2,
):
    """One allocation tick. ``thrust_ceiling`` is the normalized-thrust
    clamp (a float, or a 0-d tensor when a recovery mode raises it).

    Returns ``(thrust_normalized, rate_setpoint3, attitude_setpoint3, carry)``.
    """
    g = torch.zeros(3, dtype=accel_des.dtype, device=accel_des.device)
    g[2] = gravity
    thrust_vector = accel_des + g
    thrust_magnitude = torch.linalg.vector_norm(thrust_vector)
    thrust_normalized = torch.clamp(thrust_magnitude / gravity, min=0.25)
    thrust_normalized = torch.minimum(
        thrust_normalized, torch.as_tensor(thrust_ceiling, dtype=accel_des.dtype, device=accel_des.device)
    )

    thrust_unit = thrust_vector / torch.clamp(thrust_magnitude, min=1e-9)
    pitch_cmd = -torch.asin(torch.clamp(thrust_unit[0], -0.4, 0.4))
    roll_cmd = torch.asin(torch.clamp(thrust_unit[1], -0.4, 0.4))
    # zero tilt when the thrust vector is degenerate
    degenerate = thrust_magnitude <= 0.1
    pitch_cmd = torch.where(degenerate, torch.zeros_like(pitch_cmd), pitch_cmd)
    roll_cmd = torch.where(degenerate, torch.zeros_like(roll_cmd), roll_cmd)

    error = torch.stack(
        [
            wrap_angle(roll_cmd - current_attitude[0]),
            wrap_angle(pitch_cmd - current_attitude[1]),
            wrap_angle(target_yaw - current_attitude[2]),
        ]
    )
    integral = torch.clamp(carry.integral + error * dt_attitude, -integral_max, integral_max)

    rate_cmd = kp * error + ki * integral - kd * current_angular_velocity
    rollrate = torch.clamp(rate_cmd[0], -1.2, 1.2)
    pitchrate = torch.clamp(rate_cmd[1], -1.2, 1.2)
    yawrate = torch.clamp(yawrate_des + rate_cmd[2], -0.8, 0.8)

    rate_setpoint = torch.stack([rollrate, pitchrate, yawrate])
    attitude_setpoint = torch.stack([roll_cmd, pitch_cmd, target_yaw])
    return (
        thrust_normalized,
        rate_setpoint,
        attitude_setpoint,
        AttitudeLoopState(integral=integral),
    )
