"""Control allocation (port of ``control/allocation.py``).

``geometric_control_allocation``: desired world acceleration + yaw ->
normalized thrust, attitude setpoint and body-rate command through an
attitude PID (Kp=3.2, Ki=0.6, Kd=0.6) whose clipped error integral is the
carried state. ``torque_to_px4_rates`` converts a torque-input MPC's
command into PX4 body rates and normalized thrust; ``with_hover_fallback``
wraps a controller so that a command that is not finite becomes the hover
command.
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


def torque_to_px4_rates(
    u_mpc: torch.Tensor,
    mass: float = 2.0,
    Jx: float = 0.0217,
    Jy: float = 0.0217,
    Jz: float = 0.04,
    kp_att: float = 5.0,
    gravity: float = 9.81,
):
    """Torque + thrust MPC output ``[T, tau_x, tau_y, tau_z]`` -> ``(rate_cmd
    (3,), thrust_norm)``: the reference's conversion, with its 0.05 s
    feed-forward constant and its asymmetric clips (thrust to [0.30, 0.80]
    of ``m g``, roll and pitch rates to 3, yaw rate to 2)."""
    uT, tau = u_mpc[0], u_mpc[1:4]
    thrust_norm = torch.clamp(uT / (mass * gravity), 0.30, 0.80)
    alpha = tau / torch.tensor([Jx, Jy, Jz], dtype=u_mpc.dtype, device=u_mpc.device)
    dt_control = 0.05
    rate_cmd = alpha * dt_control * kp_att
    rate_cmd = torch.stack([
        torch.clamp(rate_cmd[0], -3.0, 3.0),
        torch.clamp(rate_cmd[1], -3.0, 3.0),
        torch.clamp(rate_cmd[2], -2.0, 2.0),
    ])
    return rate_cmd, thrust_norm


def with_hover_fallback(controller_fn, hover_control=None):
    """Wrap a ``(*args) -> u`` or ``(*args) -> (u, *rest)`` controller with
    the reference's solver-failure behaviour: a command that is not finite
    everywhere is replaced by the hover command. The check is a
    ``torch.where`` on the output, so it needs no host read.
    ``hover_control`` defaults to the zero-acceleration command (zeros of
    ``u``'s shape: the fused loops' convention, where allocation adds the
    gravity compensation)."""

    def wrapped(*args, **kwargs):
        out = controller_fn(*args, **kwargs)
        u, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
        hover = (torch.zeros_like(u) if hover_control is None
                 else torch.as_tensor(hover_control, dtype=u.dtype, device=u.device))
        safe = torch.where(torch.isfinite(u).all(), u, hover)
        return (safe, *rest) if rest else safe

    return wrapped
