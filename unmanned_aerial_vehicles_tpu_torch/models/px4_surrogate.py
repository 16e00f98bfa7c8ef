"""PX4-in-the-loop surrogate plant (port of ``models/px4_surrogate.py``).

Rate-setpoint + normalized-thrust inputs ``[thrust_norm, p, q, r]``; a
first-order lag on each body rate on top of rigid-body translational and
attitude kinematics, in the reference's mixed-NED frame (NED x/y and Euler
angles, z up): ``a_xy = -(T/m)(R e3)_xy``, ``a_z = +(T/m)(R e3)_z - g``.

This is the plain version of the plant kernels in ``ops.plant_pallas``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.rotations import euler_rate_transform, euler_to_rotation_matrix
from .params import RigidBodyParams


@dataclass(frozen=True)
class RateLoopParams:
    """First-order body-rate tracking constants plus the normalized-thrust
    calibration: thrust acceleration = ``thrust_norm * g / hover_thrust_norm``."""

    tau_roll: float = 0.05
    tau_pitch: float = 0.05
    tau_yaw: float = 0.08
    hover_thrust_norm: float = 1.0


def _derivative(
    state: torch.Tensor,
    control: torch.Tensor,
    body: RigidBodyParams,
    rates: RateLoopParams,
) -> torch.Tensor:
    dtype = state.dtype
    vel = state[..., 3:6]
    phi, theta, psi = state[..., 6], state[..., 7], state[..., 8]
    omega = state[..., 9:12]

    thrust_norm = control[..., 0]
    rate_cmd = control[..., 1:4]

    R = euler_to_rotation_matrix(phi, theta, psi)
    # mixed-NED thrust mapping: xy components flip sign
    t_dir = R[..., :, 2] * torch.tensor([-1.0, -1.0, 1.0], dtype=dtype, device=state.device)
    thrust_gain = body.gravity / rates.hover_thrust_norm
    thrust_accel_world = t_dir * (thrust_norm * thrust_gain)[..., None]

    # drag acts on the airspeed (v - wind)
    airspeed_vec = vel - torch.tensor(body.wind, dtype=dtype, device=state.device)
    sq = torch.sum(airspeed_vec**2, dim=-1, keepdim=True)
    speed = torch.where(sq > 0.0, torch.sqrt(torch.where(sq > 0.0, sq, 1.0)), 0.0)
    drag_accel = -(body.k_drag_linear / body.mass) * speed * airspeed_vec

    gravity = torch.zeros_like(vel)
    gravity[..., 2] = -body.gravity
    acceleration = thrust_accel_world + gravity + drag_accel

    W = euler_rate_transform(phi, theta)
    attitude_dot = torch.einsum("...ij,...j->...i", W, omega)

    taus = torch.tensor(
        [rates.tau_roll, rates.tau_pitch, rates.tau_yaw], dtype=dtype, device=state.device
    )
    omega_dot = (rate_cmd - omega) / taus

    return torch.cat([vel, acceleration, attitude_dot, omega_dot], dim=-1)


def px4_rate_tracking_step(
    state: torch.Tensor,
    control: torch.Tensor,
    body: RigidBodyParams,
    rates: RateLoopParams,
    dt: float,
) -> torch.Tensor:
    """RK4 step of the rate-tracking surrogate plant."""

    def f(x):
        return _derivative(x, control, body, rates)

    k1 = f(state)
    k2 = f(state + 0.5 * dt * k1)
    k3 = f(state + 0.5 * dt * k2)
    k4 = f(state + dt * k3)
    return state + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
