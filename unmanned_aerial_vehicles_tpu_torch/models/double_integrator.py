"""6-state double-integrator plant (port of ``models/double_integrator.py``).

State ``[x, y, z, vx, vy, vz]``, control ``[ax, ay, az, yaw_rate]``; the
yaw-rate channel does not enter the translational dynamics.
"""

from __future__ import annotations

import torch

STATE_DIM = 6
CONTROL_DIM = 4


def double_integrator_derivative(state: torch.Tensor, control: torch.Tensor) -> torch.Tensor:
    """dx/dt = [vx, vy, vz, ax, ay, az]."""
    return torch.cat([state[..., 3:6], control[..., 0:3]], dim=-1)


def double_integrator_step(
    state: torch.Tensor, control: torch.Tensor, dt: float
) -> torch.Tensor:
    """Forward-Euler step: ``x + dt * dx/dt``."""
    return state + dt * double_integrator_derivative(state, control)
