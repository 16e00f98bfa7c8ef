"""6-state double-integrator plant (port of ``models/double_integrator.py``).

State ``[x, y, z, vx, vy, vz]``, control ``[ax, ay, az, yaw_rate]``; the
yaw-rate channel does not enter the translational dynamics.
"""

from __future__ import annotations

import torch

from .._device import resolve_device

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


def discrete_system_matrices(dt: float, dtype=torch.float32, device=None):
    """``(A, B)`` of the forward-Euler discrete system the linear MPC uses,
    ``x_{k+1} = A x_k + B u_k``: ``A = I + dt [[0, I], [0, 0]]``, ``B = dt
    [[0], [I | 0]]`` (the yaw-rate column is zero: it does not enter the
    translational dynamics)."""
    device = resolve_device(device)
    A = torch.eye(STATE_DIM, dtype=dtype, device=device)
    A[0:3, 3:6] = dt * torch.eye(3, dtype=dtype, device=device)
    B = torch.zeros(STATE_DIM, CONTROL_DIM, dtype=dtype, device=device)
    B[3:6, 0:3] = dt * torch.eye(3, dtype=dtype, device=device)
    return A, B
