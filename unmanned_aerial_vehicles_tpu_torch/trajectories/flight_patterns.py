"""Flight-node reference patterns with the 5-second tanh ramp (port of
``trajectories/flight_patterns.py``)."""

from __future__ import annotations

import math

import torch


def ramped_figure8_reference(t: torch.Tensor, amplitude: float = 6.0, frequency: float = 0.02):
    """Figure-8 position + yaw of the MPC flight node.

    ``t`` is a tensor of times (any shape); returns ``(pos (..., 3), yaw)``
    on ``t``'s device and dtype, with z = 0 (harnesses add their altitude)."""
    w = 2.0 * math.pi * frequency
    ramp = torch.tanh(torch.clamp(t, min=0.0) / 5.0)
    x = ramp * amplitude * torch.sin(w * t)
    y = ramp * (amplitude / 2.0) * torch.sin(2.0 * w * t)
    z = torch.zeros_like(x)
    yaw = torch.zeros_like(x)
    return torch.stack([x, y, z], dim=-1), yaw


def ramped_circle_reference(t: torch.Tensor, amplitude: float = 6.0, frequency: float = 0.02,
                            height: float = 3.0):
    """Circle position/velocity + yaw of the cascade-PID flight node.

    Returns ``(pos (..., 3), vel (..., 3), yaw)`` on ``t``'s device and
    dtype. The velocity formulas are the reference's, including its
    ``vy = A w cos(2 w t)`` quirk."""
    w = 2.0 * math.pi * frequency
    ramp = torch.tanh(torch.clamp(t, min=0.0) / 5.0)
    x = ramp * amplitude * torch.sin(w * t)
    y = ramp * amplitude * torch.cos(w * t)
    z = torch.full_like(x, height)
    vx = ramp * amplitude * w * torch.cos(w * t)
    vy = ramp * amplitude * w * torch.cos(2.0 * w * t)
    vz = torch.zeros_like(x)
    yaw = torch.zeros_like(x)
    return torch.stack([x, y, z], dim=-1), torch.stack([vx, vy, vz], dim=-1), yaw
