"""Tracking metrics of the reference's flight-log analyzer (port of
``metrics/tracking.py``).

Formula for formula, on tensors: every function takes leading batch
dimensions, the time axis is ``-2`` for ``(..., T, 3)`` signals, so a
batch of flights reduces in one call on its device.
"""

from __future__ import annotations

import math

import torch


def rms_position_error(pos_setpoint, pos_current) -> torch.Tensor:
    """``sqrt(mean ||e||^2)`` over time."""
    err = pos_setpoint - pos_current
    return torch.sqrt(torch.mean(torch.sum(err**2, dim=-1), dim=-1))


def max_position_error(pos_setpoint, pos_current) -> torch.Tensor:
    err = pos_setpoint - pos_current
    return torch.amax(torch.linalg.vector_norm(err, dim=-1), dim=-1)


def rms_velocity_error(vel_setpoint, vel_current) -> torch.Tensor:
    err = vel_setpoint - vel_current
    return torch.sqrt(torch.mean(torch.sum(err**2, dim=-1), dim=-1))


def thrust_saturation_pct(thrust_normalized, high: float = 0.99,
                          low: float = 0.11) -> torch.Tensor:
    """The share (%) of samples with normalized thrust >= 0.99 or <= 0.11."""
    sat = (thrust_normalized >= high) | (thrust_normalized <= low)
    return 100.0 * torch.mean(sat.to(torch.float32), dim=-1)


def thrust_saturation_informative_pct(thrust_normalized, hover: float = 1.0,
                                      hover_band: float = 0.05, high: float = 0.99,
                                      low: float = 0.11) -> torch.Tensor:
    """The saturation share without the samples within ``hover_band`` of
    the hover thrust. The reference's definition counts any thrust >= 0.99
    as saturated, and its allocation commands ~1.0 at hover, so that share
    reads ~100 % in healthy flight; this one reads ~0 % there and grows
    only when the controller rails against the actuator limits."""
    near_hover = torch.abs(thrust_normalized - hover) <= hover_band
    sat = ((thrust_normalized >= high) | (thrust_normalized <= low)) & ~near_hover
    return 100.0 * torch.mean(sat.to(torch.float32), dim=-1)


def attitude_rmse_deg(att_setpoint, att_current) -> torch.Tensor:
    """Per-axis attitude RMSE in degrees, shape ``(..., 3)``."""
    err = att_setpoint - att_current
    return torch.sqrt(torch.mean(err**2, dim=-2)) * (180.0 / math.pi)


def tracking_metrics(pos_setpoint, pos_current, vel_setpoint=None, vel_current=None,
                     att_setpoint=None, att_current=None, thrust_normalized=None) -> dict:
    """The reference's whole metric set as a dict of tensors."""
    out = {
        "rms_pos": rms_position_error(pos_setpoint, pos_current),
        "max_pos": max_position_error(pos_setpoint, pos_current),
    }
    if vel_setpoint is not None and vel_current is not None:
        out["rms_vel"] = rms_velocity_error(vel_setpoint, vel_current)
    if att_setpoint is not None and att_current is not None:
        rmse = attitude_rmse_deg(att_setpoint, att_current)
        out["rms_roll_deg"] = rmse[..., 0]
        out["rms_pitch_deg"] = rmse[..., 1]
        out["rms_yaw_deg"] = rmse[..., 2]
    if thrust_normalized is not None:
        out["mean_thrust_sat_pct"] = thrust_saturation_pct(thrust_normalized)
        out["thrust_sat_nonhover_pct"] = thrust_saturation_informative_pct(thrust_normalized)
    return out
