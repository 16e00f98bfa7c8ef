"""Stateless PID step with an explicit carry (port of ``control/pid.py``):
anti-windup integral clamp, error-difference derivative, symmetric output
limit, and a first call that returns zero."""

from __future__ import annotations

from typing import NamedTuple

import torch


class PIDGains(NamedTuple):
    kp: torch.Tensor
    ki: torch.Tensor
    kd: torch.Tensor
    max_output: torch.Tensor
    max_integral: torch.Tensor


class PIDState(NamedTuple):
    integral: torch.Tensor
    previous_error: torch.Tensor
    initialized: torch.Tensor  # bool; the first update returns 0


def pid_init(shape=(), dtype=torch.float32, device=None) -> PIDState:
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    return PIDState(
        integral=zeros, previous_error=zeros.clone(),
        initialized=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def pid_step(gains: PIDGains, state: PIDState, setpoint: torch.Tensor,
             current: torch.Tensor, dt: float):
    """One PID update; returns ``(output, new_state)``."""
    error = setpoint - current
    integral = torch.clamp(state.integral + error * dt, -gains.max_integral, gains.max_integral)
    derivative = (error - state.previous_error) / dt

    output = gains.kp * error + gains.ki * integral + gains.kd * derivative
    output = torch.clamp(output, -gains.max_output, gains.max_output)

    output = torch.where(state.initialized, output, torch.zeros_like(output))
    new_state = PIDState(
        integral=torch.where(state.initialized, integral, state.integral),
        previous_error=torch.where(state.initialized, error, state.previous_error),
        initialized=torch.ones_like(state.initialized),
    )
    return output, new_state
