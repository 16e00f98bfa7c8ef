"""PX4-in-the-loop surrogate plant (port of ``models/px4_surrogate.py``).

Rate-setpoint + normalized-thrust inputs ``[thrust_norm, p, q, r]``; a
first-order lag on each body rate on top of rigid-body translational and
attitude kinematics, in the reference's mixed-NED frame (NED x/y and Euler
angles, z up): ``a_xy = -(T/m)(R e3)_xy``, ``a_z = +(T/m)(R e3)_z - g``.

This is the plain version of the plant kernels in ``ops.plant_pallas``.
``derivative_jacobian`` and ``px4_step_jacobian`` give the continuous
Jacobian and the RK4 step's transition Jacobian in closed form.
"""

from __future__ import annotations

import functools
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


# The PX4 cascade-PID campaign's rate loop: its hover calibration feeds a 0.7
# normalized-thrust baseline (JAX ``models/px4_surrogate.py:118``), the rate
# loop of the JAX CLI's ``tune`` command.
PID_CAMPAIGN_RATE_LOOP = RateLoopParams(hover_thrust_norm=0.7)


@functools.lru_cache(maxsize=256)
def _constant_vector(values: tuple, dtype, device) -> torch.Tensor:
    """A vector of Python-number constants on ``device``, made once: a copy
    from the host at every call would wait for the device's queue. Every
    caller gets the same tensor, so none may write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def _constants(values, dtype, device) -> torch.Tensor:
    """A vector of plant constants. They are Python numbers, or tensors
    where a population gives each flight its own (0-d per flight under
    ``torch.func.vmap``)."""
    if any(isinstance(v, torch.Tensor) for v in values):
        return torch.stack([torch.as_tensor(v, dtype=dtype, device=device) for v in values])
    return _constant_vector(tuple(float(v) for v in values), dtype,
                            None if device is None else torch.device(device))


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
    t_dir = R[..., :, 2] * _constant_vector((-1.0, -1.0, 1.0), dtype, state.device)
    thrust_gain = body.gravity / rates.hover_thrust_norm
    thrust_accel_world = t_dir * (thrust_norm * thrust_gain)[..., None]

    # drag acts on the airspeed (v - wind)
    airspeed_vec = vel - _constants(body.wind, dtype, state.device)
    sq = torch.sum(airspeed_vec**2, dim=-1, keepdim=True)
    speed = torch.where(sq > 0.0, torch.sqrt(torch.where(sq > 0.0, sq, 1.0)), 0.0)
    drag_accel = -(body.k_drag_linear / body.mass) * speed * airspeed_vec

    gravity = torch.zeros_like(vel)
    gravity[..., 2] = -body.gravity
    acceleration = thrust_accel_world + gravity + drag_accel

    W = euler_rate_transform(phi, theta)
    attitude_dot = torch.einsum("...ij,...j->...i", W, omega)

    taus = _constants((rates.tau_roll, rates.tau_pitch, rates.tau_yaw), dtype, state.device)
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


def derivative_jacobian(
    state: torch.Tensor,
    control: torch.Tensor,
    body: RigidBodyParams,
    rates: RateLoopParams,
) -> torch.Tensor:
    """``d(_derivative)/d(state)`` in closed form (12, 12): identity from
    velocity to position, the airspeed drag ``-(k/m)(speed I + av av' /
    speed)`` (zero at zero airspeed) and the thrust direction's Euler-angle
    derivatives on the acceleration rows, ``dW/d(phi, theta) omega`` and
    ``W`` on the attitude rows, ``-diag(1/tau)`` on the rate rows. The
    tangent and secant use the guarded ``cos(theta)``."""
    dtype, dev = state.dtype, state.device
    vel = state[3:6]
    phi, theta, psi = state[6], state[7], state[8]
    q, r = state[10], state[11]

    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    eps = torch.where(cth < 0, torch.full_like(cth, -1e-6), torch.full_like(cth, 1e-6))
    cth_safe = torch.where(torch.abs(cth) < 1e-6, eps, cth)
    tth = sth / cth_safe
    sec = 1.0 / cth_safe
    sec2 = sec * sec
    zero, one = torch.zeros_like(phi), torch.ones_like(phi)

    av = vel - _constants(body.wind, dtype, dev)
    sq = torch.sum(av**2)
    pos = sq > 0.0
    speed = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
    kd = body.k_drag_linear / body.mass
    outer = torch.where(pos, torch.outer(av, av) / torch.where(pos, speed, 1.0), 0.0)
    drag = -kd * (speed * torch.eye(3, dtype=dtype, device=dev) + outer)

    a_thrust = control[0] * (body.gravity / rates.hover_thrust_norm)
    d_euler = a_thrust * torch.stack([
        torch.stack([sphi * sth * cpsi - cphi * spsi, -cphi * cth * cpsi,
                     cphi * sth * spsi - sphi * cpsi]),
        torch.stack([sphi * sth * spsi + cphi * cpsi, -cphi * cth * spsi,
                     -(cphi * sth * cpsi + sphi * spsi)]),
        torch.stack([-sphi * cth, -cphi * sth, zero]),
    ])
    att = torch.stack([
        torch.stack([q * cphi * tth - r * sphi * tth, (q * sphi + r * cphi) * sec2, zero,
                     one, sphi * tth, cphi * tth]),
        torch.stack([-q * sphi - r * cphi, zero, zero, zero, cphi, -sphi]),
        torch.stack([(q * cphi - r * sphi) * sec, (q * sphi + r * cphi) * sth * sec2, zero,
                     zero, sphi * sec, cphi * sec]),
    ])
    taus = _constants((rates.tau_roll, rates.tau_pitch, rates.tau_yaw), dtype, dev)

    J = torch.zeros(12, 12, dtype=dtype, device=dev)
    J[0:3, 3:6] = torch.eye(3, dtype=dtype, device=dev)
    J[3:6, 3:6] = drag
    J[3:6, 6:9] = d_euler
    J[6:9, 6:12] = att
    J[9:12, 9:12] = torch.diag(-1.0 / taus)
    return J


def px4_step_jacobian(
    state: torch.Tensor,
    control: torch.Tensor,
    body: RigidBodyParams,
    rates: RateLoopParams,
    dt: float,
) -> torch.Tensor:
    """Transition Jacobian of ``px4_rate_tracking_step``: the chain rule
    through the RK4 stages with ``derivative_jacobian``,

        K1 = J(x),  K2 = J(x2)(I + h/2 K1),  K3 = J(x3)(I + h/2 K2),
        K4 = J(x4)(I + h K3),  F = I + h/6 (K1 + 2 K2 + 2 K3 + K4)."""
    f = lambda x: _derivative(x, control, body, rates)
    Jat = lambda x: derivative_jacobian(x, control, body, rates)
    eye = torch.eye(12, dtype=state.dtype, device=state.device)
    h = dt
    k1 = f(state)
    x2 = state + 0.5 * h * k1
    k2 = f(x2)
    x3 = state + 0.5 * h * k2
    k3 = f(x3)
    x4 = state + h * k3
    K1 = Jat(state)
    K2 = Jat(x2) @ (eye + 0.5 * h * K1)
    K3 = Jat(x3) @ (eye + 0.5 * h * K2)
    K4 = Jat(x4) @ (eye + h * K3)
    return eye + (h / 6.0) * (K1 + 2.0 * K2 + 2.0 * K3 + K4)
