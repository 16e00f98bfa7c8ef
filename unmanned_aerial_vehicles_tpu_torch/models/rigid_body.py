"""12-state rigid-body quadrotor plant (port of ``models/rigid_body.py``).

State  ``[x, y, z, vx, vy, vz, phi, theta, psi, p, q, r]``
Control ``[T, tau_phi, tau_theta, tau_psi]`` (thrust in N, torques in Nm).

* translational:  m a = R [0, 0, T] + [0, 0, -m g] - k_l ||v - wind|| (v - wind)
* attitude:       d(euler)/dt = W(phi, theta) [p, q, r]
* rotational:     I dw/dt = tau - w x (I w) - k_a w
* an optional additive 12-D residual on the state derivative.

With ``k_drag_* = 0`` this is also the forward-Euler prediction model of
the 12-state MPC. Every function broadcasts over leading batch dimensions
and is differentiable: the SQP controllers linearise it with
``torch.func.jacfwd``, at hover too (the norm below is gradient-safe).
"""

from __future__ import annotations

import torch

from ..utils.rotations import euler_rate_transform, euler_to_rotation_matrix
from .params import RigidBodyParams

STATE_DIM = 12
CONTROL_DIM = 4


def rigid_body_derivative(state: torch.Tensor, control: torch.Tensor, params: RigidBodyParams,
                          residual: torch.Tensor | None = None) -> torch.Tensor:
    """Continuous-time state derivative."""
    kw = dict(dtype=state.dtype, device=state.device)
    vel = state[..., 3:6]
    phi, theta, psi = state[..., 6], state[..., 7], state[..., 8]
    omega = state[..., 9:12]
    thrust = control[..., 0]
    torques = control[..., 1:4]

    R = euler_to_rotation_matrix(phi, theta, psi)
    thrust_world = R[..., :, 2] * thrust[..., None]

    # drag on the airspeed (v - wind); gradient-safe ||.||: exact forward
    # value, zero (sub)gradient at 0, where a plain norm's derivative is NaN
    airspeed = vel - torch.tensor(params.wind, **kw)
    sq = torch.sum(airspeed**2, dim=-1, keepdim=True)
    pos = sq > 0.0
    speed = torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))),
                        torch.zeros_like(sq))
    drag = -params.k_drag_linear * speed * airspeed

    gravity = torch.tensor([0.0, 0.0, -params.mass * params.gravity], **kw)
    acceleration = (thrust_world + gravity + drag) / params.mass

    W = euler_rate_transform(phi, theta)
    attitude_dot = torch.einsum("...ij,...j->...i", W, omega)

    inertia = torch.tensor(params.inertia_diag, **kw)
    i_omega = inertia * omega
    # omega x (I omega), written out (vmap- and jacfwd-safe)
    gyroscopic = torch.stack([
        omega[..., 1] * i_omega[..., 2] - omega[..., 2] * i_omega[..., 1],
        omega[..., 2] * i_omega[..., 0] - omega[..., 0] * i_omega[..., 2],
        omega[..., 0] * i_omega[..., 1] - omega[..., 1] * i_omega[..., 0],
    ], dim=-1)
    angular_drag = -params.k_drag_angular * omega
    angular_acceleration = (torques - gyroscopic + angular_drag) / inertia

    deriv = torch.cat([vel, acceleration, attitude_dot, angular_acceleration], dim=-1)
    if residual is not None:
        deriv = deriv + residual
    return deriv


def rigid_body_rk4_step(state: torch.Tensor, control: torch.Tensor, params: RigidBodyParams,
                        dt: float, residual: torch.Tensor | None = None) -> torch.Tensor:
    """Classic RK4 with zero-order-hold control."""

    def f(x):
        return rigid_body_derivative(x, control, params, residual)

    k1 = f(state)
    k2 = f(state + 0.5 * dt * k1)
    k3 = f(state + 0.5 * dt * k2)
    k4 = f(state + dt * k3)
    return state + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rigid_body_euler_step(state: torch.Tensor, control: torch.Tensor, params: RigidBodyParams,
                          dt: float, residual: torch.Tensor | None = None) -> torch.Tensor:
    """Forward Euler: the 12-state MPC's prediction model."""
    return state + dt * rigid_body_derivative(state, control, params, residual)
