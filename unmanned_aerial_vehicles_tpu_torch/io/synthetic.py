"""Synthetic dynamics data and least-squares system identification (port of
``io/synthetic.py``).

``generate_excitation_data`` flies the surrogate plant under smooth random
acceleration commands and returns residual training pairs in the GP
dataset's schema (the residual against the double integrator, the GP's
nominal model); ``identify_linear_dynamics`` fits ``x+ = A x + B u`` to
transitions by one least-squares solve.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..control.allocation import attitude_loop_init, geometric_control_allocation
from ..models.double_integrator import double_integrator_step
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams, px4_rate_tracking_step


def generate_excitation_data(
    seed: int = 0,
    num_steps: int = 2000,
    dt: float = 0.02,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    smoothing: float = 0.95,
    noise: torch.Tensor | None = None,
    dtype=torch.float64,
    device=None,
):
    """``(X (n, 10), Y (n, 6))`` NumPy arrays: the flown states with the
    acceleration commands, and the residuals ``next state - double
    integrator step``. The commands are standard normals scaled by ``(0.8,
    0.8, 0.6, 0.2)`` and low-pass filtered by ``smoothing``; the normals are
    drawn from ``torch.Generator().manual_seed(seed)``, or handed in as
    ``noise`` (``(num_steps, 4)``, e.g. another package's draws). The
    flight is a host loop of the plain allocation and plant."""
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    if noise is None:
        noise = torch.randn(num_steps, 4, generator=torch.Generator().manual_seed(seed),
                            dtype=dtype)
    if tuple(noise.shape) != (num_steps, 4):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected ({num_steps}, 4)")
    noise = noise.to(**kw) * torch.tensor([0.8, 0.8, 0.6, 0.2], **kw)

    c = torch.zeros(4, **kw)
    commands = []
    for n in noise:
        c = smoothing * c + (1.0 - smoothing) * n
        commands.append(c)
    accel_cmd = torch.stack(commands)

    state = torch.zeros(12, **kw)
    state[2] = 3.0
    att = attitude_loop_init(dtype, dev)
    yaw = torch.zeros((), **kw)
    states, next_states = [], []
    for u in accel_cmd:
        thrust, rates, _, att = geometric_control_allocation(
            att, u[0:3], yaw, u[3], state[6:9], state[9:12], dt_attitude=dt)
        control = torch.cat([thrust[None], rates])
        new_state = state
        for _ in range(2):
            new_state = px4_rate_tracking_step(new_state, control, body, rate_loop, dt / 2)
        states.append(state)
        next_states.append(new_state)
        state = new_state
    states, next_states = torch.stack(states), torch.stack(next_states)

    X = torch.cat([states[:, 0:6], accel_cmd], dim=1)
    Y = next_states[:, 0:6] - double_integrator_step(states[:, 0:6], accel_cmd, dt)
    return X.cpu().numpy(), Y.cpu().numpy()


def identify_linear_dynamics(states, controls, next_states):
    """Least-squares fit of ``x+ = A x + B u`` from transitions (NumPy
    arrays or CPU tensors). Returns ``(A, B, residual RMS)``."""
    states = np.asarray(states)
    controls = np.asarray(controls)
    next_states = np.asarray(next_states)
    Z = np.hstack([states, controls])                     # (n, nx+nu)
    theta, *_ = np.linalg.lstsq(Z, next_states, rcond=None)
    nx = states.shape[1]
    A, B = theta[:nx].T, theta[nx:].T
    resid = next_states - Z @ theta
    return A, B, float(np.sqrt(np.mean(resid**2)))
