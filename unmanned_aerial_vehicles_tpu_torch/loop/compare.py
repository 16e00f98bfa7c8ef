"""The standalone PID-against-"GP-MPC" comparison harness (port of
``loop/compare.py``).

The reference's deterministic side-by-side benchmark, with its quirks kept:

* the inline Euler plant damps the velocity by 0.97 every step and writes
  the controller's channels 1:4 straight into the attitude states (for the
  PID clipped torques, for the stand-in MPC desired angles);
* the "GP-MPC" is a PD law with kp=20, kd=10;
* four trajectories: hover, circle, figure-8 and step.

``run_comparison`` is a host loop of small PyTorch ops on ``device`` (no
kernel, as in the JAX package, whose version is one scan).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .._device import resolve_device
from ..control.cascade_pid import ComparisonPidParams, comparison_pid_init, comparison_pid_step

TRAJECTORY_TYPES = ("hover", "circle", "figure8", "step")


def comparison_reference(t: torch.Tensor, traj_type: str) -> torch.Tensor:
    """The 12-D references at times ``t`` (any shape ``S``), ``S + (12,)``,
    computed in float64 as the JAX package computes them."""
    t = torch.as_tensor(t).to(torch.float64)
    ref = torch.zeros(t.shape + (12,), dtype=torch.float64, device=t.device)
    if traj_type == "hover":
        ref[..., 2] = 1.0
    elif traj_type in ("circle", "figure8"):
        radius, height = 2.0, 1.5
        w = 2.0 * math.pi / (10.0 if traj_type == "circle" else 15.0)
        s, c = torch.sin(w * t), torch.cos(w * t)
        ref[..., 2] = height
        if traj_type == "circle":
            ref[..., 0], ref[..., 1] = radius * c, radius * s
            ref[..., 3], ref[..., 4] = -radius * w * s, radius * w * c
        else:
            ref[..., 0], ref[..., 1] = radius * s, radius * s * c
            ref[..., 3], ref[..., 4] = radius * w * c, radius * w * (c**2 - s**2)
    elif traj_type == "step":
        ref[..., 2] = torch.where(t > 5.0, 1.5, 0.5)
    else:
        raise ValueError(f"unknown trajectory type {traj_type!r}")
    return ref


def simplified_mpc_control(state: torch.Tensor, ref: torch.Tensor,
                           params: ComparisonPidParams) -> torch.Tensor:
    """The reference's MPC stand-in: PD with kp=20, kd=10, output
    ``[thrust, phi_des, theta_des, psi_des]``."""
    kp, kd = 20.0, 10.0
    accel_cmd = kp * (ref[0:3] - state[0:3]) + kd * (ref[3:6] - state[3:6])
    accel_z_cmd = accel_cmd[2] + params.gravity
    thrust = params.mass * accel_z_cmd
    phi_des = -torch.arcsin(torch.clamp(accel_cmd[1] / (accel_z_cmd + 1e-6), -0.5, 0.5))
    theta_des = torch.arcsin(torch.clamp(accel_cmd[0] / (accel_z_cmd + 1e-6), -0.5, 0.5))
    control = torch.stack([thrust, phi_des, theta_des, ref[8]])
    kw = dict(dtype=state.dtype, device=state.device)
    return torch.minimum(torch.maximum(control, torch.tensor([0.0, -0.5, -0.5, -math.pi], **kw)),
                         torch.tensor([params.max_thrust, 0.5, 0.5, math.pi], **kw))


def comparison_plant_step(state: torch.Tensor, control: torch.Tensor, dt: float,
                          params: ComparisonPidParams) -> torch.Tensor:
    """The harness's inline Euler plant, quirks intact: the velocity damped
    by 0.97 each step, the attitude set to the control channels 1:4."""
    phi, theta = state[6], state[7]
    thrust = control[0]
    accel = torch.stack([
        thrust * torch.sin(theta) / params.mass,
        -thrust * torch.sin(phi) * torch.cos(theta) / params.mass,
        thrust * torch.cos(phi) * torch.cos(theta) / params.mass - params.gravity,
    ])
    vel = state[3:6] + accel * dt
    pos = state[0:3] + vel * dt
    return torch.cat([pos, vel * 0.97, control[1:4], state[9:12]])


def run_comparison(traj_type: str, duration: float = 30.0, dt: float = 0.1,
                   params: ComparisonPidParams = ComparisonPidParams(),
                   dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Both controllers on the same trajectory; the stacked per-step
    errors, positions and controls of both."""
    dev = resolve_device(device)
    num_steps = int(duration / dt)
    times = torch.arange(num_steps, device=dev).to(dtype) * dt
    refs = comparison_reference(times, traj_type).to(dtype)
    pid_state = torch.zeros(12, dtype=dtype, device=dev)
    pid_state[2] = 0.1
    mpc_state = pid_state.clone()
    z_int = comparison_pid_init(dtype, dev)
    rows = {k: [] for k in ("pid_pos", "mpc_pos", "pid_control", "mpc_control")}
    for i in range(num_steps):
        ref = refs[i]
        pid_u, z_int = comparison_pid_step(params, z_int, pid_state, ref, dt)
        pid_state = comparison_plant_step(pid_state, pid_u, dt, params)
        mpc_u = simplified_mpc_control(mpc_state, ref, params)
        mpc_state = comparison_plant_step(mpc_state, mpc_u, dt, params)
        for key, val in (("pid_pos", pid_state[0:3]), ("mpc_pos", mpc_state[0:3]),
                         ("pid_control", pid_u), ("mpc_control", mpc_u)):
            rows[key].append(val)
    outs = {k: torch.stack(v) for k, v in rows.items()}
    outs["ref_pos"] = refs[:, 0:3]
    outs["pid_error"] = torch.linalg.vector_norm(outs["pid_pos"] - outs["ref_pos"], dim=1)
    outs["mpc_error"] = torch.linalg.vector_norm(outs["mpc_pos"] - outs["ref_pos"], dim=1)
    return outs


def comparison_summary(outs: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The winner table's statistics."""
    pid_e, mpc_e = outs["pid_error"], outs["mpc_error"]
    summary = {
        "pid_avg_error": float(torch.mean(pid_e)),
        "pid_rmse": float(torch.sqrt(torch.mean(pid_e**2))),
        "pid_max_error": float(torch.max(pid_e)),
        "mpc_avg_error": float(torch.mean(mpc_e)),
        "mpc_rmse": float(torch.sqrt(torch.mean(mpc_e**2))),
        "mpc_max_error": float(torch.max(mpc_e)),
    }
    summary["winner"] = "GP-MPC" if summary["mpc_avg_error"] < summary["pid_avg_error"] else "PID"
    summary["improvement_%"] = ((summary["pid_avg_error"] - summary["mpc_avg_error"])
                                / max(summary["pid_avg_error"], 1e-12) * 100.0)
    return summary


def run_full_comparison(duration: float = 30.0, dt: float = 0.1,
                        device=None) -> Dict[str, dict]:
    """All four trajectory types (the reference's default campaign)."""
    return {traj: comparison_summary(run_comparison(traj, duration, dt, device=device))
            for traj in TRAJECTORY_TYPES}
