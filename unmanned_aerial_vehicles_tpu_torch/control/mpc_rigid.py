"""Nonlinear quadrotor MPC variants on the SQP engine (port of
``control/mpc_rigid.py``).

* ``RigidBodyMPC``: the 12-state torque + thrust MPC (forward-Euler rigid
  body, hover-centric cost, target clamping and final control clamps).
* ``DirectRateMPC``: the direct body-rate MPC, control ``[p_cmd, q_cmd,
  r_cmd, thrust]`` with first-order rate tracking (tau 0.05/0.05/0.08 s),
  normalized thrust scaled by g (1.0 is hover), per-stage residuals as an
  input.
* ``LTVTrackingMPC``: the LTV tracking MPC, linearised about the reference
  trajectory with hover controls, RK4 rigid body with drag, attitude boxes,
  optional obstacle rows.
"""

from __future__ import annotations

import math

import torch

from .._device import resolve_device
from ..models.params import GZ_QUADROTOR_PARAMS, X500_PARAMS, RigidBodyParams
from ..models.rigid_body import rigid_body_derivative
from ..utils.rotations import wrap_angle
from .mpc_sqp import QuadCost, SQPCarry, SQPConfig, SQPMPC

BIG = 1e9


class RigidBodyMPC:
    """The 12-state torque MPC: forward-Euler rigid body, torque + thrust
    inputs."""

    def __init__(self, dt: float = 0.02, horizon: int = 15,
                 params: RigidBodyParams = X500_PARAMS, config: SQPConfig | None = None,
                 dtype=torch.float32, device=None):
        self.dt = dt
        self.params = params
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev)
        mg = params.mass * params.gravity
        self.u_hover = torch.tensor([mg, 0.0, 0.0, 0.0], **kw)

        def step_fn(x, u, d):
            return x + dt * rigid_body_derivative(x, u, params, d)

        cfg = config or SQPConfig(horizon=horizon, sqp_iterations=1, admm_iterations=80,
                                  admm_rho=0.05)
        self.mpc = SQPMPC(
            step_fn, state_dim=12, control_dim=4, config=cfg,
            state_lower=[-50, -50, -1, -15, -15, -15, -1.2, -1.2, -BIG, -10, -10, -10],
            state_upper=[50, 50, 20, 15, 15, 15, 1.2, 1.2, BIG, 10, 10, 10],
            control_lower=[0.3 * mg, -0.8, -0.8, -0.4],
            control_upper=[1.2 * mg, 0.8, 0.8, 0.4],
            dtype=dtype, device=dev,
        )
        q_stage = torch.tensor([12.0, 12.0, 18.0, 3.0, 3.0, 4.0, 2.0, 2.0, 1.5, 0.3, 0.3, 0.3],
                               **kw)
        term = torch.tensor([2.5] * 3 + [1.5] * 3 + [1.5] * 3 + [0.8] * 3, **kw)
        self.cost = QuadCost(q_stage=q_stage, q_terminal=q_stage * term,
                             r_control=torch.tensor([0.5, 0.1, 0.1, 0.1], **kw),
                             u_ref=self.u_hover)
        self._mg = mg

    def init_carry(self, state12: torch.Tensor) -> SQPCarry:
        return self.mpc.init_carry(state12, self.u_hover)

    def solve(self, carry: SQPCarry, state12: torch.Tensor, target_pos, target_yaw=0.0):
        """Velocity clamp, angle wrapping, the 4 m target clamp and box, the
        SQP tick, the final control clamps."""
        x = state12.clone()
        x[3:6] = torch.clamp(x[3:6], -6.0, 6.0)
        x[6:9] = wrap_angle(x[6:9])
        kw = dict(dtype=x.dtype, device=x.device)
        target_yaw = wrap_angle(torch.as_tensor(target_yaw, **kw))
        target_pos = torch.as_tensor(target_pos, **kw)

        pos_err = target_pos - x[0:3]
        dist = torch.linalg.vector_norm(pos_err)
        direction = pos_err / (dist + 1e-6)
        target_pos = torch.where(dist > 4.0, x[0:3] + 4.0 * direction, target_pos)
        target_pos = torch.minimum(torch.maximum(target_pos, torch.tensor([-15.0, -15.0, 0.2], **kw)),
                                   torch.tensor([15.0, 15.0, 8.0], **kw))

        N = self.mpc.config.horizon
        zero3 = torch.zeros(3, **kw)
        x_ref_stage = torch.cat([target_pos, zero3, torch.stack([zero3[0], zero3[0], target_yaw]),
                                 zero3])
        x_ref = x_ref_stage[None, :].repeat(N, 1)

        u0, X_opt, carry = self.mpc.solve(carry, x, self.cost, x_ref)
        mg = self._mg
        u0 = torch.stack([
            torch.clamp(u0[0], 0.3 * mg, 1.2 * mg),
            torch.clamp(u0[1], -0.8, 0.8),
            torch.clamp(u0[2], -0.8, 0.8),
            torch.clamp(u0[3], -0.4, 0.4),
        ])
        return u0, X_opt, carry


def direct_rate_step(x, u, residual, dt=0.02, gravity=9.81, taus=(0.05, 0.05, 0.08)):
    """Forward-Euler step of the direct-rate model, z-up, normalized thrust
    scaled by g. ``residual`` is the 12-D dynamics residual added to the
    derivative."""
    vel = x[3:6]
    roll, pitch, yaw = x[6], x[7], x[8]
    rates = x[9:12]
    rate_cmd, thrust = u[0:3], u[3]
    # g as a tensor of x's dtype: under torch.func.jacfwd, a 0-d tensor
    # times a Python float carries a float64 tangent
    gravity = torch.tensor(gravity, dtype=x.dtype, device=x.device)

    a = thrust * gravity
    vx_dot = a * (torch.sin(roll) * torch.sin(yaw)
                  + torch.cos(roll) * torch.cos(yaw) * torch.sin(pitch))
    vy_dot = a * (-torch.sin(roll) * torch.cos(yaw)
                  + torch.cos(roll) * torch.sin(yaw) * torch.sin(pitch))
    vz_dot = a * (torch.cos(roll) * torch.cos(pitch)) - gravity

    cr, sr = torch.cos(roll), torch.sin(roll)
    tp = torch.tan(pitch)
    cp = torch.cos(pitch)
    roll_dot = rates[0] + rates[1] * sr * tp + rates[2] * cr * tp
    pitch_dot = rates[1] * cr - rates[2] * sr
    yaw_dot = rates[1] * sr / cp + rates[2] * cr / cp

    tau = torch.tensor(taus, dtype=x.dtype, device=x.device)
    rate_dot = (rate_cmd - rates) / tau

    deriv = torch.cat([vel, torch.stack([vx_dot, vy_dot, vz_dot]),
                       torch.stack([roll_dot, pitch_dot, yaw_dot]), rate_dot])
    return x + dt * (deriv + residual)


class DirectRateMPC:
    """The direct body-rate MPC; residuals are an ``(N, 12)`` input."""

    def __init__(self, dt: float = 0.02, horizon: int = 20, config: SQPConfig | None = None,
                 dtype=torch.float32, device=None):
        self.dt = dt
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev)

        def step_fn(x, u, d):
            return direct_rate_step(x, u, d, dt=dt)

        cfg = config or SQPConfig(horizon=horizon, sqp_iterations=1, admm_iterations=80,
                                  admm_rho=0.05)
        self.mpc = SQPMPC(
            step_fn, state_dim=12, control_dim=4, config=cfg,
            state_lower=[-50, -50, -2, -12, -12, -8, -0.5, -0.5, -3.14, -3, -3, -2],
            state_upper=[50, 50, 25, 12, 12, 8, 0.5, 0.5, 3.14, 3, 3, 2],
            control_lower=[-2.5, -2.5, -1.8, 0.2],
            control_upper=[2.5, 2.5, 1.8, 1.5],
            dtype=dtype, device=dev,
        )
        q_stage = torch.tensor([100.0, 100.0, 120.0, 10.0, 10.0, 15.0, 5.0, 5.0, 0.0, 2.0, 2.0,
                                3.0], **kw)
        q_term = q_stage.clone()
        q_term[0:3] = 5.0 * q_stage[0:3]
        self.cost = QuadCost(q_stage=q_stage, q_terminal=q_term,
                             r_control=torch.tensor([1.0, 1.0, 1.5, 0.5], **kw),
                             u_ref=torch.zeros(4, **kw))
        self.u_hover = torch.tensor([0.0, 0.0, 0.0, 1.0], **kw)

    def init_carry(self, state12: torch.Tensor) -> SQPCarry:
        return self.mpc.init_carry(state12, self.u_hover)

    def solve(self, carry, state12, target_pos, residuals=None):
        N = self.mpc.config.horizon
        x_ref_stage = torch.cat([torch.as_tensor(target_pos, dtype=state12.dtype,
                                                 device=state12.device),
                                 torch.zeros(9, dtype=state12.dtype, device=state12.device)])
        return self.mpc.solve(carry, state12, self.cost, x_ref_stage[None, :].repeat(N, 1),
                              residuals)


class LTVTrackingMPC:
    """The LTV tracking MPC: one QP per tick, linearised about the
    reference trajectory with hover nominal controls."""

    def __init__(self, dt: float = 0.1, horizon: int = 20,
                 params: RigidBodyParams = GZ_QUADROTOR_PARAMS, config: SQPConfig | None = None,
                 num_obstacles: int = 0, obstacle_margin: float = 0.5, dtype=torch.float32,
                 device=None):
        self.dt = dt
        self.params = params
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev)
        mg = params.mass * params.gravity
        self.u_hover = torch.tensor([mg, 0.0, 0.0, 0.0], **kw)

        def step_fn(x, u, d):
            # RK4, the residual entering as dt * uncertainty
            def f(xx):
                return rigid_body_derivative(xx, u, params)

            k1 = f(x)
            k2 = f(x + 0.5 * dt * k1)
            k3 = f(x + 0.5 * dt * k2)
            k4 = f(x + dt * k3)
            return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4) + dt * d

        cfg = config or SQPConfig(horizon=horizon, sqp_iterations=1, admm_iterations=200,
                                  admm_rho=0.02)
        q4 = math.pi / 4
        self.mpc = SQPMPC(
            step_fn, state_dim=12, control_dim=4, config=cfg,
            state_lower=[-BIG] * 6 + [-q4, -q4, -BIG] + [-BIG] * 3,
            state_upper=[BIG] * 6 + [q4, q4, BIG] + [BIG] * 3,
            control_lower=[0.0, -0.1, -0.1, -0.1],
            control_upper=[2.0 * mg, 0.1, 0.1, 0.1],
            num_obstacles=num_obstacles, obstacle_margin=obstacle_margin,
            dtype=dtype, device=dev,
        )
        q = torch.tensor([100.0] * 3 + [10.0] * 3 + [50.0] * 3 + [5.0] * 3, **kw)
        self.cost = QuadCost(q_stage=q, q_terminal=5.0 * q,
                             r_control=torch.tensor([0.01, 0.1, 0.1, 0.1], **kw),
                             u_ref=torch.zeros(4, **kw))

    def init_carry(self, state12: torch.Tensor) -> SQPCarry:
        return self.mpc.init_carry(state12, self.u_hover)

    def solve(self, carry, state12, reference_traj, residuals=None, obstacles=None):
        """``reference_traj (N+1, 12)`` stage references; the linearisation
        anchors to the reference and hover controls each tick."""
        N = self.mpc.config.horizon
        lin = (reference_traj.to(state12.dtype), self.u_hover[None, :].repeat(N, 1))
        return self.mpc.solve(carry, state12, self.cost, reference_traj[1:], residuals,
                              lin_trajectory=lin, obstacles=obstacles)
