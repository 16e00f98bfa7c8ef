"""The RK4 demo MPC and the 9-state attitude MPC (port of
``control/mpc_demo.py``).

* ``RK4DemoMPC``: 6 states, 3 controls, the RK4-discretised double
  integrator (exact: ``A_d = I + dt A``, ``B_d = dt B + dt^2/2 A B``), a
  reference for every stage and a NED altitude box. A static condensed QP,
  built once in NumPy float64; each solve is the explicit-inverse ADMM of
  ``ops.qp.admm_box_qp``, which on the card is one launch of kernel K14
  (``ops.admm_pallas.admm_box_qp_fused``, float32). Only a float64 MPC on
  the CPU keeps the plain float64 loop (the split ``MPPIController``
  makes); ``plain_kernels=True`` runs K14's plain version on any device.
* ``AttitudeMPC``: 9 states ``[pos, vel, euler]``, control ``[T, tau]``
  with the reference's Euler-rate simplification (``d(euler)/dt = tau``),
  z-up thrust, a terminal stage of the same weight; nonlinear in the
  attitude, so it runs on the SQP engine (``control.mpc_sqp``), whose
  ADMM is PyTorch ops as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import full_f32_matmul, resolve_device
from ..ops.qp import admm_box_qp, condense_dynamics
from .mpc_sqp import QuadCost, SQPCarry, SQPConfig, SQPMPC


class DemoCarry(NamedTuple):
    slack: torch.Tensor
    dual: torch.Tensor


class RK4DemoMPC:
    """Static condensed QP with a reference for every stage."""

    def __init__(self, dt: float = 0.1, horizon: int = 10, admm_iterations: int = 80,
                 admm_rho: float = 4.0, dtype=torch.float32, device=None):
        self.dt = dt
        self.N = N = horizon
        self.rho = admm_rho
        self.iterations = admm_iterations
        self.dtype = dtype
        self.device = resolve_device(device)
        nx, nu = 6, 3

        A_c = np.zeros((nx, nx))
        A_c[0:3, 3:6] = np.eye(3)
        B_c = np.zeros((nx, nu))
        B_c[3:6, :] = np.eye(3)
        # exact RK4 == exact discretisation (A_c is nilpotent of index 2)
        A = np.eye(nx) + dt * A_c
        B = dt * B_c + 0.5 * dt**2 * (A_c @ B_c)

        Sx, Su, _ = condense_dynamics(A, B, N)

        q = np.array([30.0, 30.0, 40.0, 15.0, 15.0, 20.0])
        r = np.array([2.5, 2.5, 1.0])
        qbar = np.concatenate([np.tile(q, N - 1), 2.0 * q])   # Qf = 2 Q
        rbar = np.tile(r, N)

        H = Su.T @ (qbar[:, None] * Su) + np.diag(rbar)
        G = np.vstack([np.eye(N * nu), Su])
        M_inv = np.linalg.inv(H + admm_rho * (G.T @ G))

        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        cast = lambda a: torch.as_tensor(np.ascontiguousarray(a, np_dtype), device=self.device)
        self._Sx, self._Su = cast(Sx), cast(Su)
        self._SuT_q = cast(Su.T * qbar[None, :])
        self._G, self._M_inv = cast(G), cast(M_inv)
        # K14's operands: float32, G' contiguous
        f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)
        self._G_f32, self._GT_f32, self._M_inv_f32 = f32(G), f32(G.T), f32(M_inv)
        # bounds: x, y +-50; NED z in [-5, -0.5]; v, a +-2.5
        self._x_lo = cast(np.tile([-50, -50, -5.0, -2.5, -2.5, -2.5], N))
        self._x_hi = cast(np.tile([50, 50, -0.5, 2.5, 2.5, 2.5], N))
        self._u_lo = cast(np.full(N * nu, -2.5))
        self._u_hi = cast(np.full(N * nu, 2.5))
        self.n_constraints = G.shape[0]

    def init_carry(self) -> DemoCarry:
        kw = dict(dtype=self.dtype, device=self.device)
        return DemoCarry(slack=torch.zeros(self.n_constraints, **kw),
                         dual=torch.zeros(self.n_constraints, **kw))

    def _use_fused(self) -> bool:
        # K14 computes in float32 whatever the MPC's dtype; only a float64
        # MPC on the CPU keeps the float64 loop
        return self.device.type != "cpu" or self.dtype == torch.float32

    def solve(self, carry: DemoCarry, state: torch.Tensor, X_ref: torch.Tensor, *,
              plain_kernels: bool = False):
        """``X_ref (N+1, 6)`` the references of every stage (the first is
        not used). Returns ``(u0, X_opt, carry)``."""
        from ..ops.admm_pallas import admm_box_qp_fused, admm_box_qp_fused_plain

        full_f32_matmul()
        x0 = state.to(dtype=self.dtype, device=self.device)
        ref = X_ref[1:].to(self.dtype).reshape(-1)

        offset = self._Sx @ x0
        f = self._SuT_q @ (offset - ref)
        lower = torch.cat([self._u_lo, self._x_lo - offset])
        upper = torch.cat([self._u_hi, self._x_hi - offset])

        if self._use_fused() or plain_kernels:
            admm = admm_box_qp_fused_plain if plain_kernels else admm_box_qp_fused
            f32 = lambda v: v.to(torch.float32).contiguous()
            U, z, y = admm(self._M_inv_f32, self._G_f32, self._GT_f32, f32(f), f32(lower),
                           f32(upper), f32(carry.slack), f32(carry.dual), self.rho,
                           self.iterations)
            primal, slack, dual = (v.to(self.dtype) for v in (U, z, y))
        else:
            primal, slack, dual = admm_box_qp(self._M_inv, self._G, f, lower, upper, carry.slack,
                                              carry.dual, self.rho, self.iterations)
        N = self.N
        U = slack[: N * 3].reshape(N, 3)
        X_tail = (offset + self._Su @ primal).reshape(N, 6)
        X_opt = torch.cat([x0[None, :], X_tail], dim=0)
        return U[0], X_opt, DemoCarry(slack=slack, dual=dual)


def attitude_mpc_step(x, u, residual, dt=0.1, mass=1.5, gravity=9.81):
    """Forward-Euler step of the 9-state attitude model: z-up thrust, the
    Euler rates commanded directly by the torque channels."""
    vel = x[3:6]
    phi, theta, psi = x[6], x[7], x[8]
    T, tau = u[0], u[1:4]
    # constants as tensors of x's dtype: under torch.func.jacfwd, a 0-d
    # tensor times a Python float carries a float64 tangent
    mass = torch.tensor(mass, dtype=x.dtype, device=x.device)
    gravity = torch.tensor(gravity, dtype=x.dtype, device=x.device)

    ax = T / mass * (torch.cos(phi) * torch.sin(theta) * torch.cos(psi)
                     + torch.sin(phi) * torch.sin(psi))
    ay = T / mass * (torch.cos(phi) * torch.sin(theta) * torch.sin(psi)
                     - torch.sin(phi) * torch.cos(psi))
    az = T / mass * (torch.cos(phi) * torch.cos(theta)) - gravity

    deriv = torch.cat([vel, torch.stack([ax, ay, az]), tau])
    return x + dt * (deriv + residual)


class AttitudeMPC:
    """The attitude MPC of the reference's velocity-control node on the SQP
    engine (dt=0.1, N=10, mass=1.5)."""

    def __init__(self, dt: float = 0.1, horizon: int = 10, mass: float = 1.5,
                 config: SQPConfig | None = None, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev)
        self.mass = mass
        mg = mass * 9.81
        self.u_hover = torch.tensor([mg, 0.0, 0.0, 0.0], **kw)

        def step_fn(x, u, d):
            return attitude_mpc_step(x, u, d, dt=dt, mass=mass)

        cfg = config or SQPConfig(horizon=horizon, sqp_iterations=2, admm_iterations=100,
                                  admm_rho=0.05)
        BIG = 1e9
        self.mpc = SQPMPC(
            step_fn, state_dim=9, control_dim=4, config=cfg,
            state_lower=[-BIG] * 9, state_upper=[BIG] * 9,
            # thrust in [0, 2 m g], |tau| <= 1
            control_lower=[0.0, -1.0, -1.0, -1.0],
            control_upper=[2.0 * mg, 1.0, 1.0, 1.0],
            dtype=dtype, device=dev,
        )
        q = torch.tensor([10.0, 10.0, 20.0, 1.0, 1.0, 1.0, 0.5, 0.5, 0.1], **kw)
        self.cost = QuadCost(q_stage=q, q_terminal=q,   # the terminal stage weighs as the others
                             r_control=torch.tensor([0.1, 0.05, 0.05, 0.01], **kw),
                             u_ref=torch.zeros(4, **kw))

    def init_carry(self, state9: torch.Tensor) -> SQPCarry:
        return self.mpc.init_carry(state9, self.u_hover)

    def solve(self, carry: SQPCarry, state9: torch.Tensor, target9: torch.Tensor):
        N = self.mpc.config.horizon
        x_ref = target9.to(state9.dtype)[None, :].repeat(N, 1)
        return self.mpc.solve(carry, state9, self.cost, x_ref)
