"""Fixed-iteration iLQR (Gauss-Newton) on the Riccati solvers (port of
``control/ilqr.py``).

The second engine of the 12-state family beside the SQP engine
(``control.mpc_sqp``): each iteration solves the unconstrained tracking
subproblem exactly by Riccati (``ops.riccati``, or the log-depth
``ops.parallel_riccati``) and handles the control bounds by clamping the
updated sequence:

    X       = rollout(U)
    A_k,B_k = jacfwd(step)(X_k, U_k)            (torch.func.vmap)
    dU      = LQR(A, B, 0, Q, R + reg, xref - X, uref - U, dx0 = 0)
    U       <- clip(U + dU, lo, hi)

Fixed iterations, no line search: the Levenberg-style ``reg`` on R keeps
full steps stable. The rollout of each iterate doubles as the next
iteration's linearisation anchor, so an iteration runs one rollout.

``ILQRRigidBodyMPC(integrator="rk4")`` on a CUDA device in float32 runs the
solve's forward rollouts as one launch each of kernel K10
(``ops.rigid_plant_pallas.rigid_body_rollout_fused``). The linearisation
never reaches the kernel: it is the vmapped ``jacfwd`` of the plain
``step_fn``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .._device import full_f32_matmul, resolve_device
from ..models.params import X500_PARAMS
from ..models.rigid_body import rigid_body_derivative, rigid_body_rk4_step
from ..ops.parallel_riccati import lqr_tracking_solve_parallel
from ..ops.riccati import lqr_tracking_solve


class ILQRSolution(NamedTuple):
    U: torch.Tensor       # (N, nu)
    X: torch.Tensor       # (N+1, nx)
    cost: torch.Tensor    # () tracking cost of the returned trajectory
    gains: torch.Tensor   # (N, nu, nx) that iterate's LQR feedback gains K_k


def _tracking_cost(X, U, q_diag, r_diag, x_ref, u_ref):
    return torch.sum(q_diag * (X - x_ref) ** 2) + torch.sum(r_diag * (U - u_ref) ** 2)


def _plain_rollout(step_fn: Callable, x0: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """``(N+1, nx)``: x0 and the serial steps of ``step_fn`` under ``U``."""
    X = [x0]
    for k in range(U.shape[0]):
        X.append(step_fn(X[-1], U[k]))
    return torch.stack(X)


def _clamp(U, u_lower, u_upper):
    if u_lower is not None:
        U = torch.maximum(U, u_lower)
    if u_upper is not None:
        U = torch.minimum(U, u_upper)
    return U


def ilqr_solve(
    step_fn: Callable,              # (x, u) -> x_next, the discrete dynamics
    x0: torch.Tensor,               # (nx,)
    U_init: torch.Tensor,           # (N, nu) initial control sequence
    q_diag: torch.Tensor,           # (N+1, nx) stage and terminal state weights
    r_diag: torch.Tensor,           # (nu,)
    x_ref: torch.Tensor,            # (N+1, nx)
    u_ref: torch.Tensor,            # (N, nu)
    iterations: int = 8,
    reg: float = 1e-3,
    u_lower: torch.Tensor | None = None,
    u_upper: torch.Tensor | None = None,
    parallel: bool = False,
    rollout_fn: Callable | None = None,
) -> ILQRSolution:
    """Fixed-iteration iLQR for quadratic tracking costs; returns the
    best-cost iterate (a later iterate replaces it only when strictly
    cheaper), with the gains of the subproblem that produced it.

    ``parallel=True`` solves each LQR subproblem with the log-depth
    Riccati. ``rollout_fn(x0, U) -> (N, nx)`` replaces the serial loop of
    ``step_fn`` for the forward rollouts (K10 for the rigid body); it must
    compute what ``step_fn`` computes. ``reg`` is added to R in the
    subproblem only, never in the cost."""
    lqr = lqr_tracking_solve_parallel if parallel else lqr_tracking_solve
    step_jac = torch.func.vmap(torch.func.jacfwd(step_fn, argnums=(0, 1)))

    def rollout(U):
        if rollout_fn is None:
            return _plain_rollout(step_fn, x0, U)
        return torch.cat([x0[None, :], rollout_fn(x0, U).to(x0.dtype)])

    N, nu = U_init.shape
    nx = x0.shape[0]
    zeros_c = torch.zeros(N, nx, dtype=U_init.dtype, device=U_init.device)
    dx0 = torch.zeros(nx, dtype=U_init.dtype, device=U_init.device)
    r_sub = r_diag + reg

    U, X = U_init, rollout(U_init)
    best_U, best_X = U, X
    best_cost = _tracking_cost(X, U, q_diag, r_diag, x_ref, u_ref)
    best_K = torch.zeros(N, nu, nx, dtype=U_init.dtype, device=U_init.device)
    for _ in range(iterations):
        A, B = step_jac(X[:-1], U)
        sol = lqr(A, B, zeros_c, q_diag, r_sub, x_ref - X, u_ref - U, dx0)
        U = _clamp(U + sol.U, u_lower, u_upper)
        X = rollout(U)
        cost = _tracking_cost(X, U, q_diag, r_diag, x_ref, u_ref)
        better = cost < best_cost
        best_U = torch.where(better, U, best_U)
        best_X = torch.where(better, X, best_X)
        # the gains belong to the same iterate as U and X: the policy tier
        # applies them around (U, X) for a whole dispatch
        best_K = torch.where(better, sol.gains, best_K)
        best_cost = torch.minimum(cost, best_cost)
    return ILQRSolution(U=best_U, X=best_X, cost=best_cost, gains=best_K)


def ilqr_optimality(
    step_fn: Callable,
    x0: torch.Tensor,
    U: torch.Tensor,                # (N, nu) candidate controls
    q_diag: torch.Tensor,           # (N+1, nx)
    r_diag: torch.Tensor,           # (nu,)
    x_ref: torch.Tensor,
    u_ref: torch.Tensor,
    u_lower: torch.Tensor | None = None,
    u_upper: torch.Tensor | None = None,
    tol: float = 1e-6,
) -> torch.Tensor:
    """First-order optimality of an iLQR iterate: the projected-gradient
    KKT residual of ``min_U J(U) s.t. lo <= U <= hi``, ``J`` the exact
    tracking cost of the plain rollout of ``step_fn`` (its gradient by
    ``torch.autograd.grad``, independent of the Riccati machinery).
    Componentwise: ``g`` on the interior, ``min(g, 0)`` within ``tol`` of
    the upper bound, ``max(g, 0)`` within ``tol`` of the lower bound.
    Zero exactly at a KKT point."""
    with torch.enable_grad():
        U_var = U.detach().clone().requires_grad_(True)
        cost = _tracking_cost(_plain_rollout(step_fn, x0.detach(), U_var), U_var, q_diag,
                              r_diag, x_ref, u_ref)
        (g,) = torch.autograd.grad(cost, U_var)
    res = g
    if u_upper is not None:
        res = torch.where(U >= u_upper - tol, torch.clamp(g, max=0.0), res)
    if u_lower is not None:
        res = torch.where(U <= u_lower + tol, torch.clamp(g, min=0.0), res)
    return torch.max(torch.abs(res))


class ILQRCarry(NamedTuple):
    U_prev: torch.Tensor   # (N, nu) warm start


class ILQRRigidBodyMPC:
    """The 12-state torque-MPC task (``control.mpc_rigid.RigidBodyMPC``'s
    costs and bounds) solved by iLQR, warm-started by shifting the previous
    control sequence. ``iterations=3`` by default.

    ``integrator="euler"`` predicts with forward Euler;
    ``integrator="rk4"`` with the plant's own RK4 step
    (``rigid_body_rk4_step``), so the plan is exact. With ``"rk4"``, float32
    and a CUDA device, ``rollout_fn`` is K10 (one launch of N steps per
    rollout); otherwise it is ``None`` and the plain loop of ``step_fn``
    rolls out. ``plain_kernels=True`` keeps ``rollout_fn`` at its plain
    version (the kernel's twin on the card)."""

    def __init__(self, dt: float = 0.02, horizon: int = 15, iterations: int = 3,
                 reg: float = 1e-2, parallel: bool = False, dtype=torch.float32,
                 integrator: str = "euler", device=None, plain_kernels: bool = False):
        self.params = p = X500_PARAMS
        self.device = dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev)
        mg = p.mass * p.gravity
        self.u_hover = torch.tensor([mg, 0.0, 0.0, 0.0], **kw)
        self.N = horizon
        self.iterations = iterations
        self.reg = reg
        self.parallel = parallel
        self.dtype = dtype

        if integrator == "euler":
            def step(x, u):
                return x + dt * rigid_body_derivative(x, u, p)
        elif integrator == "rk4":
            def step(x, u):
                return rigid_body_rk4_step(x, u, p, dt)
        else:
            raise ValueError(f"unknown integrator {integrator!r}")
        self.integrator = integrator
        self.step_fn = step

        self.rollout_fn = None
        if (integrator == "rk4" and dtype == torch.float32 and dev.type == "cuda"
                and not plain_kernels):
            from ..ops.rigid_plant_pallas import rigid_body_rollout_fused

            self.rollout_fn = lambda x0, U: rigid_body_rollout_fused(x0, U, p, dt)

        q = torch.tensor([12.0, 12.0, 18.0, 3.0, 3.0, 4.0, 2.0, 2.0, 1.5, 0.3, 0.3, 0.3], **kw)
        term = torch.tensor([2.5] * 3 + [1.5] * 3 + [1.5] * 3 + [0.8] * 3, **kw)
        self.q_diag = torch.cat([q[None].repeat(horizon, 1), (q * term)[None]])
        self.r_diag = torch.tensor([0.5, 0.1, 0.1, 0.1], **kw)
        self.u_lower = torch.tensor([0.3 * mg, -0.8, -0.8, -0.4], **kw)
        self.u_upper = torch.tensor([1.2 * mg, 0.8, 0.8, 0.4], **kw)

    def init_carry(self, state12) -> ILQRCarry:
        return ILQRCarry(U_prev=self.u_hover[None, :].repeat(self.N, 1))

    def solve(self, carry: ILQRCarry, state12: torch.Tensor, target_pos, target_yaw=0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, ILQRCarry]:
        """One tick: hold ``target_pos`` and ``target_yaw`` over the horizon
        from ``state12``. Returns ``(u0, X_plan, new_carry)``."""
        full_f32_matmul()
        kw = dict(dtype=self.dtype, device=self.device)
        x = state12.to(**kw)
        zero = torch.zeros((), **kw)
        x_ref_stage = torch.cat([
            torch.as_tensor(target_pos, **kw), torch.zeros(3, **kw),
            torch.stack([zero, zero, torch.as_tensor(target_yaw, **kw)]), torch.zeros(3, **kw)])
        x_ref = x_ref_stage[None, :].repeat(self.N + 1, 1)
        u_ref = self.u_hover[None, :].repeat(self.N, 1)
        U0 = torch.cat([carry.U_prev[1:], carry.U_prev[-1:]])
        sol = ilqr_solve(self.step_fn, x, U0, self.q_diag, self.r_diag, x_ref, u_ref,
                         iterations=self.iterations, reg=self.reg, u_lower=self.u_lower,
                         u_upper=self.u_upper, parallel=self.parallel,
                         rollout_fn=self.rollout_fn)
        return sol.U[0], sol.X, ILQRCarry(U_prev=sol.U)
