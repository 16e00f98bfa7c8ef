"""Nonlinear MPC by fixed-iteration SQP over a condensed LTV QP (port of
``control/mpc_sqp.py``).

One engine for the 12-state family (``control.mpc_rigid``): the torque MPC,
the direct body-rate MPC and the LTV tracking MPC differ only in their
``step_fn``, costs and bounds. Per SQP iteration (real-time iteration,
Gauss-Newton):

1. linearise the discrete step about the warm-start trajectory with
   ``torch.func.vmap(torch.func.jacfwd(step_fn, argnums=(0, 1)))``;
2. condense (``ops.qp.condense_ltv``), equilibrate (diagonal Ruiz scaling),
   factor ``M = Hs + rho Gs'Gs`` once and solve the box QP with
   operator-composed ADMM (``ops.qp.admm_box_qp_composite``), fixed
   iterations;
3. roll the nonlinear dynamics forward under the new controls.

``SQPConfig(polish=True)`` replaces step 2's ADMM by the verification
solve: ``ops.qp.ip_box_qp`` on the unequilibrated QP, then
``ops.qp.active_set_polish``. ``solve(return_kkt=True)`` also returns each
SQP iteration's ``ops.qp.kkt_score`` against its own QP, and
``nonlinear_kkt_score`` scores a candidate against the nonlinear program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from .._device import full_f32_matmul, resolve_device
from ..ops.qp import (
    active_set_polish,
    admm_box_qp_composite,
    condense_ltv,
    ip_box_qp,
    kkt_score,
    kkt_violation,
    roll_block,
    shift_stages,
)


@dataclass(frozen=True)
class QuadCost:
    """Diagonal tracking cost ``sum_k |x_k - x_ref|_Q^2 + |u_k - u_ref|_R^2``
    with a terminal stage of its own diagonal."""

    q_stage: torch.Tensor      # (nx,)
    q_terminal: torch.Tensor   # (nx,)
    r_control: torch.Tensor    # (nu,)
    u_ref: torch.Tensor        # (nu,) e.g. hover thrust


@dataclass(frozen=True)
class SQPConfig:
    horizon: int = 15
    sqp_iterations: int = 1
    admm_iterations: int = 40
    admm_rho: float = 1.0       # in equilibrated space (unit-diagonal H)
    admm_over_relax: float = 1.6
    polish: bool = False        # interior point + active-set polish in place of the ADMM


class SQPCarry(NamedTuple):
    slack: torch.Tensor     # (m,)
    dual: torch.Tensor      # (m,)
    X_prev: torch.Tensor    # (N+1, nx)
    U_prev: torch.Tensor    # (N, nu)


def step_jacobians(step_fn: Callable):
    """``(X (N, nx), U (N, nu), D (N, nx)) -> (A (N, nx, nx), B (N, nx,
    nu))``: the discrete step's exact Jacobians at each stage."""
    return torch.func.vmap(torch.func.jacfwd(step_fn, argnums=(0, 1)))


def linearize(step_fn: Callable, X_bar, U_bar, residuals):
    """``(A, B, c)`` of the affine model ``x_{k+1} = A_k x_k + B_k u_k +
    c_k`` about ``(X_bar[:-1], U_bar)``."""
    A, B = step_jacobians(step_fn)(X_bar[:-1], U_bar, residuals)
    X_next = torch.func.vmap(step_fn)(X_bar[:-1], U_bar, residuals)
    c = (X_next - torch.einsum("kij,kj->ki", A, X_bar[:-1])
         - torch.einsum("kij,kj->ki", B, U_bar))
    return A, B, c


def ruiz_scaling(H: torch.Tensor, G: torch.Tensor):
    """Diagonal equilibration of the condensed QP: primal scale ``d =
    diag(H)^-1/2``, constraint rows to unit norm (``e``). Returns ``(d, e,
    Hs, Gs)``."""
    d = 1.0 / torch.sqrt(torch.diagonal(H) + 1e-10)
    Hs = H * d[:, None] * d[None, :]
    Gd = G * d[None, :]
    e = 1.0 / torch.sqrt(torch.sum(Gd**2, dim=1) + 1e-10)
    return d, e, Hs, Gd * e[:, None]


def obstacle_normals(X_anchor: torch.Tensor, obstacles: torch.Tensor):
    """Unit normals ``(N, n_obs, 3)`` from each obstacle's centre to the
    anchor plan's positions ``X_anchor[1:]``."""
    diff = X_anchor[1:, None, 0:3] - obstacles[None, :, 0:3]
    dist = torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-9)
    return diff / dist[..., None]


class SQPMPC:
    """Generic SQP MPC around a user step function.

    ``step_fn(x, u, residual) -> x_next`` is the discrete prediction model;
    ``residual`` is the per-stage dynamics-residual hook (may be ignored).
    It must be composable with ``torch.func`` (vmap, jacfwd).

    ``num_obstacles`` reserves constraint rows for spherical-obstacle
    avoidance: each obstacle/stage pair becomes the half-space ``n'(p_k -
    obs) >= r + margin`` with ``n`` the unit vector from the obstacle to
    the warm-start plan."""

    def __init__(self, step_fn: Callable, state_dim: int, control_dim: int, config: SQPConfig,
                 state_lower, state_upper, control_lower, control_upper,
                 num_obstacles: int = 0, obstacle_margin: float = 0.5,
                 dtype=torch.float32, device=None):
        self.step_fn = step_fn
        self.nx, self.nu = state_dim, control_dim
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.num_obstacles = num_obstacles
        self.obstacle_margin = obstacle_margin
        N = config.horizon
        tile = lambda v: torch.tensor([float(a) for a in v], dtype=dtype,
                                      device=self.device).repeat(N)
        self._x_lo, self._x_hi = tile(state_lower), tile(state_upper)
        self._u_lo, self._u_hi = tile(control_lower), tile(control_upper)
        self.n_primal = N * control_dim
        self.n_constraints = N * (control_dim + state_dim) + N * num_obstacles

    # ------------------------------------------------------------------
    def init_carry(self, state: torch.Tensor, u_init: torch.Tensor) -> SQPCarry:
        """Cold start: constant state, constant control (the hover guess)."""
        N = self.config.horizon
        kw = dict(dtype=self.dtype, device=self.device)
        return SQPCarry(
            slack=torch.zeros(self.n_constraints, **kw),
            dual=torch.zeros(self.n_constraints, **kw),
            X_prev=state.to(**kw)[None, :].repeat(N + 1, 1),
            U_prev=u_init.to(**kw)[None, :].repeat(N, 1),
        )

    def shift_blocks(self, vec: torch.Tensor) -> torch.Tensor:
        """Every block of a slack or dual vector (U, X, obstacle rows) moved
        one stage forward, its last stage repeated."""
        N, nu, nx = self.config.horizon, self.nu, self.nx
        splits = [N * nu, N * (nu + nx)]
        parts = [roll_block(vec[: splits[0]], N), roll_block(vec[splits[0]: splits[1]], N)]
        if self.num_obstacles:
            parts.append(roll_block(vec[splits[1]:], N))
        return torch.cat(parts)

    def _shift(self, carry: SQPCarry, x0: torch.Tensor) -> SQPCarry:
        X_prev = shift_stages(carry.X_prev)
        X_prev[0] = x0
        return SQPCarry(slack=self.shift_blocks(carry.slack), dual=self.shift_blocks(carry.dual),
                        X_prev=X_prev, U_prev=shift_stages(carry.U_prev))

    def rollout(self, x0: torch.Tensor, U: torch.Tensor, residuals: torch.Tensor) -> torch.Tensor:
        """``(N+1, nx)``: x0 and the nonlinear step under ``U``."""
        X = [x0]
        for k in range(U.shape[0]):
            X.append(self.step_fn(X[-1], U[k], residuals[k]))
        return torch.stack(X)

    # ------------------------------------------------------------------
    def defaults(self, residuals, obstacles):
        """Zero residuals, and inactive obstacle placeholders (hugely
        negative radius) for an engine with obstacle rows."""
        N = self.config.horizon
        kw = dict(dtype=self.dtype, device=self.device)
        residuals = (torch.zeros(N, self.nx, **kw) if residuals is None
                     else residuals.to(**kw))
        if self.num_obstacles:
            if obstacles is None:
                obstacles = torch.zeros(self.num_obstacles, 4, **kw)
                obstacles[:, 3] = -1e9
            else:
                obstacles = obstacles.to(**kw)
        return residuals, obstacles

    def horizon_weights(self, cost: QuadCost):
        """``(qbar, rbar, u_ref_flat)``: the cost's diagonals and control
        reference over the horizon (the terminal stage's own diagonal)."""
        N = self.config.horizon
        kw = dict(dtype=self.dtype, device=self.device)
        qbar = torch.cat([cost.q_stage.to(**kw).repeat(N - 1), cost.q_terminal.to(**kw)])
        return qbar, cost.r_control.to(**kw).repeat(N), cost.u_ref.to(**kw).repeat(N)

    def cost_arrays(self, cost: QuadCost, x_ref: torch.Tensor):
        """``(qbar, rbar, ref_flat, u_ref_flat)`` over the horizon."""
        qbar, rbar, u_ref_flat = self.horizon_weights(cost)
        return qbar, rbar, x_ref.to(dtype=self.dtype, device=self.device).reshape(-1), u_ref_flat

    def _subproblem(self, x0, X_bar, U_bar, X_anchor, residuals, obstacles,
                    qbar, rbar, ref_flat, u_ref_flat):
        """Unequilibrated condensed QP of one SQP iteration linearised about
        ``(X_bar, U_bar)``: ``(H, G, f, lower, upper)`` of ``min 1/2 U'HU +
        f'U  s.t.  l <= GU <= u``."""
        N, nx, nu = self.config.horizon, self.nx, self.nu
        A, B, c = linearize(self.step_fn, X_bar, U_bar, residuals)
        Sx, Su, Sc = condense_ltv(A, B, c)

        offset = Sx @ x0 + Sc
        SuT_q = Su.T * qbar[None, :]
        H = SuT_q @ Su + torch.diag(rbar)
        f = SuT_q @ (offset - ref_flat) - rbar * u_ref_flat

        G = torch.cat([torch.eye(N * nu, dtype=self.dtype, device=self.device), Su])
        lower = torch.cat([self._u_lo, self._x_lo - offset])
        upper = torch.cat([self._u_hi, self._x_hi - offset])
        if self.num_obstacles:
            # half-space rows n'(p_k) >= r + margin + n'obs, the normals
            # anchored to the warm-start plan (it already detours)
            Su3 = Su.reshape(N, nx, N * nu)[:, 0:3, :]
            off3 = offset.reshape(N, nx)[:, 0:3]
            n_vec = obstacle_normals(X_anchor, obstacles)
            rows = torch.einsum("nkj,njp->nkp", n_vec, Su3)
            lo_obs = (obstacles[None, :, 3] + self.obstacle_margin
                      + torch.einsum("nkj,kj->nk", n_vec, obstacles[:, 0:3])
                      - torch.einsum("nkj,nj->nk", n_vec, off3))
            G = torch.cat([G, rows.reshape(-1, N * nu)])
            lower = torch.cat([lower, lo_obs.reshape(-1)])
            upper = torch.cat([upper, torch.full((N * self.num_obstacles,), 1e9,
                                                 dtype=self.dtype, device=self.device)])
        return H, G, f, lower, upper

    def _anchors(self, carry: SQPCarry, x0, lin_trajectory):
        if lin_trajectory is not None:
            X_bar, U_bar = lin_trajectory
            X_bar = X_bar.to(self.dtype).clone()
            X_bar[0] = x0
            return X_bar, U_bar.to(self.dtype)
        X_bar = carry.X_prev.clone()
        X_bar[0] = x0
        return X_bar, carry.U_prev

    def qp_data(self, carry: SQPCarry, state: torch.Tensor, cost: QuadCost, x_ref: torch.Tensor,
                residuals=None, lin_trajectory=None, obstacles=None):
        """Unequilibrated ``(H, G, f, lower, upper)`` of the first SQP
        subproblem ``solve`` would pose this tick (after the warm-start
        shift)."""
        full_f32_matmul()
        x0 = state.to(self.dtype)
        carry = self._shift(carry, x0)
        residuals, obstacles = self.defaults(residuals, obstacles)
        X_bar, U_bar = self._anchors(carry, x0, lin_trajectory)
        return self._subproblem(x0, X_bar, U_bar, carry.X_prev, residuals, obstacles,
                                *self.cost_arrays(cost, x_ref))

    # ------------------------------------------------------------------
    def solve(self, carry: SQPCarry, state: torch.Tensor, cost: QuadCost, x_ref: torch.Tensor,
              residuals: torch.Tensor | None = None, lin_trajectory: tuple | None = None,
              obstacles: torch.Tensor | None = None, return_kkt: bool = False):
        """One MPC tick: fixed SQP iterations, warm-started. ``x_ref (N,
        nx)`` per-stage targets, ``lin_trajectory`` an optional ``(X (N+1,
        nx), U (N, nu))`` linearisation anchor, ``obstacles (n_obs, 4)``
        ``[x, y, z, r]``. Returns ``(u0, X_opt, new_carry)``, or with
        ``return_kkt=True`` ``(u0, X_opt, new_carry, kkt)``: ``kkt`` the
        ``(sqp_iterations,)`` ``kkt_score`` of each iteration's iterate
        against its own unequilibrated QP."""
        cfg = self.config
        full_f32_matmul()
        N, nu = cfg.horizon, self.nu
        x0 = state.to(self.dtype)
        carry = self._shift(carry, x0)
        residuals, obstacles = self.defaults(residuals, obstacles)
        arrays = self.cost_arrays(cost, x_ref)
        X_bar, U_bar = self._anchors(carry, x0, lin_trajectory)
        X_anchor, z, y = carry.X_prev, carry.slack, carry.dual
        rho = cfg.admm_rho
        scores = []
        for _ in range(cfg.sqp_iterations):
            H, G, f, lower, upper = self._subproblem(x0, X_bar, U_bar, X_anchor, residuals,
                                                     obstacles, *arrays)
            if cfg.polish:
                # solve to convergence on the unequilibrated QP: the interior
                # point, then the active-set polish of its iterate
                U_pol, y, _ = active_set_polish(H, G, f, lower, upper,
                                                ip_box_qp(H, G, f, lower, upper))
                U_bar = U_pol[: N * nu].reshape(N, nu)
                z = torch.clamp(G @ U_pol, min=lower, max=upper)
            else:
                # equilibrate (the traced Hessians are badly conditioned),
                # factor once, compose the ADMM operator (one matvec per
                # iteration)
                d, e, Hs, Gs = ruiz_scaling(H, G)
                fs = f * d
                L = torch.linalg.cholesky(Hs + rho * (Gs.T @ Gs))
                GMinvT_s = torch.cholesky_solve(Gs.T, L)
                P1 = Gs @ GMinvT_s
                p0 = -(GMinvT_s.T @ fs)
                minv_f = torch.cholesky_solve(fs[:, None], L)[:, 0]
                sol = admm_box_qp_composite(P1, p0, GMinvT_s, minv_f, lower * e, upper * e,
                                            z * e, y / e, rho, cfg.admm_iterations,
                                            cfg.admm_over_relax)
                z, y = sol.slack / e, sol.dual * e
                # controls from the slack's U-block: box-feasible at every
                # iteration, the primal at convergence
                U_bar = z[: N * nu].reshape(N, nu)
            if return_kkt:
                scores.append(kkt_score(H, G, f, lower, upper, U_bar.reshape(-1), y))
            X_bar = self.rollout(x0, U_bar, residuals)
            X_anchor = X_bar
        new_carry = SQPCarry(slack=z, dual=y, X_prev=X_bar, U_prev=U_bar)
        if return_kkt:
            return U_bar[0], X_bar, new_carry, torch.stack(scores)
        return U_bar[0], X_bar, new_carry


def nonlinear_kkt_score(mpc: SQPMPC, cost: QuadCost, x0: torch.Tensor, x_ref: torch.Tensor,
                        U: torch.Tensor, y: torch.Tensor, residuals: torch.Tensor | None = None,
                        obstacles: torch.Tensor | None = None) -> torch.Tensor:
    """KKT score of the nonlinear single-shooting program at ``(U (N, nu),
    y (m,))``, with exact Jacobians of the engine's rollout (autograd),
    independent of the SQP linearisation:

        min_U 1/2 [ sum_k q_k (x_k(U) - ref_k)^2 + r (u_k - uref)^2 ]
        s.t.  u_lo <= U <= u_hi,  x_lo <= X(U) <= x_hi,
              dist(p_k(U), obs_j) >= r_j + margin

    (the 1/2 matches the engine's QP scaling, so the engine's duals apply
    unchanged): ``ops.qp.kkt_violation`` with stationarity ``grad J + J_g'
    y``."""
    N, nu = mpc.config.horizon, mpc.nu
    residuals, obstacles = mpc.defaults(residuals, obstacles)
    qbar, rbar, ref_flat, u_ref_flat = mpc.cost_arrays(cost, x_ref)
    x0 = x0.to(mpc.dtype)
    y = y.to(mpc.dtype)

    def x_traj(U_f):
        return mpc.rollout(x0, U_f.reshape(N, nu), residuals)[1:]

    def g_fn(U_f):
        X = x_traj(U_f)
        parts = [U_f, X.reshape(-1)]
        if mpc.num_obstacles:
            diff = X[:, None, 0:3] - obstacles[None, :, 0:3]
            parts.append(torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-9).reshape(-1))
        return torch.cat(parts)

    def cost_fn(U_f):
        ex = x_traj(U_f).reshape(-1) - ref_flat
        return 0.5 * (torch.sum(qbar * ex**2) + torch.sum(rbar * (U_f - u_ref_flat) ** 2))

    lower = torch.cat([mpc._u_lo, mpc._x_lo])
    upper = torch.cat([mpc._u_hi, mpc._x_hi])
    if mpc.num_obstacles:
        lower = torch.cat([lower, (obstacles[None, :, 3] + mpc.obstacle_margin)
                           .repeat(N, 1).reshape(-1)])
        upper = torch.cat([upper, torch.full((N * mpc.num_obstacles,), 1e9, dtype=mpc.dtype,
                                             device=mpc.device)])
    with torch.enable_grad():
        U_f = U.reshape(-1).to(mpc.dtype).detach().requires_grad_(True)
        g_val = g_fn(U_f)
        (g_y,) = torch.autograd.grad(g_val, U_f, grad_outputs=y)
        (grad_J,) = torch.autograd.grad(cost_fn(U_f), U_f)
    return kkt_violation(grad_J + g_y, g_val.detach(), lower, upper, y)

