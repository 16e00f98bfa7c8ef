"""6-state linear GP-MPC as a condensed box-QP (port of
``control/mpc_linear.py``).

Double-integrator model ``x_{k+1} = x_k + dt (f_nom + d_k)`` with stage-wise
GP dynamics residuals ``d_k``; cost ``Q_pos = diag(50,50,80)``,
``Q_vel = diag(12,12,18)``, ``R = diag(2,2,1,8)`` with terminal weights
``3 Q_pos`` / ``2 Q_vel``; box bounds on states and controls; states
eliminated and the QP solved in control space by fixed-iteration composite
ADMM with a shifted warm start. With ``tightening_factor`` kappa > 0 and a
stage-wise GP std (``solve(uncertainty=...)``) the state boxes shrink by
kappa times the std propagated through the prediction matrix (zero-order
GP-MPC, arXiv:2211.15522).

``use_fused_controller`` solves each tick in one launch of the fused
controller kernel K3 (``ops.controller_pallas.gpmpc_controller_fused``);
``use_fused_admm`` runs the ADMM loop as one launch of K6
(``ops.admm_pallas.admm_box_qp_fused_composite``, given ``Su'`` so that it
applies P1 as its factors). Both compute in float32 and cast back to the
MPC's dtype. On the staged path ``polish=True`` snaps each tick's ADMM
iterate to the KKT point of its detected active set
(``ops.qp.active_set_polish``); the fused paths ignore ``polish``, as in
the JAX package.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .._device import full_f32_matmul, resolve_device
from ..models.double_integrator import CONTROL_DIM, STATE_DIM
from ..ops.qp import AdmmState, active_set_polish, admm_box_qp_composite, condense_dynamics


@dataclass(frozen=True)
class LinearMPCConfig:
    dt: float = 0.02
    horizon: int = 25
    q_pos: Tuple[float, float, float] = (50.0, 50.0, 80.0)
    q_vel: Tuple[float, float, float] = (12.0, 12.0, 18.0)
    r_control: Tuple[float, float, float, float] = (2.0, 2.0, 1.0, 8.0)
    terminal_pos_weight: float = 3.0
    terminal_vel_weight: float = 2.0
    state_lower: Tuple[float, ...] = (-30.0, -30.0, -5.0, -8.0, -8.0, -4.0)
    state_upper: Tuple[float, ...] = (30.0, 30.0, 20.0, 8.0, 8.0, 4.0)
    control_lower: Tuple[float, ...] = (-4.0, -4.0, -5.0, -1.0)
    control_upper: Tuple[float, ...] = (4.0, 4.0, 8.0, 1.0)
    admm_iterations: int = 80
    admm_rho: float = 8.0
    admm_over_relax: float = 1.6
    polish: bool = False
    polish_tol: float = 1e-7
    polish_passes: int = 3
    tightening_factor: float = 0.0
    use_fused_admm: bool = False
    use_fused_controller: bool = False


class MPCCarry(NamedTuple):
    """Warm-start state carried across ticks."""

    slack: torch.Tensor       # ADMM z  (m,)
    dual: torch.Tensor        # ADMM y  (m,)
    X_prev: torch.Tensor      # (N+1, 6) previous predicted states
    U_prev: torch.Tensor      # (N, 4) previous optimal controls


class LinearMPC:
    """Condensed-QP linear MPC: built once in NumPy float64, solved with
    tensors of ``dtype`` on ``device``.

    With ``use_fused_controller`` it also holds ``_fc_data``, the host
    row-form controller operands (``ops.controller_pallas``), and
    ``_tick_data``, their float32 device layouts for K3, K4 and K5
    (``ops.tick_pallas.build_tick_data``). With ``use_fused_admm`` it holds
    K6's float32 ``P1``, ``GMinvT`` and ``SuT`` (``Su'``, G's block below
    the identity: the kernel applies P1 as ``GMinvT`` and ``SuT``)."""

    def __init__(self, config: LinearMPCConfig = LinearMPCConfig(),
                 dtype=torch.float32, device=None):
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        N, dt = config.horizon, config.dt
        nx, nu = STATE_DIM, CONTROL_DIM

        A = np.eye(nx)
        A[0:3, 3:6] = dt * np.eye(3)
        B = np.zeros((nx, nu))
        B[3:6, 0:3] = dt * np.eye(3)

        Sx, Su, Sw = condense_dynamics(A, B, N)

        q_stage = np.concatenate([config.q_pos, config.q_vel])
        q_term = np.concatenate(
            [
                config.terminal_pos_weight * np.asarray(config.q_pos),
                config.terminal_vel_weight * np.asarray(config.q_vel),
            ]
        )
        qbar = np.concatenate([np.tile(q_stage, N - 1), q_term])
        rbar = np.tile(np.asarray(config.r_control), N)

        H = Su.T @ (qbar[:, None] * Su) + np.diag(rbar)
        G = np.vstack([np.eye(N * nu), Su])
        M = H + config.admm_rho * (G.T @ G)
        M_inv = np.linalg.inv(M)

        self.n_primal = N * nu
        self.n_constraints = G.shape[0]

        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        cast = lambda a: torch.as_tensor(np.asarray(a, dtype=np_dtype), device=self.device)
        self._Sx, self._Su, self._Sw = cast(Sx), cast(Su), cast(Sw)
        self._Sw_sq = cast(Sw**2)   # variance propagation (tightening)
        self._qbar = cast(qbar)
        self._H, self._G, self._M_inv = cast(H), cast(G), cast(M_inv)
        self._SuT_q = cast(Su.T * qbar[None, :])
        GMinv = G @ M_inv
        self._GMinv = cast(GMinv)
        self._P1 = cast(GMinv @ G.T)
        u_lo = np.asarray(np.tile(config.control_lower, N), np_dtype)
        u_hi = np.asarray(np.tile(config.control_upper, N), np_dtype)
        x_lo = np.asarray(np.tile(config.state_lower, N), np_dtype)
        x_hi = np.asarray(np.tile(config.state_upper, N), np_dtype)
        self._u_lo, self._u_hi = cast(u_lo), cast(u_hi)
        self._x_lo, self._x_hi = cast(x_lo), cast(x_hi)

        if config.use_fused_controller:
            from ..ops.controller_pallas import build_fused_controller_data
            from ..ops.tick_pallas import build_tick_data

            self._fc_data = build_fused_controller_data(
                Sx, Su, Sw, Su.T * qbar[None, :], M_inv, G, u_lo, u_hi, x_lo, x_hi,
            )
            self._tick_data = build_tick_data(self._fc_data, N, nu, nx, device=self.device)
        if config.use_fused_admm:
            f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                            device=self.device)
            self._P1_f32 = f32(GMinv @ G.T)
            self._GMinvT_f32 = f32(GMinv.T)
            self._SuT_f32 = f32(Su.T)

    # ------------------------------------------------------------------
    def init_carry(self, state: torch.Tensor | None = None) -> MPCCarry:
        N = self.config.horizon
        kw = dict(dtype=self.dtype, device=self.device)
        x0 = torch.zeros(STATE_DIM, **kw) if state is None else state.to(**kw)
        return MPCCarry(
            slack=torch.zeros(self.n_constraints, **kw),
            dual=torch.zeros(self.n_constraints, **kw),
            X_prev=x0[None, :].repeat(N + 1, 1),
            U_prev=torch.zeros(N, CONTROL_DIM, **kw),
        )

    def _shift(self, carry: MPCCarry, x0: torch.Tensor) -> MPCCarry:
        """Shift the warm start one stage forward (last stage duplicated)."""
        N = self.config.horizon

        def roll(mat):
            return torch.cat([mat[1:], mat[-1:]], dim=0)

        nu_n = N * CONTROL_DIM
        zu = roll(carry.slack[:nu_n].reshape(N, CONTROL_DIM)).reshape(-1)
        zx = roll(carry.slack[nu_n:].reshape(N, STATE_DIM)).reshape(-1)
        yu = roll(carry.dual[:nu_n].reshape(N, CONTROL_DIM)).reshape(-1)
        yx = roll(carry.dual[nu_n:].reshape(N, STATE_DIM)).reshape(-1)
        X_prev = roll(carry.X_prev)
        X_prev[0] = x0
        return MPCCarry(
            slack=torch.cat([zu, zx]),
            dual=torch.cat([yu, yx]),
            X_prev=X_prev,
            U_prev=roll(carry.U_prev),
        )

    # ------------------------------------------------------------------
    def solve(
        self,
        carry: MPCCarry,
        state: torch.Tensor,
        target_pos: torch.Tensor,
        residuals: torch.Tensor | None = None,
        reference_states: torch.Tensor | None = None,
        uncertainty: torch.Tensor | None = None,
        *,
        plain_kernels: bool = False,
    ):
        """One MPC tick. ``state``: 6-vector, ``target_pos``: 3-vector,
        ``residuals``: optional ``(N, 6)`` gain-scaled GP dynamics
        residuals, ``reference_states``: optional ``(N, 6)`` per-stage
        references (trajectory preview; overrides ``target_pos``),
        ``uncertainty``: optional ``(N, 6)`` stage-wise GP dynamics stds
        (``gp.build_horizon_uncertainty``): with ``tightening_factor`` kappa
        > 0 the state boxes shrink by ``min(kappa sqrt(Sw^2 (dt sigma)^2),
        0.45 (x_hi - x_lo))``. Returns ``(u0, X_opt, new_carry)``.

        With ``use_fused_controller`` the tick is one launch of K3, with
        ``use_fused_admm`` the ADMM loop is one launch of K6;
        ``plain_kernels=True`` runs their plain versions instead, on any
        device."""
        cfg = self.config
        tightened = uncertainty is not None and cfg.tightening_factor > 0.0
        if cfg.use_fused_controller and tightened:
            raise ValueError(
                "uncertainty tightening with use_fused_controller runs on the multi-tick "
                "kernel path; the fused controller kernel reads static bound rows"
            )
        full_f32_matmul()
        N = cfg.horizon
        x0 = state.to(self.dtype)

        carry = self._shift(carry, x0)

        if residuals is None:
            w = torch.zeros(N * STATE_DIM, dtype=self.dtype, device=self.device)
        else:
            w = (cfg.dt * residuals.to(self.dtype)).reshape(-1)

        if reference_states is not None:
            ref = reference_states.to(self.dtype).reshape(-1)
        else:
            ref = torch.cat(
                [target_pos.to(self.dtype), torch.zeros(3, dtype=self.dtype, device=self.device)]
            ).repeat(N)

        f32 = lambda v: v.to(torch.float32).contiguous()
        if cfg.use_fused_controller:
            from ..ops.controller_pallas import (
                gpmpc_controller_fused,
                gpmpc_controller_fused_plain,
            )

            controller = gpmpc_controller_fused_plain if plain_kernels else gpmpc_controller_fused
            z, y, _, X_tail = controller(
                self._tick_data, f32(x0), f32(w), f32(ref), f32(carry.slack), f32(carry.dual),
                cfg.admm_rho, cfg.admm_iterations, cfg.admm_over_relax,
            )
            slack, dual = z.to(self.dtype), y.to(self.dtype)
            U = slack[: N * CONTROL_DIM].reshape(N, CONTROL_DIM)
            X_opt = torch.cat([x0[None, :], X_tail.to(self.dtype).reshape(N, STATE_DIM)], dim=0)
            return U[0], X_opt, MPCCarry(slack=slack, dual=dual, X_prev=X_opt, U_prev=U)

        offset = self._Sx @ x0 + self._Sw @ w
        f = self._SuT_q @ (offset - ref)
        x_lo, x_hi = self._x_lo, self._x_hi
        if tightened:
            var_x = self._Sw_sq @ (cfg.dt * uncertainty.to(self.dtype).reshape(-1)) ** 2
            tight = cfg.tightening_factor * torch.sqrt(var_x)
            # never invert a box: cap at 45% of its width
            tight = torch.minimum(tight, 0.45 * (x_hi - x_lo))
            x_lo, x_hi = x_lo + tight, x_hi - tight
        lower = torch.cat([self._u_lo, x_lo - offset])
        upper = torch.cat([self._u_hi, x_hi - offset])

        p0 = -(self._GMinv @ f)
        minv_f = self._M_inv @ f
        if cfg.use_fused_admm:
            from ..ops.admm_pallas import (
                admm_box_qp_fused_composite,
                admm_box_qp_fused_composite_plain,
            )

            if plain_kernels:
                admm = admm_box_qp_fused_composite_plain
            else:
                admm = functools.partial(admm_box_qp_fused_composite, SuT=self._SuT_f32)
            Uf, zf, yf = admm(
                self._P1_f32, f32(p0), self._GMinvT_f32, f32(minv_f), f32(lower), f32(upper),
                f32(carry.slack), f32(carry.dual),
                cfg.admm_rho, cfg.admm_iterations, cfg.admm_over_relax,
            )
            sol = AdmmState(Uf.to(self.dtype), zf.to(self.dtype), yf.to(self.dtype))
        else:
            sol = admm_box_qp_composite(
                self._P1, p0, self._GMinv.T, minv_f, lower, upper,
                carry.slack, carry.dual,
                cfg.admm_rho, cfg.admm_iterations, cfg.admm_over_relax,
            )
            if cfg.polish:
                U_pol, y_pol, _ = active_set_polish(self._H, self._G, f, lower, upper, sol,
                                                    tol=cfg.polish_tol,
                                                    passes=cfg.polish_passes)
                # slack = G U_pol: G = [I; Su], so its U-block is U_pol
                sol = AdmmState(U_pol, self._G @ U_pol, y_pol)

        # controls come from the slack's U-block: box-feasible at every
        # iteration; equals the primal at convergence
        U = sol.slack[: N * CONTROL_DIM].reshape(N, CONTROL_DIM)
        X_tail = (offset + self._Su @ sol.primal).reshape(N, STATE_DIM)
        X_opt = torch.cat([x0[None, :], X_tail], dim=0)

        new_carry = MPCCarry(slack=sol.slack, dual=sol.dual, X_prev=X_opt, U_prev=U)
        return U[0], X_opt, new_carry
