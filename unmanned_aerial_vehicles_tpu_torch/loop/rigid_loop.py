"""Multi-tick closed loops of the 12-state SQP family (port of
``loop/rigid_loop.py``).

The per-tick SQP engine (``control.mpc_sqp``) relinearises, condenses and
factors every tick. Here the linearisation anchors to the warm-start plan
for K consecutive ticks, so every matrix is a per-dispatch constant:

* per dispatch: one vmapped ``jacfwd``, one condensation
  (``ops.qp.condense_ltv_doubling``), one Ruiz equilibration, Cholesky
  factor and the explicit ``M^-1``, ``GMinvT_s = M^-1 Gs'`` and ``P1 = Gs
  M^-1 Gs'``: plain large products in PyTorch on the engine's device, in
  full float32 where the engine is float32 (no TF32);
* per tick: the warm-start shift, two small matvecs (offset and linear
  cost), the composite ADMM (one (m, m) matvec with ``P1`` per iteration;
  kernel K11 applies it as its rank-``N nu`` factors ``Gs`` and
  ``GMinvT_s``) and the true **nonlinear** plant step.

The equilibration scalars (d, e) are fixed across the dispatch, so the
ADMM duals warm-start across ticks in the same scaled space.

``sqp_multitick_rollout`` runs the tick in PyTorch, with any plant step
(``ops.rigid_plant_pallas.rigid_body_rk4_step_fast`` runs the rigid body
through kernel K10 on the card); ``sqp_multitick_population`` flies a
population of members, each on its own true plant
(``loop.monte_carlo.monte_carlo_mpc12``: one launch of K10 a tick for all
members). ``direct_rate_multitick_fused`` and ``rigid_multitick_fused`` run K whole ticks per launch of kernel K11
(``ops.rigid_tick_pallas``), with the direct-rate model or the torque-input
rigid body as the in-kernel plant. ``ilqr_multitick_rollout`` is the iLQR
engine's policy tier: one full solve per dispatch, then the solve's own
time-varying LQR policy per tick.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .._device import full_f32_matmul
from ..control.ilqr import ILQRCarry, ILQRRigidBodyMPC, ilqr_solve
from ..control.mpc_sqp import QuadCost, SQPMPC, linearize, obstacle_normals, ruiz_scaling
from ..models.params import X500_PARAMS, RigidBodyParams
from ..ops.qp import admm_box_qp_composite, condense_ltv_doubling, roll_block
from ..ops.rigid_tick_pallas import (
    RigidTickOperands,
    direct_rate_multitick_kernel,
    direct_rate_multitick_plain,
)


def make_attitude_recovery_fallback(params: RigidBodyParams, tilt_limit: float = 0.9,
                                    kp: float = 0.05, kd: float = 0.02, tau_max: float = 0.1,
                                    thrust_max: float | None = None):
    """Per-tick emergency-recovery law for the torque-input 12-state engines
    (``u = [T, tau_x, tau_y, tau_z]``): where the controls or the state are
    not finite, or |roll| or |pitch| exceeds ``tilt_limit``, fly a PD
    level-off (gravity-compensating thrust ``mg / cos(tilt)``, optionally
    clamped to ``thrust_max``, attitude PD with rate damping, torques within
    ``tau_max``). Returns ``fb(x, u0) -> (u_applied, bad)``; ``x (..., 12)``
    and ``u0 (..., 4)`` may carry a leading member axis, and ``bad (...)``
    is decided per member. ``sqp_multitick_rollout`` also resets the ADMM
    slack and duals on the ticks where it engages."""
    mg = params.mass * params.gravity

    def fb(x, u0):
        # reduced over each member's own state and controls: x (..., 12),
        # u0 (..., 4), bad (...), so one bad member of a population leaves
        # the others alone
        bad = (~torch.isfinite(u0).all(dim=-1) | ~torch.isfinite(x).all(dim=-1)
               | (x[..., 6].abs() > tilt_limit) | (x[..., 7].abs() > tilt_limit))
        cos_t = torch.clamp(torch.cos(x[..., 6]) * torch.cos(x[..., 7]), 0.3, 1.0)
        thrust = mg / cos_t
        if thrust_max is not None:
            thrust = torch.clamp(thrust, max=thrust_max)
        tau_rp = -kp * x[..., 6:8] - kd * x[..., 9:11]
        tau_y = -kd * x[..., 11]
        tau = torch.clamp(torch.cat([tau_rp, tau_y[..., None]], dim=-1), -tau_max, tau_max)
        u_safe = torch.cat([thrust[..., None], tau], dim=-1).to(u0.dtype)
        return torch.where(bad[..., None], u_safe, u0), bad

    return fb


class MultiTickCarry(NamedTuple):
    state: torch.Tensor     # (nx,) plant state (the true nonlinear state)
    X_plan: torch.Tensor    # (N+1, nx) warm-start plan (linearisation anchor)
    U_plan: torch.Tensor    # (N, nu)
    z: torch.Tensor         # (m,) ADMM slack, unequilibrated space
    y: torch.Tensor         # (m,) ADMM dual, unequilibrated space


class _Dispatch(NamedTuple):
    """One dispatch's relinearisation, equilibrated where it says so."""

    Sx: torch.Tensor
    Su: torch.Tensor
    Sc: torch.Tensor
    SuT_q: torch.Tensor      # Su' diag(qbar)
    d: torch.Tensor          # Ruiz column scaling
    e: torch.Tensor          # Ruiz row scaling
    Minv_s: torch.Tensor     # (Hs + rho Gs'Gs)^-1
    Gs: torch.Tensor         # diag(e) G diag(d), G = [I; Su] (and the obstacle rows)
    GMinvT_s: torch.Tensor   # M^-1 Gs'
    P1: torch.Tensor | None  # Gs M^-1 Gs' (None where nothing reads it)
    n_vec: torch.Tensor | None        # obstacle normals (N, n_obs, 3)
    lo_obs_base: torch.Tensor | None  # obstacle bounds without the offset term


def _relinearize(mpc: SQPMPC, X_bar, U_bar, residuals, qbar, rbar, obstacles=None,
                 with_p1: bool = True) -> _Dispatch:
    """Linearise about ``(X_bar, U_bar)``, condense by doubling, add the
    obstacle rows (normals anchored to ``X_bar``), equilibrate, factor and
    compose the ADMM operators (``P1`` only ``with_p1``)."""
    N, nx, nu = mpc.config.horizon, mpc.nx, mpc.nu
    A, B, c = linearize(mpc.step_fn, X_bar, U_bar, residuals)
    Sx, Su, Sc = condense_ltv_doubling(A, B, c)
    SuT_q = Su.T * qbar[None, :]
    H = SuT_q @ Su + torch.diag(rbar)
    G = torch.cat([torch.eye(N * nu, dtype=mpc.dtype, device=mpc.device), Su])
    n_vec = lo_obs_base = None
    if obstacles is not None:
        Su3 = Su.reshape(N, nx, N * nu)[:, 0:3, :]
        n_vec = obstacle_normals(X_bar, obstacles)
        rows = torch.einsum("nkj,njp->nkp", n_vec, Su3)
        # bound = r + margin + n'obs - n'offset: the offset term per tick
        lo_obs_base = (obstacles[None, :, 3] + mpc.obstacle_margin
                       + torch.einsum("nkj,kj->nk", n_vec, obstacles[:, 0:3])).reshape(-1)
        G = torch.cat([G, rows.reshape(-1, N * nu)])
    d, e, Hs, Gs = ruiz_scaling(H, G)
    L = torch.linalg.cholesky(Hs + mpc.config.admm_rho * (Gs.T @ Gs))
    # the explicit inverse once per dispatch makes every per-tick solve a
    # plain matvec
    Minv_s = torch.cholesky_solve(torch.eye(Hs.shape[0], dtype=mpc.dtype, device=mpc.device), L)
    GMinvT_s = Minv_s @ Gs.T
    P1 = Gs @ GMinvT_s if with_p1 else None
    return _Dispatch(Sx, Su, Sc, SuT_q, d, e, Minv_s, Gs, GMinvT_s, P1, n_vec, lo_obs_base)


def _initial_carry(mpc: SQPMPC, cost: QuadCost, x0, u_init, m: int) -> MultiTickCarry:
    N = mpc.config.horizon
    kw = dict(dtype=mpc.dtype, device=mpc.device)
    x = x0.to(**kw)
    u = (cost.u_ref if u_init is None else u_init).to(**kw)
    return MultiTickCarry(state=x, X_plan=x[None, :].repeat(N + 1, 1),
                          U_plan=u[None, :].repeat(N, 1),
                          z=torch.zeros(m, **kw), y=torch.zeros(m, **kw))


def _plan_tail(mpc: SQPMPC, disp: _Dispatch, x_fin, U_fin, residuals, plan_roll: str,
               plan_roll_fn=None):
    """The next dispatch's anchor after ``x_fin``: ``plan_roll_fn``, the
    dispatch's own LTV prediction (``"linear"``), or the nonlinear roll of
    ``mpc.step_fn``."""
    if plan_roll_fn is not None:
        tail = plan_roll_fn(x_fin, U_fin, residuals)
    elif plan_roll == "linear":
        tail = (disp.Sx @ x_fin + disp.Su @ U_fin.reshape(-1) + disp.Sc).reshape(-1, mpc.nx)
    else:
        tail = mpc.rollout(x_fin, U_fin, residuals)[1:]
    return torch.cat([x_fin[None, :], tail.to(x_fin.dtype)])


def _stack(states, controls, carry, dim: int = 0) -> dict:
    return {"state": torch.stack(states, dim), "u": torch.stack(controls, dim), "carry": carry}


def _sqp_tick(mpc: SQPMPC, disp: _Dispatch, x, z, y, ref, rbar, u_ref_flat, big,
              admm_iterations: int):
    """One tick of the multi-tick SQP tier: the warm-start shift, the
    offset, linear cost and bounds (the obstacle rows' too), and the
    composite ADMM in the dispatch's equilibrated space. Returns the new
    ``(z, y)`` in the unequilibrated space."""
    cfg = mpc.config
    N, nx = cfg.horizon, mpc.nx
    z, y = mpc.shift_blocks(z), mpc.shift_blocks(y)
    offset = disp.Sx @ x + disp.Sc
    f = disp.SuT_q @ (offset - ref.reshape(-1)) - rbar * u_ref_flat
    lower = torch.cat([mpc._u_lo, mpc._x_lo - offset])
    upper = torch.cat([mpc._u_hi, mpc._x_hi - offset])
    if mpc.num_obstacles:
        off3 = offset.reshape(N, nx)[:, 0:3]
        lo_obs = disp.lo_obs_base - torch.einsum("nkj,nj->nk", disp.n_vec, off3).reshape(-1)
        lower = torch.cat([lower, lo_obs])
        upper = torch.cat([upper, big])
    fs = f * disp.d
    sol = admm_box_qp_composite(disp.P1, -(disp.GMinvT_s.T @ fs), disp.GMinvT_s,
                                disp.Minv_s @ fs, lower * disp.e, upper * disp.e,
                                z * disp.e, y / disp.e, cfg.admm_rho, admm_iterations,
                                cfg.admm_over_relax)
    return sol.slack / disp.e, sol.dual * disp.e


def sqp_multitick_rollout(
    mpc: SQPMPC,
    cost: QuadCost,
    reference_fn: Callable,      # tick indices (K,) -> (K, N, nx) stage references
    plant_step: Callable,        # (x, u) -> x_next, the true plant
    x0: torch.Tensor,
    num_steps: int,
    ticks_per_dispatch: int = 8,
    admm_iterations: int = 30,
    residuals: torch.Tensor | None = None,
    u_init: torch.Tensor | None = None,
    obstacles: torch.Tensor | None = None,
    plan_roll: str = "nonlinear",
    plan_roll_fn: Callable | None = None,
    fallback_fn: Callable | None = None,
) -> dict:
    """Closed-loop rollout of an ``SQPMPC`` engine at dispatch granularity,
    on the engine's device and in its dtype.

    ``reference_fn(ticks)`` maps an int64 tensor of tick indices ``(K,)`` to
    each tick's per-stage state references ``(K, N, nx)``. Returns
    ``{"state": (T, nx) pre-plant, "u": (T, nu) applied, "carry":
    MultiTickCarry}``.

    ``obstacles (n_obs, 4)`` ``[x, y, z, r]`` need an engine built with
    ``num_obstacles > 0``: the half-space rows' normals anchor to the
    dispatch's warm-start plan, their bounds follow the per-tick offset.
    ``plan_roll`` re-anchors the plan after the K ticks by the nonlinear
    roll of ``mpc.step_fn`` (``"nonlinear"``) or the dispatch's own LTV
    prediction (``"linear"``); ``plan_roll_fn(x_fin, U_fin, residuals) ->
    (N, nx)`` overrides both (e.g. ``ops.rigid_plant_pallas.
    rigid_body_rollout_fused``, kernel K10). ``fallback_fn(x, u0) ->
    (u_applied, bad)`` is a per-tick emergency guard
    (``make_attitude_recovery_fallback``); on the ticks where it engages the
    ADMM slack and duals reset to zero."""
    if plan_roll not in ("nonlinear", "linear"):
        raise ValueError(f"unknown plan_roll mode: {plan_roll!r}")
    cfg = mpc.config
    N, nx, nu = cfg.horizon, mpc.nx, mpc.nu
    n_obs = mpc.num_obstacles
    if obstacles is not None and not n_obs:
        raise ValueError("obstacles passed but the engine was built with num_obstacles=0")
    K = ticks_per_dispatch
    if num_steps % K:
        raise ValueError(f"num_steps={num_steps} not a multiple of K={K}")
    full_f32_matmul()
    dtype, dev = mpc.dtype, mpc.device
    residuals, obstacles = mpc.defaults(residuals, obstacles)
    qbar, rbar, u_ref_flat = mpc.horizon_weights(cost)
    big = torch.full((N * n_obs,), 1e9, dtype=dtype, device=dev)
    carry = _initial_carry(mpc, cost, x0, u_init, N * (nu + nx + n_obs))
    states, controls = [], []
    for tick0 in range(0, num_steps, K):
        X_bar = carry.X_plan.clone()
        X_bar[0] = carry.state
        disp = _relinearize(mpc, X_bar, carry.U_plan, residuals, qbar, rbar, obstacles)
        refs = reference_fn(torch.arange(tick0, tick0 + K, device=dev)).to(dtype)
        x, U, z, y = carry.state, carry.U_plan, carry.z, carry.y
        for k in range(K):
            z, y = _sqp_tick(mpc, disp, x, z, y, refs[k], rbar, u_ref_flat, big,
                             admm_iterations)
            U = z[: N * nu].reshape(N, nu)
            u0 = U[0]
            if fallback_fn is not None:
                u0, bad = fallback_fn(x, u0)
                z = torch.where(bad, torch.zeros_like(z), z)
                y = torch.where(bad, torch.zeros_like(y), y)
            states.append(x)
            controls.append(u0)
            x = plant_step(x, u0)
        X_plan = _plan_tail(mpc, disp, x, U, residuals, plan_roll, plan_roll_fn)
        carry = MultiTickCarry(x, X_plan, U, z, y)
    return _stack(states, controls, carry)


def sqp_multitick_population(
    mpc: SQPMPC,
    cost: QuadCost,
    reference_fn: Callable,      # tick indices (K,) -> (K, N, nx) stage references
    plant_step: Callable,        # (x (B, nx), u (B, nu)) -> (B, nx), each member's true plant
    x0: torch.Tensor,            # (B, nx)
    num_steps: int,
    ticks_per_dispatch: int = 8,
    admm_iterations: int = 30,
    u_init: torch.Tensor | None = None,
    fallback_fn: Callable | None = None,
) -> dict:
    """``sqp_multitick_rollout`` for a population of B members that share
    the engine and the reference, each from its own start and on its own
    true plant (``plant_step`` steps all members at once: kernel K10 with a
    body per member in ``loop.monte_carlo.monte_carlo_mpc12``). Per
    dispatch each member's relinearisation about its own plan (the one-
    member code mapped over the members with ``torch.func.vmap``: batched
    ``jacfwd``, condensation, Ruiz, Cholesky, ``M^-1`` and P1); per tick the
    composite ADMM of every member as one batched solve, then
    ``fallback_fn(x (B, nx), u0 (B, nu)) -> (u, bad (B,))`` decided per
    member (its slack and duals reset where it engages), then the plants.
    The plan re-anchors by the nonlinear roll of ``mpc.step_fn``. The
    engine must have no obstacle rows. Returns ``{"state": (B, T, nx)
    pre-plant, "u": (B, T, nu) applied, "carry": MultiTickCarry}`` with a
    leading member axis on every carry field."""
    cfg = mpc.config
    N, nx, nu = cfg.horizon, mpc.nx, mpc.nu
    if mpc.num_obstacles:
        raise ValueError("the population runs engines without obstacle rows")
    K = ticks_per_dispatch
    if num_steps % K:
        raise ValueError(f"num_steps={num_steps} not a multiple of K={K}")
    full_f32_matmul()
    dtype, dev = mpc.dtype, mpc.device
    residuals, _ = mpc.defaults(None, None)
    qbar, rbar, u_ref_flat = mpc.horizon_weights(cost)
    x = x0.to(dtype=dtype, device=dev)
    B, m = x.shape[0], N * (nu + nx)
    u = (cost.u_ref if u_init is None else u_init).to(dtype=dtype, device=dev)
    X_plan = x[:, None, :].repeat(1, N + 1, 1)
    U = u.expand(B, N, nu).clone()
    z = torch.zeros(B, m, dtype=dtype, device=dev)
    y = torch.zeros(B, m, dtype=dtype, device=dev)
    # the dispatch's tensors without the obstacle fields, which vmap cannot map
    fields = _Dispatch._fields[:10]
    as_dispatch = lambda t: _Dispatch(*t, n_vec=None, lo_obs_base=None)
    relinearize = torch.func.vmap(
        lambda Xb, Ub: tuple(_relinearize(mpc, Xb, Ub, residuals, qbar, rbar)[:len(fields)]))
    tick = torch.func.vmap(
        lambda d, xb, zb, yb, ref: _sqp_tick(mpc, as_dispatch(d), xb, zb, yb, ref, rbar,
                                             u_ref_flat, None, admm_iterations),
        in_dims=(0, 0, 0, 0, None))
    roll = torch.func.vmap(lambda d, xb, Ub: _plan_tail(mpc, as_dispatch(d), xb, Ub, residuals,
                                                        "nonlinear"))
    states, controls = [], []
    for tick0 in range(0, num_steps, K):
        X_bar = X_plan.clone()
        X_bar[:, 0] = x
        disp = relinearize(X_bar, U)
        refs = reference_fn(torch.arange(tick0, tick0 + K, device=dev)).to(dtype)
        for k in range(K):
            z, y = tick(disp, x, z, y, refs[k])
            U = z[:, : N * nu].reshape(B, N, nu)
            u0 = U[:, 0]
            if fallback_fn is not None:
                u0, bad = fallback_fn(x, u0)
                z = torch.where(bad[:, None], torch.zeros_like(z), z)
                y = torch.where(bad[:, None], torch.zeros_like(y), y)
            states.append(x)
            controls.append(u0)
            x = plant_step(x, u0)
        X_plan = roll(disp, x, U)
    return _stack(states, controls, MultiTickCarry(x, X_plan, U, z, y), dim=1)


def dispatch_tick_operands(mpc: SQPMPC, cost: QuadCost, X_bar: torch.Tensor, U_bar: torch.Tensor,
                           residuals: torch.Tensor | None = None, with_p1: bool = True
                           ) -> tuple[_Dispatch, RigidTickOperands]:
    """One dispatch of the fused tier: the relinearisation about the plan
    ``(X_bar (N+1, nx), U_bar (N, nu))`` and K11's operands from it, with
    the equilibration's per-lane shift correction ``e / blockroll(e)`` and
    its inverse beside the scalings. The ADMM operator comes as its factors
    ``Gs``, ``GMinvT_s`` (the kernel's) and, ``with_p1``, as ``P1 = Gs @
    GMinvT_s`` (the plain version's; ``None`` otherwise)."""
    full_f32_matmul()
    N, Nnu = mpc.config.horizon, mpc.config.horizon * mpc.nu
    residuals, _ = mpc.defaults(residuals, None)
    qbar, rbar, u_ref_flat = mpc.horizon_weights(cost)
    disp = _relinearize(mpc, X_bar, U_bar, residuals, qbar, rbar, with_p1=with_p1)
    e = disp.e
    e_shift = torch.cat([roll_block(e[:Nnu], N), roll_block(e[Nnu:], N)])
    return disp, RigidTickOperands(
        Sx=disp.Sx.contiguous(), Sc=disp.Sc.contiguous(), SuT_q=disp.SuT_q.contiguous(),
        f0=-rbar * u_ref_flat, GMinvT_s=disp.GMinvT_s.contiguous(), Gs=disp.Gs.contiguous(),
        P1=None if disp.P1 is None else disp.P1.contiguous(),
        d=disp.d, e=e, ie=1.0 / e, ce=e / e_shift, ice=e_shift / e,
        lo=torch.cat([mpc._u_lo, mpc._x_lo]), hi=torch.cat([mpc._u_hi, mpc._x_hi]))


def direct_rate_multitick_fused(
    mpc: SQPMPC,
    cost: QuadCost,
    reference_fn: Callable,
    x0: torch.Tensor,
    num_steps: int,
    ticks_per_dispatch: int = 8,
    admm_iterations: int = 30,
    residuals: torch.Tensor | None = None,
    u_init: torch.Tensor | None = None,
    dt: float = 0.02,
    substeps: int = 1,
    gravity: float = 9.81,
    taus: tuple = (0.05, 0.05, 0.08),
    plan_roll: str = "nonlinear",
    plant: str = "direct_rate",
    body: RigidBodyParams | None = None,
    plain_kernels: bool = False,
) -> dict:
    """``sqp_multitick_rollout`` for the direct-rate engine with the
    per-tick chain (warm-start shift, condensed gradient and bounds,
    composite ADMM, plant) in kernel K11, K ticks per launch; the
    relinearisation stays in PyTorch, once per dispatch. The slack and dual
    live in the dispatch's equilibrated space inside the kernel, with the
    per-lane shift correction ``e / blockroll(e)``.

    The in-kernel plant is the direct-rate model with zero residual
    (``control.mpc_rigid.direct_rate_step``), or with ``plant="rigid"`` RK4
    substeps of the torque-input rigid body of ``body`` (see
    ``rigid_multitick_fused``); ``residuals`` only enter the controller's
    linearisation. The engine must be float32. ``plain_kernels=True`` runs
    K11's plain version instead, on any device; on the CPU the wrapper runs
    it anyway. Returns what ``sqp_multitick_rollout`` returns."""
    cfg = mpc.config
    N, nx, nu = cfg.horizon, mpc.nx, mpc.nu
    if mpc.dtype != torch.float32:
        raise ValueError(f"the fused direct-rate tier is f32-only (engine dtype {mpc.dtype})")
    if mpc.num_obstacles:
        raise ValueError("the fused direct-rate tier has no obstacle rows; "
                         "use sqp_multitick_rollout")
    if plan_roll not in ("nonlinear", "linear"):
        raise ValueError(f"unknown plan_roll mode: {plan_roll!r}")
    if plant == "rigid":
        if body is None:
            raise ValueError('plant="rigid" requires body=RigidBodyParams')
        gravity = float(body.gravity)
    elif plant != "direct_rate":
        raise ValueError(f"unknown in-kernel plant: {plant!r}")
    K = ticks_per_dispatch
    if num_steps % K:
        raise ValueError(f"num_steps={num_steps} not a multiple of K={K}")
    dev = mpc.device
    Nnu, Nnx = N * nu, N * nx
    residuals, _ = mpc.defaults(residuals, None)
    tick = direct_rate_multitick_plain if plain_kernels else direct_rate_multitick_kernel
    # only the plain version (which CPU tensors take) reads P1
    with_p1 = plain_kernels or torch.device(dev).type != "cuda"
    statics = dict(k_ticks=K, n=N, nu=nu, nx=nx, iterations=admm_iterations,
                   over_relax=float(cfg.admm_over_relax), rho=float(cfg.admm_rho), dt=dt,
                   substeps=substeps, gravity=gravity, taus=taus, plant=plant, body=body)
    carry = _initial_carry(mpc, cost, x0, u_init, Nnu + Nnx)
    states, controls = [], []
    for tick0 in range(0, num_steps, K):
        X_bar = carry.X_plan.clone()
        X_bar[0] = carry.state
        disp, ops = dispatch_tick_operands(mpc, cost, X_bar, carry.U_plan, residuals, with_p1)
        refs = reference_fn(torch.arange(tick0, tick0 + K, device=dev))
        refs = refs.to(torch.float32).reshape(K, Nnx).contiguous()
        out, x_fin, z_fin, y_fin = tick(carry.state, carry.z * ops.e, carry.y / ops.e, refs, ops,
                                        **statics)
        z, y = z_fin * ops.ie, y_fin * ops.e
        U = z[:Nnu].reshape(N, nu)
        states.extend(out[:, 0:nx])
        controls.extend(out[:, nx:nx + nu])
        X_plan = _plan_tail(mpc, disp, x_fin, U, residuals, plan_roll)
        carry = MultiTickCarry(x_fin, X_plan, U, z, y)
    return _stack(states, controls, carry)


def rigid_multitick_fused(mpc: SQPMPC, cost: QuadCost, reference_fn: Callable, x0: torch.Tensor,
                          num_steps: int, body: RigidBodyParams | None = None, **kwargs) -> dict:
    """The whole-tick-in-kernel tier for the torque-input SQP family
    (``control.mpc_rigid.RigidBodyMPC``): ``direct_rate_multitick_fused``
    with RK4 substeps of the rigid body of ``body`` (default
    ``X500_PARAMS``) as K11's plant (``csrc/rigid_math.cuh``, K10's
    math)."""
    return direct_rate_multitick_fused(mpc, cost, reference_fn, x0, num_steps, plant="rigid",
                                       body=X500_PARAMS if body is None else body, **kwargs)


def ilqr_multitick_rollout(
    eng: ILQRRigidBodyMPC,
    position_ref_fn: Callable,   # tick indices (K,) -> (K, 3) positions
    plant_step: Callable,        # (x, u) -> x_next, the true plant
    x0: torch.Tensor,
    num_steps: int,
    ticks_per_dispatch: int = 2,
) -> dict:
    """iLQR at dispatch granularity: one full solve per K ticks, then the
    solve's own time-varying LQR policy per tick.

    Per dispatch: the fixed-iteration ``ilqr_solve`` from the current state
    against the mid-dispatch target ``pos_refs[K // 2]`` (the solve holds a
    constant target; centring it halves the lag the reference's motion over
    K ticks would bias in), warm-started by the previous plan shifted one
    stage. Per tick: ``u_k = clip(U[k] - K_k (x - X[k]))`` (the ``u = -Kx -
    d`` convention of ``ops.riccati``) and one ``plant_step``. The plan is
    then shifted by K. ``position_ref_fn`` maps an int64 tensor of tick
    indices on the engine's device to ``(K, 3)`` positions. Returns
    ``{"state": (T, 12) pre-plant, "u": (T, 4) applied, "carry":
    ILQRCarry}``."""
    K = ticks_per_dispatch
    if num_steps % K:
        raise ValueError(f"num_steps={num_steps} not a multiple of K={K}")
    full_f32_matmul()
    N, dtype, dev = eng.N, eng.dtype, eng.device
    u_ref = eng.u_hover[None, :].repeat(N, 1)
    x = x0.to(dtype=dtype, device=dev)
    U_prev = eng.u_hover[None, :].repeat(N, 1)
    states, controls = [], []
    for tick0 in range(0, num_steps, K):
        pos_refs = position_ref_fn(torch.arange(tick0, tick0 + K, device=dev)).to(dtype)
        x_ref_stage = torch.cat([pos_refs[K // 2], torch.zeros(9, dtype=dtype, device=dev)])
        x_ref = x_ref_stage[None, :].repeat(N + 1, 1)
        U0 = torch.cat([U_prev[1:], U_prev[-1:]])
        sol = ilqr_solve(eng.step_fn, x, U0, eng.q_diag, eng.r_diag, x_ref, u_ref,
                         iterations=eng.iterations, reg=eng.reg, u_lower=eng.u_lower,
                         u_upper=eng.u_upper, parallel=eng.parallel,
                         rollout_fn=eng.rollout_fn)
        for k in range(K):
            u = sol.U[k] - sol.gains[k] @ (x - sol.X[k])
            u = torch.minimum(torch.maximum(u, eng.u_lower), eng.u_upper)
            states.append(x)
            controls.append(u)
            x = plant_step(x, u)
        U_prev = torch.cat([sol.U[K:], sol.U[-1:].repeat(K, 1)])
    return _stack(states, controls, ILQRCarry(U_prev=U_prev))
