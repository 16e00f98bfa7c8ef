"""Differentiable closed-loop controller auto-tuning (port of
``tuning/autotune.py``).

A whole flight is a differentiable function of the controller's gains, so
tuning becomes gradient descent through the closed loop, plant included:

* ``tune_cascade_gains`` tunes the 27 kp/ki/kd gains of the 9-loop cascade
  PID (log-space parameters keep them positive; the safety limits stay
  fixed);
* ``tune_mpc_weights`` tunes the linear MPC's Q/R/terminal weights through
  the GP-MPC tick (condensed QP, ADMM, allocation, plant). The ADMM loop has
  a fixed iteration count, so reverse mode through the solver is exact; the
  condensed QP is rebuilt from the weight tensors (``_TracedWeightMPC``,
  ``ops.qp.admm_box_qp_chol``).

Where a flight's loop config puts a kernel on the loss's path
(``use_pallas_plant``, ``use_fused_tick``), the tuners fly it with
``fused_tick_ad=True``: the forward pass is the kernel that flies (K1, K2 or
K5) and the backward its VJP (``ops.tick_ad``). In the JAX package each
tuning run is one jitted scan; here it is a Python loop of
``torch.optim.Adam`` steps, each one value-and-gradient of a whole flight;
the multi-start flies all its starts as one batch and steps them with one
Adam.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..control.cascade_pid import CascadePidGains
from ..control.mpc_linear import LinearMPC, LinearMPCConfig, MPCCarry
from ..loop.closed_loop import (
    FlightLoopConfig,
    batched_pid_flight_rollout,
    mpc_flight_rollout,
    pid_flight_rollout,
)
from ..models.double_integrator import CONTROL_DIM, STATE_DIM
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams
from ..ops.qp import admm_box_qp_chol, condense_dynamics
from ..ops.tick_pallas import guarded_sqrt

_f32 = torch.float32


class TuningResult(NamedTuple):
    params: object              # tuned gains (CascadePidGains) or the weight dict
    losses: torch.Tensor        # (iterations,) loss trace
    initial_loss: torch.Tensor
    final_loss: torch.Tensor    # the best loss seen


@dataclass(frozen=True)
class TuneConfig:
    iterations: int = 60
    learning_rate: float = 0.05
    # loss = mean squared tracking error after the take-off/ramp transient
    # + effort_weight * mean squared rate command
    settle_steps: int = 250           # 5 s at 50 Hz (the reference tanh ramp)
    effort_weight: float = 1e-3


# ---------------------------------------------------------------------------
# generic optimiser loop (used by both tuners)
# ---------------------------------------------------------------------------


def tune_parameters(
    loss_fn: Callable,
    init_params: dict,
    iterations: int,
    learning_rate: float = 0.05,
    optimizer: Callable | None = None,
):
    """``iterations`` optimiser steps of ``loss_fn`` over the dict of tensors
    ``init_params``; returns ``(best params, loss trace (iterations,),
    best loss)``.

    ``optimizer`` is a factory ``list of parameters -> torch.optim.Optimizer``
    (default Adam at ``learning_rate``, betas (0.9, 0.999), eps 1e-8: the
    update of ``optax.adam``). As in the JAX package: non-finite gradients
    are zeroed, the best-seen parameters are those that produced the best
    loss (taken before the step that follows it), and one final evaluation
    lets the last iterate compete. One run of ``_tune_stacked``."""
    params, trace, best = _tune_stacked(
        lambda p: loss_fn({k: v[0] for k, v in p.items()})[None],
        {k: v[None] for k, v in init_params.items()}, iterations, learning_rate, optimizer)
    return {k: v[0] for k, v in params.items()}, trace[:, 0], best[0]


def _tune_stacked(loss_fn: Callable, init_params: dict, iterations: int,
                  learning_rate: float = 0.05, optimizer: Callable | None = None):
    """``tune_parameters`` for S independent runs stacked on a leading axis
    of every tensor in ``init_params``: ``loss_fn`` returns the ``(S,)``
    losses, one optimiser steps the stacked tensors (Adam is elementwise,
    so it is one Adam per run), and the non-finite gradients, the best-seen
    parameters and loss, and the final iterate's comparison are each run's
    own (``torch.where`` over the run axis), as the JAX package's ``vmap``
    of ``tune_parameters``. Returns ``(best params (S, ...), loss trace
    (iterations, S), best loss (S,))``; no value is read on the host."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in init_params.items()}
    leaves = list(params.values())
    opt = (optimizer(leaves) if optimizer is not None
           else torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8))
    best_params = {k: v.detach().clone() for k, v in params.items()}
    best_loss = None
    per_run = lambda mask, v: mask.reshape(-1, *([1] * (v.ndim - 1)))

    def keep_better(loss):
        nonlocal best_loss
        if best_loss is None:
            best_loss = torch.full_like(loss, math.inf)
        better = torch.isfinite(loss) & (loss < best_loss)
        for k, v in params.items():
            best_params[k] = torch.where(per_run(better, v), v.detach(), best_params[k])
        best_loss = torch.where(better, loss, best_loss)

    losses = []
    for _ in range(iterations):
        loss = loss_fn(params)
        # the runs are independent: the sum's gradient is each run's own
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                # a diverging candidate must not poison the run
                p.grad = (torch.zeros_like(p) if g is None
                          else torch.where(torch.isfinite(g), g, torch.zeros_like(g)))
        loss = loss.detach()
        keep_better(loss)
        opt.step()
        losses.append(loss)
    with torch.no_grad():
        final_loss = loss_fn(params).detach()
    keep_better(final_loss)
    trace = (torch.stack(losses) if losses
             else torch.empty(0, *final_loss.shape, dtype=final_loss.dtype))
    return best_params, trace, best_loss


def _tracking_loss(outs, settle_steps: int, effort_weight: float):
    err = outs["state"][:, 0:3] - outs["pos_ref"]
    err = err[settle_steps:]
    mse = torch.mean(torch.sum(err**2, dim=-1))
    effort = torch.mean(outs["rates_cmd"][settle_steps:] ** 2)
    return mse + effort_weight * effort


def _differentiable(loop_cfg: FlightLoopConfig) -> FlightLoopConfig:
    """The loop config with the kernels' autodiff routes on wherever a kernel
    is on the flight's path."""
    if (loop_cfg.use_pallas_plant or loop_cfg.use_fused_tick) and not loop_cfg.fused_tick_ad:
        return replace(loop_cfg, fused_tick_ad=True)
    return loop_cfg


# ---------------------------------------------------------------------------
# cascade-PID gain tuning
# ---------------------------------------------------------------------------

_LAYERS = ("position", "velocity", "attitude")


def _f32_gains(gains: CascadePidGains, device) -> CascadePidGains:
    """The gains' tensors as float32 on ``device`` (the float limits stay)."""
    cast = lambda pid: pid._replace(**{k: torch.as_tensor(v, device=device).to(_f32)
                                       for k, v in pid._asdict().items()})
    return gains._replace(**{layer: cast(getattr(gains, layer)) for layer in _LAYERS})


def _cascade_theta(gains: CascadePidGains) -> dict:
    """Log-space copies of the tunable leaves (kp/ki/kd per layer)."""
    out = {}
    for layer in _LAYERS:
        pid = getattr(gains, layer)
        for k in ("kp", "ki", "kd"):
            out[f"{layer}_{k}"] = torch.log(torch.clamp(getattr(pid, k).to(_f32), min=1e-6))
    return out


def _cascade_gains(theta: dict, template: CascadePidGains) -> CascadePidGains:
    """Gains from log-parameters, keeping the template's safety limits
    (max_output, max_integral, the thrust and rate clips) fixed."""
    layers = {
        layer: getattr(template, layer)._replace(
            kp=torch.exp(theta[f"{layer}_kp"]),
            ki=torch.exp(theta[f"{layer}_ki"]),
            kd=torch.exp(theta[f"{layer}_kd"]),
        )
        for layer in _LAYERS
    }
    return template._replace(**layers)


def _cascade_loss_fn(reference_fn, num_steps, template, tune_cfg, body, rate_loop, loop_cfg,
                     dev, plain_kernels):
    loop_cfg = _differentiable(loop_cfg)

    def loss_fn(theta):
        outs = pid_flight_rollout(
            reference_fn, num_steps, gains=_cascade_gains(theta, template), body=body,
            rate_loop=rate_loop, cfg=loop_cfg, device=dev, plain_kernels=plain_kernels,
        )
        return _tracking_loss(outs, tune_cfg.settle_steps, tune_cfg.effort_weight)

    return loss_fn


def tune_cascade_gains(
    reference_fn: Callable,
    num_steps: int,
    init_gains: CascadePidGains | None = None,
    tune_cfg: TuneConfig = TuneConfig(),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
    device=None,
    plain_kernels: bool = False,
) -> TuningResult:
    """Gradient-descend the cascade's 27 PID gains through a full flight.

    ``reference_fn(t (T,)) -> (pos (T, 3), yaw (T,))`` as in
    ``pid_flight_rollout``. With ``loop_cfg.use_pallas_plant`` every tick's
    plant runs as K1 forward and K13a backward (``plain_kernels=True``:
    autograd through K1's plain version instead, on any device)."""
    dev = resolve_device(device)
    template = _f32_gains(init_gains if init_gains is not None
                          else CascadePidGains.default(device=dev), dev)
    loss_fn = _cascade_loss_fn(reference_fn, num_steps, template, tune_cfg, body, rate_loop,
                               loop_cfg, dev, plain_kernels)
    theta0 = _cascade_theta(template)
    with torch.no_grad():
        initial_loss = loss_fn(theta0)
    theta, losses, final_loss = tune_parameters(loss_fn, theta0, tune_cfg.iterations,
                                                tune_cfg.learning_rate)
    return TuningResult(params=_cascade_gains(theta, template), losses=losses,
                        initial_loss=initial_loss, final_loss=final_loss)


def _multistart_thetas(theta0: dict, n_starts: int, jitter: float, seed: int) -> dict:
    """The starts stacked on a leading axis: start 0 is ``theta0``, start i
    ``theta0`` plus log-space Gaussian jitter drawn from
    ``torch.Generator().manual_seed(seed)`` (one draw of every leaf per
    start, in order)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    starts = []
    for i in range(n_starts):
        noise = {k: jitter * torch.randn(v.shape, generator=gen, dtype=_f32)
                 for k, v in theta0.items()}
        starts.append(theta0 if i == 0 else
                      {k: v + noise[k].to(v.device) for k, v in theta0.items()})
    return {k: torch.stack([th[k] for th in starts]) for k in theta0}


def _cascade_population_loss_fn(reference_fn, num_steps, template, tune_cfg, body, rate_loop,
                                loop_cfg, dev, plain_kernels):
    """``theta`` stacked over S starts -> the ``(S,)`` losses of the S
    flights, flown as one batch (``batched_pid_flight_rollout``, each
    flight its own gains)."""
    loop_cfg = _differentiable(loop_cfg)
    settle = tune_cfg.settle_steps

    def loss_fn(theta):
        S = next(iter(theta.values())).shape[0]
        x0 = torch.zeros(S, 12, dtype=_f32, device=dev)
        x0[:, 2] = loop_cfg.takeoff_height
        outs = batched_pid_flight_rollout(
            reference_fn, num_steps, body, rate_loop, x0, gains=_cascade_gains(theta, template),
            cfg=loop_cfg, device=dev, plain_kernels=plain_kernels,
        )
        err = outs["state"][:, settle:, 0:3] - outs["pos_ref"][settle:]
        mse = torch.mean(torch.sum(err**2, dim=-1), dim=1)
        effort = torch.mean(outs["rates_cmd"][:, settle:] ** 2, dim=(1, 2))
        return mse + tune_cfg.effort_weight * effort

    return loss_fn


def tune_cascade_gains_multistart(
    reference_fn: Callable,
    num_steps: int,
    n_starts: int = 8,
    jitter: float = 0.3,
    seed: int = 0,
    init_gains: CascadePidGains | None = None,
    tune_cfg: TuneConfig = TuneConfig(),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
    device=None,
    plain_kernels: bool = False,
) -> TuningResult:
    """Run the tuning from ``n_starts`` jittered initialisations (log-space
    Gaussian jitter from ``torch.Generator().manual_seed(seed)``, start 0
    unjittered) and return the best. All starts fly as one batch of
    ``n_starts`` flights (``batched_pid_flight_rollout``: with
    ``loop_cfg.use_pallas_plant`` one launch of K1 forward and K13a
    backward a tick for all starts) and one Adam steps them together
    (``_tune_stacked``), as the JAX package vmaps its runs."""
    dev = resolve_device(device)
    template = _f32_gains(init_gains if init_gains is not None
                          else CascadePidGains.default(device=dev), dev)
    loss_fn = _cascade_population_loss_fn(reference_fn, num_steps, template, tune_cfg, body,
                                          rate_loop, loop_cfg, dev, plain_kernels)
    thetas = _multistart_thetas(_cascade_theta(template), n_starts, jitter, seed)
    theta, losses, final_losses = _tune_stacked(loss_fn, thetas, tune_cfg.iterations,
                                                          tune_cfg.learning_rate)
    best = int(torch.argmin(final_losses))
    with torch.no_grad():
        initial_loss = loss_fn({k: v[:1] for k, v in thetas.items()})[0]
    return TuningResult(params=_cascade_gains({k: v[best] for k, v in theta.items()}, template),
                        losses=losses[:, best], initial_loss=initial_loss,
                        final_loss=final_losses[best])


# ---------------------------------------------------------------------------
# MPC cost-weight tuning (differentiable MPC)
# ---------------------------------------------------------------------------


class _TracedWeightMPC:
    """``LinearMPC`` twin whose Q/R weights are tensors that carry gradient.

    The deployment controller builds its condensed matrices once in NumPy.
    This twin rebuilds ``H`` and ``M = H + rho G'G`` from the weight dict and
    solves each tick by ADMM through a Cholesky factor of ``M``
    (``ops.qp.admm_box_qp_chol``), so the gradient flows from the flight
    back into the weights. Shift, ADMM splitting and the slack's U-block
    controls match ``LinearMPC.solve`` at equal iteration counts. With
    ``use_fused_controller`` it also holds the kernels' operands built from
    the same weights (``_fc_data``, ``_tick_data``; ``ops.tick_ad``), which
    the multi-tick tier hands K5. Float32, on ``device`` (default: the
    weights')."""

    def __init__(self, weights: dict, config: LinearMPCConfig, device=None):
        from ..ops.tick_ad import build_fused_controller_data_traced, build_tick_data_traced

        self.config = config
        self.dtype = _f32
        self.device = (next(iter(weights.values())).device if device is None
                       else resolve_device(device))
        N, dt = config.horizon, config.dt
        nx, nu = STATE_DIM, CONTROL_DIM
        self._nx, self._nu = nx, nu

        A = np.eye(nx)
        A[0:3, 3:6] = dt * np.eye(3)
        B = np.zeros((nx, nu))
        B[3:6, 0:3] = dt * np.eye(3)
        Sx, Su, Sw = condense_dynamics(A, B, N)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self._Sx, self._Su, self._Sw = f32(Sx), f32(Su), f32(Sw)
        self._Sw_sq = f32(Sw**2)
        self._G = f32(np.vstack([np.eye(N * nu), Su]))
        self._u_lo = f32(np.tile(config.control_lower, N))
        self._u_hi = f32(np.tile(config.control_upper, N))
        self._x_lo = f32(np.tile(config.state_lower, N))
        self._x_hi = f32(np.tile(config.state_upper, N))
        self.n_primal = N * nu
        self.n_constraints = self._G.shape[0]

        # the weight-dependent, state-independent cost and factor, built once
        # per twin (once per loss evaluation), not per tick
        w = weights
        q_pos, q_vel = torch.exp(w["log_q_pos"]), torch.exp(w["log_q_vel"])
        q_stage = torch.cat([q_pos, q_vel])
        q_term = torch.cat([torch.exp(w["log_terminal_pos"]) * q_pos,
                            torch.exp(w["log_terminal_vel"]) * q_vel])
        qbar = torch.cat([q_stage.repeat(N - 1), q_term])
        rbar = torch.exp(w["log_r"]).repeat(N)
        self._SuTq = self._Su.T * qbar[None, :]
        H = self._SuTq @ self._Su + torch.diag(rbar)
        M = H + config.admm_rho * (self._G.T @ self._G)
        self._M_chol = torch.linalg.cholesky(M)

        if config.use_fused_controller:
            eye = torch.eye(N * nu, dtype=_f32, device=self.device)
            M_inv = torch.cholesky_solve(eye, self._M_chol)
            self._fc_data = build_fused_controller_data_traced(
                self._Sx, self._Su, self._Sw, self._SuTq, M_inv, self._G,
                self._u_lo, self._u_hi, self._x_lo, self._x_hi,
            )
            self._tick_data = build_tick_data_traced(self._fc_data, N, nu, nx)

    def init_carry(self, state=None) -> MPCCarry:
        return LinearMPC.init_carry(self, state)

    def _shift(self, carry: MPCCarry, x0: torch.Tensor) -> MPCCarry:
        return LinearMPC._shift(self, carry, x0)

    def solve(self, carry, state, target_pos, residuals=None, reference_states=None,
              uncertainty=None, *, plain_kernels: bool = False):
        """One tick, as ``LinearMPC.solve`` (staged): ``(u0, X_opt,
        new_carry)``. It runs no kernel, so ``plain_kernels`` changes
        nothing."""
        cfg = self.config
        N, nx, nu = cfg.horizon, self._nx, self._nu
        x0 = state.to(self.dtype)
        carry = self._shift(carry, x0)
        w_vec = (torch.zeros(N * nx, dtype=self.dtype, device=self.device) if residuals is None
                 else (cfg.dt * residuals.to(self.dtype)).reshape(-1))
        if reference_states is not None:
            ref = reference_states.to(self.dtype).reshape(-1)
        else:
            ref = torch.cat([target_pos.to(self.dtype),
                             torch.zeros(3, dtype=self.dtype, device=self.device)]).repeat(N)

        offset = self._Sx @ x0 + self._Sw @ w_vec
        f = self._SuTq @ (offset - ref)
        x_lo, x_hi = self._x_lo, self._x_hi
        if uncertainty is not None and cfg.tightening_factor > 0.0:
            var_x = self._Sw_sq @ (cfg.dt * uncertainty.to(self.dtype).reshape(-1)) ** 2
            tight = torch.minimum(cfg.tightening_factor * guarded_sqrt(var_x),
                                  0.45 * (x_hi - x_lo))
            x_lo, x_hi = x_lo + tight, x_hi - tight
        lower = torch.cat([self._u_lo, x_lo - offset])
        upper = torch.cat([self._u_hi, x_hi - offset])

        sol = admm_box_qp_chol(self._M_chol, self._G, f, lower, upper, carry.slack, carry.dual,
                               cfg.admm_rho, cfg.admm_iterations, cfg.admm_over_relax)
        U = sol.slack[: N * nu].reshape(N, nu)
        X_tail = (offset + self._Su @ sol.primal).reshape(N, nx)
        X_opt = torch.cat([x0[None, :], X_tail], dim=0)
        return U[0], X_opt, MPCCarry(slack=sol.slack, dual=sol.dual, X_prev=X_opt, U_prev=U)


def mpc_weights_theta(config: LinearMPCConfig, device=None) -> dict:
    """Log-space float32 weight dict seeded from a config's Q/R/terminal
    values."""
    dev = resolve_device(device)
    log = lambda v: torch.log(torch.tensor(v, dtype=_f32, device=dev))
    return {
        "log_q_pos": log(config.q_pos),
        "log_q_vel": log(config.q_vel),
        "log_r": log(config.r_control),
        "log_terminal_pos": log(config.terminal_pos_weight),
        "log_terminal_vel": log(config.terminal_vel_weight),
    }


def mpc_config_from_theta(theta: dict, base: LinearMPCConfig) -> LinearMPCConfig:
    """A config of host floats from a tuned weight dict: it drops into the
    deployment ``LinearMPC`` (fused kernels included)."""
    e = lambda k: np.exp(theta[k].detach().cpu().numpy())
    t = lambda k: tuple(float(v) for v in e(k))
    return replace(
        base,
        q_pos=t("log_q_pos"),
        q_vel=t("log_q_vel"),
        r_control=t("log_r"),
        terminal_pos_weight=float(e("log_terminal_pos")),
        terminal_vel_weight=float(e("log_terminal_vel")),
    )


def _mpc_loss_fn(reference_fn, num_steps, base, tune_cfg, body, rate_loop, loop_cfg, residual_fn,
                 preview, dev, plain_kernels):
    loop_cfg = _differentiable(loop_cfg)

    def loss_fn(theta):
        outs = mpc_flight_rollout(
            _TracedWeightMPC(theta, base, device=dev), reference_fn, num_steps, body=body,
            rate_loop=rate_loop, cfg=loop_cfg, residual_fn=residual_fn, preview=preview,
            device=dev, plain_kernels=plain_kernels,
        )
        return _tracking_loss(outs, tune_cfg.settle_steps, tune_cfg.effort_weight)

    return loss_fn


def tune_mpc_weights(
    reference_fn: Callable,
    num_steps: int,
    base_config: LinearMPCConfig | None = None,
    tune_cfg: TuneConfig = TuneConfig(iterations=30, learning_rate=0.08),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
    residual_fn: Callable | None = None,
    preview: bool = False,
    device=None,
    plain_kernels: bool = False,
) -> Tuple[TuningResult, LinearMPCConfig]:
    """Tune the MPC's 16 cost weights by gradient descent through the closed
    GP-MPC loop, QP solver included.

    With ``loop_cfg.use_fused_tick`` it tunes the program that flies: the
    multi-tick tier (``ticks_per_dispatch > 1``), K5 forward and the VJP of
    its plain twin backward; with ``use_pallas_plant`` on the staged tier,
    K2 forward and K13b backward (``plain_kernels=True``: autograd through
    the kernels' plain versions instead, on any device). Returns ``(TuningResult with the weight
    dict, tuned LinearMPCConfig)``."""
    dev = resolve_device(device)
    base = base_config if base_config is not None else LinearMPCConfig()
    if loop_cfg.use_fused_tick:
        if not base.use_fused_controller:
            base = replace(base, use_fused_controller=True)
        if loop_cfg.ticks_per_dispatch <= 1:
            raise ValueError("fused-tier tuning runs on the multi-tick path: set "
                             "FlightLoopConfig.ticks_per_dispatch > 1")
    loss_fn = _mpc_loss_fn(reference_fn, num_steps, base, tune_cfg, body, rate_loop, loop_cfg,
                           residual_fn, preview, dev, plain_kernels)
    theta0 = mpc_weights_theta(base, device=dev)
    with torch.no_grad():
        initial_loss = loss_fn(theta0)
    theta, losses, final_loss = tune_parameters(loss_fn, theta0, tune_cfg.iterations,
                                                tune_cfg.learning_rate)
    result = TuningResult(params=theta, losses=losses, initial_loss=initial_loss,
                          final_loss=final_loss)
    return result, mpc_config_from_theta(theta, base)
