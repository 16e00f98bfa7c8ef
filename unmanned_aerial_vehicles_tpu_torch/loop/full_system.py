"""The online GP-MPC system: fly, collect, refit, in one loop (port of
``loop/full_system.py``).

The reference's multi-rate "full system" (plant, MPC and GP retraining on
timers, a data collector beside them) as one host loop, one Python step a
tick: every tick's transition goes into the ring buffer (quality filters
included), every ``gp_refit_every`` ticks a masked Cholesky refit rebuilds
the posterior once ``gp_min_samples`` samples are in, the MPC solves every
``mpc_every`` ticks with the GP's residual rows (zero until the GP is
trained), and a non-finite command falls back to hover.

Nothing is read from the device on an ordinary tick: the gate on the
residual rows and the hover fallback are ``torch.where`` on the device,
``mpc_every`` is a host ``if`` on the tick, and the sample count is read
only on the refit ticks (the quality filters make it data-dependent). An
MPC built with ``use_fused_controller`` solves in one launch of K3 a tick,
``FlightLoopConfig(use_pallas_plant=True)`` steps the plant in one launch
of K1; ``plain_kernels=True`` flies their plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from .._device import full_f32_matmul, resolve_device
from ..control.allocation import attitude_loop_init, geometric_control_allocation
from ..control.mpc_linear import LinearMPC
from ..gp.residual_gp import (
    ResidualDataset,
    ResidualGPConfig,
    add_training_sample,
    build_horizon_residuals,
    empty_dataset,
    fit_residual_gp_masked,
    masked_input_stats,
    standardized_params,
)
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams
from .closed_loop import (
    FlightLoopConfig,
    _plant_substeps,
    _preview_references,
    _references,
    _stack_outs,
)


@dataclass(frozen=True)
class OnlineGPMPCConfig:
    flight: FlightLoopConfig = field(default_factory=FlightLoopConfig)
    gp: ResidualGPConfig = field(default_factory=ResidualGPConfig)
    gp_refit_every: int = 250      # ticks; 5 s at 50 Hz
    gp_min_samples: int = 30
    mpc_every: int = 1             # solve every k-th tick (10 Hz MPC = 5)
    preview: bool = False          # per-stage horizon references
    # refits with ARD length scales equivalent to standardized inputs
    # (gp.residual_gp.standardized_params)
    standardize_inputs: bool = False


def online_gp_mpc_rollout(
    mpc: LinearMPC,
    reference_fn: Callable,
    num_steps: int,
    cfg: OnlineGPMPCConfig = OnlineGPMPCConfig(),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    initial_state: torch.Tensor | None = None,
    initial_dataset: ResidualDataset | None = None,
    dtype=torch.float32,
    device=None,
    plain_kernels: bool = False,
):
    """Closed loop with in-flight data collection and periodic GP refits.

    ``reference_fn(t (T,)) -> (pos (T, 3), yaw (T,))``. Returns ``(outs,
    dataset, posterior)``: the stacked per-tick ``state``, ``pos_ref``,
    ``thrust``, ``gp_count`` and ``gp_active`` (with ``final_state``), the
    final ring buffer and the last fitted posterior (``io.checkpoint.
    save_gp_checkpoint`` saves them)."""
    dev = resolve_device(device)
    if mpc.device != dev:
        raise ValueError(f"the MPC lives on {mpc.device}, the flight on {dev}")
    full_f32_matmul()
    fcfg = cfg.flight
    kw = dict(dtype=dtype, device=dev)
    if initial_state is None:
        initial_state = torch.zeros(12, **kw)
        initial_state[2] = fcfg.takeoff_height
    if initial_dataset is None:
        initial_dataset = empty_dataset(cfg.gp.max_data_points, dtype, dev)
    N = mpc.config.horizon

    accel_lo = torch.tensor(fcfg.accel_lower, **kw)
    accel_hi = torch.tensor(fcfg.accel_upper, **kw)
    hover_u = torch.zeros(4, **kw)   # the zero-acceleration command: hover
    no_residuals = torch.zeros(N, 6, **kw)

    def fit_scaled(ds):
        if cfg.standardize_inputs:
            shift, std = masked_input_stats(ds)
            return fit_residual_gp_masked(ds, cfg.gp,
                                          params=standardized_params(ds, cfg.gp, std=std),
                                          x_shift=shift)
        return fit_residual_gp_masked(ds, cfg.gp)

    pos_refs, yaw_refs = _references(reference_fn, num_steps, fcfg, dtype, dev)
    ref_states = (_preview_references(reference_fn, num_steps, N, fcfg, dtype, dev)
                  .reshape(num_steps, N, 6) if cfg.preview else None)

    state = initial_state.to(**kw)
    dataset = initial_dataset
    posterior = fit_scaled(dataset)
    mpc_carry = mpc.init_carry(state[0:6])
    att_carry = attitude_loop_init(dtype, dev)
    prev_state, prev_control, last_u = state, torch.zeros(4, **kw), torch.zeros(4, **kw)
    rows = []
    for i in range(num_steps):
        pos_ref, yaw_ref = pos_refs[i], yaw_refs[i]
        # the last transition into the ring buffer
        dataset = add_training_sample(dataset, prev_state[0:6], prev_control, state[0:6], cfg.gp)
        # the periodic refit: the count is read on the refit ticks only
        if (i % cfg.gp_refit_every == cfg.gp_refit_every - 1
                and int(dataset.count) >= cfg.gp_min_samples):
            posterior = fit_scaled(dataset)
        trained = dataset.count >= cfg.gp_min_samples
        residuals = torch.where(
            trained, build_horizon_residuals(posterior, mpc_carry.X_prev, mpc_carry.U_prev,
                                             cfg.gp), no_residuals)
        if i % cfg.mpc_every == 0:
            u_opt, _, mpc_carry = mpc.solve(
                mpc_carry, state[0:6], pos_ref, residuals,
                reference_states=ref_states[i] if cfg.preview else None,
                plain_kernels=plain_kernels)
        else:
            u_opt = last_u
        # the solver-failure fallback: hover on a non-finite command
        u_opt = torch.where(torch.all(torch.isfinite(u_opt)), u_opt, hover_u)

        accel_des = torch.minimum(torch.maximum(u_opt[0:3], accel_lo), accel_hi)
        yawrate_des = torch.clamp(u_opt[3], -fcfg.yawrate_limit, fcfg.yawrate_limit)
        thrust, rate_cmd, _, att_carry = geometric_control_allocation(
            att_carry, accel_des, yaw_ref, yawrate_des, state[6:9], state[9:12],
            dt_attitude=fcfg.control_dt,
        )
        control = torch.cat([thrust[None], rate_cmd])
        new_state = _plant_substeps(state, control, body, rate_loop, fcfg, plain=plain_kernels)
        rows.append({"state": state, "pos_ref": pos_ref, "thrust": thrust,
                     "gp_count": dataset.count, "gp_active": trained})
        prev_state, prev_control, last_u = state, torch.cat([accel_des, yawrate_des[None]]), u_opt
        state = new_state
    outs = _stack_outs(rows)
    outs["final_state"] = state
    return outs, dataset, posterior
