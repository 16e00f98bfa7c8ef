"""Sweeps over flights and GP hyperparameters, on one card or split over
the ranks of a ``torch.distributed`` mesh (port of ``parallel/sweep.py``).

- ``structured_flight_sweep``: B flights through the batched sweep on one
  card (kernels K8, K7 and K2), reduced to tracking aggregates.
- ``sharded_structured_flight_sweep``: the same with the flights split
  over the mesh, each rank sweeping its block; the aggregates are reduced
  over the ranks.
- ``sharded_flight_sweep``: any ``rollout_fn`` flown once for each of this
  rank's flights, one after another (a ctypes launch cannot be vmapped).
- ``hyperparameter_search_step``: H candidate GP hyperparameters fitted
  and scored (validation MSE, LML), split over the ranks, the argmin taken
  after gathering the scores.

Per-flight results come back whole on every rank (gathered in rank order,
as the JAX package's sharded arrays read), the mean and max reduced over
the ranks. A batch that does not divide by the world's size raises, as
``shard_map`` does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..gp.exact_gp import GPParams, fit_gp, log_marginal_likelihood, predict_mean
from ..loop.closed_loop import FlightLoopConfig, batched_mpc_flight_sweep
from .sharding import Mesh, gather_rows, pmax, psum, shard_batch, shard_rows


class SweepResult(NamedTuple):
    best_index: torch.Tensor
    best_params: GPParams
    val_mse: torch.Tensor      # (H,)
    lml: torch.Tensor          # (H,)


def _rms(pos_ref: torch.Tensor, pos: torch.Tensor, time_axis: int) -> torch.Tensor:
    err = pos_ref - pos
    return torch.sqrt(torch.mean(torch.sum(err**2, dim=-1), dim=time_axis))


def structured_flight_sweep(
    mpc,
    reference_fn: Callable,
    num_steps: int,
    initial_states: torch.Tensor,   # (B, 12)
    cfg: FlightLoopConfig = FlightLoopConfig(),
    residual_fn: Callable | None = None,
    gp_posterior=None,
    gp_cfg=None,
    gp_fused_precision: str = "high",
    device=None,
) -> dict:
    """B flights through ``loop.closed_loop.batched_mpc_flight_sweep``
    (kernels K8, K7 and K2), reduced to per-flight RMS position errors and
    their mean and max over the flights."""
    outs = batched_mpc_flight_sweep(
        mpc, reference_fn, num_steps, initial_states,
        cfg=cfg, residual_fn=residual_fn, gp_posterior=gp_posterior, gp_cfg=gp_cfg,
        gp_fused_precision=gp_fused_precision, device=device,
    )
    rms = _rms(outs["pos_ref"][:, None, :], outs["state"][:, :, 0:3], 0)   # (B,)
    return {"rms_per_flight": rms, "rms_mean": torch.mean(rms), "rms_max": torch.max(rms)}


def sharded_structured_flight_sweep(
    mesh: Mesh,
    mpc,
    reference_fn: Callable,
    num_steps: int,
    initial_states: torch.Tensor,   # (B, 12)
    cfg: FlightLoopConfig | None = None,
    residual_fn: Callable | None = None,
    axis_name: str = "batch",
    gp_posterior=None,
    gp_cfg=None,
    gp_fused_precision: str = "high",
) -> dict:
    """B flights through the structured batched controller, split over the
    mesh: each rank sweeps its block of flights on its device
    (``batched_mpc_flight_sweep``: K8 and K2 a tick, K7 with
    ``gp_posterior``), then ``rms_mean`` is the mean over the ranks of each
    rank's mean (JAX's ``pmean(mean(rms))``) and ``rms_max`` the maximum.
    ``mpc`` must be built with ``use_fused_controller=True`` on the mesh's
    device, and the posterior too."""
    local = shard_batch(initial_states, mesh, axis_name)
    outs = batched_mpc_flight_sweep(
        mpc, reference_fn, num_steps, local, cfg=cfg or FlightLoopConfig(),
        residual_fn=residual_fn, gp_posterior=gp_posterior, gp_cfg=gp_cfg,
        gp_fused_precision=gp_fused_precision, device=mesh.device,
    )
    rms = _rms(outs["pos_ref"][:, None, :], outs["state"][:, :, 0:3], 0)   # (B_loc,)
    return {
        "rms_per_flight": gather_rows(rms, mesh),
        "rms_mean": psum(torch.mean(rms), mesh) / mesh.world_size,
        "rms_max": pmax(torch.max(rms), mesh),
    }


def sharded_flight_sweep(
    mesh: Mesh,
    rollout_fn: Callable[[torch.Tensor], dict],
    initial_states: torch.Tensor,   # (B, 12)
    axis_name: str = "batch",
) -> dict:
    """B independent closed-loop flights split over the mesh.
    ``rollout_fn(initial_state) -> outs`` (a partial of
    ``loop.mpc_flight_rollout``, say) flies each of this rank's flights in
    turn. Returns the per-flight RMS position errors and final states of
    all B flights, and their mean and max reduced over the ranks."""
    n = torch.as_tensor(initial_states).shape[0]
    local = shard_batch(initial_states, mesh, axis_name)
    rms, finals = [], []
    for x0 in local:
        outs = rollout_fn(x0)
        rms.append(_rms(outs["pos_ref"], outs["state"][..., 0:3], -1))
        finals.append(outs["final_state"])
    rms, finals = torch.stack(rms), torch.stack(finals)
    return {
        "rms_per_flight": gather_rows(rms, mesh),
        "rms_mean": psum(torch.sum(rms), mesh) / n,
        "rms_max": pmax(torch.max(rms), mesh),
        "final_states": gather_rows(finals, mesh),
    }


def hyperparameter_search_step(
    mesh: Mesh,
    candidates: GPParams,          # tensors with a leading axis H
    X_train: torch.Tensor,
    Y_train: torch.Tensor,
    X_val: torch.Tensor,
    Y_val: torch.Tensor,
    jitter: float = 1e-4,
    axis_name: str = "batch",
) -> SweepResult:
    """Fit and score H candidates split over the mesh
    (``gp.exact_gp.fit_gp`` with ``normalize_y``, the validation MSE of
    ``predict_mean``, ``log_marginal_likelihood``); the winner is the
    argmin of the gathered MSEs."""
    H = candidates.log_length_scale.shape[0]
    rows = shard_rows(H, mesh)
    dev = mesh.device
    X_train, Y_train, X_val, Y_val = (t.to(dev) for t in (X_train, Y_train, X_val, Y_val))
    mse, lml = [], []
    for h in range(rows.start, rows.stop):
        p = GPParams(*(v[h].to(dev) for v in candidates))
        post = fit_gp(p, X_train, Y_train, jitter=jitter, normalize_y=True)
        pred = predict_mean(post, X_val)
        mse.append(torch.mean((pred - Y_val) ** 2))
        lml.append(log_marginal_likelihood(p, X_train, Y_train, jitter, normalize_y=True))
    mse = gather_rows(torch.stack(mse), mesh)
    lml = gather_rows(torch.stack(lml), mesh)
    best = torch.argmin(mse)
    best_params = GPParams(*(v[int(best)] for v in candidates))
    return SweepResult(best, best_params, mse, lml)
