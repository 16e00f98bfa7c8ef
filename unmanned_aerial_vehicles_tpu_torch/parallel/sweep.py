"""Flight sweeps on one card (port of ``parallel/sweep.py``:
``sharded_structured_flight_sweep`` with the mesh dropped).

Sharding the flights over several cards with ``torch.distributed`` is
queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..loop.closed_loop import FlightLoopConfig, batched_mpc_flight_sweep


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
    err = outs["pos_ref"][:, None, :] - outs["state"][:, :, 0:3]
    rms = torch.sqrt(torch.mean(torch.sum(err**2, dim=-1), dim=0))   # (B,)
    return {"rms_per_flight": rms, "rms_mean": torch.mean(rms), "rms_max": torch.max(rms)}
