"""Mid-flight resume checkpoints (port of ``io/checkpoint.py``:
``save_resume_state`` and ``load_resume_state``).

A ``loop.closed_loop.FlightResumeState`` is stored as an ``.npz`` of named
plain arrays: the tick, the configuration fingerprint, K5's carries, the
online ring buffer and the kernel's GP rows (each present only when the
flight had one). The arrays keep their dtypes, so a flight resumed from the
file continues bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..gp.residual_gp import ResidualDataset
from ..loop.closed_loop import FlightResumeState
from ..ops.tick_pallas import GPRows

_CARRIES = ("state", "aux", "xtail", "z", "y")


def save_resume_state(path, rs: FlightResumeState) -> None:
    """Write ``rs`` to ``path`` (an ``.npz``, whatever its suffix)."""
    *carries, dataset, gp = rs.carry
    arrays = {"tick": np.asarray(rs.tick, np.int64),
              "meta": np.asarray([int(v) for v in rs.meta], np.int64)}
    arrays.update({name: t.detach().cpu().numpy() for name, t in zip(_CARRIES, carries)})
    if dataset is not None:
        arrays.update({f"dataset_{k}": v.detach().cpu().numpy()
                       for k, v in dataset._asdict().items()})
    if gp is not None:
        arrays.update({f"gp_{k}": v.detach().cpu().numpy()
                       for k, v in gp._asdict().items() if v is not None})
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_resume_state(path, device=None) -> FlightResumeState:
    """Read a checkpoint written by ``save_resume_state`` onto ``device``
    (default ``cuda``). Resuming under another configuration raises in
    ``mpc_flight_rollout`` (the fingerprint in ``meta``)."""
    dev = resolve_device(device)
    with np.load(path) as data:
        t = lambda key: torch.from_numpy(data[key].copy()).to(dev)
        carries = tuple(t(name) for name in _CARRIES)
        dataset = (ResidualDataset(**{k: t(f"dataset_{k}") for k in ResidualDataset._fields})
                   if "dataset_X" in data.files else None)
        gp = (GPRows(**{k: t(f"gp_{k}") for k in GPRows._fields if f"gp_{k}" in data.files})
              if "gp_ztrT" in data.files else None)
        return FlightResumeState(carry=(*carries, dataset, gp), tick=int(data["tick"]),
                                 meta=tuple(int(v) for v in data["meta"]))
