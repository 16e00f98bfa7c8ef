"""GP and mid-flight resume checkpoints (port of ``io/checkpoint.py``).

``save_gp_checkpoint`` / ``load_gp_checkpoint`` keep a GP as an ``.npz`` of
its training set, log-hyperparameters, jitter and ``normalize_y`` under
the JAX package's keys, so each package reads the other's files; loading
refits the posterior (one Cholesky), which reproduces it exactly.

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
from ..gp.exact_gp import GPParams, GPPosterior, fit_gp
from ..gp.residual_gp import ResidualDataset
from ..loop.closed_loop import FlightResumeState
from ..ops.tick_pallas import GPRows

_CARRIES = ("state", "aux", "xtail", "z", "y")


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_gp_checkpoint(path, posterior: GPPosterior, X, Y, jitter: float,
                       normalize_y: bool = True, metadata: dict | None = None) -> None:
    """Write the GP (its training set ``X``, ``Y`` and the posterior's
    hyperparameters) to ``path``; ``np.savez`` adds ``.npz`` to a name
    without it, as in the JAX package. ``metadata`` entries are stored as
    ``meta_<key>``."""
    p = posterior.params
    arrays = {
        "X_train": _numpy(X),
        "Y_train": _numpy(Y),
        "log_length_scale": _numpy(p.log_length_scale),
        "log_signal_variance": _numpy(p.log_signal_variance),
        "log_noise_variance": _numpy(p.log_noise_variance),
        "jitter": np.asarray(jitter),
        "normalize_y": np.asarray(normalize_y),
    }
    for k, v in (metadata or {}).items():
        arrays[f"meta_{k}"] = _numpy(v)
    np.savez(path, **arrays)


def load_gp_checkpoint(path, dtype=None, device=None):
    """Read a GP checkpoint (either package's) onto ``device`` (default
    ``cuda``) and refit it: ``(posterior, X, Y, jitter, normalize_y)``.
    ``dtype`` (a torch dtype) casts the training set; the
    hyperparameters keep the file's dtype."""
    dev = resolve_device(device)
    with np.load(path) as data:
        t = lambda key: torch.from_numpy(np.array(data[key])).to(dev)
        X, Y = t("X_train"), t("Y_train")
        if dtype is not None:
            X, Y = X.to(dtype), Y.to(dtype)
        params = GPParams(t("log_length_scale"), t("log_signal_variance"),
                          t("log_noise_variance"))
        jitter = float(data["jitter"])
        normalize_y = bool(data["normalize_y"])
    posterior = fit_gp(params, X, Y, jitter=jitter, normalize_y=normalize_y)
    return posterior, X, Y, jitter, normalize_y


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
