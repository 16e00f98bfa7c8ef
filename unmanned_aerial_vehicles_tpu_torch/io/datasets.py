"""Flight-dataset IO: the ``gp_datasets/*.csv`` schema (port of
``io/datasets.py``).

Schema (the reference's ``src/px4/simple_gp.py:93-99``):
``x,y,z,vx,vy,vz,ax,ay,az,yaw_rate,res_dx,res_dy,res_dz,res_dvx,res_dvy,res_dvz``
— the 10-D GP input and the 6-D state residual.

Loading applies the offline trainer's filters (the reference's
``src/px4/train_gp_offline.py:43-69``: drop non-finite rows and residual
norms >= 5), vectorised over the whole file. NumPy arrays in and out.
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np

from .fast_csv import load_numeric_csv

CSV_HEADER = (
    "x,y,z,vx,vy,vz,ax,ay,az,yaw_rate,"
    "res_dx,res_dy,res_dz,res_dvx,res_dvy,res_dvz"
)
_N_COLS = 16


def load_gp_dataset(
    path: str,
    residual_norm_limit: float = 5.0,
    dtype=np.float64,
) -> Tuple[np.ndarray, np.ndarray]:
    """One CSV -> filtered ``(X (n,10), Y (n,6))`` arrays. Parsed by the
    native loader (the port's ``native/csv_loader.cpp``) when available."""
    data = load_numeric_csv(path, _N_COLS).astype(dtype, copy=False)
    if data.shape[1] != _N_COLS:
        raise ValueError(
            f"{path}: expected {_N_COLS} columns ({CSV_HEADER}), got {data.shape[1]}"
        )
    X, Y = data[:, :10], data[:, 10:]
    finite = np.isfinite(data).all(axis=1)
    reasonable = np.linalg.norm(Y, axis=1) < residual_norm_limit
    keep = finite & reasonable
    return X[keep], Y[keep]


def load_gp_datasets(
    paths: Iterable[str],
    residual_norm_limit: float = 5.0,
    max_samples: int | None = None,
    dtype=np.float64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate several CSVs, optionally down-sampling evenly to
    ``max_samples`` (``train_gp_offline.py:155-163`` uses max 10000).
    Files that don't match the 16-column flight schema (e.g. the
    ``*_metrics.csv`` analysis outputs living in the same directory) are
    skipped with a warning, mirroring the reference's per-file error
    tolerance (``train_gp_offline.py:98-104``)."""
    import warnings

    xs, ys = [], []
    for p in paths:
        try:
            X, Y = load_gp_dataset(p, residual_norm_limit, dtype)
        except ValueError as e:
            warnings.warn(f"skipping {p}: {e}")
            continue
        xs.append(X)
        ys.append(Y)
    if not xs:
        return np.empty((0, 10), dtype), np.empty((0, 6), dtype)
    X = np.concatenate(xs, axis=0)
    Y = np.concatenate(ys, axis=0)
    if max_samples is not None and X.shape[0] > max_samples:
        idx = np.linspace(0, X.shape[0] - 1, max_samples).astype(int)
        X, Y = X[idx], Y[idx]
    return X, Y


def save_gp_dataset(path: str, X: np.ndarray, Y: np.ndarray, include_header=True):
    """Write the reference CSV schema (``simple_gp.py:75-115``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = np.hstack([np.asarray(X), np.asarray(Y)])
    np.savetxt(
        path, data, delimiter=",",
        header=CSV_HEADER if include_header else "", comments="",
    )
