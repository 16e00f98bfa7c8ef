"""GP and MPC performance aggregates and JSON logging (port of
``metrics/performance.py``, NumPy only, copied).

The reference's GP and MPC metric classes and its metrics logger, as
array-at-once reductions: a whole flight's stacked signals reduce in one
call, with the same metric definitions (solve-time mean and max, the
constraint-violation rate, the mean sum-of-squares control effort).

A per-tick wall-clock "solve time" has no meaning inside a fused loop, so
``mpc_metrics_summary`` takes whatever timing array the caller provides,
and the ``measure_time`` decorator times host-side callables.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Callable, Dict

import numpy as np


def gp_metrics_summary(
    prediction_errors: np.ndarray,      # (T, out)
    uncertainties: np.ndarray,          # (T, out)
    training_data_counts: np.ndarray | None = None,
) -> Dict:
    """``GPMetrics`` reductions (:39-57)."""
    prediction_errors = np.asarray(prediction_errors)
    uncertainties = np.asarray(uncertainties)
    out = {
        "mean_prediction_error": np.mean(prediction_errors, axis=0).tolist(),
        "mean_uncertainty": np.mean(uncertainties, axis=0).tolist(),
        "rmse": float(np.sqrt(np.mean(prediction_errors**2))),
    }
    if training_data_counts is not None:
        out["final_training_data_count"] = int(np.asarray(training_data_counts)[-1])
    return out


def mpc_metrics_summary(
    tracking_errors: np.ndarray,        # (T, >=9) state-space errors
    control_inputs: np.ndarray,         # (T, nu)
    solve_times: np.ndarray | None = None,       # (R,) seconds
    constraints_violated: np.ndarray | None = None,  # (T,) bool
) -> Dict:
    """``MPCMetrics`` reductions (:84-135)."""
    e = np.asarray(tracking_errors)
    u = np.asarray(control_inputs)
    out = {
        "position_rmse": float(np.sqrt(np.mean(e[:, 0:3] ** 2))),
        "velocity_rmse": float(np.sqrt(np.mean(e[:, 3:6] ** 2))),
        "control_effort": float(np.mean(np.sum(u**2, axis=1))),
    }
    if e.shape[1] >= 9:
        out["attitude_rmse"] = float(np.sqrt(np.mean(e[:, 6:9] ** 2)))
    if solve_times is not None:
        st = np.asarray(solve_times)
        out["mean_solve_time"] = float(np.mean(st))
        out["max_solve_time"] = float(np.max(st))
        out["std_solve_time"] = float(np.std(st))
    if constraints_violated is not None:
        cv = np.asarray(constraints_violated)
        out["constraint_violation_rate"] = float(np.mean(cv.astype(float)))
    return out


def constraint_violations(
    controls: np.ndarray, lower: np.ndarray, upper: np.ndarray, tol: float = 1e-6
) -> np.ndarray:
    """Per-tick bound-violation flags for the violation-rate metric."""
    c = np.asarray(controls)
    return np.any((c < lower - tol) | (c > upper + tol), axis=-1)


def measure_time(fn: Callable) -> Callable:
    """Decorator: appends wall-clock duration to ``fn_timings[fn]``
    (``performance_metrics_utils.py:77-86``)."""
    timings: list[float] = []

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        timings.append(time.perf_counter() - t0)
        return result

    wrapper.timings = timings
    return wrapper


class MetricsLogger:
    """JSON metrics logger: one file per save under ``output_dir``."""

    def __init__(self, output_dir: str = "quadrotor_metrics"):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    def save(self, name: str, metrics: Dict, filename: str | None = None) -> str:
        if filename is None:
            filename = f"{name}_{time.strftime('%Y%m%d_%H%M%S')}.json"
        path = os.path.join(self.output_dir, filename)
        with open(path, "w") as f:
            json.dump({"name": name, "timestamp": time.time(), "metrics": metrics}, f, indent=2)
        return path

    def save_gp_metrics(self, metrics: Dict, filename: str | None = None) -> str:
        return self.save("gp_metrics", metrics, filename)

    def save_mpc_metrics(self, metrics: Dict, filename: str | None = None) -> str:
        return self.save("mpc_metrics", metrics, filename)
