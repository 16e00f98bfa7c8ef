"""Offline GP evaluation: nominal against GP-corrected derivative error
(port of ``gp/evaluate.py``, NumPy only, copied).

The reference's offline evaluation, formula for formula and vectorised:

* global / acceleration-only MSE, RMSE and relative improvement %;
* per-component MSE/RMSE/improvement, R^2 (nominal prediction = zero
  residual vs GP prediction), fraction-of-samples-better;
* CSV output with the reference's exact column set.

Since ``err_nom = R_true`` and ``err_gp = R_true - R_pred`` algebraically
(the nominal derivative cancels), the evaluation needs only the true and
predicted residuals — the same simplification the reference's own math
reduces to.
"""

from __future__ import annotations

import csv
import os
from typing import Callable

import numpy as np

COMPONENT_NAMES = ["dx", "dy", "dz", "dvx", "dvy", "dvz"]
CSV_COLUMNS = [
    "component", "mse_nom", "mse_gp", "rmse_nom", "rmse_gp",
    "improvement_%", "r2_nom", "r2_gp", "frac_better",
]


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Coefficient of determination, sklearn semantics."""
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - np.mean(y_true)) ** 2)
    return float(1.0 - ss_res / max(ss_tot, 1e-300))


def evaluate_gp_residuals(R_true: np.ndarray, R_pred: np.ndarray) -> dict:
    """Full reference metric set from true/predicted residual arrays (N, 6)."""
    R_true = np.asarray(R_true, dtype=float)
    R_pred = np.asarray(R_pred, dtype=float)

    err_nom = R_true                 # nominal predicts zero residual
    err_gp = R_true - R_pred

    se_nom = np.sum(err_nom**2, axis=1)
    se_gp = np.sum(err_gp**2, axis=1)
    mse_nom, mse_gp = float(np.mean(se_nom)), float(np.mean(se_gp))

    se_nom_acc = np.sum(err_nom[:, 3:6] ** 2, axis=1)
    se_gp_acc = np.sum(err_gp[:, 3:6] ** 2, axis=1)
    mse_nom_acc, mse_gp_acc = float(np.mean(se_nom_acc)), float(np.mean(se_gp_acc))

    improvement = se_nom - se_gp
    frac_better = float(np.mean(improvement > 0.0))
    frac_worse = float(np.mean(improvement < 0.0))

    per_component = []
    for j, name in enumerate(COMPONENT_NAMES):
        mse_nom_j = float(np.mean(err_nom[:, j] ** 2))
        mse_gp_j = float(np.mean(err_gp[:, j] ** 2))
        per_component.append(
            {
                "component": name,
                "mse_nom": mse_nom_j,
                "mse_gp": mse_gp_j,
                "rmse_nom": float(np.sqrt(mse_nom_j)),
                "rmse_gp": float(np.sqrt(mse_gp_j)),
                "improvement_%": (mse_nom_j - mse_gp_j) / max(mse_nom_j, 1e-12) * 100.0,
                "r2_nom": r2_score(R_true[:, j], np.zeros_like(R_true[:, j])),
                "r2_gp": r2_score(R_true[:, j], R_pred[:, j]),
                "frac_better": float(
                    np.mean(err_nom[:, j] ** 2 > err_gp[:, j] ** 2)
                ),
            }
        )

    return {
        "global": {
            "mse_nom": mse_nom,
            "mse_gp": mse_gp,
            "rmse_nom": float(np.sqrt(mse_nom)),
            "rmse_gp": float(np.sqrt(mse_gp)),
            "improvement_%": (mse_nom - mse_gp) / max(mse_nom, 1e-12) * 100.0,
        },
        "acc_only": {
            "mse_nom": mse_nom_acc,
            "mse_gp": mse_gp_acc,
            "rmse_nom": float(np.sqrt(mse_nom_acc)),
            "rmse_gp": float(np.sqrt(mse_gp_acc)),
            "improvement_%": (mse_nom_acc - mse_gp_acc)
            / max(mse_nom_acc, 1e-12)
            * 100.0,
        },
        "fractions": {
            "frac_better": frac_better,
            "frac_worse": frac_worse,
            "frac_equal": 1.0 - frac_better - frac_worse,
        },
        "per_component": per_component,
    }


def evaluate_gp(
    predict_fn: Callable[[np.ndarray], np.ndarray],
    X_feat: np.ndarray,
    R_true: np.ndarray,
    save_prefix: str | None = None,
) -> dict:
    """Evaluate a residual predictor (``(N,10) -> (N,6)``) on flight data and
    optionally write ``<prefix>_metrics.csv`` in the reference layout."""
    R_pred = predict_fn(np.asarray(X_feat))
    if hasattr(R_pred, "detach"):        # a tensor from the port's predictors
        R_pred = R_pred.detach().cpu().numpy()
    R_pred = np.asarray(R_pred)
    results = evaluate_gp_residuals(R_true, R_pred)
    if save_prefix is not None:
        write_metrics_csv(f"{save_prefix}_metrics.csv", results["per_component"])
    return results


def write_metrics_csv(path: str, per_component: list[dict]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
        writer.writeheader()
        for row in per_component:
            writer.writerow({k: row[k] for k in CSV_COLUMNS})
