"""GP model analysis: test-point generation, prediction distributions,
uncertainty statistics, residual correlations (port of ``gp/analysis.py``).

The reference's ``GPModelEvaluator`` (``src/px4/gp_evaluation.py:54-588``
of the reference): the same three physically motivated test regimes
(uniform flight envelope, hover-like, figure-8 trajectory; :150-207),
prediction-distribution statistics, uncertainty across operating regimes
(:398-474) and residual-feature correlations (:476-500), from one batched
``predict_fn`` call. NumPy in and out: ``predict_fn`` may wrap any of the
port's predictors (tensors are converted with ``np.asarray``). The figures
live in ``metrics.plots``, imported only by ``run_complete_gp_analysis``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

FEATURE_NAMES = ["x", "y", "z", "vx", "vy", "vz", "ax", "ay", "az", "yaw_rate"]
OUTPUT_NAMES = ["res_dx", "res_dy", "res_dz", "res_dvx", "res_dvy", "res_dvz"]


def generate_physical_test_points(n_samples: int = 1000, seed: int = 42) -> np.ndarray:
    """The reference's three-regime physical test set (:150-207):
    uniform envelope + 100 hover-like + 200 figure-8 points; (n, 10)."""
    rng = np.random.default_rng(seed)

    base = np.column_stack(
        [
            rng.uniform(-10, 10, n_samples),
            rng.uniform(-10, 10, n_samples),
            rng.uniform(-2, 15, n_samples),
            rng.uniform(-5, 5, n_samples),
            rng.uniform(-5, 5, n_samples),
            rng.uniform(-3, 3, n_samples),
            rng.uniform(-8, 8, n_samples),
            rng.uniform(-8, 8, n_samples),
            rng.uniform(1, 18, n_samples),
            rng.uniform(-1, 1, n_samples),
        ]
    )

    pos = rng.uniform(-5, 5, (100, 3))
    hover = np.column_stack(
        [
            pos[:, 0], pos[:, 1], pos[:, 2] + 5.0,
            rng.normal(0, 0.5, 100), rng.normal(0, 0.5, 100), rng.normal(0, 0.2, 100),
            rng.normal(0, 2, 100), rng.normal(0, 2, 100), rng.normal(9.81, 1, 100),
            rng.normal(0, 0.3, 100),
        ]
    )

    t = np.linspace(0, 10, 200)
    traj = np.column_stack(
        [
            3 * np.sin(0.5 * t), 3 * np.sin(t), 5 + 2 * np.sin(0.3 * t),
            1.5 * np.cos(0.5 * t), 3.0 * np.cos(t), 0.6 * np.cos(0.3 * t),
            -0.75 * np.sin(0.5 * t) + rng.normal(0, 1, 200),
            -3.0 * np.sin(t) + rng.normal(0, 1, 200),
            -0.18 * np.sin(0.3 * t) + 9.81 + rng.normal(0, 0.5, 200),
            rng.normal(0, 0.2, 200),
        ]
    )
    return np.concatenate([base, hover, traj], axis=0)


def generate_generic_test_points(n_features: int, n_samples: int = 2000, seed: int = 42):
    """Fallback uniform [-1, 1] grid (:209-220)."""
    return np.random.default_rng(seed).uniform(-1, 1, (n_samples, n_features))


def analyze_gp_model(
    predict_fn: Callable[[np.ndarray], tuple],
    test_points: np.ndarray | None = None,
) -> Dict:
    """Full analysis pass: ``predict_fn(X) -> (mean (n,out), var (n,out))``.

    Returns prediction-distribution stats, uncertainty stats per regime
    (envelope / hover / trajectory), and residual-feature correlations —
    the quantitative content of the reference's ``run_complete_evaluation``.
    """
    if test_points is None:
        test_points = generate_physical_test_points()
    X = np.asarray(test_points)
    mean, var = (np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
                 for v in predict_fn(X))
    std = np.sqrt(var)

    n = X.shape[0]
    regimes = {}
    if n > 300:  # physical set: last 300 = hover(100) + trajectory(200)
        regimes = {
            "envelope": slice(0, n - 300),
            "hover": slice(n - 300, n - 200),
            "trajectory": slice(n - 200, n),
        }

    out_names = OUTPUT_NAMES[: mean.shape[1]]
    prediction_stats = {
        name: {
            "mean": float(mean[:, j].mean()),
            "std": float(mean[:, j].std()),
            "min": float(mean[:, j].min()),
            "max": float(mean[:, j].max()),
        }
        for j, name in enumerate(out_names)
    }
    uncertainty_stats = {
        "overall_mean_std": float(std.mean()),
        "max_std": float(std.max()),
        "per_regime": {
            name: float(std[sl].mean()) for name, sl in regimes.items()
        },
    }

    feat_names = FEATURE_NAMES[: X.shape[1]]
    correlations = {}
    for j, oname in enumerate(out_names):
        m = mean[:, j]
        if m.std() == 0:
            continue
        correlations[oname] = {
            fname: float(np.corrcoef(X[:, i], m)[0, 1])
            for i, fname in enumerate(feat_names)
            if X[:, i].std() > 0
        }

    # output-output correlation matrix of the predicted residual means —
    # the reference's "Residual correlations between outputs" heatmap
    # (gp_evaluation.py:476-500); constant outputs keep a zero off-diagonal
    out_corr = np.eye(len(out_names))
    live = np.where(mean.std(axis=0) > 0)[0]
    if len(live) > 1:
        sub = np.corrcoef(mean[:, live].T)
        # outputs that are constant to machine precision (e.g. a GP far
        # outside its data collapses to y_mean) produce NaN rows — zero them
        sub = np.nan_to_num(sub, nan=0.0)
        out_corr[np.ix_(live, live)] = sub
        np.fill_diagonal(out_corr, 1.0)

    return {
        "n_test_points": int(n),
        "prediction_stats": prediction_stats,
        "uncertainty_stats": uncertainty_stats,
        "correlations": correlations,
        "output_correlations": out_corr.tolist(),
        "output_names": out_names,
        "_mean": mean,   # raw arrays for the plot surfaces (not JSON)
        "_std": std,
        "_X": X,
    }


def run_complete_gp_analysis(
    predict_fn: Callable[[np.ndarray], tuple],
    out_prefix: str,
    test_points: np.ndarray | None = None,
) -> Dict:
    """The ``run_complete_evaluation`` role (``gp_evaluation.py:551-575``):
    full quantitative report + the reference's three figures —
    ``<prefix>_distributions.png`` (per-output mean/std histograms),
    ``<prefix>_uncertainty.png`` (uncertainty vs velocity/acceleration/
    altitude + histogram), ``<prefix>_correlations.png`` (output-output
    residual correlation heatmap). Returns the JSON-able report (raw
    arrays stripped)."""
    from ..metrics.plots import (
        plot_gp_output_correlations,
        plot_gp_prediction_distributions,
        plot_gp_uncertainty_analysis,
    )

    report = analyze_gp_model(predict_fn, test_points)
    mean, std, X = report.pop("_mean"), report.pop("_std"), report.pop("_X")
    names = report["output_names"]
    plot_gp_prediction_distributions(
        mean, std, f"{out_prefix}_distributions.png", names
    )
    plot_gp_uncertainty_analysis(X, std, f"{out_prefix}_uncertainty.png")
    plot_gp_output_correlations(
        np.asarray(report["output_correlations"]),
        f"{out_prefix}_correlations.png", names,
    )
    return report
