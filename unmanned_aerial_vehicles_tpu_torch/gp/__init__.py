"""Exact GP (fit, prediction, the log marginal likelihood and its
maximisation), the residual-dynamics ring buffer, per-dimension GPs,
posterior compression and the offline evaluation."""

from .evaluate import evaluate_gp, evaluate_gp_residuals, write_metrics_csv
from .exact_gp import (
    GPParams,
    GPPosterior,
    fit_gp,
    log_marginal_likelihood,
    optimize_hyperparameters,
    optimize_hyperparameters_restarts,
    predict,
    predict_mean,
)
from .per_dim import (
    PerDimGP,
    Standardizer,
    build_horizon_residuals_per_dim,
    default_per_dim_params,
    fit_per_dim_gp,
    per_dim_training_report,
    predict_per_dim,
)
from .residual_gp import (
    OutputCorrectionConfig,
    ResidualDataset,
    ResidualGPConfig,
    add_training_sample,
    add_training_samples_batch,
    build_horizon_residuals,
    build_horizon_residuals_batched_fused,
    build_horizon_uncertainty,
    default_params,
    empty_dataset,
    fit_residual_gp,
    fit_residual_gp_masked,
    make_output_correction_fn,
    masked_input_stats,
    output_correction,
    predict_residual,
    standardized_params,
)
from .sparse import compress_posterior, compression_error, select_anchors

__all__ = [
    "evaluate_gp", "evaluate_gp_residuals", "write_metrics_csv",
    "GPParams", "GPPosterior", "fit_gp", "log_marginal_likelihood", "optimize_hyperparameters",
    "optimize_hyperparameters_restarts", "predict", "predict_mean",
    "PerDimGP", "Standardizer", "build_horizon_residuals_per_dim", "default_per_dim_params",
    "fit_per_dim_gp", "per_dim_training_report", "predict_per_dim",
    "compress_posterior", "compression_error", "select_anchors", "OutputCorrectionConfig",
    "ResidualDataset", "ResidualGPConfig", "add_training_sample", "add_training_samples_batch",
    "build_horizon_residuals", "build_horizon_residuals_batched_fused",
    "build_horizon_uncertainty", "default_params", "empty_dataset", "fit_residual_gp",
    "fit_residual_gp_masked", "make_output_correction_fn", "masked_input_stats",
    "output_correction", "predict_residual", "standardized_params",
]
