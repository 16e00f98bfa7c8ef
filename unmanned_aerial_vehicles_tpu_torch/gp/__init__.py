"""Exact GP and the residual-dynamics ring buffer."""

from .exact_gp import GPParams, GPPosterior, fit_gp, predict_mean
from .residual_gp import (
    ResidualDataset,
    ResidualGPConfig,
    add_training_samples_batch,
    build_horizon_residuals,
    build_horizon_residuals_batched_fused,
    default_params,
    empty_dataset,
    fit_residual_gp,
    fit_residual_gp_masked,
    masked_input_stats,
    standardized_params,
)

__all__ = [
    "GPParams", "GPPosterior", "fit_gp", "predict_mean", "ResidualDataset",
    "ResidualGPConfig", "add_training_samples_batch", "build_horizon_residuals",
    "build_horizon_residuals_batched_fused",
    "default_params", "empty_dataset", "fit_residual_gp", "fit_residual_gp_masked",
    "masked_input_stats", "standardized_params",
]
