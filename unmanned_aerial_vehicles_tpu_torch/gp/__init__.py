"""Exact GP and the residual-dynamics ring buffer."""

from .exact_gp import GPParams, GPPosterior, fit_gp, predict, predict_mean
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

__all__ = [
    "GPParams", "GPPosterior", "fit_gp", "predict", "predict_mean", "OutputCorrectionConfig",
    "ResidualDataset", "ResidualGPConfig", "add_training_sample", "add_training_samples_batch",
    "build_horizon_residuals", "build_horizon_residuals_batched_fused",
    "build_horizon_uncertainty", "default_params", "empty_dataset", "fit_residual_gp",
    "fit_residual_gp_masked", "make_output_correction_fn", "masked_input_stats",
    "output_correction", "predict_residual", "standardized_params",
]
