"""Differentiable closed-loop controller auto-tuning (port of ``tuning``):
gradient descent on the cascade-PID gains or the MPC cost weights through
whole flights, kernels included."""

from .autotune import (
    TuneConfig,
    TuningResult,
    mpc_config_from_theta,
    mpc_weights_theta,
    tune_cascade_gains,
    tune_cascade_gains_multistart,
    tune_mpc_weights,
    tune_parameters,
)

__all__ = [
    "TuneConfig",
    "TuningResult",
    "mpc_config_from_theta",
    "mpc_weights_theta",
    "tune_cascade_gains",
    "tune_cascade_gains_multistart",
    "tune_mpc_weights",
    "tune_parameters",
]
