"""Tracking metrics and the GP and MPC performance aggregates (plots and
animations are not ported)."""

from .performance import (
    MetricsLogger,
    constraint_violations,
    gp_metrics_summary,
    measure_time,
    mpc_metrics_summary,
)
from .tracking import (
    attitude_rmse_deg,
    max_position_error,
    rms_position_error,
    rms_velocity_error,
    thrust_saturation_informative_pct,
    thrust_saturation_pct,
    tracking_metrics,
)

__all__ = [
    "MetricsLogger",
    "constraint_violations",
    "gp_metrics_summary",
    "measure_time",
    "mpc_metrics_summary",
    "attitude_rmse_deg",
    "max_position_error",
    "rms_position_error",
    "rms_velocity_error",
    "thrust_saturation_informative_pct",
    "thrust_saturation_pct",
    "tracking_metrics",
]
