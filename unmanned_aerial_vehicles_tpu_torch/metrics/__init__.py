"""Tracking metrics, the GP and MPC performance aggregates, and the plots
(matplotlib is imported only when a plot is drawn)."""

from .performance import (
    MetricsLogger,
    constraint_violations,
    gp_metrics_summary,
    measure_time,
    mpc_metrics_summary,
)
from .plots import plot_comparison, plot_flight_log, plot_robustness
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
    "plot_comparison",
    "plot_flight_log",
    "plot_robustness",
    "attitude_rmse_deg",
    "max_position_error",
    "rms_position_error",
    "rms_velocity_error",
    "thrust_saturation_informative_pct",
    "thrust_saturation_pct",
    "tracking_metrics",
]
