"""Reference trajectories: the analytic families and the flight nodes'
ramped patterns."""

from .families import (
    TRAJECTORY_CONFIGS,
    available_trajectories,
    circular_trajectory,
    cloverleaf_trajectory,
    figure_8_trajectory,
    get_trajectory_function,
    hover_trajectory,
    lemniscate_trajectory,
    oval_trajectory,
    sine_wave_trajectory,
    spiral_trajectory,
    square_trajectory,
    waypoint_trajectory,
)
from .flight_patterns import ramped_circle_reference, ramped_figure8_reference

__all__ = [
    "TRAJECTORY_CONFIGS",
    "available_trajectories",
    "circular_trajectory",
    "cloverleaf_trajectory",
    "figure_8_trajectory",
    "get_trajectory_function",
    "hover_trajectory",
    "lemniscate_trajectory",
    "oval_trajectory",
    "sine_wave_trajectory",
    "spiral_trajectory",
    "square_trajectory",
    "waypoint_trajectory",
    "ramped_circle_reference",
    "ramped_figure8_reference",
]
