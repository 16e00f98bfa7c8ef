"""Reference trajectories."""

from .flight_patterns import ramped_circle_reference, ramped_figure8_reference

__all__ = ["ramped_circle_reference", "ramped_figure8_reference"]
