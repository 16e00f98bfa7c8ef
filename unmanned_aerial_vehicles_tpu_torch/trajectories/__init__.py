"""Reference trajectories."""

from .flight_patterns import ramped_figure8_reference

__all__ = ["ramped_figure8_reference"]
