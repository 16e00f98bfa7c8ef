"""Rotation, angle and quaternion helpers, the device timers and trace,
and the examples' workload scaling."""

from .examples import fast_examples, scaled
from .profiling import device_timeit, scan_slope_timeit, trace
from .rotations import (
    euler_rate_transform,
    euler_to_quaternion,
    euler_to_rotation_matrix,
    quaternion_to_euler,
    wrap_angle,
)

__all__ = ["fast_examples", "scaled", "device_timeit", "scan_slope_timeit", "trace",
           "euler_rate_transform", "euler_to_quaternion", "euler_to_rotation_matrix",
           "quaternion_to_euler", "wrap_angle"]
