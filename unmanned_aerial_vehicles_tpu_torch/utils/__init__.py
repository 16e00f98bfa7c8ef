"""Rotation, angle and quaternion helpers."""

from .rotations import (
    euler_rate_transform,
    euler_to_quaternion,
    euler_to_rotation_matrix,
    quaternion_to_euler,
    wrap_angle,
)

__all__ = ["euler_rate_transform", "euler_to_quaternion", "euler_to_rotation_matrix",
           "quaternion_to_euler", "wrap_angle"]
