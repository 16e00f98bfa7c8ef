"""Rotation and angle helpers."""

from .rotations import euler_rate_transform, euler_to_rotation_matrix, wrap_angle

__all__ = ["euler_rate_transform", "euler_to_rotation_matrix", "wrap_angle"]
