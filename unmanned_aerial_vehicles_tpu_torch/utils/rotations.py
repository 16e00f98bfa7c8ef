"""Rotation / attitude helpers (port of ``utils/rotations.py``).

ZYX Euler rotation matrix and Euler-rate transform, elementwise over leading
batch dimensions.
"""

from __future__ import annotations

import math

import torch


def wrap_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi) as a floor-mod: ``(a + pi) mod 2 pi - pi``.

    ``torch.remainder`` takes the sign of the divisor, exactly as
    ``jnp.remainder`` does (C's ``fmod`` alone would not)."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def euler_to_rotation_matrix(phi, theta, psi) -> torch.Tensor:
    """Body->world rotation matrix, ZYX convention (R = Rz @ Ry @ Rx).
    Returns shape ``(..., 3, 3)``."""
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)

    r00 = cth * cpsi
    r01 = sphi * sth * cpsi - cphi * spsi
    r02 = cphi * sth * cpsi + sphi * spsi
    r10 = cth * spsi
    r11 = sphi * sth * spsi + cphi * cpsi
    r12 = cphi * sth * spsi - sphi * cpsi
    r20 = -sth
    r21 = sphi * cth
    r22 = cphi * cth
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def euler_rate_transform(phi, theta) -> torch.Tensor:
    """W(phi, theta): body rates [p,q,r] -> Euler-angle rates, with the
    ``|cos(theta)| >= 1e-6`` singularity guard. Returns ``(..., 3, 3)``."""
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth = torch.cos(theta)
    tth = torch.tan(theta)

    # sign-preserving clamp away from the theta = +-pi/2 singularity
    eps = torch.where(cth < 0.0, torch.full_like(cth, -1e-6), torch.full_like(cth, 1e-6))
    cth_safe = torch.where(cth.abs() < 1e-6, eps, cth)

    one = torch.ones_like(cphi)
    zero = torch.zeros_like(cphi)
    return torch.stack(
        [
            torch.stack([one, sphi * tth, cphi * tth], dim=-1),
            torch.stack([zero, cphi, -sphi], dim=-1),
            torch.stack([zero, sphi / cth_safe, cphi / cth_safe], dim=-1),
        ],
        dim=-2,
    )


def euler_to_quaternion(roll, pitch, yaw) -> torch.Tensor:
    """ZYX Euler angles -> quaternion ``[w, x, y, z]``, shape ``(..., 4)``."""
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)

    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([w, x, y, z], dim=-1)


def quaternion_to_euler(q: torch.Tensor) -> torch.Tensor:
    """Quaternion ``[w, x, y, z]`` ``(..., 4)`` -> Euler ``[roll, pitch,
    yaw]`` ``(..., 3)``; the pitch is clamped to +-pi/2 where ``|sin p| >=
    1``."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    sinp = 2.0 * (w * y - z * x)
    pitch = torch.where(torch.abs(sinp) >= 1.0, torch.sign(sinp) * (math.pi / 2.0),
                        torch.arcsin(torch.clamp(sinp, -1.0, 1.0)))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)
