"""Physical parameter sets for the quadrotor plants (port of
``models/params.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class RigidBodyParams:
    """12-state rigid-body quadrotor parameters.

    ``wind`` is a steady world-frame wind velocity (m/s): drag acts on the
    airspeed ``v - wind``; zero wind is the reference's drag term."""

    mass: float = 0.5
    gravity: float = 9.81
    inertia_xx: float = 0.0023
    inertia_yy: float = 0.0023
    inertia_zz: float = 0.0046
    k_drag_linear: float = 0.25
    k_drag_angular: float = 0.01
    wind: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def hover_thrust(self) -> float:
        return self.mass * self.gravity
