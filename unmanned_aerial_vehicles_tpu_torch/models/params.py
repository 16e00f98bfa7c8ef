"""Physical parameter sets for the quadrotor plants (port of
``models/params.py``).

* ``GZ_QUADROTOR_PARAMS``: the standalone Gazebo-package quadrotor (the
  defaults), the LTV tracking MPC's model.
* ``X500_PARAMS``: the gz_x500 approximation of the 12-state MPC: mass 2.0,
  no drag terms.
* ``COMPARISON_PARAMS``: the standalone comparison harness: mass 1.225.
"""

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
    def inertia_diag(self) -> Tuple[float, float, float]:
        return (self.inertia_xx, self.inertia_yy, self.inertia_zz)

    @property
    def hover_thrust(self) -> float:
        return self.mass * self.gravity


GZ_QUADROTOR_PARAMS = RigidBodyParams()

X500_PARAMS = RigidBodyParams(
    mass=2.0,
    inertia_xx=0.0217,
    inertia_yy=0.0217,
    inertia_zz=0.04,
    k_drag_linear=0.0,
    k_drag_angular=0.0,
)

COMPARISON_PARAMS = RigidBodyParams(mass=1.225)
