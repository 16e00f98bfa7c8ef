"""Plants: double integrator and the PX4 rate-loop surrogate."""

from .double_integrator import CONTROL_DIM, STATE_DIM, double_integrator_step
from .params import RigidBodyParams
from .px4_surrogate import RateLoopParams, px4_rate_tracking_step

__all__ = [
    "CONTROL_DIM", "STATE_DIM", "double_integrator_step", "RigidBodyParams",
    "RateLoopParams", "px4_rate_tracking_step",
]
