"""Plants: double integrator, PX4 rate-loop surrogate, 12-state rigid body,
parameters."""

from .double_integrator import (
    CONTROL_DIM,
    STATE_DIM,
    discrete_system_matrices,
    double_integrator_derivative,
    double_integrator_step,
)
from .params import COMPARISON_PARAMS, GZ_QUADROTOR_PARAMS, X500_PARAMS, RigidBodyParams
from .px4_surrogate import PID_CAMPAIGN_RATE_LOOP, RateLoopParams, px4_rate_tracking_step
from .rigid_body import rigid_body_derivative, rigid_body_euler_step, rigid_body_rk4_step

__all__ = [
    "CONTROL_DIM", "STATE_DIM", "discrete_system_matrices", "double_integrator_derivative", "double_integrator_step",
    "RigidBodyParams",
    "COMPARISON_PARAMS", "GZ_QUADROTOR_PARAMS", "X500_PARAMS",
    "PID_CAMPAIGN_RATE_LOOP", "RateLoopParams", "px4_rate_tracking_step",
    "rigid_body_derivative", "rigid_body_euler_step", "rigid_body_rk4_step",
]
