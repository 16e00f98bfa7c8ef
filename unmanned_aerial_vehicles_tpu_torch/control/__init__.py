"""Controllers: allocation, cascade PID, condensed linear MPC."""

from .allocation import AttitudeLoopState, attitude_loop_init, geometric_control_allocation
from .mpc_linear import LinearMPC, LinearMPCConfig, MPCCarry

__all__ = [
    "AttitudeLoopState", "attitude_loop_init", "geometric_control_allocation",
    "LinearMPC", "LinearMPCConfig", "MPCCarry",
]
