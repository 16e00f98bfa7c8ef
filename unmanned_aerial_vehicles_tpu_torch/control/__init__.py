"""Controllers: allocation, cascade PID, condensed linear MPC, the 12-state
SQP family and MPPI."""

from .allocation import AttitudeLoopState, attitude_loop_init, geometric_control_allocation
from .mpc_linear import LinearMPC, LinearMPCConfig, MPCCarry
from .mpc_rigid import DirectRateMPC, LTVTrackingMPC, RigidBodyMPC, direct_rate_step
from .mpc_sqp import QuadCost, SQPCarry, SQPConfig, SQPMPC
from .mppi import MPPICarry, MPPIConfig, MPPIController

__all__ = [
    "AttitudeLoopState", "attitude_loop_init", "geometric_control_allocation",
    "LinearMPC", "LinearMPCConfig", "MPCCarry",
    "DirectRateMPC", "LTVTrackingMPC", "RigidBodyMPC", "direct_rate_step",
    "QuadCost", "SQPCarry", "SQPConfig", "SQPMPC",
    "MPPICarry", "MPPIConfig", "MPPIController",
]
