"""Controllers: PID, cascade PID (and the comparison harness's), allocation,
condensed linear MPC, the RK4 demo and attitude MPCs, the 12-state SQP
family, iLQR and MPPI."""

from .pid import PIDGains, PIDState, pid_init, pid_step
from .cascade_pid import (
    CascadePidGains,
    CascadeState,
    ComparisonPidParams,
    cascade_init,
    cascade_pid_step,
    comparison_pid_init,
    comparison_pid_step,
)
from .allocation import (
    AttitudeLoopState,
    attitude_loop_init,
    geometric_control_allocation,
    torque_to_px4_rates,
    with_hover_fallback,
)
from .mpc_linear import LinearMPC, LinearMPCConfig, MPCCarry
from .mpc_rigid import DirectRateMPC, LTVTrackingMPC, RigidBodyMPC, direct_rate_step
from .mpc_sqp import QuadCost, SQPCarry, SQPConfig, SQPMPC
from .mpc_demo import AttitudeMPC, RK4DemoMPC
from .ilqr import ILQRRigidBodyMPC, ilqr_solve
from .mppi import MPPICarry, MPPIConfig, MPPIController

__all__ = [
    "PIDGains", "PIDState", "pid_init", "pid_step",
    "CascadePidGains", "CascadeState", "cascade_init", "cascade_pid_step",
    "ComparisonPidParams", "comparison_pid_init", "comparison_pid_step",
    "AttitudeLoopState", "attitude_loop_init", "geometric_control_allocation",
    "torque_to_px4_rates", "with_hover_fallback",
    "LinearMPC", "LinearMPCConfig", "MPCCarry",
    "DirectRateMPC", "LTVTrackingMPC", "RigidBodyMPC", "direct_rate_step",
    "QuadCost", "SQPCarry", "SQPConfig", "SQPMPC",
    "AttitudeMPC", "RK4DemoMPC",
    "ILQRRigidBodyMPC", "ilqr_solve",
    "MPPICarry", "MPPIConfig", "MPPIController",
]
