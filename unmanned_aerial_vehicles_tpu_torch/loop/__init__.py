"""Closed-loop flights: the 6-state GP-MPC loops and sweep, and the 12-state
SQP family's multi-tick tiers."""

from .closed_loop import (
    FlightLoopConfig,
    FlightResumeState,
    OnlineFusedGPConfig,
    batched_mpc_flight_sweep,
    mpc_flight_rollout,
    pid_flight_rollout,
)
from .rigid_loop import (
    MultiTickCarry,
    direct_rate_multitick_fused,
    make_attitude_recovery_fallback,
    rigid_multitick_fused,
    sqp_multitick_rollout,
)

__all__ = [
    "FlightLoopConfig", "FlightResumeState", "OnlineFusedGPConfig", "batched_mpc_flight_sweep", "mpc_flight_rollout",
    "pid_flight_rollout",
    "MultiTickCarry", "direct_rate_multitick_fused", "make_attitude_recovery_fallback",
    "rigid_multitick_fused", "sqp_multitick_rollout",
]
