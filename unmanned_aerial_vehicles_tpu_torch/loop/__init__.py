"""Closed-loop flights: the 6-state GP-MPC loops, sweep and Monte Carlo
populations, and the 12-state SQP and iLQR multi-tick tiers."""

from .closed_loop import (
    FlightLoopConfig,
    FlightResumeState,
    OnlineFusedGPConfig,
    batched_mpc_flight_rollout,
    batched_mpc_flight_sweep,
    batched_pid_flight_rollout,
    mpc_flight_rollout,
    pid_flight_rollout,
    plant_block,
)
from .monte_carlo import (
    MonteCarloConfig,
    monte_carlo_flights,
    monte_carlo_mpc,
    monte_carlo_mpc12,
    monte_carlo_pid,
    robustness_stats,
    sample_conditions,
)
from .rigid_loop import (
    MultiTickCarry,
    direct_rate_multitick_fused,
    ilqr_multitick_rollout,
    make_attitude_recovery_fallback,
    rigid_multitick_fused,
    sqp_multitick_population,
    sqp_multitick_rollout,
)

__all__ = [
    "FlightLoopConfig", "FlightResumeState", "OnlineFusedGPConfig", "batched_mpc_flight_rollout",
    "batched_mpc_flight_sweep", "batched_pid_flight_rollout", "mpc_flight_rollout",
    "pid_flight_rollout", "plant_block",
    "MonteCarloConfig", "monte_carlo_flights", "monte_carlo_mpc", "monte_carlo_mpc12",
    "monte_carlo_pid", "robustness_stats", "sample_conditions",
    "MultiTickCarry", "direct_rate_multitick_fused", "ilqr_multitick_rollout",
    "make_attitude_recovery_fallback",
    "rigid_multitick_fused", "sqp_multitick_population", "sqp_multitick_rollout",
]
