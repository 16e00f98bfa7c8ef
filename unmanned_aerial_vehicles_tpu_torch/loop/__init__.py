"""Closed-loop flights."""

from .closed_loop import (
    FlightLoopConfig,
    OnlineFusedGPConfig,
    batched_mpc_flight_sweep,
    mpc_flight_rollout,
    pid_flight_rollout,
)

__all__ = [
    "FlightLoopConfig", "OnlineFusedGPConfig", "batched_mpc_flight_sweep", "mpc_flight_rollout",
    "pid_flight_rollout",
]
