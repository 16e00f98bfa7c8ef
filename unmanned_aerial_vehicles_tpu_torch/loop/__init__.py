"""Closed-loop flights."""

from .closed_loop import (
    FlightLoopConfig,
    OnlineFusedGPConfig,
    mpc_flight_rollout,
    pid_flight_rollout,
)

__all__ = ["FlightLoopConfig", "OnlineFusedGPConfig", "mpc_flight_rollout", "pid_flight_rollout"]
