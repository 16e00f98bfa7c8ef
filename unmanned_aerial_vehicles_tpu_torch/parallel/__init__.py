"""Batch sweeps of flights (one card; sharding across cards is queued in
ROADMAP.md)."""

from .sweep import structured_flight_sweep

__all__ = ["structured_flight_sweep"]
