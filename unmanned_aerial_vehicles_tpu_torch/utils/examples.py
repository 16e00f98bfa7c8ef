"""Workload scaling for runnable examples (port of ``utils/examples.py``).

Examples route their workload sizes through :func:`scaled`, so that a
smoke run with ``UAV_FAST_EXAMPLES=1`` finishes quickly while the default
invocation keeps the full workload.
"""

from __future__ import annotations

import os

__all__ = ["fast_examples", "scaled"]


def fast_examples() -> bool:
    """True when ``UAV_FAST_EXAMPLES`` is set (smoke mode)."""
    return bool(os.environ.get("UAV_FAST_EXAMPLES"))


def scaled(full, fast):
    """``full`` normally; ``fast`` under ``UAV_FAST_EXAMPLES=1``."""
    return fast if fast_examples() else full
