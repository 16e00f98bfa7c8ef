"""Workload scaling for runnable examples (port of ``utils/examples.py``).

Examples route their workload sizes through :func:`scaled`, so that a
smoke run with ``UAV_FAST_EXAMPLES=1`` finishes quickly while the default
invocation keeps the full workload, and take their device from
:func:`example_device` (``UAV_EXAMPLES_DEVICE``; unset, the entry points'
default, ``cuda``).
"""

from __future__ import annotations

import os

__all__ = ["example_device", "fast_examples", "scaled"]


def fast_examples() -> bool:
    """True when ``UAV_FAST_EXAMPLES`` is set (smoke mode)."""
    return bool(os.environ.get("UAV_FAST_EXAMPLES"))


def scaled(full, fast):
    """``full`` normally; ``fast`` under ``UAV_FAST_EXAMPLES=1``."""
    return fast if fast_examples() else full


def example_device():
    """``UAV_EXAMPLES_DEVICE`` when set (``cpu`` runs the kernels' plain
    versions), else ``None``: the entry points resolve it to ``cuda`` and
    raise without a GPU."""
    return os.environ.get("UAV_EXAMPLES_DEVICE") or None
