"""Checkpoints of the port's own objects."""

from .checkpoint import load_resume_state, save_resume_state

__all__ = ["load_resume_state", "save_resume_state"]
