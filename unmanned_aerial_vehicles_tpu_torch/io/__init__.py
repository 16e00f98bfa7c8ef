"""GP and mid-flight resume checkpoints, and synthetic excitation data
with least-squares system identification."""

from .checkpoint import load_gp_checkpoint, load_resume_state, save_gp_checkpoint, save_resume_state
from .synthetic import generate_excitation_data, identify_linear_dynamics

__all__ = ["generate_excitation_data", "identify_linear_dynamics", "load_gp_checkpoint",
           "load_resume_state", "save_gp_checkpoint", "save_resume_state"]
