"""Flight datasets (the native CSV parser), GP and mid-flight resume
checkpoints, flight logs (npz and the streaming ``uavlog`` recorder), the
reference's sklearn GP pickles, and synthetic excitation data with
least-squares system identification."""

from .checkpoint import load_gp_checkpoint, load_resume_state, save_gp_checkpoint, save_resume_state
from .datasets import CSV_HEADER, load_gp_dataset, load_gp_datasets, save_gp_dataset
from .fast_csv import load_numeric_csv, native_available
from .flight_log import analyze_flight_log, load_flight_log, save_flight_log
from .sklearn_import import load_reference_gp, load_sklearn_gp_pickle, load_sklearn_perdim_pickle
from .synthetic import generate_excitation_data, identify_linear_dynamics
from .uavlog import UavLogWriter, read_uavlog, write_uavlog

__all__ = [
    "CSV_HEADER",
    "load_numeric_csv",
    "native_available",
    "load_gp_dataset",
    "load_gp_datasets",
    "save_gp_dataset",
    "load_gp_checkpoint",
    "save_gp_checkpoint",
    "load_resume_state",
    "save_resume_state",
    "analyze_flight_log",
    "load_flight_log",
    "save_flight_log",
    "load_reference_gp",
    "load_sklearn_gp_pickle",
    "load_sklearn_perdim_pickle",
    "generate_excitation_data",
    "identify_linear_dynamics",
    "UavLogWriter",
    "read_uavlog",
    "write_uavlog",
]
