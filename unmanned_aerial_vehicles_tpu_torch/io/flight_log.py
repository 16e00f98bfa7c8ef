"""Flight-log recording and post-hoc analysis: the rosbag-analyser role
(port of ``io/flight_log.py``).

The reference records every run as a rosbag with an explicit topic list
and extracts metrics afterwards with sqlite queries and NumPy
(``src/px4/enhanced_plot_mpc_bag.py:446-998`` of the reference). Here a
"bag" is the output dict of a rollout, saved as one npz (or a streaming
``.uavlog``), loaded as numpy arrays and analysed with the same formulas
(``metrics.tracking``). Signals are tick-synchronous by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..metrics.tracking import tracking_metrics
from .uavlog import _host


def save_flight_log(path: str, outs: dict, **metadata):
    """Persist a rollout's output dict (tensors or arrays) and scalar
    metadata.

    ``.uavlog`` paths use the streaming binary format (``io.uavlog``,
    per-tick channels only); anything else is one compressed npz (the
    whole dict, run-level entries included)."""
    if path.endswith(".uavlog"):
        from .uavlog import write_uavlog

        write_uavlog(path, outs)
        return
    arrays = {k: _host(v) for k, v in outs.items()}
    for k, v in metadata.items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_flight_log(path: str) -> dict:
    """Load either format (told apart by the file's magic, not its name)
    as numpy arrays."""
    from .uavlog import MAGIC, read_uavlog

    with open(path, "rb") as f:
        magic = f.read(8)
    if magic == MAGIC:
        return read_uavlog(path)
    data = np.load(path)
    return {k: data[k] for k in data.files}


def analyze_flight_log(log: dict) -> dict:
    """The reference's ``compute_metrics`` (``enhanced_plot_mpc_bag.py:
    640-722``) on a saved rollout: RMS and max position error, RMS velocity
    error, attitude RMSE (deg), thrust saturation %. Computed on CPU
    tensors in the log's own dtype."""
    t = lambda v: torch.as_tensor(_host(v))
    state = t(log["state"])
    kwargs = {}
    if "vel_ref" in log:
        kwargs["vel_setpoint"] = t(log["vel_ref"])
        kwargs["vel_current"] = state[..., 3:6]
    if "att_ref" in log:
        kwargs["att_setpoint"] = t(log["att_ref"])
        kwargs["att_current"] = state[..., 6:9]
    if "thrust" in log:
        kwargs["thrust_normalized"] = t(log["thrust"])
    m = tracking_metrics(t(log["pos_ref"]), state[..., 0:3], **kwargs)
    return {k: float(v) for k, v in m.items()}
