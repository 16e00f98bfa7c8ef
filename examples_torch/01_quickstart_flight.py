"""Quickstart: a GP-enhanced MPC figure-8 flight on the card.

The PyTorch/CUDA counterpart of ``examples/01_quickstart_flight.py``.

Run from the repo root (the flight CSVs' glob as the optional argument):

    python examples_torch/01_quickstart_flight.py 'gp_datasets/*.csv'
    UAV_EXAMPLES_DEVICE=cpu python examples_torch/01_quickstart_flight.py ...
"""

import glob
import sys

import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp import build_horizon_residuals, fit_residual_gp
from unmanned_aerial_vehicles_tpu_torch.io import load_gp_datasets
from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig, mpc_flight_rollout
from unmanned_aerial_vehicles_tpu_torch.metrics import tracking_metrics
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

DATA = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/gp_datasets/*.csv"
dev = resolve_device(example_device())

# 1. flight data -> residual GP training set
paths = sorted(glob.glob(DATA))
if not paths:
    sys.exit(f"no flight CSVs match {DATA!r}: pass their glob as the first argument")
X, Y = load_gp_datasets(paths, max_samples=scaled(800, 128))

# 2. the controller and the loop configuration: N=25 condensed-QP GP-MPC,
# 50 Hz control, 100 Hz plant; each solve through the fused controller
# kernel and the plant substeps through the plant kernel
mpc = LinearMPC(LinearMPCConfig(use_fused_controller=True), device=dev)
cfg = FlightLoopConfig(use_pallas_plant=True)


def reference(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
    return pos + torch.tensor([0.0, 0.0, cfg.takeoff_height], dtype=pos.dtype,
                              device=pos.device), yaw


# 3. GP fit + 60 s closed loop
post = fit_residual_gp(torch.as_tensor(X, dtype=torch.float32, device=dev),
                       torch.as_tensor(Y, dtype=torch.float32, device=dev))
rf = lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug)
outs = mpc_flight_rollout(mpc, reference, scaled(3000, 200), cfg=cfg, residual_fn=rf,
                          device=dev)
m = tracking_metrics(outs["pos_ref"], outs["state"][:, 0:3], thrust_normalized=outs["thrust"])
print({k: round(float(v), 4) for k, v in m.items()})
