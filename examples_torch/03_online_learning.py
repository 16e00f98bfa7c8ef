"""Online learning: fly, collect residual data and retrain the GP in flight.

The PyTorch/CUDA counterpart of ``examples/03_online_learning.py``: one
host loop a tick around the staged solve (the fused controller kernel) and
the plant kernel, the ring buffer refitted every 5 s of flight time.
Run from the repo root: ``python examples_torch/03_online_learning.py``.
"""

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    OnlineGPMPCConfig,
    online_gp_mpc_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

dev = resolve_device(example_device())
cfg = OnlineGPMPCConfig(
    flight=FlightLoopConfig(use_pallas_plant=True),
    gp=ResidualGPConfig(max_data_points=400, residual_gain=1.0),
    gp_refit_every=scaled(250, 64),  # 5 s at 50 Hz (the reference's training timer)
)
mpc = LinearMPC(LinearMPCConfig(use_fused_controller=True), device=dev)


def reference(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
    return pos + torch.tensor([0.0, 0.0, cfg.flight.takeoff_height], dtype=pos.dtype,
                              device=pos.device), yaw


outs, dataset, posterior = online_gp_mpc_rollout(mpc, reference, scaled(3000, 200), cfg=cfg,
                                                 device=dev)
err = np.linalg.norm((outs["pos_ref"] - outs["state"][:, 0:3]).cpu().numpy(), axis=1)
print(f"samples collected in flight: {int(dataset.count)}")
print(f"fig-8 RMS with in-flight learning: {np.sqrt((err ** 2).mean()):.4f} m")
