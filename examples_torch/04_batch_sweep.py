"""Sharded batch sweep: closed-loop flights split over the process group.

The PyTorch/CUDA counterpart of ``examples/04_batch_sweep.py``. Without a
``torch.distributed`` process group the mesh is a world of one (this
card); under ``torchrun`` each rank flies its share of the batch.
Run from the repo root: ``python examples_torch/04_batch_sweep.py``.
"""

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp import fit_residual_gp
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig, mpc_flight_rollout
from unmanned_aerial_vehicles_tpu_torch.parallel import (
    make_mesh,
    sharded_flight_sweep,
    sharded_structured_flight_sweep,
)
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

dev = resolve_device(example_device())
cfg = FlightLoopConfig(use_pallas_plant=True)          # the allocation and plant kernel
mpc = LinearMPC(LinearMPCConfig(use_fused_controller=True), device=dev)  # the solve kernel


def reference(t):
    pos, yaw = ramped_figure8_reference(t)
    return pos + torch.tensor([0.0, 0.0, cfg.takeoff_height], dtype=pos.dtype,
                              device=pos.device), yaw


def one_flight(x0):
    return mpc_flight_rollout(mpc, reference, scaled(1000, 128), cfg=cfg, initial_state=x0,
                              device=dev)


B = scaled(64, 16)
starts = torch.zeros(B, 12, dtype=torch.float32, device=dev)
starts[:, 2] = cfg.takeoff_height
starts[:, 0] = torch.linspace(-2.0, 2.0, B, device=dev)

mesh = make_mesh(device=dev)
result = sharded_flight_sweep(mesh, one_flight, starts)
print(f"{B} flights on {mesh.world_size} process(es): "
      f"rms mean {float(result['rms_mean']):.3f} m, "
      f"max {float(result['rms_max']):.3f} m")

# -- throughput mode: every flight in lockstep, one structured controller
# kernel launch a tick for the whole batch, the GP residual stage through
# the fused posterior-mean kernel (the (B*N, n_train) cross-covariance
# never reaches global memory)
gp_cfg = ResidualGPConfig()
rng = np.random.default_rng(0)
post = fit_residual_gp(
    torch.as_tensor(rng.normal(size=(scaled(400, 64), 10)), dtype=torch.float32, device=dev),
    torch.as_tensor(0.05 * rng.normal(size=(scaled(400, 64), 6)), dtype=torch.float32,
                    device=dev),
    gp_cfg,
)
mpc_fused = LinearMPC(LinearMPCConfig(use_fused_controller=True), device=dev)
result_k = sharded_structured_flight_sweep(
    mesh, mpc_fused, reference, scaled(500, 64), starts,
    gp_posterior=post, gp_cfg=gp_cfg, gp_fused_precision="high",
)
print(f"structured GP-MPC sweep (fused GP kernel): "
      f"rms mean {float(result_k['rms_mean']):.3f} m, "
      f"max {float(result_k['rms_max']):.3f} m")
