"""The latency tier with everything on: in-flight GP learning inside the
fused multi-tick kernel, constraint tightening from the in-kernel posterior
variance, the divergence-triggered recovery fallback, and a
dispersed-plant Monte-Carlo study on the same tier.

The PyTorch/CUDA counterpart of ``examples/09_online_fused_and_safety.py``.
The GP the kernel flies is refit from the ring buffer every 5 s of flight
time (the reference's retrain policy, gaussian_process.py:122); plant
parameters and wind are kernel operands. The population runs the
multi-tick kernel with one block per flight, which takes no variance
section: its MPC is the same one untightened.

Run from the repo root: ``python examples_torch/09_online_fused_and_safety.py``.
"""

import dataclasses

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    MonteCarloConfig,
    OnlineFusedGPConfig,
    monte_carlo_mpc,
    mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.models import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

dev = resolve_device(example_device())
mpc_cfg = LinearMPCConfig(
    horizon=20,
    admm_iterations=10,
    use_fused_controller=True,
    tightening_factor=2.0,   # back the state boxes off by 2 sigma of the in-kernel GP std
)
mpc = LinearMPC(mpc_cfg, device=dev)
cfg = FlightLoopConfig(
    use_fused_tick=True,
    ticks_per_dispatch=8,        # 8 whole ticks per kernel launch
    fallback_error_m=1.5,        # divergence-triggered recovery (in the kernel)
)


def reference(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
    return pos + torch.tensor([0.0, 0.0, cfg.takeoff_height], dtype=pos.dtype,
                              device=pos.device), yaw


# --- 1. online learning under an unmodelled steady wind -------------------
windy = RigidBodyParams(wind=(1.5, 0.8, 0.0))
ogp = OnlineFusedGPConfig(
    gp=ResidualGPConfig(max_data_points=256, residual_gain=1.0),
    refit_every=scaled(250, 64),
)
T = scaled(2000, 256)
plain = mpc_flight_rollout(mpc, reference, T, body=windy, cfg=cfg, preview=True, device=dev)
online = mpc_flight_rollout(mpc, reference, T, body=windy, cfg=cfg, preview=True,
                            online_gp=ogp, gp_gain=1.0, device=dev)


def rms_tail(outs):
    e = np.linalg.norm((outs["pos_ref"] - outs["state"][:, 0:3]).cpu().numpy(), axis=1)
    return float(np.sqrt((e[scaled(1000, 128):] ** 2).mean()))


print(f"windy fig-8, plain MPC:        {rms_tail(plain):.3f} m RMS")
print(f"windy fig-8, ONLINE GP-MPC:    {rms_tail(online):.3f} m RMS "
      f"({int(online['gp_count'][-1])} samples learned in flight)")

# --- 2. dispersed-plant Monte-Carlo on the multi-tick kernel -------------
population_mpc = LinearMPC(dataclasses.replace(mpc_cfg, tightening_factor=0.0), device=dev)
n = scaled(64, 8)
stats = monte_carlo_mpc(
    population_mpc, reference, scaled(1504, 256),
    mc=MonteCarloConfig(n_rollouts=n, wind_std=0.8),
    loop_cfg=cfg, device=dev,
)
print(
    f"{n}-flight dispersion study (multi-tick kernel, a block per flight): "
    f"success {float(stats['success_rate']) * 100:.1f} %, "
    f"worst excursion {float(stats['worst_max_pos']):.2f} m, "
    f"median RMS {float(stats['rms_p50']):.3f} m"
)
