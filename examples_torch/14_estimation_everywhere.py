"""Estimation across every tier: multi-rate LTV and learning from estimates.

The PyTorch/CUDA counterpart of ``examples/14_estimation_everywhere.py``.
(1) ``noisy_ltv_rollout``: the LTV tracking MPC (the cvxpy engine's role,
``quadrotor_gp_mpc/mpc_controller.py:123-368``) over a multi-rate
estimator: plant and rigid-body EKF at the 100 Hz sensor rate, the solve
every 10th plant tick flying the estimate (the reference's 100 Hz plant
under its 10 Hz timer, ``main.py:814-826``); obstacle rows compose. (2)
online and noisy on the fused 6-state path: the in-flight GP trains on
EKF estimates (the reference's captured state is PX4-EKF2 output,
``src/px4/mpc.py:1889-1907,2016-2021``) and still recovers the
wind-induced tracking penalty.

Run from the repo root: ``python examples_torch/14_estimation_everywhere.py``.
"""

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control import LTVTrackingMPC
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.estimation import (
    EKFConfig,
    noisy_ltv_rollout,
    noisy_mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig, OnlineFusedGPConfig
from unmanned_aerial_vehicles_tpu_torch.models import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.trajectories import (
    ramped_circle_reference,
    ramped_figure8_reference,
)
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

dev = resolve_device(example_device())
f32 = dict(dtype=torch.float32, device=dev)

# --- 1. multi-rate estimation for the LTV engine ------------------------
LDT = 0.1
HEIGHT = 3.0
mpc_ltv = LTVTrackingMPC(num_obstacles=1, obstacle_margin=0.2, device=dev)
N = mpc_ltv.mpc.config.horizon
obstacles = torch.tensor([[0.0, 1.5, HEIGHT, 0.3]], **f32)


def window_at(i):
    ts = (i + torch.arange(N + 1, device=dev)).to(torch.float32) * LDT
    pos, _, _ = ramped_circle_reference(ts, amplitude=1.5, height=HEIGHT)
    return torch.cat([pos, torch.zeros(N + 1, 9, **f32)], dim=1)


STEPS10 = scaled(100, 12)
outs = noisy_ltv_rollout(mpc_ltv, window_at, STEPS10, torch.Generator(dev).manual_seed(0),
                         ekf_cfg=EKFConfig(), obstacles=obstacles, device=dev)
st = outs["state"].cpu().numpy()
est = outs["state_est"].cpu().numpy()
ref_pos = outs["pos_ref"].cpu().numpy()
rms = float(np.sqrt(np.mean(np.sum((st[:, 0:3] - ref_pos) ** 2, -1))))
est_err = float(np.sqrt(np.mean(np.sum((est[2:, 0:3] - st[2:, 0:3]) ** 2, -1))))
obs = obstacles.cpu().numpy()
d = st[:, None, 0:3] - obs[None, :, 0:3]
clear = float(np.min(np.sqrt(np.sum(d ** 2, -1)) - obs[None, :, 3]))
print(f"ltv12 multi-rate noisy tier ({STEPS10} solves @ 10 Hz, 10 EKF "
      f"subticks @ 100 Hz each): tracking RMS {rms:.4f} m, estimate RMS "
      f"{est_err * 100:.1f} cm, obstacle clearance {clear:.3f} m")

# --- 2. online learning from EKF estimates (wind recovery) --------------
windy = RigidBodyParams(wind=(1.5, 0.8, 0.0))
STEPS = scaled(1600, 160)
TAIL = STEPS // 2


def ref(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
    return pos + torch.tensor([0.0, 0.0, HEIGHT], dtype=pos.dtype, device=pos.device), yaw


mpc = LinearMPC(LinearMPCConfig(horizon=20, admm_iterations=60, use_fused_controller=True),
                device=dev)
cfg = FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=8)
ekf_cfg = EKFConfig()
gen = lambda: torch.Generator(dev).manual_seed(2)

plain = noisy_mpc_flight_rollout(mpc, ref, STEPS, gen(), ekf_cfg=ekf_cfg, body=windy, cfg=cfg,
                                 preview=True, device=dev)
ogp = OnlineFusedGPConfig(
    gp=ResidualGPConfig(max_data_points=256, residual_gain=1.0),
    refit_every=scaled(200, 48),  # the short run must refit too
)
online = noisy_mpc_flight_rollout(mpc, ref, STEPS, gen(), ekf_cfg=ekf_cfg, body=windy, cfg=cfg,
                                  preview=True, online_gp=ogp, gp_gain=1.0, device=dev)


def tail_rms(o):
    e = np.linalg.norm((o["pos_ref"] - o["state"][:, 0:3]).cpu().numpy(), axis=1)
    return float(np.sqrt((e[TAIL:] ** 2).mean()))


print(f"windy fig-8, learning FROM ESTIMATES ({STEPS} ticks): plain noisy "
      f"{tail_rms(plain):.3f} m -> online-noisy {tail_rms(online):.3f} m "
      f"(GP samples {int(online['gp_count'][-1])}; capture, refit, EKF and solve "
      f"on the fused multi-tick path)")
