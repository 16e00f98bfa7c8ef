"""12-state Monte-Carlo dispersion study + the EKF latency-tier knobs.

The PyTorch/CUDA counterpart of ``examples/12_mc12_and_ekf_tiers.py``.
(1) ``loop.monte_carlo_mpc12``: the torque-input 12-state family (the
reference's ``mpc_FULL.py:86-549`` formulation) flown as a population over
jittered true plants while the controller keeps its nominal model; members
whose hover demand reaches the engine's 1.2x-nominal thrust bound saturate
and tip, lighter members only sag. (2) the fused EKF tier's knobs:
``EKFConfig(relinearize_every="dispatch")`` rebuilds the filter's Jacobian
once a launch; ``cov_precision="bf16"`` is accepted for the JAX package's
signature, and on the card the covariance products compute in float32
either way.

Run from the repo root: ``python examples_torch/12_mc12_and_ekf_tiers.py``.
"""

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.control.mpc_rigid import RigidBodyMPC
from unmanned_aerial_vehicles_tpu_torch.estimation import EKFConfig, noisy_mpc_flight_rollout
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    MonteCarloConfig,
    monte_carlo_mpc12,
)
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

dev = resolve_device(example_device())


def reference(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


# --- 1. 12-state population robustness ---------------------------------
N_MEMBERS = scaled(64, 4)
STEPS = scaled(480, 64)

eng = RigidBodyMPC(device=dev)
mc = MonteCarloConfig(n_rollouts=N_MEMBERS, settle_steps=scaled(100, 16))
stats = monte_carlo_mpc12(eng, reference, STEPS, mc=mc, device=dev)
print(
    f"12-state MC ({N_MEMBERS} members, {STEPS} ticks): "
    f"success {float(stats['success_rate']) * 100:.1f}%, "
    f"RMS p50 {float(stats['rms_p50']):.2f} m, "
    f"p99 {float(stats['rms_p99']):.2f} m"
)
if not bool(torch.as_tensor(stats["success"]).all()):
    print("  crashed members are the HEAVY tail (hover demand at the 1.2x-nominal "
          "thrust bound); light members only sag: the asymmetric cliff a "
          "single-plant run cannot measure")

# --- 2. EKF tier knobs ---------------------------------------------------
EKF_STEPS = scaled(960, 64)
mpc_f = LinearMPC(LinearMPCConfig(horizon=20, admm_iterations=10, use_fused_controller=True),
                  device=dev)
cfg = FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=scaled(20, 8),
                       fused_tick_loop_precision="default")


def fly(ekf_cfg):
    outs = noisy_mpc_flight_rollout(mpc_f, reference, EKF_STEPS,
                                    torch.Generator(dev).manual_seed(0), cfg=cfg,
                                    ekf_cfg=ekf_cfg, device=dev)
    err = np.linalg.norm((outs["state"][:, 0:3] - outs["pos_ref"]).cpu().numpy(), axis=1)
    skip = scaled(100, 16)
    return float(np.sqrt((err[skip:] ** 2).mean()))


rms_exact = fly(EKFConfig())
rms_fast = fly(EKFConfig(relinearize_every="dispatch", cov_precision="bf16"))
print(f"fused EKF loop RMS: Jacobian per tick {rms_exact:.4f} m, once a launch "
      f"{rms_fast:.4f} m (the covariance in float32 in both)")
