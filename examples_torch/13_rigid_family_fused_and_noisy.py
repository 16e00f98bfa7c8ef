"""The 12-state torque family end to end: the fused whole-tick kernel + EKF.

The PyTorch/CUDA counterpart of ``examples/13_rigid_family_fused_and_noisy.py``,
for the reference's full 12-state formulation (``src/px4/mpc_FULL.py:86-549``).
(1) ``rigid_multitick_fused``: the torque-SQP engine's per-tick chain
(warm-start shift, condensed ADMM, RK4 rigid-body plant) runs as one
kernel launch of K ticks, against the staged multi-tick tier. (2)
``noisy_rigid_mpc_rollout``: noisy sensors -> rigid-body EKF -> controller
flying the estimate -> true plant, on a seeded ``torch.Generator``.

Run from the repo root: ``python examples_torch/13_rigid_family_fused_and_noisy.py``.
"""

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control.mpc_rigid import RigidBodyMPC
from unmanned_aerial_vehicles_tpu_torch.estimation import EKFConfig
from unmanned_aerial_vehicles_tpu_torch.estimation.noisy_loop import noisy_rigid_mpc_rollout
from unmanned_aerial_vehicles_tpu_torch.loop.rigid_loop import (
    rigid_multitick_fused,
    sqp_multitick_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.models import X500_PARAMS
from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import rigid_body_rk4_step_fast
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

dev = resolve_device(example_device())
f32 = dict(dtype=torch.float32, device=dev)
DT = 0.02
HEIGHT = 3.0


def reference(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=HEIGHT)
    return pos, yaw


eng = RigidBodyMPC(device=dev)
N = eng.mpc.config.horizon


def reference_fn(ticks):
    pos, _, _ = ramped_circle_reference(ticks.to(torch.float32) * DT, amplitude=2.0,
                                        height=HEIGHT)
    stage = torch.cat([pos, torch.zeros(pos.shape[0], 9, **f32)], dim=1)
    return stage[:, None, :].repeat(1, N, 1)


def rms_vs_ref(states):
    ts = torch.arange(states.shape[0], **f32) * DT
    refs = ramped_circle_reference(ts, amplitude=2.0, height=HEIGHT)[0]
    return float(torch.sqrt(torch.mean(torch.sum((states[:, 0:3] - refs) ** 2, -1))))


# --- 1. the fused whole-tick tier against the staged multi-tick tier -----
STEPS = scaled(480, 40)
K, ITERS = scaled(20, 4), scaled(10, 10)
x0 = torch.zeros(12, **f32)
x0[2] = HEIGHT
plant = lambda x, u: rigid_body_rk4_step_fast(x, u, X500_PARAMS, DT)

staged = sqp_multitick_rollout(
    eng.mpc, eng.cost, reference_fn, plant, x0, STEPS,
    ticks_per_dispatch=K, admm_iterations=ITERS, u_init=eng.u_hover, plan_roll="linear")
fused = rigid_multitick_fused(
    eng.mpc, eng.cost, reference_fn, x0, STEPS,
    ticks_per_dispatch=K, admm_iterations=ITERS, u_init=eng.u_hover,
    dt=DT, plan_roll="linear")
print(f"torque-SQP multitick (K={K}, {ITERS} ADMM iters, {STEPS} ticks): "
      f"staged RMS {rms_vs_ref(staged['state']):.4f} m, "
      f"fused-kernel RMS {rms_vs_ref(fused['state']):.4f} m")

# --- 2. the estimator joins the 12-state loop ---------------------------
NOISY_STEPS = scaled(480, 40)
outs = noisy_rigid_mpc_rollout(eng, reference, NOISY_STEPS, torch.Generator(dev).manual_seed(0),
                               ekf_cfg=EKFConfig(), dt=DT, takeoff_height=HEIGHT, device=dev)
st = outs["state"].cpu().numpy()
est = outs["state_est"].cpu().numpy()
meas = outs["meas_pos"].cpu().numpy()
skip = scaled(40, 8)
est_err = float(np.sqrt(np.mean(np.sum((est[skip:, 0:3] - st[skip:, 0:3]) ** 2, -1))))
meas_err = float(np.sqrt(np.mean(np.sum((meas[skip:] - st[skip:, 0:3]) ** 2, -1))))
print(f"noisy 12-state loop ({NOISY_STEPS} ticks): tracking RMS "
      f"{rms_vs_ref(outs['state']):.4f} m; EKF position estimate "
      f"{est_err * 100:.1f} cm vs raw sensor {meas_err * 100:.1f} cm "
      f"(unmeasured velocity reconstructed by the filter)")
