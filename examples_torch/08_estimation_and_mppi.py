"""Estimator-in-the-loop flight + derivative-free MPPI control.

The PyTorch/CUDA counterpart of ``examples/08_estimation_and_mppi.py``.
Two capabilities the reference lacks: it consumes PX4-EKF2 state over DDS
(never running an estimator itself), and every controller it has is
derivative-based. Here: (1) a full sensors -> EKF -> GP-MPC -> plant loop
on a seeded ``torch.Generator``, (2) the same task flown by MPPI, 512
perturbed nonlinear rollouts a tick in one kernel launch.

Run from the repo root: ``python examples_torch/08_estimation_and_mppi.py``.
"""

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control import MPPIConfig, MPPIController
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.estimation import noisy_mpc_flight_rollout
from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig, mpc_flight_rollout
from unmanned_aerial_vehicles_tpu_torch.models import X500_PARAMS
from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import rigid_body_rk4_step_fast
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

dev = resolve_device(example_device())


def reference(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


def rms(pos, ref, skip=100):
    err = np.linalg.norm((pos - ref).detach().cpu().numpy(), axis=1)
    return float(np.sqrt((err[skip:] ** 2).mean()))


STEPS = scaled(1000, 128)  # 20 s

# --- 1. EKF in the loop ------------------------------------------------
mpc = LinearMPC(LinearMPCConfig(use_fused_controller=True), device=dev)   # the solve kernel
cfg = FlightLoopConfig(use_pallas_plant=True)                              # the plant kernels
ideal = mpc_flight_rollout(mpc, reference, STEPS, cfg=cfg, device=dev)
noisy = noisy_mpc_flight_rollout(mpc, reference, STEPS, torch.Generator(dev).manual_seed(0),
                                 cfg=cfg, device=dev)
print(f"MPC circle RMS: true state {rms(ideal['state'][:, 0:3], ideal['pos_ref']):.3f} m, "
      f"EKF-estimated state {rms(noisy['state'][:, 0:3], noisy['pos_ref']):.3f} m")
est_err = np.linalg.norm((noisy["state_est"][:, 0:3] - noisy["state"][:, 0:3]).cpu().numpy(),
                         axis=1)
print(f"EKF position error: {est_err[100:].mean() * 100:.1f} cm mean (sensors at 5 cm std)")

# --- 2. MPPI -----------------------------------------------------------
ctrl = MPPIController(MPPIConfig(num_samples=scaled(512, 64)), device=dev)
dt = ctrl.config.dt
x = torch.zeros(12, dtype=torch.float32, device=dev)
x[2] = 3.0
carry = ctrl.init_carry(x)
pos_refs, yaw_refs = reference(torch.arange(STEPS, dtype=torch.float32, device=dev) * dt)
states = []
for i in range(STEPS):
    u, _, carry = ctrl.solve(carry, x, pos_refs[i], yaw_refs[i])
    x = rigid_body_rk4_step_fast(x, u, X500_PARAMS, dt)
    states.append(x)
print(f"MPPI ({ctrl.config.num_samples} rollouts/tick) circle RMS: "
      f"{rms(torch.stack(states)[:, 0:3], pos_refs):.3f} m")
