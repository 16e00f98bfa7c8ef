"""Differentiable auto-tuning + Monte-Carlo robustness (capabilities the
reference lacks: its gains are hand-tuned, cascade_pid_demo.py:194-210,
and every run uses one nominal plant).

The PyTorch/CUDA counterpart of ``examples/07_autotune_and_robustness.py``:

1. gradient descent on the 27 cascade-PID gains through a whole
   closed-loop flight (the plant kernel forward, its VJP kernel backward);
2. tuned against hand-tuned gains over randomised plants (mass, drag and
   rate-lag jitter, steady wind, perturbed starts).

Run from the repo root: ``python examples_torch/07_autotune_and_robustness.py``.
"""

import numpy as np

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    MonteCarloConfig,
    monte_carlo_pid,
    pid_flight_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference
from unmanned_aerial_vehicles_tpu_torch.tuning import TuneConfig, tune_cascade_gains
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

dev = resolve_device(example_device())


def reference(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


STEPS = scaled(1500, 200)  # 30 s at 50 Hz
ITERATIONS = scaled(30, 3)
SETTLE = scaled(250, 50)   # ticks left out of the loss and the RMS (the short run has 200)
LOOP = FlightLoopConfig(use_pallas_plant=True)   # the plant kernel forward, its VJP backward

# --- 1. tune -----------------------------------------------------------
result = tune_cascade_gains(
    reference, STEPS,
    tune_cfg=TuneConfig(iterations=ITERATIONS, learning_rate=0.06, settle_steps=SETTLE),
    loop_cfg=LOOP, device=dev,
)
print(f"tuning loss: {float(result.initial_loss):.4f} -> "
      f"{float(result.final_loss):.4f} over {ITERATIONS} gradient steps")


def rms(outs):
    err = (outs["state"][:, 0:3] - outs["pos_ref"]).detach().cpu().numpy()
    return float(np.sqrt((np.linalg.norm(err, axis=1) ** 2).mean()))


base = pid_flight_rollout(reference, STEPS, cfg=LOOP, device=dev)
tuned = pid_flight_rollout(reference, STEPS, gains=result.params, cfg=LOOP, device=dev)
print(f"circle RMS: hand-tuned {rms(base):.3f} m -> auto-tuned {rms(tuned):.3f} m")

# --- 2. robustness -----------------------------------------------------
mc = MonteCarloConfig(n_rollouts=scaled(128, 16), wind_std=0.8, settle_steps=SETTLE)
for name, gains in (("hand-tuned", None), ("auto-tuned", result.params)):
    stats = monte_carlo_pid(reference, STEPS, mc=mc, gains=gains, loop_cfg=LOOP, device=dev)
    print(f"{name}: success {float(stats['success_rate']) * 100:.1f} %, "
          f"RMS p50/p90/p99 = {float(stats['rms_p50']):.3f} / "
          f"{float(stats['rms_p90']):.3f} / {float(stats['rms_p99']):.3f} m")
