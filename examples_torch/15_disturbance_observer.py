"""Learning-free wind rejection: the augmented-EKF disturbance observer.

The PyTorch/CUDA counterpart of ``examples/15_disturbance_observer.py``.
The reference's only answer to unmodelled forces is the GP residual model,
learned offline or retrained on a 5 s timer
(``src/px4/simple_gp.py:147-154``, ``gaussian_process.py:122``). The
classical alternative (``estimation/disturbance.py``) extends the EKF's
state with a random-walk acceleration disturbance and feeds the estimate to
the MPC as the same stage-wise residual rows the GP path uses. Flights on
the noisy windy figure-8:

1. plain noisy MPC: the full wind penalty;
2. + the observer: most of it recovered, with no dataset and no refits;
3. observer + GP residuals: the two rows add;
4. a mid-flight gust (``wind_fn=``): the observer re-converges, also on
   the fused multi-tick tier with the 15-state filter in the kernel.

Run from the repo root: ``python examples_torch/15_disturbance_observer.py``.
"""

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.estimation import (
    DisturbanceEKFConfig,
    noisy_mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
    ResidualGPConfig,
    build_horizon_residuals,
    fit_residual_gp,
)
from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig
from unmanned_aerial_vehicles_tpu_torch.models import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, fast_examples, scaled

dev = resolve_device(example_device())
f32 = dict(dtype=torch.float32, device=dev)
cfg = FlightLoopConfig(use_pallas_plant=True)   # the plant substeps through the plant kernel


def fig8(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=scaled(6.0, 2.0))
    return pos + torch.tensor([0.0, 0.0, cfg.takeoff_height], dtype=pos.dtype,
                              device=pos.device), yaw


WIND = (1.5, 0.8, 0.0)
windy = RigidBodyParams(wind=WIND)
mpc = LinearMPC(LinearMPCConfig(use_fused_controller=True), device=dev)   # the solve kernel
num_steps = scaled(2400, 152)  # 48 s, or ~3 s in the short run (a multiple of K=4)


def tail_rms(outs):
    e = np.linalg.norm((outs["pos_ref"] - outs["state"][:, 0:3]).cpu().numpy(), axis=1)
    return float(np.sqrt((e[len(e) // 2:] ** 2).mean()))


def fly(controller=mpc, loop_cfg=cfg, **kw):
    outs = noisy_mpc_flight_rollout(controller, fig8, num_steps,
                                    torch.Generator(dev).manual_seed(0), cfg=loop_cfg,
                                    preview=True, body=windy, device=dev, **kw)
    return outs, tail_rms(outs)


def tail_estimate(outs):
    return outs["disturbance_est"][num_steps // 2:].mean(dim=0).cpu().numpy()


# --- 1. plain noisy flight in wind ---------------------------------------
_, rms_plain = fly()
print(f"plain noisy windy fig8      : tail RMS {rms_plain:.3f} m")

# --- 2. + the disturbance observer ---------------------------------------
outs, rms_dob = fly(disturbance_observer=True)
d_tail = tail_estimate(outs)
print(f"+ disturbance observer      : tail RMS {rms_dob:.3f} m, "
      f"d_est = [{d_tail[0]:+.2f} {d_tail[1]:+.2f} {d_tail[2]:+.2f}] m/s^2")

# the q_dist knob trades convergence speed against noise rejection
_, rms_fast = fly(disturbance_observer=DisturbanceEKFConfig(q_dist=0.2))
print(f"  (q_dist 0.05 -> 0.2       : tail RMS {rms_fast:.3f} m: faster "
      f"tracking, more sensor noise passed into the feedforward)")

# --- 3. observer + GP residuals compose ----------------------------------
# a tiny near-zero GP stands in for the offline corpus here (examples_torch/02
# shows the pipeline): the residual_fn and observer rows add inside the loop
gcfg = ResidualGPConfig(max_data_points=scaled(64, 16))
rng = np.random.default_rng(0)
Xd = torch.as_tensor(rng.uniform(-1, 1, (gcfg.max_data_points, 10)), **f32)
Yd = torch.as_tensor(0.01 * rng.standard_normal((gcfg.max_data_points, 6)), **f32)
post = fit_residual_gp(Xd, Yd, gcfg)
residual_fn = lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gcfg)
_, rms_both = fly(disturbance_observer=True, residual_fn=residual_fn)
print(f"+ observer + GP residuals   : tail RMS {rms_both:.3f} m "
      f"(near-zero GP: matches the observer row; the paths compose)")

assert rms_dob < rms_plain, (rms_dob, rms_plain)

# --- 4. gust: the wind steps mid-flight ----------------------------------
T_GUST = scaled(24.0, 1.5)
w_post = torch.tensor([-1.0, 1.5, 0.0], **f32)
w_pre = torch.tensor(WIND, **f32)
wind_fn = lambda t: torch.where(torch.as_tensor(t) < T_GUST, w_pre, w_post)

outs_g, rms_g = fly(disturbance_observer=True, wind_fn=wind_fn)
_, rms_g_plain = fly(wind_fn=wind_fn)
d_post = tail_estimate(outs_g)
print(f"gust at t={T_GUST:.1f}s       : plain tail RMS {rms_g_plain:.3f} m -> observer "
      f"{rms_g:.3f} m; post-gust d_est = [{d_post[0]:+.2f} {d_post[1]:+.2f} "
      f"{d_post[2]:+.2f}] (wind flipped to [-1.0, +1.5, 0])")

# the same gust and observer at the latency tier: the multi-tick kernel
# takes a per-tick plant row (only the wind lanes vary) and the 15-state
# filter runs in the kernel; staged against fused at the same controller
# (horizon 20)
mpc_fused = LinearMPC(LinearMPCConfig(horizon=20, admm_iterations=60,
                                      use_fused_controller=True), device=dev)
_, rms_gs = fly(mpc_fused, cfg, disturbance_observer=True, wind_fn=wind_fn)
outs_gf, rms_gf = fly(mpc_fused,
                      FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=scaled(8, 4)),
                      disturbance_observer=True, wind_fn=wind_fn)
d_post_f = tail_estimate(outs_gf)
print(f"  (latency tier, in-kernel  : tail RMS {rms_gf:.3f} m vs staged same-config "
      f"{rms_gs:.3f} m; post-gust d_est = [{d_post_f[0]:+.2f} {d_post_f[1]:+.2f} "
      f"{d_post_f[2]:+.2f}])")
# the same controller and the same draws: the two tiers agree
assert abs(rms_gf - rms_gs) < max(0.01, 0.02 * rms_gs), (rms_gf, rms_gs)
# the estimate's x-component flips with the wind, and the tracking gain
# shows, once the post-gust window has settled: the full 48 s flight (the
# short run's 1.5 s tail is inside the ~2 s re-convergence)
if not fast_examples():
    assert d_post_f[0] < 0.0, d_post_f
    assert d_post[0] < 0.0, d_post
    assert rms_g < rms_g_plain, (rms_g, rms_g_plain)
print("OK: the observer recovers the wind penalty without learning, "
      "and adapts to wind no frozen model has seen")
