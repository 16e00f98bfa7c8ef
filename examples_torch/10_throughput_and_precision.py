"""Throughput mode and the GP posterior mean's precision on the card.

The PyTorch/CUDA counterpart of ``examples/10_throughput_and_precision.py``.
The structured batched controller kernel advances B flights in lockstep
(one launch a tick), and the GP residual stage runs through the fused
posterior-mean kernel (``ops.rbf_pallas.rbf_posterior_mean_pallas``): the
(B*N, n_train) cross-covariance never reaches global memory.

The JAX package's kernel offers three precision tiers, built from bf16
limbs. The card's kernel does not carry those limbs over: every tier
(``highest``, ``high``, ``default``) computes the same result, both
products on the tensor cores in 3xTF32 with FP32 accumulation, which is
float32-class. This example measures that against a float64 ground truth
on the device it runs on; on the CPU the kernel's plain float32 version
stands in.

Run from the repo root: ``python examples_torch/10_throughput_and_precision.py``.
"""

import time

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp import fit_residual_gp
from unmanned_aerial_vehicles_tpu_torch.gp.exact_gp import predict_mean
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu_torch.loop.closed_loop import (
    FlightLoopConfig,
    batched_mpc_flight_sweep,
)
from unmanned_aerial_vehicles_tpu_torch.ops.rbf_pallas import rbf_posterior_mean_pallas
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

dev = resolve_device(example_device())
f32 = dict(dtype=torch.float32, device=dev)

# ---- fit a flight-data-scale GP --------------------------------------------
gp_cfg = ResidualGPConfig()
rng = np.random.default_rng(0)
P = scaled(800, 120)
# realistic feature magnitudes (positions +-6 m, z ~ 3.4): the distance's
# rounding grows with ||z||^2, as it does on real flight CSVs
X = torch.as_tensor(
    rng.normal(size=(P, 10)) * np.array([6, 6, 0.3, 1, 1, 0.3, 1, 1, 0.5, 0.1])
    + np.array([0, 0, 3.4, 0, 0, 0, 0, 0, -2, 0]), **f32)
Y = torch.as_tensor(0.05 * rng.normal(size=(P, 6)), **f32)
post = fit_residual_gp(X, Y, gp_cfg)

# ---- the precision tiers against a float64 ground truth ---------------------
Xt = X[: scaled(512, 64)] + 0.01
Z64 = X.double().cpu().numpy() / 0.5
Zt64 = Xt.double().cpu().numpy() / 0.5
d2 = ((Zt64[:, None, :] - Z64[None, :, :]) ** 2).sum(-1)
truth = (np.exp(-0.5 * d2) @ post.alpha.double().cpu().numpy()
         * post.y_std.double().cpu().numpy() + post.y_mean.double().cpu().numpy())
staged_err = np.abs(predict_mean(post, Xt).double().cpu().numpy() - truth).max()
print(f"staged float32 posterior mean vs float64: max err {staged_err:.2e}")
tiers = {}
for prec in ("highest", "high", "default"):
    tiers[prec] = rbf_posterior_mean_pallas(post, Xt, precision=prec)
    err = np.abs(tiers[prec].double().cpu().numpy() - truth).max()
    print(f"fused posterior-mean kernel [{prec:8s}]   : max err {err:.2e}")
same = all(torch.equal(tiers["highest"], t) for t in tiers.values())
print(f"the three tiers give the same result on {dev.type}: {same}")

# ---- the sweep ---------------------------------------------------------------
B, T = scaled(1024, 128), scaled(500, 40)
mpc = LinearMPC(LinearMPCConfig(horizon=scaled(20, 10), admm_iterations=10,
                                use_fused_controller=True), device=dev)
cfg = FlightLoopConfig()


def reference(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
    return pos + torch.tensor([0.0, 0.0, cfg.takeoff_height], dtype=pos.dtype,
                              device=pos.device), yaw


starts = torch.zeros(B, 12, **f32)
starts[:, 2] = cfg.takeoff_height
starts[:, 0] = torch.linspace(-1.0, 1.0, B, device=dev)


def sweep(ss):
    outs = batched_mpc_flight_sweep(
        mpc, reference, T, ss, cfg=cfg,
        gp_posterior=post, gp_cfg=gp_cfg, gp_fused_precision="high", device=dev,
    )
    err = outs["pos_ref"][:, None, :] - outs["state"][:, :, 0:3]
    return torch.sqrt(torch.mean(torch.sum(err**2, dim=-1), dim=0))


rms = sweep(starts)
float(rms[0])  # build the kernels and synchronise
t0 = time.perf_counter()
shifted = starts.clone()
shifted[:, 1] = 0.01
rms = sweep(shifted)
float(rms[0])
dt_run = time.perf_counter() - t0
print(f"\n{B} concurrent GP-MPC flights x {T} ticks on {dev.type}: "
      f"{dt_run / (B * T) * 1e6:.3f} us/tick/flight "
      f"(one timed call, the fixed launch overhead included)")
print(f"mean RMS over flights: {float(torch.mean(rms)):.3f} m")
