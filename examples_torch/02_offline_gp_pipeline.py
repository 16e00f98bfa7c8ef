"""Offline GP pipeline: train on flight CSVs, optimise hyperparameters with
restarts, evaluate nominal-vs-GP, write the reference metrics CSV layout.

The PyTorch/CUDA counterpart of ``examples/02_offline_gp_pipeline.py``.
Run from the repo root: ``python examples_torch/02_offline_gp_pipeline.py
'gp_datasets/*.csv'`` (``UAV_EXAMPLES_DEVICE=cpu`` for the CPU). Writes
``gp_tuned.npz`` and ``gp_tuned_metrics.csv`` into the system's temporary
directory.
"""

import glob
import os
import sys
import tempfile

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.gp import (
    evaluate_gp,
    fit_gp,
    optimize_hyperparameters_restarts,
    predict_mean,
)
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig, default_params
from unmanned_aerial_vehicles_tpu_torch.io import load_gp_datasets, save_gp_checkpoint
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

DATA = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/gp_datasets/*.csv"
dev = resolve_device(example_device())
out = os.path.join(tempfile.gettempdir(), "gp_tuned")

paths = sorted(glob.glob(DATA))
if not paths:
    sys.exit(f"no flight CSVs match {DATA!r}: pass their glob as the first argument")
X, Y = load_gp_datasets(paths, max_samples=scaled(600, 128))
Xt = torch.as_tensor(X, dtype=torch.float32, device=dev)
Yt = torch.as_tensor(Y, dtype=torch.float32, device=dev)
cfg = ResidualGPConfig()

params, nll = optimize_hyperparameters_restarts(
    default_params(cfg, device=dev), Xt, Yt, torch.Generator(dev).manual_seed(0),
    restarts=scaled(3, 2), jitter=cfg.alpha, normalize_y=True,
    steps=scaled(40, 8),
)
print(f"optimised nll: {float(nll):.1f}, "
      f"length_scale: {float(torch.exp(params.log_length_scale)):.3f}")

post = fit_gp(params, Xt, Yt, jitter=cfg.alpha, normalize_y=True)
save_gp_checkpoint(out + ".npz", post, X, Y, jitter=cfg.alpha)

results = evaluate_gp(
    lambda x: predict_mean(post, torch.as_tensor(x, dtype=torch.float32, device=dev))
    .cpu().numpy().astype(np.float64),
    X, Y, save_prefix=out,
)
print("global improvement: "
      f"{results['global']['improvement_%']:.1f}% (metrics at {out}_metrics.csv)")
