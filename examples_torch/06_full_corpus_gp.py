"""Full-corpus GP training, rows sharded over the process group — no 10k
down-sampling.

The PyTorch/CUDA counterpart of ``examples/06_full_corpus_gp.py``. The
reference's offline trainer caps itself at 10,000 samples
(``train_gp_offline.py:155-163``); here the whole corpus fits and
hyperparameter-trains through the row-sharded preconditioned CG, every
Gram block built by the Gram kernel (float32). Without a process group the
mesh is a world of one.

Run from the repo root: ``python examples_torch/06_full_corpus_gp.py
'gp_datasets/*.csv'`` (``UAV_EXAMPLES_DEVICE=cpu`` for the CPU).
"""

import glob
import sys

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig, default_params
from unmanned_aerial_vehicles_tpu_torch.io import load_gp_datasets
from unmanned_aerial_vehicles_tpu_torch.parallel import (
    fit_residual_gp_sharded,
    make_mesh,
    optimize_hyperparameters_sharded,
    predict_mean_sharded,
)
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

DATA = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/gp_datasets/*.csv"
dev = resolve_device(example_device())

cfg = ResidualGPConfig()
paths = sorted(glob.glob(DATA))
if not paths:
    sys.exit(f"no flight CSVs match {DATA!r}: pass their glob as the first argument")
X, Y = load_gp_datasets(paths, max_samples=scaled(None, 512))  # FULL corpus
X, Y = X.astype(np.float32), Y.astype(np.float32)             # the Gram kernel's precision
print(f"corpus: {X.shape[0]} samples")

mesh = make_mesh(device=dev)

# stochastic-trace LML ascent (Hutchinson probes through the sharded CG)
params = optimize_hyperparameters_sharded(
    default_params(cfg, device=dev), X, Y, mesh=mesh, config=cfg,
    steps=scaled(10, 2), num_probes=scaled(16, 4),
    cg_iterations=scaled(100, 30), generator=torch.Generator(dev).manual_seed(0),
)
print(f"optimised: ls={float(params.length_scale):.4f} "
      f"sf2={float(params.signal_variance):.4f} "
      f"sn2={float(params.noise_variance):.4f}")

# row-sharded Gram + Nystrom-preconditioned CG fit
post = fit_residual_gp_sharded(X, Y, mesh=mesh, config=cfg, params=params)
print(f"fit CG residual: {float(post.cg_residual):.2e}")

mean = predict_mean_sharded(post, X[:8], mesh=mesh)
print("posterior means:", np.round(mean[:2].cpu().numpy(), 4))

# the gathered view plugs straight into the control loop
view = post.to_gp_posterior(mesh)
print("control-loop-ready posterior on", view.X_train.shape[0], "points")
