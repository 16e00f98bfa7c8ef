"""Posterior compression: the fitted GP mean as a small anchor expansion
(port of ``gp/sparse.py``).

``compress_posterior`` projects the fitted mean ``g(x) = sum_i alpha_i
k(x, x_i)`` onto ``m`` anchors by kernel interpolation, ``w = (K_zz + eps
I)^-1 K_zx alpha``: the compressed mean equals the exact one at the anchors
and interpolates between them with the same RBF smoothness. The result is
an ordinary ``GPPosterior`` with ``m`` rows, so it plugs into the residual
rows and the kernels unchanged; its variance is the anchor expansion's
(below the exact posterior's away from the anchors).

Compression needs a length scale comparable to the data's spread: for
``RBF(0.5)`` over unscaled 10-D flight inputs the mean is a sum of nearly
disjoint bumps that no small expansion represents. ``compression_error``
measures that before the compressed posterior is used.
"""

from __future__ import annotations

import numpy as np
import torch

from .exact_gp import GPPosterior, _work_dtype, predict_mean
from .kernels import rbf_kernel


def select_anchors(X: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` rows of ``X`` at evenly strided indices (flight data arrives
    in trajectory order, so the anchors spread along the flown path). The
    indices are the JAX package's: ``linspace(0, n - 1, m)`` formed as
    ``(n - 1) (i / (m - 1))`` in float64, truncated."""
    n = X.shape[0]
    if m > 1:
        step = np.arange(m - 1, dtype=np.float64) / np.float64(m - 1)
        idx = np.concatenate([(n - 1) * step, [n - 1]]).astype(np.int64)
    else:
        idx = np.zeros(m, np.int64)
    return X[torch.from_numpy(idx).to(X.device)]


def compress_posterior(
    posterior: GPPosterior,
    m: int = 96,
    anchors: torch.Tensor | None = None,
    jitter: float = 1e-8,
) -> GPPosterior:
    """A posterior whose ``X_train`` is ``m`` anchors (``select_anchors``, or
    ``anchors``) and whose ``alpha`` reproduces the exact mean there;
    ``chol`` is the Cholesky factor of the anchors' kernel plus noise, so
    ``predict`` still runs."""
    p = posterior.params
    X = posterior.X_train
    Z = anchors if anchors is not None else select_anchors(X, m)
    wd = _work_dtype(p, X, posterior.alpha)
    ls, sig = p.length_scale.to(wd), p.signal_variance.to(wd)
    Zw, Xw = Z.to(wd), X.to(wd)
    eye = torch.eye(Z.shape[0], dtype=wd, device=Z.device)

    Kzz = rbf_kernel(Zw, Zw, ls, sig)
    # scale-aware interpolation jitter (Kzz is PSD but nearly singular
    # where anchors cluster)
    Kzz = Kzz + jitter * torch.trace(Kzz) / Z.shape[0] * eye
    g_z = rbf_kernel(Zw, Xw, ls, sig) @ posterior.alpha.to(wd)   # (m, out), normalised targets
    w = torch.cholesky_solve(g_z, torch.linalg.cholesky(Kzz))
    Ln = torch.linalg.cholesky(Kzz + p.noise_variance.to(wd) * eye)
    return GPPosterior(
        params=p,
        X_train=Z,   # the anchors are in the (possibly shifted) training frame
        chol=Ln,
        alpha=w,
        y_mean=posterior.y_mean,
        y_std=posterior.y_std,
        y_train_norm=g_z,
        x_shift=posterior.x_shift,
    )


def compression_error(posterior: GPPosterior, compressed: GPPosterior,
                      X_eval: torch.Tensor) -> torch.Tensor:
    """Per output, the largest ``|exact mean - compressed mean|`` over
    ``X_eval``: the number to check before trusting a compression."""
    exact = predict_mean(posterior, X_eval)
    approx = predict_mean(compressed, X_eval)
    return torch.amax(torch.abs(exact - approx), dim=0)
