"""Exact multi-output Gaussian-process regression (port of
``gp/exact_gp.py``: fit, posterior mean and predictive variance).

sklearn semantics (``RBF + WhiteKernel``, ``alpha`` jitter,
``normalize_y=True`` with the population std). Hyperparameter optimisation
is queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import full_f32_matmul, resolve_device
from .kernels import rbf_kernel


class GPParams(NamedTuple):
    """Log-space hyperparameters (0-d, or ``(d,)`` ARD length scales)."""

    log_length_scale: torch.Tensor
    log_signal_variance: torch.Tensor
    log_noise_variance: torch.Tensor

    @classmethod
    def create(cls, length_scale=1.0, signal_variance=1.0, noise_variance=0.01,
               dtype=torch.float64, device=None):
        dev = resolve_device(device)
        log = lambda v: torch.log(torch.as_tensor(v, dtype=dtype, device=dev))
        return cls(log(length_scale), log(signal_variance), log(noise_variance))

    @property
    def length_scale(self):
        return torch.exp(self.log_length_scale)

    @property
    def signal_variance(self):
        return torch.exp(self.log_signal_variance)

    @property
    def noise_variance(self):
        return torch.exp(self.log_noise_variance)

    @property
    def dtype(self):
        return self.log_length_scale.dtype


class GPPosterior(NamedTuple):
    """Cached factorisation for posteriors."""

    params: GPParams
    X_train: torch.Tensor      # (n, d), stored centered when x_shift is set
    chol: torch.Tensor         # (n, n) lower Cholesky of K + (noise+jitter) I
    alpha: torch.Tensor        # (n, out) = K^{-1} Y_normalized
    y_mean: torch.Tensor       # (out,)
    y_std: torch.Tensor        # (out,)
    y_train_norm: torch.Tensor  # (n, out)
    x_shift: torch.Tensor | None = None   # (d,) query centering


def _work_dtype(params: GPParams, *tensors):
    """JAX promotes a float32 input against float64 hyperparameters to
    float64; torch would keep float32 (0-d tensors do not promote), so the
    fits cast explicitly."""
    dtype = params.dtype
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def fit_gp(
    params: GPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    jitter: float = 0.0,
    normalize_y: bool = False,
) -> GPPosterior:
    """Cholesky fit (sklearn ``.fit`` when ``normalize_y=True`` and
    ``jitter=alpha``). The Gram matrix and its factor are in the promoted
    dtype of the inputs and the hyperparameters."""
    full_f32_matmul()
    Y = Y if Y.ndim == 2 else Y[:, None]
    if normalize_y:
        y_mean = torch.mean(Y, dim=0)
        y_std = torch.std(Y, dim=0, correction=0)
        y_std = torch.where(y_std == 0.0, torch.ones_like(y_std), y_std)
    else:
        y_mean = torch.zeros(Y.shape[1], dtype=Y.dtype, device=Y.device)
        y_std = torch.ones(Y.shape[1], dtype=Y.dtype, device=Y.device)
    Yn = (Y - y_mean) / y_std

    wd = _work_dtype(params, X, Y)
    Xw = X.to(wd)
    n = X.shape[0]
    K = rbf_kernel(Xw, Xw, params.length_scale.to(wd), params.signal_variance.to(wd))
    K = K + (params.noise_variance.to(wd) + jitter) * torch.eye(n, dtype=wd, device=X.device)
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(Yn.to(wd), L)
    return GPPosterior(
        params=params, X_train=X, chol=L, alpha=alpha,
        y_mean=y_mean, y_std=y_std, y_train_norm=Yn,
    )


def predict_mean(posterior: GPPosterior, X_test: torch.Tensor) -> torch.Tensor:
    """Posterior mean only: one ``(m, n) @ (n, out)`` product."""
    p = posterior.params
    if posterior.x_shift is not None:
        X_test = X_test - posterior.x_shift
    wd = posterior.alpha.dtype
    K_star = rbf_kernel(
        X_test.to(wd), posterior.X_train.to(wd),
        p.length_scale.to(wd), p.signal_variance.to(wd),
    )
    return K_star @ posterior.alpha * posterior.y_std + posterior.y_mean


def predict(posterior: GPPosterior, X_test: torch.Tensor,
            include_noise_in_variance: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance at a batch of test points:
    ``(mean (m, out), var (m, out))``.

    The latent variance ``max(prior - sum(v^2), 1e-10)`` with
    ``v = L^-1 K_*'`` is shared by the outputs and scaled per output by
    ``y_std^2`` (sklearn's ``normalize_y`` predict). With
    ``include_noise_in_variance`` the prior includes the White-kernel noise
    (sklearn's ``RBF + WhiteKernel`` predict)."""
    p = posterior.params
    if posterior.x_shift is not None:
        X_test = X_test - posterior.x_shift
    wd = posterior.alpha.dtype
    K_star = rbf_kernel(
        X_test.to(wd), posterior.X_train.to(wd),
        p.length_scale.to(wd), p.signal_variance.to(wd),
    )
    mean = K_star @ posterior.alpha * posterior.y_std + posterior.y_mean
    v = torch.linalg.solve_triangular(posterior.chol.to(wd), K_star.T, upper=False)
    # the prior diagonal in the queries' own dtype, as the JAX package's
    # rbf_kernel_diag forms it
    prior_var = p.signal_variance.to(X_test.dtype).to(wd).expand(X_test.shape[0])
    if include_noise_in_variance:
        prior_var = prior_var + p.noise_variance.to(wd)
    var_latent = torch.clamp(prior_var - torch.sum(v**2, dim=0), min=1e-10)
    return mean, var_latent[:, None] * posterior.y_std[None, :] ** 2
