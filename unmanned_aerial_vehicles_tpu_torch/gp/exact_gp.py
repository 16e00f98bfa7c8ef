"""Exact multi-output Gaussian-process regression (port of
``gp/exact_gp.py``: fit, posterior mean and predictive variance, the log
marginal likelihood and its maximisation).

sklearn semantics (``RBF + WhiteKernel``, ``alpha`` jitter,
``normalize_y=True`` with the population std). The hyperparameters are
optimised by ``torch.optim.LBFGS`` (a strong-Wolfe line search, a history
of 10) for a fixed number of steps, where the JAX package runs
``optax.lbfgs``: the same quasi-Newton family, so the two reach
comparable optima, not the same iterates.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

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


def _train_kernel(params: GPParams, X: torch.Tensor, jitter: float) -> torch.Tensor:
    n = X.shape[0]
    K = rbf_kernel(X, X, params.length_scale, params.signal_variance)
    return K + (params.noise_variance + jitter) * torch.eye(n, dtype=X.dtype, device=X.device)


def log_marginal_likelihood(
    params: GPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    jitter: float = 0.0,
    normalize_y: bool = False,
) -> torch.Tensor:
    """Multi-output log marginal likelihood, differentiable in ``params``
    (sklearn's ``log_marginal_likelihood`` summed over the outputs). In
    the promoted dtype of the inputs and the hyperparameters; NaN where the
    Gram matrix is not positive definite (a failed Cholesky), as in the JAX
    package."""
    full_f32_matmul()
    Y = Y if Y.ndim == 2 else Y[:, None]
    if normalize_y:
        y_std = torch.std(Y, dim=0, correction=0)
        Y = (Y - torch.mean(Y, dim=0)) / torch.where(y_std == 0.0, torch.ones_like(y_std), y_std)
    n, out = Y.shape
    wd = _work_dtype(params, X, Y)
    p = GPParams(*(v.to(wd) for v in params))
    L, info = torch.linalg.cholesky_ex(_train_kernel(p, X.to(wd), jitter))
    alpha = torch.cholesky_solve(Y.to(wd), L)
    log_det = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    quad = torch.sum(Y.to(wd) * alpha)
    const = n * out * math.log(2.0 * math.pi)
    lml = -0.5 * (out * log_det + quad + const)
    return torch.where(info == 0, lml, torch.nan)


_NLL_PENALTY = 1e30


def optimize_hyperparameters(
    params: GPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    jitter: float = 0.0,
    normalize_y: bool = False,
    steps: int = 100,
    learning_rate: float = 1.0,
) -> Tuple[GPParams, torch.Tensor]:
    """Maximise the log marginal likelihood over the log-hyperparameters
    with ``steps`` L-BFGS steps (``torch.optim.LBFGS``, one iteration a
    step, strong-Wolfe line search, ``learning_rate`` its initial step).
    A trial point whose Gram matrix is not positive definite scores a large
    finite penalty, so the line search backs off from it. Returns the best
    parameters seen (the start included) and their negative log marginal
    likelihood, as the JAX package does."""
    leaves = [v.detach().clone().requires_grad_(True) for v in params]
    opt = torch.optim.LBFGS(leaves, lr=learning_rate, max_iter=1, history_size=10,
                            line_search_fn="strong_wolfe")

    def nll():
        return -log_marginal_likelihood(GPParams(*leaves), X, Y, jitter, normalize_y)

    def closure():
        opt.zero_grad()
        value = nll()
        if not bool(torch.isfinite(value)):
            value = _NLL_PENALTY + sum(0.0 * leaf.sum() for leaf in leaves)
        value.backward()
        return value

    best_p = GPParams(*(v.detach().clone() for v in leaves))
    best_v = math.inf
    for _ in range(steps):
        current = GPParams(*(v.detach().clone() for v in leaves))
        value = float(opt.step(closure).detach())
        if value < best_v:
            best_p, best_v = current, value
    with torch.no_grad():
        final_v = float(nll())
    if final_v < best_v:    # False for a NaN
        best_p, best_v = GPParams(*(v.detach().clone() for v in leaves)), final_v
    return best_p, torch.tensor(best_v, dtype=_work_dtype(params, X, Y))


def optimize_hyperparameters_restarts(
    params: GPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    generator: torch.Generator,
    restarts: int = 3,
    perturbation: float = 1.0,
    jitter: float = 0.0,
    normalize_y: bool = False,
    steps: int = 100,
) -> Tuple[GPParams, torch.Tensor]:
    """Multi-start maximisation (sklearn's ``n_restarts_optimizer``): the
    log length scales perturbed by ``perturbation`` times standard normals
    drawn from ``generator``, restart 0 the unperturbed start; the restarts
    run one after another. Returns the best restart's parameters and
    negative log marginal likelihood."""
    log_ls = params.log_length_scale
    draws = torch.randn((restarts,) + tuple(log_ls.shape), generator=generator,
                        device=generator.device, dtype=log_ls.dtype).to(log_ls.device)
    best, best_v = None, None
    for r in range(restarts):
        start = params if r == 0 else params._replace(
            log_length_scale=log_ls + perturbation * draws[r])
        p, v = optimize_hyperparameters(start, X, Y, jitter=jitter, normalize_y=normalize_y,
                                        steps=steps)
        if best_v is None or bool(v < best_v) or bool(torch.isnan(best_v)):
            best, best_v = p, v
    return best, best_v
