"""Per-output ARD GPs with input and output standardisation (port of
``gp/per_dim.py``).

The reference's per-dimension trainer and runtime: six independent GPs,
kernel ``Const(1.0, fixed) * RBF(ARD) + White``, ``alpha=1e-6``, a
standard scaler on the inputs and on each output, and a per-dimension
RMSE / R^2 / LML report. The JAX package fits the six as one ``vmap``; here
they are fitted one after another (six small Cholesky factorisations) and
their posteriors stacked on a leading output axis, the JAX layout.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .._device import resolve_device
from .exact_gp import (
    GPParams,
    GPPosterior,
    fit_gp,
    log_marginal_likelihood,
    optimize_hyperparameters,
    predict,
)


class Standardizer(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor

    @classmethod
    def fit(cls, data: torch.Tensor) -> "Standardizer":
        std = torch.std(data, dim=0, correction=0)
        return cls(mean=torch.mean(data, dim=0),
                   std=torch.where(std == 0, torch.ones_like(std), std))

    def transform(self, data):
        return (data - self.mean) / self.std

    def inverse_transform(self, data):
        return data * self.std + self.mean


class PerDimGP(NamedTuple):
    """Single-output GPs over standardized inputs: ``posteriors``' tensors
    carry a leading axis of one entry per output."""

    posteriors: GPPosterior
    scaler_X: Standardizer
    scaler_Y: Standardizer


def _output(tree, i: int):
    """Entry ``i`` of the leading axis of every tensor of a stacked
    ``GPParams`` or ``GPPosterior`` (``None`` fields stay ``None``)."""
    return type(tree)(*(_output(v, i) if isinstance(v, tuple)
                        else None if v is None else v[i] for v in tree))


def _stack(trees):
    first = trees[0]
    return type(first)(*(_stack([t[k] for t in trees]) if isinstance(v, tuple)
                         else None if v is None else torch.stack([t[k] for t in trees])
                         for k, v in enumerate(first)))


def default_per_dim_params(input_dim: int, out_dim: int = 6, dtype=torch.float64,
                           device=None) -> GPParams:
    """ARD RBF (length scale 1 per input) + White(0.01), per output; the
    signal variance fixed at 1."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    return GPParams(
        log_length_scale=torch.zeros(out_dim, input_dim, **kw),
        log_signal_variance=torch.zeros(out_dim, **kw),
        log_noise_variance=torch.full((out_dim,), math.log(0.01), **kw),
    )


def fit_per_dim_gp(
    X: torch.Tensor,
    Y: torch.Tensor,
    params: GPParams | None = None,
    jitter: float = 1e-6,
    optimize: bool = False,
    opt_steps: int = 60,
) -> PerDimGP:
    """Standardise, then fit one single-output GP per output column.
    ``optimize=True`` first maximises each output's log marginal
    likelihood (``optimize_hyperparameters``, ``opt_steps`` steps)."""
    out_dim = Y.shape[1]
    if params is None:
        params = default_per_dim_params(X.shape[1], out_dim, device=X.device)
    sx, sy = Standardizer.fit(X), Standardizer.fit(Y)
    Xs, Ys = sx.transform(X), sy.transform(Y)
    per_output = [_output(params, i) for i in range(out_dim)]
    if optimize:
        per_output = [optimize_hyperparameters(p, Xs, Ys[:, i:i + 1], jitter=jitter,
                                               steps=opt_steps)[0]
                      for i, p in enumerate(per_output)]
    posteriors = [fit_gp(p, Xs, Ys[:, i:i + 1], jitter=jitter, normalize_y=False)
                  for i, p in enumerate(per_output)]
    return PerDimGP(posteriors=_stack(posteriors), scaler_X=sx, scaler_Y=sy)


def predict_per_dim(model: PerDimGP, X_test: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean (m, out), var (m, out))``: each output's prediction with the
    output scaler inverted (the variance scaled by its std squared)."""
    Xs = model.scaler_X.transform(X_test)
    out_dim = model.scaler_Y.mean.shape[0]
    preds = [predict(_output(model.posteriors, i), Xs, include_noise_in_variance=True)
             for i in range(out_dim)]
    means = torch.stack([m[:, 0] for m, _ in preds], dim=1)
    variances = torch.stack([v[:, 0] for _, v in preds], dim=1)
    mean = model.scaler_Y.inverse_transform(means)
    return mean, variances * model.scaler_Y.std[None, :] ** 2


def build_horizon_residuals_per_dim(
    model: PerDimGP,
    X_guess: torch.Tensor,
    U_guess: torch.Tensor,
    dt: float = 0.02,
    residual_gain: float = 0.1,
) -> torch.Tensor:
    """The MPC's horizon residual rows from the per-dimension GPs: ``X_guess
    (N+1, >=6)``, ``U_guess (N, >=4)`` -> ``(N, 6)``, the state residual
    ``/ dt`` times ``residual_gain`` on the acceleration rows."""
    N = U_guess.shape[0]
    inputs = torch.cat([X_guess[:N, :6], U_guess[:, :4]], dim=1)
    mean, _ = predict_per_dim(model, inputs)
    acc = residual_gain * (mean[:, 3:6] / dt)
    return torch.cat([torch.zeros_like(acc), acc], dim=1)


def per_dim_training_report(
    model: PerDimGP,
    X_test: torch.Tensor,
    Y_test: torch.Tensor,
    X_train: torch.Tensor,
    Y_train: torch.Tensor,
    jitter: float = 1e-6,
) -> dict:
    """Per-dimension MSE, RMSE, R^2 and log marginal likelihood."""
    mean, _ = predict_per_dim(model, X_test)
    names = ["x_residual", "y_residual", "z_residual",
             "vx_residual", "vy_residual", "vz_residual"]
    Xs = model.scaler_X.transform(X_train)
    Ys = model.scaler_Y.transform(Y_train)
    out = {}
    for i, name in enumerate(names[: Y_test.shape[1]]):
        err = mean[:, i] - Y_test[:, i]
        mse = float(torch.mean(err**2))
        ss_tot = float(torch.sum((Y_test[:, i] - torch.mean(Y_test[:, i])) ** 2))
        lml = float(log_marginal_likelihood(_output(model.posteriors.params, i), Xs,
                                            Ys[:, i:i + 1], jitter))
        out[name] = {
            "mse": mse,
            "rmse": mse**0.5,
            "r2": 1.0 - float(torch.sum(err**2)) / max(ss_tot, 1e-300),
            "log_marginal_likelihood": lml,
        }
    return out
