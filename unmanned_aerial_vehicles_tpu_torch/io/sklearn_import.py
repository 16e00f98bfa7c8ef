"""Load the reference's sklearn GP pickles into the port's posteriors
(port of ``io/sklearn_import.py``).

The reference ships two checkpoint formats:

* the single multi-output GP pickle of the offline trainer —
  ``{'gp_model': GaussianProcessRegressor, 'training_count',
  'data_points_used', 'timestamp', 'is_trained'}``
  (the reference's ``src/px4/train_gp_offline.py:186-214``); kernel
  ``RBF + WhiteKernel``, ``alpha`` regularisation, ``normalize_y``;
* the per-dimension package of ``GPTrainer`` —
  ``{'gp_models': {name: GPR}, 'scalers_X': {name: StandardScaler},
  'scalers_y': {...}, 'training_stats', ...}``
  (``src/px4/gp_trainer.py:207-229``, read by ``pretrained_gp.py:13-111``);
  kernel ``Const(fixed) * RBF(ARD) + White`` over standardised inputs and
  outputs.

Both load into the port's ``gp.exact_gp.GPPosterior`` and
``gp.per_dim.PerDimGP``: the hyperparameters are read off the fitted
sklearn kernel, the training targets un-normalised from the stored arrays,
and the Cholesky factor rebuilt with ``fit_gp`` (float64 hyperparameters,
the data in ``dtype``, on ``device``: ``cuda`` unless the caller passes
another).

scikit-learn is needed only to unpickle (its classes must be importable);
nothing here imports it when the module is imported, and every prediction
runs through the port's own GP.

SECURITY: ``pickle.load`` runs arbitrary code embedded in the file; this
is inherent to loading sklearn checkpoints (the reference has the same
exposure). Only load pickles you trust.
"""

from __future__ import annotations

import pickle
from typing import Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..gp.exact_gp import GPParams, GPPosterior, fit_gp
from ..gp.per_dim import PerDimGP, Standardizer, _stack

PER_DIM_OUTPUT_NAMES = (
    "x_residual", "y_residual", "z_residual",
    "vx_residual", "vy_residual", "vz_residual",
)  # pretrained_gp.py:65-67


def _kernel_hyperparams(kernel) -> Tuple[np.ndarray, float, float]:
    """(length_scale, signal_variance, noise_variance) from a fitted sklearn
    kernel. Handles the reference's two shapes — ``RBF + White``
    (simple_gp.py:160) and ``Const * RBF(ARD) + White``
    (gp_trainer.py:163-166) — plus bare RBF/products of the same parts."""
    import sklearn.gaussian_process.kernels as K

    signal = 1.0
    noise = 0.0
    length = None

    def walk(k, scale):
        nonlocal signal, noise, length
        if isinstance(k, K.Sum):
            walk(k.k1, scale)
            walk(k.k2, scale)
        elif isinstance(k, K.Product):
            if isinstance(k.k1, K.ConstantKernel):
                walk(k.k2, scale * float(k.k1.constant_value))
            elif isinstance(k.k2, K.ConstantKernel):
                walk(k.k1, scale * float(k.k2.constant_value))
            else:
                raise ValueError(f"unsupported kernel product: {k}")
        elif isinstance(k, K.RBF):
            if length is not None:
                raise ValueError(
                    "multiple RBF components in one kernel are not "
                    "supported (single shared RBF expected, as in both "
                    "reference configurations)"
                )
            length = np.asarray(k.length_scale, np.float64)
            signal = scale
        elif isinstance(k, K.WhiteKernel):
            noise = scale * float(k.noise_level)
        elif isinstance(k, K.ConstantKernel):
            # additive constant has no counterpart; reject loudly
            raise ValueError("additive ConstantKernel is not supported")
        else:
            raise ValueError(f"unsupported kernel component: {type(k)}")

    walk(kernel, 1.0)
    if length is None:
        raise ValueError(f"no RBF component found in kernel {kernel}")
    return length, signal, noise


def _posterior_from_gpr(gpr, dtype=torch.float64, device=None) -> GPPosterior:
    """Rebuild a ``GPPosterior`` from a FITTED GaussianProcessRegressor:
    hyperparameters off ``kernel_``, targets un-normalised from the stored
    (internally normalised) ``y_train_``, factorisation redone by
    ``fit_gp`` with the same ``alpha`` jitter and normalize_y semantics."""
    length, signal, noise = _kernel_hyperparams(gpr.kernel_)
    dev = resolve_device(device)
    params = GPParams.create(
        length_scale=length, signal_variance=signal, noise_variance=noise, device=dev
    )
    X = np.asarray(gpr.X_train_, np.float64)
    Yn = np.asarray(gpr.y_train_, np.float64)
    if Yn.ndim == 1:
        Yn = Yn[:, None]
    # sklearn stores y_train_ NORMALISED when normalize_y; undo it so our
    # fit_gp re-derives identical y_mean/y_std
    y_mean = np.asarray(getattr(gpr, "_y_train_mean", 0.0), np.float64)
    y_std = np.asarray(getattr(gpr, "_y_train_std", 1.0), np.float64)
    Y = Yn * y_std + y_mean
    jitter = float(np.max(np.atleast_1d(gpr.alpha)))
    return fit_gp(
        params,
        torch.as_tensor(X).to(dtype=dtype, device=dev),
        torch.as_tensor(Y).to(dtype=dtype, device=dev),
        jitter=jitter,
        normalize_y=bool(gpr.normalize_y),
    )


def load_sklearn_gp_pickle(path: str, dtype=torch.float64, device=None):
    """Load the reference's single-GP pickle into ``(posterior, meta)``.

    ``meta`` carries the pickle's bookkeeping fields (``training_count``,
    ``data_points_used``, ``timestamp``, ``is_trained``) so callers can
    reproduce the reference's gating (e.g. the >=500-sample output
    -correction gate, mpc_gp.py:346)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return _single_from_dict(data, dtype, device)


def _single_from_dict(data, dtype, device):
    if isinstance(data, dict) and "gp_model" in data:
        gpr = data["gp_model"]
        meta = {k: v for k, v in data.items() if k != "gp_model"}
    else:  # a bare pickled regressor
        gpr, meta = data, {}
    # surface the regressor's ACTUAL fit settings so any downstream refit
    # (e.g. the CLI's capacity cap) reuses them instead of config defaults —
    # a bare GPR with normalize_y=False / non-default alpha must round-trip
    meta["jitter"] = float(np.max(np.atleast_1d(gpr.alpha)))
    meta["normalize_y"] = bool(gpr.normalize_y)
    return _posterior_from_gpr(gpr, dtype, device), meta


def load_sklearn_perdim_pickle(path: str, dtype=torch.float64, device=None) -> PerDimGP:
    """Load the per-dimension ``GPTrainer`` package into a ``PerDimGP``.

    Each output's regressor was fitted on ITS scaler's standardised inputs
    (gp_trainer.py:152-176); the trainer fits one scaler per output on the
    same X, so they are numerically identical — asserted here — and the
    shared ``PerDimGP.scaler_X`` reproduces ``pretrained_gp.py:72`` exactly.
    Partial packages are legitimate reference output — ``gp_trainer.py``
    skips an output when ``std(y) < 1e-6`` and ``pretrained_gp.py:93-96``
    tolerates the gap by predicting zero — so missing outputs get a
    zero-residual posterior here (zero targets on the shared X: the
    posterior mean is exactly 0 everywhere)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return _perdim_from_dict(data, dtype, device)


def _perdim_from_dict(data, dtype, device) -> PerDimGP:
    models = data["gp_models"]
    scalers_X = data["scalers_X"]
    scalers_y = data["scalers_y"]
    present = [n for n in PER_DIM_OUTPUT_NAMES if n in models]
    if not present:
        raise ValueError(
            f"per-dim package has none of the outputs {PER_DIM_OUTPUT_NAMES}"
        )

    sx0 = scalers_X[present[0]]
    for name in present[1:]:
        if not (
            np.allclose(scalers_X[name].mean_, sx0.mean_)
            and np.allclose(scalers_X[name].scale_, sx0.scale_)
        ):
            raise ValueError(
                "per-dim input scalers disagree across outputs — the "
                "package was not produced by the reference trainer"
            )

    dev = resolve_device(device)
    template = _posterior_from_gpr(models[present[0]], dtype, dev)

    def zero_posterior() -> GPPosterior:
        # gp_trainer.py skips an output when std(y_train) < 1e-6;
        # pretrained_gp.py:93-96 then predicts zero for it. Zero targets on
        # the template's (standardised) X give mean == 0 everywhere (alpha =
        # K^{-1} 0 = 0) with the template's hyperparameters, so the stacked
        # stack keeps uniform shapes.
        Y0 = torch.zeros((template.X_train.shape[0], 1), dtype=dtype, device=dev)
        return fit_gp(template.params, template.X_train, Y0,
                      jitter=float(torch.exp(template.params.log_noise_variance))
                      + 1e-10,
                      normalize_y=False)

    posteriors = []
    y_means, y_stds = [], []
    for name in PER_DIM_OUTPUT_NAMES:
        if name in models:
            posteriors.append(_posterior_from_gpr(models[name], dtype, dev))
            y_means.append(float(np.atleast_1d(scalers_y[name].mean_)[0]))
            y_stds.append(float(np.atleast_1d(scalers_y[name].scale_)[0]))
        else:
            posteriors.append(zero_posterior())
            y_means.append(0.0)
            y_stds.append(1.0)

    f = dict(dtype=dtype, device=dev)
    return PerDimGP(
        posteriors=_stack(posteriors),
        scaler_X=Standardizer(
            mean=torch.as_tensor(sx0.mean_).to(**f),
            std=torch.as_tensor(sx0.scale_).to(**f),
        ),
        scaler_Y=Standardizer(
            mean=torch.tensor(y_means, **f), std=torch.tensor(y_stds, **f)
        ),
    )


def load_reference_gp(path: str, dtype=torch.float64, device=None):
    """Auto-detect and load either reference pickle format.

    Returns ``("single", posterior, meta)`` or ``("per_dim", model, {})``.
    """
    with open(path, "rb") as f:
        data = pickle.load(f)
    if isinstance(data, dict) and "gp_models" in data:
        return "per_dim", _perdim_from_dict(data, dtype, device), {}
    post, meta = _single_from_dict(data, dtype, device)
    return "single", post, meta
