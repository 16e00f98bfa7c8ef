"""Residual-dynamics GP (port of ``gp/residual_gp.py``).

10-D input ``[x,y,z,vx,vy,vz,ax,ay,az,yaw_rate]`` -> 6-D state residual
``state_next - nominal(state, control, dt)``, with the reference's data
quality filters and sklearn configuration (``RBF(0.5) + WhiteKernel(0.1)``,
``alpha=1e-4``, ``normalize_y=True``). ``ResidualDataset`` is a
fixed-capacity ring buffer updated on the device without host syncs.

The predictive variance serves two consumers: ``build_horizon_uncertainty``
(the stage-wise std that tightens the MPC's state boxes) and
``output_correction`` (the reference's earlier GP-MPC generation, which
corrects the solved control after the solve, gated on the GP's confidence).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .._device import full_f32_matmul, resolve_device
from ..models.double_integrator import double_integrator_step
from .exact_gp import GPParams, GPPosterior, _work_dtype, fit_gp, predict, predict_mean
from .kernels import rbf_kernel

INPUT_DIM = 10
OUTPUT_DIM = 6


@dataclass(frozen=True)
class ResidualGPConfig:
    max_data_points: int = 800
    dt: float = 0.02
    max_velocity_norm: float = 5.0
    max_control_norm: float = 3.0
    max_residual_norm: float = 2.0
    length_scale: float = 0.5
    noise_variance: float = 0.1
    alpha: float = 1e-4
    residual_gain: float = 0.1


class ResidualDataset(NamedTuple):
    """Fixed-capacity ring buffer of (input, residual) pairs."""

    X: torch.Tensor        # (capacity, 10)
    Y: torch.Tensor        # (capacity, 6)
    head: torch.Tensor     # 0-d int64: next write slot (monotone)
    count: torch.Tensor    # 0-d int64: number of valid rows (<= capacity)


def empty_dataset(capacity: int = 800, dtype=torch.float32, device=None) -> ResidualDataset:
    dev = resolve_device(device)
    return ResidualDataset(
        X=torch.zeros(capacity, INPUT_DIM, dtype=dtype, device=dev),
        Y=torch.zeros(capacity, OUTPUT_DIM, dtype=dtype, device=dev),
        head=torch.zeros((), dtype=torch.int64, device=dev),
        count=torch.zeros((), dtype=torch.int64, device=dev),
    )


def add_training_sample(
    dataset: ResidualDataset,
    state: torch.Tensor,
    control: torch.Tensor,
    state_next: torch.Tensor,
    config: ResidualGPConfig = ResidualGPConfig(),
) -> ResidualDataset:
    """One ring-buffer insert with the reference's quality filters
    (``simple_gp.py:118-141``): a rejected sample leaves the buffer as it
    was; an accepted one takes slot ``head % capacity``."""
    return add_training_samples_batch(dataset, state[None], control[None], state_next[None],
                                      config)


def add_training_samples_batch(
    dataset: ResidualDataset,
    states: torch.Tensor,        # (K, >=6)
    controls: torch.Tensor,      # (K, >=4)
    states_next: torch.Tensor,   # (K, >=6)
    config: ResidualGPConfig = ResidualGPConfig(),
) -> ResidualDataset:
    """K ring-buffer inserts with the reference's quality filters, equal to
    K sequential single inserts.

    Accepted samples take consecutive ring slots by a prefix count
    (wrap-around included). Rejected samples are written to one scratch
    row past the ring, which is cut off: the scatter never reads the number
    of accepted rows on the host, so a flight pays no sync per launch."""
    K = states.shape[0]
    capacity = dataset.X.shape[0]
    if K > capacity:
        raise ValueError(f"batch of {K} inserts exceeds ring capacity {capacity}")
    s6 = states[:, :6]
    n6 = states_next[:, :6]
    c4 = controls[:, :4]

    velocity_norm = torch.linalg.vector_norm(s6[:, 3:6], dim=1)
    control_norm = torch.linalg.vector_norm(c4[:, :3], dim=1)
    residual = n6 - double_integrator_step(s6, c4, config.dt)
    residual_norm = torch.linalg.vector_norm(residual, dim=1)
    accept = (
        (velocity_norm <= config.max_velocity_norm)
        & (control_norm <= config.max_control_norm)
        & (residual_norm <= config.max_residual_norm)
    )

    acc_i = accept.to(torch.int64)
    before = torch.cumsum(acc_i, dim=0) - acc_i
    slots = torch.where(
        accept, (dataset.head + before) % capacity, torch.full_like(before, capacity)
    )
    rows = torch.cat([s6, c4], dim=1).to(dataset.X.dtype)

    def scatter(buf, vals):
        ext = torch.cat([buf, buf.new_zeros(1, buf.shape[1])], dim=0)
        ext[slots] = vals.to(buf.dtype)
        return ext[:capacity]

    n_new = acc_i.sum()
    return ResidualDataset(
        X=scatter(dataset.X, rows),
        Y=scatter(dataset.Y, residual),
        head=dataset.head + n_new,
        count=torch.clamp(dataset.count + n_new, max=capacity),
    )


def default_params(config: ResidualGPConfig = ResidualGPConfig(), device=None) -> GPParams:
    return GPParams.create(
        length_scale=config.length_scale,
        signal_variance=1.0,
        noise_variance=config.noise_variance,
        device=device,
    )


def masked_input_stats(dataset: ResidualDataset):
    """Per-dim (mean, std) of the valid ring-buffer inputs; degenerate
    dims get std 1. The mean doubles as the fit's ``x_shift``."""
    capacity = dataset.X.shape[0]
    valid = (torch.arange(capacity, device=dataset.X.device) < dataset.count)[:, None]
    count = torch.clamp(dataset.count, min=1).to(dataset.X.dtype)
    Xv = torch.where(valid, dataset.X, 0.0)
    mean = torch.sum(Xv, dim=0) / count
    var = torch.sum(torch.where(valid, (dataset.X - mean) ** 2, 0.0), dim=0) / count
    std = torch.sqrt(var)
    std = torch.where(std > 1e-8, std, torch.ones_like(std))
    return mean, std


def standardized_params(
    dataset: ResidualDataset,
    config: ResidualGPConfig = ResidualGPConfig(),
    std: torch.Tensor | None = None,
) -> GPParams:
    """ARD length scales ``l * sigma_d`` equivalent to standardizing the
    inputs (sigma_d: masked per-dim std over valid rows)."""
    if std is None:
        _, std = masked_input_stats(dataset)
    dev = dataset.X.device
    return GPParams.create(
        length_scale=config.length_scale * std,
        signal_variance=1.0,
        noise_variance=config.noise_variance,
        device=dev,
    )


def fit_residual_gp(
    X: torch.Tensor,
    Y: torch.Tensor,
    config: ResidualGPConfig = ResidualGPConfig(),
    params: GPParams | None = None,
) -> GPPosterior:
    """Fit on (n,10)/(n,6) tensors: fixed hyperparameters, alpha jitter,
    normalized targets."""
    if params is None:
        params = default_params(config, device=X.device)
    return fit_gp(params, X, Y, jitter=config.alpha, normalize_y=True)


def fit_residual_gp_masked(
    dataset: ResidualDataset,
    config: ResidualGPConfig = ResidualGPConfig(),
    params: GPParams | None = None,
    x_shift: torch.Tensor | None = None,
) -> GPPosterior:
    """Fit on a partially filled ring buffer with static shapes.

    Invalid rows are masked out algebraically: off-diagonal kernel entries
    0, diagonal 1, target 0, so their alpha is exactly 0; target
    normalisation uses masked statistics. Invalid training inputs are set
    to a large finite sentinel (1e6), so a query's kernel value against
    them underflows to 0. The Gram matrix and its Cholesky factor are in
    float64 with the default (float64) hyperparameters."""
    full_f32_matmul()
    X, Y = dataset.X, dataset.Y
    if params is None:
        params = default_params(config, device=X.device)

    capacity = X.shape[0]
    valid = (torch.arange(capacity, device=X.device) < dataset.count)[:, None]
    count = torch.clamp(dataset.count, min=1).to(X.dtype)
    X_in = X if x_shift is None else X - x_shift

    Yv = torch.where(valid, Y, 0.0)
    y_mean = torch.sum(Yv, dim=0) / count
    y_var = torch.sum(torch.where(valid, (Y - y_mean) ** 2, 0.0), dim=0) / count
    y_std = torch.sqrt(y_var)
    y_std = torch.where(y_std == 0.0, torch.ones_like(y_std), y_std)
    Yn = torch.where(valid, (Y - y_mean) / y_std, 0.0)

    wd = _work_dtype(params, X_in)
    K = rbf_kernel(X_in.to(wd), X_in.to(wd), params.length_scale.to(wd),
                   params.signal_variance.to(wd))
    mask2d = valid & valid.T
    K = torch.where(mask2d, K, 0.0)
    diag = torch.where(
        valid[:, 0],
        torch.diagonal(K) + params.noise_variance.to(wd) + config.alpha,
        1.0,
    )
    K.diagonal().copy_(diag)

    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(Yn.to(wd), L)
    return GPPosterior(
        params=params,
        X_train=torch.where(valid, X_in, 1e6),
        chol=L,
        alpha=alpha,
        y_mean=y_mean,
        y_std=y_std,
        y_train_norm=Yn,
        x_shift=x_shift,
    )


def predict_residual(posterior: GPPosterior, state: torch.Tensor,
                     control: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean residual (6,), variance (6,))`` for one (state, control) pair
    (``simple_gp.py:187-197``)."""
    mean, var = predict(posterior, torch.cat([state[:6], control[:4]])[None, :])
    return mean[0], var[0]


def build_horizon_residuals(
    posterior: GPPosterior,
    X_guess: torch.Tensor,
    U_guess: torch.Tensor,
    config: ResidualGPConfig = ResidualGPConfig(),
) -> torch.Tensor:
    """Stage-wise MPC dynamics residuals from the warm-start trajectory:
    one batched posterior over the horizon, state residual / dt on the
    acceleration rows, scaled by ``residual_gain``.

    ``X_guess (N+1, 6)``, ``U_guess (N, 4)`` -> ``(N, 6)``. Free of
    in-place writes, so ``torch.func.vmap`` maps it over flights."""
    N = U_guess.shape[0]
    inputs = torch.cat([X_guess[:N, :6], U_guess[:, :4]], dim=1)
    mean = predict_mean(posterior, inputs)        # (N, 6) state residuals
    return _acceleration_rows(mean, config)


def _acceleration_rows(mean: torch.Tensor, config: ResidualGPConfig) -> torch.Tensor:
    """State residuals ``(..., 6)`` -> dynamics residuals: ``/ dt`` on the
    acceleration rows, scaled by ``residual_gain``, zeros on the position
    rows (the reference's conversion, ``mpc.py:1490-1506``)."""
    acc = config.residual_gain * (mean[..., 3:6] / config.dt)
    return torch.cat([torch.zeros_like(acc), acc], dim=-1)


def build_horizon_residuals_batched_fused(
    posterior,
    X_guess: torch.Tensor,
    U_guess: torch.Tensor,
    config: ResidualGPConfig = ResidualGPConfig(),
    precision: str = "high",
    plain_kernels: bool = False,
) -> torch.Tensor:
    """Flight-batched ``build_horizon_residuals`` through the fused
    posterior-mean kernel K7 (``ops.rbf_pallas.rbf_posterior_mean_pallas``),
    whose ``(B N, n_train)`` cross-kernel matrix is never written out.
    ``posterior`` is a ``GPPosterior`` or its ``PosteriorMeanOperands``;
    ``precision`` is accepted for the JAX signature (K7 computes in float32
    for every tier). ``plain_kernels=True`` runs K7's plain version on any
    device.

    ``X_guess (B, N+1, 6)``, ``U_guess (B, N, 4)`` -> ``(B, N, 6)`` float32."""
    from ..ops.rbf_pallas import rbf_posterior_mean_pallas, rbf_posterior_mean_plain

    B, N = U_guess.shape[0], U_guess.shape[1]
    inputs = torch.cat([X_guess[:, :N, :6], U_guess[:, :, :4]], dim=2)
    inputs = inputs.to(torch.float32).reshape(B * N, INPUT_DIM).contiguous()
    mean_fn = rbf_posterior_mean_plain if plain_kernels else rbf_posterior_mean_pallas
    mean = mean_fn(posterior, inputs, precision).reshape(B, N, OUTPUT_DIM)
    return _acceleration_rows(mean, config)


def build_horizon_uncertainty(
    posterior: GPPosterior,
    X_guess: torch.Tensor,
    U_guess: torch.Tensor,
    config: ResidualGPConfig = ResidualGPConfig(),
) -> torch.Tensor:
    """Stage-wise GP predictive std of the dynamics residual, ``(N, 6)``:
    the same ``/ dt`` and gain conversion as the residual means, on the
    acceleration rows. ``LinearMPC.solve(uncertainty=...)`` backs the state
    boxes off by it (zero-order GP-MPC, arXiv:2211.15522)."""
    N = U_guess.shape[0]
    inputs = torch.cat([X_guess[:N, :6], U_guess[:, :4]], dim=1)
    _, var = predict(posterior, inputs)            # (N, 6) state-residual variance
    return _acceleration_rows(torch.sqrt(var), config)


@dataclass(frozen=True)
class OutputCorrectionConfig:
    """Constants of the reference's first GP-MPC generation
    (``mpc_gp.py:341-372``), which corrects the solved control after the
    solve instead of entering the prediction model."""

    correction_gain: float = 0.01       # mpc_gp.py:362
    correction_clip: float = 0.1        # mpc_gp.py:368
    confidence_threshold: float = 0.1   # mpc_gp.py:134 (uncertainty gate)
    min_train_samples: int = 500        # mpc_gp.py:346
    max_velocity_norm: float = 2.0      # mpc_gp.py:352 "system is stable"
    max_position_error: float = 5.0     # mpc_gp.py:352


def output_correction(
    posterior: GPPosterior,
    state6: torch.Tensor,
    u_opt: torch.Tensor,
    target_pos: torch.Tensor,
    n_train,
    config: OutputCorrectionConfig = OutputCorrectionConfig(),
) -> torch.Tensor:
    """Post-solve GP control correction: ``clip(gain * mean[3:6], +-clip)``
    added to the solved accelerations when the GP has at least
    ``min_train_samples`` samples, the state is stable (speed and position
    error below their limits) and the mean posterior std is below the
    confidence threshold. The three gates are one ``torch.where`` on the
    device (no host read per tick)."""
    mean, var = predict(posterior, torch.cat([state6[:6], u_opt[:4]])[None, :])
    uncertainty = torch.mean(torch.sqrt(var[0]))
    correction = torch.clamp(config.correction_gain * mean[0, 3:6],
                             -config.correction_clip, config.correction_clip)
    stable = (
        (torch.linalg.vector_norm(state6[3:6]) < config.max_velocity_norm)
        & (torch.linalg.vector_norm(state6[0:3] - target_pos) < config.max_position_error)
    )
    apply = (
        (torch.as_tensor(n_train, device=u_opt.device) >= config.min_train_samples)
        & stable & (uncertainty < config.confidence_threshold)
    )
    applied = torch.where(apply, correction, 0.0).to(u_opt.dtype)
    return torch.cat([u_opt[0:3] + applied, u_opt[3:]])


def make_output_correction_fn(
    posterior: GPPosterior,
    n_train: int,
    config: OutputCorrectionConfig = OutputCorrectionConfig(),
):
    """The rollout hook ``(state6, u_opt, target_pos) -> u_corrected`` with
    ``posterior`` bound."""

    def fn(state6, u_opt, target_pos):
        return output_correction(posterior, state6, u_opt, target_pos, n_train, config)

    return fn
