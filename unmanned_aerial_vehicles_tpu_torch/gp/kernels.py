"""RBF kernel computations (port of ``gp/kernels.py``)."""

from __future__ import annotations

import torch


def rbf_kernel(
    X1: torch.Tensor,
    X2: torch.Tensor,
    length_scale: torch.Tensor,
    signal_variance: torch.Tensor | float = 1.0,
) -> torch.Tensor:
    """``sigma^2 exp(-0.5 ||(x1 - x2)/l||^2)`` for row batches, by the
    squared-distance product form. ``length_scale`` is a scalar
    (isotropic) or a ``(d,)`` tensor (ARD)."""
    Z1 = X1 / length_scale
    Z2 = X2 / length_scale
    sq1 = torch.sum(Z1**2, dim=-1)[:, None]
    sq2 = torch.sum(Z2**2, dim=-1)[None, :]
    cross = Z1 @ Z2.T
    dists = torch.clamp(sq1 + sq2 - 2.0 * cross, min=0.0)
    return signal_variance * torch.exp(-0.5 * dists)


def rbf_kernel_diag(X: torch.Tensor, signal_variance: torch.Tensor | float = 1.0) -> torch.Tensor:
    """``diag(k(X, X))`` without forming the matrix: ``sigma^2`` for every
    row of ``X``, in ``X``'s dtype."""
    sig = torch.as_tensor(signal_variance, dtype=X.dtype, device=X.device)
    return sig.expand(X.shape[:-1]).clone()
