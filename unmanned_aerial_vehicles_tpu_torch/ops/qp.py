"""Condensed box-constrained QP machinery (port of ``ops/qp.py``).

The linear MPC's states are eliminated so the QP lives in control space,

    min_U  1/2 U' H U + f' U      s.t.  l <= G U <= u,     G = [I; Su],

and is solved by fixed-iteration over-relaxed ADMM with a constant system
matrix (warm-started across control ticks).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def condense_dynamics(A: np.ndarray, B: np.ndarray, N: int):
    """Prediction matrices for ``x_{k+1} = A x_k + B u_k + w_k``.

    Returns ``(Sx, Su, Sw)`` with ``X = Sx x0 + Su U + Sw W`` for stacked
    ``X = [x_1..x_N]``, ``U = [u_0..u_{N-1}]``, ``W = [w_0..w_{N-1}]``.
    Pure NumPy, float64, run once at controller build time."""
    nx, nu = B.shape
    Sx = np.zeros((N * nx, nx))
    Su = np.zeros((N * nx, N * nu))
    Sw = np.zeros((N * nx, N * nx))

    Ak = np.eye(nx)
    powers = [Ak]
    for _ in range(N):
        Ak = A @ Ak
        powers.append(Ak)  # powers[k] = A^k

    for k in range(1, N + 1):
        Sx[(k - 1) * nx : k * nx, :] = powers[k]
        for j in range(k):
            blk = powers[k - 1 - j]
            Su[(k - 1) * nx : k * nx, j * nu : (j + 1) * nu] = blk @ B
            Sw[(k - 1) * nx : k * nx, j * nx : (j + 1) * nx] = blk
    return Sx, Su, Sw


class AdmmState(NamedTuple):
    primal: torch.Tensor  # U
    slack: torch.Tensor   # z  (constraint-space iterate)
    dual: torch.Tensor    # y


def admm_box_qp_composite(
    P1: torch.Tensor,      # (m, m) = G M^{-1} G'
    p0: torch.Tensor,      # (m,)   = -G M^{-1} f   (per-tick)
    GMinvT: torch.Tensor,  # (n, m) = M^{-1} G'     (for the final primal)
    Minv_f: torch.Tensor,  # (n,)   = M^{-1} f      (per-tick)
    lower: torch.Tensor,
    upper: torch.Tensor,
    z0: torch.Tensor,
    y0: torch.Tensor,
    rho: float,
    iterations: int,
    over_relax: float = 1.6,
) -> AdmmState:
    """Operator-composed over-relaxed ADMM: one (m, m) matvec per iteration,

        GU = G M^{-1} (-f + G'(rho z - y)) = p0 + P1 (rho z - y),

    the primal ``U = -M^{-1} f + M^{-1} G' (rho z - y)`` recovered once from
    the final ``(z, y)``."""
    z, y = z0, y0
    for _ in range(iterations):
        GU = p0 + P1 @ (rho * z - y)
        Gt = over_relax * GU + (1.0 - over_relax) * z
        z_new = torch.minimum(torch.maximum(Gt + y / rho, lower), upper)
        y = y + rho * (Gt - z_new)
        z = z_new
    U = -Minv_f + GMinvT @ (rho * z - y)
    return AdmmState(U, z, y)
