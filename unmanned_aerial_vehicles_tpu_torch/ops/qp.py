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


def admm_box_qp(
    M_inv: torch.Tensor,   # (n, n) = (H + rho G'G)^{-1}
    G: torch.Tensor,       # (m, n)
    f: torch.Tensor,       # (n,)
    lower: torch.Tensor,
    upper: torch.Tensor,
    z0: torch.Tensor,
    y0: torch.Tensor,
    rho: float,
    iterations: int,
    over_relax: float = 1.6,
) -> AdmmState:
    """Fixed-iteration over-relaxed ADMM for ``min 1/2 U'HU + f'U,
    l <= GU <= u`` with the explicit inverse ``M_inv``: per iteration
    ``U = M^{-1}(-f + G'(rho z - y))``, ``GU``, relaxation, box projection
    and dual step. The returned primal is refreshed from the final
    ``(z, y)``, as in ``admm_box_qp_composite`` and the fused kernel K14
    (``ops.admm_pallas.admm_box_qp_fused``)."""
    GT = G.T
    z, y = z0, y0
    for _ in range(iterations):
        U = M_inv @ (-f + GT @ (rho * z - y))
        Gt = over_relax * (G @ U) + (1.0 - over_relax) * z
        z_new = torch.minimum(torch.maximum(Gt + y / rho, lower), upper)
        y = y + rho * (Gt - z_new)
        z = z_new
    U = M_inv @ (-f + GT @ (rho * z - y))
    return AdmmState(U, z, y)


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


def admm_box_qp_chol(
    M_chol: torch.Tensor,  # (n, n) lower Cholesky factor of M = H + rho G'G
    G: torch.Tensor,       # (m, n)
    f: torch.Tensor,       # (n,)
    lower: torch.Tensor,
    upper: torch.Tensor,
    z0: torch.Tensor,
    y0: torch.Tensor,
    rho: float,
    iterations: int,
    over_relax: float = 1.6,
) -> AdmmState:
    """ADMM with a Cholesky factor of ``M = H + rho G'G`` formed from
    tensors (the traced-weight MPC of the tuner): two triangular solves per
    iteration, ``U = M^{-1} (-f + G'(rho z - y))``. The iteration count is
    fixed, so reverse mode through the solver is exact."""
    U = torch.zeros(G.shape[1], dtype=f.dtype, device=f.device)
    z, y = z0, y0
    for _ in range(iterations):
        rhs = -f + G.T @ (rho * z - y)
        U = torch.cholesky_solve(rhs[:, None], M_chol)[:, 0]
        Gt = over_relax * (G @ U) + (1.0 - over_relax) * z
        z_new = torch.minimum(torch.maximum(Gt + y / rho, lower), upper)
        y = y + rho * (Gt - z_new)
        z = z_new
    return AdmmState(U, z, y)


def condense_ltv(A: torch.Tensor, B: torch.Tensor, c: torch.Tensor):
    """Condensation of time-varying affine dynamics
    ``x_{k+1} = A_k x_k + B_k u_k + c_k`` with ``A (N, nx, nx)``, ``B (N, nx,
    nu)``, ``c (N, nx)``: ``(Sx (N nx, nx), Su (N nx, N nu), Sc (N nx,))``
    with ``X = Sx x0 + Su U + Sc`` for ``X = [x_1..x_N]``, ``U =
    [u_0..u_{N-1}]``. A serial pass of three small products per stage."""
    N, nx, nu = B.shape
    row_x = torch.eye(nx, dtype=B.dtype, device=B.device)
    row_u = torch.zeros(nx, N * nu, dtype=B.dtype, device=B.device)
    row_c = torch.zeros(nx, dtype=B.dtype, device=B.device)
    Sx, Su, Sc = [], [], []
    for k in range(N):
        row_x = A[k] @ row_x
        row_u = A[k] @ row_u
        row_u[:, k * nu:(k + 1) * nu] = B[k]
        row_c = A[k] @ row_c + c[k]
        Sx.append(row_x)
        Su.append(row_u)
        Sc.append(row_c)
    return torch.cat(Sx), torch.cat(Su), torch.cat(Sc)


def condense_ltv_doubling(A: torch.Tensor, B: torch.Tensor, c: torch.Tensor):
    """``condense_ltv`` by log-depth block doubling: adjacent horizon
    blocks combine as

        Sx = [Sx_L; Sx_R PhiL],  Su = [[Su_L, 0], [Sx_R SuL_end, Su_R]],
        Sc = [Sc_L; Sx_R ScL_end + Sc_R],

    ``ceil(log2 N)`` levels of batched small products. The horizon pads to
    a power of two with zero stages, sliced off at the end. The products
    associate differently from the serial form, so the two agree to
    rounding."""
    N, nx, nu = B.shape
    P = 1 << max(N - 1, 0).bit_length()
    if P != N:
        pad = P - N
        A = torch.cat([A, A.new_zeros(pad, nx, nx)])
        B = torch.cat([B, B.new_zeros(pad, nx, nu)])
        c = torch.cat([c, c.new_zeros(pad, nx)])
    Sx, Su, Sc = A, B, c          # blocks of length L=1: (P, L nx, .)
    L = 1
    while L < P:
        SxL, SxR = Sx[0::2], Sx[1::2]
        SuL, SuR = Su[0::2], Su[1::2]
        ScL, ScR = Sc[0::2], Sc[1::2]
        PhiL = SxL[:, -nx:, :]                    # end-state map of the left block
        SuLe = SuL[:, -nx:, :]
        ScLe = ScL[:, -nx:]
        Sx = torch.cat([SxL, torch.bmm(SxR, PhiL)], dim=1)
        Su = torch.cat([
            torch.cat([SuL, torch.zeros_like(SuL)], dim=2),
            torch.cat([torch.bmm(SxR, SuLe), SuR], dim=2),
        ], dim=1)
        Sc = torch.cat([ScL, torch.bmm(SxR, ScLe[:, :, None])[:, :, 0] + ScR], dim=1)
        L *= 2
    return Sx[0, : N * nx], Su[0, : N * nx, : N * nu], Sc[0, : N * nx]


def shift_stages(mat: torch.Tensor) -> torch.Tensor:
    """The warm-start shift: rows moved one forward, the last repeated."""
    return torch.cat([mat[1:], mat[-1:]], dim=0)


def roll_block(vec: torch.Tensor, N: int) -> torch.Tensor:
    """A vector of N stages moved one stage forward, its last stage repeated."""
    return shift_stages(vec.reshape(N, -1)).reshape(-1)
