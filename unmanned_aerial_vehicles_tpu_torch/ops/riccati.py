"""Finite-horizon LQR by the backward Riccati recursion (port of
``ops/riccati.py``).

For the unconstrained tracking problem with affine time-varying dynamics
``x_{k+1} = A_k x_k + B_k u_k + c_k``,

    min sum_k |x_k - xref_k|^2_{Q_k} + |u_k - uref_k|^2_R   (+ terminal Q_N),

the exact optimum comes from one backward pass over the stages and one
forward rollout, O(N) in the horizon. With the value function ``V_k(x) =
x'P_k x + 2 q_k'x + const``:

    K_k = (R + B'P_{k+1}B)^{-1} B'P_{k+1}A
    d_k = (R + B'P_{k+1}B)^{-1} (B'(P_{k+1}c_k + q_{k+1}) - R uref_k)
    P_k = Q_k + A'P_{k+1}(A - B K_k)
    q_k = A'(P_{k+1}(c_k - B d_k) + q_{k+1}) - Q_k xref_k

and the controls follow ``u_k = -K_k x_k - d_k``. The passes are Python
loops of small PyTorch ops on the inputs' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .qp import cholesky_or_nan


class LQRSolution(NamedTuple):
    U: torch.Tensor            # (N, nu) optimal controls
    X: torch.Tensor            # (N+1, nx) optimal trajectory
    gains: torch.Tensor        # (N, nu, nx) feedback gains K_k
    feedforward: torch.Tensor  # (N, nu) affine terms d_k


def lqr_tracking_solve(
    A: torch.Tensor,        # (N, nx, nx)
    B: torch.Tensor,        # (N, nx, nu)
    c: torch.Tensor,        # (N, nx)
    q_diag: torch.Tensor,   # (N+1, nx) stage and terminal state-cost diagonals
    r_diag: torch.Tensor,   # (nu,)
    x_ref: torch.Tensor,    # (N+1, nx)
    u_ref: torch.Tensor,    # (N, nu)
    x0: torch.Tensor,       # (nx,)
) -> LQRSolution:
    """Exact unconstrained tracking LQR: the backward pass (an (nu, nu)
    Cholesky per stage, P re-symmetrised every stage), then the forward
    rollout."""
    N = B.shape[0]
    R = torch.diag(r_diag)
    P = torch.diag(q_diag[N])
    q = -q_diag[N] * x_ref[N]
    Ks, ds = [None] * N, [None] * N
    for k in reversed(range(N)):
        A_k, B_k = A[k], B[k]
        BtP = B_k.T @ P
        L = cholesky_or_nan(R + BtP @ B_k)
        K = torch.cholesky_solve(BtP @ A_k, L)
        d = torch.cholesky_solve((B_k.T @ (P @ c[k] + q) - r_diag * u_ref[k])[:, None], L)[:, 0]
        P_new = torch.diag(q_diag[k]) + A_k.T @ (P @ (A_k - B_k @ K))
        q = A_k.T @ (P @ (c[k] - B_k @ d) + q) - q_diag[k] * x_ref[k]
        P = 0.5 * (P_new + P_new.T)
        Ks[k], ds[k] = K, d
    X, U = [x0], []
    for k in range(N):
        u = -(Ks[k] @ X[-1]) - ds[k]
        U.append(u)
        X.append(A[k] @ X[-1] + B[k] @ u + c[k])
    return LQRSolution(U=torch.stack(U), X=torch.stack(X), gains=torch.stack(Ks),
                       feedforward=torch.stack(ds))
