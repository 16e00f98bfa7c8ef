"""Parallel-in-horizon LQR (port of ``ops/parallel_riccati.py``).

``ops.riccati.lqr_tracking_solve`` runs one backward and one forward pass
over the stages, O(N) sequential steps. This module computes the same
solution with O(log N) depth by temporal parallelisation (Sarkka and
Garcia-Fernandez, "Temporal Parallelization of Dynamic Programming and
Linear Quadratic Trackers"):

* backward: the value functions compose as matrix fractional
  transformations. A stage is the 5-tuple ``(A, b, C, eta, J)`` and
  ``_combine`` is associative, so every suffix value function comes from
  one inclusive suffix scan;
* forward: the closed-loop rollout ``x+ = (A - B K) x + v`` is a chain of
  affine maps ``(M, v)``, composed by an inclusive prefix scan.

Both scans are written by hand (``inclusive_scan``): Hillis and Steele's
log-depth scan over the stage axis, each level one batched combine of
every element with the one ``2^level`` stages away, for any N. Semantics
and signature are those of ``lqr_tracking_solve``.
"""

from __future__ import annotations

from typing import Callable

import torch

from .qp import cholesky_or_nan
from .riccati import LQRSolution


def _combine(e_i, e_j):
    """Compose conditional value elements, ``e_i`` over the EARLIER
    interval: ``(A, b, C, eta, J)`` are the interval's dynamics compression
    (A, b), accumulated control Gramian C and cost-to-go terms (J, eta).
    Batched over leading dimensions."""
    A_i, b_i, C_i, eta_i, J_i = e_i
    A_j, b_j, C_j, eta_j, J_j = e_j
    eye = torch.eye(A_i.shape[-1], dtype=A_i.dtype, device=A_i.device)
    T = lambda M: M.transpose(-1, -2)
    ICJ = eye + C_i @ J_j
    A = A_j @ torch.linalg.solve(ICJ, A_i)
    b = (A_j @ torch.linalg.solve(ICJ, b_i[..., None] + C_i @ eta_j[..., None]))[..., 0] + b_j
    C = A_j @ (torch.linalg.solve(ICJ, C_i) @ T(A_j)) + C_j
    IJC = eye + J_j @ C_i
    eta = (T(A_i) @ torch.linalg.solve(IJC, eta_j[..., None] - J_j @ b_i[..., None]))[..., 0] + eta_i
    J = T(A_i) @ (torch.linalg.solve(IJC, J_j) @ A_i) + J_i
    return (A, b, C, eta, J)


def _compose(f, g):
    """Affine maps ``x -> M x + v``, ``f`` applied first."""
    M_f, v_f = f
    M_g, v_g = g
    return M_g @ M_f, (M_g @ v_f[..., None])[..., 0] + v_g


def inclusive_scan(combine: Callable, elems: tuple, reverse: bool = False) -> tuple:
    """Inclusive scan of ``combine`` over axis 0 of a tuple of tensors
    (Hillis-Steele: ceil(log2 L) levels, each one batched ``combine``).
    ``combine(earlier, later)`` must be associative. Forward, element k
    becomes ``e_0 (x) ... (x) e_k``; with ``reverse``, ``e_k (x) ... (x)
    e_{L-1}``; the earlier element stays first in every combine."""
    L = elems[0].shape[0]
    out = tuple(elems)
    d = 1
    while d < L:
        early = tuple(t[:-d] for t in out)
        late = tuple(t[d:] for t in out)
        merged = combine(early, late)
        if reverse:    # element k takes in k + d: rows 0..L-d-1 change
            out = tuple(torch.cat([m, t[L - d:]]) for m, t in zip(merged, out))
        else:          # element k takes in k - d: rows d..L-1 change
            out = tuple(torch.cat([t[:d], m]) for m, t in zip(merged, out))
        d *= 2
    return out


def lqr_tracking_solve_parallel(
    A: torch.Tensor,        # (N, nx, nx)
    B: torch.Tensor,        # (N, nx, nu)
    c: torch.Tensor,        # (N, nx)
    q_diag: torch.Tensor,   # (N+1, nx) stage and terminal state-cost diagonals
    r_diag: torch.Tensor,   # (nu,)
    x_ref: torch.Tensor,    # (N+1, nx)
    u_ref: torch.Tensor,    # (N, nu)
    x0: torch.Tensor,       # (nx,)
) -> LQRSolution:
    """Drop-in parallel counterpart of ``lqr_tracking_solve``."""
    N, nx, _ = B.shape
    kw = dict(dtype=B.dtype, device=B.device)
    R = torch.diag(r_diag)
    Rinv = torch.diag(1.0 / r_diag)

    # stage elements, u = utilde + uref absorbed: stage k < N is (A_k, c_k +
    # B_k uref_k, 1/2 B R^-1 B', 2 Q_k xref_k, 2 Q_k), the terminal one (0,
    # 0, 0, 2 Q_N xref_N, 2 Q_N); the factor 2 maps the |.|^2_Q costs onto
    # the 1/2 |.|^2 form of the composition rule, so P_k = J_k / 2
    b_stage = c + torch.einsum("kij,kj->ki", B, u_ref)
    C_stage = 0.5 * torch.einsum("kij,jl,kml->kim", B, Rinv, B)
    J_stage = torch.diag_embed(2.0 * q_diag[:N])
    eta_stage = 2.0 * q_diag[:N] * x_ref[:N]
    elems = (
        torch.cat([A, torch.zeros(1, nx, nx, **kw)]),
        torch.cat([b_stage, torch.zeros(1, nx, **kw)]),
        torch.cat([C_stage, torch.zeros(1, nx, nx, **kw)]),
        torch.cat([eta_stage, (2.0 * q_diag[N] * x_ref[N])[None]]),
        torch.cat([J_stage, torch.diag(2.0 * q_diag[N])[None]]),
    )
    suffix = inclusive_scan(_combine, elems, reverse=True)
    P_next = 0.5 * suffix[4][1:]           # (N, nx, nx)
    q_next = -0.5 * suffix[3][1:]          # (N, nx)

    # per-stage gains, batched over the stages (the sequential algebra)
    Bt = B.transpose(-1, -2)
    BtP = Bt @ P_next
    L = cholesky_or_nan(R + BtP @ B)
    Ks = torch.cholesky_solve(BtP @ A, L)
    rhs = (Bt @ ((P_next @ c[..., None])[..., 0] + q_next)[..., None])[..., 0] - r_diag * u_ref
    ds = torch.cholesky_solve(rhs[..., None], L)[..., 0]

    # the closed-loop rollout as a prefix scan of affine maps
    M = A - B @ Ks
    v = c - (B @ ds[..., None])[..., 0]
    Mp, vp = inclusive_scan(_compose, (M, v))
    X = torch.cat([x0[None, :], (Mp @ x0) + vp])
    U = -(Ks @ X[:-1, :, None])[..., 0] - ds
    return LQRSolution(U=U, X=X, gains=Ks, feedforward=ds)
