"""Condensed box-constrained QP machinery (port of ``ops/qp.py``).

The linear MPC's states are eliminated so the QP lives in control space,

    min_U  1/2 U' H U + f' U      s.t.  l <= G U <= u,     G = [I; Su],

and is solved by fixed-iteration over-relaxed ADMM with a constant system
matrix (warm-started across control ticks). The verification tier solves
it to convergence: ``ip_box_qp`` (a fixed-iteration primal-dual interior
point) and ``active_set_polish`` (the KKT system on the detected active
set), scored by ``kkt_score`` and ``kkt_residuals``.
"""

from __future__ import annotations

import math
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


def cholesky_or_nan(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``S`` (batched), NaN where the factor does
    not exist, as JAX's Cholesky gives; no error check, so no device sync
    on the card."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, math.nan))


def kkt_violation(stationarity, g, lower, upper, y):
    """The infinity norm over the KKT conditions of ``l <= g <= u`` with
    duals ``y``: ``|stationarity|``, the primal violation ``max(0, g - u,
    l - g)`` and the complementarity ``|max(y, 0) (u - g)|``, ``|min(y, 0)
    (g - l)|`` (which also catches wrong-sign duals). Bounds beyond 1e8
    encode "unbounded" rows: their gap counts as 1, so the condition there
    is ``y = 0``."""
    stat = torch.max(torch.abs(stationarity))
    prim = torch.max(torch.clamp(torch.maximum(g - upper, lower - g), min=0.0))
    one = torch.ones_like(g)
    hi_gap = torch.where(upper > 1e8, one, upper - g)
    lo_gap = torch.where(lower < -1e8, one, g - lower)
    comp = torch.maximum(torch.max(torch.abs(torch.clamp(y, min=0.0) * hi_gap)),
                         torch.max(torch.abs(torch.clamp(y, max=0.0) * lo_gap)))
    return torch.maximum(torch.maximum(stat, prim), comp)


def kkt_score(H, G, f, lower, upper, U, y):
    """Scalar KKT score of ``(U, y)`` for ``min 1/2 U'HU + f'U, l <= GU <=
    u`` (``kkt_violation`` with stationarity ``HU + f + G'y``). Zero
    exactly at a KKT point."""
    return kkt_violation(H @ U + f + G.T @ y, G @ U, lower, upper, y)


def active_set_polish(
    H: torch.Tensor,
    G: torch.Tensor,
    f: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    state: AdmmState,
    tol: float = 1e-7,
    passes: int = 3,
    reg: float = 1e-9,
    refine_steps: int = 2,
):
    """Active-set polish of a box-QP iterate (OSQP's polish, fixed shapes).

    The active set comes from the iterate's dual signs and the primal's
    proximity to each bound; the equality-constrained KKT system on it
    keeps all m duals (active rows impose ``(GU)_i = b_i``, inactive rows
    ``nu_i = 0``):

        [ H      G'        ] [U ]   [ -f  ]
        [ D G    diag(1-D) ] [nu] = [ D b ]

    factored once per pass by LU with the regularisation ``+reg`` on the
    primal block and ``-reg`` on the dual block, then ``refine_steps``
    rounds of iterative refinement against the unregularised matrix. The
    active set is re-detected ``passes`` times; the result is whichever of
    the input and the passes has the smallest ``kkt_score`` (a pass
    replaces the best only when strictly better). Returns ``(U, y,
    score)``."""
    n, m = H.shape[0], G.shape[0]
    kw = dict(dtype=f.dtype, device=f.device)
    reg_diag = torch.diag(torch.cat([torch.full((n,), reg, **kw), torch.full((m,), -reg, **kw)]))

    def one_pass(U, y):
        GU = G @ U
        lo_act = (y < -tol) | (GU < lower + tol)
        hi_act = (y > tol) | (GU > upper - tol)
        D = (lo_act | hi_act).to(f.dtype)
        b = torch.where(lo_act, lower, upper)
        K = torch.cat([torch.cat([H, G.T], 1), torch.cat([D[:, None] * G, torch.diag(1.0 - D)], 1)])
        rhs = torch.cat([-f, D * b])
        LU, pivots = torch.linalg.lu_factor(K + reg_diag)
        sol = torch.linalg.lu_solve(LU, pivots, rhs[:, None])[:, 0]
        for _ in range(refine_steps):
            sol = sol + torch.linalg.lu_solve(LU, pivots, (rhs - K @ sol)[:, None])[:, 0]
        return sol[:n], D * sol[n:]

    best_U, best_y = state.primal, state.dual
    best_score = kkt_score(H, G, f, lower, upper, best_U, best_y)
    U, y = best_U, best_y
    for _ in range(passes):
        U, y = one_pass(U, y)
        score = kkt_score(H, G, f, lower, upper, U, y)
        better = score < best_score
        best_U = torch.where(better, U, best_U)
        best_y = torch.where(better, y, best_y)
        best_score = torch.minimum(score, best_score)
    return best_U, best_y, best_score


def ip_box_qp(
    H: torch.Tensor,
    G: torch.Tensor,
    f: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    iterations: int = 60,
    sigma: float = 0.2,
    tau: float = 0.995,
    mu_floor: float | None = None,
) -> AdmmState:
    """Fixed-iteration primal-dual interior-point solve of ``min 1/2 U'HU +
    f'U  s.t.  l <= GU <= u``: the solve-to-convergence tier for QPs whose
    ADMM tail is too slow for ``active_set_polish`` to detect the active
    set (the LTV tracking QP).

    Path-following with slacks ``s1 = GU - l``, ``s2 = u - GU`` (started at
    ``max(., 1)``, their duals at the reciprocals), fixed centering
    ``sigma``, one Cholesky of the (n, n) Newton matrix per iteration and
    the fraction-to-boundary rule ``tau``. Once the barrier parameter falls
    to ``mu_floor`` (default 1e-13 in float64, 1e-6 otherwise) the iterate
    freezes; the frozen branch's step is made finite first, so a singular
    Newton matrix cannot poison it. Returns an ``AdmmState``: the primal,
    ``clip(GU, l, u)`` and the dual ``z2 - z1`` in the ADMM's sign
    convention."""
    n, m = H.shape[0], G.shape[0]
    dtype = f.dtype
    if mu_floor is None:
        mu_floor = 1e-13 if dtype == torch.float64 else 1e-6
    U = torch.zeros(n, dtype=dtype, device=f.device)
    g0 = G @ U
    s1 = torch.clamp(g0 - lower, min=1.0)
    s2 = torch.clamp(upper - g0, min=1.0)
    z1, z2 = 1.0 / s1, 1.0 / s2
    GT = G.T

    def max_step(v, dv):
        neg = dv < 0.0
        ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                            torch.full_like(dv, math.inf))
        return torch.clamp(tau * torch.min(ratio), max=1.0)

    for _ in range(iterations):
        g = G @ U
        mu = (torch.dot(s1, z1) + torch.dot(s2, z2)) / (2.0 * m)
        live = (mu > mu_floor).to(dtype)
        r_d = H @ U + f - GT @ z1 + GT @ z2
        r_p1 = g - s1 - lower
        r_p2 = upper - g - s2
        r_c1 = z1 * s1 - sigma * mu
        r_c2 = z2 * s2 - sigma * mu
        w = z1 / s1 + z2 / s2
        M = H + (GT * w[None, :]) @ G
        rhs = -r_d - GT @ ((r_c1 + z1 * r_p1) / s1) + GT @ ((r_c2 + z2 * r_p2) / s2)
        # a failed factor gives NaN (as JAX's Cholesky does), which the
        # frozen branch's nan_to_num below turns into a zero step
        dU = torch.cholesky_solve(rhs[:, None], cholesky_or_nan(M))[:, 0]
        GdU = G @ dU
        ds1 = GdU + r_p1
        ds2 = -GdU + r_p2
        dz1 = -(r_c1 + z1 * ds1) / s1
        dz2 = -(r_c2 + z2 * ds2) / s2
        alpha_p = live * torch.minimum(max_step(s1, ds1), max_step(s2, ds2))
        alpha_d = live * torch.minimum(max_step(z1, dz1), max_step(z2, dz2))
        U = U + alpha_p * torch.nan_to_num(dU)
        s1 = s1 + alpha_p * torch.nan_to_num(ds1)
        s2 = s2 + alpha_p * torch.nan_to_num(ds2)
        z1 = z1 + alpha_d * torch.nan_to_num(dz1)
        z2 = z2 + alpha_d * torch.nan_to_num(dz2)
    return AdmmState(U, torch.clamp(G @ U, min=lower, max=upper), z2 - z1)


def kkt_residuals(H, G, f, lower, upper, state: AdmmState):
    """``(primal infeasibility, dual residual)`` of an iterate, each an
    infinity norm: ``max(0, GU - u, l - GU)`` and ``HU + f + G'y``."""
    GU = G @ state.primal
    primal = torch.clamp(torch.maximum(GU - upper, lower - GU), min=0.0)
    dual = H @ state.primal + f + G.T @ state.dual
    return torch.max(torch.abs(primal)), torch.max(torch.abs(dual))
