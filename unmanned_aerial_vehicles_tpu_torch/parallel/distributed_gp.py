"""Full-corpus GP training: a row-sharded Gram matrix and a distributed,
Nystrom-preconditioned conjugate-gradient solve (port of
``parallel/distributed_gp.py``).

The reference's offline trainer caps itself at 10,000 of the corpus's
19,816 samples because a dense Cholesky is O(n^3) in time and O(n^2) in
memory. Here the n training rows are split over the ranks of a mesh
(``parallel.sharding``): each rank owns ``n/D`` rows and builds its
``(n/D, n)`` Gram block once, and ``(K + (noise + alpha) I) alpha = Y_norm``
is solved by preconditioned conjugate gradients whose matvec is the
rank's block times the gathered iterate, and whose inner products are
all-reduced. The preconditioner is the Nystrom/Woodbury approximation from
``m`` anchor rows, ``P^-1 r = (r - C S^-1 C' r) / c`` with ``S = c W + C'C``
(``C = K(X, X_m)``, ``W = K(X_m, X_m)``, ``c`` the diagonal).

Every Gram block (the fit's ``(n/D, n)`` block, the preconditioner's ``C``
and ``W``, prediction's ``(n/D, q)`` block, the LML gradient's block) goes
through ``gram_block``: on the card in float32 the RBF Gram kernel K15
(``ops.rbf_pallas.rbf_kernel_matrix_pallas``), one launch for each tile of
``GRAM_SHIFT_ROWS`` rows, each tile on coordinates shifted to its own
centroid (the product form's float32 rounding otherwise grows with the
inputs' distance from the origin; see ``gram_block``); on the CPU the plain
``gp.kernels.rbf_kernel`` in the tensors' own dtype (float32 reaches it
through K15's wrapper, which runs the plain version for CPU tensors).
``plain_kernels=True`` takes the plain route on the card as well: it is the
twin a kernel fit is held against, and the only route for float64 there.
The padding mask is multiplied in after the block, as the JAX package
does. The solve's products (``K_loc @ v``, the gradient's extra
products) are plain ``torch.matmul`` in full float32 (no TF32).

sklearn semantics are kept: ``normalize_y`` statistics over the real
(unpadded) rows with the population std, White noise plus the ``alpha``
jitter on the diagonal, White noise in the predictive variance.

Inputs ``X``, ``Y`` are the whole corpus on every rank (numpy arrays or
tensors), as the JAX package takes them; a posterior holds only this
rank's rows. Every rank must call each function with the same arguments:
they all-reduce and gather. ``dtype=None`` means ``X``'s own float dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .._device import full_f32_matmul
from ..gp.exact_gp import GPParams, GPPosterior
from ..gp.kernels import rbf_kernel, rbf_kernel_diag
from ..gp.residual_gp import ResidualGPConfig, default_params
from ..ops.rbf_pallas import rbf_kernel_matrix_pallas
from .sharding import Mesh, gather_rows, make_mesh, psum, shard_rows


class ShardedGPPosterior(NamedTuple):
    """Row-sharded CG posterior: this rank's rows of the padded corpus."""

    params: GPParams
    X_train: torch.Tensor      # (n_pad/D, d)  this rank's rows
    mask: torch.Tensor         # (n_pad/D,)    1 = real sample, 0 = padding
    alpha: torch.Tensor        # (n_pad/D, out) K^-1 Y_norm, this rank's rows
    y_mean: torch.Tensor       # (out,)
    y_std: torch.Tensor        # (out,)
    cg_residual: torch.Tensor  # () the largest final CG residual (diagnostic)

    def to_gp_posterior(self, mesh: Mesh | None = None) -> GPPosterior:
        """A mean-only ``GPPosterior`` of every rank's real rows
        (``predict_mean`` and ``build_horizon_residuals`` take it; ``chol``
        is empty, so variances go through ``predict_sharded``). Gathers the
        rows: every rank of ``mesh`` (the mesh of the fit) must call it."""
        mesh = mesh or make_mesh(device=self.X_train.device)
        valid = gather_rows(self.mask, mesh) > 0.5
        empty = torch.zeros((0, 0), dtype=self.X_train.dtype, device=self.X_train.device)
        return GPPosterior(
            params=self.params,
            X_train=gather_rows(self.X_train, mesh)[valid],
            chol=empty,
            alpha=gather_rows(self.alpha, mesh)[valid],
            y_mean=self.y_mean,
            y_std=self.y_std,
            y_train_norm=empty,
        )


GRAM_SHIFT_ROWS = 32   # rows of X1 that share one coordinate shift in gram_block


def _gram(X1, X2, length_scale, signal_variance, plain_kernels):
    if plain_kernels:
        return rbf_kernel(X1, X2, length_scale, signal_variance)
    if X1.dtype == torch.float32:
        return rbf_kernel_matrix_pallas(X1.contiguous(), X2.contiguous(), length_scale,
                                        signal_variance)
    if X1.is_cuda:
        raise ValueError(
            f"the Gram kernel K15 computes in float32, got {X1.dtype} on {X1.device}: "
            "fit in float32, or pass plain_kernels=True for the plain route")
    return rbf_kernel(X1, X2, length_scale, signal_variance)


def gram_block(X1: torch.Tensor, X2: torch.Tensor, length_scale: torch.Tensor,
               signal_variance: torch.Tensor, plain_kernels: bool = False) -> torch.Tensor:
    """The Gram block ``sigma^2 exp(-0.5 ||(x1 - x2)/l||^2)``: K15 for
    float32 (on the card the kernel, on the CPU its plain version), the
    plain ``rbf_kernel`` for float64 on the CPU or with
    ``plain_kernels=True``. float64 on the card without ``plain_kernels``
    raises: the kernel computes in float32.

    Both routes evaluate the squared distance in the product form
    ``|z1|^2 + |z2|^2 - 2 z1.z2``, whose rounding grows with the inputs'
    distance from the origin (about ``eps (|z1|^2 + |z2|^2)``, ~6e-5 on a
    flight corpus at ``l = 0.5`` in float32, which the posterior mean
    amplifies to ~1.5e-3 of ``y_std``). The kernel depends only on
    ``x1 - x2``, so each tile of ``GRAM_SHIFT_ROWS`` rows of ``X1`` is
    computed on coordinates shifted to the tile's centroid: the rounding
    then scales with the tile's spread and the pair's distance. Put the
    time-ordered side (the corpus) first."""
    out = torch.empty(X1.shape[0], X2.shape[0], dtype=X1.dtype, device=X1.device)
    for i in range(0, X1.shape[0], GRAM_SHIFT_ROWS):
        rows = X1[i:i + GRAM_SHIFT_ROWS]
        shift = torch.mean(rows, dim=0)
        out[i:i + GRAM_SHIFT_ROWS] = _gram(rows - shift, X2 - shift, length_scale,
                                           signal_variance, plain_kernels)
    return out


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _dtype(dtype, X: np.ndarray) -> torch.dtype:
    if dtype is not None:
        return dtype
    return torch.float32 if X.dtype == np.float32 else torch.float64


def _pad_rows(a: np.ndarray, n_pad: int) -> np.ndarray:
    out = np.zeros((n_pad,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


class _Corpus(NamedTuple):
    """The padded corpus on the mesh's device (replicated) and this rank's
    rows of it."""

    X: torch.Tensor          # (n_pad, d)
    mask: torch.Tensor       # (n_pad,)
    Yn: torch.Tensor         # (n_pad, out) normalised targets, 0 on padding
    y_mean: torch.Tensor
    y_std: torch.Tensor
    X_anchor: torch.Tensor   # (m, d)
    rows: slice


def _corpus(X, Y, mesh: Mesh, precond_size: int, dtype) -> _Corpus:
    """Pad the rows to a multiple of the world's size, take the anchors
    (strided over the corpus) and the masked ``normalize_y`` statistics."""
    X, Y = _numpy(X), _numpy(Y)
    dtype = _dtype(dtype, X)
    n = X.shape[0]
    n_pad = -(-n // mesh.world_size) * mesh.world_size
    f = dict(dtype=dtype, device=mesh.device)
    Xp = torch.as_tensor(_pad_rows(X, n_pad)).to(**f)
    Yp = torch.as_tensor(_pad_rows(Y, n_pad)).to(**f)
    maskp = torch.as_tensor(_pad_rows(np.ones((n, 1), np.float64), n_pad)[:, 0]).to(**f)
    anchors = np.linspace(0, n - 1, int(min(precond_size, n))).astype(int)
    X_m = torch.as_tensor(X[anchors]).to(**f)
    count = torch.tensor(float(n), **f)
    y_mean = torch.sum(Yp * maskp[:, None], dim=0) / count
    y_var = torch.sum(((Yp - y_mean) ** 2) * maskp[:, None], dim=0) / count
    y_std = torch.sqrt(y_var)
    y_std = torch.where(y_std == 0.0, torch.ones_like(y_std), y_std)
    Yn = ((Yp - y_mean) / y_std) * maskp[:, None]
    return _Corpus(Xp, maskp, Yn, y_mean, y_std, X_m, shard_rows(n_pad, mesh))


def _cg(matvec, precond, b: torch.Tensor, iterations: int, mesh: Mesh):
    """Conjugate gradients on several right-hand sides at once (per-column
    scalars), the inner products all-reduced over the mesh. ``b (n_loc,
    out)``; returns this rank's rows of the solution and the largest
    column's final residual norm.

    The iteration count is fixed (no host synchronisation). A column whose
    ``r'z`` has fallen below the square root of the dtype's smallest normal
    number stops moving: its updates are below the solution's last place,
    and the recursively updated residual would otherwise keep shrinking
    into subnormal numbers, which the CPU computes a hundred times slower."""
    floor = torch.finfo(b.dtype).tiny ** 0.5

    def dot(a, c):
        return psum(torch.sum(a * c, dim=0), mesh)

    def safe(v):
        return torch.where(v == 0.0, torch.ones_like(v), v)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    rz = dot(r, z)
    p = z
    zero = torch.zeros_like(rz)
    for _ in range(iterations):
        live = rz > floor
        Ap = matvec(p)
        a = torch.where(live, rz / safe(dot(p, Ap)), zero)
        x = x + a * p
        r = r - a * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(live, rz_new / safe(rz), zero)
        p = z + beta * p
        rz = rz_new
    res = torch.sqrt(psum(torch.sum(r**2, dim=0), mesh))
    return x, torch.max(res)


def _masked_block(X_loc, X_full, mask_loc, mask_full, ls, sv, plain_kernels):
    """This rank's ``(n/D, n)`` Gram block with the padding rows and
    columns zeroed."""
    K = gram_block(X_loc, X_full, ls, sv, plain_kernels)
    return K.mul_(mask_loc[:, None]).mul_(mask_full[None, :])


def _gram_matvec(K_loc, c, mesh: Mesh):
    def matvec(v_loc):
        return torch.matmul(K_loc, gather_rows(v_loc, mesh)) + c * v_loc

    return matvec


def _nystrom_precond(X_loc, mask_loc, X_anchor, ls, sv, c, mesh: Mesh, plain_kernels):
    """``r -> (r - C S^-1 C' r) / c`` with ``S = c W + C'C`` (m x m,
    replicated), its diagonal raised by a scale-aware jitter: with a small
    noise and many anchors ``S`` is nearly singular, and a float32
    Cholesky would give an indefinite preconditioner."""
    W = gram_block(X_anchor, X_anchor, ls, sv, plain_kernels)
    C_loc = gram_block(X_loc, X_anchor, ls, sv, plain_kernels) * mask_loc[:, None]
    S = c * W + psum(torch.matmul(C_loc.T, C_loc), mesh)
    eps = 1e-10 if S.dtype == torch.float64 else 1e-5
    m = S.shape[0]
    S = S + (eps * torch.trace(S) / m) * torch.eye(m, dtype=S.dtype, device=S.device)
    S_chol = torch.linalg.cholesky(S)

    def precond(r_loc):
        u = torch.cholesky_solve(psum(torch.matmul(C_loc.T, r_loc), mesh), S_chol)
        return (r_loc - torch.matmul(C_loc, u)) / c

    return precond


def _scalars(params: GPParams, config: ResidualGPConfig, dtype, dev):
    f = dict(dtype=dtype, device=dev)
    ls = params.length_scale.detach().to(**f)
    sv = torch.tensor(float(params.signal_variance), **f)
    c = torch.tensor(float(params.noise_variance) + config.alpha, **f)
    return ls, sv, c


def fit_residual_gp_sharded(
    X,
    Y,
    mesh: Mesh | None = None,
    config: ResidualGPConfig = ResidualGPConfig(),
    params: GPParams | None = None,
    cg_iterations: int = 200,
    precond_size: int = 256,
    dtype=None,
    device=None,
    plain_kernels: bool = False,
) -> ShardedGPPosterior:
    """Fit the residual GP on the whole corpus, rows sharded over the mesh:
    ``gp.residual_gp.fit_residual_gp``'s kernel, ``alpha`` jitter and
    target normalisation, with O(n^2 / D) memory a rank and a CG solve in
    place of the Cholesky factorisation. The diagonal is the parameters'
    noise (which the hyperparameter optimisation moves) plus
    ``config.alpha``. ``device`` (default ``cuda``) applies when ``mesh``
    is not given."""
    full_f32_matmul()
    mesh = mesh or make_mesh(device=device)
    if params is None:
        params = default_params(config, device=mesh.device)
    corpus = _corpus(X, Y, mesh, precond_size, dtype)
    ls, sv, c = _scalars(params, config, corpus.X.dtype, mesh.device)
    rows = corpus.rows
    X_loc, mask_loc = corpus.X[rows], corpus.mask[rows]
    K_loc = _masked_block(X_loc, corpus.X, mask_loc, corpus.mask, ls, sv, plain_kernels)
    precond = _nystrom_precond(X_loc, mask_loc, corpus.X_anchor, ls, sv, c, mesh,
                               plain_kernels)
    alpha, residual = _cg(_gram_matvec(K_loc, c, mesh), precond, corpus.Yn[rows],
                          int(cg_iterations), mesh)
    return ShardedGPPosterior(params=params, X_train=X_loc, mask=mask_loc, alpha=alpha,
                              y_mean=corpus.y_mean, y_std=corpus.y_std, cg_residual=residual)


def _queries(posterior: ShardedGPPosterior, X_test) -> torch.Tensor:
    X = X_test if isinstance(X_test, torch.Tensor) else torch.as_tensor(_numpy(X_test))
    return X.to(dtype=posterior.X_train.dtype, device=posterior.X_train.device)


def predict_mean_sharded(posterior: ShardedGPPosterior, X_test, mesh: Mesh | None = None,
                         plain_kernels: bool = False) -> torch.Tensor:
    """Posterior mean at ``X_test (q, d)``: each rank's ``(q, n/D)`` block
    times its rows of ``alpha``, summed over the ranks."""
    full_f32_matmul()
    mesh = mesh or make_mesh(device=posterior.X_train.device)
    p = posterior.params
    Xq = _queries(posterior, X_test)
    ls, sv, _ = _scalars(p, ResidualGPConfig(), Xq.dtype, Xq.device)
    Kq_loc = gram_block(posterior.X_train, Xq, ls, sv, plain_kernels) * posterior.mask[:, None]
    mean_n = psum(torch.matmul(Kq_loc.T, posterior.alpha), mesh)
    return mean_n * posterior.y_std + posterior.y_mean


def predict_sharded(
    posterior: ShardedGPPosterior,
    X_test,
    mesh: Mesh | None = None,
    config: ResidualGPConfig = ResidualGPConfig(),
    cg_iterations: int = 200,
    include_noise_in_variance: bool = True,
    plain_kernels: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance at ``X_test``: the variance by one sharded CG
    solve with the ``q`` query columns as right-hand sides
    (``var = k** - k*' (K + cI)^-1 k*``, White noise in the prior as
    ``exact_gp.predict``)."""
    full_f32_matmul()
    mesh = mesh or make_mesh(device=posterior.X_train.device)
    p = posterior.params
    Xq = _queries(posterior, X_test)
    ls, sv, c = _scalars(p, config, Xq.dtype, Xq.device)
    X_loc, mask_loc = posterior.X_train, posterior.mask
    X_full, mask_full = gather_rows(X_loc, mesh), gather_rows(mask_loc, mesh)
    K_loc = _masked_block(X_loc, X_full, mask_loc, mask_full, ls, sv, plain_kernels)
    Kq_loc = gram_block(X_loc, Xq, ls, sv, plain_kernels) * mask_loc[:, None]
    v_loc, _ = _cg(_gram_matvec(K_loc, c, mesh), lambda r: r / c, Kq_loc,
                   int(cg_iterations), mesh)
    quad = psum(torch.sum(Kq_loc * v_loc, dim=0), mesh)
    mean_n = psum(torch.matmul(Kq_loc.T, posterior.alpha), mesh)
    prior = rbf_kernel_diag(Xq, sv)
    if include_noise_in_variance:
        prior = prior + p.noise_variance.to(prior)
    var_latent = torch.clamp(prior - quad, min=1e-10)
    mean = mean_n * posterior.y_std + posterior.y_mean
    return mean, var_latent[:, None] * posterior.y_std[None, :] ** 2


# ---------------------------------------------------------------------------
# Hyperparameter optimisation on the whole corpus (stochastic-trace LML
# gradients)
# ---------------------------------------------------------------------------
#
# The exact LML gradient needs tr(Khat^-1 dK/dtheta), an O(n^3) log-det
# derivative. Hutchinson probes estimate it,
#
#     tr(Khat^-1 dK) ~= 1/P sum_p (Khat^-1 z_p)' (dK z_p),   z_p Rademacher,
#
# each solve the fit's sharded CG (probes and targets as one multi-RHS
# solve), each dK product from the Gram block already built:
#
#     dKhat/dlog sf2 = K,   dKhat/dlog sn2 = sn2 I,
#     (dK/dlog l_j) M = xj^2 o (K M) + K (xj^2 o M) - 2 xj o (K (xj o M)),
#
# divided by l_j^2 (per dimension for ARD, summed for an isotropic scale).


def _lml_grad_terms(K_loc, X_loc, X_full, mask_loc, noise_var, ls_vec, ard, alpha_loc,
                    Z_loc, V_loc, out_dim, trace_scale, mesh: Mesh):
    """This rank's part of d(LML)/d(log ls, log sf2, log sn2), all-reduced.
    ``alpha (n/D, out)``, probes ``Z (n/D, P)``, ``V = Khat^-1 Z``;
    ``trace_scale`` is 1/P for Rademacher probes, 1 for identity probes;
    ``ls_vec`` the ``(d,)`` length scales; ``ard`` picks per-dimension
    gradients over their sum."""
    mm = torch.matmul
    d = X_loc.shape[1]
    M_loc = torch.cat([alpha_loc, Z_loc], dim=1)
    M_full = gather_rows(M_loc, mesh)
    KM = mm(K_loc, M_full)
    Ka, KZ = KM[:, :out_dim], KM[:, out_dim:]

    quad_sf = psum(torch.sum(alpha_loc * Ka), mesh)
    tr_sf = psum(torch.sum(V_loc * KZ), mesh) * trace_scale
    quad_sn = noise_var * psum(torch.sum(alpha_loc * alpha_loc), mesh)
    tr_sn = noise_var * psum(torch.sum(V_loc * Z_loc), mesh) * trace_scale

    g_ls_dims = []
    for j in range(d):
        xj_loc = X_loc[:, j][:, None]
        xj_full = X_full[:, j][:, None]
        Aj = (xj_loc**2 * KM
              + mm(K_loc, xj_full**2 * M_full)
              - 2.0 * xj_loc * mm(K_loc, xj_full * M_full))
        quad_j = psum(torch.sum(alpha_loc * Aj[:, :out_dim]), mesh)
        tr_j = psum(torch.sum(V_loc * Aj[:, out_dim:]), mesh) * trace_scale
        g_ls_dims.append((0.5 * quad_j - 0.5 * out_dim * tr_j) / ls_vec[j] ** 2)
    g_ls_vec = torch.stack(g_ls_dims)
    g_ls = g_ls_vec if ard else torch.sum(g_ls_vec)
    g_sf = 0.5 * quad_sf - 0.5 * out_dim * tr_sf
    g_sn = 0.5 * quad_sn - 0.5 * out_dim * tr_sn
    return g_ls, g_sf, g_sn


def rademacher_probes(n_rows: int, num_probes: int, generator: torch.Generator,
                      dtype=torch.float64) -> torch.Tensor:
    """``(n_rows, num_probes)`` independent signs, each +1 or -1 with
    probability 1/2, drawn from ``generator`` on its device."""
    bits = torch.randint(0, 2, (n_rows, num_probes), generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(dtype)


def lml_grad_sharded(
    params: GPParams,
    X,
    Y,
    mesh: Mesh | None = None,
    config: ResidualGPConfig = ResidualGPConfig(),
    generator: torch.Generator | None = None,
    num_probes: int = 16,
    cg_iterations: int = 150,
    precond_size: int = 256,
    exact_trace: bool = False,
    dtype=None,
    probes=None,
    device=None,
    plain_kernels: bool = False,
) -> GPParams:
    """d(LML)/d(log length_scale, log signal_var, log noise_var) on the
    whole corpus, rows sharded over the mesh (sklearn ``normalize_y``
    semantics). A scalar length scale gives its gradient; a ``(d,)`` (ARD)
    one gives ``(d,)``.

    The trace term is estimated with ``num_probes`` Rademacher probes
    drawn from ``generator`` (default: a CPU generator seeded 0) over the
    padded rows, or taken from ``probes`` (``(n_pad, P)``: another run's
    draws). ``exact_trace=True`` uses the identity instead (P = n_pad:
    exact, for small corpora)."""
    full_f32_matmul()
    mesh = mesh or make_mesh(device=device)
    corpus = _corpus(X, Y, mesh, precond_size, dtype)
    dtype, dev = corpus.X.dtype, mesh.device
    n_pad, d = corpus.X.shape
    out_dim = corpus.Yn.shape[1]
    noise_var = float(params.noise_variance)
    ls, sv, c = _scalars(params, config, dtype, dev)
    ard = ls.ndim > 0
    ls_vec = ls.expand(d)

    mask = corpus.mask[:, None]
    if exact_trace:
        Z = torch.eye(n_pad, dtype=dtype, device=dev) * mask
        trace_scale = 1.0
    else:
        if probes is None:
            generator = generator or torch.Generator().manual_seed(0)
            probes = rademacher_probes(n_pad, num_probes, generator)
        Z = torch.as_tensor(np.array(probes) if not isinstance(probes, torch.Tensor)
                            else probes).to(dtype=dtype, device=dev)
        if Z.shape[0] != n_pad:
            raise ValueError(f"probes have {Z.shape[0]} rows, the padded corpus {n_pad}")
        Z = Z * mask
        trace_scale = 1.0 / Z.shape[1]
    trace_scale = torch.tensor(trace_scale, dtype=dtype, device=dev)

    rows = corpus.rows
    X_loc, mask_loc, Z_loc = corpus.X[rows], corpus.mask[rows], Z[rows]
    K_loc = _masked_block(X_loc, corpus.X, mask_loc, corpus.mask, ls, sv, plain_kernels)
    precond = _nystrom_precond(X_loc, mask_loc, corpus.X_anchor, ls, sv, c, mesh,
                               plain_kernels)
    sol, _ = _cg(_gram_matvec(K_loc, c, mesh), precond,
                 torch.cat([corpus.Yn[rows], Z_loc], dim=1), int(cg_iterations), mesh)
    g_ls, g_sf, g_sn = _lml_grad_terms(
        K_loc, X_loc, corpus.X, mask_loc, torch.tensor(noise_var, dtype=dtype, device=dev),
        ls_vec, ard, sol[:, :out_dim], Z_loc, sol[:, out_dim:], out_dim, trace_scale, mesh)
    return GPParams(log_length_scale=g_ls, log_signal_variance=g_sf, log_noise_variance=g_sn)


def optimize_hyperparameters_sharded(
    params: GPParams,
    X,
    Y,
    mesh: Mesh | None = None,
    config: ResidualGPConfig = ResidualGPConfig(),
    steps: int = 30,
    learning_rate: float = 0.05,
    num_probes: int = 16,
    cg_iterations: int = 100,
    generator: torch.Generator | None = None,
    probes: Sequence | None = None,
    dtype=None,
    device=None,
    plain_kernels: bool = False,
) -> GPParams:
    """LML ascent on the whole corpus with stochastic-trace gradients:
    ``steps`` Adam steps (``torch.optim.Adam``: betas 0.9, 0.999, eps 1e-8,
    bias-corrected, as ``optax.adam``) on the log-parameters, fresh probes
    each step from ``generator`` (default a CPU generator seeded 0), or
    ``probes[step]`` where given (one ``(n_pad, P)`` set a step)."""
    mesh = mesh or make_mesh(device=device)
    generator = generator or torch.Generator().manual_seed(0)
    leaves = [v.detach().clone().to(mesh.device).requires_grad_(True) for v in params]
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    for step in range(steps):
        g = lml_grad_sharded(
            GPParams(*(v.detach() for v in leaves)), X, Y, mesh=mesh, config=config,
            generator=generator, num_probes=num_probes, cg_iterations=cg_iterations,
            dtype=dtype, probes=None if probes is None else probes[step],
            plain_kernels=plain_kernels)
        for leaf, grad in zip(leaves, g):
            leaf.grad = -grad.detach().to(leaf)   # ascent on the LML
        opt.step()
    return GPParams(*(v.detach() for v in leaves))


# ---------------------------------------------------------------------------
# Per-output GPs on the whole corpus
# ---------------------------------------------------------------------------


class PerDimShardedGP(NamedTuple):
    """Independent single-output sharded posteriors and the input scaler
    (the per-dimension trainer without its 10k cap). The output scaling is
    each posterior's ``normalize_y`` statistics, which equal a standard
    scaler on ``y``."""

    posteriors: tuple          # out_dim x ShardedGPPosterior
    x_mean: torch.Tensor       # (d,)
    x_std: torch.Tensor        # (d,)


def fit_per_dim_gp_sharded(
    X,
    Y,
    mesh: Mesh | None = None,
    params: GPParams | None = None,
    jitter: float = 1e-6,
    optimize: bool = False,
    opt_steps: int = 20,
    cg_iterations: int = 200,
    precond_size: int = 256,
    generator: torch.Generator | None = None,
    dtype=None,
    device=None,
    plain_kernels: bool = False,
) -> PerDimShardedGP:
    """Per-dimension ARD GPs on the whole corpus: one row-sharded CG fit per
    output with its own hyperparameters (optionally LML-optimised,
    ``optimize_hyperparameters_sharded``). ``params``' tensors carry a
    leading output axis (``gp.per_dim.default_per_dim_params``). The inputs
    are standardised with their mean and population std (numpy, in
    ``X``'s dtype)."""
    from ..gp.per_dim import default_per_dim_params

    mesh = mesh or make_mesh(device=device)
    generator = generator or torch.Generator().manual_seed(0)
    X, Y = _numpy(X), _numpy(Y)
    out_dim = Y.shape[1]
    if params is None:
        params = default_per_dim_params(X.shape[1], out_dim, device=mesh.device)
    x_mean = X.mean(axis=0)
    x_std = X.std(axis=0)
    x_std = np.where(x_std == 0.0, 1.0, x_std)
    Xs = (X - x_mean) / x_std
    cfg = ResidualGPConfig(alpha=jitter)
    posts = []
    for i in range(out_dim):
        p_i = GPParams(*(v[i] for v in params))
        if optimize:
            p_i = optimize_hyperparameters_sharded(
                p_i, Xs, Y[:, i:i + 1], mesh=mesh, config=cfg, steps=opt_steps,
                cg_iterations=cg_iterations, generator=generator, dtype=dtype,
                plain_kernels=plain_kernels)
        posts.append(fit_residual_gp_sharded(
            Xs, Y[:, i:i + 1], mesh=mesh, config=cfg, params=p_i,
            cg_iterations=cg_iterations, precond_size=precond_size, dtype=dtype,
            plain_kernels=plain_kernels))
    return PerDimShardedGP(posteriors=tuple(posts),
                           x_mean=torch.as_tensor(x_mean).to(mesh.device),
                           x_std=torch.as_tensor(x_std).to(mesh.device))


def predict_per_dim_sharded(
    model: PerDimShardedGP,
    X_test,
    mesh: Mesh | None = None,
    jitter: float = 1e-6,
    cg_iterations: int = 200,
    plain_kernels: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean (q, out), var (q, out))``: each output's posterior at the
    standardised queries."""
    mesh = mesh or make_mesh(device=model.x_mean.device)
    X = X_test if isinstance(X_test, torch.Tensor) else torch.as_tensor(_numpy(X_test))
    Xq = (X.to(model.x_mean.device) - model.x_mean) / model.x_std
    cfg = ResidualGPConfig(alpha=jitter)
    means, variances = [], []
    for post in model.posteriors:
        m, v = predict_sharded(post, Xq, mesh=mesh, config=cfg, cg_iterations=cg_iterations,
                               plain_kernels=plain_kernels)
        means.append(m[:, 0])
        variances.append(v[:, 0])
    return torch.stack(means, dim=1), torch.stack(variances, dim=1)
