"""The RBF kernels K15 and K7 (port of ``ops/rbf_pallas.py``:
``rbf_kernel_matrix_pallas`` and ``rbf_posterior_mean_pallas``).

K15 ``rbf_kernel_matrix_pallas``: the Gram matrix
``sigma^2 exp(-0.5 max(|z1|^2 + |z2|^2 - 2 z1.z2, 0))``, ``z = x / l``, of
``X1 (n1, d)`` against ``X2 (n2, d)``, scalar or per-feature (ARD) ``l``.
The kernel is ``csrc/rbf_kernels.cu`` (``rbf_gram_kernel``: persistent
blocks, three on each SM, each walking an even share of the 64 x 64 output
tiles in row-major order (``gram_geometry``), its X1 rows scaled once, the
next tile's X2 loaded under the current tile's stores; an entry is its dot,
two adds, the clamp and one ``ex2``, with ``-0.5 log2(e)`` folded into the
scaled operands; a 4 x 4 micro-tile per thread, 16-byte streaming stores);
its plain version ``rbf_kernel_matrix_plain`` is ``gp.kernels.rbf_kernel``
in float32. The clamp at 0 is kept exactly: the Gram's positive
semi-definiteness rests on it, and coincident points give exactly
``sigma^2``.

K7 ``rbf_posterior_mean_pallas``:
``K_*(X_test - x_shift, X_train) @ (sigma^2 alpha y_std) + y_mean`` for
``(m, d)`` queries against ``P`` training points, ``(m, out)`` out. The
kernel is ``csrc/rbf_kernels.cu``: both products (the cross term and the
value product) on the tensor cores in 3xTF32, the exp between them in
registers, the training set in shared memory (streamed in chunks past one
block's shared memory), so the ``(m, P)`` cross-kernel matrix is never
written to memory and there is no limit on ``P`` and no second route (the
TPU kernel's ``P_pad > 4096`` branch was a VMEM limit). The training side
is packed once per posterior into the tensor-core operands' fragment order
(``posterior_mean_operands``, ``pack_posterior_tiles``); the layout in
shared memory is ``posterior_mean_layout``. Its plain PyTorch version is
``rbf_posterior_mean_plain`` below.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.

``precision`` is accepted for the JAX signature. Every tier computes to
float32 accuracy here (K7's products in 3xTF32, within ~2e-6 of the
float32 plain version): the bfloat16 limb tiers were a TPU matrix-unit
scheme, and float32 meets all three of the JAX tiers' bars against
``predict_mean``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..gp.kernels import rbf_kernel
from . import _cuda

PRECISIONS = ("default", "high", "highest")
KERNEL_FEATURES, KERNEL_OUTPUTS = 10, 6   # csrc/rbf_kernels.cu kD, kOut

# csrc/rbf_kernels.cu's layout of the training side: 8-point tiles of the
# tensor-core operands, 10 floats a lane (320 a tile), 4 tiles a chunk (one
# bulk copy); the 4 warps of a row split a chunk's tiles, 2 rows of warps
# split the queries; a round is 10 query tiles of 16 (5 a warp).
TILE_POINTS = 8
TILE_FLOATS = 320
CHUNK_TILES = 4
CHUNK_BYTES = 4 * TILE_FLOATS * CHUNK_TILES
QUERY_TILE = 16
ROUND_TILES = 10
WARP_COLUMNS = 4
REDUCE_BYTES = 4 * WARP_COLUMNS * ROUND_TILES * QUERY_TILE * 8
# exp(-0.5 d) = 2^(EXP2_SCALE d): folded into the operands, so the kernel's
# exp is one ex2
EXP2_SCALE = -0.5 * 1.4426950408889634
# sentinel rows give |z_p|^2 up to ~1e13 and more: clamped here so that the
# split's parts stay finite (the kernel value is 0 either way)
OPERAND_LIMIT = 1e34


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (float32) as ``hi + lo``, both TF32 values (10-bit mantissas):
    ``hi`` is ``x`` rounded to nearest, ties away from zero (PTX's
    ``cvt.rna.tf32.f32``), ``lo`` the exact remainder rounded the same way.
    Bit operations on the float32 encoding: adding half a unit of the last
    kept place to the magnitude's bits carries into the exponent where it
    should."""
    def rna(v):
        return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def pack_posterior_tiles(ztr: torch.Tensor, sq2: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The training side of K7 in the tensor cores' fragment order: ``(tiles
    * 320,)`` float32, ``tiles = 4 ceil(P / 32)`` (zero points pad the last
    chunk; they contribute exactly 0, their value rows being 0). For lane
    ``l = 4 g + t`` of 8-point tile ``j`` (points ``8 j .. 8 j + 7``):

    - floats ``[4 l, 4 l + 4)``: the cross product's B fragment of
      ``mma.m16n8k8`` (k = feature, n = point ``8 j + g``), ``w_t`` and
      ``w_{t+4}``, hi then lo, with ``w = -2 EXP2_SCALE z_p``;
    - ``128 + [4 l, 4 l + 4)``: the value product's B fragment (k = point,
      n = output ``g``) with the points permuted so that its k index ``t``
      is point ``2 t`` and ``t + 4`` point ``2 t + 1``: the cross product's
      accumulator columns ``(2 t, 2 t + 1)`` are then the value product's A
      columns ``(t, t + 4)`` in the same lane, and the exp tile goes from
      one to the other in registers. ``a[8 j + 2 t, g]``, ``a[8 j + 2 t + 1,
      g]`` (0 for ``g >= out``), hi then lo;
    - ``256 + [2 l, 2 l + 2)``: the ``mma.m16n8k4`` B fragment of features
      8-11 (``w_8``, ``w_9``, ``EXP2_SCALE |z_p|^2``, 0 for ``t`` = 0..3),
      hi, lo.

    ``ztr (P, 10)``, ``sq2 (P,)``, ``a (P, 6)`` float32: the kernel (and
    its packing) takes only the residual GP's shapes."""
    P, d = ztr.shape
    if (d, a.shape[1]) != (KERNEL_FEATURES, KERNEL_OUTPUTS):
        raise ValueError(
            f"the posterior-mean kernel is built for {KERNEL_FEATURES} features and "
            f"{KERNEL_OUTPUTS} outputs (got {d}, {a.shape[1]})"
        )
    f32 = dict(dtype=torch.float32, device=ztr.device)
    per_chunk = TILE_POINTS * CHUNK_TILES
    Pp = -(-P // per_chunk) * per_chunk
    tiles = Pp // TILE_POINTS
    lim = OPERAND_LIMIT
    # features 0-11 of each point: w (10), EXP2_SCALE |z|^2, 0
    feats = torch.zeros(Pp, 12, **f32)
    feats[:P, :10] = torch.clamp(ztr * (-2.0 * EXP2_SCALE), -lim, lim)
    feats[:P, 10] = torch.clamp(sq2 * EXP2_SCALE, -lim, lim)
    vals = torch.zeros(Pp, 8, **f32)
    vals[:P, : a.shape[1]] = a
    fh, fl = tf32_split(feats)
    vh, vl = tf32_split(vals)
    g = torch.arange(8, device=ztr.device)[:, None]     # lane = 4 g + t
    t = torch.arange(4, device=ztr.device)[None, :]
    pt = (TILE_POINTS * torch.arange(tiles, device=ztr.device))[:, None, None]
    pnt = pt + g                                        # (tiles, 8, 4): point 8 j + g
    cross = torch.stack([fh[pnt, t], fh[pnt, t + 4], fl[pnt, t], fl[pnt, t + 4]], -1)
    v0, v1 = pt + 2 * t, pt + 2 * t + 1                 # value rows 2 t, 2 t + 1
    gg = g.expand(8, 4)
    value = torch.stack([vh[v0, gg], vh[v1, gg], vl[v0, gg], vl[v1, gg]], -1)
    k4 = torch.stack([fh[pnt, 8 + t], fl[pnt, 8 + t]], -1)
    return torch.cat([cross.reshape(tiles, 128), value.reshape(tiles, 128),
                      k4.reshape(tiles, 64)], 1).reshape(-1).contiguous()


def posterior_mean_layout(P: int, smem_limit: int) -> dict:
    """K7's shared memory for ``P`` training points on a card whose blocks
    may opt into ``smem_limit`` bytes: the training set's chunks, the
    stages of the ring they pass through, whether all of them stay resident
    for the launch (``chunks <= stages``; else two halves of the ring are
    refilled in turns, double-buffered), and the bytes (the stages'
    transaction barriers, the reduction of the 4 warp columns' sums, the
    stages)."""
    chunks = -(-P // (TILE_POINTS * CHUNK_TILES))

    def nbytes(stages):
        return -(-8 * stages // 128) * 128 + REDUCE_BYTES + CHUNK_BYTES * stages

    most = 0
    while nbytes(most + 1) <= smem_limit:
        most += 1
    if chunks <= most:
        return dict(chunks=chunks, stages=chunks, resident=True, bytes=nbytes(chunks))
    stages = most - most % 2
    if stages < 2:
        raise ValueError(f"K7 needs {nbytes(2)} bytes of shared memory, more than {smem_limit}")
    return dict(chunks=chunks, stages=stages, resident=False, bytes=nbytes(stages))


class PosteriorMeanOperands(NamedTuple):
    """A posterior packed for K7 (float32, on the posterior's device). Built
    once per posterior by ``posterior_mean_operands``; a loop that queries
    one posterior every tick passes these instead of the posterior."""

    rec: torch.Tensor      # (P, 4 ceil((d + 1 + out) / 4)) one record per
                           #   training point: [ztr | sq2 | a | zero padding]
    y_mean: torch.Tensor   # (out,)
    ls: torch.Tensor       # (d,)     length scales
    shift: torch.Tensor    # (d,)     query centering (zeros without x_shift)
    tiles: torch.Tensor | None   # the kernel's operand (pack_posterior_tiles),
                                 #   packed for a posterior on the card in
                                 #   the kernel's shapes, else None

    @property
    def ztr(self) -> torch.Tensor:
        """(P, d) training inputs / length scales."""
        return self.rec[:, : self.ls.shape[0]]

    @property
    def sq2(self) -> torch.Tensor:
        """(P,) their squared norms."""
        return self.rec[:, self.ls.shape[0]]

    @property
    def a(self) -> torch.Tensor:
        """(P, out) sigma^2 alpha y_std."""
        d = self.ls.shape[0]
        return self.rec[:, d + 1 : d + 1 + self.y_mean.shape[0]]


def posterior_mean_operands(posterior) -> PosteriorMeanOperands:
    """Pack a ``gp.exact_gp.GPPosterior`` for K7 (and, on the CPU, for its
    plain version alone: ``tiles`` is packed only where the kernel runs)."""
    f32 = torch.float32
    p = posterior.params
    d = posterior.X_train.shape[1]
    ls = p.length_scale.to(f32).expand(d).contiguous()
    ztr = posterior.X_train.to(f32) / ls
    shift = (posterior.x_shift.to(f32) if posterior.x_shift is not None
             else torch.zeros(d, dtype=f32, device=ztr.device)).contiguous()
    sig = p.signal_variance.to(f32)
    sq2 = torch.sum(ztr * ztr, dim=1)
    a = sig * posterior.alpha.to(f32) * posterior.y_std.to(f32)
    P, width = ztr.shape[0], d + 1 + a.shape[1]
    pad = torch.zeros(P, (width + 3) // 4 * 4 - width, dtype=f32, device=ztr.device)
    return PosteriorMeanOperands(
        rec=torch.cat([ztr, sq2[:, None], a, pad], dim=1).contiguous(),
        y_mean=posterior.y_mean.to(f32).contiguous(),
        ls=ls,
        shift=shift,
        tiles=(pack_posterior_tiles(ztr, sq2, a)
               if ztr.is_cuda and (d, a.shape[1]) == (KERNEL_FEATURES, KERNEL_OUTPUTS)
               else None),
    )


def _operands(posterior) -> PosteriorMeanOperands:
    if isinstance(posterior, PosteriorMeanOperands):
        return posterior
    return posterior_mean_operands(posterior)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def rbf_posterior_mean_plain(posterior, X_test: torch.Tensor,
                             precision: str = "highest") -> torch.Tensor:
    """Plain version of K7 on any device: ``X_test (m, d)`` -> ``(m, out)``.
    ``posterior`` is a ``GPPosterior`` or its ``PosteriorMeanOperands``."""
    _check_precision(precision)
    ops = _operands(posterior)
    Z = (X_test.to(torch.float32) - ops.shift) / ops.ls
    sq1 = torch.sum(Z * Z, dim=1)
    cross = Z @ ops.ztr.T
    dists = torch.clamp(sq1[:, None] + ops.sq2[None, :] - 2.0 * cross, min=0.0)
    return torch.exp(-0.5 * dists) @ ops.a + ops.y_mean


class _MeanOperands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p)
                for name in ("X", "tiles", "y_mean", "ls", "shift", "out")]


def rbf_posterior_mean_pallas(posterior, X_test: torch.Tensor,
                              precision: str = "highest") -> torch.Tensor:
    """Fused GP posterior mean (K7): ``X_test (m, d)`` float32 ->
    ``(m, out)``. ``posterior`` is a ``GPPosterior`` or its
    ``PosteriorMeanOperands``. Numerically mirrors
    ``gp.exact_gp.predict_mean`` (``x_shift`` centering and the
    ``normalize_y`` unscaling included); masked training rows at the 1e6
    sentinel of ``fit_residual_gp_masked`` contribute exactly 0.

    The kernel is built for the residual GP's shapes (d=10 features, 6
    outputs); other shapes raise on the card. One launch is one wave: a
    block on each SM (``_cuda.sm_count``), each taking an even share of
    the 16-query tiles."""
    _check_precision(precision)
    ops = _operands(posterior)
    dev = X_test.device
    P, d, out_dim = ops.rec.shape[0], ops.ls.shape[0], ops.y_mean.shape[0]
    m = X_test.shape[0]
    req = _cuda.require
    req(X_test, "X_test", (m, d), dev)
    req(ops.y_mean, "y_mean", (out_dim,), dev)
    req(ops.ls, "ls", (d,), dev)
    req(ops.shift, "shift", (d,), dev)
    if dev.type == "cpu":
        return rbf_posterior_mean_plain(ops, X_test, precision)
    if dev.type != "cuda":
        raise ValueError(f"rbf_posterior_mean_pallas runs on cuda or cpu, not {dev}")
    if (d, out_dim) != (KERNEL_FEATURES, KERNEL_OUTPUTS):
        raise ValueError(
            f"the posterior-mean kernel is built for {KERNEL_FEATURES} features and "
            f"{KERNEL_OUTPUTS} outputs (got {d}, {out_dim})"
        )
    if ops.tiles is None:
        raise ValueError("the posterior-mean operands were packed off the card: pack them "
                         "(posterior_mean_operands) from a posterior on the card")
    layout = posterior_mean_layout(P, _cuda.shared_memory_optin(dev))
    req(ops.tiles, "tiles", (layout["chunks"] * CHUNK_TILES * TILE_FLOATS,), dev)
    _cuda.require_aligned("rbf_posterior_mean_pallas", ops.tiles)
    out = torch.empty(m, out_dim, dtype=torch.float32, device=dev)
    if m == 0:
        return out
    tensors = dict(X=X_test, tiles=ops.tiles, y_mean=ops.y_mean, ls=ops.ls, shift=ops.shift,
                   out=out)
    operands = _MeanOperands(**{k: v.data_ptr() for k, v in tensors.items()})
    query_tiles = -(-m // QUERY_TILE)
    grid = min(_cuda.sm_count(dev), query_tiles)
    fn = _cuda.library("rbf").rbf_posterior_mean_launch
    fn.argtypes = [ctypes.POINTER(_MeanOperands)] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(operands), m, layout["chunks"], layout["stages"],
                int(layout["resident"]), grid, layout["bytes"], _cuda.stream_of(X_test))
    _cuda.check(status, "rbf_posterior_mean_pallas")
    _cuda.count_launch("rbf_posterior_mean_pallas")
    return out


POSTERIOR_MEAN_SECTIONS = ("training set wait", "cross product", "exp", "value product",
                           "reduction", "store", "queries", "whole", "copies issued")


def posterior_mean_section_cycles() -> dict[str, float]:
    """Clock cycles of K7 by section since the last call, per block (warp
    0's: the training set's wait, the cross product's MMAs, the clamp, exp
    and split, the value product's MMAs, the reduction of the warp columns'
    sums, the store, the queries' loads and splits, the whole block, and
    thread 0's barrier set-up and first bulk copies), from the
    ``rbf_clocks`` build:
    call inside ``_cuda.library_variant("rbf", "rbf_clocks")`` after the
    launches, synchronised. The first call only resets them. Each launch
    adds its blocks, so the counts are divided by the blocks counted
    (``rbf_posterior_mean_section_cycles`` counts them in the last slot)."""
    raw = _cuda.section_cycles("rbf", "rbf_posterior_mean_section_cycles",
                               POSTERIOR_MEAN_SECTIONS + ("blocks",))
    blocks = max(raw.pop("blocks"), 1)
    return {k: v / blocks for k, v in raw.items()}


# ---------------------------------------------------------------------------
# K15: the RBF Gram matrix
# ---------------------------------------------------------------------------

GRAM_MAX_FEATURES = 16   # csrc/rbf_kernels.cu kGramMaxD
GRAM_TILE = 64           # kGramTile: output rows and columns per tile
GRAM_BLOCKS_PER_SM = 3   # kGramBlocksPerSM


class GramGeometry(NamedTuple):
    """K15's launch: ``tiles_r x tiles_c`` tiles of 64 x 64 in row-major
    order (tile ``t`` is row ``t // tiles_c``, column ``t % tiles_c`` of
    the tiles), ``grid`` persistent blocks, block b walking tiles
    ``[b T // grid, (b + 1) T // grid)`` of the ``T`` tiles."""

    tiles_r: int
    tiles_c: int
    grid: int

    @property
    def tiles(self) -> int:
        return self.tiles_r * self.tiles_c


def gram_geometry(n1: int, n2: int, sms: int) -> GramGeometry:
    """K15's tiles and grid for an ``(n1, n2)`` Gram on a card of ``sms``
    SMs: three blocks an SM, no more blocks than tiles."""
    tiles_r, tiles_c = -(-n1 // GRAM_TILE), -(-n2 // GRAM_TILE)
    return GramGeometry(tiles_r, tiles_c, min(tiles_r * tiles_c, GRAM_BLOCKS_PER_SM * sms))


def _gram_operands(X1, length_scale, signal_variance):
    """``(ls (1,) or (d,), sig (1,))`` float32 on ``X1``'s device (a
    tensor already there in float32 is not copied)."""
    f32 = dict(dtype=torch.float32, device=X1.device)
    d = X1.shape[1]
    ls = torch.as_tensor(length_scale, **f32).reshape(-1).contiguous()
    if ls.numel() not in (1, d):
        raise ValueError(f"length_scale has {ls.numel()} values, expected 1 or {d}")
    sig = torch.as_tensor(signal_variance, **f32).reshape(1).contiguous()
    return ls, sig


def rbf_kernel_matrix_plain(X1: torch.Tensor, X2: torch.Tensor, length_scale,
                            signal_variance) -> torch.Tensor:
    """Plain version of K15: ``gp.kernels.rbf_kernel`` in float32."""
    ls, sig = _gram_operands(X1, length_scale, signal_variance)
    return rbf_kernel(X1.to(torch.float32), X2.to(torch.float32), ls, sig[0])


class _GramOperands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("X1", "X2", "ls", "sig", "out")]


def rbf_kernel_matrix_pallas(X1: torch.Tensor, X2: torch.Tensor, length_scale,
                             signal_variance) -> torch.Tensor:
    """``sigma^2 exp(-0.5 ||(x1 - x2)/l||^2)`` as one launch of the
    persistent Gram kernel (K15): ``X1 (n1, d)``, ``X2 (n2, d)`` float32,
    ``d <= 16``; ``length_scale`` a scalar or ``(d,)``, ``signal_variance``
    a scalar (numbers or tensors). Returns ``(n1, n2)`` float32."""
    dev = X1.device
    n1, d = X1.shape
    n2 = X2.shape[0]
    _cuda.require(X1, "X1", (n1, d), dev)
    _cuda.require(X2, "X2", (n2, d), dev)
    ls, sig = _gram_operands(X1, length_scale, signal_variance)
    if dev.type == "cpu":
        return rbf_kernel_matrix_plain(X1, X2, ls, sig)
    if dev.type != "cuda":
        raise ValueError(f"rbf_kernel_matrix_pallas runs on cuda or cpu, not {dev}")
    if not 1 <= d <= GRAM_MAX_FEATURES:
        raise ValueError(f"the Gram kernel stages up to {GRAM_MAX_FEATURES} features, got {d}")
    out = torch.empty(n1, n2, dtype=torch.float32, device=dev)
    if n1 == 0 or n2 == 0:
        return out
    geometry = gram_geometry(n1, n2, _cuda.sm_count(dev))
    operands = _GramOperands(*(t.data_ptr() for t in (X1, X2, ls, sig, out)))
    fn = _cuda.library("rbf").rbf_gram_launch
    fn.argtypes = [ctypes.POINTER(_GramOperands)] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(operands), n1, n2, d, int(ls.numel() > 1), geometry.grid,
                _cuda.stream_of(X1))
    _cuda.check(status, "rbf_kernel_matrix_pallas")
    _cuda.count_launch("rbf_kernel_matrix_pallas")
    return out
