"""The RBF kernels K15 and K7 (port of ``ops/rbf_pallas.py``:
``rbf_kernel_matrix_pallas`` and ``rbf_posterior_mean_pallas``).

K15 ``rbf_kernel_matrix_pallas``: the Gram matrix
``sigma^2 exp(-0.5 max(|z1|^2 + |z2|^2 - 2 z1.z2, 0))``, ``z = x / l``, of
``X1 (n1, d)`` against ``X2 (n2, d)``, scalar or per-feature (ARD) ``l``.
The kernel is ``csrc/rbf_kernels.cu`` (``rbf_gram_kernel``: 64 x 64 output
tiles, both tiles' scaled rows in shared memory, a 4 x 4 micro-tile per
thread, 16-byte stores); its plain version ``rbf_kernel_matrix_plain`` is
``gp.kernels.rbf_kernel`` in float32. The clamp at 0 is kept exactly: the
Gram's positive semi-definiteness rests on it.

K7 ``rbf_posterior_mean_pallas``:
``K_*(X_test - x_shift, X_train) @ (sigma^2 alpha y_std) + y_mean`` for
``(m, d)`` queries against ``P`` training points, ``(m, out)`` out. The
kernel is ``csrc/rbf_kernels.cu``: the training points stream through
shared memory in chunks and the ``(m, P)`` cross-kernel matrix is never
written to memory, so there is no limit on ``P`` and no second route (the
TPU kernel's ``P_pad > 4096`` branch was a VMEM limit). Its plain PyTorch
version is ``rbf_posterior_mean_plain`` below.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.

``precision`` is accepted for the JAX signature. Every tier computes in
float32 here: the bfloat16 limb tiers were a TPU matrix-unit scheme, and
float32 meets all three of the JAX tiers' bars against ``predict_mean``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..gp.kernels import rbf_kernel
from . import _cuda

PRECISIONS = ("default", "high", "highest")
KERNEL_FEATURES, KERNEL_OUTPUTS = 10, 6   # csrc/rbf_kernels.cu kD, kOut


class PosteriorMeanOperands(NamedTuple):
    """A posterior packed for K7 (float32, on the posterior's device). Built
    once per posterior by ``posterior_mean_operands``; a loop that queries
    one posterior every tick passes these instead of the posterior."""

    rec: torch.Tensor      # (P, 4 ceil((d + 1 + out) / 4)) one record per
                           #   training point: [ztr | sq2 | a | zero padding]
    y_mean: torch.Tensor   # (out,)
    ls: torch.Tensor       # (d,)     length scales
    shift: torch.Tensor    # (d,)     query centering (zeros without x_shift)

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
    """Pack a ``gp.exact_gp.GPPosterior`` for K7."""
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
                for name in ("X", "rec", "y_mean", "ls", "shift", "out")]


def rbf_posterior_mean_pallas(posterior, X_test: torch.Tensor,
                              precision: str = "highest") -> torch.Tensor:
    """Fused GP posterior mean (K7): ``X_test (m, d)`` float32 ->
    ``(m, out)``. ``posterior`` is a ``GPPosterior`` or its
    ``PosteriorMeanOperands``. Numerically mirrors
    ``gp.exact_gp.predict_mean`` (``x_shift`` centering and the
    ``normalize_y`` unscaling included); masked training rows at the 1e6
    sentinel of ``fit_residual_gp_masked`` contribute exactly 0.

    The kernel is built for the residual GP's shapes (d=10 features, 6
    outputs); other shapes raise on the card."""
    _check_precision(precision)
    ops = _operands(posterior)
    dev = X_test.device
    P, d, out_dim = ops.rec.shape[0], ops.ls.shape[0], ops.y_mean.shape[0]
    m = X_test.shape[0]
    req = _cuda.require
    req(X_test, "X_test", (m, d), dev)
    req(ops.rec, "rec", (P, (d + out_dim + 4) // 4 * 4), dev)
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
    if ops.rec.data_ptr() % 16:
        raise ValueError("rec must be 16-byte aligned")
    out = torch.empty(m, out_dim, dtype=torch.float32, device=dev)
    if m == 0:
        return out
    tensors = dict(X=X_test, rec=ops.rec, y_mean=ops.y_mean, ls=ops.ls, shift=ops.shift,
                   out=out)
    operands = _MeanOperands(**{k: v.data_ptr() for k, v in tensors.items()})
    fn = _cuda.library("rbf").rbf_posterior_mean_launch
    fn.argtypes = [ctypes.POINTER(_MeanOperands), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(operands), m, P, _cuda.stream_of(X_test))
    _cuda.check(status, "rbf_posterior_mean_pallas")
    _cuda.count_launch("rbf_posterior_mean_pallas")
    return out


# ---------------------------------------------------------------------------
# K15: the blocked RBF Gram matrix
# ---------------------------------------------------------------------------

GRAM_MAX_FEATURES = 16   # csrc/rbf_kernels.cu kGramMaxD


def _gram_operands(X1, length_scale, signal_variance):
    """``(ls (d,), sig (1,))`` float32 on ``X1``'s device."""
    f32 = dict(dtype=torch.float32, device=X1.device)
    d = X1.shape[1]
    ls = torch.as_tensor(length_scale, **f32).expand(d).contiguous()
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
    """``sigma^2 exp(-0.5 ||(x1 - x2)/l||^2)`` as one launch of the blocked
    Gram kernel (K15): ``X1 (n1, d)``, ``X2 (n2, d)`` float32, ``d <= 16``;
    ``length_scale`` a scalar or ``(d,)``, ``signal_variance`` a scalar
    (numbers or tensors). Returns ``(n1, n2)`` float32."""
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
    operands = _GramOperands(*(t.data_ptr() for t in (X1, X2, ls, sig, out)))
    fn = _cuda.library("rbf").rbf_gram_launch
    fn.argtypes = [ctypes.POINTER(_GramOperands), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(operands), n1, n2, d, _cuda.stream_of(X1))
    _cuda.check(status, "rbf_kernel_matrix_pallas")
    _cuda.count_launch("rbf_kernel_matrix_pallas")
    return out
