"""The fused GP posterior mean K7 (port of ``ops/rbf_pallas.py``:
``rbf_posterior_mean_pallas``).

``K_*(X_test - x_shift, X_train) @ (sigma^2 alpha y_std) + y_mean`` for
``(m, d)`` queries against ``P`` training points, ``(m, out)`` out. The
kernel is ``csrc/rbf_kernels.cu``: the training points stream through
shared memory in chunks and the ``(m, P)`` cross-kernel matrix is never
written to memory, so there is no limit on ``P`` and no second route (the
TPU kernel's ``P_pad > 4096`` branch was a VMEM limit). Its plain PyTorch
version is ``rbf_posterior_mean_plain`` below. The wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.

``precision`` is accepted for the JAX signature. Every tier computes in
float32 here: the bfloat16 limb tiers were a TPU matrix-unit scheme, and
float32 meets all three of the JAX tiers' bars against ``predict_mean``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

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
