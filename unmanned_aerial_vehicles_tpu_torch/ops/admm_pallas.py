"""The fused composite-ADMM kernel K6 (port of the composite half of
``ops/admm_pallas.py``: ``admm_box_qp_fused_composite``).

One launch runs the whole fixed-iteration solve of ``ops.qp.
admm_box_qp_composite``: ``iterations`` over-relaxed ADMM steps with one
``(m, m)`` matvec each, then the primal recovery

    GU = p0 + (rho z - y) P1,  Gt = a GU + (1 - a) z,
    z  = clip(Gt + y / rho, lower, upper),  y += rho (Gt - z),
    U  = -M^-1 f + GMinvT (rho z - y).

The kernel is ``csrc/single_tick_kernels.cu`` (``admm_composite_kernel``,
one thread block, P1 in shared memory where it fits and read through L2
beyond). Its plain PyTorch version is ``admm_box_qp_fused_composite_plain``
below: the float32 ``admm_box_qp_composite`` with the TPU kernel's
contractions (the row form ``v @ P1``, GMinvT contracted on its second
axis; a float32 P1 is not exactly symmetric, so ``P1 @ v`` differs). The
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.

Shapes are semantic (the TPU kernel's 128-lane padding is gone): ``P1
(m, m)``, ``GMinvT (n, m)``, ``p0, lower, upper, z0, y0 (m,)``,
``Minv_f (n,)``, all float32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

KERNEL_THREADS = 256   # csrc/single_tick_kernels.cu kThreads


def admm_box_qp_fused_composite_plain(P1, p0, GMinvT, Minv_f, lower, upper, z0, y0,
                                      rho: float, iterations: int, over_relax: float = 1.6):
    """Plain version of K6: ``(U (n,), z (m,), y (m,))``."""
    z, y = z0, y0
    for _ in range(iterations):
        GU = p0 + (rho * z - y) @ P1
        Gt = over_relax * GU + (1.0 - over_relax) * z
        z_new = torch.minimum(torch.maximum(Gt + y / rho, lower), upper)
        y = y + rho * (Gt - z_new)
        z = z_new
    U = -Minv_f + GMinvT @ (rho * z - y)
    return U, z, y


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def shared_memory_bytes(m: int, p1_shared: bool = True) -> int:
    """Dynamic shared memory of one K6 block (csrc/single_tick_kernels.cu
    layout): P1 (shared variant only), the double-buffered matvec input and
    five m-vectors."""
    return 4 * ((_round4(m * m) if p1_shared else 0) + 2 * _round4(m) + 5 * m)


class _AdmmParams(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int), ("m", ctypes.c_int), ("iterations", ctypes.c_int),
        ("rho", ctypes.c_float), ("over_relax", ctypes.c_float),
        ("one_minus_over_relax", ctypes.c_float),
    ]


_ADMM_OPERANDS = ("P1", "p0", "GMinvT", "minvf", "lower", "upper", "z_in", "y_in",
                  "u_out", "z_out", "y_out")


class _AdmmOperands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _ADMM_OPERANDS]


def admm_box_qp_fused_composite(
    P1: torch.Tensor,       # (m, m) = G M^-1 G'
    p0: torch.Tensor,       # (m,)   = -G M^-1 f
    GMinvT: torch.Tensor,   # (n, m) = M^-1 G'
    Minv_f: torch.Tensor,   # (n,)   = M^-1 f
    lower: torch.Tensor,    # (m,)
    upper: torch.Tensor,    # (m,)
    z0: torch.Tensor,       # (m,)
    y0: torch.Tensor,       # (m,)
    rho: float,
    iterations: int,
    over_relax: float = 1.6,
):
    """The whole composite-ADMM solve in one launch (K6). Returns
    ``(U (n,), z (m,), y (m,))`` in float32."""
    dev = P1.device
    m, n = P1.shape[0], GMinvT.shape[0]
    req = _cuda.require
    req(P1, "P1", (m, m), dev)
    req(GMinvT, "GMinvT", (n, m), dev)
    req(Minv_f, "Minv_f", (n,), dev)
    for name, t in (("p0", p0), ("lower", lower), ("upper", upper), ("z0", z0), ("y0", y0)):
        req(t, name, (m,), dev)
    if dev.type == "cpu":
        return admm_box_qp_fused_composite_plain(P1, p0, GMinvT, Minv_f, lower, upper, z0, y0,
                                                 rho, iterations, over_relax)
    if dev.type != "cuda":
        raise ValueError(f"admm_box_qp_fused_composite runs on cuda or cpu, not {dev}")

    _cuda.require_aligned("admm_box_qp_fused_composite", P1)
    p1_shared, smem = _cuda.p1_variant(dev, shared_memory_bytes(m, True),
                                        shared_memory_bytes(m, False))
    params = _AdmmParams(n=n, m=m, iterations=int(iterations), rho=rho, over_relax=over_relax,
                         one_minus_over_relax=1.0 - over_relax)
    U = torch.empty(n, dtype=torch.float32, device=dev)
    z = torch.empty(m, dtype=torch.float32, device=dev)
    y = torch.empty(m, dtype=torch.float32, device=dev)
    ops = _AdmmOperands(*(t.data_ptr() for t in (P1, p0, GMinvT, Minv_f, lower, upper, z0, y0,
                                                 U, z, y)))
    fn = _cuda.library("single_tick").admm_composite_launch
    fn.argtypes = [ctypes.POINTER(_AdmmParams), ctypes.POINTER(_AdmmOperands), ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(params), ctypes.byref(ops), p1_shared, smem, _cuda.stream_of(P1))
    _cuda.check(status, "admm_box_qp_fused_composite")
    _cuda.count_launch("admm_box_qp_fused_composite")
    return U, z, y
