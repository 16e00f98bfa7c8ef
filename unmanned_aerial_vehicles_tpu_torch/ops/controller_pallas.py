"""The condensed-QP controller's operands and the structured batched
controller kernel K8 (port of ``ops/controller_pallas.py``:
``FusedControllerData``, ``build_fused_controller_data``,
``StructuredBatchData``, ``build_structured_batch_data`` and
``gpmpc_controller_structured_batched``).

The kernels consume these matrices in "row form": a per-tick vector ``v``
is contracted as ``v @ A``. Shapes are semantic (no 128-lane padding):
``Nnx = N nx`` stacked states, ``Nnu = N nu`` stacked controls,
``m = Nnu + Nnx`` constraint rows. A constraint-space vector has the layout
``[U-block (Nnu) | X-block (Nnx)]``.

K8 runs one controller tick for B flights in lockstep. Slacks and duals
are split into U-space ``(B, Nnu)`` and X-space ``(B, Nnx)`` planes, so the
identity block of ``G = [I; Su]`` costs nothing:
``G'v = v_U + v_X Su``, ``U = (G'v - f) M^-1``, ``(G U)_X = U Su'``. The
kernel is ``csrc/controller_kernels.cu``; its plain PyTorch version is
``gpmpc_controller_structured_batched_plain`` below. The wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.

The single-tick controller kernel (``gpmpc_controller_fused``, K3) is
queued in ROADMAP.md; the multi-tick kernel (``ops.tick_pallas``) consumes
``FusedControllerData`` today.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from . import _cuda


class FusedControllerData(NamedTuple):
    """Host float32 operands, semantic shapes."""

    SxT: np.ndarray       # (nx, Nnx):   offset = x0 @ SxT (+ w @ SwT)
    SwT: np.ndarray       # (Nnx, Nnx)
    SuTqT: np.ndarray     # (Nnx, Nnu):  f = (offset - ref) @ SuTqT
    SuT: np.ndarray       # (Nnu, Nnx):  X_tail = offset + U @ SuT
    P1: np.ndarray        # (m, m)     = G M^-1 G'
    P0mat: np.ndarray     # (Nnu, m)   = (G M^-1)'   -> p0 = -(f @ P0mat)
    P0matT: np.ndarray    # (m, Nnu)   = G M^-1      -> U recovery
    MinvT: np.ndarray     # (Nnu, Nnu) = M^-1        -> minv_f = f @ MinvT
    u_lo_row: np.ndarray  # (m,) u bounds in the U-block, zeros elsewhere
    u_hi_row: np.ndarray
    x_lo_row: np.ndarray  # (m,) x bounds in the X-block, zeros elsewhere
    x_hi_row: np.ndarray


def build_fused_controller_data(
    Sx, Su, Sw, SuT_q, M_inv, G,
    u_lo, u_hi, x_lo, x_hi,
) -> FusedControllerData:
    """Row-form float32 operands from the (float64) condensed-QP data.

    ``Sx (Nnx, nx)``, ``Su (Nnx, Nnu)``, ``Sw (Nnx, Nnx)``,
    ``SuT_q (Nnu, Nnx)``, ``M_inv (Nnu, Nnu)``, ``G (m, Nnu)``."""
    Nnu = Su.shape[1]
    m = G.shape[0]
    f32 = lambda a: np.ascontiguousarray(np.asarray(a, np.float32))
    GMinv = G @ M_inv

    def row(v, off):
        out = np.zeros(m, np.float32)
        out[off : off + len(v)] = np.asarray(v, np.float32)
        return out

    return FusedControllerData(
        SxT=f32(np.asarray(Sx, np.float32).T),
        SwT=f32(np.asarray(Sw, np.float32).T),
        SuTqT=f32(np.asarray(SuT_q, np.float32).T),
        SuT=f32(np.asarray(Su, np.float32).T),
        P1=f32(GMinv @ G.T),
        P0mat=f32(np.asarray(GMinv, np.float32).T),
        P0matT=f32(GMinv),
        MinvT=f32(M_inv),
        u_lo_row=row(u_lo, 0), u_hi_row=row(u_hi, 0),
        x_lo_row=row(x_lo, Nnu), x_hi_row=row(x_hi, Nnu),
    )


# ---------------------------------------------------------------------------
# K8: structured batched controller (G = [I; Su])
# ---------------------------------------------------------------------------

FLIGHTS_PER_BLOCK = 8      # csrc/controller_kernels.cu kFlights


class StructuredBatchData(NamedTuple):
    """Device float32 operands of K8, semantic shapes. ``horizon/nu/nx``
    record the layout the warm-start shift must follow."""

    SxT: torch.Tensor      # (nx, Nnx):   offset = x0 @ SxT + w @ SwT
    SwT: torch.Tensor      # (Nnx, Nnx)
    SuTqT: torch.Tensor    # (Nnx, Nnu):  f = (offset - ref) @ SuTqT
    SuT: torch.Tensor      # (Nnu, Nnx):  (G U)_X = U @ SuT
    SuRow: torch.Tensor    # (Nnx, Nnu):  (G'v)_U += v_X @ SuRow
    MinvT: torch.Tensor    # (Nnu, Nnu):  U = (G'v - f) @ MinvT
    u_lo: torch.Tensor     # (Nnu,)
    u_hi: torch.Tensor
    x_lo: torch.Tensor     # (Nnx,)
    x_hi: torch.Tensor
    horizon: int
    nu: int
    nx: int


def build_structured_batch_data(
    data: FusedControllerData, N: int, nu: int, nx: int,
    u_lo, u_hi, x_lo, x_hi, device=None,
) -> StructuredBatchData:
    """K8's operands on ``device`` from the row-form controller data and the
    stacked box bounds (``(N nu,)`` and ``(N nx,)``, arrays or tensors)."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    vec = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1).contiguous()
    return StructuredBatchData(
        SxT=t(data.SxT), SwT=t(data.SwT), SuTqT=t(data.SuTqT), SuT=t(data.SuT),
        SuRow=t(np.asarray(data.SuT).T), MinvT=t(data.MinvT),
        u_lo=vec(u_lo), u_hi=vec(u_hi), x_lo=vec(x_lo), x_hi=vec(x_hi),
        horizon=int(N), nu=int(nu), nx=int(nx),
    )


def _shift_plane(v: torch.Tensor, N: int, width: int) -> torch.Tensor:
    """Warm-start shift of a ``(B, N width)`` plane: each stage block moves
    one stage forward, the last stage is repeated."""
    return torch.cat([v[:, width : N * width], v[:, (N - 1) * width :]], dim=1)


def gpmpc_controller_structured_batched_plain(
    sdata: StructuredBatchData, X0, W, REF, ZU, ZX, YU, YX,
    rho: float, iterations: int, over_relax: float = 1.6,
):
    """Plain version of K8: the same operands and outputs in PyTorch tensor
    ops on any device. Returns ``(ZU, ZX, YU, YX, U, X_tail)``."""
    N, nu, nx = sdata.horizon, sdata.nu, sdata.nx
    clip = lambda v, lo, hi: torch.minimum(torch.maximum(v, lo), hi)
    zU, yU = _shift_plane(ZU, N, nu), _shift_plane(YU, N, nu)
    zX, yX = _shift_plane(ZX, N, nx), _shift_plane(YX, N, nx)

    offset = X0 @ sdata.SxT + W @ sdata.SwT
    f = (offset - REF) @ sdata.SuTqT
    loU, hiU = sdata.u_lo, sdata.u_hi
    loX, hiX = sdata.x_lo - offset, sdata.x_hi - offset
    for _ in range(iterations):
        t = (rho * zU - yU) + (rho * zX - yX) @ sdata.SuRow
        U = (t - f) @ sdata.MinvT
        GX = U @ sdata.SuT
        GtU = over_relax * U + (1.0 - over_relax) * zU
        GtX = over_relax * GX + (1.0 - over_relax) * zX
        zU_n = clip(GtU + yU / rho, loU, hiU)
        zX_n = clip(GtX + yX / rho, loX, hiX)
        yU = yU + rho * (GtU - zU_n)
        yX = yX + rho * (GtX - zX_n)
        zU, zX = zU_n, zX_n
    # final primal refresh from the last (z, y)
    t = (rho * zU - yU) + (rho * zX - yX) @ sdata.SuRow
    U = (t - f) @ sdata.MinvT
    return zU, zX, yU, yX, U, offset + U @ sdata.SuT


class _StructuredParams(ctypes.Structure):
    _fields_ = [
        ("batch", ctypes.c_int), ("n", ctypes.c_int), ("nu", ctypes.c_int),
        ("nx", ctypes.c_int), ("iterations", ctypes.c_int),
        ("w_stride", ctypes.c_int), ("ref_stride", ctypes.c_int),
        ("rho", ctypes.c_float), ("over_relax", ctypes.c_float),
        ("one_minus_over_relax", ctypes.c_float),
    ]


_STRUCTURED_OPERANDS = (
    "X0", "W", "REF", "ZU", "ZX", "YU", "YX",
    "SxT", "SwT", "SuTqT", "SuT", "SuRow", "MinvT", "u_lo", "u_hi", "x_lo", "x_hi",
    "zu_out", "zx_out", "yu_out", "yx_out", "u_out", "xtail_out",
)


class _StructuredOperands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _STRUCTURED_OPERANDS]


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def structured_shared_memory_bytes(n: int, nu: int = 4, nx: int = 6) -> int:
    """Dynamic shared memory of one K8 block (csrc/controller_kernels.cu
    layout): SuRow, MinvT and SuT, the U bounds, and per flight six U-space
    and seven X-space vectors plus x0."""
    Nnu, Nnx = n * nu, n * nx
    floats = (2 * Nnx * Nnu + Nnu * Nnu + 2 * _round4(Nnu)
              + FLIGHTS_PER_BLOCK * (6 * _round4(Nnu) + 7 * _round4(Nnx) + _round4(nx)))
    return 4 * floats


def gpmpc_controller_structured_batched(
    sdata: StructuredBatchData,
    X0: torch.Tensor,    # (B, nx)
    W: torch.Tensor,     # (B, Nnx) or (1, Nnx) broadcast
    REF: torch.Tensor,   # (B, Nnx) or (1, Nnx) broadcast
    ZU: torch.Tensor, ZX: torch.Tensor,   # (B, Nnu), (B, Nnx) unshifted slacks
    YU: torch.Tensor, YX: torch.Tensor,   # (B, Nnu), (B, Nnx) unshifted duals
    rho: float,
    iterations: int,
    over_relax: float = 1.6,
    horizon: int | None = None,
    nu: int | None = None,
    nx: int | None = None,
):
    """One structured controller tick for a flight batch (K8). Returns
    ``(ZU, ZX, YU, YX, U, X_tail)``: ``(B, Nnu)`` for the U-space planes and
    U, ``(B, Nnx)`` for the X-space planes and X_tail.

    The warm-start shift follows the layout ``sdata`` recorded; passing
    ``horizon/nu/nx`` is allowed only as a cross-check, and a mismatch
    raises. The kernel computes in float32 with FMAs (the TPU kernel's
    bfloat16 ADMM recursion was a matrix-unit choice)."""
    lay = (int(sdata.horizon), int(sdata.nu), int(sdata.nx))
    asked = (lay[0] if horizon is None else int(horizon),
             lay[1] if nu is None else int(nu),
             lay[2] if nx is None else int(nx))
    if asked != lay:
        raise ValueError(
            f"horizon/nu/nx {asked} disagree with the sdata layout {lay} "
            "recorded by build_structured_batch_data"
        )
    N, nu_, nx_ = lay
    Nnu, Nnx = N * nu_, N * nx_
    dev = ZU.device
    B = ZU.shape[0]
    req = _cuda.require
    for name, t in (("ZU", ZU), ("YU", YU)):
        req(t, name, (B, Nnu), dev)
    for name, t in (("ZX", ZX), ("YX", YX)):
        req(t, name, (B, Nnx), dev)
    rows = lambda t: 1 if t.ndim == 2 and t.shape[0] == 1 else B   # 1: broadcast row
    req(X0, "X0", (B, nx_), dev)
    req(W, "W", (rows(W), Nnx), dev)
    req(REF, "REF", (rows(REF), Nnx), dev)
    req(sdata.SxT, "SxT", (nx_, Nnx), dev)
    req(sdata.SwT, "SwT", (Nnx, Nnx), dev)
    req(sdata.SuTqT, "SuTqT", (Nnx, Nnu), dev)
    req(sdata.SuT, "SuT", (Nnu, Nnx), dev)
    req(sdata.SuRow, "SuRow", (Nnx, Nnu), dev)
    req(sdata.MinvT, "MinvT", (Nnu, Nnu), dev)
    for name in ("u_lo", "u_hi"):
        req(getattr(sdata, name), name, (Nnu,), dev)
    for name in ("x_lo", "x_hi"):
        req(getattr(sdata, name), name, (Nnx,), dev)
    if dev.type == "cpu":
        return gpmpc_controller_structured_batched_plain(
            sdata, X0, W, REF, ZU, ZX, YU, YX, rho, iterations, over_relax)
    if dev.type != "cuda":
        raise ValueError(f"gpmpc_controller_structured_batched runs on cuda or cpu, not {dev}")

    if nu_ % 4 or any(t.data_ptr() % 16 for t in (sdata.SuRow, sdata.SuT, sdata.MinvT)):
        raise ValueError("the kernel copies SuRow, SuT and MinvT in 16-byte rows: nu must be "
                         "a multiple of 4 and the three operands 16-byte aligned")
    smem = structured_shared_memory_bytes(N, nu_, nx_)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"horizon {N}: SuRow, MinvT, SuT and the flight tile need {smem} bytes of "
            f"shared memory, more than one block's {limit}"
        )
    f = lambda v: float(np.float32(v))
    stride = lambda t, width: 0 if t.shape[0] == 1 else width
    params = _StructuredParams(
        batch=B, n=N, nu=nu_, nx=nx_, iterations=int(iterations),
        w_stride=stride(W, Nnx), ref_stride=stride(REF, Nnx),
        rho=f(rho), over_relax=f(over_relax), one_minus_over_relax=f(1.0 - over_relax),
    )
    plane = lambda width: torch.empty(B, width, dtype=torch.float32, device=dev)
    outs = dict(zu_out=plane(Nnu), zx_out=plane(Nnx), yu_out=plane(Nnu), yx_out=plane(Nnx),
                u_out=plane(Nnu), xtail_out=plane(Nnx))
    tensors = dict(
        X0=X0, W=W, REF=REF, ZU=ZU, ZX=ZX, YU=YU, YX=YX,
        SxT=sdata.SxT, SwT=sdata.SwT, SuTqT=sdata.SuTqT, SuT=sdata.SuT, SuRow=sdata.SuRow,
        MinvT=sdata.MinvT, u_lo=sdata.u_lo, u_hi=sdata.u_hi, x_lo=sdata.x_lo,
        x_hi=sdata.x_hi, **outs,
    )
    ops = _StructuredOperands(**{k: v.data_ptr() for k, v in tensors.items()})
    fn = _cuda.library("controller").structured_batched_launch
    fn.argtypes = [ctypes.POINTER(_StructuredParams), ctypes.POINTER(_StructuredOperands),
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(params), ctypes.byref(ops), smem, _cuda.stream_of(ZU))
    _cuda.check(status, "gpmpc_controller_structured_batched")
    _cuda.count_launch("gpmpc_controller_structured_batched")
    return (outs["zu_out"], outs["zx_out"], outs["yu_out"], outs["yx_out"],
            outs["u_out"], outs["xtail_out"])
