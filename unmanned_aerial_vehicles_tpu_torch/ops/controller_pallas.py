"""The condensed-QP controller's operands, the fused controller kernel K3
and the structured batched controller kernel K8 (port of
``ops/controller_pallas.py``: ``FusedControllerData``,
``build_fused_controller_data``, ``gpmpc_controller_fused``,
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
kernel is ``csrc/controller_kernels.cu`` (``structured_batched_kernel``: a
block of 512 threads per 8 flights, the products on register tiles of 4
outputs x 8 flights with each contraction split over 8 lanes); its plain
PyTorch version is
``gpmpc_controller_structured_batched_plain`` below. The wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.

K3 runs one controller tick of one flight from an already shifted warm
start (K16, ``gpmpc_controller_fused_batched``, runs it for a batch of
flights, the warm-start shift ``z0 = Z0 @ ShiftT`` inside the kernel):

    offset = [x0, w] @ [Sx'; Sw'],  f = (offset - ref) @ (Su'Q)',
    box bounds [u_box; x_box - offset],  p0 = -(f @ P0mat),  M^-1 f,
    ADMM loop (v = rho z - y:  GU = p0 + v @ P1),
    U = -M^-1 f + (rho z - y) @ G M^-1,  X_tail = offset + U @ Su'.

It reads the stacked device operands of ``ops.tick_pallas.FusedTickData``
(the TPU kernel's ``Emb`` matmul is a lane offset here). The kernel is
``csrc/single_tick_kernels.cu`` (``controller_kernel``, one block of 512
threads running ``multitick_phases.cuh:condensed_solve`` as K4 does,
without K4's shift and plant). It applies P1 as its two factors, for
``G = [I; Su]`` (``FusedTickData.factored``):
``v @ P1 = [t | t @ Su']`` with ``t = v @ P0matT``, 64 N^2 multiply-adds a
step against P1's 100 N^2: each thread holds its slices of both factors
in registers for the whole ADMM (to N=25; both read through L2 every step
beyond: ``factor_variant``). Its plain version is
``gpmpc_controller_fused_plain`` below, which multiplies by P1. K16's
kernel is
``csrc/controller_kernels.cu`` (``fused_batched_kernel``: a block per tile
of two flights, their iterates in shared memory, so every P1 element read
serves the whole tile); its plain version is
``gpmpc_controller_fused_batched_plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from . import _cuda
from .admm_pallas import KERNEL_THREADS


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


def factors_reproduce_p1(ctrl: FusedControllerData) -> bool:
    """Whether ``P1 = P0matT @ [I | SuT]`` (to float32 rounding), that is
    ``G = [I; Su]``: the factors K3 applies P1 as."""
    P1 = np.asarray(ctrl.P1, np.float64)
    A, S = np.asarray(ctrl.P0matT, np.float64), np.asarray(ctrl.SuT, np.float64)
    Nnu = A.shape[1]
    if P1.shape != (A.shape[0], Nnu + S.shape[1]) or S.shape[0] != Nnu:
        return False
    factored = np.concatenate([A, A @ S], axis=1)
    return bool(np.abs(factored - P1).max() <= 1e-5 * max(np.abs(P1).max(), 1e-30))


# ---------------------------------------------------------------------------
# K3: the fused single-flight controller (and the launch K4 shares with it)
# ---------------------------------------------------------------------------


def controller_plain(data, x0, w, ref, z, y, rho: float, iterations: int,
                     over_relax: float, tight=None):
    """The condensed controller tick of K3, K4, K5 and K16 in PyTorch tensor
    ops: ``(z, y, U, X_tail)`` from the (already shifted) warm start
    ``z, y``. Vectors may carry a leading flight axis (K16: ``(B, .)``
    rows, all of equal batch). ``tight`` (m,) backs the boxes off (K4's
    tightening row)."""
    Nnu = data.Nnu
    offset = torch.cat([x0, w], dim=-1) @ data.SxSwT
    f = (offset - ref) @ data.SuTqT
    off_z = torch.cat([offset.new_zeros(offset.shape[:-1] + (Nnu,)), offset], dim=-1)
    lower, upper = data.lo_row, data.hi_row
    if tight is not None:
        lower, upper = lower + tight, upper - tight
    lower, upper = lower - off_z, upper - off_z
    m = data.P1.shape[0]
    pm = f @ data.PM
    p0 = -pm[..., :m]
    for _ in range(iterations):
        GU = p0 + (rho * z - y) @ data.P1
        Gt = over_relax * GU + (1.0 - over_relax) * z
        z_new = torch.minimum(torch.maximum(Gt + y / rho, lower), upper)
        y = y + rho * (Gt - z_new)
        z = z_new
    U = -pm[..., m:] + (rho * z - y) @ data.P0matT
    return z, y, U, offset + U @ data.SuT


def gpmpc_controller_fused_plain(data, x0, w, ref, z0, y0, rho: float, iterations: int,
                                 over_relax: float = 1.6):
    """Plain version of K3: ``(z (m,), y (m,), U (Nnu,), X_tail (Nnx,))``."""
    return controller_plain(data, x0, w, ref, z0, y0, rho, iterations, over_relax)


CONTROLLER_THREADS = 512   # csrc/single_tick_kernels.cu kTickThreads: K3's block


def controller_shared_memory_bytes(n: int, nu: int = 4, nx: int = 6,
                                   threads: int = CONTROLLER_THREADS) -> int:
    """Dynamic shared memory of one K3 block of ``threads``
    (csrc/single_tick_kernels.cu ``controller_kernel`` layout; the factors
    stay in registers or device memory): the ADMM input double-buffered and
    t (16-byte aligned), the slack, dual, p0 and the bounds, [x0 | w],
    offset, ref error, f, M^-1 f and U, the matvec slices (``max(threads, m
    + Nnu)``) and the solve's x0 copy (nx)."""
    m, Nnu, Nnx = n * (nu + nx), n * nu, n * nx
    m4 = (m + 3) // 4 * 4
    floats = 2 * m4 + Nnu + 5 * m + nx + 3 * Nnx + 3 * Nnu + max(threads, m + Nnu) + nx
    return 4 * floats


# The factors' variants of K3 and K6 (csrc/single_tick_kernels.cu
# kFactorsL2 ...): each thread's slices of GM^-1 and Su' in registers, of
# at most (36, 20) or (52, 36) rows, or both factors read through L2 every
# step where the slices exceed those bounds
FACTORS_L2, FACTORS_REGS20, FACTORS_REGS25 = 0, 1, 2
FACTOR_SLICE_ROWS = {FACTORS_REGS20: (36, 20), FACTORS_REGS25: (52, 36)}


def aligned_slice_rows(n_in: int, n_out: int, threads: int = CONTROLLER_THREADS) -> int:
    """Rows of each slice of a product in ``aligned_slice``'s decomposition
    (csrc/block_linalg.cuh): ``threads // n_out`` slices of a multiple of 4
    rows."""
    parts = 1 if n_out >= threads else threads // n_out
    return (-(-n_in // parts) + 3) // 4 * 4


def factor_variant(device, n_t: int, m: int, smem_bytes: int,
                   even_rows: bool = False) -> tuple[int, int]:
    """``(variant, shared-memory bytes)`` of K3 or K6 on P1's factors for
    ``n_t`` controls and ``m`` constraint rows: the first register variant
    whose bounds hold each thread's slices (and, ``even_rows``, m is even:
    K6 reads its rows 8 bytes at a time), else the factors through L2.
    Raises if the layout (``smem_bytes``) does not fit one block."""
    limit = _cuda.shared_memory_optin(device)
    if smem_bytes > limit:
        raise ValueError(f"the kernel's vectors need {smem_bytes} bytes of shared memory, more "
                         f"than one block's {limit}")
    rows = (aligned_slice_rows(m, n_t), aligned_slice_rows(n_t, m - n_t))
    for variant, (ka, kb) in FACTOR_SLICE_ROWS.items():
        if rows[0] <= ka and rows[1] <= kb and not (even_rows and m % 2):
            return variant, smem_bytes
    return FACTORS_L2, smem_bytes


# K3's section clocks (the build with section clocks): the library's
# counters it sets (``tick_pallas.SINGLE_TICK_COUNTERS``; the ADMM includes
# the slices' loads, its three phases are summed over its steps)
CONTROLLER_SECTIONS = ("solve: offset", "solve: f", "solve: p0 and M^-1 f", "ADMM",
                       "ADMM: t and the U-block update", "ADMM: t Su'",
                       "ADMM: the X-block update", "solve: U", "solve: X_tail", "whole launch")


def controller_section_cycles() -> dict[str, int]:
    """K3's per-section clock cycles summed over the launches since the
    last call, then reset (``CONTROLLER_SECTIONS``). Counted only by the
    build with section clocks: launch K3 inside ``_cuda.library_variant(
    "single_tick", "single_tick_clocks")``, synchronise, then call this."""
    from .tick_pallas import single_tick_counters

    cycles = single_tick_counters()
    return {name: cycles[name] for name in CONTROLLER_SECTIONS}


class _SingleTickParams(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int), ("m", ctypes.c_int), ("iterations", ctypes.c_int),
        ("substeps", ctypes.c_int), ("use_fallback", ctypes.c_int),
        ("dt", ctypes.c_double),
        ("rho", ctypes.c_float), ("over_relax", ctypes.c_float),
        ("one_minus_over_relax", ctypes.c_float), ("yawrate_limit", ctypes.c_float),
        ("fallback_error_sq", ctypes.c_float), ("fallback_thrust_ceiling", ctypes.c_float),
        ("accel_lo", ctypes.c_float * 3), ("accel_hi", ctypes.c_float * 3),
        ("fallback_lo", ctypes.c_float * 3), ("fallback_hi", ctypes.c_float * 3),
    ]


_SINGLE_TICK_OPERANDS = (
    "SxSwT", "SuTqT", "PM", "P1", "P0matT", "SuT", "lo_row", "hi_row",
    "x0", "w", "ref", "z_in", "y_in", "state", "misc", "tight", "plant_row",
    "z_out", "y_out", "u_out", "xtail_out", "packed",
)


class _SingleTickOperands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _SINGLE_TICK_OPERANDS]


def require_tick_data(data, n: int, device) -> None:
    """Raise unless ``data`` (``ops.tick_pallas.FusedTickData``) holds the
    operands of horizon ``n`` as contiguous float32 tensors on ``device``."""
    Nnu, Nnx = data.Nnu, data.Nnx
    if (Nnu, Nnx) != (4 * n, 6 * n):
        raise ValueError(f"the tick data is laid out for Nnu={Nnu}, Nnx={Nnx}, not horizon {n}")
    m = Nnu + Nnx
    req = _cuda.require
    req(data.P1, "P1", (m, m), device)
    req(data.SxSwT, "SxSwT", (6 + Nnx, Nnx), device)
    req(data.SuTqT, "SuTqT", (Nnx, Nnu), device)
    req(data.PM, "PM", (Nnu, m + Nnu), device)
    req(data.P0matT, "P0matT", (m, Nnu), device)
    req(data.SuT, "SuT", (Nnu, Nnx), device)
    req(data.lo_row, "lo_row", (m,), device)
    req(data.hi_row, "hi_row", (m,), device)


def launch_single_tick(entry: str, counter: str, data, n: int, tensors: dict, outs: dict,
                       rho: float, iterations: int, over_relax: float, dt: float = 0.0,
                       substeps: int = 0, accel_lo=(0.0,) * 3, accel_hi=(0.0,) * 3,
                       yawrate_limit: float = 0.0, fallback_error_m: float = 0.0,
                       fallback_thrust_ceiling: float = 1.5,
                       fallback_accel_scale: float = 1.5,
                       layout=None, variant=None, blocks: int | None = None) -> None:
    """Launch K3 (``entry="gpmpc_controller_launch"``, ``variant`` its
    ``(variant, shared-memory bytes)`` from ``factor_variant``) or K4
    (``"gpmpc_tick_launch"``, with ``layout`` its shared-memory bytes
    ``(n, p1_shared)``: P1 in shared memory where it fits, and ``blocks``
    its flights, one block each) on the operands already checked by the
    caller."""
    dev = data.P1.device
    m = data.P1.shape[0]
    _cuda.require_aligned(counter, data.P1)
    if variant is None:
        p1_shared, smem = _cuda.p1_variant(dev, layout(n, True), layout(n, False))
    else:
        p1_shared, smem = variant
    floats3 = lambda v: (ctypes.c_float * 3)(*v)
    params = _SingleTickParams(
        n=n, m=m, iterations=int(iterations), substeps=int(substeps),
        use_fallback=int(fallback_error_m > 0.0), dt=float(dt),
        rho=rho, over_relax=over_relax, one_minus_over_relax=1.0 - over_relax,
        yawrate_limit=yawrate_limit, fallback_error_sq=fallback_error_m**2,
        fallback_thrust_ceiling=fallback_thrust_ceiling,
        accel_lo=floats3(accel_lo), accel_hi=floats3(accel_hi),
        fallback_lo=floats3(fallback_accel_scale * v for v in accel_lo),
        fallback_hi=floats3(fallback_accel_scale * v for v in accel_hi),
    )
    ptrs = dict(SxSwT=data.SxSwT, SuTqT=data.SuTqT, PM=data.PM, P1=data.P1,
                P0matT=data.P0matT, SuT=data.SuT, lo_row=data.lo_row, hi_row=data.hi_row,
                **tensors, **outs)
    ops = _SingleTickOperands(**{k: v.data_ptr() for k, v in ptrs.items()})
    fn = getattr(_cuda.library("single_tick"), entry)
    grid = () if blocks is None else (blocks,)
    fn.argtypes = [ctypes.POINTER(_SingleTickParams), ctypes.POINTER(_SingleTickOperands),
                   ctypes.c_int, ctypes.c_int, *(ctypes.c_int for _ in grid), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(params), ctypes.byref(ops), p1_shared, smem, *grid,
                _cuda.stream_of(data.P1))
    _cuda.check(status, counter)
    _cuda.count_launch(counter)


def gpmpc_controller_fused(
    data,                 # ops.tick_pallas.FusedTickData
    x0: torch.Tensor,     # (nx,) controller state
    w: torch.Tensor,      # (Nnx,) stacked disturbance dt * D
    ref: torch.Tensor,    # (Nnx,) stacked state reference
    z0: torch.Tensor,     # (m,) shifted warm-start slack
    y0: torch.Tensor,     # (m,) shifted warm-start dual
    rho: float,
    iterations: int,
    over_relax: float = 1.6,
):
    """One fused controller tick (K3). Returns ``(z (m,), y (m,),
    U (Nnu,), X_tail (Nnx,))`` in float32. The kernel applies P1 as its
    factors P0matT and SuT, so ``data`` must come from ``G = [I; Su]``
    (``data.factored``); each thread holds its slices of them in
    registers to N=25, and the kernel reads them through L2 beyond."""
    dev = x0.device
    Nnu, Nnx = data.Nnu, data.Nnx
    n, m = Nnu // 4, Nnu + Nnx
    require_tick_data(data, n, dev)
    req = _cuda.require
    req(x0, "x0", (6,), dev)
    req(w, "w", (Nnx,), dev)
    req(ref, "ref", (Nnx,), dev)
    req(z0, "z0", (m,), dev)
    req(y0, "y0", (m,), dev)
    if dev.type == "cpu":
        return gpmpc_controller_fused_plain(data, x0, w, ref, z0, y0, rho, iterations, over_relax)
    if dev.type != "cuda":
        raise ValueError(f"gpmpc_controller_fused runs on cuda or cpu, not {dev}")
    if not data.factored:
        raise ValueError("gpmpc_controller_fused applies P1 as P0matT @ [I | SuT], which needs "
                         "the tick data of G = [I; Su]")
    empty = lambda k: torch.empty(k, dtype=torch.float32, device=dev)
    outs = dict(z_out=empty(m), y_out=empty(m), u_out=empty(Nnu), xtail_out=empty(Nnx))
    variant = factor_variant(dev, Nnu, m, controller_shared_memory_bytes(n))
    launch_single_tick("gpmpc_controller_launch", "gpmpc_controller_fused", data, n,
                       dict(x0=x0, w=w, ref=ref, z_in=z0, y_in=y0), outs,
                       rho, iterations, over_relax, variant=variant)
    return outs["z_out"], outs["y_out"], outs["u_out"], outs["xtail_out"]


# ---------------------------------------------------------------------------
# K8: structured batched controller (G = [I; Su])
# ---------------------------------------------------------------------------

FLIGHTS_PER_BLOCK = 8      # csrc/controller_kernels.cu kFlights
STRUCTURED_THREADS = 512   # kK8Threads: K8's block


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


def _stride48(n: int) -> int:
    """A row stride of at least ``n`` floats, a multiple of 4 and 4 mod 8
    (csrc/controller_kernels.cu ``stride48``): K8's operator rows, so that
    the two rows a quarter warp reads lie on disjoint banks."""
    r = _round4(n)
    return r if r % 8 else r + 4


def _stride16(n: int) -> int:
    """A row stride of at least ``n`` floats, 16 mod 32
    (csrc/controller_kernels.cu ``stride16``): K8's per-flight rows, so that
    the two flights' rows a quarter warp updates lie on disjoint banks."""
    return 16 if n <= 16 else 16 + -(-(n - 16) // 32) * 32


def structured_shared_memory_bytes(n: int, nu: int = 4, nx: int = 6) -> int:
    """Dynamic shared memory of one K8 block (csrc/controller_kernels.cu
    layout): SuRow (its rows rounded up to 4), MinvT and SuT at
    ``_stride48`` rows; the U bounds and the X bounds, and per flight six
    U-space and five X-space vectors, at ``_stride16`` rows; x0 (8 per
    flight)."""
    Nnu, Nnx = n * nu, n * nx
    lau, lax = _stride48(Nnu), _stride48(Nnx)
    ldu, ldx = _stride16(Nnu), _stride16(Nnx)
    floats = (_round4(Nnx) * lau + Nnu * lau + Nnu * lax + 2 * ldu + 2 * ldx
              + FLIGHTS_PER_BLOCK * (6 * ldu + 5 * ldx + 8))
    return 4 * floats


# K8's sections (csrc/controller_kernels.cu), each summed over the blocks:
# the operators' copy into shared memory, the tile's loads, the set-up's
# offset and f, the ADMM iterations' three phases, the primal refresh with
# X_tail, and the whole launch
STRUCTURED_SECTIONS = ("operator copy", "setup: load", "setup: offset", "setup: f", "ADMM: t",
                       "ADMM: U", "ADMM: G_X", "refresh", "whole launch")


def structured_section_cycles() -> dict[str, int]:
    """K8's per-section clock cycles summed over the blocks of the launches
    since the last call, then reset (``STRUCTURED_SECTIONS``). Counted only
    by the build with section clocks: launch K8 inside
    ``_cuda.library_variant("controller", "controller_clocks")``,
    synchronise, then call this."""
    return _cuda.section_cycles("controller_clocks", "structured_section_cycles",
                                STRUCTURED_SECTIONS)


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

    if nu_ % 4 or nx_ > 8 or any(t.data_ptr() % 16 for t in (
            sdata.SuRow, sdata.SuT, sdata.MinvT, sdata.SxT, sdata.SwT, sdata.SuTqT)):
        raise ValueError("the kernel copies SuRow, MinvT and SuT in 16-byte rows and reads "
                         "SxT, SwT and SuTqT 16 bytes at a time: nu must be a multiple of 4, nx "
                         "at most 8 and the six operands 16-byte aligned")
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


# ---------------------------------------------------------------------------
# K16: the fused controller for a batch of flights
# ---------------------------------------------------------------------------

# csrc/controller_kernels.cu: a thread-block cluster of up to
# FUSED_CLUSTER_BLOCKS blocks owns a tile of FUSED_TILE_FLIGHTS flights;
# each block owns a column slice of at most FUSED_MAX_SLICE columns
FUSED_CLUSTER_BLOCKS = 8
FUSED_TILE_FLIGHTS = 16
FUSED_MAX_SLICE = 64
_FUSED_PART_ROW = 20   # kPartRow


def gpmpc_controller_fused_batched_plain(data, ShiftT, X0, W, REF, Z0, Y0, rho: float,
                                         iterations: int, over_relax: float = 1.6):
    """Plain version of K16: K3's ``controller_plain`` on every flight's
    row after the warm-start shift ``Z0 @ ShiftT``, ``Y0 @ ShiftT``.
    ``W`` and ``REF`` may be one ``(1, Nnx)`` row shared by every flight."""
    B = X0.shape[0]
    return controller_plain(data, X0, W.expand(B, -1), REF.expand(B, -1), Z0 @ ShiftT,
                            Y0 @ ShiftT, rho, iterations, over_relax)


def fused_column_slices(width: int, cluster: int = FUSED_CLUSTER_BLOCKS) -> list[tuple[int, int]]:
    """The column slices of a K16 cluster's blocks: block ``r`` owns
    ``[r width // cluster, (r + 1) width // cluster)`` of an m-, Nnu- or
    Nnx-wide product (csrc/controller_kernels.cu part_begin)."""
    return [(r * width // cluster, (r + 1) * width // cluster) for r in range(cluster)]


def fused_flight_tiles(batch: int) -> list[tuple[int, int]]:
    """The flight tiles of K16's clusters: ``FUSED_TILE_FLIGHTS`` flights
    each, the last one cut at the batch (the kernel masks its tail)."""
    F = FUSED_TILE_FLIGHTS
    return [(b, min(b + F, batch)) for b in range(0, batch, F)]


def fused_slice_pad(n: int, cluster: int) -> int:
    """The widest column slice of a K16 block at horizon ``n`` with
    ``cluster`` blocks, rounded up to 4 (the kernel's tiles)."""
    return 4 * -(-(-(-10 * n // cluster)) // 4)


def fused_batched_shared_memory_bytes(n: int, cluster: int = FUSED_CLUSTER_BLOCKS, nu: int = 4,
                                      nx: int = 6) -> int:
    """Dynamic shared memory of one K16 block (csrc/controller_kernels.cu
    layout): two transaction barriers (16 bytes), the block's column slice
    of P1 (m x the slice rounded up to 4), the tile's double-buffered matvec
    input (m x 16), 256 partial columns of 20, and [x0 | w], the offset, f
    (then U) and the block's M^-1 f, each 16 flights wide."""
    m, Nnu, Nnx = n * (nu + nx), n * nu, n * nx
    F = FUSED_TILE_FLIGHTS
    floats = (4 + m * fused_slice_pad(n, cluster) + 2 * m * F + KERNEL_THREADS * _FUSED_PART_ROW
              + F * ((nx + Nnx) + Nnx + Nnu + -(-Nnu // cluster)))
    return 4 * floats


@functools.lru_cache(maxsize=64)
def fused_cluster_choice(device, batch: int, n: int) -> tuple[int, int, int]:
    """``(cluster, shared-memory bytes, clusters the card runs at once)`` for
    a K16 launch: the largest cluster of 8 down to 1 blocks whose slice
    fits (at most FUSED_MAX_SLICE columns, one block's shared memory) and
    whose clusters for ``batch`` flights all run at once on ``device``
    (``cudaOccupancyMaxActiveClusters``); failing that, the largest that
    fits. Every block asks for at least half of an SM's shared memory, so
    that no SM runs two blocks: a cluster's blocks meet at a barrier every
    ADMM iteration, and one slow block holds back all of them. Cached per
    argument set (the card does not change)."""
    limit = _cuda.shared_memory_optin(device)
    tiles = len(fused_flight_tiles(batch))
    fitting = []
    for cluster in range(FUSED_CLUSTER_BLOCKS, 0, -1):
        smem = max(fused_batched_shared_memory_bytes(n, cluster), limit // 2 + 16)
        if fused_slice_pad(n, cluster) <= FUSED_MAX_SLICE and smem <= limit:
            active = fused_max_active_clusters(cluster, smem)
            if active >= tiles:
                return cluster, smem, active
            fitting.append((cluster, smem, active))
    if not fitting:
        raise ValueError(f"horizon {n}: no K16 cluster of {FUSED_CLUSTER_BLOCKS} or fewer "
                         f"blocks holds P1 in slices of at most {FUSED_MAX_SLICE} columns")
    return fitting[0]


def fused_max_active_clusters(cluster: int, smem: int) -> int:
    """How many K16 clusters of ``cluster`` blocks with ``smem`` bytes each
    the current card runs at once."""
    fn = _cuda.library("controller").fused_batched_max_active_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    count = ctypes.c_int(0)
    _cuda.check(fn(cluster, smem, ctypes.byref(count)), "fused_batched_max_active_clusters")
    return count.value


class _FusedBatchedParams(ctypes.Structure):
    _fields_ = [
        ("batch", ctypes.c_int), ("n", ctypes.c_int), ("m", ctypes.c_int),
        ("iterations", ctypes.c_int), ("w_stride", ctypes.c_int), ("ref_stride", ctypes.c_int),
        ("rho", ctypes.c_float), ("over_relax", ctypes.c_float),
        ("one_minus_over_relax", ctypes.c_float),
    ]


_FUSED_BATCHED_OPERANDS = (
    "ShiftT", "SxSwT", "SuTqT", "PM", "P1", "P0matT", "SuT", "lo_row", "hi_row",
    "X0", "W", "REF", "Z0", "Y0", "z_out", "y_out", "u_out", "xtail_out",
)


class _FusedBatchedOperands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _FUSED_BATCHED_OPERANDS]


def gpmpc_controller_fused_batched(
    data,                   # ops.tick_pallas.FusedTickData
    ShiftT: torch.Tensor,   # (m, m) warm-start shift, row form
    X0: torch.Tensor,       # (B, nx) controller states
    W: torch.Tensor,        # (B, Nnx) or (1, Nnx) stacked dt * D disturbances
    REF: torch.Tensor,      # (B, Nnx) or (1, Nnx) stacked state references
    Z0: torch.Tensor,       # (B, m) unshifted previous slacks
    Y0: torch.Tensor,       # (B, m) unshifted previous duals
    rho: float,
    iterations: int,
    over_relax: float = 1.6,
):
    """The whole-controller tick for a batch of flights (K16): the
    warm-start shift ``Z0 @ ShiftT``, ``Y0 @ ShiftT`` (any shift), then K3's
    offset, gradient, bounds, composite-ADMM loop, primal and predicted tail
    for every flight. Returns ``(Z (B, m), Y (B, m), U (B, Nnu),
    X_tail (B, Nnx))`` in float32. Any B (the TPU kernel's multiple of 128
    is gone); a one-row ``W`` or ``REF`` is shared by every flight. A
    thread-block cluster per 16 flights keeps P1 split over its blocks'
    shared memory (``fused_cluster_choice`` picks its size)."""
    dev = X0.device
    Nnu, Nnx = data.Nnu, data.Nnx
    n, m = Nnu // 4, Nnu + Nnx
    B = X0.shape[0]
    require_tick_data(data, n, dev)
    req = _cuda.require
    rows = lambda t: 1 if t.ndim == 2 and t.shape[0] == 1 else B   # 1: a shared row
    req(ShiftT, "ShiftT", (m, m), dev)
    req(X0, "X0", (B, 6), dev)
    req(W, "W", (rows(W), Nnx), dev)
    req(REF, "REF", (rows(REF), Nnx), dev)
    req(Z0, "Z0", (B, m), dev)
    req(Y0, "Y0", (B, m), dev)
    if dev.type == "cpu":
        return gpmpc_controller_fused_batched_plain(data, ShiftT, X0, W, REF, Z0, Y0, rho,
                                                    iterations, over_relax)
    if dev.type != "cuda":
        raise ValueError(f"gpmpc_controller_fused_batched runs on cuda or cpu, not {dev}")
    stride = lambda t: 0 if t.shape[0] == 1 else Nnx
    params = _FusedBatchedParams(
        batch=B, n=n, m=m, iterations=int(iterations), w_stride=stride(W),
        ref_stride=stride(REF), rho=rho, over_relax=over_relax,
        one_minus_over_relax=1.0 - over_relax,
    )
    plane = lambda width: torch.empty(B, width, dtype=torch.float32, device=dev)
    outs = dict(z_out=plane(m), y_out=plane(m), u_out=plane(Nnu), xtail_out=plane(Nnx))
    tensors = dict(ShiftT=ShiftT, SxSwT=data.SxSwT, SuTqT=data.SuTqT, PM=data.PM, P1=data.P1,
                   P0matT=data.P0matT, SuT=data.SuT, lo_row=data.lo_row, hi_row=data.hi_row,
                   X0=X0, W=W, REF=REF, Z0=Z0, Y0=Y0, **outs)
    if B == 0:
        return outs["z_out"], outs["y_out"], outs["u_out"], outs["xtail_out"]
    cluster, smem, _ = fused_cluster_choice(dev, B, n)
    ops = _FusedBatchedOperands(**{k: v.data_ptr() for k, v in tensors.items()})
    fn = _cuda.library("controller").fused_batched_launch
    fn.argtypes = [ctypes.POINTER(_FusedBatchedParams), ctypes.POINTER(_FusedBatchedOperands),
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(params), ctypes.byref(ops), cluster, smem, _cuda.stream_of(X0))
    _cuda.check(status, "gpmpc_controller_fused_batched")
    _cuda.count_launch("gpmpc_controller_fused_batched")
    return outs["z_out"], outs["y_out"], outs["u_out"], outs["xtail_out"]
