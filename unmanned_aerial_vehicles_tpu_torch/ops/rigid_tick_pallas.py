"""The multi-tick kernel K11 of the 12-state SQP family (port of
``ops/rigid_tick_pallas.py``).

``direct_rate_multitick_kernel`` runs K whole ticks of the multi-tick tier
(``loop.rigid_loop.direct_rate_multitick_fused``) in one launch of
``csrc/rigid_tick_kernel.cu``: per tick the blockwise warm-start shift in
the dispatch's equilibrated space (times ``ce`` / ``ice``), the condensed
gradient and bounds from ``offset = Sx x + Sc``, the composite ADMM,
``u0 = z[:nu] ie`` and the plant substeps (the direct-rate model's Euler
steps, or RK4 of the torque-input rigid body with ``plant="rigid"``). The
kernel applies the ADMM operator ``P1 = Gs @ GMinvT_s`` as its two factors,
held in shared memory (``factor_placement``); its plain version,
``direct_rate_multitick_plain``, is the JAX kernel's algebra in PyTorch (in
the operands' dtype) and multiplies by ``P1``. The wrapper takes it only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.

Operands are semantic (the TPU kernel's 128-lane padding, its homogeneous
``x_row`` lane and its lane rolls are gone): ``RigidTickOperands`` below,
``m = N (nu + nx)``. The kernel computes in float32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..models.params import RigidBodyParams
from . import _cuda
from .qp import roll_block
from .rigid_plant_pallas import make_plant_math, rigid_body_struct, _RigidBody, _RK4Step

OUT_LANES = 16         # per tick: pre-plant state (12), u0 (4)


class RigidTickOperands(NamedTuple):
    """One dispatch's relinearised operands, equilibrated space."""

    Sx: torch.Tensor         # (N nx, 12)
    Sc: torch.Tensor         # (N nx,)
    SuT_q: torch.Tensor      # (N nu, N nx)  Su' diag(q)
    f0: torch.Tensor         # (N nu,)       -rbar * u_ref
    GMinvT_s: torch.Tensor   # (N nu, m)     M^-1 Gs'
    Gs: torch.Tensor         # (m, N nu)     diag(e) [I; Su] diag(d)
    P1: torch.Tensor | None  # (m, m)        Gs M^-1 Gs' = Gs @ GMinvT_s: the plain
                             #               version's; the kernel reads none
    d: torch.Tensor          # (N nu,)       Ruiz column scaling
    e: torch.Tensor          # (m,)          Ruiz row scaling
    ie: torch.Tensor         # (m,)          1 / e
    ce: torch.Tensor         # (m,)          e / blockroll(e)
    ice: torch.Tensor        # (m,)          blockroll(e) / e
    lo: torch.Tensor         # (m,)          [u_lo | x_lo], unscaled
    hi: torch.Tensor         # (m,)


def _direct_rate_substep(h: float, gravity: float, taus):
    tau0, tau1, tau2 = (float(t) for t in taus)
    g = float(gravity)

    def sub(s, u):
        a = u[3] * g
        sr, cr = torch.sin(s[6]), torch.cos(s[6])
        sp, cp = torch.sin(s[7]), torch.cos(s[7])
        sy, cy = torch.sin(s[8]), torch.cos(s[8])
        tp = sp / cp
        deriv = (
            s[3], s[4], s[5],
            a * (sr * sy + cr * cy * sp),
            a * (-sr * cy + cr * sy * sp),
            a * cr * cp - g,
            s[9] + s[10] * sr * tp + s[11] * cr * tp,
            s[10] * cr - s[11] * sr,
            s[10] * sr / cp + s[11] * cr / cp,
            (u[0] - s[9]) / tau0,
            (u[1] - s[10]) / tau1,
            (u[2] - s[11]) / tau2,
        )
        return tuple(s[i] + h * deriv[i] for i in range(12))

    return sub


def plant_substep(plant: str, dt: float, substeps: int, gravity: float, taus,
                  body: RigidBodyParams | None):
    """``sub(s, u)`` on 12-tuples: one Euler substep of the direct-rate model
    (zero residual, the JAX kernel's sin/cos form of tan) or one RK4 substep
    of the rigid body (``make_plant_math``)."""
    h = float(dt) / substeps
    if plant == "rigid":
        return make_plant_math(h, body)[1]
    return _direct_rate_substep(h, gravity, taus)


def direct_rate_multitick_plain(x, z0, y0, refs, ops: RigidTickOperands, *, k_ticks: int, n: int,
                                nu: int, nx: int, iterations: int, over_relax: float, rho: float,
                                dt: float, substeps: int, gravity: float = 9.81,
                                taus=(0.05, 0.05, 0.08), plant: str = "direct_rate",
                                body: RigidBodyParams | None = None):
    """Plain version of K11: ``(out (K, 16), x (12,), z (m,), y (m,))``,
    ``out`` holding each tick's pre-plant state and u0; z and y stay in the
    equilibrated space."""
    if ops.P1 is None:
        raise ValueError("direct_rate_multitick_plain multiplies by ops.P1, which is None")
    sub = plant_substep(plant, dt, substeps, gravity, taus, body)
    Nnu = n * nu
    shift = lambda v: torch.cat([roll_block(v[:Nnu], n), roll_block(v[Nnu:], n)])
    z, y = z0, y0
    rows = []
    for t in range(k_ticks):
        z = shift(z) * ops.ce
        y = shift(y) * ops.ice
        offset = ops.Sx @ x + ops.Sc
        fs = (ops.SuT_q @ (offset - refs[t]) + ops.f0) * ops.d
        p0 = -(fs @ ops.GMinvT_s)
        off_z = torch.cat([torch.zeros_like(fs), offset])
        lower = (ops.lo - off_z) * ops.e
        upper = (ops.hi - off_z) * ops.e
        for _ in range(iterations):
            GU = p0 + (rho * z - y) @ ops.P1
            Gt = over_relax * GU + (1.0 - over_relax) * z
            z_new = torch.minimum(torch.maximum(Gt + y / rho, lower), upper)
            y = y + rho * (Gt - z_new)
            z = z_new
        u0 = z[:nu] * ops.ie[:nu]
        rows.append(torch.cat([x, u0]))
        s = tuple(x[i] for i in range(12))
        uu = tuple(u0[j] for j in range(nu))
        for _ in range(substeps):
            s = sub(s, uu)
        x = torch.stack(s)
    return torch.stack(rows), x, z, y


KERNEL_THREADS = 640   # csrc/rigid_tick_kernel.cu kThreads


def shared_memory_bytes(N: int, nu: int = 4, nx: int = 12, factors_shared: bool = True) -> int:
    """Dynamic shared memory of one K11 block (csrc/rigid_tick_kernel.cu
    layout): the factors (shared variant: Gs's lower rows transposed with a
    row stride of N nx + 4, GMinvT_s and Gs's diagonal) or the first
    product's partial sums (L2 variant), then v, w, fs, ten m-vectors, three
    (N nx)-vectors and the state."""
    m, Nnu, Nnx = N * (nu + nx), N * nu, N * nx
    factors = Nnu * (Nnx + 4) + Nnu * m + Nnu if factors_shared else max(KERNEL_THREADS, Nnu)
    return 4 * (factors + m + 2 * Nnu + 10 * m + 3 * Nnx + 12)


class _RigidTickParams(ctypes.Structure):
    _fields_ = [
        ("k_ticks", ctypes.c_int), ("n", ctypes.c_int), ("m", ctypes.c_int),
        ("iterations", ctypes.c_int), ("substeps", ctypes.c_int), ("rigid_plant", ctypes.c_int),
        ("rho", ctypes.c_float), ("over_relax", ctypes.c_float),
        ("one_minus_over_relax", ctypes.c_float), ("step", _RK4Step),
        ("gravity", ctypes.c_float), ("tau0", ctypes.c_float), ("tau1", ctypes.c_float),
        ("tau2", ctypes.c_float), ("body", _RigidBody),
    ]


_OPERANDS = ("x_in", "z_in", "y_in", "refs", "Sx", "Sc", "SuT_q", "f0", "GMinvT_s", "Gs", "d", "e",
             "ie", "ce", "ice", "lo", "hi", "out", "x_out", "z_out", "y_out")


class _RigidTickOperands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _OPERANDS]


def factor_placement(device, N: int, nu: int = 4, nx: int = 12) -> tuple[int, int]:
    """``(factors_shared, bytes)`` K11 launches with on ``device``: the
    factors in shared memory where that layout fits one block (N <= 21 on an
    H100; its first product also needs N nx <= 256), read through L2
    otherwise; raise if neither fits."""
    limit = _cuda.shared_memory_optin(device)
    shared, streamed = (shared_memory_bytes(N, nu, nx, flag) for flag in (True, False))
    if shared <= limit and N * nx <= 256:
        return 1, shared
    if streamed <= limit:
        return 0, streamed
    raise ValueError(f"K11's vectors need {streamed} bytes of shared memory, more than one "
                     f"block's {limit}")


def direct_rate_multitick_kernel(x, z0, y0, refs, ops: RigidTickOperands, *, k_ticks: int,
                                 n: int, nu: int, nx: int, iterations: int, over_relax: float,
                                 rho: float, dt: float, substeps: int, gravity: float = 9.81,
                                 taus=(0.05, 0.05, 0.08), plant: str = "direct_rate",
                                 body: RigidBodyParams | None = None):
    """K ticks (shift + condensed ADMM + plant) in one launch (K11), in
    float32. ``x (12,)``, ``z0, y0 (m,)`` equilibrated, ``refs (K, N nx)``.
    Returns ``(out (K, 16), x (12,), z (m,), y (m,))``.

    The kernel multiplies by ``P1`` as ``(v @ ops.Gs) @ ops.GMinvT_s`` and
    reads only ``Gs``'s diagonal in its top ``N nu`` rows: the operands must
    hold ``P1 = Gs @ GMinvT_s`` with ``Gs = diag(e) [I; Su] diag(d)``, as
    ``loop.rigid_loop.dispatch_tick_operands`` builds them. On CUDA tensors
    ``ops.P1`` is not read and may be ``None``; the plain version, which
    CPU tensors take, multiplies by it."""
    if plant not in ("direct_rate", "rigid"):
        raise ValueError(f"unknown in-kernel plant: {plant!r}")
    if plant == "rigid" and body is None:
        raise ValueError('plant="rigid" requires body=RigidBodyParams')
    if (nu, nx) != (4, 12):
        raise ValueError(f"K11 is built for nu=4, nx=12, not nu={nu}, nx={nx}")
    dev = x.device
    N, m = n, n * (nu + nx)
    Nnu, Nnx = N * nu, N * nx
    req = _cuda.require
    req(x, "x", (12,), dev)
    req(z0, "z0", (m,), dev)
    req(y0, "y0", (m,), dev)
    req(refs, "refs", (k_ticks, Nnx), dev)
    shapes = dict(Sx=(Nnx, 12), Sc=(Nnx,), SuT_q=(Nnu, Nnx), f0=(Nnu,), GMinvT_s=(Nnu, m),
                  Gs=(m, Nnu), P1=(m, m), d=(Nnu,))
    for name, t in ops._asdict().items():
        if name != "P1" or dev.type == "cpu":
            req(t, name, shapes.get(name, (m,)), dev)
    statics = dict(k_ticks=k_ticks, n=n, nu=nu, nx=nx, iterations=iterations,
                   over_relax=over_relax, rho=rho, dt=dt, substeps=substeps, gravity=gravity,
                   taus=taus, plant=plant, body=body)
    if dev.type == "cpu":
        return direct_rate_multitick_plain(x, z0, y0, refs, ops, **statics)
    if dev.type != "cuda":
        raise ValueError(f"direct_rate_multitick_kernel runs on cuda or cpu, not {dev}")

    _cuda.require_aligned("direct_rate_multitick_kernel", ops.GMinvT_s)
    factors_shared, smem = factor_placement(dev, N, nu, nx)
    h = float(dt) / substeps
    params = _RigidTickParams(
        k_ticks=k_ticks, n=N, m=m, iterations=int(iterations), substeps=int(substeps),
        rigid_plant=int(plant == "rigid"), rho=rho, over_relax=over_relax,
        one_minus_over_relax=1.0 - over_relax, step=_RK4Step(h, 0.5 * h, h / 6.0),
        gravity=float(body.gravity if plant == "rigid" else gravity),
        tau0=float(taus[0]), tau1=float(taus[1]), tau2=float(taus[2]),
        body=rigid_body_struct(body if body is not None else RigidBodyParams()),
    )
    out = torch.empty(k_ticks, OUT_LANES, dtype=torch.float32, device=dev)
    x_out = torch.empty(12, dtype=torch.float32, device=dev)
    z = torch.empty(m, dtype=torch.float32, device=dev)
    y = torch.empty(m, dtype=torch.float32, device=dev)
    tensors = dict(ops._asdict(), x_in=x, z_in=z0, y_in=y0, refs=refs, out=out, x_out=x_out,
                   z_out=z, y_out=y)
    operands = _RigidTickOperands(*(tensors[name].data_ptr() for name in _OPERANDS))
    fn = _cuda.library("rigid_tick").rigid_multitick_launch
    fn.argtypes = [ctypes.POINTER(_RigidTickParams), ctypes.POINTER(_RigidTickOperands),
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(params), ctypes.byref(operands), factors_shared, smem,
                _cuda.stream_of(x))
    _cuda.check(status, "direct_rate_multitick_kernel")
    _cuda.count_launch("direct_rate_multitick_kernel")
    return out, x_out, z, y


RIGID_SECTIONS = ("shift and offset", "gradient and bounds", "p0", "ADMM", "plant", "whole tick",
                  "ADMM w = v Gs", "ADMM GU and update")


def rigid_section_cycles() -> dict[str, int]:
    """K11's per-section clock cycles summed over the launches since the
    last call, then reset (``RIGID_SECTIONS``: the tick's five sections,
    the whole tick, and the ADMM's two halves). Counted only by the build
    with section clocks: launch K11 inside ``_cuda.library_variant(
    "rigid_tick", "rigid_tick_clocks")``, synchronise, then call this."""
    return _cuda.section_cycles("rigid_tick_clocks", "rigid_tick_section_cycles", RIGID_SECTIONS)
