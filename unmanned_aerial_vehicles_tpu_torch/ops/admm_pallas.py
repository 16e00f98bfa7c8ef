"""The fused ADMM kernels K14 and K6 (port of ``ops/admm_pallas.py``:
``admm_box_qp_fused`` and ``admm_box_qp_fused_composite``).

K14 ``admm_box_qp_fused`` runs the whole fixed-iteration solve of
``ops.qp.admm_box_qp`` (the box QP with an explicit ``M^-1``) in one
launch, in the TPU kernel's row form:

    rhs = -f + (rho z - y) G,  u = rhs M^-1,  Gu = u G',
    Gt = a Gu + (1 - a) z,  z = clip(Gt + y / rho, lower, upper),
    y += rho (Gt - z),

then one more ``u`` from the final ``(z, y)``. The kernel is
``csrc/single_tick_kernels.cu`` (``admm_explicit_kernel``, one block of
512 threads: warp w owns a band of ``ceil(m / 16)`` rows of ``G`` and of
``ceil(n / 16)`` rows of ``M^-1``, lane l the columns ``l + 32 q``; each
thread's slices in registers for ``n <= 128``, ``m <= 256``, read from
shared memory or through L2 beyond: ``explicit_variant``). ``G`` serves
both products, so ``GT`` is taken for the JAX signature and must be
``G``'s transpose. Its plain PyTorch version is ``admm_box_qp_fused_plain``
below.

K6 ``admm_box_qp_fused_composite`` runs the whole fixed-iteration solve of
``ops.qp.admm_box_qp_composite``: ``iterations`` over-relaxed ADMM steps
with one ``(m, m)`` matvec each, then the primal recovery

    GU = p0 + (rho z - y) P1,  Gt = a GU + (1 - a) z,
    z  = clip(Gt + y / rho, lower, upper),  y += rho (Gt - z),
    U  = -M^-1 f + GMinvT (rho z - y).

Given ``SuT`` (``G``'s block below the identity, transposed: the contract
is ``G = [I; Su]``), the kernel applies P1 as its two factors,
``v @ P1 = [t | t @ SuT]`` with ``t = v @ GMinvT'``, 64 N^2 multiply-adds a
step at horizon N against P1's 100 N^2: ``csrc/single_tick_kernels.cu``
``admm_factored_kernel``, one block of 512 threads, each thread's slices
of ``GMinvT`` and ``SuT`` in registers for the whole launch (to N=25 at
``LinearMPC``'s shapes), both read through L2 every step beyond; P1 is not
read. Without ``SuT`` (a general ``G``) it is ``admm_composite_kernel``, one
block of 256 threads, P1 in shared memory where it fits (N <= 23) and read
through L2 beyond. The plain PyTorch version is
``admm_box_qp_fused_composite_plain`` below, for both: the float32
``admm_box_qp_composite`` with the TPU kernel's contractions (the row form
``v @ P1``, GMinvT contracted on its second axis; a float32 P1 is not
exactly symmetric, so ``P1 @ v`` differs).

K6 on the factors also takes a batch of QPs that share P1's factors (a
leading axis on the per-QP vectors, one block per QP: the population's
``use_fused_admm`` tick).

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Shapes are semantic (the TPU
kernels' 128-lane padding is gone, and the ``(1, k)`` rows are ``(k,)``
vectors): K14 takes ``M_inv (n, n)``, ``G (m, n)``, ``GT (n, m)``,
``f (n,)``, ``lower, upper, z0, y0 (m,)``; K6 ``P1 (m, m)``,
``GMinvT (n, m)``, ``p0, lower, upper, z0, y0 (m,)``, ``Minv_f (n,)`` and
optionally ``SuT (n, m - n)``; all float32. Zero-padded operands (zero rows and columns of ``M^-1`` and
``G``, ``lower = upper = 0`` on padded rows) keep zeros in the padded
lanes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda

KERNEL_THREADS = 256     # csrc/single_tick_kernels.cu kThreads: K6 on P1
FACTORED_THREADS = 512   # kTickThreads: K6 on the factors, K14


def admm_box_qp_fused_composite_plain(P1, p0, GMinvT, Minv_f, lower, upper, z0, y0,
                                      rho: float, iterations: int, over_relax: float = 1.6):
    """Plain version of K6: ``(U (n,), z (m,), y (m,))``; with a leading
    flight axis on the per-QP vectors, each QP's (``(B, .)`` rows)."""
    z, y = z0, y0
    for _ in range(iterations):
        GU = p0 + (rho * z - y) @ P1
        Gt = over_relax * GU + (1.0 - over_relax) * z
        z_new = torch.minimum(torch.maximum(Gt + y / rho, lower), upper)
        y = y + rho * (Gt - z_new)
        z = z_new
    v = rho * z - y
    U = -Minv_f + (GMinvT @ v if v.ndim == 1 else v @ GMinvT.T)
    return U, z, y


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def shared_memory_bytes(m: int, p1_shared: bool = True) -> int:
    """Dynamic shared memory of one K6 block (csrc/single_tick_kernels.cu
    layout): P1 (shared variant only), the double-buffered matvec input and
    five m-vectors."""
    return 4 * ((_round4(m * m) if p1_shared else 0) + 2 * _round4(m) + 5 * m)


def factored_shared_memory_bytes(n: int, m: int, threads: int = FACTORED_THREADS) -> int:
    """Dynamic shared memory of one block of K6 on the factors
    (csrc/single_tick_kernels.cu ``admm_factored_kernel`` layout; the
    factors stay in registers or device memory): the ADMM input
    double-buffered and t (16-byte aligned), five m-vectors and the
    products' slices."""
    return 4 * (2 * _round4(m) + _round4(n) + 5 * m + threads)


# K6's section clocks on the factors (the build with section clocks): the
# library's counters it sets (``tick_pallas.SINGLE_TICK_COUNTERS``; the ADMM
# includes the slices' loads, its three phases are summed over its steps)
COMPOSITE_SECTIONS = ("ADMM", "ADMM: t and the U-block update", "ADMM: t Su'",
                      "ADMM: the X-block update", "solve: U", "whole launch")


def composite_section_cycles() -> dict[str, int]:
    """K6's per-section clock cycles on the factors, summed over the
    launches since the last call, then reset (``COMPOSITE_SECTIONS``).
    Counted only by the build with section clocks: launch K6 with ``SuT``
    inside ``_cuda.library_variant("single_tick", "single_tick_clocks")``,
    synchronise, then call this."""
    from .tick_pallas import single_tick_counters

    cycles = single_tick_counters()
    return {name: cycles[name] for name in COMPOSITE_SECTIONS}


class _AdmmParams(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int), ("m", ctypes.c_int), ("iterations", ctypes.c_int),
        ("rho", ctypes.c_float), ("over_relax", ctypes.c_float),
        ("one_minus_over_relax", ctypes.c_float),
    ]


_ADMM_OPERANDS = ("P1", "p0", "GMinvT", "minvf", "lower", "upper", "z_in", "y_in",
                  "u_out", "z_out", "y_out", "SuT")


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
    *,
    SuT: torch.Tensor | None = None,   # (n, m - n) = Su' for G = [I; Su]
):
    """The whole composite-ADMM solve in one launch (K6). Returns
    ``(U (n,), z (m,), y (m,))`` in float32. With ``SuT`` the kernel applies
    P1 as ``GMinvT`` and ``SuT`` and does not read P1; the plain version,
    which the CPU runs, multiplies by P1 either way. With a leading flight
    axis on ``p0``, ``Minv_f``, the bounds, ``z0`` and ``y0`` (``(B, .)``
    rows: B QPs that share P1's factors) the launch is a grid of one block
    per QP, which needs ``SuT``; the outputs then carry the axis."""
    dev = P1.device
    m, n = P1.shape[0], GMinvT.shape[0]
    batch = (p0.shape[0],) if p0.ndim == 2 else ()
    req = _cuda.require
    req(P1, "P1", (m, m), dev)
    req(GMinvT, "GMinvT", (n, m), dev)
    req(Minv_f, "Minv_f", batch + (n,), dev)
    for name, t in (("p0", p0), ("lower", lower), ("upper", upper), ("z0", z0), ("y0", y0)):
        req(t, name, batch + (m,), dev)
    if SuT is not None:
        req(SuT, "SuT", (n, m - n), dev)
    elif batch:
        raise ValueError("a batch of QPs runs on P1's factors: pass SuT")
    if dev.type == "cpu":
        return admm_box_qp_fused_composite_plain(P1, p0, GMinvT, Minv_f, lower, upper, z0, y0,
                                                 rho, iterations, over_relax)
    if dev.type != "cuda":
        raise ValueError(f"admm_box_qp_fused_composite runs on cuda or cpu, not {dev}")

    if SuT is None:
        _cuda.require_aligned("admm_box_qp_fused_composite", P1)
        shared, smem = _cuda.p1_variant(dev, shared_memory_bytes(m, True),
                                        shared_memory_bytes(m, False))
        entry = "admm_composite_launch"
    else:
        from .controller_pallas import factor_variant

        _cuda.require_aligned("admm_box_qp_fused_composite", GMinvT, SuT)
        shared, smem = factor_variant(dev, n, m, factored_shared_memory_bytes(n, m),
                                      even_rows=True)
        entry = "admm_factored_launch"
    params = _AdmmParams(n=n, m=m, iterations=int(iterations), rho=rho, over_relax=over_relax,
                         one_minus_over_relax=1.0 - over_relax)
    U = torch.empty(*batch, n, dtype=torch.float32, device=dev)
    z = torch.empty(*batch, m, dtype=torch.float32, device=dev)
    y = torch.empty(*batch, m, dtype=torch.float32, device=dev)
    ops = _AdmmOperands(*(t.data_ptr() if t is not None else None
                          for t in (P1, p0, GMinvT, Minv_f, lower, upper, z0, y0, U, z, y, SuT)))
    fn = getattr(_cuda.library("single_tick"), entry)
    # the factored entry takes the grid's QPs, one block each
    grid = () if SuT is None else (batch[0] if batch else 1,)
    fn.argtypes = [ctypes.POINTER(_AdmmParams), ctypes.POINTER(_AdmmOperands), ctypes.c_int,
                   ctypes.c_int, *(ctypes.c_int for _ in grid), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(params), ctypes.byref(ops), shared, smem, *grid,
                _cuda.stream_of(P1))
    _cuda.check(status, "admm_box_qp_fused_composite")
    _cuda.count_launch("admm_box_qp_fused_composite")
    return U, z, y


# ---------------------------------------------------------------------------
# K14: the ADMM box QP with an explicit M^-1
# ---------------------------------------------------------------------------


def admm_box_qp_fused_plain(M_inv, G, GT, f, lower, upper, z0, y0, rho: float,
                            iterations: int, over_relax: float = 1.6):
    """Plain version of K14: ``(U (n,), z (m,), y (m,))``. ``GT`` is
    ``G``'s transpose; like the kernel, this reads ``G`` for both products."""
    z, y = z0, y0

    def primal(z, y):
        return (-f + (rho * z - y) @ G) @ M_inv

    for _ in range(iterations):
        Gt = over_relax * (primal(z, y) @ G.T) + (1.0 - over_relax) * z
        z_new = torch.minimum(torch.maximum(Gt + y / rho, lower), upper)
        y = y + rho * (Gt - z_new)
        z = z_new
    return primal(z, y), z, y


# K14's layout (csrc/single_tick_kernels.cu): 16 warps, each a band of
# rows; a lane's columns l + 32 q, q < 4, of each 128-column block; G's
# rows 16 at a time, M^-1's rhs 8 at a time
EXPLICIT_WARPS, EXPLICIT_ROW_GROUP, EXPLICIT_COL_BLOCK, EXPLICIT_M_GROUP = 16, 16, 128, 8
# the variants: each thread's slices in registers (one row group: m <= 256;
# variant i + 1 for the i-th (n bound, columns a lane, rows of M^-1): 16
# rows x q columns of G and r x q of M^-1), or read where they are used
# (variant 0: from shared memory where G and M^-1 fit beside the vectors,
# else through L2)
EXPLICIT_MEMORY = 0
EXPLICIT_REG_VARIANTS = ((96, 3, 6), (112, 4, 7), (128, 4, 8))


class ExplicitShape(NamedTuple):
    """K14's bands for ``n`` unknowns and ``m`` rows (``explicit_shape`` in
    the kernel)."""

    band: int     # G rows a warp owns: ceil(m / 16)
    mband: int    # M^-1 rows a warp owns: ceil(n / 16)
    groups: int   # 16-row groups of a band
    mgroups: int  # 8-row groups of an M^-1 band
    blocks: int   # 128-column blocks
    slots: int    # a warp's row slots, 16 groups
    ldp: int      # the partials' row stride, 128 blocks + 8


def explicit_shape(n: int, m: int) -> ExplicitShape:
    band, mband = -(-m // EXPLICIT_WARPS), -(-n // EXPLICIT_WARPS)
    groups, blocks = -(-band // EXPLICIT_ROW_GROUP), -(-n // EXPLICIT_COL_BLOCK)
    return ExplicitShape(band, mband, groups, -(-mband // EXPLICIT_M_GROUP), blocks,
                         EXPLICIT_ROW_GROUP * groups, EXPLICIT_COL_BLOCK * blocks + 8)


def explicit_shared_memory_bytes(n: int, m: int, shared: bool = True) -> int:
    """Dynamic shared memory of one K14 block (csrc/single_tick_kernels.cu
    layout): the two partials' tables (16 rows of ``ldp``), f, u, each
    warp's 8 rhs rows, five vectors by row slot (v, z, y and the box), and,
    with ``shared``, copies of G and M^-1."""
    S = explicit_shape(n, m)
    floats = 2 * EXPLICIT_WARPS * S.ldp + S.ldp + EXPLICIT_COL_BLOCK * S.blocks
    floats += EXPLICIT_WARPS * EXPLICIT_M_GROUP + 5 * EXPLICIT_WARPS * S.slots
    if shared:
        floats += _round4(m * n) + n * n
    return 4 * floats


def explicit_variant(device, n: int, m: int) -> tuple[int, bool, int]:
    """``(variant, shared_slices, bytes)`` of K14: where a band is one group
    of at most 16 rows (``m <= 256``), the register slices of the first of
    ``EXPLICIT_REG_VARIANTS`` that holds the row (``n <= 96``, ``112``,
    ``128``); else the slices read where they are used, from copies in
    shared memory where those fit one block, else through L2. Raises if not
    even the vectors fit."""
    limit = _cuda.shared_memory_optin(device)
    S = explicit_shape(n, m)
    vectors = explicit_shared_memory_bytes(n, m, False)
    if vectors > limit:
        raise ValueError(f"K14's vectors need {vectors} bytes of shared memory, more than one "
                         f"block's {limit}")
    if S.groups == 1:
        for variant, (n_max, _, _) in enumerate(EXPLICIT_REG_VARIANTS, 1):
            if n <= n_max:
                return variant, False, vectors
    with_slices = explicit_shared_memory_bytes(n, m, True)
    if with_slices <= limit:
        return EXPLICIT_MEMORY, True, with_slices
    return EXPLICIT_MEMORY, False, vectors


# K14's section clocks (the build with section clocks, thread 0; slots 0-8
# of the library's counters)
EXPLICIT_SECTIONS = ("v G", "wait after v G", "rhs and rhs M^-1", "wait after rhs M^-1", "u",
                     "wait after u", "G u and the updates", "whole launch", "set-up")


def explicit_section_cycles() -> dict[str, int]:
    """K14's per-section clock cycles summed over the launches since the
    last call, then reset (``EXPLICIT_SECTIONS``; the loop's sections summed
    over its iterations). Counted only by the build with section clocks:
    launch K14 inside ``_cuda.library_variant("single_tick",
    "single_tick_clocks")``, synchronise, then call this."""
    from .tick_pallas import single_tick_counters

    cycles = list(single_tick_counters().values())
    return dict(zip(EXPLICIT_SECTIONS, cycles))


class _ExplicitParams(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int), ("m", ctypes.c_int), ("iterations", ctypes.c_int),
        ("rho", ctypes.c_float), ("over_relax", ctypes.c_float),
        ("one_minus_over_relax", ctypes.c_float), ("shared_slices", ctypes.c_int),
    ]


_EXPLICIT_OPERANDS = ("Minv", "G", "f", "lower", "upper", "z_in", "y_in",
                      "u_out", "z_out", "y_out")


class _ExplicitOperands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _EXPLICIT_OPERANDS]


def admm_box_qp_fused(
    M_inv: torch.Tensor,   # (n, n) = (H + rho G'G)^-1
    G: torch.Tensor,       # (m, n)
    GT: torch.Tensor,      # (n, m) = G'
    f: torch.Tensor,       # (n,)
    lower: torch.Tensor,   # (m,)
    upper: torch.Tensor,   # (m,)
    z0: torch.Tensor,      # (m,)
    y0: torch.Tensor,      # (m,)
    rho: float,
    iterations: int,
    over_relax: float = 1.6,
):
    """The whole explicit-inverse ADMM solve in one launch (K14). Returns
    ``(U (n,), z (m,), y (m,))`` in float32 after ``iterations`` steps and
    the final primal refresh."""
    dev = M_inv.device
    n, m = M_inv.shape[0], G.shape[0]
    req = _cuda.require
    req(M_inv, "M_inv", (n, n), dev)
    req(G, "G", (m, n), dev)
    req(GT, "GT", (n, m), dev)
    req(f, "f", (n,), dev)
    for name, t in (("lower", lower), ("upper", upper), ("z0", z0), ("y0", y0)):
        req(t, name, (m,), dev)
    if dev.type == "cpu":
        return admm_box_qp_fused_plain(M_inv, G, GT, f, lower, upper, z0, y0, rho,
                                       iterations, over_relax)
    if dev.type != "cuda":
        raise ValueError(f"admm_box_qp_fused runs on cuda or cpu, not {dev}")

    variant, shared, smem = explicit_variant(dev, n, m)
    if shared:
        _cuda.require_aligned("admm_box_qp_fused", M_inv, G)
    params = _ExplicitParams(n=n, m=m, iterations=int(iterations), rho=rho,
                             over_relax=over_relax, one_minus_over_relax=1.0 - over_relax,
                             shared_slices=int(shared))
    U = torch.empty(n, dtype=torch.float32, device=dev)
    z = torch.empty(m, dtype=torch.float32, device=dev)
    y = torch.empty(m, dtype=torch.float32, device=dev)
    ops = _ExplicitOperands(*(t.data_ptr() for t in (M_inv, G, f, lower, upper, z0, y0,
                                                     U, z, y)))
    fn = _cuda.library("single_tick").admm_explicit_launch
    fn.argtypes = [ctypes.POINTER(_ExplicitParams), ctypes.POINTER(_ExplicitOperands),
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(params), ctypes.byref(ops), variant, smem, _cuda.stream_of(M_inv))
    _cuda.check(status, "admm_box_qp_fused")
    _cuda.count_launch("admm_box_qp_fused")
    return U, z, y
