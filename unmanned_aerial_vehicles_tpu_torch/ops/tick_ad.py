"""Autodiff through the fused flight tiers (port of ``ops/tick_ad.py``), the
K13 routes.

A kernel launched on ``data_ptr()`` has no place in autograd's graph
(``_cuda.require`` refuses operands that ask for a gradient). Each route
here is one ``torch.autograd.Function`` whose forward calls the existing
wrapper (on ``cuda`` the kernel, on the CPU its plain version) with grad
mode off, and whose backward is:

* K1 ``px4_plant_step_ad``: the VJP kernel K13a ``px4_plant_step_vjp``
  (``csrc/plant_vjp_kernels.cu``); its plain version
  ``px4_plant_step_vjp_plain`` is ``torch.func.vjp`` of K1's plain version;
* K2 ``allocation_plant_tick_ad``: the VJP kernel K13b
  ``allocation_plant_tick_vjp``; plain version
  ``allocation_plant_tick_vjp_plain``;

both VJP kernels run a warp per state, ``VJP_STATES_PER_BLOCK`` to a block
(``vjp_geometry``); K13b's allocation VJP spreads its serial pieces over
the lanes by the table ``ALLOC_VJP_LANES`` (``alloc_vjp_lane_role``), and
``plant_vjp_section_cycles`` reads its cycles by phase from the
``plant_vjp_clocks`` build;
* K5 ``gpmpc_multitick_ad``: ``torch.autograd.grad`` of K5's plain twin
  ``ops.tick_pallas.multitick_staged``, recomputed from the saved operands.
  That is the JAX package's own backward program (its custom VJP
  differentiates the same staged twin); the TPU side has no backward
  kernel here either.

Both plant VJPs return a cotangent for every operand, the plant row's 10
lanes included, as the JAX custom VJPs do. ``Function.apply`` tracks only
tensors passed as positional arguments, so the K5 route flattens every
tensor of ``FusedTickData`` and ``GPRows`` into its argument list and
rebuilds the tuples inside.

Also here: ``build_fused_controller_data_traced`` and
``build_tick_data_traced``, the kernels' controller operands built with
tensor ops from tensors that carry gradient (the tuner's cost weights), so
the gradient reaches the MPC weights through the kernel operands.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .controller_pallas import FusedControllerData
from .plant_pallas import (
    PLANT_LANES,
    _allocation_plant_rows,
    _px4_plant_rows,
    allocation_plant_tick_plain,
    px4_plant_step_plain,
)
from .tick_pallas import (
    FusedTickData,
    GPRows,
    build_shift_matrix,
    gpmpc_multitick_fused,
    multitick_staged,
)

_f32 = torch.float32


# ---------------------------------------------------------------------------
# Traced construction of the fused-kernel operands
# ---------------------------------------------------------------------------


def build_fused_controller_data_traced(
    Sx, Su, Sw, SuT_q, M_inv, G, u_lo, u_hi, x_lo, x_hi,
) -> FusedControllerData:
    """Tensor twin of ``controller_pallas.build_fused_controller_data``:
    the same fields and shapes as contiguous float32 tensors, built with
    differentiable ops from tensors of one dtype and device. Products form
    in the operands' dtype and round to float32 once."""
    out = lambda a: a.to(_f32).contiguous()
    Nnu = Su.shape[1]
    m = G.shape[0]
    GMinv = G @ M_inv

    def row(v, off):
        return out(torch.nn.functional.pad(v, (off, m - off - v.shape[0])))

    return FusedControllerData(
        SxT=out(Sx.T),
        SwT=out(Sw.T),
        SuTqT=out(SuT_q.T),
        SuT=out(Su.T),
        P1=out(GMinv @ G.T),
        P0mat=out(GMinv.T),
        P0matT=out(GMinv),
        MinvT=out(M_inv),
        u_lo_row=row(u_lo, 0), u_hi_row=row(u_hi, 0),
        x_lo_row=row(x_lo, Nnu), x_hi_row=row(x_hi, Nnu),
    )


def build_tick_data_traced(ctrl: FusedControllerData, N: int, nu: int, nx: int) -> FusedTickData:
    """Tensor twin of ``tick_pallas.build_tick_data`` over tensor controller
    operands, field for field. ``ShiftT`` is the weight-independent 0/1
    shift matrix."""
    dev = ctrl.P1.device
    c = lambda a: a.to(_f32).contiguous()
    return FusedTickData(
        ctrl=ctrl,
        ShiftT=torch.as_tensor(build_shift_matrix(N, nu, nx), device=dev),
        SxSwT=c(torch.cat([ctrl.SxT, ctrl.SwT], dim=0)),
        SuTqT=c(ctrl.SuTqT),
        PM=c(torch.cat([ctrl.P0mat, ctrl.MinvT], dim=1)),
        P1=c(ctrl.P1),
        P0matT=c(ctrl.P0matT),
        SuT=c(ctrl.SuT),
        lo_row=c(ctrl.u_lo_row + ctrl.x_lo_row),
        hi_row=c(ctrl.u_hi_row + ctrl.x_hi_row),
        SwSqT=c(ctrl.SwT ** 2),
        Nnu=N * nu,
        Nnx=N * nx,
    )


def traced_plant_row(mass, gravity, k_drag_linear, taus, thrust_gain,
                     wind=(0.0, 0.0, 0.0), device=None) -> torch.Tensor:
    """``plant_pallas.build_plant_row`` that keeps the gradient of scalars
    given as tensors (floats become constants)."""
    vals = (mass, gravity, k_drag_linear, taus[0], taus[1], taus[2], thrust_gain,
            wind[0], wind[1], wind[2])
    return torch.stack([torch.as_tensor(v, device=device).to(_f32).reshape(()) for v in vals])


# ---------------------------------------------------------------------------
# K13a / K13b: the plant VJP kernels and their plain versions
# ---------------------------------------------------------------------------


VJP_MAX_SUBSTEPS = 64   # csrc/plant_vjp_kernels.cu kMaxVjpSubsteps
VJP_STATES_PER_BLOCK = 4   # kVjpWarps: a warp per state
VJP_THREADS = 32 * VJP_STATES_PER_BLOCK

# csrc/plant_math.cuh:allocation_vjp_warp's lane table: in each round, lane
# i forms entry ``i % len(round)`` (the kernel's ``lane & 1`` and ``lane %
# 3``), which the warp's shuffles read from the lowest such lane; the other
# lanes repeat a neighbour's work, unread. ``ALLOC_VJP_EVERY_LANE`` is the
# quotient alone in its round, which every lane forms.
ALLOC_VJP_LANES = {
    "quotient 1": ("tmag / gravity", "1 / max(tmag, 1e-9)"),
    "asinf": ("pitch", "roll"),
    "rsqrtf": ("pitch", "roll"),
    "quotient 2": ("g_x / gravity", "g_x tmag / gravity^2"),
    "wrap": ("roll", "pitch", "yaw"),
}
ALLOC_VJP_EVERY_LANE = ("g_tmag / (2 tmag)",)


def alloc_vjp_lane_role(lane: int) -> dict[str, str]:
    """What lane ``lane`` of a K13b warp forms in each round of
    ``allocation_vjp_warp``."""
    return {rnd: names[lane % len(names)] for rnd, names in ALLOC_VJP_LANES.items()}


def vjp_geometry(B: int) -> tuple[int, int]:
    """K13a's and K13b's launch for a batch of ``B`` states, as the wrappers
    pass it to ``csrc/plant_vjp_kernels.cu``: ``(blocks, threads a
    block)``, a warp per state, ``VJP_STATES_PER_BLOCK`` a block (256 blocks
    at B=1024)."""
    return -(-B // VJP_STATES_PER_BLOCK), VJP_THREADS


PLANT_VJP_SECTIONS = ("forward allocation", "plant forward", "plant adjoint",
                      "allocation VJP", "whole")


def plant_vjp_section_cycles() -> dict[str, float]:
    """K13b's clock cycles per state since the last call, counted by lane 0
    of each warp in the ``plant_vjp_clocks`` build: the forward allocation,
    the plant's forward (its stage states stored), its adjoint, the
    allocation's VJP, and the whole state (the loads included, the writes
    not). Call inside ``_cuda.library_variant("plant_vjp",
    "plant_vjp_clocks")`` after the launches, synchronised; the first call
    only resets them."""
    raw = _cuda.section_cycles("plant_vjp", "plant_vjp_section_cycles",
                               PLANT_VJP_SECTIONS + ("states",))
    states = max(raw.pop("states"), 1)
    return {k: v / states for k, v in raw.items()}


def px4_plant_step_vjp_plain(state, control, plant_row, ct_out, dt: float, substeps: int):
    """Plain version of K13a: ``torch.func.vjp`` of K1's plain version.
    Returns ``(ct_state (B, 12), ct_control (B, 4), ct_plant (10,))``."""
    _, vjp = torch.func.vjp(lambda s, c, p: px4_plant_step_plain(s, c, p, dt, substeps),
                            state, control, plant_row)
    return vjp(ct_out)


def px4_plant_step_vjp(state, control, plant_row, ct_out, dt: float, substeps: int,
                       plant_grad: bool = True):
    """K13a: the cotangents of K1's operands from the cotangent ``ct_out
    (B, 12)`` of its new state, one launch, one warp per state (at most
    ``VJP_MAX_SUBSTEPS`` substeps, whose stage states the warp keeps in
    shared memory). The plant row's per-state cotangents are summed over the
    batch in a fixed order (``None`` when ``plant_grad`` is off; a batch of
    one returns its row). On CPU tensors it runs the plain version."""
    dev = state.device
    B = state.shape[0]
    _cuda.require(state, "state", (B, 12), dev)
    _cuda.require(control, "control", (B, 4), dev)
    _cuda.require(plant_row, "plant_row", (PLANT_LANES,), dev)
    _cuda.require(ct_out, "ct_out", (B, 12), dev)
    if dev.type == "cpu":
        out = px4_plant_step_vjp_plain(state, control, plant_row, ct_out, dt, substeps)
        return out if plant_grad else (*out[:2], None)
    if dev.type != "cuda":
        raise ValueError(f"px4_plant_step_vjp runs on cuda or cpu, not {dev}")
    if not 0 <= substeps <= VJP_MAX_SUBSTEPS:
        raise ValueError(f"px4_plant_step_vjp takes 0..{VJP_MAX_SUBSTEPS} substeps, not {substeps}")
    fn = _cuda.library("plant_vjp").px4_plant_step_vjp_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_double] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ct_state = torch.empty_like(state)
    ct_control = torch.empty_like(control)
    ct_plant = torch.empty(B, PLANT_LANES, dtype=_f32, device=dev)
    status = fn(_cuda.ptr(state), _cuda.ptr(control), _cuda.ptr(plant_row), _cuda.ptr(ct_out),
                _cuda.ptr(ct_state), _cuda.ptr(ct_control), _cuda.ptr(ct_plant), B, float(dt),
                int(substeps), *vjp_geometry(B), _cuda.stream_of(state))
    _cuda.check(status, "px4_plant_step_vjp")
    _cuda.count_launch("px4_plant_step_vjp")
    if not plant_grad:
        return ct_state, ct_control, None
    # a batch of one (the tuners') needs no reduction launch
    return ct_state, ct_control, ct_plant[0] if B == 1 else ct_plant.sum(dim=0)


def allocation_plant_tick_vjp_plain(state, cmd, integral, plant_row, ct_state, ct_ctrl, ct_int,
                                    dt: float, substeps: int):
    """Plain version of K13b: ``torch.func.vjp`` of K2's plain version.
    Returns ``(ct_state (B, 12), ct_cmd (B, 6), ct_integral (B, 3),
    ct_plant (10,))``."""
    _, vjp = torch.func.vjp(
        lambda s, c, i, p: allocation_plant_tick_plain(s, c, i, p, dt, substeps),
        state, cmd, integral, plant_row)
    return vjp((ct_state, ct_ctrl, ct_int))


def allocation_plant_tick_vjp(state, cmd, integral, plant_row, ct_state, ct_ctrl, ct_int,
                              dt: float, substeps: int, plant_grad: bool = True):
    """K13b: the cotangents of K2's operands from those of its three outputs
    (new state (B, 12), control + attitude setpoint (B, 7), integral
    (B, 3)), one launch, one warp per state (at most ``VJP_MAX_SUBSTEPS``
    substeps, as K13a); the plant row's summed as in K13a (``None`` when
    ``plant_grad`` is off; a batch of one returns its row). On CPU tensors
    it runs the plain version."""
    dev = state.device
    B = state.shape[0]
    req = _cuda.require
    req(state, "state", (B, 12), dev)
    req(cmd, "cmd", (B, 6), dev)
    req(integral, "integral", (B, 3), dev)
    req(plant_row, "plant_row", (PLANT_LANES,), dev)
    req(ct_state, "ct_state", (B, 12), dev)
    req(ct_ctrl, "ct_ctrl", (B, 7), dev)
    req(ct_int, "ct_int", (B, 3), dev)
    if dev.type == "cpu":
        out = allocation_plant_tick_vjp_plain(state, cmd, integral, plant_row, ct_state,
                                              ct_ctrl, ct_int, dt, substeps)
        return out if plant_grad else (*out[:3], None)
    if dev.type != "cuda":
        raise ValueError(f"allocation_plant_tick_vjp runs on cuda or cpu, not {dev}")
    if not 0 <= substeps <= VJP_MAX_SUBSTEPS:
        raise ValueError(f"allocation_plant_tick_vjp takes 0..{VJP_MAX_SUBSTEPS} substeps, "
                         f"not {substeps}")
    fn = _cuda.library("plant_vjp").allocation_plant_tick_vjp_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_double] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g_state = torch.empty_like(state)
    g_cmd = torch.empty_like(cmd)
    g_int = torch.empty_like(integral)
    g_plant = torch.empty(B, PLANT_LANES, dtype=_f32, device=dev)
    status = fn(_cuda.ptr(state), _cuda.ptr(cmd), _cuda.ptr(integral), _cuda.ptr(plant_row),
                _cuda.ptr(ct_state), _cuda.ptr(ct_ctrl), _cuda.ptr(ct_int), _cuda.ptr(g_state),
                _cuda.ptr(g_cmd), _cuda.ptr(g_int), _cuda.ptr(g_plant), B, float(dt),
                int(substeps), *vjp_geometry(B), _cuda.stream_of(state))
    _cuda.check(status, "allocation_plant_tick_vjp")
    _cuda.count_launch("allocation_plant_tick_vjp")
    if not plant_grad:
        return g_state, g_cmd, g_int, None
    # a batch of one (the staged MPC tuner's) needs no reduction launch
    return g_state, g_cmd, g_int, g_plant[0] if B == 1 else g_plant.sum(dim=0)


# ---------------------------------------------------------------------------
# K1 / K2 with VJP rules
# ---------------------------------------------------------------------------


class _PlantStepAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, state, control, plant_row, dt, substeps):
        ctx.save_for_backward(state, control, plant_row)
        ctx.dt, ctx.substeps = dt, substeps
        return _px4_plant_rows(state, control, plant_row, dt, substeps)

    @staticmethod
    def backward(ctx, ct_out):
        need = ctx.needs_input_grad
        if not any(need[:3]):
            return None, None, None, None, None
        state, control, plant_row = ctx.saved_tensors
        g_state, g_control, g_plant = px4_plant_step_vjp(
            state, control, plant_row, ct_out.contiguous(), ctx.dt, ctx.substeps,
            plant_grad=need[2])
        return (g_state if need[0] else None, g_control if need[1] else None,
                g_plant, None, None)


def _shared_plant_row(plant_row) -> None:
    """The VJP kernels sum the plant row's cotangent over the batch: the
    autodiff routes take one shared ``(10,)`` row, not a per-flight block."""
    if tuple(plant_row.shape) != (PLANT_LANES,):
        raise ValueError(f"the autodiff routes take one shared plant row of {PLANT_LANES} "
                         f"lanes, got shape {tuple(plant_row.shape)}")


def px4_plant_rows_ad(state, control, plant_row, dt: float, substeps: int):
    """``plant_pallas._px4_plant_rows`` (K1 on ``(B, 12)``, ``(B, 4)``
    rows) with a VJP rule: the forward is K1, the backward K13a."""
    _shared_plant_row(plant_row)
    return _PlantStepAD.apply(state, control, plant_row, dt, substeps)


class _AllocationTickAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, state, cmd, integral, plant_row, dt, substeps):
        ctx.save_for_backward(state, cmd, integral, plant_row)
        ctx.dt, ctx.substeps = dt, substeps
        return _allocation_plant_rows(state, cmd, integral, plant_row, dt, substeps)

    @staticmethod
    def backward(ctx, ct_state, ct_ctrl, ct_int):
        need = ctx.needs_input_grad
        if not any(need[:4]):
            return None, None, None, None, None, None
        state, cmd, integral, plant_row = ctx.saved_tensors
        grads = allocation_plant_tick_vjp(
            state, cmd, integral, plant_row, ct_state.contiguous(), ct_ctrl.contiguous(),
            ct_int.contiguous(), ctx.dt, ctx.substeps, plant_grad=need[3])
        return (*(g if n else None for g, n in zip(grads, need[:4])), None, None)


def allocation_plant_rows_ad(state, cmd, integral, plant_row, dt: float, substeps: int):
    """``plant_pallas._allocation_plant_rows`` (K2) with a VJP rule: the
    forward is K2, the backward K13b."""
    _shared_plant_row(plant_row)
    return _AllocationTickAD.apply(state, cmd, integral, plant_row, dt, substeps)


def px4_plant_step_ad(state, control, mass, gravity, k_drag_linear, taus, dt: float,
                      substeps: int = 2, thrust_gain=None, wind=(0.0, 0.0, 0.0)):
    """Drop-in for ``plant_pallas.px4_plant_step_fused`` with a VJP rule.
    Plant scalars given as tensors keep their gradient."""
    single = state.ndim == 1
    srow = state.reshape(-1, 12).to(_f32).contiguous()
    crow = control.reshape(-1, 4).to(_f32).contiguous()
    prow = traced_plant_row(mass, gravity, k_drag_linear, taus,
                            gravity if thrust_gain is None else thrust_gain, wind,
                            device=state.device)
    out = px4_plant_rows_ad(srow, crow, prow, dt, substeps)
    return out[0] if single else out


def allocation_plant_tick_ad(state, accel_des, yawrate_des, target_yaw, att_integral,
                             mass, gravity, k_drag_linear, taus, dt: float, substeps: int = 2,
                             thrust_gain=None, wind=(0.0, 0.0, 0.0), thrust_ceiling=1.2):
    """Drop-in for ``plant_pallas.allocation_plant_tick_fused`` with a VJP
    rule. Returns ``(new_state, control4, att_setpoint3, new_integral3)``."""
    single = state.ndim == 1
    dev = state.device
    srow = state.reshape(-1, 12).to(_f32).contiguous()
    B = srow.shape[0]
    col = lambda v: torch.as_tensor(v, device=dev).to(_f32).reshape(-1, 1).expand(B, 1)
    cmd = torch.cat([accel_des.reshape(-1, 3).to(_f32).expand(B, 3), col(yawrate_des),
                     col(target_yaw), col(thrust_ceiling)], dim=1).contiguous()
    irow = att_integral.reshape(-1, 3).to(_f32).expand(B, 3).contiguous()
    prow = traced_plant_row(mass, gravity, k_drag_linear, taus,
                            gravity if thrust_gain is None else thrust_gain, wind, device=dev)
    new_state, ctrl, new_int = allocation_plant_rows_ad(srow, cmd, irow, prow, dt, substeps)
    out = (new_state, ctrl[:, 0:4], ctrl[:, 4:7], new_int)
    return tuple(o[0] for o in out) if single else out


# ---------------------------------------------------------------------------
# K5 with a VJP rule: forward = the kernel, backward = the staged twin's VJP
# ---------------------------------------------------------------------------

# FusedTickData's tensor fields (``ctrl`` is the host source, ``Nnu``/``Nnx``
# ints); every GPRows field is a tensor or None
TICK_DATA_TENSORS = ("ShiftT", "SxSwT", "SuTqT", "PM", "P1", "P0matT", "SuT", "lo_row",
                     "hi_row", "SwSqT")
_N_DATA, _N_GP = len(TICK_DATA_TENSORS), len(GPRows._fields)


def _rebuild(layout, ops):
    ctrl, Nnu, Nnx, has_gp = layout
    data = FusedTickData(ctrl=ctrl, Nnu=Nnu, Nnx=Nnx,
                         **dict(zip(TICK_DATA_TENSORS, ops[:_N_DATA])))
    gp = GPRows(*ops[_N_DATA:_N_DATA + _N_GP]) if has_gp else None
    return data, gp, ops[_N_DATA + _N_GP:]


class _MultitickAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layout, statics, *ops):
        ctx.layout, ctx.statics = layout, statics
        ctx.save_for_backward(*ops)
        data, gp, rows = _rebuild(layout, ops)
        return gpmpc_multitick_fused(data, gp, *rows, **statics)

    @staticmethod
    def backward(ctx, *cts):
        ops = ctx.saved_tensors
        need = [n and t is not None for t, n in zip(ops, ctx.needs_input_grad[2:])]
        grads = [None] * len(ops)
        if any(need):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(n) if t is not None else None
                          for t, n in zip(ops, need)]
                data, gp, rows = _rebuild(ctx.layout, leaves)
                outs = multitick_staged(data, gp, *rows, **ctx.statics)
                pairs = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
                wrt = [t for t, n in zip(leaves, need) if n]
                got = torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs],
                                          allow_unused=True) if pairs else [None] * len(wrt)
            it = iter(got)
            grads = [next(it) if n else None for n in need]
        return (None, None, *grads)


def gpmpc_multitick_ad(data: FusedTickData, gp: GPRows | None, state, aux, xtail, z0, y0,
                       refs, yaw_refs, plant_row, **statics):
    """Drop-in for ``tick_pallas.gpmpc_multitick_fused`` with a VJP rule.

    The forward is K5 itself (the plain version on CPU tensors), so the
    outputs are those of the kernel bit for bit; under autograd the
    backward recomputes K5's plain twin ``multitick_staged`` from the saved
    operands and takes its VJP. Select it with
    ``FlightLoopConfig(fused_tick_ad=True)``."""
    layout = (data.ctrl, data.Nnu, data.Nnx, gp is not None)
    ops = ([getattr(data, f) for f in TICK_DATA_TENSORS]
           + (list(gp) if gp is not None else [None] * _N_GP)
           + [state, aux, xtail, z0, y0, refs, yaw_refs, plant_row])
    return _MultitickAD.apply(layout, statics, *ops)

