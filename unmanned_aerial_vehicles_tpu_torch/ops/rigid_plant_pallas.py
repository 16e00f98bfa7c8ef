"""The rigid-plant kernel K10 (port of ``ops/rigid_plant_pallas.py``).

``rigid_body_rollout_fused`` runs n sequential RK4 steps of the 12-state
rigid body (per-step controls and optional per-step derivative residuals,
``substeps`` per step) in one launch of ``csrc/rigid_plant_kernels.cu``;
``rigid_body_rk4_step_fused`` is its one-step form. The physics constants
are kernel arguments, so every parameter set shares one build.

``make_plant_math`` is the plain counterpart of the device math in
``csrc/rigid_math.cuh`` (shared by K10, K11's rigid plant and K12): the
same expressions on tuples of tensors of any one shape (0-d for one
trajectory, ``(K,)`` for MPPI's samples). ``rigid_body_rollout_plain`` is
K10's plain version. A wrapper takes it only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.

``rigid_body_rk4_step_fast`` is the flights' plant step: the kernel for a
CUDA state, the model's ``rigid_body_rk4_step`` (in the state's dtype) for
a CPU one, as the JAX package's backend-aware step.

With a leading member axis (``x0 (B, 12)``, the fields of
``RigidBodyParams`` numbers or ``(B,)`` tensors) K10 rolls every member out
on its own body in one launch, one warp per member
(``rigid_body_block``'s rows on the card): ``loop.monte_carlo.
monte_carlo_mpc12``'s truth step.

K10 runs the rollout on one warp: each derivative spreads its sines,
cosines and quotients over a group of 8 lanes
(``csrc/rigid_math.cuh:rigid_rk4_warp``, K12's lane table,
``ops.mppi_pallas.rigid_lane_roles``), every group stepping the same state.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.params import RigidBodyParams
from ..models.rigid_body import rigid_body_rk4_step
from . import _cuda


def _constant(v):
    """A parameter as the math reads it: a number, or a ``(B,)`` tensor of
    per-member values (broadcast against the members' state columns)."""
    return v if isinstance(v, torch.Tensor) and v.ndim > 0 else float(v)


def make_plant_math(h: float, params: RigidBodyParams):
    """``(deriv, rk4)`` over 12-tuples of same-shaped tensors: the device
    math of ``csrc/rigid_math.cuh``. ``deriv(s, u, res=None)``; ``rk4(s,
    u, res=None)`` is one classic RK4 step of length ``h``. A field of
    ``params`` may be a ``(B,)`` tensor, one value per member, for ``(B,)``
    columns."""
    g, m_ = _constant(params.gravity), _constant(params.mass)
    kl, ka = _constant(params.k_drag_linear), _constant(params.k_drag_angular)
    ix, iy, iz = (_constant(v) for v in params.inertia_diag)
    wx, wy, wz = (_constant(v) for v in params.wind)
    h = float(h)

    def deriv(s, u, res=None):
        vx, vy, vz = s[3], s[4], s[5]
        phi, th, psi = s[6], s[7], s[8]
        p, q, r = s[9], s[10], s[11]
        T = u[0]
        sphi, cphi = torch.sin(phi), torch.cos(phi)
        sth, cth = torch.sin(th), torch.cos(th)
        spsi, cpsi = torch.sin(psi), torch.cos(psi)
        # R[:, 2] of Rz Ry Rx
        r02 = cphi * sth * cpsi + sphi * spsi
        r12 = cphi * sth * spsi - sphi * cpsi
        r22 = cphi * cth
        ax_, ay_, az_ = vx - wx, vy - wy, vz - wz
        sq = ax_ * ax_ + ay_ * ay_ + az_ * az_
        pos = sq > 0.0
        speed = torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))),
                            torch.zeros_like(sq))
        accx = (T * r02 - kl * speed * ax_) / m_
        accy = (T * r12 - kl * speed * ay_) / m_
        accz = (T * r22 - kl * speed * az_) / m_ - g
        eps = torch.where(cth < 0.0, torch.full_like(cth, -1e-6), torch.full_like(cth, 1e-6))
        cth_safe = torch.where(torch.abs(cth) < 1e-6, eps, cth)
        tth = torch.tan(th)
        dphi = p + q * sphi * tth + r * cphi * tth
        dth = q * cphi - r * sphi
        dpsi = (q * sphi + r * cphi) / cth_safe
        gyx = q * (iz * r) - r * (iy * q)
        gyy = r * (ix * p) - p * (iz * r)
        gyz = p * (iy * q) - q * (ix * p)
        dp = (u[1] - gyx - ka * p) / ix
        dq = (u[2] - gyy - ka * q) / iy
        dr = (u[3] - gyz - ka * r) / iz
        d = (vx, vy, vz, accx, accy, accz, dphi, dth, dpsi, dp, dq, dr)
        if res is None:
            return d
        return tuple(d[i] + res[i] for i in range(12))

    def axpy(s, k, a):
        return tuple(s[i] + a * k[i] for i in range(12))

    def rk4(s, u, res=None):
        k1 = deriv(s, u, res)
        k2 = deriv(axpy(s, k1, 0.5 * h), u, res)
        k3 = deriv(axpy(s, k2, 0.5 * h), u, res)
        k4 = deriv(axpy(s, k3, h), u, res)
        return tuple(s[i] + (h / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i])
                     for i in range(12))

    return deriv, rk4


def rigid_body_rollout_plain(x0: torch.Tensor, controls: torch.Tensor, params: RigidBodyParams,
                             dt: float, substeps: int = 1,
                             residuals: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K10 in the inputs' dtype: the ``(n, 12)`` states
    after each of the n steps; with a leading member axis (``x0 (B, 12)``,
    ``controls (B, n, 4)``, the fields of ``params`` numbers or ``(B,)``)
    each member's ``(B, n, 12)``."""
    _, rk4 = make_plant_math(float(dt) / substeps, params)
    s = tuple(x0[..., i] for i in range(12))
    rows = []
    for k in range(controls.shape[-2]):
        u = tuple(controls[..., k, j] for j in range(4))
        res = None if residuals is None else tuple(residuals[..., k, j] for j in range(12))
        for _ in range(substeps):
            s = rk4(s, u, res)
        rows.append(torch.stack(s, dim=-1))
    return torch.stack(rows, dim=-2)


class _RigidBody(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in
                ("mass", "gravity", "k_lin", "k_ang", "ix", "iy", "iz", "wx", "wy", "wz")]


class _RK4Step(ctypes.Structure):
    _fields_ = [("h", ctypes.c_float), ("half_h", ctypes.c_float), ("h6", ctypes.c_float)]


def rigid_body_struct(params: RigidBodyParams) -> _RigidBody:
    """The kernels' ``RigidBody`` argument (``csrc/rigid_math.cuh``)."""
    return _RigidBody(params.mass, params.gravity, params.k_drag_linear, params.k_drag_angular,
                      *params.inertia_diag, *params.wind)


def rigid_body_block(params: RigidBodyParams, members: int, device=None) -> torch.Tensor:
    """``(members, 10)`` float32 rows laid out as ``RigidBody`` (K10's
    per-member bodies): each field a number shared by every member or a
    ``(members,)`` tensor."""
    fields = (params.mass, params.gravity, params.k_drag_linear, params.k_drag_angular,
              *params.inertia_diag, *params.wind)
    col = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device).expand(members)
    return torch.stack([col(v) for v in fields], dim=1).contiguous()


def rk4_step_struct(h: float) -> _RK4Step:
    """The kernels' ``RK4Step``: h, h / 2 and h / 6 from double arithmetic."""
    h = float(h)
    return _RK4Step(h, 0.5 * h, h / 6.0)


def rigid_body_rollout_fused(
    x0: torch.Tensor,                 # (12,) or (B, 12)
    controls: torch.Tensor,           # (n, 4) / (B, n, 4) per-step [T, tau x3]
    params: RigidBodyParams,
    dt: float,
    substeps: int = 1,
    residuals: torch.Tensor | None = None,   # (n, 12) / (B, n, 12) derivative residuals
) -> torch.Tensor:
    """n sequential RK4 steps in one launch (K10, one warp), in float32: the
    ``(n, 12)`` states after each step. ``substeps`` subdivides each step's
    dt (zero-order-hold controls). With a leading member axis on ``x0``
    (``(B, 12)``) the controls and residuals carry it too, each field of
    ``params`` is a number or a ``(B,)`` tensor (each member's own body),
    and the launch is a grid of one warp per member: ``(B, n, 12)``."""
    dev = x0.device
    n = controls.shape[-2]
    batch = tuple(x0.shape[:-1])
    x = x0.to(torch.float32).contiguous()
    u = controls.to(torch.float32).contiguous()
    res = None if residuals is None else residuals.to(torch.float32).contiguous()
    _cuda.require(x, "x0", batch + (12,), dev)
    _cuda.require(u, "controls", batch + (n, 4), dev)
    if res is not None:
        _cuda.require(res, "residuals", batch + (n, 12), dev)
    if dev.type == "cpu":
        return rigid_body_rollout_plain(x, u, params, dt, substeps, res)
    if dev.type != "cuda":
        raise ValueError(f"rigid_body_rollout_fused runs on cuda or cpu, not {dev}")
    out = torch.empty(*batch, n, 12, dtype=torch.float32, device=dev)
    step = rk4_step_struct(float(dt) / substeps)
    lib = _cuda.library("rigid_plant")
    if batch:
        bodies = rigid_body_block(params, batch[0], dev)
        fn = lib.rigid_rollout_batched_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.POINTER(_RK4Step), ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        status = fn(_cuda.ptr(x), _cuda.ptr(u), None if res is None else _cuda.ptr(res),
                    _cuda.ptr(out), n, int(substeps), batch[0], ctypes.byref(step),
                    _cuda.ptr(bodies), _cuda.stream_of(x))
    else:
        fn = lib.rigid_rollout_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.POINTER(_RK4Step),
                                               ctypes.POINTER(_RigidBody), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        status = fn(_cuda.ptr(x), _cuda.ptr(u), None if res is None else _cuda.ptr(res),
                    _cuda.ptr(out), n, int(substeps), ctypes.byref(step),
                    ctypes.byref(rigid_body_struct(params)), _cuda.stream_of(x))
    _cuda.check(status, "rigid_body_rollout_fused")
    _cuda.count_launch("rigid_body_rollout_fused")
    return out


def rigid_body_rk4_step_fused(state: torch.Tensor, control: torch.Tensor,
                              params: RigidBodyParams, dt: float, substeps: int = 1,
                              residual: torch.Tensor | None = None) -> torch.Tensor:
    """One (substepped) RK4 plant step as one launch of K10, in float32;
    with a leading member axis, every member's step in one launch."""
    res = None if residual is None else residual[..., None, :]
    return rigid_body_rollout_fused(state, control[..., None, :], params, dt, substeps=substeps,
                                    residuals=res)[..., 0, :]


def rigid_body_rk4_step_fast(state: torch.Tensor, control: torch.Tensor,
                             params: RigidBodyParams, dt: float, substeps: int = 1,
                             residual: torch.Tensor | None = None,
                             plain_kernels: bool = False) -> torch.Tensor:
    """The flights' plant step: K10 for a CUDA state (float32, cast back
    to the state's dtype), ``substeps`` model RK4 steps in the state's
    dtype for a CPU one or with ``plain_kernels=True``."""
    if state.device.type == "cuda" and not plain_kernels:
        return rigid_body_rk4_step_fused(state, control, params, dt, substeps,
                                         residual).to(state.dtype)
    x = state
    for _ in range(substeps):
        x = rigid_body_rk4_step(x, control, params, dt / substeps, residual=residual)
    return x
