"""The plant kernels K1 and K2 (port of ``ops/plant_pallas.py``).

K1 ``px4_plant_step_fused``: all RK4 substeps of the PX4 surrogate
(mixed-NED thrust, first-order body-rate lags, guarded Euler-rate
transform, airspeed drag ``v - wind``) in one launch.
K2 ``allocation_plant_tick_fused``: u0 command -> geometric allocation +
attitude PID (integral carried) -> K1.

Both take a batch (``csrc/plant_kernels.cu``; the device math lives in
``csrc/plant_math.cuh`` and is shared with K5): a group of 8 lanes per
state, 16 a block (``plant_geometry``).
Plant scalars are a row operand, not constants, so dispersed plants and
steady wind reuse one build: one (10,) row shared by the batch, or a
``(B, 10)`` block with one row per state (a Monte Carlo population's
dispersed plants; what the JAX package's ``vmap`` over traced plant rows
computes).

Beside each kernel is its plain PyTorch version (``_rk4_substeps``,
``_allocation`` below, an elementwise transcription of the same scalar
math). A wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .._device import resolve_device
from . import _cuda

# plant row lanes: [mass, gravity, k_drag_linear, tau_roll, tau_pitch,
#                   tau_yaw, thrust_gain, wind_x, wind_y, wind_z]
PLANT_LANES = 10


def build_plant_row(mass, gravity, k_drag_linear, taus, thrust_gain,
                    wind=(0.0, 0.0, 0.0), device=None) -> torch.Tensor:
    """Pack the plant scalars into the kernels' (10,) float32 row."""
    vals = (mass, gravity, k_drag_linear, taus[0], taus[1], taus[2],
            thrust_gain, wind[0], wind[1], wind[2])
    return torch.tensor([float(v) for v in vals], dtype=torch.float32,
                        device=resolve_device(device))


def _read_plant(plant_row: torch.Tensor):
    """The 10 plant scalars: 0-d tensors from a shared ``(10,)`` row, or
    ``(B,)`` columns from a ``(B, 10)`` block (both broadcast against the
    batch's state columns)."""
    return tuple(plant_row[..., i] for i in range(PLANT_LANES))


def _require_plant(plant_row, B: int, dev) -> int:
    """Check a shared ``(10,)`` row or a ``(B, 10)`` block; return the
    kernels' row stride (0 or 10)."""
    shape = (PLANT_LANES,) if plant_row.ndim == 1 else (B, PLANT_LANES)
    _cuda.require(plant_row, "plant_row", shape, dev)
    return 0 if plant_row.ndim == 1 else PLANT_LANES


def _derivative(s, c, plant):
    """Elementwise transcription of ``px4_surrogate._derivative`` on
    12-tuples of state columns and 4-tuples of control columns."""
    (mass, gravity, k_drag_linear, tau_r, tau_p, tau_y,
     thrust_gain, wx, wy, wz) = plant
    vx, vy, vz = s[3], s[4], s[5]
    phi, theta, psi = s[6], s[7], s[8]
    p, q, r = s[9], s[10], s[11]
    thrust_norm = c[0]

    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)

    # R[:, 2] with mixed-NED xy sign flip
    t0 = -(cphi * sth * cpsi + sphi * spsi)
    t1 = -(cphi * sth * spsi - sphi * cpsi)
    t2 = cphi * cth
    a_thrust = thrust_norm * thrust_gain

    # drag acts on the airspeed (v - wind)
    avx, avy, avz = vx - wx, vy - wy, vz - wz
    sq = avx * avx + avy * avy + avz * avz
    pos_sq = sq > 0.0
    speed = torch.where(pos_sq, torch.sqrt(torch.where(pos_sq, sq, 1.0)), 0.0)
    kd = k_drag_linear / mass
    ax = a_thrust * t0 - kd * speed * avx
    ay = a_thrust * t1 - kd * speed * avy
    az = a_thrust * t2 - kd * speed * avz - gravity

    tth = sth / cth
    eps = torch.where(cth < 0, torch.full_like(cth, -1e-6), torch.full_like(cth, 1e-6))
    cth_safe = torch.where(torch.abs(cth) < 1e-6, eps, cth)
    phi_dot = p + q * sphi * tth + r * cphi * tth
    theta_dot = q * cphi - r * sphi
    psi_dot = q * sphi / cth_safe + r * cphi / cth_safe

    p_dot = (c[1] - p) / tau_r
    q_dot = (c[2] - q) / tau_p
    r_dot = (c[3] - r) / tau_y

    return (vx, vy, vz, ax, ay, az, phi_dot, theta_dot, psi_dot, p_dot, q_dot, r_dot)


def _axpy(s, k, h):
    return tuple(s[i] + h * k[i] for i in range(12))


def _rk4_substeps(s, c, plant, dt, substeps):
    """RK4 substeps on tuples of state columns (the plain version of K1)."""
    h = dt / substeps
    for _ in range(substeps):
        k1 = _derivative(s, c, plant)
        k2 = _derivative(_axpy(s, k1, 0.5 * h), c, plant)
        k3 = _derivative(_axpy(s, k2, 0.5 * h), c, plant)
        k4 = _derivative(_axpy(s, k3, h), c, plant)
        s = tuple(
            s[i] + (h / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i])
            for i in range(12)
        )
    return s


def _jacobian(s, c, plant):
    """Elementwise transcription of ``px4_surrogate.derivative_jacobian``
    on a 12-tuple of 0-d state tensors: the (12, 12) continuous Jacobian
    that the noisy tick kernel K9 relinearises each tick (``csrc/
    plant_math.cuh:jacobian``). Unlike ``_derivative``, the phi row uses
    the guarded tangent ``sin/cth_safe``: identical for any bounded
    attitude, finite at the theta singularity."""
    (mass, gravity, k_drag_linear, tau_r, tau_p, tau_y,
     thrust_gain, wx, wy, wz) = plant
    vx, vy, vz = s[3], s[4], s[5]
    phi, theta, psi = s[6], s[7], s[8]
    q, r = s[10], s[11]
    zero, one = torch.zeros_like(phi), torch.ones_like(phi)

    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    eps = torch.where(cth < 0, torch.full_like(cth, -1e-6), torch.full_like(cth, 1e-6))
    cth_safe = torch.where(torch.abs(cth) < 1e-6, eps, cth)
    tth = sth / cth_safe
    sec = one / cth_safe
    sec2 = sec * sec

    # drag block: -(k/m)(speed I + av av'/speed), zero at zero airspeed
    avx, avy, avz = vx - wx, vy - wy, vz - wz
    sq = avx * avx + avy * avy + avz * avz
    pos = sq > 0.0
    inv_speed = torch.where(pos, one / torch.sqrt(torch.where(pos, sq, one)), zero)
    speed = sq * inv_speed
    kd = k_drag_linear / mass
    av = (avx, avy, avz)
    drag = [[-kd * ((speed if i == j else zero) + av[i] * av[j] * inv_speed) for j in range(3)]
            for i in range(3)]

    # thrust-direction derivatives wrt the Euler angles (mixed-NED signs)
    a_thrust = c[0] * thrust_gain
    dphi = (a_thrust * (sphi * sth * cpsi - cphi * spsi),
            a_thrust * (sphi * sth * spsi + cphi * cpsi),
            a_thrust * (-sphi * cth))
    dth = (a_thrust * (-cphi * cth * cpsi), a_thrust * (-cphi * cth * spsi),
           a_thrust * (-cphi * sth))
    dpsi = (a_thrust * (cphi * sth * spsi - sphi * cpsi),
            a_thrust * (-(cphi * sth * cpsi + sphi * spsi)), zero)

    z3 = (zero, zero, zero)
    rows = [
        z3 + (one, zero, zero) + z3 + z3,
        z3 + (zero, one, zero) + z3 + z3,
        z3 + (zero, zero, one) + z3 + z3,
        *(z3 + tuple(drag[i]) + (dphi[i], dth[i], dpsi[i]) + z3 for i in range(3)),
        z3 + z3 + (q * cphi * tth - r * sphi * tth, (q * sphi + r * cphi) * sec2, zero,
                   one, sphi * tth, cphi * tth),
        z3 + z3 + (-q * sphi - r * cphi, zero, zero, zero, cphi, -sphi),
        z3 + z3 + ((q * cphi - r * sphi) * sec, (q * sphi + r * cphi) * sth * sec2, zero,
                   zero, sphi * sec, cphi * sec),
        z3 + z3 + z3 + (-one / tau_r, zero, zero),
        z3 + z3 + z3 + (zero, -one / tau_p, zero),
        z3 + z3 + z3 + (zero, zero, -one / tau_y),
    ]
    return torch.stack([torch.stack(row) for row in rows])


def _wrap(a):
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def _allocation(s, cmd, integral, dt, gravity,
                kp=3.2, ki=0.6, kd=0.6, integral_max=0.3,
                thrust_ceiling=1.2):
    """Elementwise transcription of ``control.allocation.
    geometric_control_allocation``. ``cmd = (ax, ay, az, yawrate, yaw)``;
    ``thrust_ceiling`` may be a tensor (recovery modes raise it)."""
    ax, ay, az, yawrate_des, target_yaw = cmd[0], cmd[1], cmd[2], cmd[3], cmd[4]

    tvx, tvy, tvz = ax, ay, az + gravity
    tmag = torch.sqrt(tvx * tvx + tvy * tvy + tvz * tvz)
    thrust = torch.minimum(torch.clamp(tmag / gravity, min=0.25),
                           torch.as_tensor(thrust_ceiling, dtype=tmag.dtype, device=tmag.device))

    inv = 1.0 / torch.clamp(tmag, min=1e-9)
    pitch_cmd = -torch.asin(torch.clamp(tvx * inv, -0.4, 0.4))
    roll_cmd = torch.asin(torch.clamp(tvy * inv, -0.4, 0.4))
    degenerate = tmag <= 0.1
    pitch_cmd = torch.where(degenerate, 0.0, pitch_cmd)
    roll_cmd = torch.where(degenerate, 0.0, roll_cmd)

    e0 = _wrap(roll_cmd - s[6])
    e1 = _wrap(pitch_cmd - s[7])
    e2 = _wrap(target_yaw - s[8])

    i0 = torch.clamp(integral[0] + e0 * dt, -integral_max, integral_max)
    i1 = torch.clamp(integral[1] + e1 * dt, -integral_max, integral_max)
    i2 = torch.clamp(integral[2] + e2 * dt, -integral_max, integral_max)

    rollrate = torch.clamp(kp * e0 + ki * i0 - kd * s[9], -1.2, 1.2)
    pitchrate = torch.clamp(kp * e1 + ki * i1 - kd * s[10], -1.2, 1.2)
    yawrate = torch.clamp(yawrate_des + kp * e2 + ki * i2 - kd * s[11], -0.8, 0.8)

    control = (thrust, rollrate, pitchrate, yawrate)
    att_sp = (roll_cmd, pitch_cmd, target_yaw)
    return control, att_sp, (i0, i1, i2)


def _cols(x: torch.Tensor):
    return tuple(x[:, i] for i in range(x.shape[1]))


# ---------------------------------------------------------------------------
# K1: all plant substeps
# ---------------------------------------------------------------------------

LANES_PER_STATE = 8   # csrc/plant_kernels.cu kLanes
PLANT_THREADS = 128   # four warps a block


def plant_geometry(B: int) -> tuple[int, int]:
    """K1's and K2's launch for a batch of ``B`` states, as
    ``_px4_plant_rows`` and ``_allocation_plant_rows`` pass it to
    ``csrc/plant_kernels.cu``: ``(blocks, threads a block)``, a group of 8
    lanes per state, 16 states a block."""
    return -(-B // (PLANT_THREADS // LANES_PER_STATE)), PLANT_THREADS


def px4_plant_step_plain(state, control, plant_row, dt: float, substeps: int):
    """Plain version of K1: ``state (B, 12)``, ``control (B, 4)``,
    ``plant_row (10,)`` or ``(B, 10)`` float32 -> ``(B, 12)``."""
    s = _rk4_substeps(_cols(state), _cols(control), _read_plant(plant_row), dt, substeps)
    return torch.stack(s, dim=1)


def _px4_plant_rows(state, control, plant_row, dt: float, substeps: int):
    dev = state.device
    B = state.shape[0]
    _cuda.require(state, "state", (B, 12), dev)
    _cuda.require(control, "control", (B, 4), dev)
    plant_stride = _require_plant(plant_row, B, dev)
    if dev.type == "cpu":
        return px4_plant_step_plain(state, control, plant_row, dt, substeps)
    if dev.type != "cuda":
        raise ValueError(f"px4_plant_step_fused runs on cuda or cpu, not {dev}")
    lib = _cuda.library("plant")
    fn = lib.px4_plant_step_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_double] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(state)
    blocks, threads = plant_geometry(B)
    status = fn(_cuda.ptr(state), _cuda.ptr(control), _cuda.ptr(plant_row),
                _cuda.ptr(out), B, float(dt), int(substeps), plant_stride, blocks, threads,
                _cuda.stream_of(state))
    _cuda.check(status, "px4_plant_step_fused")
    _cuda.count_launch("px4_plant_step_fused")
    return out


def px4_plant_step_fused(
    state: torch.Tensor,     # (12,) or (B, 12)
    control: torch.Tensor,   # (4,) or (B, 4)
    mass,
    gravity,
    k_drag_linear,
    taus,
    dt: float,
    substeps: int = 2,
    thrust_gain=None,        # g / hover_thrust_norm; None -> g
    wind=(0.0, 0.0, 0.0),
) -> torch.Tensor:
    """All RK4 substeps of the surrogate plant in one launch (K1), in
    float32. Returns the new state with ``state``'s batch shape."""
    single = state.ndim == 1
    srow = state.reshape(-1, 12).to(torch.float32).contiguous()
    crow = control.reshape(-1, 4).to(torch.float32).contiguous()
    prow = build_plant_row(mass, gravity, k_drag_linear, taus,
                           gravity if thrust_gain is None else thrust_gain, wind,
                           device=state.device)
    out = _px4_plant_rows(srow, crow, prow, dt, substeps)
    return out[0] if single else out


# ---------------------------------------------------------------------------
# K2: allocation + attitude PID + plant substeps
# ---------------------------------------------------------------------------


def allocation_plant_tick_plain(state, cmd, integral, plant_row, dt: float, substeps: int):
    """Plain version of K2: ``state (B, 12)``, ``cmd (B, 6)`` =
    ``[ax, ay, az, yawrate, yaw, thrust_ceiling]``, ``integral (B, 3)``,
    ``plant_row (10,)`` or ``(B, 10)`` -> ``(state (B, 12), control+att_sp (B, 7),
    integral (B, 3))``."""
    s = _cols(state)
    cm = _cols(cmd)
    plant = _read_plant(plant_row)
    c, att_sp, new_int = _allocation(s, cm[0:5], _cols(integral), dt, plant[1],
                                     thrust_ceiling=cm[5])
    s = _rk4_substeps(s, c, plant, dt, substeps)
    return (torch.stack(s, dim=1), torch.stack(c + att_sp, dim=1),
            torch.stack(new_int, dim=1))


def _allocation_plant_rows(state, cmd, integral, plant_row, dt: float, substeps: int):
    dev = state.device
    B = state.shape[0]
    _cuda.require(state, "state", (B, 12), dev)
    _cuda.require(cmd, "cmd", (B, 6), dev)
    _cuda.require(integral, "integral", (B, 3), dev)
    plant_stride = _require_plant(plant_row, B, dev)
    if dev.type == "cpu":
        return allocation_plant_tick_plain(state, cmd, integral, plant_row, dt, substeps)
    if dev.type != "cuda":
        raise ValueError(f"allocation_plant_tick_fused runs on cuda or cpu, not {dev}")
    lib = _cuda.library("plant")
    fn = lib.allocation_plant_tick_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_double] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out_state = torch.empty_like(state)
    out_ctrl = torch.empty(B, 7, dtype=torch.float32, device=dev)
    out_int = torch.empty_like(integral)
    blocks, threads = plant_geometry(B)
    status = fn(_cuda.ptr(state), _cuda.ptr(cmd), _cuda.ptr(integral), _cuda.ptr(plant_row),
                _cuda.ptr(out_state), _cuda.ptr(out_ctrl), _cuda.ptr(out_int),
                B, float(dt), int(substeps), plant_stride, blocks, threads,
                _cuda.stream_of(state))
    _cuda.check(status, "allocation_plant_tick_fused")
    _cuda.count_launch("allocation_plant_tick_fused")
    return out_state, out_ctrl, out_int


def allocation_plant_tick_fused(
    state: torch.Tensor,        # (12,) or (B, 12)
    accel_des: torch.Tensor,    # (3,) or (B, 3), already clipped
    yawrate_des,                # () or (B,)
    target_yaw,                 # () or (B,)
    att_integral: torch.Tensor,  # (3,) or (B, 3)
    mass,
    gravity,
    k_drag_linear,
    taus,
    dt: float,
    substeps: int = 2,
    thrust_gain=None,
    wind=(0.0, 0.0, 0.0),
    thrust_ceiling=1.2,
):
    """Geometric allocation + attitude PID + all plant RK4 substeps in one
    launch (K2), in float32.

    Returns ``(new_state, control4, att_setpoint3, new_integral3)`` with the
    input's batch shape."""
    single = state.ndim == 1
    dev = state.device
    f32 = dict(dtype=torch.float32, device=dev)
    srow = state.reshape(-1, 12).to(torch.float32).contiguous()
    B = srow.shape[0]
    col = lambda v: torch.as_tensor(v, **f32).reshape(-1, 1).expand(B, 1)
    cmd = torch.cat(
        [accel_des.reshape(-1, 3).to(torch.float32).expand(B, 3),
         col(yawrate_des), col(target_yaw), col(thrust_ceiling)], dim=1
    ).contiguous()
    irow = att_integral.reshape(-1, 3).to(torch.float32).expand(B, 3).contiguous()
    prow = build_plant_row(mass, gravity, k_drag_linear, taus,
                           gravity if thrust_gain is None else thrust_gain, wind,
                           device=dev)
    new_state, ctrl, new_int = _allocation_plant_rows(srow, cmd, irow, prow, dt, substeps)
    out = (new_state, ctrl[:, 0:4], ctrl[:, 4:7], new_int)
    return tuple(o[0] for o in out) if single else out
