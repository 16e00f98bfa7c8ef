"""The MPPI sampling kernel K12 (port of ``ops/mppi_pallas.py``).

``mppi_rollout_costs_fused`` runs MPPI's whole sampling stage in one launch
of ``csrc/mppi_kernels.cu``: K candidate control sequences rolled through N
RK4 steps of the 12-state rigid body (``csrc/rigid_math.cuh``, the math of
K10) from one start state, each step's tracking cost summed, plus the
terminal term. Only the ``(K,)`` costs leave the kernel; the softmax and the
update stay in PyTorch (``control.mppi``).

``mppi_rollout_costs_plain`` is its plain version: the same expressions
(``ops.rigid_plant_pallas.make_plant_math``) on ``(K,)`` tensors, in the
inputs' dtype. The wrapper takes it only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.

Layout: the candidates stay ``(K, N, 4)`` row-major, as the controller
draws them; no transpose per tick. A group of ``K12_LANES_PER_SAMPLE``
lanes rolls one sample, every lane carrying the whole state, and spreads
each derivative's sines, cosines and quotients over its lanes
(``RIGID_SINCOS_LANES``, ``RIGID_QUOTIENT_LANES``: the lane table of
``csrc/rigid_math.cuh:rigid_derivative_warp``). Before its steps the group
copies its sample's row (N * 16 bytes) into shared memory, each lane a share
of the 16-byte loads, so no global load waits on a step.
``mppi_launch_geometry`` sizes the launch; any sample count launches (a
group past K reads the last sample and writes nothing).
``mppi_section_cycles`` reads the ``mppi_clocks`` build's cycles per RK4
step and per derivative.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.params import RigidBodyParams
from . import _cuda
from .rigid_plant_pallas import make_plant_math, rigid_body_struct, rk4_step_struct, _RigidBody, _RK4Step

K12_LANES_PER_SAMPLE = 8   # csrc/mppi_kernels.cu kLanes
K12_THREADS = 64           # two warps, 8 samples a block (csrc/mppi_kernels.cu kMaxThreads)

# csrc/rigid_math.cuh:rigid_derivative_warp's lane table: lane i of a group
# forms the sine and cosine of RIGID_SINCOS_LANES[i] and the quotient
# RIGID_QUOTIENT_LANES[i] (numerator over denominator, as rigid_derivative
# divides), which the group's shuffles read from that lane; the other lanes
# repeat a neighbour's work (rigid_lane_roles), unread.
RIGID_SINCOS_LANES = ("phi", "theta", "psi")
RIGID_QUOTIENT_LANES = ("accel_x", "accel_y", "accel_z", "psi_dot", "p_dot", "q_dot", "r_dot")


def rigid_lane_roles(lane: int) -> tuple[str, str]:
    """The Euler angle whose sine and cosine lane ``lane`` of a group forms
    and the quotient it divides (``lane % 3``, ``min(lane & 7, 6)`` in the
    kernel)."""
    return RIGID_SINCOS_LANES[lane % 3], RIGID_QUOTIENT_LANES[min(lane & 7, 6)]


def mppi_launch_geometry(K: int) -> tuple[int, int]:
    """K12's launch for ``K`` samples, as ``mppi_rollout_costs_fused``
    passes it to ``csrc/mppi_kernels.cu``: ``(blocks, threads a block)``, a
    group of 8 lanes per sample, 8 samples a block (64 blocks at K=512)."""
    if K < 1:
        raise ValueError(f"mppi_rollout_costs_fused needs at least one sample, got {K}")
    return -(-K // (K12_THREADS // K12_LANES_PER_SAMPLE)), K12_THREADS


MPPI_SECTIONS = ("staging", "rk4 steps", "derivatives", "whole")


def mppi_section_cycles() -> dict[str, float]:
    """K12's clock cycles since the last call, counted by lane 0 of each
    sample's group in the ``mppi_clocks`` build: per RK4 step, per
    derivative (one more evaluation a step at the step's end state, timed
    alone with its outputs waited for), and per sample the staging of its
    controls and the whole rollout (the timed derivatives included). Call
    inside ``_cuda.library_variant("mppi", "mppi_clocks")`` after the
    launches, synchronised; the first call only resets them."""
    raw = _cuda.section_cycles("mppi", "mppi_section_cycles", MPPI_SECTIONS + ("steps", "samples"))
    steps, samples = max(raw["steps"], 1), max(raw["samples"], 1)
    return {"RK4 step": raw["rk4 steps"] / steps, "derivative": raw["derivatives"] / steps,
            "staging a sample": raw["staging"] / samples,
            "whole sample": raw["whole"] / samples}


def mppi_rollout_costs_plain(x0: torch.Tensor, U_cand: torch.Tensor, targets: torch.Tensor,
                             target_yaw, params: RigidBodyParams, dt: float, u_hover,
                             weights) -> torch.Tensor:
    """Plain version of K12 in the inputs' dtype: ``(K,)`` costs."""
    q_pos, q_vel, q_att, q_yaw, q_rate, r0, r1, r2, r3, terminal_weight = (float(w) for w in weights)
    uh = _floats(u_hover)
    _, rk4 = make_plant_math(dt, params)
    K, N, _ = U_cand.shape
    s = tuple(x0[i].expand(K) for i in range(12))
    yaw = torch.as_tensor(target_yaw, dtype=x0.dtype, device=x0.device)
    c = torch.zeros(K, dtype=x0.dtype, device=x0.device)
    for i in range(N):
        u = tuple(U_cand[:, i, j] for j in range(4))
        s = rk4(s, u)
        ex, ey, ez = s[0] - targets[i, 0], s[1] - targets[i, 1], s[2] - targets[i, 2]
        du = [u[j] - uh[j] for j in range(4)]
        dyaw = torch.remainder(s[8] - yaw + math.pi, 2.0 * math.pi) - math.pi
        c = c + (q_pos * (ex * ex + ey * ey + ez * ez)
                 + q_vel * (s[3] * s[3] + s[4] * s[4] + s[5] * s[5])
                 + q_att * (s[6] * s[6] + s[7] * s[7])
                 + q_yaw * dyaw * dyaw
                 + q_rate * (s[9] * s[9] + s[10] * s[10] + s[11] * s[11])
                 + r0 * du[0] * du[0] + r1 * du[1] * du[1]
                 + r2 * du[2] * du[2] + r3 * du[3] * du[3])
    ex, ey, ez = s[0] - targets[-1, 0], s[1] - targets[-1, 1], s[2] - targets[-1, 2]
    return c + (terminal_weight - 1.0) * (q_pos * (ex * ex + ey * ey + ez * ez)
                                          + q_vel * (s[3] * s[3] + s[4] * s[4] + s[5] * s[5]))


def _floats(v) -> tuple:
    return tuple(float(a) for a in (v.tolist() if torch.is_tensor(v) else v))


class _MppiCost(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in
                ("q_pos", "q_vel", "q_att", "q_yaw", "q_rate", "r0", "r1", "r2", "r3",
                 "terminal_scale", "uh0", "uh1", "uh2", "uh3")]


def mppi_rollout_costs_fused(
    x0: torch.Tensor,          # (12,)
    U_cand: torch.Tensor,      # (K, N, 4) clipped candidate sequences
    targets: torch.Tensor,     # (N, 3) per-stage positions
    target_yaw: torch.Tensor,  # () target yaw
    params: RigidBodyParams,
    dt: float,
    u_hover,                   # (4,) hover control: a sequence of floats or a tensor
    weights,                   # (q_pos, q_vel, q_att, q_yaw, q_rate, r0..r3, terminal_weight)
) -> torch.Tensor:
    """All K rollout costs in one launch of K12, in float32: ``(K,)``."""
    dev = x0.device
    K, N, _ = U_cand.shape
    x = x0.to(torch.float32).contiguous()
    U = U_cand.to(torch.float32).contiguous()
    tg = targets.to(torch.float32).contiguous()
    yaw = torch.as_tensor(target_yaw, dtype=torch.float32, device=dev).reshape(()).contiguous()
    _cuda.require(x, "x0", (12,), dev)
    _cuda.require(U, "U_cand", (K, N, 4), dev)
    _cuda.require(tg, "targets", (N, 3), dev)
    if dev.type == "cpu":
        return mppi_rollout_costs_plain(x, U, tg, yaw, params, dt, u_hover, weights)
    if dev.type != "cuda":
        raise ValueError(f"mppi_rollout_costs_fused runs on cuda or cpu, not {dev}")
    _cuda.require_aligned("mppi_rollout_costs_fused", U)
    w = [float(v) for v in weights]
    cost = _MppiCost(*w[:9], w[9] - 1.0, *_floats(u_hover))
    out = torch.empty(K, dtype=torch.float32, device=dev)
    fn = _cuda.library("mppi").mppi_costs_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.POINTER(_RK4Step),
                                           ctypes.POINTER(_RigidBody), ctypes.POINTER(_MppiCost),
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    step, body = rk4_step_struct(dt), rigid_body_struct(params)
    blocks, threads = mppi_launch_geometry(K)
    status = fn(_cuda.ptr(x), _cuda.ptr(U), _cuda.ptr(tg), _cuda.ptr(yaw), _cuda.ptr(out), K, N,
                ctypes.byref(step), ctypes.byref(body), ctypes.byref(cost), blocks, threads,
                _cuda.stream_of(x))
    _cuda.check(status, "mppi_rollout_costs_fused")
    _cuda.count_launch("mppi_rollout_costs_fused")
    return out
