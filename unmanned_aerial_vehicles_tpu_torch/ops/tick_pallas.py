"""The fused tick kernels K4, K5 and K9 (port of ``ops/tick_pallas.py``:
``FusedTickData``, ``build_tick_data``, ``build_shift_matrix``,
``gpmpc_tick_fused``, ``GPRows``, ``build_gp_rows``,
``gpmpc_multitick_fused``, ``EKF_MEAS_IDX``, ``build_dob_bdist`` and
``gpmpc_noisy_multitick_fused``).

K4 ``gpmpc_tick_fused`` runs one whole control tick of one flight: the
warm-start shift, the fused controller of K3 (``ops.controller_pallas``) on
the controller state ``ctrl_state`` with the state boxes backed off by the
``tight`` row, the u0 clips and hover fallback, allocation + attitude PID,
and the plant's RK4 substeps on ``state``. The kernel is
``csrc/single_tick_kernels.cu`` (``gpmpc_tick_kernel``: one block of 512
threads running K5's shift, solve and scalar section, P1's copy into shared
memory overlapping the solve's phases before the ADMM); its plain version
is ``gpmpc_tick_fused_plain`` below. Packed row lanes (25): next state 0:12,
control 12:16, att_sp 16:19, integral 19:22, accel_cmd 22:25.

K5 ``gpmpc_multitick_fused`` runs K whole control ticks of one flight in
one launch. Each tick:

    GP horizon posterior mean from the previous solution's features
    z, y   <- shifted warm start
    offset = Sx x0 + Sw w,  f = Su'Q (offset - ref),  box bounds
    ADMM loop (one (m, m) matvec per iteration)
    U = M^-1(-f + G'(rho z - y)),  X_tail = offset + Su U
    u0 clips (+ hover fallback) -> allocation + attitude PID -> plant RK4

With ``tighten_kappa > 0`` (GP rows built ``with_variance=True``) each
tick also forms the GP's posterior variance at the horizon's features from
the cached ``K^-1`` and backs the state boxes off:

    var_lat[k] = max(prior - K*_k K^-1 K*_k', 1e-10)
    sig[k, 3+j] = gain^2 var_lat[k] y_std[3+j]^2,   var_x = sig @ SwSqT
    tight = min(kappa sqrt(var_x), 0.45 (x_hi - x_lo))   (state block)

The kernel is ``csrc/tick_kernel.cu`` (one thread block per flight, the K
ticks looped inside the block, P1 resident in shared memory). Its plain
PyTorch version is ``multitick_staged`` below, a port of the JAX package's
own block-for-block XLA twin (``ops/tick_ad.py:multitick_staged``). The
wrapper ``gpmpc_multitick_fused`` takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.

Shapes are semantic (no 128-lane padding): ``N`` stages, ``Nnu = N nu``,
``Nnx = N nx``, ``m = Nnu + Nnx``. Carries: ``state (12,)``,
``aux (9,) = [previous x0 (6), attitude integral (3)]``, ``xtail (Nnx,)``,
``z, y (m,)``. ``packed (K, 32)`` lanes: state 0:12, control 12:16,
att_sp 16:19, integral 19:22, accel_cmd 22:25, u_mpc 25:29, vel_ref 29:32.

K9 ``gpmpc_noisy_multitick_fused`` is K5 with the EKF inside: each tick
first predicts and fuses the noisy measurement of the truth (the 12-state
filter, or the 15-state disturbance observer), then flies K5's tick on the
estimate while the plant integrates the truth. The kernel is
``csrc/noisy_tick_kernel.cu``; its plain version is
``noisy_multitick_staged``. Carries: ``est (12|15,)``, ``P (12|15,
12|15)``, ``aux (13,)``; ``packed (K, 47)``.

K4 and K5 also take a leading flight axis on every per-flight operand (a
population: ``loop.closed_loop.batched_mpc_flight_rollout``): the launch is
a grid of one block per flight, the operators, references (and K5's GP
rows) shared, each block bit-identical to a one-flight launch; their plain
versions map the one-flight version over the flights.

``loop_precision`` (and K9's ``cov_precision``) are accepted for the JAX
signature; on the card every mode computes in float32 with FMAs (the
bfloat16 modes were TPU matrix-unit choices).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from . import _cuda
from .controller_pallas import (
    FusedControllerData,
    controller_plain,
    factors_reproduce_p1,
    launch_single_tick,
    require_tick_data,
)
from .plant_pallas import (
    PLANT_LANES,
    _allocation,
    _axpy,
    _derivative,
    _jacobian,
    _read_plant,
    _rk4_substeps,
    _wrap,
)

PACKED_LANES = 32
TICK_PACKED_LANES = 25   # K4's packed row
AUX_LANES = 9
KERNEL_THREADS = 512        # csrc/tick_kernel.cu kThreads: K5's block
TIGHT_KERNEL_THREADS = 256  # kTightThreads: each block of the tightened K5's cluster
GP_GROUP = 8                # kGpGroup: lanes whose GP sums meet in a shuffle tree (K5, K9)
TIGHT_GP_GROUP = 1          # the same on the tightened K5's 256 threads
GP_STAGES = 4               # kGpStages: horizon stages per GP thread (K5)
NOISY_GP_STAGES = 2         # the same in K9 (csrc/noisy_tick_kernel.cu)
SINGLE_TICK_THREADS = 512   # csrc/single_tick_kernels.cu kTickThreads: K4's block


class FusedTickData(NamedTuple):
    """Device float32 operands of the fused controller and tick kernels K3,
    K4 and K5 (row form)."""

    ctrl: FusedControllerData   # host source of the operands below
    ShiftT: torch.Tensor        # (m, m) warm-start shift: z_new = z @ ShiftT
    SxSwT: torch.Tensor         # (nx + Nnx, Nnx): offset = [x0, w] @ SxSwT
    SuTqT: torch.Tensor         # (Nnx, Nnu)
    PM: torch.Tensor            # (Nnu, m + Nnu) = [P0mat | MinvT]
    P1: torch.Tensor            # (m, m)
    P0matT: torch.Tensor        # (m, Nnu)
    SuT: torch.Tensor           # (Nnu, Nnx)
    lo_row: torch.Tensor        # (m,) = u_lo_row + x_lo_row (disjoint blocks)
    hi_row: torch.Tensor        # (m,)
    SwSqT: torch.Tensor         # (Nnx, Nnx) = SwT**2: disturbance-variance propagation
    Nnu: int
    Nnx: int
    # P1 = P0matT @ [I | SuT] (G = [I; Su]): K3 applies P1 as these factors
    factored: bool = True


def build_shift_matrix(N: int, nu: int, nx: int) -> np.ndarray:
    """Row-form shift: ``z_new = z_old @ ShiftT`` moves each stage block
    one stage forward and repeats the last stage (U and X blocks alike)."""

    def block(width):
        n = N * width
        S = np.zeros((n, n), np.float32)
        for i in range((N - 1) * width):
            S[i, i + width] = 1.0       # new[k] = old[k+1]
        for i in range((N - 1) * width, n):
            S[i, i] = 1.0               # new[N-1] = old[N-1]
        return S.T

    m = N * (nu + nx)
    out = np.zeros((m, m), np.float32)
    out[: N * nu, : N * nu] = block(nu)
    out[N * nu :, N * nu :] = block(nx)
    return out


def build_tick_data(ctrl: FusedControllerData, N: int, nu: int, nx: int,
                    device=None) -> FusedTickData:
    """Stack the controller operands into the kernel's layouts on ``device``."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    return FusedTickData(
        ctrl=ctrl,
        ShiftT=t(build_shift_matrix(N, nu, nx)),
        SxSwT=t(np.concatenate([ctrl.SxT, ctrl.SwT], axis=0)),
        SuTqT=t(ctrl.SuTqT),
        PM=t(np.concatenate([ctrl.P0mat, ctrl.MinvT], axis=1)),
        P1=t(ctrl.P1),
        P0matT=t(ctrl.P0matT),
        SuT=t(ctrl.SuT),
        lo_row=t(ctrl.u_lo_row + ctrl.x_lo_row),
        hi_row=t(ctrl.u_hi_row + ctrl.x_hi_row),
        SwSqT=t(np.asarray(ctrl.SwT, np.float32) ** 2),
        Nnu=N * nu,
        Nnx=N * nx,
        factored=factors_reproduce_p1(ctrl),
    )


class GPRows(NamedTuple):
    """GP-posterior operands of the kernel (rebuilt whenever the posterior
    changes: once per flight for a frozen GP, at every refit online)."""

    ztrT: torch.Tensor     # (d, P) length-scaled training inputs, transposed
    sq2: torch.Tensor      # (P,)   per-training-point squared norms
    alpha_s: torch.Tensor  # (P, 6) alpha * y_std
    y_mean: torch.Tensor   # (6,)
    inv_ls: torch.Tensor   # (2, d): row 0 = 1/ls, row 1 = x_shift/ls
    scal: torch.Tensor     # (3,) = [signal_variance, gain, prior variance]
    kinv: torch.Tensor | None = None    # (P, P) K^-1 (with_variance)
    y_std: torch.Tensor | None = None   # (6,) (with_variance)


def build_gp_rows(posterior, gain: float, control_dt: float = 0.02, gp_dt: float = 0.02,
                  with_variance: bool = False) -> GPRows:
    """Pack a ``gp.exact_gp.GPPosterior`` for the kernel (float32, on the
    posterior's device). The kernel computes
    ``w[k, 3:6] = gain (control_dt / gp_dt) posterior_mean[k, 3:6]``.
    ``with_variance`` also caches ``K^-1`` (``cholesky_solve`` of the
    identity against the posterior's factor, in its dtype) and ``y_std``,
    the operands of the posterior variance ``prior - K* K^-1 K*'``
    (``predict``'s ``include_noise_in_variance`` semantics)."""
    f32 = torch.float32
    X = posterior.X_train.to(f32)                     # (P, d)
    P, d = X.shape
    ls = posterior.params.length_scale.to(f32).expand(d)
    Z = X / ls
    inv_ls = torch.zeros(2, d, dtype=f32, device=X.device)
    inv_ls[0] = 1.0 / ls
    if posterior.x_shift is not None:
        inv_ls[1] = posterior.x_shift.to(f32) / ls
    sf2 = posterior.params.signal_variance.to(f32)
    noise = posterior.params.noise_variance.to(f32)
    g = torch.tensor(gain * (control_dt / gp_dt), dtype=f32, device=X.device)
    kinv = y_std = None
    if with_variance:
        chol = posterior.chol
        eye = torch.eye(P, dtype=chol.dtype, device=chol.device)
        kinv = torch.cholesky_solve(eye, chol).to(f32).contiguous()
        y_std = posterior.y_std.to(f32).contiguous()
    return GPRows(
        ztrT=Z.T.contiguous(),
        sq2=torch.sum(Z * Z, dim=1).contiguous(),
        alpha_s=(posterior.alpha.to(f32) * posterior.y_std.to(f32)[None, :]).contiguous(),
        y_mean=posterior.y_mean.to(f32).contiguous(),
        inv_ls=inv_ls,
        scal=torch.stack([sf2, g, sf2 + noise]),
        kinv=kinv,
        y_std=y_std,
    )


def _uses_tightening(use_gp, gp, tighten_kappa) -> bool:
    """Whether a K5 launch forms the variance and backs the boxes off: only
    with the GP on, and then its rows must carry the variance operands."""
    if not (use_gp and tighten_kappa > 0.0):
        return False
    if gp is None or gp.kinv is None or gp.y_std is None:
        raise ValueError("tighten_kappa > 0 needs GP rows built with_variance=True "
                         "(build_gp_rows(..., with_variance=True))")
    return True


def _check_statics(n, nu, nx):
    if (nu, nx) != (4, 6):
        raise ValueError(f"the tick kernel is built for nu=4, nx=6 (got {nu}, {nx})")
    if n < 1:
        raise ValueError("horizon n must be >= 1")


def command_plant_plain(z, ref, sc, s, yaw_ref, integral, plant, *, dt, substeps,
                        accel_lo, accel_hi, yawrate_limit, fallback_error_m=0.0,
                        fallback_thrust_ceiling=1.5, fallback_accel_scale=1.5):
    """The scalar section of K4 and K5 in PyTorch tensor ops: the first
    stage of the slack's U-block clipped, the hover fallback when the
    controller state ``sc`` is farther than ``fallback_error_m`` from
    ``ref[0:3]``, allocation + attitude PID on ``sc`` and the plant's RK4
    substeps on ``s`` (both 12-tuples of 0-d tensors). Returns
    ``(next state, control, att_sp, integral, accel_cmd)`` as tuples."""
    ax = torch.clamp(z[0], accel_lo[0], accel_hi[0])
    ay = torch.clamp(z[1], accel_lo[1], accel_hi[1])
    az = torch.clamp(z[2], accel_lo[2], accel_hi[2])
    yr = torch.clamp(z[3], -yawrate_limit, yawrate_limit)
    thrust_hi = torch.full((), 1.2, dtype=torch.float32, device=z.device)
    if fallback_error_m > 0.0:
        # divergence guard: fallback PD hover law + recovery thrust
        ex, ey, ez = ref[0] - sc[0], ref[1] - sc[1], ref[2] - sc[2]
        diverged = ex * ex + ey * ey + ez * ez > fallback_error_m**2
        ks = fallback_accel_scale
        fb = lambda e, v, lo, hi: torch.clamp(1.5 * e - 0.8 * v, ks * lo, ks * hi)
        ax = torch.where(diverged, fb(ex, sc[3], accel_lo[0], accel_hi[0]), ax)
        ay = torch.where(diverged, fb(ey, sc[4], accel_lo[1], accel_hi[1]), ay)
        az = torch.where(diverged, fb(ez, sc[5], accel_lo[2], accel_hi[2]), az)
        yr = torch.where(diverged, 0.0, yr)
        thrust_hi = torch.where(diverged, fallback_thrust_ceiling, thrust_hi)
    c, att_sp, new_int = _allocation(
        sc, (ax, ay, az, yr, yaw_ref), integral, dt, plant[1], thrust_ceiling=thrust_hi,
    )
    return _rk4_substeps(s, c, plant, dt, substeps), c, att_sp, new_int, (ax, ay, az)


def guarded_sqrt(v: torch.Tensor) -> torch.Tensor:
    """``sqrt(v)`` for ``v >= 0`` whose gradient is 0, not infinite, where
    ``v`` is 0. The propagated variance is exactly 0 on the first stage's
    position rows, where the plain ``sqrt`` makes every weight gradient NaN
    (the JAX package's, fault F13 in ROADMAP.md); the value is the same."""
    pos = v > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, v, torch.ones_like(v))),
                       torch.zeros_like(v))


def tightening_row(data: FusedTickData, gp: GPRows, Kst: torch.Tensor,
                   tighten_kappa: float) -> torch.Tensor:
    """The ``(m,)`` box back-off of one tick from the horizon's cross-kernel
    ``Kst (N, P)``: the posterior variance through the cached ``K^-1``, its
    acceleration rows scaled by ``gain^2 y_std^2``, propagated by ``SwSqT``,
    ``kappa sqrt`` of it capped at 45% of each state box's width, and zero
    on the U-block."""
    Nnu = data.Nnu
    quad = torch.sum((Kst @ gp.kinv) * Kst, dim=1)
    var_lat = torch.clamp(gp.scal[2] - quad, min=1e-10)
    gain = gp.scal[1]
    sig_acc = (gain * gain) * var_lat[:, None] * (gp.y_std[3:6] ** 2)[None, :]
    sig = torch.cat([torch.zeros_like(sig_acc), sig_acc], dim=1).reshape(-1)
    tight_x = tighten_kappa * guarded_sqrt(sig @ data.SwSqT)
    cap = 0.45 * (data.hi_row[Nnu:] - data.lo_row[Nnu:])
    return torch.cat([torch.zeros(Nnu, dtype=torch.float32, device=Kst.device),
                      torch.minimum(tight_x, cap)])


def gp_horizon_rows(gp: GPRows, anchor, xtail, z_prev, N: int, nu: int = 4, nx: int = 6):
    """The GP's horizon rows of K5's and K9's ticks: ``(gain mean[:, 3:6]
    (N, 3), the cross-kernel K* (N, P))`` at the features of the UNshifted
    previous solution: stage 0 from ``anchor`` (the previous x0), stages
    1..N-1 from the previous X_tail, controls from the previous slack's
    U-block."""
    Xs = torch.cat([anchor[None, :], xtail[: (N - 1) * nx].reshape(N - 1, nx)], dim=0)
    F = torch.cat([Xs, z_prev[: N * nu].reshape(N, nu)], dim=1)
    Zf = F * gp.inv_ls[0] - gp.inv_ls[1]
    sq1 = torch.sum(Zf * Zf, dim=1, keepdim=True)
    dists = torch.clamp(sq1 + gp.sq2[None, :] - 2.0 * (Zf @ gp.ztrT), min=0.0)
    Kst = gp.scal[0] * torch.exp(-0.5 * dists)
    mean = Kst @ gp.alpha_s + gp.y_mean                    # (N, 6)
    return gp.scal[1] * mean[:, 3:6], Kst


def multitick_staged(
    data: FusedTickData,
    gp: GPRows | None,
    state, aux, xtail, z0, y0, refs, yaw_refs, plant_row,
    *,
    k_ticks, use_gp, rho, iterations, over_relax, dt, substeps,
    accel_lo, accel_hi, yawrate_limit,
    loop_precision="highest", n=0, nu=4, nx=6, tighten_kappa=0.0,
    fallback_error_m=0.0, fallback_thrust_ceiling=1.5,
    fallback_accel_scale=1.5,
):
    """Plain version of K5: the same operands and outputs, the same math
    block for block, in PyTorch tensor ops on any device; with a leading
    flight axis on ``state`` the one-flight version mapped over the flights
    (``torch.func.vmap``)."""
    _check_statics(n, nu, nx)
    if state.ndim == 2:
        statics = dict(k_ticks=k_ticks, use_gp=use_gp, rho=rho, iterations=iterations,
                       over_relax=over_relax, dt=dt, substeps=substeps, accel_lo=accel_lo,
                       accel_hi=accel_hi, yawrate_limit=yawrate_limit, n=n, nu=nu, nx=nx,
                       tighten_kappa=tighten_kappa, fallback_error_m=fallback_error_m,
                       fallback_thrust_ceiling=fallback_thrust_ceiling,
                       fallback_accel_scale=fallback_accel_scale)
        one = lambda s, a, xt, z, y, pr: multitick_staged(data, gp, s, a, xt, z, y, refs,
                                                          yaw_refs, pr, **statics)
        return torch.func.vmap(one)(state, aux, xtail, z0, y0, plant_row)
    tighten = _uses_tightening(use_gp, gp, tighten_kappa)
    N = n
    Nnu = N * nu
    plant = _read_plant(plant_row)
    plant_statics = dict(
        dt=dt, substeps=substeps, accel_lo=accel_lo, accel_hi=accel_hi,
        yawrate_limit=yawrate_limit, fallback_error_m=fallback_error_m,
        fallback_thrust_ceiling=fallback_thrust_ceiling,
        fallback_accel_scale=fallback_accel_scale,
    )
    dev = state.device
    zeros3 = torch.zeros(N, 3, dtype=torch.float32, device=dev)

    packed_rows = []
    z_prev, y_prev = z0, y0
    for t in range(k_ticks):
        ref = refs[t]
        yaw_ref = yaw_refs[t]
        if use_gp:
            wrow, Kst = gp_horizon_rows(gp, aux[:nx], xtail, z_prev, N, nu, nx)
            w = torch.cat([zeros3, wrow], dim=1).reshape(-1)
        else:
            w = torch.zeros(N * nx, dtype=torch.float32, device=dev)
        tight = tightening_row(data, gp, Kst, tighten_kappa) if tighten else None

        zy = torch.stack([z_prev, y_prev]) @ data.ShiftT            # exact 0/1 product
        z, y, U, X_tail = controller_plain(data, state[:nx], w, ref, zy[0], zy[1], rho,
                                           iterations, over_relax, tight)
        s = tuple(state[i] for i in range(12))
        s_new, c, att_sp, new_int, accel = command_plant_plain(
            z, ref, s, s, yaw_ref, (aux[6], aux[7], aux[8]), plant, **plant_statics)
        packed_rows.append(torch.stack(
            s + c + att_sp + new_int + accel
            + (z[0], z[1], z[2], z[3]) + (X_tail[3], X_tail[4], X_tail[5])
        ))
        state = torch.stack(s_new)
        aux = torch.stack(s[0:6] + new_int)
        xtail = X_tail
        z_prev, y_prev = z, y
    return torch.stack(packed_rows), state, aux, xtail, z_prev, y_prev


# The tightened K5's thread-block cluster (csrc/tick_kernel.cu,
# csrc/multitick_phases.cuh): rank 0 runs the tick, the other blocks are
# variance workers, each over one share of K^-1's upper triangle.
VAR_CLUSTER = 8           # blocks per flight where the card runs no larger cluster
VAR_MAX_CLUSTER = 16      # the largest (non-portable on an H100), taken where it runs
VAR_WORKERS = VAR_CLUSTER - 1
VAR_ROWS = 16             # kVarRows: rows of K^-1 per worker task
MAX_VAR_STAGES = 24       # kMaxVarStages: the most horizon stages a worker sums
_VAR_HEAD = 9 * MAX_VAR_STAGES   # kVarHead: a worker's partial and warp sums


class _TickParams(ctypes.Structure):
    _fields_ = [
        ("k_ticks", ctypes.c_int), ("n", ctypes.c_int), ("m", ctypes.c_int),
        ("n_train", ctypes.c_int), ("use_gp", ctypes.c_int),
        ("iterations", ctypes.c_int), ("substeps", ctypes.c_int),
        ("use_fallback", ctypes.c_int), ("tighten", ctypes.c_int),
        ("var_kinv_shared", ctypes.c_int), ("var_rows", ctypes.c_int * VAR_MAX_CLUSTER),
        ("dt", ctypes.c_double),
        ("rho", ctypes.c_float), ("over_relax", ctypes.c_float),
        ("one_minus_over_relax", ctypes.c_float), ("yawrate_limit", ctypes.c_float),
        ("fallback_error_sq", ctypes.c_float), ("fallback_thrust_ceiling", ctypes.c_float),
        ("tighten_kappa", ctypes.c_float),
        ("accel_lo", ctypes.c_float * 3), ("accel_hi", ctypes.c_float * 3),
        ("fallback_lo", ctypes.c_float * 3), ("fallback_hi", ctypes.c_float * 3),
    ]


_OPERAND_NAMES = (
    "SxSwT", "SuTqT", "PM", "P1", "P0matT", "SuT", "lo_row", "hi_row",
    "ztrT", "sq2", "alpha_s", "y_mean", "inv_ls", "scal",
    "kinv", "y_std", "SwSqT", "kst_ws",
    "state_in", "aux_in", "xtail_in", "z_in", "y_in", "refs", "yaw_refs", "plant_row",
    "packed", "state_out", "aux_out", "xtail_out", "z_out", "y_out", "tight_out",
)


class _TickOperands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _OPERAND_NAMES]


# the solve's six phases, in both kernels' section clocks
SOLVE_PHASES = ("solve: offset", "solve: f", "solve: p0 and M^-1 f", "ADMM", "solve: U",
                "solve: X_tail")
TICK_SECTIONS = ("GP", "shift", "solve", "scalar section", "whole tick") + SOLVE_PHASES


def tick_section_cycles() -> dict[str, int]:
    """K5's per-section clock cycles summed over the launches since the
    last call, then reset (``TICK_SECTIONS``: the GP and the shift on warps
    1.., the solve, the scalar section on warp 0, the whole tick, then the
    solve's phases; its L2 matvecs are the solve less its ADMM). Counted
    only by the build with
    section clocks: launch K5 inside ``_cuda.library_variant("tick",
    "tick_clocks")``, synchronise, then call this."""
    return _cuda.section_cycles("tick_clocks", "tick_section_cycles", TICK_SECTIONS)


def single_tick_shared_memory_bytes(n: int, p1_shared: bool = True, nu: int = 4, nx: int = 6,
                                    threads: int = SINGLE_TICK_THREADS) -> int:
    """Dynamic shared memory of one K4 block of ``threads``
    (csrc/single_tick_kernels.cu ``gpmpc_tick_kernel`` layout): P1's
    transaction barrier (4 floats), P1 (``p1_shared`` only), the ADMM input
    double-buffered (16-byte aligned), the slack, dual, p0 and the bounds,
    [x0 | w], offset, ref error, f, M^-1 f and U, the matvec slices
    (``max(threads, m + N nu)``) and the solve's x0 copy (nx)."""
    m, Nnu, Nnx = n * (nu + nx), n * nu, n * nx
    m4 = (m + 3) // 4 * 4
    floats = (4 + (m * m if p1_shared else 0) + 2 * m4 + 5 * m + nx + 3 * Nnx + 3 * Nnu
              + max(threads, m + Nnu) + nx)
    return 4 * floats


# K4's sections (csrc/single_tick_kernels.cu): P1's copy into shared memory
# (the part not hidden behind the phases before the ADMM), the warm start,
# the solve's six phases, the scalar section and the whole launch
SINGLE_TICK_SECTIONS = ("P1 copy", "shift") + SOLVE_PHASES + ("scalar section", "whole launch")
# the library's counters: K4's, then the three phases of a factored ADMM step
# (block_linalg.cuh factored_admm: K3 and K6 on P1's factors), summed over
# the steps
SINGLE_TICK_COUNTERS = SINGLE_TICK_SECTIONS + (
    "ADMM: t and the U-block update", "ADMM: t Su'", "ADMM: the X-block update")


def single_tick_counters() -> dict[str, int]:
    """Every counter of the single-tick kernels' build with section clocks
    (``SINGLE_TICK_COUNTERS``), summed over the launches since the last
    call, then reset."""
    return _cuda.section_cycles("single_tick_clocks", "single_tick_section_cycles",
                                SINGLE_TICK_COUNTERS)


def single_tick_section_cycles() -> dict[str, int]:
    """K4's per-section clock cycles summed over the launches since the
    last call, then reset (``SINGLE_TICK_SECTIONS``). Counted only by the
    build with section clocks: launch K4 inside ``_cuda.library_variant(
    "single_tick", "single_tick_clocks")``, synchronise, then call this."""
    cycles = single_tick_counters()
    return {name: cycles[name] for name in SINGLE_TICK_SECTIONS}


def _vector_floats(n: int, nu: int, nx: int, threads: int, gp_threads: int, group: int,
                   stages: int) -> int:
    """The shared-memory floats K5 and K9 lay out alike (csrc/tick_kernel.cu,
    noisy_tick_kernel.cu): P1, the ADMM input double-buffered (16-byte
    aligned), the slack, dual, p0 and the boxes, [x0 | w], X_tail, offset,
    ref and its difference, f, M^-1 f and U, the matvec slices (``max(threads,
    m + N nu)``), the GP's features and its group sums (3 per ``group`` of its
    ``gp_threads`` for each of its ``stages`` per thread)."""
    m, Nnu, Nnx, d = n * (nu + nx), n * nu, n * nx, nu + nx
    m4 = (m + 3) // 4 * 4
    return (m * m + 2 * m4 + 7 * m + nx + 5 * Nnx + 3 * Nnu + max(threads, m + Nnu) + n * d
            + 3 * (gp_threads // group) * stages)


def shared_memory_bytes(n: int, nu: int = 4, nx: int = 6, threads: int | None = None,
                        tighten: bool = False) -> int:
    """Dynamic shared memory of one K5 block (csrc/tick_kernel.cu layout) of
    ``threads`` (KERNEL_THREADS, or TIGHT_KERNEL_THREADS with ``tighten``):
    P1, the per-tick vectors, the state (12), aux (9) and the GP's anchor
    (nx); with ``tighten``, rank 0's layout, which adds the variance row (N *
    nx) and the back-off row (m). The tightened launch gives every block of
    its cluster the larger of this and ``variance_worker_bytes``."""
    if threads is None:
        threads = TIGHT_KERNEL_THREADS if tighten else KERNEL_THREADS
    group, stages = (TIGHT_GP_GROUP, 1) if tighten else (GP_GROUP, GP_STAGES)
    floats = _vector_floats(n, nu, nx, threads, threads - 32, group, stages) + 12 + AUX_LANES + nx
    if tighten:
        floats += n * nx + n * (nu + nx)
    return 4 * floats


@functools.lru_cache(maxsize=64)
def variance_row_shares(n_train: int, workers: int = VAR_WORKERS) -> tuple[int, ...]:
    """Row bounds ``b`` (``workers + 1`` of them) of the variance workers'
    shares of K^-1's upper triangle: worker ``r`` takes rows ``[b[r],
    b[r + 1])``, row ``q`` holding columns ``q .. P - 1``. Each bound is the
    first row at which the entries before it reach ``r / workers`` of the
    triangle, so the shares' entry counts differ by less than one row."""
    P = int(n_train)
    total = P * (P + 1) // 2
    before = lambda q: q * P - q * (q - 1) // 2   # entries of rows 0 .. q - 1
    bounds, q = [0], 0
    for r in range(1, workers):
        while q < P and before(q) * workers < r * total:
            q += 1
        bounds.append(q)
    bounds.append(P)
    return tuple(bounds)


@functools.lru_cache(maxsize=64)
def variance_worker_bytes(n: int, n_train: int, kinv_shared: bool,
                          workers: int = VAR_WORKERS) -> int:
    """Dynamic shared memory a variance worker of the tightened K5 needs
    (csrc/tick_kernel.cu variance_worker_ticks), the largest share's: its
    partial and warp sums, K*'s columns of its rows (the stages rounded up
    to 4, the rows to VAR_ROWS) and, with ``kinv_shared``, its rows of the
    triangle."""
    P, kS = int(n_train), (n + 3) // 4 * 4
    b = variance_row_shares(P, workers)
    most = 0
    for q0, q1 in zip(b[:-1], b[1:]):
        rows = -(-(q1 - q0) // VAR_ROWS) * VAR_ROWS
        entries = sum(P - q for q in range(q0, q1)) if kinv_shared else 0
        most = max(most, rows * kS + entries)
    return 4 * (_VAR_HEAD + most)


def gpmpc_multitick_fused(
    data: FusedTickData,
    gp: GPRows | None,
    state: torch.Tensor,      # (12,) or (B, 12)
    aux: torch.Tensor,        # (9,) / (B, 9) previous x0 (6) + integral (3)
    xtail: torch.Tensor,      # (Nnx,) / (B, Nnx) previous predicted X_tail
    z0: torch.Tensor,         # (m,) / (B, m) UNshifted previous slack
    y0: torch.Tensor,         # (m,) / (B, m) UNshifted previous dual
    refs: torch.Tensor,       # (K, Nnx) stacked state references per tick (shared)
    yaw_refs: torch.Tensor,   # (K,) (shared)
    plant_row: torch.Tensor,  # (10,) / (B, 10)
    *,
    k_ticks: int,
    use_gp: bool,
    rho: float,
    iterations: int,
    over_relax: float,
    dt: float,
    substeps: int,
    accel_lo: tuple,
    accel_hi: tuple,
    yawrate_limit: float,
    loop_precision: str = "highest",
    n: int = 0,
    nu: int = 4,
    nx: int = 6,
    tighten_kappa: float = 0.0,
    fallback_error_m: float = 0.0,
    fallback_thrust_ceiling: float = 1.5,
    fallback_accel_scale: float = 1.5,
):
    """K whole GP-MPC ticks in one launch (K5).

    Returns ``(packed (K, 32), state (12,), aux (9,), xtail (Nnx,),
    z (m,), y (m,))``. With ``use_gp`` and ``tighten_kappa > 0`` the GP
    rows must carry ``kinv`` and ``y_std`` (``build_gp_rows(...,
    with_variance=True)``): each tick then backs the state boxes off by the
    posterior std, the quadratic form spread over a thread-block cluster
    (``variance_cluster``). A horizon whose P1 does not fit in one block's
    shared memory raises ``ValueError``. With a leading flight axis on
    ``state`` (``(B, 12)``) every per-flight operand carries it and the
    launch is a grid of one block per flight (the operators, the GP rows
    and the references shared; the outputs carry the axis); the tightened
    kernel takes one flight."""
    _check_statics(n, nu, nx)
    tighten = _uses_tightening(use_gp, gp, tighten_kappa)
    dev = state.device
    N, K = n, k_ticks
    Nnx, m = N * nx, N * (nu + nx)
    batch = (state.shape[0],) if state.ndim == 2 else ()
    if batch and tighten:
        raise ValueError("the tightened K5 (a thread-block cluster per flight) flies one flight "
                         "a launch: a population flies untightened")
    req = _cuda.require
    req(state, "state", batch + (12,), dev)
    req(aux, "aux", batch + (AUX_LANES,), dev)
    req(xtail, "xtail", batch + (Nnx,), dev)
    req(z0, "z0", batch + (m,), dev)
    req(y0, "y0", batch + (m,), dev)
    req(refs, "refs", (K, Nnx), dev)
    req(yaw_refs, "yaw_refs", (K,), dev)
    req(plant_row, "plant_row", batch + (PLANT_LANES,), dev)
    require_tick_data(data, N, dev)
    if use_gp:
        if gp is None:
            raise ValueError("use_gp=True needs GP rows")
        P = gp.sq2.shape[0]
        d = nu + nx
        req(gp.ztrT, "ztrT", (d, P), dev)
        req(gp.sq2, "sq2", (P,), dev)
        req(gp.alpha_s, "alpha_s", (P, 6), dev)
        req(gp.y_mean, "y_mean", (6,), dev)
        req(gp.inv_ls, "inv_ls", (2, d), dev)
        req(gp.scal, "scal", (3,), dev)
    if tighten:
        req(gp.kinv, "kinv", (P, P), dev)
        req(gp.y_std, "y_std", (6,), dev)
        req(data.SwSqT, "SwSqT", (Nnx, Nnx), dev)
    statics = dict(
        k_ticks=k_ticks, use_gp=use_gp, rho=rho, iterations=iterations,
        over_relax=over_relax, dt=dt, substeps=substeps, accel_lo=accel_lo,
        accel_hi=accel_hi, yawrate_limit=yawrate_limit, loop_precision=loop_precision,
        n=n, nu=nu, nx=nx, tighten_kappa=tighten_kappa,
        fallback_error_m=fallback_error_m,
        fallback_thrust_ceiling=fallback_thrust_ceiling,
        fallback_accel_scale=fallback_accel_scale,
    )
    if dev.type == "cpu":
        return multitick_staged(data, gp, state, aux, xtail, z0, y0, refs, yaw_refs,
                                plant_row, **statics)
    if dev.type != "cuda":
        raise ValueError(f"gpmpc_multitick_fused runs on cuda or cpu, not {dev}")

    return _launch_multitick(data, gp, (state, aux, xtail, z0, y0, refs, yaw_refs, plant_row),
                             statics, tighten)


@functools.lru_cache(maxsize=64)
def variance_cluster(device, n: int, n_train: int, nu: int = 4, nx: int = 6,
                     kinv_shared: bool | None = None,
                     cluster: int | None = None) -> tuple[int, bool, int]:
    """``(cluster, kinv_shared, shared-memory bytes)`` of a tightened K5
    launch: VAR_MAX_CLUSTER blocks where ``device`` runs such a cluster
    (``cudaOccupancyMaxActiveClusters``), VAR_CLUSTER otherwise, or
    ``cluster`` as asked; the workers keep their shares of K^-1 in shared
    memory where those fit one block, or as ``kinv_shared`` asks. Every
    block gets the larger of rank 0's layout and a worker's. Raises if none
    fits. Cached per argument set (the card does not change)."""
    limit = _cuda.shared_memory_optin(device)
    rank0 = shared_memory_bytes(n, nu, nx, tighten=True)
    for c in ([cluster] if cluster else [VAR_MAX_CLUSTER, VAR_CLUSTER]):
        shared = (variance_worker_bytes(n, n_train, True, c - 1) <= limit
                  if kinv_shared is None else kinv_shared)
        smem = max(rank0, variance_worker_bytes(n, n_train, shared, c - 1))
        if smem > limit:
            continue
        if c > VAR_CLUSTER:   # non-portable: does the card run one?
            fn = _cuda.library("tick").gpmpc_multitick_max_active_clusters
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            count = ctypes.c_int(0)
            _cuda.check(fn(c, smem, ctypes.byref(count)), "gpmpc_multitick_max_active_clusters")
            if count.value < 1:
                continue
        return c, shared, smem
    raise ValueError(f"{n_train} GP points at horizon {n}: the tightened K5's blocks need more "
                     f"shared memory than one block's {limit}")


def _launch_multitick(data: FusedTickData, gp: GPRows | None, tensors_in: tuple, statics: dict,
                      tighten: bool, kinv_shared: bool | None = None,
                      tight_out: torch.Tensor | None = None, cluster: int | None = None):
    """K5's launch on the card, after ``gpmpc_multitick_fused``'s checks.
    The tightened kernel's cluster and where its workers keep K^-1 follow
    ``variance_cluster`` (``kinv_shared`` and ``cluster`` force them: the
    card check times both); ``tight_out`` (K, m), if given, receives each
    tick's back-off row (the card check compares it)."""
    state, aux, xtail, z0, y0, refs, yaw_refs, plant_row = tensors_in
    dev = state.device
    N, K, nu, nx = statics["n"], statics["k_ticks"], statics["nu"], statics["nx"]
    Nnx, m = N * nx, N * (nu + nx)
    use_gp = statics["use_gp"]
    P = gp.sq2.shape[0] if use_gp else 0
    if tighten and N > MAX_VAR_STAGES:
        raise ValueError(f"the variance section sums at most {MAX_VAR_STAGES} horizon stages "
                         f"(got {N})")
    smem = shared_memory_bytes(N, nu, nx, tighten=tighten)
    limit = _cuda.shared_memory_optin(dev)
    if smem > limit:
        raise ValueError(
            f"horizon {N}: P1 ({m}x{m}) and the tick vectors need {smem} bytes of "
            f"shared memory, more than one block's {limit}; streaming P1 from L2 "
            "for long horizons is queued in ROADMAP.md"
        )
    rows = [0] * VAR_MAX_CLUSTER
    if tighten:
        cluster, kinv_shared, smem = variance_cluster(dev, N, P, nu, nx, kinv_shared, cluster)
        rows = variance_row_shares(P, cluster - 1)
        rows += (P,) * (VAR_MAX_CLUSTER - len(rows))
    f = lambda v: float(np.float32(v))
    fallback_error_m, accel_lo, accel_hi = (statics["fallback_error_m"], statics["accel_lo"],
                                            statics["accel_hi"])
    scale = statics["fallback_accel_scale"]
    params = _TickParams(
        k_ticks=K, n=N, m=m, n_train=P,
        use_gp=int(bool(use_gp)), iterations=int(statics["iterations"]),
        substeps=int(statics["substeps"]), use_fallback=int(fallback_error_m > 0.0),
        tighten=int(tighten), var_kinv_shared=int(bool(kinv_shared)),
        var_rows=(ctypes.c_int * VAR_MAX_CLUSTER)(*rows), dt=float(statics["dt"]),
        rho=f(statics["rho"]), over_relax=f(statics["over_relax"]),
        one_minus_over_relax=f(1.0 - statics["over_relax"]),
        yawrate_limit=f(statics["yawrate_limit"]), fallback_error_sq=f(fallback_error_m**2),
        fallback_thrust_ceiling=f(statics["fallback_thrust_ceiling"]),
        tighten_kappa=f(statics["tighten_kappa"]),
        accel_lo=(ctypes.c_float * 3)(*accel_lo), accel_hi=(ctypes.c_float * 3)(*accel_hi),
        fallback_lo=(ctypes.c_float * 3)(*(scale * v for v in accel_lo)),
        fallback_hi=(ctypes.c_float * 3)(*(scale * v for v in accel_hi)),
    )
    batch = tuple(state.shape[:-1])
    empty = lambda *shape: torch.empty(*batch, *shape, dtype=torch.float32, device=dev)
    outs = dict(packed=empty(K, PACKED_LANES), state_out=empty(12), aux_out=empty(AUX_LANES),
                xtail_out=empty(Nnx), z_out=empty(m), y_out=empty(m))
    tensors = dict(
        SxSwT=data.SxSwT, SuTqT=data.SuTqT, PM=data.PM, P1=data.P1, P0matT=data.P0matT,
        SuT=data.SuT, lo_row=data.lo_row, hi_row=data.hi_row,
        state_in=state, aux_in=aux, xtail_in=xtail, z_in=z0, y_in=y0, refs=refs,
        yaw_refs=yaw_refs, plant_row=plant_row, **outs,
    )
    if use_gp:
        tensors.update(ztrT=gp.ztrT, sq2=gp.sq2, alpha_s=gp.alpha_s, y_mean=gp.y_mean,
                       inv_ls=gp.inv_ls, scal=gp.scal)
    if tighten:
        # the GP section leaves the horizon's cross-kernel K* (N, P) here for
        # the variance workers (64 KB at N=20, P=800: it stays in L2)
        tensors.update(kinv=gp.kinv, y_std=gp.y_std, SwSqT=data.SwSqT,
                       kst_ws=torch.empty(N * P, dtype=torch.float32, device=dev))
        if tight_out is not None:
            _cuda.require(tight_out, "tight_out", (K, m), dev)
            tensors.update(tight_out=tight_out)
    ops = _TickOperands(**{k: v.data_ptr() for k, v in tensors.items()})
    fn = _cuda.library("tick").gpmpc_multitick_launch
    fn.argtypes = [ctypes.POINTER(_TickParams), ctypes.POINTER(_TickOperands),
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(params), ctypes.byref(ops), cluster if tighten else 1, smem,
                batch[0] if batch else 1, _cuda.stream_of(state))
    _cuda.check(status, "gpmpc_multitick_fused")
    _cuda.count_launch("gpmpc_multitick_fused_tightened" if tighten else "gpmpc_multitick_fused")
    return (outs["packed"], outs["state_out"], outs["aux_out"], outs["xtail_out"],
            outs["z_out"], outs["y_out"])


# ---------------------------------------------------------------------------
# K4: one whole tick per launch
# ---------------------------------------------------------------------------


def gpmpc_tick_fused_plain(
    data: FusedTickData, state, w, ref, misc, z0, y0, plant_row, *,
    rho, iterations, over_relax, dt, substeps, accel_lo, accel_hi, yawrate_limit,
    loop_precision="highest", n=0, nu=4, nx=6, fallback_error_m=0.0,
    fallback_thrust_ceiling=1.5, fallback_accel_scale=1.5, ctrl_state=None, tight=None,
):
    """Plain version of K4: the same operands and outputs, in PyTorch
    tensor ops on any device; with a leading flight axis on ``state`` the
    one-flight version mapped over the flights (``torch.func.vmap``)."""
    statics = dict(rho=rho, iterations=iterations, over_relax=over_relax, dt=dt,
                   substeps=substeps, accel_lo=accel_lo, accel_hi=accel_hi,
                   yawrate_limit=yawrate_limit, n=n, nu=nu, nx=nx,
                   fallback_error_m=fallback_error_m,
                   fallback_thrust_ceiling=fallback_thrust_ceiling,
                   fallback_accel_scale=fallback_accel_scale, tight=tight)
    if state.ndim == 2:
        one = lambda s, w_, mi, z, y, pr, cs: gpmpc_tick_fused_plain(
            data, s, w_, ref, mi, z, y, pr, ctrl_state=cs, **statics)
        return torch.func.vmap(one)(state, w, misc, z0, y0, plant_row,
                                    state if ctrl_state is None else ctrl_state)
    cs = state if ctrl_state is None else ctrl_state
    zy = torch.stack([z0, y0]) @ data.ShiftT            # exact 0/1 product
    z, y, U, X_tail = controller_plain(data, cs[:nx], w, ref, zy[0], zy[1], rho, iterations,
                                       over_relax, tight)
    s_new, c, att_sp, new_int, accel = command_plant_plain(
        z, ref, tuple(cs[i] for i in range(12)), tuple(state[i] for i in range(12)),
        misc[0], (misc[1], misc[2], misc[3]), _read_plant(plant_row),
        dt=dt, substeps=substeps, accel_lo=accel_lo, accel_hi=accel_hi,
        yawrate_limit=yawrate_limit, fallback_error_m=fallback_error_m,
        fallback_thrust_ceiling=fallback_thrust_ceiling,
        fallback_accel_scale=fallback_accel_scale,
    )
    return torch.stack(s_new + c + att_sp + new_int + accel), z, y, U, X_tail


def gpmpc_tick_fused(
    data: FusedTickData,
    state: torch.Tensor,      # (12,) or (B, 12) plant state (the truth)
    w: torch.Tensor,          # (Nnx,) / (B, Nnx) stacked disturbance dt * D
    ref: torch.Tensor,        # (Nnx,) stacked state reference (shared)
    misc: torch.Tensor,       # (4,) / (B, 4) = [yaw_ref, attitude integral (3)]
    z0: torch.Tensor,         # (m,) / (B, m) UNshifted previous slack
    y0: torch.Tensor,         # (m,) / (B, m) UNshifted previous dual
    plant_row: torch.Tensor,  # (10,) / (B, 10)
    *,
    rho: float,
    iterations: int,
    over_relax: float,
    dt: float,
    substeps: int,
    accel_lo: tuple,
    accel_hi: tuple,
    yawrate_limit: float,
    loop_precision: str = "highest",
    n: int = 0,
    nu: int = 4,
    nx: int = 6,
    fallback_error_m: float = 0.0,
    fallback_thrust_ceiling: float = 1.5,
    fallback_accel_scale: float = 1.5,
    ctrl_state: torch.Tensor | None = None,   # like state: the controller's state; None: state
    tight: torch.Tensor | None = None,        # (m,) box back-off (shared); None: zeros
):
    """One whole GP-MPC tick in one launch (K4).

    Returns ``(packed (25,), z (m,), y (m,), U (Nnu,), X_tail (Nnx,))``.
    With a leading flight axis on ``state`` (``(B, 12)``) every per-flight
    operand carries it too and the launch is a grid of one block per flight
    (the tick data, ``ref`` and ``tight`` shared); the outputs then carry
    it. ``n`` (the horizon) defaults to the one ``data`` is laid out for. P1
    lies in shared memory where it fits one block (N <= 23 on an H100) and
    is read through L2 beyond."""
    N = n or data.Nnx // nx
    _check_statics(N, nu, nx)
    dev = state.device
    Nnx, m = N * nx, N * (nu + nx)
    require_tick_data(data, N, dev)
    batch = (state.shape[0],) if state.ndim == 2 else ()
    req = lambda t, name, shape: _cuda.require(t, name, batch + shape, dev)
    req(state, "state", (12,))
    if ctrl_state is not None:
        req(ctrl_state, "ctrl_state", (12,))
    if tight is not None:
        _cuda.require(tight, "tight", (m,), dev)
    req(w, "w", (Nnx,))
    _cuda.require(ref, "ref", (Nnx,), dev)
    req(misc, "misc", (4,))
    req(z0, "z0", (m,))
    req(y0, "y0", (m,))
    req(plant_row, "plant_row", (PLANT_LANES,))
    statics = dict(
        rho=rho, iterations=iterations, over_relax=over_relax, dt=dt, substeps=substeps,
        accel_lo=accel_lo, accel_hi=accel_hi, yawrate_limit=yawrate_limit,
        fallback_error_m=fallback_error_m, fallback_thrust_ceiling=fallback_thrust_ceiling,
        fallback_accel_scale=fallback_accel_scale,
    )
    if dev.type == "cpu":
        return gpmpc_tick_fused_plain(data, state, w, ref, misc, z0, y0, plant_row, n=N,
                                      nu=nu, nx=nx, ctrl_state=ctrl_state, tight=tight,
                                      **statics)
    if dev.type != "cuda":
        raise ValueError(f"gpmpc_tick_fused runs on cuda or cpu, not {dev}")
    if tight is None:
        tight = torch.zeros(m, dtype=torch.float32, device=dev)
    empty = lambda k: torch.empty(*batch, k, dtype=torch.float32, device=dev)
    outs = dict(z_out=empty(m), y_out=empty(m), u_out=empty(N * nu), xtail_out=empty(Nnx),
                packed=empty(TICK_PACKED_LANES))
    tensors = dict(x0=state if ctrl_state is None else ctrl_state, w=w, ref=ref, z_in=z0,
                   y_in=y0, state=state, misc=misc, tight=tight, plant_row=plant_row)
    launch_single_tick("gpmpc_tick_launch", "gpmpc_tick_fused", data, N, tensors, outs,
                       layout=single_tick_shared_memory_bytes, blocks=batch[0] if batch else 1,
                       **statics)
    return outs["packed"], outs["z_out"], outs["y_out"], outs["u_out"], outs["xtail_out"]


# ---------------------------------------------------------------------------
# K9: K whole noisy ticks per launch (K5 with the EKF inside)
# ---------------------------------------------------------------------------

EKF_MEAS_IDX = (0, 1, 2, 6, 7, 8, 9, 10, 11)   # estimation.ekf.MEASURED_IDX
NOISY_PACKED_LANES = 47   # K5's 32 lanes | estimate 32:44 | disturbance 44:47
NOISY_AUX_LANES = 13      # estimate x0 (6) | integral (3) | applied control (4)
DOB_STATES = 15           # [x12, d3] in observer mode


def build_dob_bdist(dt: float, device=None) -> torch.Tensor:
    """The disturbance-injection block of the observer's transition
    Jacobian, (15, 15): ``0.5 dt^2`` from d to position, ``dt`` from d to
    velocity, zero elsewhere, so that F = I + Fd12 + bdist is the observer's
    exact ``jacfwd``."""
    b = np.zeros((DOB_STATES, DOB_STATES), np.float32)
    for j in range(3):
        b[j, 12 + j] = 0.5 * dt * dt
        b[3 + j, 12 + j] = dt
    return torch.as_tensor(b, device=resolve_device(device))


def _rk4_stages(ex, c, plant, dt):
    """One RK4 step of the surrogate at ``dt`` on a 12-tuple: the stage
    states x2, x3, x4 (the Jacobian's linearisation points) and the
    prediction."""
    k1 = _derivative(ex, c, plant)
    x2 = _axpy(ex, k1, 0.5 * dt)
    k2 = _derivative(x2, c, plant)
    x3 = _axpy(ex, k2, 0.5 * dt)
    k3 = _derivative(x3, c, plant)
    x4 = _axpy(ex, k3, dt)
    k4 = _derivative(x4, c, plant)
    xp = tuple(ex[i] + (dt / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i])
               for i in range(12))
    return x2, x3, x4, xp


def _transition_fd(ex, c, x2, x3, x4, plant, dt, bdist):
    """Fd = F - I of the filter's RK4 step: dt/6 (K1 + 2 K2 + 2 K3 + K4)
    with K_{i+1} = J(x_{i+1}) + c_i dt J(x_{i+1}) K_i from the closed-form
    J at the stage states; plus ``bdist`` in observer mode."""
    K1 = _jacobian(ex, c, plant)
    J2, J3, J4 = (_jacobian(x, c, plant) for x in (x2, x3, x4))
    K2 = J2 + 0.5 * dt * (J2 @ K1)
    K3 = J3 + 0.5 * dt * (J3 @ K2)
    K4 = J4 + dt * (J4 @ K3)
    Fd = (dt / 6.0) * (K1 + 2.0 * K2 + 2.0 * K3 + K4)
    if bdist is None:
        return Fd
    return torch.nn.functional.pad(Fd, (0, 3, 0, 3)) + bdist


def noisy_multitick_staged(
    data: FusedTickData,
    gp: GPRows | None,
    state, est, P, aux, xtail, z0, y0, refs, yaw_refs, noise, plant_rows, q_diag, r_diag,
    *,
    k_ticks, use_gp, rho, iterations, over_relax, dt, substeps,
    accel_lo, accel_hi, yawrate_limit,
    loop_precision="highest", n=0, nu=4, nx=6,
    fallback_error_m=0.0, fallback_thrust_ceiling=1.5, fallback_accel_scale=1.5,
    relinearize_per_tick=True, cov_precision="highest", use_dob=False,
    nominal_row=None, bdist=None,
):
    """Plain version of K9: the same operands and outputs, the same math
    block for block, in PyTorch tensor ops on any device."""
    _check_statics(n, nu, nx)
    N = n
    plants = [_read_plant(plant_rows[i]) for i in range(plant_rows.shape[0])]
    nominal = _read_plant(nominal_row) if use_dob else None
    plant_statics = dict(
        dt=dt, substeps=substeps, accel_lo=accel_lo, accel_hi=accel_hi,
        yawrate_limit=yawrate_limit, fallback_error_m=fallback_error_m,
        fallback_thrust_ceiling=fallback_thrust_ceiling,
        fallback_accel_scale=fallback_accel_scale,
    )
    dev = state.device
    Q = torch.diag(q_diag)
    bd = bdist if use_dob else None
    zeros3 = torch.zeros(N, 3, dtype=torch.float32, device=dev)

    def stages_at(e, a, plant):
        ex = tuple(e[i] for i in range(12))
        c = tuple(a[9 + i] for i in range(4))
        return ex, c, _rk4_stages(ex, c, plant, dt)

    if not relinearize_per_tick:
        # "dispatch": one transition Jacobian at the entry estimate and
        # control for all K ticks (row 0's plant; the nominal row in
        # observer mode)
        ex0, c0, (x2, x3, x4, _) = stages_at(est, aux, nominal if use_dob else plants[0])
        fd_frozen = _transition_fd(ex0, c0, x2, x3, x4, nominal if use_dob else plants[0],
                                   dt, bd)

    packed_rows = []
    z_prev, y_prev = z0, y0
    for t in range(k_ticks):
        ref = refs[t]
        s = tuple(state[i] for i in range(12))     # the truth
        plant = plants[t if len(plants) > 1 else 0]
        ekf_plant = nominal if use_dob else plant

        # ---- EKF predict: one RK4 step at dt from the applied control ----
        ex, prev_c, (x2, x3, x4, xp) = stages_at(est, aux, ekf_plant)
        d_prev = ()
        if use_dob:
            d_prev = (est[12], est[13], est[14])
            hh = 0.5 * dt * dt
            xp = tuple(xp[i] + hh * d_prev[i] for i in range(3)) + tuple(
                xp[3 + i] + dt * d_prev[i] for i in range(3)) + xp[6:]
        Fd = (_transition_fd(ex, prev_c, x2, x3, x4, ekf_plant, dt, bd)
              if relinearize_per_tick else fd_frozen)
        FdP = Fd @ P
        Pm = P + FdP + FdP.T + FdP @ Fd.T + Q

        # ---- EKF update: 9 sequential scalar fusions --------------------
        xrow = torch.stack(xp + d_prev)
        for jm, j in enumerate(EKF_MEAS_IDX):
            innov = s[j] + noise[t, jm] - xrow[j]     # truth + presampled noise
            if j == 8:                                # yaw seam
                innov = _wrap(innov)
            S = Pm[j, j] + r_diag[jm]
            xrow = xrow + innov * (Pm[j, :] / S)
            Pm = Pm - (Pm[:, j:j + 1] / S) * Pm[j:j + 1, :]
        exn = tuple(_wrap(xrow[i]) if 6 <= i <= 8 else xrow[i] for i in range(12))
        dn = (xrow[12], xrow[13], xrow[14]) if use_dob else ()
        P = Pm

        # ---- GP horizon mean (from the previous tick's solution) --------
        if use_gp:
            wrow, _ = gp_horizon_rows(gp, aux[:nx], xtail, z_prev, N, nu, nx)
        else:
            wrow = zeros3
        if use_dob:
            # the observer's acceleration, summed with the GP's rows
            wrow = wrow + dt * torch.stack(dn)[None, :]
        w = torch.cat([zeros3, wrow], dim=1).reshape(-1)

        # ---- MPC on the estimate; allocation on it, plant on the truth --
        zy = torch.stack([z_prev, y_prev]) @ data.ShiftT
        z, y, U, X_tail = controller_plain(data, torch.stack(exn[0:6]), w, ref, zy[0], zy[1],
                                           rho, iterations, over_relax)
        s_new, c, att_sp, new_int, accel = command_plant_plain(
            z, ref, exn, s, yaw_refs[t], (aux[6], aux[7], aux[8]), plant, **plant_statics)
        pad = dn if use_dob else (torch.zeros((), dtype=torch.float32, device=dev),) * 3
        packed_rows.append(torch.stack(
            s + c + att_sp + new_int + accel + (z[0], z[1], z[2], z[3])
            + (X_tail[3], X_tail[4], X_tail[5]) + exn + pad
        ))
        state = torch.stack(s_new)
        est = torch.stack(exn + dn)
        aux = torch.stack(exn[0:6] + new_int + c)
        xtail = X_tail
        z_prev, y_prev = z, y
    return torch.stack(packed_rows), state, est, P, aux, xtail, z_prev, y_prev


class _NoisyTickParams(ctypes.Structure):
    _fields_ = [
        ("k_ticks", ctypes.c_int), ("n", ctypes.c_int), ("m", ctypes.c_int),
        ("n_train", ctypes.c_int), ("use_gp", ctypes.c_int),
        ("iterations", ctypes.c_int), ("substeps", ctypes.c_int),
        ("use_fallback", ctypes.c_int), ("n_est", ctypes.c_int), ("use_dob", ctypes.c_int),
        ("relin_per_tick", ctypes.c_int), ("plant_rows", ctypes.c_int),
        ("dt", ctypes.c_double),
        ("rho", ctypes.c_float), ("over_relax", ctypes.c_float),
        ("one_minus_over_relax", ctypes.c_float), ("yawrate_limit", ctypes.c_float),
        ("fallback_error_sq", ctypes.c_float), ("fallback_thrust_ceiling", ctypes.c_float),
        ("accel_lo", ctypes.c_float * 3), ("accel_hi", ctypes.c_float * 3),
        ("fallback_lo", ctypes.c_float * 3), ("fallback_hi", ctypes.c_float * 3),
    ]


_NOISY_OPERAND_NAMES = (
    "SxSwT", "SuTqT", "PM", "P1", "P0matT", "SuT", "lo_row", "hi_row",
    "ztrT", "sq2", "alpha_s", "y_mean", "inv_ls", "scal",
    "state_in", "est_in", "P_in", "aux_in", "xtail_in", "z_in", "y_in", "refs", "yaw_refs",
    "noise", "plant_rows", "q_diag", "r_diag", "nominal_row", "bdist",
    "packed", "state_out", "est_out", "P_out", "aux_out", "xtail_out", "z_out", "y_out",
)


class _NoisyTickOperands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _NOISY_OPERAND_NAMES]


NOISY_KERNEL_THREADS = 512    # csrc/noisy_tick_kernel.cu kThreads: K9's block

# csrc/noisy_tick_kernel.cu: beyond the vectors it lays out as K5 does, the
# truth (12), aux (16) and the GP's anchor (8), then the filter's arrays
# (estimate and prediction 16 each, q and r 32, stage states 48, P, Fd, Fd P
# at 15 x 15, four stage Jacobians and three chain terms at 12 x 12)
_FILTER_FLOATS = 2 * 16 + 32 + 48 + 3 * DOB_STATES**2 + 7 * 144


NOISY_SECTIONS = ("predict", "relinearise", "propagate", "fuse", "scalar section",
                  "filter warp", "GP and shift", "solve", "whole tick") + SOLVE_PHASES


def noisy_section_cycles() -> dict[str, int]:
    """K9's per-section clock cycles summed over the launches since the
    last call, then reset: warp 0's filter (predict, relinearise, propagate,
    fuse), its scalar section and its whole chain (this tick's scalar
    section, then the next tick's filter), the GP warps' GP and shift, the
    solve and the ADMM inside it, and the whole tick. Counted only by the
    build with section clocks: launch K9 inside
    ``_cuda.library_variant("noisy_tick", "noisy_tick_clocks")``,
    synchronise, then call this."""
    return _cuda.section_cycles("noisy_tick_clocks", "noisy_tick_section_cycles", NOISY_SECTIONS)


def noisy_shared_memory_bytes(n: int, nu: int = 4, nx: int = 6,
                              threads: int = NOISY_KERNEL_THREADS) -> int:
    """Dynamic shared memory of one K9 block: the vectors K5 lays out, the
    truth, aux and the GP's anchor, and the filter's arrays."""
    return 4 * (_vector_floats(n, nu, nx, threads, threads - 64, GP_GROUP, NOISY_GP_STAGES)
                + 12 + 16 + 8 + _FILTER_FLOATS)


def gpmpc_noisy_multitick_fused(
    data: FusedTickData,
    gp: GPRows | None,
    state: torch.Tensor,       # (12,) the truth
    est: torch.Tensor,         # (n_est,) estimate: 12 states, + 3 disturbance in observer mode
    P: torch.Tensor,           # (n_est, n_est) covariance
    aux: torch.Tensor,         # (13,) estimate x0 (6), integral (3), applied control (4)
    xtail: torch.Tensor,       # (Nnx,)
    z0: torch.Tensor,          # (m,) UNshifted previous slack
    y0: torch.Tensor,          # (m,) UNshifted previous dual
    refs: torch.Tensor,        # (K, Nnx)
    yaw_refs: torch.Tensor,    # (K,)
    noise: torch.Tensor,       # (K, 9) measurement noise (scaled) per measured lane
    plant_rows: torch.Tensor,  # (1, 10), or (K, 10) per tick (time-varying wind)
    q_diag: torch.Tensor,      # (n_est,) process noise variances
    r_diag: torch.Tensor,      # (9,) measurement noise variances
    *,
    k_ticks: int,
    use_gp: bool,
    rho: float,
    iterations: int,
    over_relax: float,
    dt: float,
    substeps: int,
    accel_lo: tuple,
    accel_hi: tuple,
    yawrate_limit: float,
    loop_precision: str = "highest",
    n: int = 0,
    nu: int = 4,
    nx: int = 6,
    fallback_error_m: float = 0.0,
    fallback_thrust_ceiling: float = 1.5,
    fallback_accel_scale: float = 1.5,
    relinearize_per_tick: bool = True,
    cov_precision: str = "highest",
    use_dob: bool = False,
    nominal_row: torch.Tensor | None = None,   # (10,) the observer's process model
    bdist: torch.Tensor | None = None,         # (15, 15) build_dob_bdist(dt)
):
    """K whole noisy ticks (EKF + MPC + allocation + plant) in one launch
    (K9).

    Each tick: the filter predicts one RK4 step at ``dt`` from the
    estimate and the previously applied control (process model: this
    tick's plant row, or ``nominal_row`` in observer mode, which also adds
    the disturbance's injection), relinearises ``F = I + Fd`` through the
    RK4 stages (per tick, or once per launch with ``relinearize_per_tick=
    False``), propagates P and fuses the 9 measured lanes (truth + noise)
    one by one; then K5's GP, MPC and scalar section run with the estimate
    as the controller state, the observer's disturbance added to the w
    rows, and the plant integrating the truth.

    Returns ``(packed (K, 47), state (12,), est (n_est,), P (n_est,
    n_est), aux (13,), xtail (Nnx,), z (m,), y (m,))``; packed lanes as K5,
    then the estimate 32:44 and the disturbance 44:47 (zero unless
    ``use_dob``). ``cov_precision`` and ``loop_precision`` are accepted for
    the JAX signature: the card computes in float32 either way."""
    _check_statics(n, nu, nx)
    if cov_precision not in ("highest", "bf16"):
        raise ValueError(f"cov_precision={cov_precision!r}: expected 'highest' or 'bf16'")
    dev = state.device
    N, K = n, k_ticks
    Nnx, m = N * nx, N * (nu + nx)
    n_est = DOB_STATES if use_dob else 12
    req = _cuda.require
    req(state, "state", (12,), dev)
    req(est, "est", (n_est,), dev)
    req(P, "P", (n_est, n_est), dev)
    req(aux, "aux", (NOISY_AUX_LANES,), dev)
    req(xtail, "xtail", (Nnx,), dev)
    req(z0, "z0", (m,), dev)
    req(y0, "y0", (m,), dev)
    req(refs, "refs", (K, Nnx), dev)
    req(yaw_refs, "yaw_refs", (K,), dev)
    req(noise, "noise", (K, len(EKF_MEAS_IDX)), dev)
    if plant_rows.shape[0] not in (1, K):
        raise ValueError(f"plant_rows has {plant_rows.shape[0]} rows, expected 1 or {K}")
    req(plant_rows, "plant_rows", (plant_rows.shape[0], PLANT_LANES), dev)
    req(q_diag, "q_diag", (n_est,), dev)
    req(r_diag, "r_diag", (len(EKF_MEAS_IDX),), dev)
    if use_dob:
        if nominal_row is None or bdist is None:
            raise ValueError("use_dob=True needs nominal_row and bdist")
        req(nominal_row, "nominal_row", (PLANT_LANES,), dev)
        req(bdist, "bdist", (DOB_STATES, DOB_STATES), dev)
    require_tick_data(data, N, dev)
    if use_gp:
        if gp is None:
            raise ValueError("use_gp=True needs GP rows")
        Pn, d = gp.sq2.shape[0], nu + nx
        req(gp.ztrT, "ztrT", (d, Pn), dev)
        req(gp.sq2, "sq2", (Pn,), dev)
        req(gp.alpha_s, "alpha_s", (Pn, 6), dev)
        req(gp.y_mean, "y_mean", (6,), dev)
        req(gp.inv_ls, "inv_ls", (2, d), dev)
        req(gp.scal, "scal", (3,), dev)
    statics = dict(
        k_ticks=k_ticks, use_gp=use_gp, rho=rho, iterations=iterations,
        over_relax=over_relax, dt=dt, substeps=substeps, accel_lo=accel_lo,
        accel_hi=accel_hi, yawrate_limit=yawrate_limit, loop_precision=loop_precision,
        n=n, nu=nu, nx=nx, fallback_error_m=fallback_error_m,
        fallback_thrust_ceiling=fallback_thrust_ceiling,
        fallback_accel_scale=fallback_accel_scale,
        relinearize_per_tick=relinearize_per_tick, cov_precision=cov_precision,
        use_dob=use_dob, nominal_row=nominal_row, bdist=bdist,
    )
    args = (data, gp, state, est, P, aux, xtail, z0, y0, refs, yaw_refs, noise, plant_rows,
            q_diag, r_diag)
    if dev.type == "cpu":
        return noisy_multitick_staged(*args, **statics)
    if dev.type != "cuda":
        raise ValueError(f"gpmpc_noisy_multitick_fused runs on cuda or cpu, not {dev}")

    smem = noisy_shared_memory_bytes(N, nu, nx)
    limit = _cuda.shared_memory_optin(dev)
    if smem > limit:
        raise ValueError(
            f"horizon {N}: P1 ({m}x{m}), the tick vectors and the filter need {smem} bytes "
            f"of shared memory, more than one block's {limit}; streaming P1 from L2 for "
            "long horizons is queued in ROADMAP.md"
        )
    f = lambda v: float(np.float32(v))
    params = _NoisyTickParams(
        k_ticks=K, n=N, m=m, n_train=(gp.sq2.shape[0] if use_gp else 0),
        use_gp=int(bool(use_gp)), iterations=int(iterations), substeps=int(substeps),
        use_fallback=int(fallback_error_m > 0.0), n_est=n_est, use_dob=int(bool(use_dob)),
        relin_per_tick=int(bool(relinearize_per_tick)), plant_rows=plant_rows.shape[0],
        dt=float(dt),
        rho=f(rho), over_relax=f(over_relax), one_minus_over_relax=f(1.0 - over_relax),
        yawrate_limit=f(yawrate_limit), fallback_error_sq=f(fallback_error_m**2),
        fallback_thrust_ceiling=f(fallback_thrust_ceiling),
        accel_lo=(ctypes.c_float * 3)(*accel_lo), accel_hi=(ctypes.c_float * 3)(*accel_hi),
        fallback_lo=(ctypes.c_float * 3)(*(fallback_accel_scale * v for v in accel_lo)),
        fallback_hi=(ctypes.c_float * 3)(*(fallback_accel_scale * v for v in accel_hi)),
    )
    empty = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)
    outs = dict(packed=empty(K, NOISY_PACKED_LANES), state_out=empty(12), est_out=empty(n_est),
                P_out=empty(n_est, n_est), aux_out=empty(NOISY_AUX_LANES), xtail_out=empty(Nnx),
                z_out=empty(m), y_out=empty(m))
    tensors = dict(
        SxSwT=data.SxSwT, SuTqT=data.SuTqT, PM=data.PM, P1=data.P1, P0matT=data.P0matT,
        SuT=data.SuT, lo_row=data.lo_row, hi_row=data.hi_row,
        state_in=state, est_in=est, P_in=P, aux_in=aux, xtail_in=xtail, z_in=z0, y_in=y0,
        refs=refs, yaw_refs=yaw_refs, noise=noise, plant_rows=plant_rows, q_diag=q_diag,
        r_diag=r_diag, **outs,
    )
    if use_gp:
        tensors.update(ztrT=gp.ztrT, sq2=gp.sq2, alpha_s=gp.alpha_s, y_mean=gp.y_mean,
                       inv_ls=gp.inv_ls, scal=gp.scal)
    if use_dob:
        tensors.update(nominal_row=nominal_row, bdist=bdist)
    ops = _NoisyTickOperands(**{k: v.data_ptr() for k, v in tensors.items()})
    fn = _cuda.library("noisy_tick").gpmpc_noisy_multitick_launch
    fn.argtypes = [ctypes.POINTER(_NoisyTickParams), ctypes.POINTER(_NoisyTickOperands),
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(ctypes.byref(params), ctypes.byref(ops), smem, _cuda.stream_of(state))
    _cuda.check(status, "gpmpc_noisy_multitick_fused")
    _cuda.count_launch("gpmpc_noisy_multitick_fused")
    return (outs["packed"], outs["state_out"], outs["est_out"], outs["P_out"], outs["aux_out"],
            outs["xtail_out"], outs["z_out"], outs["y_out"])
