"""Closed loop with the estimator in it (port of ``estimation/noisy_loop.py``):
sensors -> EKF -> MPC on the estimate -> allocation on the estimate ->
plant on the truth.

Three tiers, routed as in the JAX package:

* staged: one Python loop step per tick of PyTorch ops (the filter through
  ``ekf_step`` / ``dekf_step``, the MPC through ``LinearMPC.solve``);
* single-tick fused (``use_fused_tick=True``, ``ticks_per_dispatch=1``): one
  launch of K4 per tick with the estimate as its controller state, the
  staged ``ekf_step`` as PyTorch ops between launches;
* multi-tick (``use_fused_tick=True``, ``ticks_per_dispatch > 1``): K whole
  noisy ticks per launch of K9, the filter (or the 15-state disturbance
  observer) inside the kernel; with ``online_gp=`` the GP learns in flight
  from the estimates.

The 12-state family's loops: ``noisy_rigid_mpc_rollout`` (any engine of
the family on the estimate, the truth through kernel K10) and
``noisy_ltv_rollout`` (the LTV MPC at its own rate over a filter at the
sensor rate).

The sensor noise is drawn once per flight: standard normals (``(T, 9)``;
``(T, substeps, 9)`` for the LTV loop) from ``generator`` (or handed in as
``noise=``), scaled by ``sqrt(r)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .._device import full_f32_matmul, resolve_device
from ..control.allocation import attitude_loop_init, geometric_control_allocation
from ..control.mpc_linear import LinearMPC
from ..loop.closed_loop import (
    FlightLoopConfig,
    _applied_controls,
    _OnlineGP,
    _plant_row,
    _plant_substeps,
    _preview_references,
    _references,
    _stack_outs,
    _tick_references,
    _times,
)
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams
from .disturbance import (
    DisturbanceEKFConfig,
    dekf_init,
    dekf_step,
    disturbance_residual_rows,
    disturbance_residual_rows12,
)
from .ekf import MEAS_DIM, EKFConfig, ekf_init, ekf_step, measure

_HOVER = (1.0, 0.0, 0.0, 0.0)   # the control applied before the first tick


def flight_winds(wind_fn: Callable, t: torch.Tensor) -> torch.Tensor:
    """The ``(T, 3)`` true wind at the flight's tick times ``t (T,)``.

    ``wind_fn`` has either calling form: the JAX package's per-time
    ``wind_fn(t 0-d) -> (3,)``, evaluated at each tick's time, or the
    whole-flight ``wind_fn(t (T,)) -> (T, 3)``. A callable whose result on
    a single time is not ``(3,)`` (it indexes or broadcasts over the time
    axis) is taken as the whole-flight form. Any other shape raises
    ``ValueError``, so no row is read as another tick's wind."""
    T = t.shape[0]
    try:
        first = torch.as_tensor(wind_fn(t[0]))
    except (IndexError, RuntimeError):
        first = None          # the whole-flight form: it needs the time axis
    if first is not None and tuple(first.shape) == (3,):
        winds = torch.stack([torch.as_tensor(wind_fn(t[i])) for i in range(T)])
    else:
        winds = torch.as_tensor(wind_fn(t))
    if tuple(winds.shape) != (T, 3):
        raise ValueError(f"wind_fn gave shape {tuple(winds.shape)}: expected (3,) for one "
                         f"time or ({T}, 3) for the flight's {T} times")
    return winds.to(device=t.device)


def _noise_draws(noise, generator, shape, dtype, dev):
    """The flight's standard-normal sensor draws: ``noise`` as given, or
    drawn once from ``generator``; checked against ``shape``."""
    if noise is None:
        if generator is None:
            raise ValueError(f"pass generator= (a torch.Generator) or noise= {shape} draws")
        noise = torch.randn(*shape, generator=generator, device=generator.device, dtype=dtype)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {tuple(shape)}")
    return noise.to(device=dev)


def noisy_mpc_flight_rollout(
    mpc: LinearMPC,
    reference_fn: Callable,
    num_steps: int,
    generator: torch.Generator | None = None,
    ekf_cfg: EKFConfig = EKFConfig(),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    cfg: FlightLoopConfig = FlightLoopConfig(),
    initial_state: torch.Tensor | None = None,
    residual_fn: Callable | None = None,
    preview: bool = False,
    gp_posterior=None,
    gp_gain: float = 0.1,
    gp_dt: float = 0.02,
    online_gp=None,
    initial_dataset=None,
    disturbance_observer=None,
    nominal_body: RigidBodyParams | None = None,
    wind_fn: Callable | None = None,
    dtype=torch.float32,
    device=None,
    noise: torch.Tensor | None = None,
    plain_kernels: bool = False,
):
    """MPC flight on the estimate from noisy sensors.

    ``generator`` (a ``torch.Generator``) draws the flight's ``(T, 9)``
    standard-normal sensor noise once, before the first tick; ``noise``
    hands in those draws instead (e.g. another package's, to fly the same
    sensor stream draw for draw). One of the two is required.

    ``disturbance_observer`` (a ``DisturbanceEKFConfig``, or ``True`` for
    the defaults on ``ekf_cfg``; staged or multi-tick tier) swaps the
    12-state filter for the 15-state observer, whose acceleration estimate
    reaches the MPC as stage-wise feedforward (summed with the GP's rows).
    ``nominal_body`` is the observer's process model (default: ``body``
    without wind). ``wind_fn`` makes the true wind vary in time (staged or
    multi-tick tier), in the JAX package's form ``wind_fn(t) -> (3,)`` or as
    ``wind_fn(t (T,)) -> (T, 3)`` (``flight_winds``); the 12-state filter
    predicts with the same wind. ``online_gp`` (multi-tick tier) learns from the
    estimates: each launch's last transition is completed by the next
    launch's first estimate.

    Adds ``state_est``, ``meas_pos``, ``final_covariance`` and, with the
    observer, ``disturbance_est`` to the outputs of ``mpc_flight_rollout``.
    ``device`` defaults to ``cuda`` and must match the MPC's;
    ``plain_kernels=True`` flies the kernels' plain versions instead."""
    dev = resolve_device(device)
    if mpc.device != dev:
        raise ValueError(f"the MPC lives on {mpc.device}, the flight on {dev}")
    if initial_state is None:
        initial_state = torch.zeros(12, dtype=dtype, device=dev)
        initial_state[2] = cfg.takeoff_height
    initial_state = initial_state.to(device=dev)
    multitick = cfg.use_fused_tick and cfg.ticks_per_dispatch > 1
    if online_gp is not None and not multitick:
        raise ValueError(
            "online_gp= on the noisy loop requires the fused multi-tick path "
            "(FlightLoopConfig.use_fused_tick=True, ticks_per_dispatch > 1)"
        )
    if initial_dataset is not None and online_gp is None:
        raise ValueError("initial_dataset= only makes sense with online_gp=")
    if disturbance_observer is not None and disturbance_observer is not False:
        if cfg.use_fused_tick and not multitick:
            raise ValueError(
                "disturbance_observer= on the fused path requires the multi-tick kernel "
                "(ticks_per_dispatch > 1): the single-tick tier carries the 12-state filter"
            )
        dob_cfg = (DisturbanceEKFConfig(base=ekf_cfg) if disturbance_observer is True
                   else disturbance_observer)
        if nominal_body is None:
            nominal_body = dataclasses.replace(body, wind=(0.0, 0.0, 0.0))
    else:
        dob_cfg = None
    if wind_fn is not None and cfg.use_fused_tick and not multitick:
        raise ValueError(
            "wind_fn= (time-varying wind) runs on the staged path or the fused multi-tick "
            "path (ticks_per_dispatch > 1); the single-tick kernel takes the wind as a "
            "per-launch constant"
        )
    noise = _noise_draws(noise, generator, (num_steps, MEAS_DIM),
                         torch.float32 if cfg.use_fused_tick else dtype, dev)
    full_f32_matmul()
    if cfg.use_fused_tick:
        if multitick:
            if residual_fn is not None and gp_posterior is None:
                raise ValueError(
                    "the noisy multi-tick kernel computes the GP inside the kernel: pass the "
                    "raw posterior via gp_posterior= instead of residual_fn (or use "
                    "ticks_per_dispatch=1)"
                )
            return _fused_noisy_multitick_rollout(
                mpc, reference_fn, num_steps, noise, ekf_cfg, body, rate_loop, cfg,
                initial_state, preview, gp_posterior, gp_gain, gp_dt, online_gp,
                initial_dataset, dob_cfg, nominal_body, wind_fn, plain_kernels,
            )
        return _fused_noisy_rollout(mpc, reference_fn, num_steps, noise, ekf_cfg, body,
                                    rate_loop, cfg, initial_state, residual_fn, preview,
                                    plain_kernels)
    return _staged_noisy_rollout(mpc, reference_fn, num_steps, noise, ekf_cfg, body, rate_loop,
                                 cfg, initial_state, residual_fn, preview, dob_cfg,
                                 nominal_body, wind_fn, dtype, plain_kernels)


def _staged_noisy_rollout(mpc, reference_fn, num_steps, noise, ekf_cfg, body, rate_loop, cfg,
                          initial_state, residual_fn, preview, dob_cfg, nominal_body, wind_fn,
                          dtype, plain_kernels):
    """One Python step per tick: the same reference, allocation and plant
    as the staged ``mpc_flight_rollout``, with the controller on the
    estimate."""
    dev = initial_state.device
    kw = dict(dtype=dtype, device=dev)
    accel_lo = torch.tensor(cfg.accel_lower, **kw)
    accel_hi = torch.tensor(cfg.accel_upper, **kw)
    N = mpc.config.horizon
    pos_refs, yaw_refs = _references(reference_fn, num_steps, cfg, dtype, dev)
    ref_states = (_preview_references(reference_fn, num_steps, N, cfg, dtype, dev)
                  .reshape(num_steps, N, 6) if preview else None)
    # the wind of every tick, read to the host once
    winds = (flight_winds(wind_fn, _times(num_steps, cfg.control_dt, dtype, dev)).to(dtype)
             .tolist() if wind_fn is not None else None)
    # sensor model: the observer's base config when one was passed
    meas_cfg = dob_cfg.base if dob_cfg is not None else ekf_cfg

    state = initial_state.to(dtype)
    ekf = (dekf_init(state, dob_cfg, dtype) if dob_cfg is not None
           else ekf_init(state, ekf_cfg, dtype))
    mpc_carry = mpc.init_carry(state[0:6])
    att_carry = attitude_loop_init(dtype, dev)
    prev_control = torch.tensor(_HOVER, **kw)
    rows = []
    for i in range(num_steps):
        pos_ref, yaw_ref = pos_refs[i], yaw_refs[i]
        body_t = body if winds is None else dataclasses.replace(body, wind=tuple(winds[i]))
        # a sensor sample of the truth; the filter predicts with the
        # control applied over the last interval
        z = measure(state, noise[i], meas_cfg)
        if dob_cfg is not None:
            # the observer predicts with the NOMINAL model: what it cannot
            # explain lands in d
            ekf, x_est, d_est = dekf_step(ekf, prev_control, z, nominal_body, rate_loop,
                                          cfg.control_dt, dob_cfg)
        else:
            ekf, x_est = ekf_step(ekf, prev_control, z, body_t, rate_loop, cfg.control_dt,
                                  ekf_cfg)
        residuals = (residual_fn(mpc_carry.X_prev, mpc_carry.U_prev)
                     if residual_fn is not None else None)
        if dob_cfg is not None:
            dob_rows = disturbance_residual_rows(d_est, N, dtype)
            residuals = dob_rows if residuals is None else residuals + dob_rows
        u_opt, X_opt, mpc_carry = mpc.solve(
            mpc_carry, x_est[0:6], pos_ref, residuals,
            reference_states=ref_states[i] if preview else None, plain_kernels=plain_kernels,
        )
        accel_des = torch.minimum(torch.maximum(u_opt[0:3], accel_lo), accel_hi)
        yawrate_des = torch.clamp(u_opt[3], -cfg.yawrate_limit, cfg.yawrate_limit)
        thrust, rate_cmd, att_sp, att_carry = geometric_control_allocation(
            att_carry, accel_des, yaw_ref, yawrate_des, x_est[6:9], x_est[9:12],
            dt_attitude=cfg.control_dt,
        )
        control = torch.cat([thrust[None], rate_cmd])
        new_state = _plant_substeps(state, control, body_t, rate_loop, cfg, plain=plain_kernels)
        row = {
            "state": state, "state_est": x_est, "meas_pos": z[0:3], "pos_ref": pos_ref,
            "vel_ref": X_opt[1, 3:6], "att_ref": att_sp, "thrust": thrust,
            "rates_cmd": rate_cmd, "accel_cmd": accel_des, "u_mpc": u_opt,
        }
        if dob_cfg is not None:
            row["disturbance_est"] = d_est
        rows.append(row)
        state, prev_control = new_state, control
    outs = _stack_outs(rows)
    outs["final_state"] = state
    outs["final_covariance"] = ekf.P
    return outs


def _fused_noisy_rollout(mpc, reference_fn, num_steps, noise, ekf_cfg, body, rate_loop, cfg,
                         initial_state, residual_fn, preview, plain_kernels):
    """One K4 launch per tick with the estimate as its controller state
    (MPC, fallback and allocation fly the estimate, the kernel's plant the
    truth); the staged ``ekf_step`` runs as PyTorch ops between launches.
    Flies float32."""
    from ..models.double_integrator import CONTROL_DIM, STATE_DIM
    from ..ops.tick_pallas import gpmpc_tick_fused, gpmpc_tick_fused_plain

    if not mpc.config.use_fused_controller:
        raise ValueError("use_fused_tick requires LinearMPCConfig.use_fused_controller=True")
    N = mpc.config.horizon
    dev = initial_state.device
    f32 = torch.float32
    tick = gpmpc_tick_fused_plain if plain_kernels else gpmpc_tick_fused
    statics = dict(
        rho=mpc.config.admm_rho, iterations=mpc.config.admm_iterations,
        over_relax=mpc.config.admm_over_relax,
        dt=cfg.control_dt, substeps=cfg.plant_substeps,
        accel_lo=tuple(cfg.accel_lower), accel_hi=tuple(cfg.accel_upper),
        yawrate_limit=cfg.yawrate_limit, fallback_error_m=cfg.fallback_error_m,
        fallback_thrust_ceiling=cfg.fallback_thrust_ceiling,
        fallback_accel_scale=cfg.fallback_accel_scale,
        loop_precision=cfg.fused_tick_loop_precision, n=N, nu=CONTROL_DIM, nx=STATE_DIM,
    )
    data = mpc._tick_data
    plant_row = _plant_row(body, rate_loop, dev)
    pos_refs, yaw_refs, refs = _tick_references(reference_fn, num_steps, N, cfg, preview, f32,
                                                dev)
    noise = noise.to(f32)
    w = torch.zeros(N * STATE_DIM, dtype=f32, device=dev)

    state = initial_state.to(f32)
    ekf = ekf_init(state, ekf_cfg, f32)
    init = mpc.init_carry(state[0:6])
    slack, dual = init.slack.to(f32), init.dual.to(f32)
    X_prev, U_prev = init.X_prev.to(f32), init.U_prev.to(f32)
    integral = torch.zeros(3, dtype=f32, device=dev)
    prev_control = torch.tensor(_HOVER, dtype=f32, device=dev)
    rows = []
    for i in range(num_steps):
        z_meas = measure(state, noise[i], ekf_cfg)
        ekf, x_est = ekf_step(ekf, prev_control, z_meas, body, rate_loop, cfg.control_dt,
                              ekf_cfg)
        if residual_fn is not None:
            w = (cfg.control_dt * residual_fn(X_prev, U_prev).to(f32)).reshape(-1)
        misc = torch.cat([yaw_refs[i : i + 1], integral])
        packed, slack, dual, _, X_tail = tick(data, state, w, refs[i], misc, slack, dual,
                                              plant_row, ctrl_state=x_est.contiguous(), **statics)
        U_prev = slack[: N * CONTROL_DIM].reshape(N, CONTROL_DIM)
        X_prev = torch.cat([x_est[None, 0:6], X_tail.reshape(N, STATE_DIM)], dim=0)
        rows.append({
            "state": state, "state_est": x_est, "meas_pos": z_meas[0:3], "pos_ref": pos_refs[i],
            "vel_ref": X_prev[1, 3:6], "att_ref": packed[16:19], "thrust": packed[12],
            "rates_cmd": packed[13:16], "accel_cmd": packed[22:25], "u_mpc": U_prev[0],
        })
        state, integral, prev_control = packed[0:12], packed[19:22], packed[12:16]
    outs = _stack_outs(rows)
    outs["final_state"] = state
    outs["final_covariance"] = ekf.P
    return outs


def _fused_noisy_multitick_rollout(mpc, reference_fn, num_steps, noise, ekf_cfg, body, rate_loop,
                                   cfg, initial_state, preview, gp_posterior, gp_gain, gp_dt,
                                   online_gp, initial_dataset, dob_cfg, nominal_body, wind_fn,
                                   plain_kernels):
    """K whole noisy ticks per launch of K9: the filter (or the observer)
    inside the kernel, P re-symmetrised after every launch. The sensor
    noise, references and (with ``wind_fn``) per-tick plant rows of the
    whole flight are built before the first launch."""
    from ..models.double_integrator import CONTROL_DIM, STATE_DIM
    from ..ops.tick_pallas import (
        build_dob_bdist,
        build_gp_rows,
        gpmpc_noisy_multitick_fused,
        noisy_multitick_staged,
    )

    if not mpc.config.use_fused_controller:
        raise ValueError("use_fused_tick requires LinearMPCConfig.use_fused_controller=True")
    use_dob = dob_cfg is not None
    if use_dob:
        # the observer's cadence, precision and sensor model live on its
        # base config (the staged tier's sensor-model choice)
        ekf_cfg = dob_cfg.base
    if ekf_cfg.relinearize_every not in ("tick", "dispatch"):
        raise ValueError(
            f"EKFConfig.relinearize_every={ekf_cfg.relinearize_every!r}: expected 'tick' "
            "(exact, default) or 'dispatch' (frozen F within each multi-tick launch)"
        )
    if ekf_cfg.cov_precision not in ("highest", "bf16"):
        raise ValueError(
            f"EKFConfig.cov_precision={ekf_cfg.cov_precision!r}: expected 'highest' or 'bf16'"
        )
    K = cfg.ticks_per_dispatch
    if num_steps % K != 0:
        raise ValueError(f"num_steps={num_steps} not divisible by ticks_per_dispatch={K}")
    N = mpc.config.horizon
    dev = initial_state.device
    f32 = torch.float32
    data = mpc._tick_data
    online = online_gp is not None
    if online:
        if gp_posterior is not None:
            raise ValueError("online_gp builds its posterior in-flight; drop gp_posterior")
        if online_gp.refit_every < K:
            raise ValueError(
                f"online_gp.refit_every={online_gp.refit_every} must be >= "
                f"ticks_per_dispatch={K} (refits happen at launch boundaries)"
            )
        learner = _OnlineGP(online_gp, initial_dataset, gp_gain, cfg.control_dt, dev)
    else:
        gp = (build_gp_rows(gp_posterior, gp_gain, control_dt=cfg.control_dt, gp_dt=gp_dt)
              if gp_posterior is not None else None)
    tick = noisy_multitick_staged if plain_kernels else gpmpc_noisy_multitick_fused
    statics = dict(
        k_ticks=K, use_gp=online or gp_posterior is not None,
        rho=mpc.config.admm_rho, iterations=mpc.config.admm_iterations,
        over_relax=mpc.config.admm_over_relax,
        dt=cfg.control_dt, substeps=cfg.plant_substeps,
        accel_lo=tuple(cfg.accel_lower), accel_hi=tuple(cfg.accel_upper),
        yawrate_limit=cfg.yawrate_limit, fallback_error_m=cfg.fallback_error_m,
        fallback_thrust_ceiling=cfg.fallback_thrust_ceiling,
        fallback_accel_scale=cfg.fallback_accel_scale,
        loop_precision=cfg.fused_tick_loop_precision, n=N, nu=CONTROL_DIM, nx=STATE_DIM,
        relinearize_per_tick=ekf_cfg.relinearize_every == "tick",
        cov_precision=ekf_cfg.cov_precision, use_dob=use_dob,
    )
    plant_row = _plant_row(body, rate_loop, dev)
    if wind_fn is None:
        plant_rows = plant_row[None]
    else:
        # per-tick plant rows: the kernel reads tick t's row, the staged
        # tier's per-tick wind
        winds = flight_winds(wind_fn, _times(num_steps, cfg.control_dt, f32, dev)).to(f32)
        plant_rows = torch.cat([plant_row[:7].expand(num_steps, 7), winds], dim=1)
    if use_dob:
        statics.update(nominal_row=_plant_row(nominal_body, rate_loop, dev),
                       bdist=build_dob_bdist(cfg.control_dt, dev))
    q_diag = (dob_cfg if use_dob else ekf_cfg).q_diag(dev)
    p0_diag = (dob_cfg if use_dob else ekf_cfg).p0_diag(dev)
    r_diag = ekf_cfg.r_diag(dev)
    noise9 = (torch.sqrt(r_diag) * noise.to(f32)).contiguous()
    pos_refs, yaw_refs, refs_all = _tick_references(reference_fn, num_steps, N, cfg, preview,
                                                    f32, dev)

    # the staged tier's start: the estimate at the truth, hover applied
    x0 = initial_state.to(f32)
    m = mpc.n_constraints
    zeros = lambda k: torch.zeros(k, dtype=f32, device=dev)
    state = x0.clone()
    est = torch.cat([x0, zeros(3)]) if use_dob else x0.clone()
    P = torch.diag(p0_diag)
    aux = torch.cat([x0[0:6], zeros(3), torch.tensor(_HOVER, dtype=f32, device=dev)])
    xtail = x0[0:6].repeat(N).contiguous()
    z, y = zeros(m), zeros(m)

    chunks, pending = [], None
    for i in range(num_steps // K):
        sl = slice(i * K, (i + 1) * K)
        refs = refs_all[sl]
        packed, state, est, P, aux, xtail, z, y = tick(
            data, learner.rows if online else gp, state, est, P, aux, xtail, z, y, refs,
            yaw_refs[sl].contiguous(), noise9[sl], plant_rows if wind_fn is None else
            plant_rows[sl].contiguous(), q_diag, r_diag, **statics,
        )
        P = (0.5 * (P + P.T)).contiguous()   # re-symmetrise once per launch
        chunks.append(packed)
        if online:
            # transitions est_k -> est_{k+1} under the applied command.
            # est_{k+1} of a launch's last tick is formed only by the next
            # launch's first predict + fuse, so that sample waits for it
            est_rows = packed[:, 32:44]
            controls = _applied_controls(packed, refs, packed[:, 32:35], cfg)
            if pending is None:
                pre, ctl, nxt = est_rows[:-1], controls[:-1], est_rows[1:]
            else:
                pre = torch.cat([pending[0][None], est_rows[:-1]], dim=0)
                ctl = torch.cat([pending[1][None], controls[:-1]], dim=0)
                nxt = est_rows
            learner.capture(pre, ctl, nxt, i, K)
            pending = (est_rows[-1], controls[-1])

    packed = torch.cat(chunks, dim=0)
    outs = {
        "state": packed[:, 0:12],
        "state_est": packed[:, 32:44],
        "meas_pos": packed[:, 0:3] + noise9[:, 0:3],
        "pos_ref": pos_refs,
        "vel_ref": packed[:, 29:32],
        "att_ref": packed[:, 16:19],
        "thrust": packed[:, 12],
        "rates_cmd": packed[:, 13:16],
        "accel_cmd": packed[:, 22:25],
        "u_mpc": packed[:, 25:29],
    }
    if use_dob:
        outs["disturbance_est"] = packed[:, 44:47]
    if online:
        outs["gp_count"] = torch.cat(learner.counts)
    outs["final_state"] = state
    outs["final_covariance"] = P
    return outs


def noisy_rigid_mpc_rollout(
    controller,
    reference_fn: Callable,
    num_steps: int,
    generator: torch.Generator | None = None,
    ekf_cfg: EKFConfig = EKFConfig(),
    body: RigidBodyParams | None = None,
    dt: float = 0.02,
    initial_state: torch.Tensor | None = None,
    takeoff_height: float = 3.0,
    plant_step_fn: Callable | None = None,
    plant_step_tfn: Callable | None = None,
    process_step_fn: Callable | None = None,
    yaw_channel: bool = True,
    disturbance_observer=None,
    dtype=torch.float32,
    device=None,
    noise: torch.Tensor | None = None,
    plain_kernels: bool = False,
):
    """Noisy-sensor loop of the 12-state family: sensors -> EKF ->
    controller on the estimate -> torque-input rigid body on the truth.

    ``controller`` is any engine of the family with the ``solve(carry,
    state12, target_pos, target_yaw)`` surface (``ILQRRigidBodyMPC``,
    ``RigidBodyMPC``, ``MPPIController``); ``reference_fn(t 0-d) ->
    (pos_ref, yaw_ref)``. The filter's process model is the rigid body's
    RK4 step (``body``, default ``X500_PARAMS``; the filter takes its
    ``jacfwd``), and the truth steps through
    ``ops.rigid_plant_pallas.rigid_body_rk4_step_fast``: kernel K10 for a
    CUDA state (its plain version with ``plain_kernels=True``).

    ``plant_step_fn(x, u)`` replaces the truth and ``process_step_fn`` the
    filter's model (default: the truth's); ``plant_step_tfn(x, u, t)`` is a
    time-varying truth and needs an explicit ``process_step_fn``.
    ``yaw_channel=False`` for engines whose ``solve`` takes no yaw
    (direct-rate). ``disturbance_observer`` (a ``DisturbanceEKFConfig`` or
    ``True``) runs the 15-state observer and feeds its estimate to the
    engine as ``(N, 12)`` ``residuals=`` rows; it needs the residual-channel
    engine (``yaw_channel=False``).

    ``generator`` draws the flight's ``(T, 9)`` standard-normal sensor
    noise once, before the first tick, or ``noise`` hands it in; each
    sample is scaled by ``sqrt(r)`` (``measure``). Returns ``state``,
    ``state_est``, ``meas_pos``, ``pos_ref``, ``u`` (T, .), with the
    observer ``disturbance_est``, and ``final_state`` and
    ``final_covariance``. ``device`` defaults to ``cuda``."""
    from ..models.params import X500_PARAMS
    from ..models.rigid_body import rigid_body_rk4_step
    from ..ops.rigid_plant_pallas import rigid_body_rk4_step_fast

    dev = resolve_device(device)
    if body is None:
        body = X500_PARAMS
    if initial_state is None:
        initial_state = torch.zeros(12, dtype=dtype, device=dev)
        initial_state[2] = takeoff_height
    state = initial_state.to(dtype=dtype, device=dev)

    if plant_step_tfn is not None:
        if plant_step_fn is not None:
            raise ValueError("pass plant_step_fn OR plant_step_tfn, not both")
        if process_step_fn is None:
            raise ValueError(
                "plant_step_tfn= (time-varying truth) requires an explicit process_step_fn: "
                "the filter's model must not silently track the disturbance being estimated"
            )
    elif plant_step_fn is None:
        plant_step_fn = lambda x, u: rigid_body_rk4_step_fast(x, u, body, dt,
                                                              plain_kernels=plain_kernels)
        if process_step_fn is None:
            process_step_fn = lambda x, u: rigid_body_rk4_step(x, u, body, dt)
    elif process_step_fn is None:
        process_step_fn = plant_step_fn

    if disturbance_observer is not None and disturbance_observer is not False:
        if yaw_channel:
            raise ValueError(
                "disturbance_observer= on the 12-state loop requires the residual-channel "
                "engine (direct-rate: solve(carry, x, pos, residuals=), yaw_channel=False); "
                "the SQP/iLQR/MPPI solves have no residual input"
            )
        dob_cfg = (DisturbanceEKFConfig(base=ekf_cfg) if disturbance_observer is True
                   else disturbance_observer)
        horizon12 = int(controller.mpc.config.horizon)
    else:
        dob_cfg = None
    meas_cfg = dob_cfg.base if dob_cfg is not None else ekf_cfg
    noise = _noise_draws(noise, generator, (num_steps, MEAS_DIM), dtype, dev)
    full_f32_matmul()

    times = torch.arange(num_steps, dtype=dtype, device=dev) * dt
    ekf = (dekf_init(state, dob_cfg, dtype) if dob_cfg is not None
           else ekf_init(state, ekf_cfg, dtype))
    mc = controller.init_carry(state)
    prev_u = controller.u_hover.to(dtype)
    rows = []
    for i in range(num_steps):
        t = times[i]
        pos_ref, yaw_ref = reference_fn(t)
        pos_ref = torch.as_tensor(pos_ref, dtype=dtype, device=dev)
        yaw_ref = torch.as_tensor(yaw_ref, dtype=dtype, device=dev)
        z = measure(state, noise[i], meas_cfg)
        if dob_cfg is not None:
            ekf, x_est, d_est = dekf_step(ekf, prev_u, z, dt=dt, config=dob_cfg,
                                          step_fn=process_step_fn)
        else:
            ekf, x_est = ekf_step(ekf, prev_u, z, dt=dt, config=ekf_cfg, step_fn=process_step_fn)
        if yaw_channel:
            u, _, mc = controller.solve(mc, x_est, pos_ref, yaw_ref)
        elif dob_cfg is not None:
            rows12 = disturbance_residual_rows12(d_est, horizon12, dtype)
            u, _, mc = controller.solve(mc, x_est, pos_ref, residuals=rows12)
        else:
            u, _, mc = controller.solve(mc, x_est, pos_ref)
        new_state = (plant_step_fn(state, u) if plant_step_tfn is None
                     else plant_step_tfn(state, u, t))
        row = {"state": state, "state_est": x_est, "meas_pos": z[0:3], "pos_ref": pos_ref,
               "u": u}
        if dob_cfg is not None:
            row["disturbance_est"] = d_est
        rows.append(row)
        state, prev_u = new_state, u
    outs = _stack_outs(rows)
    outs["final_state"] = state
    outs["final_covariance"] = ekf.P
    return outs


def noisy_ltv_rollout(
    controller,
    reference_window_fn: Callable,
    num_steps: int,
    generator: torch.Generator | None = None,
    ekf_cfg: EKFConfig = EKFConfig(),
    body: RigidBodyParams | None = None,
    dt_plant: float = 0.01,
    substeps_per_tick: int = 10,
    obstacles: torch.Tensor | None = None,
    initial_state: torch.Tensor | None = None,
    disturbance_observer=None,
    nominal_body: RigidBodyParams | None = None,
    dtype=torch.float32,
    device=None,
    noise: torch.Tensor | None = None,
    plain_kernels: bool = False,
):
    """Multi-rate noisy loop of the LTV tracking MPC: the plant and the
    filter at the sensor rate (``dt_plant``), the controller every
    ``substeps_per_tick`` plant steps, flying the estimate while the truth
    integrates its control under zero-order hold.

    ``controller`` is an ``LTVTrackingMPC``; ``reference_window_fn(i int)
    -> (N+1, 12)`` is control tick i's window of stage references (and its
    first row the default start). The truth steps through
    ``rigid_body_rk4_step_fast`` on ``body`` (default
    ``GZ_QUADROTOR_PARAMS``): K10 for a CUDA state, its plain version with
    ``plain_kernels=True``; the filter predicts with the plain
    ``rigid_body_rk4_step``. ``obstacles (n_obs, 4)`` go to every solve.
    ``disturbance_observer`` (a ``DisturbanceEKFConfig`` or ``True``) runs
    the 15-state observer over the NOMINAL body (``nominal_body``, default
    ``body`` without wind) and feeds its estimate to the solve as ``(N,
    12)`` ``residuals=`` rows.

    ``generator`` draws the flight's ``(T, substeps_per_tick, 9)``
    standard-normal sensor draws once, or ``noise`` hands them in. Returns
    one row per control tick: ``state``, ``state_est`` and ``pos_ref`` at
    the tick, the applied ``u``, the tick's last ``meas_pos``, with the
    observer ``disturbance_est``; and ``final_state``,
    ``final_covariance``. ``device`` defaults to ``cuda``."""
    from ..models.params import GZ_QUADROTOR_PARAMS
    from ..models.rigid_body import rigid_body_rk4_step
    from ..ops.rigid_plant_pallas import rigid_body_rk4_step_fast

    dev = resolve_device(device)
    if body is None:
        body = GZ_QUADROTOR_PARAMS
    if initial_state is None:
        initial_state = reference_window_fn(0)[0]
    state = initial_state.to(dtype=dtype, device=dev)

    if disturbance_observer is not None and disturbance_observer is not False:
        dob_cfg = (DisturbanceEKFConfig(base=ekf_cfg) if disturbance_observer is True
                   else disturbance_observer)
        if nominal_body is None:
            nominal_body = dataclasses.replace(body, wind=(0.0, 0.0, 0.0))
        horizon12 = int(controller.mpc.config.horizon)
    else:
        dob_cfg = None
    meas_cfg = dob_cfg.base if dob_cfg is not None else ekf_cfg
    process_body = nominal_body if dob_cfg is not None else body
    plant_step_fn = lambda x, u: rigid_body_rk4_step_fast(x, u, body, dt_plant,
                                                          plain_kernels=plain_kernels)
    process_step_fn = lambda x, u: rigid_body_rk4_step(x, u, process_body, dt_plant)
    noise = _noise_draws(noise, generator, (num_steps, substeps_per_tick, MEAS_DIM), dtype,
                         dev)
    if obstacles is not None:
        obstacles = obstacles.to(dtype=dtype, device=dev)
    full_f32_matmul()

    ekf = (dekf_init(state, dob_cfg, dtype) if dob_cfg is not None
           else ekf_init(state, ekf_cfg, dtype))
    mc = controller.init_carry(state)
    rows = []
    for i in range(num_steps):
        window = reference_window_fn(i).to(dtype=dtype, device=dev)
        x_est = ekf.x[:12]
        if dob_cfg is not None:
            rows12 = disturbance_residual_rows12(ekf.x[12:], horizon12, dtype)
            u, _, mc = controller.solve(mc, x_est, window, residuals=rows12, obstacles=obstacles)
        else:
            u, _, mc = controller.solve(mc, x_est, window, obstacles=obstacles)
        row = {"state": state, "state_est": x_est, "pos_ref": window[0, 0:3], "u": u}
        if dob_cfg is not None:
            row["disturbance_est"] = ekf.x[12:]
        for j in range(substeps_per_tick):
            state = plant_step_fn(state, u)          # the truth under zero-order hold
            z = measure(state, noise[i, j], meas_cfg)
            if dob_cfg is not None:
                ekf, _, _ = dekf_step(ekf, u, z, dt=dt_plant, config=dob_cfg,
                                      step_fn=process_step_fn)
            else:
                ekf, _ = ekf_step(ekf, u, z, dt=dt_plant, config=ekf_cfg,
                                  step_fn=process_step_fn)
        row["meas_pos"] = z[0:3]
        rows.append(row)
    outs = _stack_outs(rows)
    outs["final_state"] = state
    outs["final_covariance"] = ekf.P
    return outs
