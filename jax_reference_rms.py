#!/usr/bin/env python3
"""Circle-task RMS of the JAX package's 12-state flights, and figure-8 RMS
of its GP-variance tightening flights, on the CPU: the yardstick for the
port's flights in ``chip_smoke.py`` phase 3.

    python3 jax_reference_rms.py

Flies, with the JAX package (``unmanned_aerial_vehicles_tpu``; its Pallas
kernels in interpret mode), the configurations that ``chip_smoke.py`` flies
through the port: the circle task of ``tools/bench_controllers.py``
(``ramped_circle_reference``, amplitude 2 m, 3 m high, 50 Hz, 400 ticks)
through the direct-rate12 and mpc12 fused multi-tick tiers (K=8, 30 ADMM
iterations, ``plan_roll="linear"``), the mpc12 ``sqp_multitick_rollout``
with the rigid plant, and the staged MPPI flight (512 x 25, seed 0); and
the LTV obstacle flight (10 Hz, K=2, 100 iterations, obstacle (0, 1.5, 1,
0.3), fallback, 200 ticks); and the iLQR engine on the circle task: the
staged RK4 engine (N=15, 3 iterations, 30 ticks) and the K=2 policy tier
(1 iteration, 100 ticks). And the 6-state figure-8
(``ramped_figure8_reference``, 6 m, 0.02 Hz, 3 m high, N=20, 10 ADMM
iterations) with tightening kappa 2: ``bench.py``'s tightening mode (the
frozen GP fitted on the seeded synthetic set, P=800, K=8, 400 ticks) and
``examples/09``'s online flight (wind (1.5, 0.8, 0), preview, fallback
1.5 m, P=256, refit every 250, K=8, 1000 ticks). And the three auto-tuners
at ``chip_smoke.py``'s widths: the cascade-PID tuner on the CLI's ``tune``
task (circle of 6 m at 3 m, 1500 ticks, settle 250, learning rate 0.06,
``PID_CAMPAIGN_RATE_LOOP``, the plant through its K1 custom VJP; 3
iterations), the fused MPC tuner (N=20, 10 ADMM iterations, K=20) and the
staged MPC tuner (``LinearMPCConfig()``, the allocation and plant through
K2's custom VJP), 200 ticks, settle 50, learning rate 0.08, 2 iterations
each: initial loss, loss trace and final loss; and whether the JAX
package's weight gradient through its tightened fused tier is finite
(kappa 2, the frozen GP, N=20, K=8, 16 ticks; fault F13). Prints one JSON
object of RMS values in metres, the LTV flight's minimum clearance from
the obstacle's surface and the tuners' losses. ``--tuners`` runs the
tuners alone, ``--ilqr`` the two iLQR flights alone. ``--campaign [DURATION]``
(default 132 s) flies the deterministic rows of ``tools/run_campaign.py``
as that tool flies them (``mpc_flight_figure8``, ``pid_flight_circle``,
``mpc_preview_{nowind,windy}_figure8``, ``mpc_perturbed_figure8``,
``gpmpc_online_{perturbed,windy}_figure8``, ``online_preview_figure8``;
none needs the GP corpus): the yardstick for the port's campaign rows.

Imports JAX; the port and ``chip_smoke.py`` do not. MPPI draws its
exploration noise from ``jax.random`` here and from a ``torch.Generator``
in the port, so its two flights see different noise; ``mppi12_port_cpu``
is the port's MPPI flight (its plain versions, on the CPU) flying the JAX
flight's own draws (``solve(..., eps=)``), the same task tick for tick.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from unmanned_aerial_vehicles_tpu.control import ILQRRigidBodyMPC, MPPIController  # noqa: E402
from unmanned_aerial_vehicles_tpu.control.mpc_rigid import (  # noqa: E402
    DirectRateMPC,
    LTVTrackingMPC,
    RigidBodyMPC,
)
from unmanned_aerial_vehicles_tpu.loop.rigid_loop import (  # noqa: E402
    direct_rate_multitick_fused,
    ilqr_multitick_rollout,
    make_attitude_recovery_fallback,
    rigid_multitick_fused,
    sqp_multitick_rollout,
)
from unmanned_aerial_vehicles_tpu.models import GZ_QUADROTOR_PARAMS, X500_PARAMS  # noqa: E402
from unmanned_aerial_vehicles_tpu.models import rigid_body_rk4_step  # noqa: E402
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference  # noqa: E402

T, LTV_T, DT, LDT = 400, 200, 0.02, 0.1
ILQR_STAGED_T, ILQR_K2_T = 30, 100      # chip_smoke.py's ILQR_STAGED_T, ILQR_K2_T
OBSTACLE = (0.0, 1.5, 1.0, 0.3)


def circle(t):
    return ramped_circle_reference(t, amplitude=2.0, height=3.0)


def rms(states, refs):
    return float(jnp.sqrt(jnp.mean(jnp.sum((states[:, 0:3] - refs) ** 2, -1))))


def circle_refs(T_):
    return jax.vmap(lambda t: circle(t)[0])(jnp.arange(T_, dtype=jnp.float32) * DT)


def reference_fn(N):
    def fn(ticks):
        pos = jax.vmap(lambda t: circle(t)[0])(ticks.astype(jnp.float32) * DT)
        stage = jnp.concatenate([pos, jnp.zeros((ticks.shape[0], 9))], axis=1)
        return jnp.tile(stage[:, None, :], (1, N, 1))
    return fn


def x_start():
    return jnp.zeros(12, jnp.float32).at[2].set(3.0)


def multitick(eng, fly, **kw):
    outs = jax.jit(lambda x: fly(eng.mpc, eng.cost, reference_fn(eng.mpc.config.horizon), x, T,
                                 ticks_per_dispatch=8, admm_iterations=30, u_init=eng.u_hover,
                                 plan_roll="linear", **kw))(x_start())
    return rms(outs["state"], circle_refs(T))


def mpc12_multitick():
    eng = RigidBodyMPC()
    plant = lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, DT)
    outs = jax.jit(lambda x: sqp_multitick_rollout(
        eng.mpc, eng.cost, reference_fn(eng.mpc.config.horizon), plant, x, T,
        ticks_per_dispatch=8, admm_iterations=30, u_init=eng.u_hover,
        plan_roll="linear"))(x_start())
    return rms(outs["state"], circle_refs(T))


def ltv_ref(t):
    w = 2.0 * jnp.pi / 20.0
    r = jnp.zeros(12, jnp.float32)
    r = r.at[0].set(1.5 * jnp.cos(w * t)).at[1].set(1.5 * jnp.sin(w * t)).at[2].set(1.0)
    return r.at[3].set(-1.5 * w * jnp.sin(w * t)).at[4].set(1.5 * w * jnp.cos(w * t))


def ltv12_obstacle():
    eng = LTVTrackingMPC(num_obstacles=1, obstacle_margin=0.2)
    N = eng.mpc.config.horizon

    def refs_fn(ticks):
        return jax.vmap(lambda i: jax.vmap(ltv_ref)((i + 1 + jnp.arange(N)).astype(jnp.float32)
                                                   * LDT))(ticks)

    def plant(x, u):
        def sub(xc, _):
            return rigid_body_rk4_step(xc, u, GZ_QUADROTOR_PARAMS, LDT / 2), None
        return jax.lax.scan(sub, x, None, length=2)[0]

    def roll(x, U, residuals):
        return jax.lax.scan(lambda c, u: (rigid_body_rk4_step(c, u, GZ_QUADROTOR_PARAMS, LDT),) * 2,
                            x, U)[1]

    outs = jax.jit(lambda x: sqp_multitick_rollout(
        eng.mpc, eng.cost, refs_fn, plant, x, LTV_T, ticks_per_dispatch=2, admm_iterations=100,
        u_init=eng.u_hover, obstacles=jnp.asarray([OBSTACLE], jnp.float32), plan_roll_fn=roll,
        fallback_fn=make_attitude_recovery_fallback(GZ_QUADROTOR_PARAMS)))(ltv_ref(0.0))
    refs = jax.vmap(ltv_ref)(jnp.arange(LTV_T, dtype=jnp.float32) * LDT)[:, 0:3]
    dist = jnp.linalg.norm(outs["state"][:, 0:3] - jnp.asarray(OBSTACLE[:3]), axis=1)
    return rms(outs["state"], refs), float(dist.min() - OBSTACLE[3])


def mppi12():
    ctrl = MPPIController()

    def step(c, i):
        st, mc = c
        pos_ref, _, yaw_ref = circle(i.astype(jnp.float32) * DT)
        u, _, mc = ctrl.solve(mc, st, pos_ref, yaw_ref)
        st = rigid_body_rk4_step(st, u, X500_PARAMS, DT)
        return (st, mc), st

    x0 = x_start()
    _, states = jax.jit(lambda: jax.lax.scan(step, (x0, ctrl.init_carry(x0, seed=0)),
                                             jnp.arange(T)))()
    return rms(states, circle_refs(T))


def ilqr12_staged():
    """cli.py fly --controller ilqr12: the RK4 iLQR engine (N=15, 3
    iterations) per tick; the state after each step against the reference
    at its tick (chip_smoke.py ``RigidFamily.ilqr12_staged``)."""
    ctrl = ILQRRigidBodyMPC(integrator="rk4")

    def step(c, i):
        st, mc = c
        pos_ref, _, yaw_ref = circle(i.astype(jnp.float32) * DT)
        u, _, mc = ctrl.solve(mc, st, pos_ref, yaw_ref)
        st = rigid_body_rk4_step(st, u, X500_PARAMS, DT)
        return (st, mc), st

    x0 = x_start()
    _, states = jax.jit(lambda: jax.lax.scan(step, (x0, ctrl.init_carry(x0)),
                                             jnp.arange(ILQR_STAGED_T)))()
    return rms(states, circle_refs(ILQR_STAGED_T))


def ilqr12_k2():
    """cli.py fly --controller ilqr12 --fast: the policy tier, K=2, the RK4
    engine at 1 iteration; the pre-step state against the reference."""
    ctrl = ILQRRigidBodyMPC(iterations=1, integrator="rk4")
    outs = jax.jit(lambda x: ilqr_multitick_rollout(
        ctrl, lambda ticks: jax.vmap(lambda t: circle(t)[0])(ticks.astype(jnp.float32) * DT),
        lambda x_, u: rigid_body_rk4_step(x_, u, X500_PARAMS, DT), x, ILQR_K2_T,
        ticks_per_dispatch=2))(x_start())
    return rms(outs["state"], circle_refs(ILQR_K2_T))


def jax_mppi_draws(ctrl):
    """The JAX controller's exploration draws, tick by tick: the carry key
    split once per tick, standard normals from the subkey."""
    cfg = ctrl.config

    def step(key, _):
        key, sub = jax.random.split(key)
        return key, jax.random.normal(sub, (cfg.num_samples, cfg.horizon, 4), jnp.float32)

    return jax.lax.scan(step, jax.random.PRNGKey(0), None, length=T)[1]


def port_mppi12_cpu():
    """The port's staged MPPI flight on the CPU with the JAX draws."""
    import numpy as np
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control import MPPIController as TMPPI
    from unmanned_aerial_vehicles_tpu_torch.models import X500_PARAMS as TX500
    from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import rigid_body_rk4_step_fast
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference as t_circle

    draws = np.asarray(jax_mppi_draws(MPPIController()))
    ctrl = TMPPI(device="cpu")
    pos, _, yaw = t_circle(torch.arange(T, dtype=torch.float32) * DT, amplitude=2.0, height=3.0)
    x = torch.zeros(12)
    x[2] = 3.0
    carry, states = ctrl.init_carry(x, seed=0), []
    for i in range(T):
        u, _, carry = ctrl.solve(carry, x, pos[i], yaw[i], eps=torch.from_numpy(draws[i]))
        x = rigid_body_rk4_step_fast(x, u, TX500, DT)
        states.append(x)
    return rms(jnp.asarray(torch.stack(states).numpy()), jnp.asarray(pos.numpy()))


def fig8(t):
    from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference

    pos, yaw = ramped_figure8_reference(t, 6.0, 0.02)
    return pos + jnp.asarray([0.0, 0.0, 3.0], pos.dtype), yaw


def fig8_rms(outs):
    return float(jnp.sqrt(jnp.mean(jnp.sum((outs["state"][:, 0:3] - outs["pos_ref"]) ** 2, -1))))


def fig8_tightening():
    """``chip_smoke.py``'s tightening flights (a) and (b), flown by the JAX
    package (its K5 in interpret mode)."""
    import numpy as np

    from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig, fit_residual_gp
    from unmanned_aerial_vehicles_tpu.loop import (
        FlightLoopConfig,
        OnlineFusedGPConfig,
        mpc_flight_rollout,
    )
    from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams

    mpc = LinearMPC(LinearMPCConfig(horizon=20, admm_iterations=10, use_fused_controller=True,
                                    tightening_factor=2.0))
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.normal(size=(800, 10)), jnp.float32)
    Y = jnp.asarray(0.05 * rng.normal(size=(800, 6)), jnp.float32)
    post = fit_residual_gp(X, Y, ResidualGPConfig())
    frozen = jax.jit(lambda p: mpc_flight_rollout(
        mpc, fig8, 400, gp_posterior=p, gp_gain=ResidualGPConfig().residual_gain,
        cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=8)))(post)
    online = jax.jit(lambda: mpc_flight_rollout(
        mpc, fig8, 1000, body=RigidBodyParams(wind=(1.5, 0.8, 0.0)),
        cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=8, fallback_error_m=1.5),
        preview=True, gp_gain=1.0,
        online_gp=OnlineFusedGPConfig(gp=ResidualGPConfig(max_data_points=256, residual_gain=1.0),
                                      refit_every=250)))()
    return fig8_rms(frozen), fig8_rms(online), int(online["gp_count"][-1])


def tune_circle(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=6.0, height=3.0)
    return pos, yaw


def tuners():
    """``chip_smoke.py``'s three tuners, flown by the JAX package."""
    import numpy as np

    from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPCConfig
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig, fit_residual_gp
    from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig, mpc_flight_rollout
    from unmanned_aerial_vehicles_tpu.models import PID_CAMPAIGN_RATE_LOOP
    from unmanned_aerial_vehicles_tpu.tuning import (
        TuneConfig,
        mpc_weights_theta,
        tune_cascade_gains,
        tune_mpc_weights,
    )
    from unmanned_aerial_vehicles_tpu.tuning.autotune import _TracedWeightMPC, _tracking_loss

    record = lambda r: dict(initial=float(r.initial_loss),
                            trace=[float(v) for v in np.asarray(r.losses)],
                            final=float(r.final_loss))
    out = {"cascade_pid": record(tune_cascade_gains(
        tune_circle, 1500, tune_cfg=TuneConfig(iterations=3, learning_rate=0.06, settle_steps=250),
        rate_loop=PID_CAMPAIGN_RATE_LOOP,
        loop_cfg=FlightLoopConfig(use_pallas_plant=True, fused_tick_ad=True)))}
    mpc_cfg = TuneConfig(iterations=2, learning_rate=0.08, settle_steps=50)
    out["mpc_fused"] = record(tune_mpc_weights(
        tune_circle, 200, base_config=LinearMPCConfig(horizon=20, admm_iterations=10),
        tune_cfg=mpc_cfg, loop_cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=20))[0])
    out["mpc_staged_k2"] = record(tune_mpc_weights(
        tune_circle, 200, base_config=LinearMPCConfig(), tune_cfg=mpc_cfg,
        loop_cfg=FlightLoopConfig(use_pallas_plant=True, fused_tick_ad=True))[0])

    rng = np.random.default_rng(0)
    post = fit_residual_gp(jnp.asarray(rng.normal(size=(800, 10)), jnp.float32),
                           jnp.asarray(0.05 * rng.normal(size=(800, 6)), jnp.float32),
                           ResidualGPConfig())
    base = LinearMPCConfig(horizon=20, admm_iterations=10, use_fused_controller=True,
                           tightening_factor=2.0)

    def loss(theta):
        outs = mpc_flight_rollout(_TracedWeightMPC(theta, base), fig8, 16, gp_posterior=post,
                                  gp_gain=0.1, cfg=FlightLoopConfig(
                                      use_fused_tick=True, ticks_per_dispatch=8,
                                      fused_tick_ad=True))
        return _tracking_loss(outs, 0, 1e-3)

    _, grads = jax.jit(jax.value_and_grad(loss))(mpc_weights_theta(base))
    leaves = [np.asarray(g) for g in grads.values()]
    out["tightened_gradient_finite_share"] = float(
        sum(np.isfinite(g).sum() for g in leaves) / sum(g.size for g in leaves))
    return out


CAMPAIGN_S = 132.0     # tools/run_campaign.py's --duration


def campaign_rows(duration: float) -> dict:
    """The deterministic rows of ``tools/run_campaign.py`` at ``duration``,
    flown as the JAX tool flies them (its staged defaults, the 6 m figure-8
    and circle at 3 m): rms_pos, max_pos and, where the row has it,
    rms_pos_tail, and the online rows' sample counts."""
    import numpy as np

    from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
    from unmanned_aerial_vehicles_tpu.loop import (
        FlightLoopConfig,
        OnlineGPMPCConfig,
        mpc_flight_rollout,
        online_gp_mpc_rollout,
        pid_flight_rollout,
    )
    from unmanned_aerial_vehicles_tpu.models import PID_CAMPAIGN_RATE_LOOP
    from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams

    cfg = FlightLoopConfig()
    T = int(duration / cfg.control_dt)
    mpc = LinearMPC(LinearMPCConfig())

    def fig8_6m(t):
        from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference

        pos, yaw = ramped_figure8_reference(t, amplitude=6.0)
        return pos + jnp.asarray([0.0, 0.0, cfg.takeoff_height], pos.dtype), yaw

    def circle_6m(t):
        pos, _, yaw = ramped_circle_reference(t, amplitude=6.0, height=cfg.takeoff_height)
        return pos, yaw

    def row(outs, tail=True, **extra):
        e = np.linalg.norm(np.asarray(outs["pos_ref"]) - np.asarray(outs["state"])[:, 0:3], axis=1)
        out = {"rms_pos": float(np.sqrt((e**2).mean())), "max_pos": float(e.max())}
        if tail:
            out["rms_pos_tail"] = float(np.sqrt((e[len(e) // 2:] ** 2).mean()))
        return out | extra

    def online(body, gain):
        ocfg = OnlineGPMPCConfig(gp=ResidualGPConfig(max_data_points=400, residual_gain=gain),
                                 gp_refit_every=250, preview=True)
        outs, ds, _ = jax.jit(lambda: online_gp_mpc_rollout(mpc, fig8_6m, T, cfg=ocfg,
                                                            body=body))()
        return outs, int(ds.count)

    plain = lambda body: jax.jit(lambda: mpc_flight_rollout(mpc, fig8_6m, T, body=body, cfg=cfg,
                                                            preview=True))()
    perturbed = RigidBodyParams(mass=0.55, k_drag_linear=0.375, wind=(1.0, 0.5, 0.0))
    windy = RigidBodyParams(wind=(1.5, 0.8, 0.0))
    out = {
        "mpc_flight_figure8": row(jax.jit(lambda: mpc_flight_rollout(mpc, fig8_6m, T,
                                                                     cfg=cfg))(), tail=False),
        "pid_flight_circle": row(jax.jit(lambda: pid_flight_rollout(
            circle_6m, T, cfg=cfg, rate_loop=PID_CAMPAIGN_RATE_LOOP))(), tail=False),
        "mpc_preview_nowind_figure8": row(plain(RigidBodyParams())),
        "mpc_preview_windy_figure8": row(plain(windy)),
        "mpc_perturbed_figure8": row(plain(perturbed)),
    }
    for name, body, gain in (("gpmpc_online_perturbed_figure8", perturbed, 1.0),
                             ("gpmpc_online_windy_figure8", windy, 1.0),
                             ("online_preview_figure8", RigidBodyParams(), 0.1)):
        outs, count = online(body, gain)
        out[name] = row(outs, tail=name != "online_preview_figure8", gp_samples_collected=count)
    return out


def main() -> int:
    if "--campaign" in sys.argv[1:]:
        rest = sys.argv[sys.argv.index("--campaign") + 1:]
        duration = float(rest[0]) if rest else CAMPAIGN_S
        print(json.dumps({"duration_s": duration, "rows": campaign_rows(duration)}))
        return 0
    if "--tuners" in sys.argv[1:]:
        print(json.dumps({"tuners": tuners()}))
        return 0
    if "--ilqr" in sys.argv[1:]:
        print(json.dumps({"ilqr12_staged": ilqr12_staged(), "ilqr12_k2": ilqr12_k2()}))
        return 0
    ltv_rms, clearance = ltv12_obstacle()
    tight_rms, online09_rms, online09_count = fig8_tightening()
    out = {
        "direct_rate12_fused": multitick(DirectRateMPC(), direct_rate_multitick_fused, dt=DT),
        "mpc12_fused": multitick(RigidBodyMPC(), rigid_multitick_fused, dt=DT),
        "mpc12_multitick": mpc12_multitick(),
        "ltv12_obstacle": ltv_rms,
        "mppi12": mppi12(),
        "mppi12_port_cpu": port_mppi12_cpu(),
        "ilqr12_staged": ilqr12_staged(),
        "ilqr12_k2": ilqr12_k2(),
        "ltv12_min_clearance_m": clearance,
        "fig8_tightened_frozen_400": tight_rms,
        "fig8_online09_1000": online09_rms,
        "fig8_online09_gp_count_1000": online09_count,
        "tuners": tuners(),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
