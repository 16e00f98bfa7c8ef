"""Command-line entry points (port of ``unmanned_aerial_vehicles_tpu/cli.py``).

The same ten sub-commands, flags, choices and defaults as the JAX package's
command line, each a thin dispatch onto the port's own functions:

    python -m unmanned_aerial_vehicles_tpu_torch train-gp --data 'gp_datasets/*.csv'
    python -m unmanned_aerial_vehicles_tpu_torch evaluate-gp --model gp.npz --data f.csv
    python -m unmanned_aerial_vehicles_tpu_torch fly --controller gp-mpc --duration 60
    python -m unmanned_aerial_vehicles_tpu_torch compare
    python -m unmanned_aerial_vehicles_tpu_torch sweep --flights 64

The staged paths fly the JAX command line's configurations with the two
switches that route them through the hand-written kernels turned on
(``KERNEL_LOOP``, ``KERNEL_MPC``): the plant substeps through the plant
kernels and each staged linear-MPC solve through the fused controller
kernel (one block of flights a tick for the Monte Carlo population). The
kernels compute the same math as the plain path (``chip_smoke.py`` holds
each within its tolerance); on the CPU their plain versions run.

Every command takes ``--device``: without it the command runs on ``cuda``
(the hand-written kernels) and raises ``RuntimeError`` when no GPU is
present; ``--device cpu`` runs the kernels' plain PyTorch versions.
Random draws come from a ``torch.Generator`` seeded with ``--seed``.

Two flags that the JAX command line accepts and then ignores are rejected
here: ``fly --controller ltv12 --gust`` (the multi-rate LTV tier flies a
steady wind only) and ``fly --controller direct-rate12 --push`` without
``--noisy`` (the force acts only in the noisy flight). Plots, animations
and ``.pkl`` models import matplotlib and scikit-learn's pickles only in
the branches that use them.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time


# the kernel routes of the staged paths (see the module docstring)
KERNEL_LOOP = dict(use_pallas_plant=True)
KERNEL_MPC = dict(use_fused_controller=True)


def _gp_dtype(dev):
    """The offline GP's working precision: float32 on the card (the Gram
    kernel's), float64 on the CPU (the JAX package's under x64)."""
    import torch

    return torch.float32 if dev.type == "cuda" else torch.float64


def _metrics_json(m: dict) -> str:
    return json.dumps({k: round(float(v), 4) for k, v in m.items()}, indent=2)


def _tail_mean(d):
    """The mean of the second half of an estimate's rows, as numpy."""
    return d[len(d) // 2:].mean(dim=0).cpu().numpy()


def _cmd_train_gp(args) -> int:
    import torch

    from .gp import log_marginal_likelihood, optimize_hyperparameters
    from .gp.residual_gp import ResidualGPConfig, default_params
    from .io import load_gp_datasets, save_gp_checkpoint
    from .gp.exact_gp import fit_gp

    dev = args.device
    paths = sorted(glob.glob(args.data))
    if not paths:
        print(f"no CSV files match {args.data!r}", file=sys.stderr)
        return 1
    max_samples = None if args.all_samples else args.max_samples
    X, Y = load_gp_datasets(paths, max_samples=max_samples)
    print(f"loaded {X.shape[0]} samples from {len(paths)} files")

    cfg = ResidualGPConfig()
    dtype = _gp_dtype(dev)

    if args.all_samples:
        # full-corpus fit, rows sharded over the mesh (a world of one
        # without a process group): every Gram block through the Gram
        # kernel, a preconditioned CG in place of the Cholesky factor
        from .parallel import (
            fit_residual_gp_sharded,
            make_mesh,
            optimize_hyperparameters_sharded,
            predict_mean_sharded,
        )

        mesh = make_mesh(device=dev)
        params = default_params(cfg, device=dev)
        if args.optimize:
            # full-corpus LML ascent: stochastic-trace gradients through the
            # sharded CG (no Cholesky or log-determinant anywhere)
            t0 = time.time()
            params = optimize_hyperparameters_sharded(
                params, X, Y, mesh=mesh, config=cfg, steps=args.opt_steps,
                num_probes=16, cg_iterations=args.cg_iterations,
                generator=torch.Generator(dev).manual_seed(0), dtype=dtype,
            )
            print(
                f"hyperparameters optimised on the full corpus in "
                f"{time.time()-t0:.1f}s: ls={float(params.length_scale):.4f} "
                f"sf2={float(params.signal_variance):.4f} "
                f"sn2={float(params.noise_variance):.4f}"
            )
        t0 = time.time()
        post_s = fit_residual_gp_sharded(
            X, Y, mesh=mesh, config=cfg, params=params,
            cg_iterations=args.cg_iterations, dtype=dtype,
        )
        mean = predict_mean_sharded(post_s, X[:4], mesh=mesh)
        print(
            f"sharded fit: n={X.shape[0]} over {mesh.world_size} device(s) "
            f"in {time.time()-t0:.1f}s, CG residual "
            f"{float(post_s.cg_residual):.2e}, smoke predict "
            f"{['%.4f' % v for v in mean[0][:3].tolist()]}"
        )
        save_gp_checkpoint(args.output, post_s.to_gp_posterior(mesh), X, Y,
                           jitter=cfg.alpha)
        print(f"saved checkpoint to {args.output}")
        return 0
    Xt = torch.as_tensor(X, dtype=dtype, device=dev)
    Yt = torch.as_tensor(Y, dtype=dtype, device=dev)
    params = default_params(cfg, device=dev)
    if args.optimize:
        # no learning_rate, as the JAX command line passes none
        t0 = time.time()
        params, nll = optimize_hyperparameters(
            params, Xt, Yt, jitter=cfg.alpha, normalize_y=True, steps=args.opt_steps
        )
        print(f"hyperparameters optimised in {time.time()-t0:.1f}s, nll={float(nll):.2f}")
    post = fit_gp(params, Xt, Yt, jitter=cfg.alpha, normalize_y=True)
    lml = log_marginal_likelihood(params, Xt, Yt, jitter=cfg.alpha, normalize_y=True)
    print(f"fitted GP: n={X.shape[0]}, log marginal likelihood={float(lml):.2f}")

    out = args.output
    save_gp_checkpoint(out, post, X, Y, jitter=cfg.alpha)
    # the 'latest' symlink of the reference's offline trainer
    latest = os.path.join(os.path.dirname(out) or ".", "gp_model_latest.npz")
    try:
        if os.path.islink(latest) or os.path.exists(latest):
            os.remove(latest)
        os.symlink(os.path.basename(out), latest)
    except OSError:
        pass
    print(f"saved checkpoint to {out} (+ gp_model_latest.npz symlink)")
    return 0


def _cmd_evaluate_gp(args) -> int:
    import numpy as np
    import torch

    from .gp import evaluate_gp, predict, predict_mean
    from .io import load_gp_checkpoint, load_gp_dataset

    dev = args.device
    if args.model.endswith(".pkl"):
        from .io import load_reference_gp

        kind, loaded, _ = load_reference_gp(args.model, device=dev)
        if kind != "single":
            print("evaluate-gp needs a single-GP model", file=sys.stderr)
            return 1
        post = loaded
    else:
        post, _, _, _, _ = load_gp_checkpoint(args.model, device=dev)
    X, Y = load_gp_dataset(args.data, residual_norm_limit=np.inf)
    prefix = args.output or os.path.splitext(args.data)[0]
    as_input = lambda x: torch.as_tensor(np.asarray(x), dtype=post.X_train.dtype, device=dev)
    results = evaluate_gp(
        lambda x: predict_mean(post, as_input(x)).cpu().numpy(), X, Y,
        save_prefix=prefix,
    )
    print(json.dumps({k: results[k] for k in ("global", "acc_only", "fractions")}, indent=2))
    print(f"per-component metrics written to {prefix}_metrics.csv")

    if args.full_analysis:
        # physical test regimes, uncertainty analysis and the three figures
        from .gp.analysis import run_complete_gp_analysis

        def predict_fn(pts):
            m, v = predict(post, as_input(pts))
            return m.cpu().numpy(), v.cpu().numpy()

        report = run_complete_gp_analysis(predict_fn, prefix)
        print(json.dumps(
            {k: report[k] for k in ("n_test_points", "uncertainty_stats")},
            indent=2,
        ))
        print(f"analysis figures written to {prefix}_distributions.png, "
              f"{prefix}_uncertainty.png, {prefix}_correlations.png")
    return 0


def _fly_guards(args) -> int:
    """The flag combinations ``fly`` refuses (exit code 1), before any
    flight: the JAX command line's guards, then the two flags it ignores."""
    if args.noisy and args.controller == "pid":
        print("--noisy supports mpc/gp-mpc (PX4-surrogate EKF), the "
              "12-state family (rigid-body / rate-lag EKF) and ltv12 "
              "(multi-rate: 100 Hz EKF under the 10 Hz solve)",
              file=sys.stderr)
        return 1
    if args.wind is not None and not (
        args.controller in ("mpc", "gp-mpc")
        or (args.controller == "ltv12" and args.noisy)
    ):
        print("--wind (steady world-frame wind on the true plant) is "
              "wired for the mpc/gp-mpc family and ltv12 --noisy",
              file=sys.stderr)
        return 1
    if args.disturbance_observer:
        if not args.noisy or args.controller not in (
            "mpc", "gp-mpc", "direct-rate12", "ltv12"
        ):
            print("--disturbance-observer is the augmented-EKF wind/"
                  "mismatch observer: requires --noisy and --controller "
                  "mpc/gp-mpc (6-state family), direct-rate12 or ltv12 "
                  "(the 12-state residual-channel engines) "
                  "(estimation.disturbance)", file=sys.stderr)
            return 1
        if args.fast and args.controller not in ("mpc", "gp-mpc"):
            print("--disturbance-observer --fast is wired for the 6-state "
                  "family (mpc/gp-mpc: the augmented filter runs inside "
                  "the fused multi-tick kernel); the 12-state engines run "
                  "it staged — drop --fast", file=sys.stderr)
            return 1
    if args.push is not None and args.controller != "direct-rate12":
        print("--push (a constant unmodelled acceleration on the TRUE "
              "plant) is the direct-rate12 scenario knob; the 6-state "
              "family uses --wind", file=sys.stderr)
        return 1
    if args.push is not None and not args.noisy:
        print("--push acts on the TRUE plant of the noisy flight only: "
              "it requires --noisy (with --controller direct-rate12)",
              file=sys.stderr)
        return 1
    if args.push_step is not None and (
        args.push is None or not args.noisy
        or args.controller != "direct-rate12"
    ):
        print("--push-step T AX AY AZ (the unmodelled force steps at t=T "
              "on the TRUE plant — the torque family's --gust) requires "
              "--push (the pre-step force), --noisy and "
              "--controller direct-rate12", file=sys.stderr)
        return 1
    if args.gust is not None:
        if args.wind is None or not args.noisy:
            print("--gust T WX WY WZ (a wind step-change at t=T on the "
                  "TRUE plant) requires --wind (the pre-gust wind) and "
                  "--noisy; with --fast the multi-tick kernel reads a "
                  "per-tick plant-row operand (6-state family)",
                  file=sys.stderr)
            return 1
        if args.controller == "ltv12":
            print("--gust needs a time-varying wind, which the ltv12 "
                  "multi-rate tier does not take (noisy_ltv_rollout flies "
                  "the steady --wind only): fly --controller mpc/gp-mpc "
                  "for a gust, or drop --gust", file=sys.stderr)
            return 1
    if args.obstacle and args.controller != "ltv12":
        print("--obstacle is the LTV engine's constraint class: use "
              "--controller ltv12 (mpc_controller.py:223-316)",
              file=sys.stderr)
        return 1
    return 0


def _fly_ltv12(args, ref, cfg, dev) -> int:
    """The cvxpy-LTV-equivalent tracking MPC at its own 10 Hz cadence on
    the GZ quadrotor, with optional spherical obstacles. ``--fast`` flies
    the K=2 multi-tick tier, ``--noisy`` the 100 Hz filter under the 10 Hz
    solve."""
    import torch

    from .control import LTVTrackingMPC
    from .loop.rigid_loop import (
        make_attitude_recovery_fallback,
        sqp_multitick_rollout,
    )
    from .metrics import tracking_metrics
    from .models import GZ_QUADROTOR_PARAMS
    from .ops.rigid_plant_pallas import (
        rigid_body_rk4_step_fast,
        rigid_body_rollout_fused,
    )

    f32 = dict(dtype=torch.float32, device=dev)
    LDT = 0.1
    obstacles = None
    n_obs = 0
    if args.obstacle:
        try:
            rows = [tuple(float(v) for v in s.split(",")) for s in args.obstacle]
        except ValueError:
            print("--obstacle expects X,Y,Z,R (numbers)", file=sys.stderr)
            return 1
        if any(len(r) != 4 for r in rows):
            print("--obstacle expects exactly 4 values: X,Y,Z,R",
                  file=sys.stderr)
            return 1
        obstacles = torch.tensor(rows, **f32)
        n_obs = len(rows)
    mpc_ltv = LTVTrackingMPC(num_obstacles=n_obs, obstacle_margin=0.2, device=dev)
    N_ltv = mpc_ltv.mpc.config.horizon
    mg_gz = GZ_QUADROTOR_PARAMS.mass * GZ_QUADROTOR_PARAMS.gravity
    K_ltv = 2
    steps10 = max(K_ltv, int(args.duration / LDT)
                  - int(args.duration / LDT) % K_ltv)

    def ref12_at(ts):
        pos, _ = ref(ts)
        return torch.cat([pos.to(torch.float32),
                          torch.zeros(*ts.shape, 9, **f32)], dim=-1)

    def plant_ltv(x, u):
        return rigid_body_rk4_step_fast(x, u, GZ_QUADROTOR_PARAMS, LDT, substeps=2)

    x0_ltv = ref12_at(torch.zeros(1, **f32))[0]
    if args.noisy:
        # multi-rate estimation tier: plant and rigid-body EKF at 100 Hz,
        # the LTV solve every 10th plant tick flying the estimate
        if args.fast:
            print("--noisy flies per-tick (the EKF must see every "
                  "measurement); drop --fast", file=sys.stderr)
            return 1
        from .estimation import EKFConfig
        from .estimation.noisy_loop import noisy_ltv_rollout

        def window_at(i):
            ts = (i + torch.arange(N_ltv + 1, device=dev)).to(torch.float32) * LDT
            return ref12_at(ts)

        ltv_body = GZ_QUADROTOR_PARAMS
        if args.wind is not None:
            ltv_body = dataclasses.replace(ltv_body, wind=tuple(args.wind))
        outs_ltv = noisy_ltv_rollout(
            mpc_ltv, window_at, steps10, torch.Generator(dev).manual_seed(args.seed),
            ekf_cfg=EKFConfig(), body=ltv_body,
            obstacles=obstacles,
            disturbance_observer=(
                True if args.disturbance_observer else None
            ),
            device=dev,
        )
        est_rms = torch.sqrt(torch.mean(torch.sum(
            (outs_ltv["state_est"][:, 0:3] - outs_ltv["state"][:, 0:3]) ** 2, -1)))
        print(f"# noisy tier: ltv12, 100 Hz EKF under the 10 Hz "
              f"solve; estimate RMS vs truth {float(est_rms):.4f} m")
        if args.disturbance_observer:
            d_tail = _tail_mean(outs_ltv["disturbance_est"])
            print(f"# disturbance observer (ltv12, 100 Hz fuse / "
                  f"10 Hz feedforward): mean estimated accel "
                  f"disturbance (tail) = [{d_tail[0]:+.3f} "
                  f"{d_tail[1]:+.3f} {d_tail[2]:+.3f}] m/s^2")
    elif args.fast:
        def reference_fn(ticks):
            ts = (ticks[:, None] + 1
                  + torch.arange(N_ltv, device=dev)[None, :]).to(torch.float32) * LDT
            return ref12_at(ts)

        def plan_roll_fn(x_fin, U_fin, residuals):
            return rigid_body_rollout_fused(x_fin, U_fin, GZ_QUADROTOR_PARAMS, LDT)

        outs_ltv = sqp_multitick_rollout(
            mpc_ltv.mpc, mpc_ltv.cost, reference_fn, plant_ltv, x0_ltv,
            steps10, ticks_per_dispatch=K_ltv, admm_iterations=100,
            u_init=mpc_ltv.u_hover, obstacles=obstacles,
            plan_roll_fn=plan_roll_fn,
            fallback_fn=make_attitude_recovery_fallback(GZ_QUADROTOR_PARAMS),
        )
        print(f"# multitick tier: ltv12, {K_ltv} ticks/dispatch, "
              f"{steps10} steps, {n_obs} obstacle(s)")
    else:
        st, mc = x0_ltv, mpc_ltv.init_carry(x0_ltv)
        states, controls = [], []
        for i in range(steps10):
            ts = (i + torch.arange(N_ltv + 1, device=dev)).to(torch.float32) * LDT
            u, _, mc = mpc_ltv.solve(mc, st, ref12_at(ts), obstacles=obstacles)
            states.append(st)
            controls.append(u)
            st = plant_ltv(st, u)
        outs_ltv = {"state": torch.stack(states), "u": torch.stack(controls)}
    ts10 = torch.arange(steps10, **f32) * LDT
    outs = {
        "state": outs_ltv["state"],
        "pos_ref": ref12_at(ts10)[:, 0:3],
        "thrust": outs_ltv["u"][:, 0] / (2.0 * mg_gz),
    }
    m = tracking_metrics(outs["pos_ref"], outs["state"][:, 0:3],
                         thrust_normalized=outs["thrust"])
    if obstacles is not None:
        d = outs["state"][:, None, 0:3] - obstacles[None, :, 0:3]
        clear = torch.min(torch.sqrt(torch.sum(d**2, -1)) - obstacles[None, :, 3])
        m["min_obstacle_clearance"] = float(clear)
    print(_metrics_json(m))
    if args.save_log:
        from .io import save_flight_log

        save_flight_log(args.save_log, outs, control_dt=LDT)
        print(f"flight log written to {args.save_log}")
    return 0


def _fly_rigid(args, ref, cfg, num_steps, dev) -> int:
    """The 12-state controllers flying the z-up rigid-body plant: mpc12
    (SQP + ADMM), direct-rate12 (the body-rate-input engine), ilqr12 (the
    Riccati-based iLQR engine) and mppi12 (512 sampled rollouts a tick).
    ``--fast`` flies mpc12 and direct-rate12 on the multi-tick tiers
    (relinearised per dispatch; direct-rate12 whole ticks in one kernel)
    and ilqr12 on the K=2 policy-reuse tier; ``--noisy`` flies the
    estimate of the rigid-body (direct-rate12: rate-lag) EKF."""
    import torch

    from .control import ILQRRigidBodyMPC, RigidBodyMPC
    from .metrics import tracking_metrics
    from .models import X500_PARAMS
    from .ops.rigid_plant_pallas import rigid_body_rk4_step_fast

    f32 = dict(dtype=torch.float32, device=dev)
    mg = X500_PARAMS.mass * X500_PARAMS.gravity
    if args.controller == "ilqr12":
        # integrator="rk4": the engine's internal model is the plant step,
        # its rollouts through the rigid plant kernel
        mpc12 = ILQRRigidBodyMPC(integrator="rk4", device=dev)
        thrust_of_u = lambda u: u[..., 0] / mg
    elif args.controller == "mppi12":
        from .control import MPPIController

        if args.fast:
            print("mppi12 has no multitick tier (every tick re-samples "
                  "512 rollouts); drop --fast", file=sys.stderr)
            return 1
        mpc12 = MPPIController(device=dev)
        thrust_of_u = lambda u: u[..., 0] / mg
    elif args.controller == "direct-rate12":
        from .control import DirectRateMPC
        from .control.mpc_rigid import direct_rate_step

        mpc12 = DirectRateMPC(device=dev)
        thrust_of_u = lambda u: u[..., 3]  # normalized thrust channel
    else:
        mpc12 = RigidBodyMPC(device=dev)
        thrust_of_u = lambda u: u[..., 0] / mg

    x0 = torch.zeros(12, **f32)
    x0[2] = cfg.takeoff_height
    zero12 = torch.zeros(12, **f32)
    if args.noisy:
        # sensors -> rigid-body EKF -> controller (flying the estimate) ->
        # true plant; per tick only, as the EKF must see every measurement
        if args.fast:
            print("--noisy flies per-tick (the EKF must see every "
                  "measurement); drop --fast", file=sys.stderr)
            return 1
        from .estimation import EKFConfig
        from .estimation.noisy_loop import noisy_rigid_mpc_rollout

        noisy_kw = {}
        if args.controller == "direct-rate12":
            # the direct-rate engine's true plant is its rate-lag model,
            # and its solve has no yaw channel
            from .control.mpc_rigid import direct_rate_step

            # --push: a constant unmodelled acceleration on the TRUE plant;
            # the EKF's process model stays nominal
            push_row = torch.zeros(12, **f32)
            if args.push is not None:
                push_row[3:6] = torch.tensor(args.push, **f32)
            noisy_kw = dict(
                process_step_fn=lambda x, u: direct_rate_step(
                    x, u, zero12, dt=float(cfg.control_dt)),
                yaw_channel=False,
            )
            if args.push_step is not None:
                # --push-step: the unmodelled force steps at t=T on the TRUE
                # plant; only the observer adapts
                t_p = float(args.push_step[0])
                post_row = torch.zeros(12, **f32)
                post_row[3:6] = torch.tensor(args.push_step[1:], **f32)
                noisy_kw["plant_step_tfn"] = (
                    lambda x, u, t: direct_rate_step(
                        x, u,
                        torch.where(torch.as_tensor(t, device=dev) < t_p, push_row, post_row),
                        dt=float(cfg.control_dt),
                    )
                )
            else:
                noisy_kw["plant_step_fn"] = (
                    lambda x, u: direct_rate_step(
                        x, u, push_row, dt=float(cfg.control_dt))
                )
            if args.disturbance_observer:
                noisy_kw["disturbance_observer"] = True
        outs12 = noisy_rigid_mpc_rollout(
            mpc12, ref, num_steps, torch.Generator(dev).manual_seed(args.seed),
            ekf_cfg=EKFConfig(), body=X500_PARAMS,
            dt=float(cfg.control_dt),
            takeoff_height=float(cfg.takeoff_height),
            device=dev,
            **noisy_kw,
        )
        if args.controller == "direct-rate12" and args.disturbance_observer:
            d_tail = _tail_mean(outs12["disturbance_est"])
            print(f"# disturbance observer (direct-rate12): mean "
                  f"estimated accel disturbance (tail) = "
                  f"[{d_tail[0]:+.3f} {d_tail[1]:+.3f} "
                  f"{d_tail[2]:+.3f}] m/s^2")
        outs = {
            "state": outs12["state"],
            "pos_ref": outs12["pos_ref"],
            "thrust": thrust_of_u(outs12["u"]),
        }
        est_rms = torch.sqrt(torch.mean(torch.sum(
            (outs12["state_est"][:, 0:3] - outs12["state"][:, 0:3]) ** 2, -1)))
        model = ("rate-lag" if args.controller == "direct-rate12"
                 else "rigid-body")
        print(f"# noisy tier: {args.controller} on {model} EKF "
              f"estimate; estimate RMS vs truth "
              f"{float(est_rms):.4f} m")
    elif args.fast:
        from .loop.rigid_loop import (
            ilqr_multitick_rollout,
            sqp_multitick_rollout,
        )

        K = 8 if args.controller != "ilqr12" else 2
        steps = max(K, num_steps - num_steps % K)
        tier = "multitick"

        def pos_at(ts):
            pos, _ = ref(ts)
            return pos.to(torch.float32)

        if args.controller == "ilqr12":
            plant = lambda x, u: rigid_body_rk4_step_fast(
                x, u, X500_PARAMS, cfg.control_dt)

            def position_ref_fn(ticks):
                return pos_at(ticks.to(torch.float32) * cfg.control_dt)

            # with the dispatch-carried warm start the closed-loop RMS does
            # not depend on the iterations: one a dispatch
            mpc12 = ILQRRigidBodyMPC(iterations=1, integrator="rk4", device=dev)
            outs12 = ilqr_multitick_rollout(
                mpc12, position_ref_fn, plant, x0, steps,
                ticks_per_dispatch=K,
            )
        else:
            N12 = mpc12.mpc.config.horizon

            def reference_fn(ticks):
                pos = pos_at(ticks.to(torch.float32) * cfg.control_dt)
                stage = torch.cat([pos, torch.zeros(pos.shape[0], 9, **f32)], dim=1)
                return stage[:, None, :].repeat(1, N12, 1)

            if args.controller == "direct-rate12":
                # whole ticks in one kernel (shift, condensed ADMM, plant),
                # relinearised per dispatch on the host
                from .loop.rigid_loop import direct_rate_multitick_fused

                outs12 = direct_rate_multitick_fused(
                    mpc12.mpc, mpc12.cost, reference_fn, x0, steps,
                    ticks_per_dispatch=K, admm_iterations=30,
                    u_init=mpc12.u_hover, dt=cfg.control_dt,
                    plan_roll="linear",
                )
                tier = "fused multitick"
            else:
                plant = lambda x, u: rigid_body_rk4_step_fast(
                    x, u, X500_PARAMS, cfg.control_dt)
                outs12 = sqp_multitick_rollout(
                    mpc12.mpc, mpc12.cost, reference_fn, plant, x0, steps,
                    ticks_per_dispatch=K, admm_iterations=30,
                    u_init=mpc12.u_hover, plan_roll="linear",
                )
        ts = torch.arange(steps, **f32) * cfg.control_dt
        outs = {
            "state": outs12["state"],
            "pos_ref": pos_at(ts),
            "thrust": thrust_of_u(outs12["u"]),
        }
        print(f"# {tier} tier: {args.controller}, "
              f"{K} ticks/dispatch, {steps} steps")
    else:
        # one solve a tick; the rigid plant step through the rigid plant
        # kernel (its plain version on the CPU is the model's RK4 step)
        st, mc = x0, mpc12.init_carry(x0)
        ts = torch.arange(num_steps, **f32) * cfg.control_dt
        pos_refs, yaw_refs = ref(ts)
        states, thrusts = [], []
        for i in range(num_steps):
            pos_ref = pos_refs[i].to(torch.float32)
            if args.controller == "direct-rate12":
                # DirectRateMPC has no yaw target channel
                u, _, mc = mpc12.solve(mc, st, pos_ref)
                st = direct_rate_step(st, u, zero12, dt=cfg.control_dt)
            else:
                u, _, mc = mpc12.solve(mc, st, pos_ref, yaw_refs[i].to(torch.float32))
                st = rigid_body_rk4_step_fast(st, u, X500_PARAMS, cfg.control_dt)
            states.append(st)
            thrusts.append(thrust_of_u(u))
        outs = {"state": torch.stack(states), "pos_ref": pos_refs.to(torch.float32),
                "thrust": torch.stack(thrusts)}
    m = tracking_metrics(outs["pos_ref"], outs["state"][:, 0:3],
                         thrust_normalized=outs["thrust"])
    print(_metrics_json(m))
    _save_and_animate(args, outs, cfg)
    return 0


def _save_and_animate(args, outs, cfg) -> None:
    if args.save_log:
        from .io import save_flight_log

        save_flight_log(args.save_log, outs, control_dt=float(cfg.control_dt))
        print(f"flight log written to {args.save_log}")
    if getattr(args, "animate", None):
        from .metrics.animate import animate_flight

        path = animate_flight(outs, args.animate, dt=float(cfg.control_dt),
                              title=args.trajectory)
        print(f"animation written to {path}")


def _fly_linear_gp(args, gp_cfg, dev, fast):
    """The gp-mpc model's residual routes: ``(residual_fn,
    output_correction_fn, gp_posterior, gp_gain)``, or an exit code."""
    import numpy as np
    import torch

    from .gp import build_horizon_residuals
    from .gp.exact_gp import fit_gp

    residual_fn = output_correction_fn = gp_posterior = None
    gp_gain = 0.1
    if args.gp_model:
        # the pretrained-model runtime (the reference's GP_USE_MODEL /
        # GP_MODEL_PATH channel): fly a saved checkpoint instead of
        # refitting from CSVs
        from .io import load_gp_checkpoint

        if not os.path.exists(args.gp_model):
            print(f"GP model not found: {args.gp_model!r}", file=sys.stderr)
            return 1
        if args.gp_model.endswith(".pkl"):
            # the reference's sklearn pickles (single GP or per-dim
            # package) load directly
            from .io import load_reference_gp

            kind, loaded, meta = load_reference_gp(
                args.gp_model, dtype=torch.float32, device=dev
            )
            if kind == "per_dim":
                if fast:
                    print("per-dim pickle models use the staged "
                          "path (six independent kernels); drop "
                          "--fast", file=sys.stderr)
                    return 1
                from .gp.per_dim import build_horizon_residuals_per_dim

                perdim = loaded
                residual_fn = lambda Xg, Ug: build_horizon_residuals_per_dim(
                    perdim, Xg, Ug, dt=gp_cfg.dt,
                    residual_gain=gp_cfg.residual_gain,
                )
                post, X = None, np.zeros((0, 10))
            else:
                post = loaded
                X = post.X_train if post.x_shift is None else post.X_train + post.x_shift
                X = X.cpu().numpy()
                # original targets back out of the stored normalisation
                Ys = (post.y_train_norm * post.y_std + post.y_mean).cpu().numpy()
            # a capacity-capped refit reuses the regressor's own settings
            jitter = meta.get("jitter", gp_cfg.alpha)
            norm_y = meta.get("normalize_y", True)
        else:
            post, X, Ys, jitter, norm_y = load_gp_checkpoint(
                args.gp_model, dtype=torch.float32, device=dev
            )
        if X.shape[0] > gp_cfg.max_data_points:
            # cap to the flight loop's design size, keeping the
            # checkpoint's hyperparameters
            n = gp_cfg.max_data_points
            print(f"checkpoint has {X.shape[0]} rows; refitting the "
                  f"flight posterior on the first {n} "
                  "(checkpoint hyperparameters kept)")
            X = X[:n]
            post = fit_gp(post.params, torch.as_tensor(X, dtype=torch.float32, device=dev),
                          torch.as_tensor(Ys[:n], dtype=torch.float32, device=dev),
                          jitter=jitter, normalize_y=norm_y)
    else:
        fitted = _fit_corpus_gp(args.gp_data, dev)
        if fitted is None:
            print(f"no GP data matches {args.gp_data!r}", file=sys.stderr)
            return 1
        post, gp_cfg, X = fitted
    if post is None:
        # per-dim pickle: residual_fn already bound above
        if args.gp_mode == "output":
            print("--gp-mode output needs a single-GP model "
                  "(per-dim packages drive the dynamics mode)",
                  file=sys.stderr)
            return 1
    elif args.gp_mode == "output":
        # the reference's earlier generation: the GP corrects the solved
        # control after the solve
        from .gp import make_output_correction_fn

        output_correction_fn = make_output_correction_fn(post, n_train=X.shape[0])
    elif fast:
        gp_posterior, gp_gain = post, gp_cfg.residual_gain
    else:
        residual_fn = lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gp_cfg)
    return residual_fn, output_correction_fn, gp_posterior, gp_gain


def _cmd_fly(args) -> int:
    import torch

    from .control.mpc_linear import LinearMPC, LinearMPCConfig
    from .gp.residual_gp import ResidualGPConfig
    from .loop import FlightLoopConfig, mpc_flight_rollout, pid_flight_rollout
    from .metrics import tracking_metrics

    dev = args.device
    cfg = FlightLoopConfig(**KERNEL_LOOP)
    num_steps = int(args.duration / cfg.control_dt)
    ref = _reference_fn(args.trajectory, args.amplitude, cfg.takeoff_height)

    if _fly_guards(args):
        return 1
    body6 = None
    wind_fn6 = None
    if args.wind is not None:
        from .models import RigidBodyParams

        body6 = RigidBodyParams(wind=tuple(args.wind))
        if args.gust is not None:
            t_g = float(args.gust[0])
            w_pre = torch.tensor(args.wind, dtype=torch.float32, device=dev)
            w_post = torch.tensor(args.gust[1:4], dtype=torch.float32, device=dev)
            wind_fn6 = lambda t: torch.where(torch.as_tensor(t) < t_g, w_pre, w_post)
    if args.controller == "pid":
        # campaign-calibrated plant: the PID bags hover at ~0.7 normalized
        # thrust (models.px4_surrogate.PID_CAMPAIGN_RATE_LOOP)
        from .models import PID_CAMPAIGN_RATE_LOOP

        outs = pid_flight_rollout(
            ref, num_steps, cfg=cfg, rate_loop=PID_CAMPAIGN_RATE_LOOP, device=dev
        )
    elif args.controller == "ltv12":
        return _fly_ltv12(args, ref, cfg, dev)
    elif args.controller in ("mpc12", "direct-rate12", "ilqr12", "mppi12"):
        return _fly_rigid(args, ref, cfg, num_steps, dev)
    else:
        if args.fast and args.gp_mode == "output":
            print("--gp-mode output (the post-solve GP generation) is a "
                  "staged-path capability; drop --fast", file=sys.stderr)
            return 1
        if args.fast:
            # latency mode: whole ticks per kernel launch, the GP posterior
            # in the kernel; --noisy runs the EKF in the multi-tick kernel
            # too. "default" loop precision is accepted for the JAX
            # signature: on the card every tier computes in float32.
            cfg = FlightLoopConfig(use_fused_tick=True,
                                   fused_tick_loop_precision="default",
                                   ticks_per_dispatch=8)
            num_steps -= num_steps % 8
            mpc = LinearMPC(LinearMPCConfig(horizon=20, admm_iterations=10,
                                            use_fused_controller=True), device=dev)
        else:
            mpc = LinearMPC(LinearMPCConfig(**KERNEL_MPC), device=dev)
        residual_fn = None
        output_correction_fn = None
        gp_posterior, gp_gain = None, 0.1
        online_gp = None
        if args.online:
            # in-flight learning on the fused multi-tick path: ring-buffer
            # capture every tick and a masked refit every 250 ticks, no
            # pretrained model
            if not (args.fast and args.controller == "gp-mpc"):
                print("--online is the fused in-flight learning mode: use "
                      "--controller gp-mpc --fast (the staged equivalent "
                      "is the 'online' subcommand)", file=sys.stderr)
                return 1
            if args.gp_model or args.gp_mode == "output":
                print("--online learns in flight; drop --gp-model/"
                      "--gp-mode output", file=sys.stderr)
                return 1
            from .loop import OnlineFusedGPConfig

            gcfg = ResidualGPConfig()
            online_gp = OnlineFusedGPConfig(gp=gcfg)
            gp_gain = gcfg.residual_gain
        elif args.controller == "gp-mpc":
            routes = _fly_linear_gp(args, ResidualGPConfig(), dev, args.fast)
            if routes == 1:
                return 1
            residual_fn, output_correction_fn, gp_posterior, gp_gain = routes
        if args.noisy:
            # sensors -> EKF -> controller -> plant; with --fast the fused
            # tick kernel flies the EKF estimate while its plant integrates
            # the truth
            if output_correction_fn is not None:
                print("--noisy supports the in-dynamics GP mode only "
                      "(--gp-mode dynamics)", file=sys.stderr)
                return 1
            from .estimation import EKFConfig, noisy_mpc_flight_rollout

            ekf_cfg = EKFConfig(relinearize_every=args.ekf_relin,
                                cov_precision=args.ekf_cov)
            body_kw = {"body": body6} if body6 is not None else {}
            if wind_fn6 is not None:
                body_kw["wind_fn"] = wind_fn6
            outs = noisy_mpc_flight_rollout(
                mpc, ref, num_steps, torch.Generator(dev).manual_seed(args.seed),
                cfg=cfg, residual_fn=residual_fn, preview=args.preview,
                gp_posterior=gp_posterior, gp_gain=gp_gain,
                ekf_cfg=ekf_cfg, online_gp=online_gp,
                disturbance_observer=(
                    True if args.disturbance_observer else None
                ),
                device=dev,
                **body_kw,
            )
            if args.disturbance_observer:
                d_tail = _tail_mean(outs["disturbance_est"])
                print(f"# disturbance observer: mean estimated accel "
                      f"disturbance (tail) = "
                      f"[{d_tail[0]:+.3f} {d_tail[1]:+.3f} "
                      f"{d_tail[2]:+.3f}] m/s^2")
            if online_gp is not None:
                print(f"# online+noisy: GP trained on EKF estimates "
                      f"(the reference's EKF2-fed capture path); "
                      f"samples {int(outs['gp_count'][-1])}")
        else:
            body_kw = {"body": body6} if body6 is not None else {}
            outs = mpc_flight_rollout(
                mpc, ref, num_steps, cfg=cfg, residual_fn=residual_fn,
                output_correction_fn=output_correction_fn,
                preview=args.preview,
                gp_posterior=gp_posterior, gp_gain=gp_gain,
                online_gp=online_gp, device=dev,
                **body_kw,
            )

    m = tracking_metrics(
        outs["pos_ref"], outs["state"][:, 0:3],
        vel_setpoint=outs["vel_ref"], vel_current=outs["state"][:, 3:6],
        att_setpoint=outs["att_ref"], att_current=outs["state"][:, 6:9],
        thrust_normalized=outs["thrust"],
    )
    print(_metrics_json(m))
    _save_and_animate(args, outs, cfg)
    return 0


def _cmd_mission(args) -> int:
    """Full mission (ground -> arm -> takeoff -> hover -> trajectory)."""
    import numpy as np
    import torch

    from .control.mpc_linear import LinearMPC, LinearMPCConfig
    from .loop import FlightLoopConfig, mission_rollout
    from .trajectories import ramped_figure8_reference

    if args.disturbance_observer and not args.noisy:
        print("--disturbance-observer needs the noisy mission (--noisy): "
              "the observer fuses drawn sensor samples", file=sys.stderr)
        return 1
    dev = args.device
    cfg = FlightLoopConfig(**KERNEL_LOOP)
    mpc = LinearMPC(LinearMPCConfig(**KERNEL_MPC), device=dev)

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=args.amplitude)
        return pos + torch.tensor([0.0, 0.0, cfg.takeoff_height], dtype=pos.dtype,
                                  device=pos.device), yaw

    kw = {}
    if args.noisy:
        # every phase flies the estimate, as the reference node flies
        # PX4-EKF2 output
        kw["generator"] = torch.Generator(dev).manual_seed(args.seed)
        if args.disturbance_observer:
            kw["disturbance_observer"] = True
    if args.wind is not None:
        from .models import RigidBodyParams

        kw["body"] = RigidBodyParams(wind=tuple(args.wind))
    outs = mission_rollout(mpc, ref, duration=args.duration, cfg=cfg, device=dev, **kw)
    host = lambda k: outs[k].detach().cpu().numpy()

    traj = host("in_trajectory").astype(bool)
    state = host("state")
    err = np.linalg.norm(host("target") - state[:, 0:3], axis=1)
    result = {
        "phases_reached": int(host("phase").max()) + 1,
        "takeoff_altitude_m": round(float(state[traj.argmax(), 2]), 3),
        "trajectory_rms_pos_m": round(float(np.sqrt((err[traj] ** 2).mean())), 4),
        "trajectory_max_pos_m": round(float(err[traj].max()), 4),
    }
    if args.noisy:
        est_err = np.linalg.norm(host("state_est")[:, 0:3] - state[:, 0:3], axis=1)
        result["estimate_rms_pos_m"] = round(float(np.sqrt((est_err**2).mean())), 4)
    if args.disturbance_observer:
        result["disturbance_est_tail"] = [
            round(float(v), 3) for v in _tail_mean(outs["disturbance_est"])
        ]
    print(json.dumps(result, indent=2))
    return 0


def _cmd_online(args) -> int:
    """Online-learning flight: collect data and retrain the GP in flight."""
    import numpy as np
    import torch

    from .control.mpc_linear import LinearMPC, LinearMPCConfig
    from .gp.residual_gp import ResidualGPConfig
    from .io import save_gp_checkpoint
    from .loop import FlightLoopConfig, OnlineGPMPCConfig, online_gp_mpc_rollout
    from .trajectories import ramped_figure8_reference

    dev = args.device
    cfg = OnlineGPMPCConfig(
        flight=FlightLoopConfig(**KERNEL_LOOP),
        gp=ResidualGPConfig(max_data_points=args.gp_capacity),
        gp_refit_every=args.refit_every,
        preview=args.preview,
    )
    mpc = LinearMPC(LinearMPCConfig(**KERNEL_MPC), device=dev)
    num_steps = int(args.duration / cfg.flight.control_dt)

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=args.amplitude)
        return pos + torch.tensor([0.0, 0.0, cfg.flight.takeoff_height], dtype=pos.dtype,
                                  device=pos.device), yaw

    outs, dataset, posterior = online_gp_mpc_rollout(mpc, ref, num_steps, cfg=cfg, device=dev)

    err = np.linalg.norm(
        (outs["pos_ref"] - outs["state"][:, 0:3]).detach().cpu().numpy(), axis=1
    )
    result = {
        "gp_samples_collected": int(dataset.count),
        "gp_active_final": bool(outs["gp_active"][-1]),
        "rms_pos_m": round(float(np.sqrt((err**2).mean())), 4),
    }
    if args.save_model:
        n = int(dataset.count)
        save_gp_checkpoint(
            args.save_model, posterior,
            dataset.X[:n].cpu().numpy(), dataset.Y[:n].cpu().numpy(),
            jitter=cfg.gp.alpha,
        )
        result["model_saved"] = args.save_model
    print(json.dumps(result, indent=2))
    return 0


def _cmd_analyze(args) -> int:
    """Post-hoc flight-log analysis (the rosbag-analyzer role)."""
    from .io import analyze_flight_log, load_flight_log

    log = load_flight_log(args.log)
    metrics = analyze_flight_log(log)
    print(json.dumps(metrics, indent=2))
    if args.plot:
        from .metrics.plots import plot_flight_log

        out = args.plot if isinstance(args.plot, str) else args.log + ".png"
        plot_flight_log(log, out, title=os.path.basename(args.log))
        print(f"plot written to {out}")
    if getattr(args, "animate", None):
        from .metrics.animate import animate_flight

        # logs flown at a non-default control_dt carry it as metadata
        dt = float(log.get("meta_control_dt", 0.02))
        path = animate_flight(log, args.animate, dt=dt,
                              title=os.path.basename(args.log))
        print(f"animation written to {path}")
    return 0


def _cmd_compare(args) -> int:
    from .loop import run_full_comparison

    results = run_full_comparison(duration=args.duration, device=args.device)
    print(json.dumps(results, indent=2))
    return 0


def _cmd_sweep(args) -> int:
    import torch

    from .control.mpc_linear import LinearMPC, LinearMPCConfig
    from .loop import FlightLoopConfig, mpc_flight_rollout
    from .parallel import make_mesh, sharded_flight_sweep
    from .trajectories import ramped_figure8_reference

    dev = args.device
    cfg = FlightLoopConfig(**KERNEL_LOOP)
    mpc = LinearMPC(LinearMPCConfig(**KERNEL_MPC), device=dev)

    def ref(t):
        pos, yaw = ramped_figure8_reference(t)
        return pos + torch.tensor([0.0, 0.0, cfg.takeoff_height], dtype=pos.dtype,
                                  device=pos.device), yaw

    num_steps = int(args.duration / cfg.control_dt)

    def one_flight(x0):
        return mpc_flight_rollout(mpc, ref, num_steps, cfg=cfg, initial_state=x0, device=dev)

    B = args.flights
    starts = torch.zeros(B, 12, dtype=torch.float32, device=dev)
    starts[:, 2] = cfg.takeoff_height
    starts[:, 0] = torch.linspace(-1.0, 1.0, B, dtype=torch.float32, device=dev)
    mesh = make_mesh(device=dev)
    result = sharded_flight_sweep(mesh, one_flight, starts)
    print(json.dumps({
        "devices": mesh.world_size,
        "flights": B,
        "rms_mean_m": round(float(result["rms_mean"]), 4),
        "rms_max_m": round(float(result["rms_max"]), 4),
    }, indent=2))
    return 0


def _reference_fn(trajectory: str, amplitude: float, takeoff_height: float):
    import torch

    from .trajectories import ramped_circle_reference, ramped_figure8_reference

    if trajectory == "figure8":
        def ref(t):
            pos, yaw = ramped_figure8_reference(t, amplitude=amplitude)
            return pos + torch.tensor([0.0, 0.0, takeoff_height], dtype=pos.dtype,
                                      device=pos.device), yaw
    else:
        def ref(t):
            pos, _, yaw = ramped_circle_reference(
                t, amplitude=amplitude, height=takeoff_height
            )
            return pos, yaw
    return ref


def _cmd_tune(args) -> int:
    """Differentiable closed-loop tuning (the reference hand-tunes its
    gains)."""
    import numpy as np

    from .loop import FlightLoopConfig, mpc_flight_rollout, pid_flight_rollout
    from .tuning import TuneConfig, tune_cascade_gains, tune_mpc_weights

    dev = args.device
    cfg = FlightLoopConfig(**KERNEL_LOOP)
    num_steps = int(args.duration / cfg.control_dt)
    ref = _reference_fn(args.trajectory, args.amplitude, cfg.takeoff_height)
    tune_cfg = TuneConfig(
        iterations=args.iterations, learning_rate=args.learning_rate,
        settle_steps=min(250, num_steps // 4),
    )

    def rms(outs):
        err = (outs["state"][:, 0:3] - outs["pos_ref"]).detach().cpu().numpy()
        return float(np.sqrt((np.linalg.norm(err, axis=1) ** 2).mean()))

    t0 = time.time()
    if args.controller == "pid":
        from .models import PID_CAMPAIGN_RATE_LOOP

        rate_loop = PID_CAMPAIGN_RATE_LOOP
        result = tune_cascade_gains(
            ref, num_steps, tune_cfg=tune_cfg, rate_loop=rate_loop,
            loop_cfg=cfg, device=dev,
        )
        fly = lambda gains: pid_flight_rollout(
            ref, num_steps, gains=gains, rate_loop=rate_loop, cfg=cfg, device=dev
        )
        rms_before, rms_after = rms(fly(None)), rms(fly(result.params))
        tuned = {
            layer: {
                k: [round(float(v), 4) for v in
                    getattr(getattr(result.params, layer), k).detach().cpu().reshape(-1)]
                for k in ("kp", "ki", "kd")
            }
            for layer in ("position", "velocity", "attitude")
        }
    else:
        from .control.mpc_linear import LinearMPC, LinearMPCConfig

        result, tuned_config = tune_mpc_weights(
            ref, num_steps, tune_cfg=tune_cfg, loop_cfg=cfg, device=dev,
        )
        fly = lambda c: mpc_flight_rollout(
            LinearMPC(dataclasses.replace(c, **KERNEL_MPC), device=dev), ref, num_steps,
            cfg=cfg, device=dev)
        rms_before = rms(fly(LinearMPCConfig()))
        rms_after = rms(fly(tuned_config))
        tuned = {
            "q_pos": [round(v, 3) for v in tuned_config.q_pos],
            "q_vel": [round(v, 3) for v in tuned_config.q_vel],
            "r_control": [round(v, 3) for v in tuned_config.r_control],
            "terminal_pos_weight": round(tuned_config.terminal_pos_weight, 3),
            "terminal_vel_weight": round(tuned_config.terminal_vel_weight, 3),
        }

    payload = {
        "controller": args.controller,
        "trajectory": args.trajectory,
        "loss_initial": round(float(result.initial_loss), 5),
        "loss_final": round(float(result.final_loss), 5),
        "rms_pos_m_before": round(rms_before, 4),
        "rms_pos_m_after": round(rms_after, 4),
        "tune_seconds": round(time.time() - t0, 1),
        "tuned": tuned,
    }
    print(json.dumps(payload, indent=2))
    if args.save:
        with open(args.save, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"saved tuned parameters to {args.save}")
    return 0


def _fit_corpus_gp(gp_data_glob: str, dev):
    """Fit the flight GP on the CSV corpus (shared by fly and montecarlo).

    Returns ``(posterior, gp_cfg, X)``, or ``None`` when the glob matches
    nothing (the caller prints the error)."""
    import torch

    from .gp import fit_residual_gp
    from .gp.residual_gp import ResidualGPConfig
    from .io import load_gp_datasets

    gp_cfg = ResidualGPConfig()
    paths = sorted(glob.glob(gp_data_glob))
    if not paths:
        return None
    X, Y = load_gp_datasets(paths, max_samples=gp_cfg.max_data_points)
    post = fit_residual_gp(torch.as_tensor(X, dtype=torch.float32, device=dev),
                           torch.as_tensor(Y, dtype=torch.float32, device=dev), gp_cfg)
    return post, gp_cfg, X


def _cmd_montecarlo(args) -> int:
    """Monte-Carlo robustness study (randomised plants, winds and initial
    states)."""
    import math

    from .loop import FlightLoopConfig, MonteCarloConfig, monte_carlo_mpc, monte_carlo_pid

    dev = args.device
    cfg = FlightLoopConfig(**KERNEL_LOOP)
    num_steps = int(args.duration / cfg.control_dt)
    ref = _reference_fn(args.trajectory, args.amplitude, cfg.takeoff_height)
    mc = MonteCarloConfig(
        n_rollouts=args.rollouts, seed=args.seed, wind_std=args.wind_std,
        settle_steps=min(250, num_steps // 4),
    )
    if args.controller == "pid":
        from .models import PID_CAMPAIGN_RATE_LOOP

        stats = monte_carlo_pid(
            ref, num_steps, mc=mc, rate_loop=PID_CAMPAIGN_RATE_LOOP,
            loop_cfg=cfg, device=dev,
        )
    else:
        from .control.mpc_linear import LinearMPC, LinearMPCConfig

        mpc = LinearMPC(LinearMPCConfig(**KERNEL_MPC), device=dev)
        residual_fn = None
        if args.controller == "gp-mpc":
            from .gp import build_horizon_residuals

            fitted = _fit_corpus_gp(args.gp_data, dev)
            if fitted is None:
                print(f"no GP data matches {args.gp_data!r}", file=sys.stderr)
                return 1
            post, gp_cfg, _ = fitted
            residual_fn = lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gp_cfg)
        stats = monte_carlo_mpc(
            mpc, ref, num_steps, mc=mc, loop_cfg=cfg,
            residual_fn=residual_fn, device=dev,
        )

    # strict JSON: a crashed population gives NaN quantiles or an infinite
    # worst case; those print as null
    num = lambda k: (
        round(float(stats[k]), 4) if math.isfinite(float(stats[k])) else None
    )
    print(json.dumps({
        "controller": args.controller,
        "trajectory": args.trajectory,
        "rollouts": args.rollouts,
        "wind_std_mps": args.wind_std,
        "success_rate": num("success_rate"),
        "rms_pos_m_mean": num("rms_mean"),
        "rms_pos_m_p50": num("rms_p50"),
        "rms_pos_m_p90": num("rms_p90"),
        "rms_pos_m_p99": num("rms_p99"),
        "worst_max_pos_m": num("worst_max_pos"),
    }, indent=2, allow_nan=False))
    if args.plot:
        from .metrics import plot_robustness

        out = args.plot if isinstance(args.plot, str) else "montecarlo.png"
        plot_robustness(
            {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
             for k, v in stats.items()},
            out, title=f"{args.controller} {args.trajectory}",
        )
        print(f"dispersion figure written to {out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="unmanned_aerial_vehicles_tpu_torch",
        description="Quadrotor GP-MPC framework on PyTorch and CUDA",
    )
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device: cuda (the default: the hand-written "
                             "kernels; raises without a GPU) or cpu (the "
                             "kernels' plain PyTorch versions)")
    sub = p.add_subparsers(dest="command", required=True)
    add = lambda name, **kw: sub.add_parser(name, parents=[common], **kw)

    t = add("train-gp", help="offline GP training from flight CSVs")
    t.add_argument("--data", default="/root/reference/gp_datasets/*.csv")
    t.add_argument("--output", default="gp_model.npz")
    t.add_argument("--max-samples", type=int, default=10000)
    t.add_argument("--all-samples", action="store_true",
                   help="train on the FULL corpus, row-sharded over the "
                        "process group (a world of one without one; no "
                        "down-sampling), every Gram block through the Gram "
                        "kernel")
    t.add_argument("--cg-iterations", type=int, default=200)
    t.add_argument("--optimize", action="store_true", help="LML hyperparameter opt")
    t.add_argument("--opt-steps", type=int, default=100)
    t.set_defaults(fn=_cmd_train_gp)

    e = add("evaluate-gp", help="offline nominal-vs-GP evaluation")
    e.add_argument("--model", required=True,
                   help="GP checkpoint (.npz, or a reference sklearn .pkl; "
                        "unpickling runs arbitrary code — only load "
                        "pickles you trust)")
    e.add_argument("--data", required=True)
    e.add_argument("--output", default=None, help="metrics CSV prefix")
    e.add_argument("--full-analysis", action="store_true",
                   help="also run the GPModelEvaluator surface: physical "
                        "test regimes, uncertainty analysis, and the "
                        "distribution/uncertainty/correlation figures "
                        "(gp_evaluation.py:551-575; needs matplotlib)")
    e.set_defaults(fn=_cmd_evaluate_gp)

    f = add("fly", help="closed-loop flight experiment")
    f.add_argument("--controller",
                   choices=["pid", "mpc", "gp-mpc", "mpc12", "direct-rate12",
                            "ilqr12", "mppi12", "ltv12"],
                   default="gp-mpc")
    f.add_argument("--obstacle", action="append", default=None,
                   metavar="X,Y,Z,R",
                   help="spherical obstacle for --controller ltv12 "
                        "(repeatable): the LTV engine reserves linearised "
                        "half-space rows per obstacle "
                        "(mpc_controller.py:223-316 semantics)")
    f.add_argument("--trajectory", choices=["figure8", "circle"], default="figure8")
    f.add_argument("--duration", type=float, default=60.0)
    f.add_argument("--amplitude", type=float, default=6.0)
    f.add_argument("--gp-data", default="/root/reference/gp_datasets/*.csv")
    f.add_argument("--gp-model", default=None,
                   help="fly a saved GP checkpoint (train-gp output) "
                        "instead of refitting from --gp-data (the "
                        "reference's GP_USE_MODEL/GP_MODEL_PATH channel). "
                        ".pkl checkpoints are unpickled — arbitrary code "
                        "runs; only load pickles you trust")
    f.add_argument("--gp-mode", choices=["dynamics", "output"],
                   default="dynamics",
                   help="GP enters the prediction model ('dynamics', "
                        "mpc.py generation) or corrects the solved control "
                        "post-solve ('output', mpc_gp.py generation)")
    f.add_argument("--preview", action="store_true",
                   help="per-stage horizon references (removes tracking lag)")
    f.add_argument("--fast", action="store_true",
                   help="latency mode. mpc/gp-mpc: 8 whole ticks per "
                        "kernel launch, the GP in the kernel (its loop "
                        "precision 'default' computes in float32 on the "
                        "card). mpc12: the multitick per-dispatch-"
                        "relinearisation tier; direct-rate12: the fused "
                        "multitick kernel tier (K=8); ilqr12: the rk4 "
                        "policy-reuse tier (K=2); ltv12: the K=2 "
                        "multitick tier. pid ignores this; mppi12 "
                        "rejects it")
    f.add_argument("--online", action="store_true",
                   help="ONLINE in-flight GP learning on the fused path "
                        "(requires --controller gp-mpc --fast; no "
                        "pretrained model needed — ring-buffer capture "
                        "+ 5 s refits, the reference's retrain policy; "
                        "composes with --noisy: the GP then trains on EKF "
                        "estimates, the reference's EKF2-fed capture path)")
    f.add_argument("--save-log", default=None,
                   help="write the flight log (.npz snapshot, or .uavlog "
                        "for the streaming binary format)")
    f.add_argument("--animate", default=None, metavar="OUT.gif",
                   help="animated replay of the flight (the reference's "
                        "live-visualizer role, results_visualizer.py:17-30; "
                        "needs matplotlib; .gif always works headless, "
                        ".mp4 needs ffmpeg)")
    f.add_argument("--noisy", action="store_true",
                   help="fly on EKF-estimated state from noisy sensors "
                        "(estimation/; every controller but pid — ltv12 "
                        "runs the multi-rate 100 Hz-EKF/10 Hz-solve split)")
    f.add_argument("--seed", type=int, default=0,
                   help="sensor-noise generator seed (--noisy)")
    f.add_argument("--ekf-relin", choices=("tick", "dispatch"),
                   default="tick",
                   help="EKF process-Jacobian cadence on the fused tier "
                        "(--noisy --fast): per-tick exact (default) or "
                        "frozen per dispatch (cheaper, bounded drift)")
    f.add_argument("--ekf-cov", choices=("highest", "bf16"),
                   default="highest",
                   help="precision of the fused EKF's covariance "
                        "propagation (--noisy --fast), accepted for the "
                        "JAX package's command line: on the card both "
                        "compute in float32")
    f.add_argument("--wind", nargs=3, type=float, default=None,
                   metavar=("WX", "WY", "WZ"),
                   help="steady world-frame wind (m/s) on the TRUE plant "
                        "(mpc/gp-mpc family and ltv12 --noisy; drag acts "
                        "on airspeed)")
    f.add_argument("--disturbance-observer", action="store_true",
                   help="augmented-EKF disturbance observer (--noisy): "
                        "estimates the accel disturbance in flight and "
                        "feeds it to the MPC — wind rejection without "
                        "learning (estimation/disturbance.py)")
    f.add_argument("--push", nargs=3, type=float, default=None,
                   metavar=("AX", "AY", "AZ"),
                   help="constant unmodelled acceleration (m/s^2) on the "
                        "TRUE plant (direct-rate12 --noisy only; pair with "
                        "--disturbance-observer for the torque family's "
                        "learning-free rejection)")
    f.add_argument("--gust", nargs=4, type=float, default=None,
                   metavar=("T", "WX", "WY", "WZ"),
                   help="wind step-change on the TRUE plant: at t=T (s) "
                        "the wind switches from --wind to (WX, WY, WZ) "
                        "(mpc/gp-mpc --noisy; pair with "
                        "--disturbance-observer to watch the estimate "
                        "re-converge)")
    f.add_argument("--push-step", nargs=4, type=float, default=None,
                   metavar=("T", "AX", "AY", "AZ"),
                   help="the torque family's --gust: at t=T (s) the "
                        "unmodelled force switches from --push to "
                        "(AX, AY, AZ) on the TRUE plant (direct-rate12 "
                        "--noisy; pair with --disturbance-observer)")
    f.set_defaults(fn=_cmd_fly)

    m = add("mission", help="full phase-machine mission")
    m.add_argument("--duration", type=float, default=60.0)
    m.add_argument("--amplitude", type=float, default=6.0)
    m.add_argument("--noisy", action="store_true",
                   help="fly the WHOLE mission on EKF estimates (the "
                        "reference node's regime: every phase consumes "
                        "PX4-EKF2 output, mpc.py:1889-1907)")
    m.add_argument("--wind", nargs=3, type=float, default=None,
                   metavar=("WX", "WY", "WZ"),
                   help="steady world-frame wind on the true plant")
    m.add_argument("--disturbance-observer", action="store_true",
                   help="augmented-EKF disturbance observer across the "
                        "mission (requires --noisy)")
    m.add_argument("--seed", type=int, default=0)
    m.set_defaults(fn=_cmd_mission)

    o = add("online", help="online-learning GP-MPC flight")
    o.add_argument("--duration", type=float, default=60.0)
    o.add_argument("--amplitude", type=float, default=6.0)
    o.add_argument("--gp-capacity", type=int, default=400)
    o.add_argument("--refit-every", type=int, default=250)
    o.add_argument("--save-model", default=None)
    o.add_argument("--preview", action="store_true")
    o.set_defaults(fn=_cmd_online)

    an = add("analyze", help="flight-log metrics (+ optional plot)")
    an.add_argument("--log", required=True, help="npz flight log")
    an.add_argument("--plot", nargs="?", const=True, default=False,
                    help="write analysis figure (optional path; needs matplotlib)")
    an.add_argument("--animate", default=None, metavar="OUT.gif",
                    help="animated replay of the saved flight "
                         "(metrics/animate; needs matplotlib; .gif "
                         "headless, .mp4 with ffmpeg)")
    an.set_defaults(fn=_cmd_analyze)

    c = add("compare", help="standalone PID vs GP-MPC comparison")
    c.add_argument("--duration", type=float, default=30.0)
    c.set_defaults(fn=_cmd_compare)

    s = add("sweep", help="batch flight sweep sharded over the process group")
    s.add_argument("--flights", type=int, default=64)
    s.add_argument("--duration", type=float, default=20.0)
    s.set_defaults(fn=_cmd_sweep)

    tu = add("tune", help="differentiable closed-loop controller tuning")
    tu.add_argument("--controller", choices=["pid", "mpc"], default="pid")
    tu.add_argument("--trajectory", choices=["figure8", "circle"],
                    default="circle")
    tu.add_argument("--duration", type=float, default=30.0)
    tu.add_argument("--amplitude", type=float, default=6.0)
    tu.add_argument("--iterations", type=int, default=40)
    tu.add_argument("--learning-rate", type=float, default=0.06)
    tu.add_argument("--save", default=None, help="write tuned params JSON")
    tu.set_defaults(fn=_cmd_tune)

    mcp = add("montecarlo", help="Monte-Carlo robustness study (randomized "
              "plants / winds / initial states)")
    mcp.add_argument("--controller", choices=["pid", "mpc", "gp-mpc"],
                     default="mpc")
    mcp.add_argument("--gp-data", default="/root/reference/gp_datasets/*.csv")
    mcp.add_argument("--trajectory", choices=["figure8", "circle"],
                     default="circle")
    mcp.add_argument("--duration", type=float, default=30.0)
    mcp.add_argument("--amplitude", type=float, default=6.0)
    mcp.add_argument("--rollouts", type=int, default=256)
    mcp.add_argument("--wind-std", type=float, default=0.8)
    mcp.add_argument("--seed", type=int, default=0)
    mcp.add_argument("--plot", nargs="?", const=True, default=False,
                     help="write the dispersion figure (optional path; needs matplotlib)")
    mcp.set_defaults(fn=_cmd_montecarlo)
    return p


def main(argv=None) -> int:
    from ._device import resolve_device

    args = build_parser().parse_args(argv)
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
