"""The experiment campaign on the PyTorch/CUDA port.

The counterpart of ``tools/run_campaign.py``: flies the campaign's 29 rows (the reference's BASELINE.md flights and the
rows beyond them) in the JAX tool's order and under its names, prints the
same lines and gates, and writes under ``artifacts_torch/`` (``ARTIFACTS``;
``artifacts/`` belongs to the JAX package and is never written):

* ``<run>.npz``      - flight logs (the rosbag analogue)
* ``<run>.png``      - analysis figure per flight, where matplotlib imports
* ``comparison_<traj>.png`` - standalone PID-vs-GPMPC comparison panels, likewise
* ``metrics_summary.json``  - ours vs the published reference baselines
* ``kernel_launches.json``  - each row's host seconds and kernel launches

Run:  python3 tools_torch/run_campaign.py [--duration 132] --gp-data 'DIR/*.csv'
      python3 tools_torch/run_campaign.py --device cpu ...   # the plain versions

``--device`` has the command line's meaning: without it the campaign runs on
``cuda`` (the hand-written kernels) and raises without a GPU; ``cpu`` flies
the kernels' plain PyTorch versions. Where the JAX tool flies the staged
defaults, the rows turn the kernel routes on as the command line does
(``cli.KERNEL_LOOP``, ``cli.KERNEL_MPC``): the plant substeps through K1 or
K2 and each staged solve through K3 (N=25, 80 iterations; K16 for the
populations, K13a under the tuner's backward). The fused rows keep the JAX
tool's N=20, 60 iterations: K5 or K9 per 8 ticks, K4 a tick for the oracle
row. The fused rows fly the largest multiple of 8 ticks that the duration
holds (the whole flight at the default 132 s).

A ``--gp-data`` glob that yields no usable rows exits 1 before any flight
(the JAX tool fits its GP on zero points and flies NaN residuals). The
noisy rows each draw their sensor stream from their own
``torch.Generator(device).manual_seed(2)`` (the JAX tool's
``PRNGKey(2)``), so a row's draws do not depend on what ran before it.

Each section is a function of ``(summary, ..., device, plain_kernels)`` that
records its rows into ``summary`` and returns their outputs; ``rows=``
flies a subset. The lengths of the tuner, the populations, the comparisons
and the settle windows are the module constants below.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from unmanned_aerial_vehicles_tpu_torch import cli  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch._device import resolve_device  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import (  # noqa: E402
    LinearMPC,
    LinearMPCConfig,
)
from unmanned_aerial_vehicles_tpu_torch.estimation import (  # noqa: E402
    EKFConfig,
    noisy_mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.gp import (  # noqa: E402
    build_horizon_residuals,
    fit_residual_gp,
)
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.io import load_gp_datasets, save_flight_log  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.loop import (  # noqa: E402
    FlightLoopConfig,
    MonteCarloConfig,
    OnlineFusedGPConfig,
    OnlineGPMPCConfig,
    comparison_summary,
    monte_carlo_mpc,
    monte_carlo_pid,
    mpc_flight_rollout,
    online_gp_mpc_rollout,
    pid_flight_rollout,
    run_comparison,
)
from unmanned_aerial_vehicles_tpu_torch.metrics import tracking_metrics  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.models import (  # noqa: E402
    PID_CAMPAIGN_RATE_LOOP,
    RigidBodyParams,
)
from unmanned_aerial_vehicles_tpu_torch.ops import _cuda  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.tuning import (  # noqa: E402
    TuneConfig,
    tune_cascade_gains,
)

ARTIFACTS = os.path.join(REPO, "artifacts_torch")

# the JAX tool's literals (tools/run_campaign.py:319-325, :342-344, :371-373,
# :116), and the settle windows it takes from TuneConfig and MonteCarloConfig
TUNE_WINDOW_S = 30.0
TUNE_ITERATIONS = 40
TUNE_LEARNING_RATE = 0.06
TUNE_SETTLE_S = 5.0           # TuneConfig().settle_steps at 50 Hz
MC_WINDOW_S = 30.0
MC_ROLLOUTS = 256
MC_SETTLE_S = 5.0             # MonteCarloConfig().settle_steps at 50 Hz
COMPARISON_S = 30.0
GUST_SETTLE_S = 6.0           # the post-gust window starts this long after the step
FUSED_TICKS = 8               # ticks per launch of the fused multi-tick rows
NOISE_SEED = 2                # each noisy row's generator

REFERENCE_BASELINES = {
    "mpc_flight_figure8": {
        "rms_pos": 1.094, "max_pos": 1.674,
        "source": "bags/mpc_flight_figure8_20251129_170402",
    },
    "gpmpc_flight_figure8": {
        "rms_pos": 1.086, "max_pos": 1.658,
        "source": "bags/metrics_figure8_1_gpmpc (run 20251123_215457)",
    },
    "pid_flight_circle": {
        "rms_pos": 2.524, "max_pos": 2.759,
        "source": "bags/metrics_circle_1_PID (run pid_cascade_20251119_001928)",
    },
}

WINDY = RigidBodyParams(wind=(1.5, 0.8, 0.0))
GUST_WIND = (-1.0, 1.5, 0.0)  # the wind after the step at duration / 2
_plots_skipped = []           # one line on stdout the first time a plot is skipped
ROW_LOG: dict = {}            # row -> its host seconds and kernel launches, in this process
_mark: dict = {}


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _loop_cfg(**kw) -> FlightLoopConfig:
    """The JAX tool's staged loop config with the plant kernels on."""
    return FlightLoopConfig(**cli.KERNEL_LOOP, **kw)


def _staged_mpc(dev) -> LinearMPC:
    return LinearMPC(LinearMPCConfig(**cli.KERNEL_MPC), device=dev)


def _fused_mpc(dev) -> LinearMPC:
    return LinearMPC(LinearMPCConfig(horizon=20, admm_iterations=60,
                                     use_fused_controller=True), device=dev)


def _fused_cfg() -> FlightLoopConfig:
    return FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=FUSED_TICKS)


def _steps(duration: float) -> int:
    return int(duration / FlightLoopConfig().control_dt)


def _fused_steps(duration: float) -> int:
    n = _steps(duration)
    return n - n % FUSED_TICKS


def _fig8():
    return cli._reference_fn("figure8", 6.0, FlightLoopConfig().takeoff_height)


def _circle():
    return cli._reference_fn("circle", 6.0, FlightLoopConfig().takeoff_height)


def _host(outs) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in outs.items()}


def _metrics(o) -> dict:
    m = tracking_metrics(
        torch.as_tensor(o["pos_ref"]), torch.as_tensor(o["state"][:, 0:3]),
        vel_setpoint=torch.as_tensor(o["vel_ref"]) if "vel_ref" in o else None,
        vel_current=torch.as_tensor(o["state"][:, 3:6]) if "vel_ref" in o else None,
        att_setpoint=torch.as_tensor(o["att_ref"]) if "att_ref" in o else None,
        att_current=torch.as_tensor(o["state"][:, 6:9]) if "att_ref" in o else None,
        thrust_normalized=torch.as_tensor(o["thrust"]),
    )
    return {k: float(v) for k, v in m.items()}


def _errors(o) -> np.ndarray:
    return np.linalg.norm(o["pos_ref"] - o["state"][:, 0:3], axis=1)


def _tail_metrics(o) -> dict:
    e = _errors(o)
    half = len(e) // 2
    return {
        "rms_pos": float(np.sqrt((e**2).mean())),
        "rms_pos_tail": float(np.sqrt((e[half:] ** 2).mean())),
        "max_pos": float(e.max()),
    }


def _est_rms(o) -> float:
    return float(np.sqrt(np.mean(np.sum(
        (o["state_est"][:, 0:3] - o["state"][:, 0:3]) ** 2, -1))))


def _can_plot() -> bool:
    """Whether matplotlib imports; the first time it does not, one line says
    the plots are skipped."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        if not _plots_skipped:
            print("plots skipped: matplotlib is not installed (the .npz logs and "
                  "metrics_summary.json are written)")
        _plots_skipped.append(True)
        return False
    return True


def _plot_flight(log: dict, name: str) -> None:
    if _can_plot():
        from unmanned_aerial_vehicles_tpu_torch.metrics import plot_flight_log

        plot_flight_log(log, os.path.join(ARTIFACTS, f"{name}.png"), title=name)


def _plot_comparison(outs: dict, traj: str) -> None:
    if _can_plot():
        from unmanned_aerial_vehicles_tpu_torch.metrics import plot_comparison

        plot_comparison(outs, os.path.join(ARTIFACTS, f"comparison_{traj}.png"), traj)


def _save(name: str, o: dict) -> None:
    os.makedirs(ARTIFACTS, exist_ok=True)
    save_flight_log(os.path.join(ARTIFACTS, f"{name}.npz"), o)
    _plot_flight(o, name)


def _start_row() -> None:
    """Mark the clock and the kernels' launch counts where a row starts."""
    _mark.update(time=time.perf_counter(), counts=dict(_cuda.launch_counts))


def _record(summary: dict, name: str, row: dict, o: dict | None = None) -> None:
    """Put a row into ``summary`` and its seconds and launches since
    ``_start_row`` into ``ROW_LOG``, save its log (``o``, if given), print
    it and start the next row."""
    ROW_LOG[name] = {
        "seconds": time.perf_counter() - _mark["time"],
        "launches": {k: v - _mark["counts"].get(k, 0) for k, v in _cuda.launch_counts.items()
                     if v != _mark["counts"].get(k, 0)},
    }
    summary[name] = row
    if o is not None:
        _save(name, o)
    print(name, json.dumps(summary[name]))
    _start_row()


def _wanted(rows, name: str) -> bool:
    return rows is None or name in rows


def _noise(noise, dev):
    """A noisy row's sensor draws: ``noise`` as given, else its own generator."""
    if noise is not None:
        return dict(noise=noise)
    return dict(generator=torch.Generator(dev).manual_seed(NOISE_SEED))


def oracle_residual_fn(dev):
    """The exact accel residual of the windy plant vs the nominal model:
    drag acts on the airspeed v - w instead of v (models.rigid_body)."""
    kd = WINDY.k_drag_linear / WINDY.mass
    wvec = torch.tensor(WINDY.wind[:3], dtype=torch.float32, device=dev)

    def oracle_residual(Xg, Ug):
        n_st = Ug.shape[0]
        v = Xg[:n_st, 3:6]
        av = v - wvec[None, :]
        a_res = -kd * (
            torch.linalg.vector_norm(av, dim=1, keepdim=True) * av
            - torch.linalg.vector_norm(v, dim=1, keepdim=True) * v
        )
        return torch.cat([torch.zeros_like(a_res), a_res], dim=1)

    return oracle_residual


# ---------------------------------------------------------------------------
# the sections
# ---------------------------------------------------------------------------


def load_corpus(gp_data: str):
    """The offline corpus's ``(X, Y)`` (at most the GP's 800 points, evenly
    down-sampled); zero rows when the glob matches nothing usable."""
    gp_cfg = ResidualGPConfig()
    return load_gp_datasets(sorted(glob.glob(gp_data)), max_samples=gp_cfg.max_data_points)


def fit_corpus_gp(X, Y, device=None, plain_kernels=False):
    """The GP posterior from the reference's offline corpus (P=800): float32
    on the card, float64 on the CPU (``cli._gp_dtype``). The fit runs no
    kernel of its own, so ``plain_kernels`` changes nothing here. Returns
    ``residual_fn(X_guess, U_guess) -> (N, 6)`` in the guess's dtype."""
    dev = resolve_device(device)
    gp_cfg = ResidualGPConfig()
    dt = cli._gp_dtype(dev)
    post = fit_residual_gp(torch.as_tensor(X, dtype=dt, device=dev),
                           torch.as_tensor(Y, dtype=dt, device=dev), gp_cfg)
    return lambda Xg, Ug: build_horizon_residuals(
        post, Xg.to(dt), Ug.to(dt), gp_cfg).to(Xg.dtype)


def baseline_rows(summary, duration, residual_fn, device=None, plain_kernels=False, rows=None):
    """The flights of BASELINE.md rows 1-3, and GP-MPC with preview."""
    dev = resolve_device(device)
    _start_row()
    cfg, num_steps, fig8, circle = _loop_cfg(), _steps(duration), _fig8(), _circle()
    mpc = _staged_mpc(dev)
    kw = dict(cfg=cfg, device=dev, plain_kernels=plain_kernels)
    runs = {
        "mpc_flight_figure8": lambda: mpc_flight_rollout(mpc, fig8, num_steps, **kw),
        "gpmpc_flight_figure8": lambda: mpc_flight_rollout(
            mpc, fig8, num_steps, residual_fn=residual_fn, **kw),
        "pid_flight_circle": lambda: pid_flight_rollout(
            circle, num_steps, rate_loop=PID_CAMPAIGN_RATE_LOOP, **kw),
        "gpmpc_preview_figure8": lambda: mpc_flight_rollout(
            mpc, fig8, num_steps, residual_fn=residual_fn, preview=True, **kw),
    }
    out = {}
    for name, fn in runs.items():
        if _wanted(rows, name):
            out[name] = o = _host(fn())
            _record(summary, name, _metrics(o), o)
    return out


def tuner_rows(summary, duration, device=None, plain_kernels=False):
    """Differentiable auto-tuning (capability beyond the reference): tune
    the cascade gains on a TUNE_WINDOW_S window, then fly the FULL campaign
    circle with them (the reference's gains are hand-tuned "emergency safe"
    values, cascade_pid_demo.py:194-210). K1 forward, K13a backward."""
    dev = resolve_device(device)
    _start_row()
    cfg, circle = _loop_cfg(), _circle()
    tuned = tune_cascade_gains(
        circle, _steps(TUNE_WINDOW_S), rate_loop=PID_CAMPAIGN_RATE_LOOP, loop_cfg=cfg,
        tune_cfg=TuneConfig(iterations=TUNE_ITERATIONS, learning_rate=TUNE_LEARNING_RATE,
                            settle_steps=_steps(TUNE_SETTLE_S)),
        device=dev, plain_kernels=plain_kernels,
    )
    o = _host(pid_flight_rollout(circle, _steps(duration), gains=tuned.params, cfg=cfg,
                                 rate_loop=PID_CAMPAIGN_RATE_LOOP, device=dev,
                                 plain_kernels=plain_kernels))
    _record(summary, "pid_flight_circle_tuned", _metrics(o), o)
    return {"pid_flight_circle_tuned": o}


def population_rows(summary, device=None, plain_kernels=False, rows=None):
    """Monte-Carlo robustness (capability beyond the reference): MC_ROLLOUTS
    flights of MC_WINDOW_S, one batch a tick (K16 and K2; K1 for PID)."""
    dev = resolve_device(device)
    _start_row()
    cfg, circle = _loop_cfg(), _circle()
    mpc = _staged_mpc(dev)
    mc = MonteCarloConfig(n_rollouts=MC_ROLLOUTS, wind_std=0.8,
                          settle_steps=_steps(MC_SETTLE_S))
    guard_cfg = _loop_cfg(fallback_error_m=1.5)
    mc_steps = _steps(MC_WINDOW_S)
    kw = dict(mc=mc, device=dev, plain_kernels=plain_kernels)
    runs = {
        "montecarlo_mpc_circle": lambda: monte_carlo_mpc(
            mpc, circle, mc_steps, loop_cfg=cfg, **kw),
        "montecarlo_pid_circle": lambda: monte_carlo_pid(
            circle, mc_steps, rate_loop=PID_CAMPAIGN_RATE_LOOP, loop_cfg=cfg, **kw),
        # same population with the divergence-triggered hover fallback wired
        # in (the reference's >50 m hover-mode switch policy, src/px4/mpc.py:
        # 2276-2282, at a 1.5 m trigger): bounds the worst-case excursion
        "montecarlo_mpc_circle_fallback": lambda: monte_carlo_mpc(
            mpc, circle, mc_steps, loop_cfg=guard_cfg, **kw),
    }
    out = {}
    for name, fn in runs.items():
        if _wanted(rows, name):
            stats = fn()
            out[name] = {k: float(v) for k, v in sorted(stats.items()) if v.ndim == 0}
            _record(summary, name, out[name])
    return out


def comparison_rows(summary, device=None, plain_kernels=False):
    """The standalone comparison campaign (docs/images/comparison_*.png):
    COMPARISON_S of each trajectory. The harness runs no kernel, so
    ``plain_kernels`` changes nothing here."""
    dev = resolve_device(device)
    _start_row()
    out = {}
    for traj in ("figure8", "circle", "hover", "step"):
        o = _host(run_comparison(traj, duration=COMPARISON_S, device=dev))
        out[f"comparison_{traj}"] = o
        _record(summary, f"comparison_{traj}",
                comparison_summary({k: torch.as_tensor(v) for k, v in o.items()}))
        _plot_comparison(o, traj)
    return out


def online_rows(summary, duration, device=None, plain_kernels=False):
    """Online in-flight learning with preview (400-point ring, a refit every
    250 ticks; K3 and K1 a tick)."""
    dev = resolve_device(device)
    _start_row()
    online_cfg = OnlineGPMPCConfig(
        flight=_loop_cfg(), gp=ResidualGPConfig(max_data_points=400), gp_refit_every=250,
        preview=True,
    )
    outs, dataset, _ = online_gp_mpc_rollout(_staged_mpc(dev), _fig8(), _steps(duration),
                                             cfg=online_cfg, device=dev,
                                             plain_kernels=plain_kernels)
    o = _host(outs)
    err = _errors(o)
    _record(summary, "online_preview_figure8", {
        "rms_pos": float(np.sqrt((err**2).mean())),
        "max_pos": float(err.max()),
        "mean_thrust_sat_pct": float(
            100.0 * ((o["thrust"] >= 0.99) | (o["thrust"] <= 0.11)).mean()
        ),
        "gp_samples_collected": int(dataset.count),
    }, o)
    return {"online_preview_figure8": o}


def mismatched_rows(summary, duration, device=None, plain_kernels=False, rows=None):
    """GP-MPC wins on MISMATCHED plants. The nominal campaign plant gives
    the double-integrator model nothing to miss, so GP-MPC ties plain MPC
    there (faithful to the reference's own thin 1.086-vs-1.094 margin).
    These rows fly plants the model gets WRONG in ways the GP can learn.
    residual_gain=1.0 (the reference's conservative 0.1 caps correction at
    10%); preview so tracking lag doesn't mask the effect."""
    dev = resolve_device(device)
    _start_row()
    cfg, num_steps, fig8 = _loop_cfg(), _steps(duration), _fig8()
    mpc = _staged_mpc(dev)
    out = {}

    def online_row(name, body):
        ocfg = OnlineGPMPCConfig(
            flight=cfg, gp=ResidualGPConfig(max_data_points=400, residual_gain=1.0),
            gp_refit_every=250, preview=True,
        )
        o, ds, _ = online_gp_mpc_rollout(mpc, fig8, num_steps, cfg=ocfg, body=body,
                                         device=dev, plain_kernels=plain_kernels)
        out[name] = o = _host(o)
        _record(summary, name, _tail_metrics(o) | {"gp_samples_collected": int(ds.count)}, o)

    def plain_row(name, body):
        out[name] = o = _host(mpc_flight_rollout(mpc, fig8, num_steps, body=body, cfg=cfg,
                                                 preview=True, device=dev,
                                                 plain_kernels=plain_kernels))
        _record(summary, name, _tail_metrics(o), o)

    # (a) mismatched physical plant: +10% mass, +50% drag, steady wind
    perturbed = RigidBodyParams(mass=0.55, k_drag_linear=0.375, wind=(1.0, 0.5, 0.0))
    # (b) the wind-rejection trio (tests/test_full_system.py measured
    # 0.19 / 1.38 / 0.85 m on the 40 s window; full campaign length here)
    for name, fly, body in (
        ("mpc_perturbed_figure8", plain_row, perturbed),
        ("gpmpc_online_perturbed_figure8", online_row, perturbed),
        ("mpc_preview_nowind_figure8", plain_row, RigidBodyParams()),
        ("mpc_preview_windy_figure8", plain_row, WINDY),
        ("gpmpc_online_windy_figure8", online_row, WINDY),
    ):
        if _wanted(rows, name):
            fly(name, body)
    return out


def fused_online_rows(summary, duration, device=None, plain_kernels=False, rows=None):
    """The windy-recovery rows on the FUSED tiers:
    - fresh refits (128-pt ring, 64-tick retrain; K5 per 8 ticks);
    - the opt-in standardized-input ARD mode
      (OnlineFusedGPConfig.standardize_inputs);
    - the ORACLE row feeds the EXACT windy-plant accel residual as
      residual_fn - a perfect GP - on the single-tick tier (K4 a tick). It
      lands ABOVE the fresh online row in the JAX package's run: the
      residual tracking error is a control-structure bound, not a
      GP-learning bound."""
    dev = resolve_device(device)
    _start_row()
    mpc_fused, fig8 = _fused_mpc(dev), _fig8()
    out = {}

    def online_fused_row(name, ogp):
        out[name] = o = _host(mpc_flight_rollout(
            mpc_fused, fig8, _fused_steps(duration), body=WINDY, cfg=_fused_cfg(),
            preview=True, online_gp=ogp, gp_gain=1.0, device=dev,
            plain_kernels=plain_kernels))
        _record(summary, name,
                _tail_metrics(o) | {"gp_samples_collected": int(o["gp_count"][-1])}, o)

    ring = ResidualGPConfig(max_data_points=128, residual_gain=1.0)
    if _wanted(rows, "gpmpc_online_fresh_windy_figure8"):
        online_fused_row("gpmpc_online_fresh_windy_figure8",
                         OnlineFusedGPConfig(gp=ring, refit_every=64))
    if _wanted(rows, "gpmpc_online_scaled_windy_figure8"):
        online_fused_row("gpmpc_online_scaled_windy_figure8",
                         OnlineFusedGPConfig(gp=ring, refit_every=64, standardize_inputs=True))
    name = "mpc_oracle_residual_windy_figure8"
    if _wanted(rows, name):
        # no log is saved for this row, as in the JAX tool
        out[name] = o = _host(mpc_flight_rollout(
            mpc_fused, fig8, _steps(duration), body=WINDY,
            cfg=FlightLoopConfig(use_fused_tick=True), preview=True,
            residual_fn=oracle_residual_fn(dev), device=dev, plain_kernels=plain_kernels))
        _record(summary, name, _tail_metrics(o))
    return out


def noisy_rows(summary, duration, device=None, plain_kernels=False, rows=None, noise=None):
    """Learning FROM THE ESTIMATOR (online + noisy; K9 per 8 ticks), the
    reference's actual capture path (the flight node's captured "state" is
    PX4-EKF2 output, src/px4/mpc.py:1889-1907,2016-2021): the GP trained on
    EKF ESTIMATES must still recover the wind penalty vs the plain noisy
    flight (gated). Then the LEARNING-FREE alternative: the augmented-EKF
    disturbance observer (estimation/disturbance.py) estimates the wind
    accel in flight and feeds it forward, on the staged path (K3 and K1).
    ``noise`` (T, 9) replaces each row's generator draws."""
    dev = resolve_device(device)
    _start_row()
    mpc_fused, fig8, num_steps = _fused_mpc(dev), _fig8(), _fused_steps(duration)
    out = {}

    def noisy_windy_row(name, ogp):
        o = _host(noisy_mpc_flight_rollout(
            mpc_fused, fig8, num_steps, ekf_cfg=EKFConfig(), body=WINDY, cfg=_fused_cfg(),
            preview=True, online_gp=ogp, gp_gain=1.0, device=dev, plain_kernels=plain_kernels,
            **_noise(noise, dev)))
        out[name] = o
        row = _tail_metrics(o) | {"est_rms_pos": _est_rms(o)}
        if ogp is not None:
            row["gp_samples_collected"] = int(o["gp_count"][-1])
        _record(summary, name, row, o)

    if _wanted(rows, "mpc_noisy_windy_figure8"):
        noisy_windy_row("mpc_noisy_windy_figure8", None)
    if _wanted(rows, "gpmpc_online_noisy_windy_figure8"):
        noisy_windy_row("gpmpc_online_noisy_windy_figure8", OnlineFusedGPConfig(
            gp=ResidualGPConfig(max_data_points=128, residual_gain=1.0), refit_every=64))
    name = "mpc_dob_noisy_windy_figure8"
    if _wanted(rows, name):
        o = _host(noisy_mpc_flight_rollout(
            mpc_fused, fig8, num_steps, ekf_cfg=EKFConfig(), body=WINDY,
            cfg=dataclasses.replace(_fused_cfg(), use_fused_tick=False, **cli.KERNEL_LOOP),
            preview=True, disturbance_observer=True, device=dev, plain_kernels=plain_kernels,
            **_noise(noise, dev)))
        out[name] = o
        half = len(o["state"]) // 2
        _record(summary, name, _tail_metrics(o) | {
            "est_rms_pos": _est_rms(o),
            "disturbance_est_tail_mean": [
                float(v) for v in o["disturbance_est"][half:].mean(axis=0)
            ],
        }, o)
    return out


def gusty_rows(summary, duration, device=None, plain_kernels=False, rows=None, noise=None):
    """GUSTS - time-varying wind (wind_fn=), a step change mid-flight.

    This is the scenario that separates the observer from ANY frozen model:
    the stale-oracle row feeds the PERFECT residual of the PRE-gust wind
    (the ceiling for anything learned before the gust - including the
    reference's 5 s-stale retrain, gaussian_process.py:122); the observer
    re-converges in-flight. Gated on the POST-gust window (GUST_SETTLE_S
    after the step to the end): observer beats plain AND beats the stale
    oracle. The fused row flies the SAME observer+gust at the latency tier
    (per-tick plant rows + 15-state filter inside the multi-tick kernel,
    K9) and must glue to the staged row (K3 and K1). ``noise`` (T, 9)
    replaces each row's generator draws."""
    dev = resolve_device(device)
    _start_row()
    mpc_fused, fig8, num_steps = _fused_mpc(dev), _fig8(), _fused_steps(duration)
    fused_cfg = _fused_cfg()
    staged_cfg = dataclasses.replace(fused_cfg, use_fused_tick=False, **cli.KERNEL_LOOP)
    t_gust = duration / 2.0
    w_pre = torch.tensor(WINDY.wind[:3], dtype=torch.float32, device=dev)
    w_post = torch.tensor(GUST_WIND, dtype=torch.float32, device=dev)

    def gust_wind(t):
        return torch.where(torch.as_tensor(t) < t_gust, w_pre, w_post)

    i_post = int((t_gust + GUST_SETTLE_S) / FlightLoopConfig().control_dt)
    out = {}

    def gusty_row(name, dob, res_fn, loop_cfg=staged_cfg, ogp=None):
        o = _host(noisy_mpc_flight_rollout(
            mpc_fused, fig8, num_steps, ekf_cfg=EKFConfig(), body=WINDY, cfg=loop_cfg,
            preview=True, disturbance_observer=dob, residual_fn=res_fn, wind_fn=gust_wind,
            online_gp=ogp, gp_gain=1.0 if ogp is not None else 0.1, device=dev,
            plain_kernels=plain_kernels, **_noise(noise, dev)))
        out[name] = o
        e = _errors(o)
        row = {
            "rms_pos": float(np.sqrt((e**2).mean())),
            "rms_pos_postgust": float(np.sqrt((e[i_post:] ** 2).mean())),
            "max_pos": float(e.max()),
        }
        if dob is not None:
            row["disturbance_est_postgust_mean"] = [
                float(v) for v in o["disturbance_est"][i_post:].mean(axis=0)
            ]
        if ogp is not None:
            row["gp_samples_collected"] = int(o["gp_count"][-1])
        _record(summary, name, row, o)

    for name, args in (
        ("mpc_noisy_gusty_figure8", (None, None)),
        ("mpc_stale_oracle_gusty_figure8", (None, oracle_residual_fn(dev))),
        ("mpc_dob_noisy_gusty_figure8", (True, None)),
        # the latency tier: same observer+gust INSIDE the multi-tick kernel
        ("mpc_dob_gusty_fused_figure8", (True, None, fused_cfg)),
        # in-flight ONLINE learning under the gust (fused tier - the ring
        # buffer turns over in ~2.6 s, so unlike the stale oracle this model
        # is NOT frozen; the honest comparison for the observer's "adapts to
        # wind never seen" claim)
        ("gpmpc_online_gusty_figure8", (None, None, fused_cfg, OnlineFusedGPConfig(
            gp=ResidualGPConfig(max_data_points=128, residual_gain=1.0), refit_every=64))),
    ):
        if _wanted(rows, name):
            gusty_row(name, *args)
    return out


def gust_gates(summary) -> None:
    # gust gates (post-gust window): the observer must beat the plain
    # flight AND the stale oracle - the PERFECT pre-gust model - because
    # only the observer adapts to wind it has never seen; both on the
    # staged path and at the latency tier
    for a, b in (
        ("mpc_dob_noisy_gusty_figure8", "mpc_noisy_gusty_figure8"),
        ("mpc_dob_noisy_gusty_figure8", "mpc_stale_oracle_gusty_figure8"),
        ("mpc_dob_gusty_fused_figure8", "mpc_noisy_gusty_figure8"),
        ("mpc_dob_gusty_fused_figure8", "mpc_stale_oracle_gusty_figure8"),
        # in-flight RELEARNING (ring turnover ~2.6 s) also survives the
        # gust - unlike the frozen stale oracle
        ("gpmpc_online_gusty_figure8", "mpc_noisy_gusty_figure8"),
        ("gpmpc_online_gusty_figure8", "mpc_stale_oracle_gusty_figure8"),
    ):
        ga = summary[a]["rms_pos_postgust"]
        gb = summary[b]["rms_pos_postgust"]
        status = "BEATS" if ga < gb else "WORSE THAN"
        print(f"{a}: {ga:.3f} m {status} {b} {gb:.3f} m (post-gust)")
    # and the fused row must GLUE to the staged row (same config, same
    # draws; the kernel's per-tick plant rows are a semantics-preserving
    # execution tier, not a different controller)
    ga = summary["mpc_dob_gusty_fused_figure8"]["rms_pos_postgust"]
    gb = summary["mpc_dob_noisy_gusty_figure8"]["rms_pos_postgust"]
    status = "TIES" if abs(ga - gb) < max(0.05, 0.1 * gb) else "DIVERGES FROM"
    print(f"mpc_dob_gusty_fused_figure8: {ga:.3f} m {status} staged "
          f"{gb:.3f} m (post-gust)")


def gates(summary) -> None:
    """The hard gates: the three published baselines must be beaten, and
    GP-MPC must WIN where the plant is mismatched (its reason to exist)."""
    for key in REFERENCE_BASELINES:
        ours, ref = summary[key]["rms_pos"], REFERENCE_BASELINES[key]["rms_pos"]
        status = "BEATS" if ours <= ref else "WORSE THAN"
        print(f"{key}: {ours:.3f} m {status} reference {ref:.3f} m")
    for a, b in (
        ("gpmpc_online_perturbed_figure8", "mpc_perturbed_figure8"),
        ("gpmpc_online_windy_figure8", "mpc_preview_windy_figure8"),
        # learned GP at fresh refits must match/beat the PERFECT residual
        # oracle (the "no learning headroom left" evidence)
        ("gpmpc_online_fresh_windy_figure8", "mpc_oracle_residual_windy_figure8"),
        # learning FROM EKF ESTIMATES must still recover the wind penalty
        # (the reference's EKF2-fed capture path)
        ("gpmpc_online_noisy_windy_figure8", "mpc_noisy_windy_figure8"),
        # the LEARNING-FREE observer must recover it too
        ("mpc_dob_noisy_windy_figure8", "mpc_noisy_windy_figure8"),
    ):
        ga = summary[a]["rms_pos_tail"]
        gb = summary[b]["rms_pos_tail"]
        status = "BEATS" if ga < gb else "WORSE THAN"
        print(f"{a}: {ga:.3f} m {status} {b} {gb:.3f} m")
    gust_gates(summary)


def note(duration: float) -> str:
    return (
        f"{duration:.0f} s flights on the PX4-surrogate plant; "
        "pid_flight_circle uses the campaign-calibrated hover thrust "
        "(models.px4_surrogate.PID_CAMPAIGN_RATE_LOOP); preview mode "
        "feeds per-stage horizon references (capability beyond the "
        "reference's point-target tracking); thrust_sat_nonhover_pct is "
        "the informative (hover-band-excluded) saturation variant; "
        "pid_flight_circle_tuned flies gains auto-tuned by gradient "
        "descent through the closed loop (tuning/, 30 s window); "
        "montecarlo_* rows are 256-flight dispersion studies "
        "(randomized mass/drag/lags/wind, loop.monte_carlo); "
        "*_gusty rows fly a wind step-change at duration/2 and "
        "rms_pos_postgust measures from 6 s after the step to the "
        "end (mpc_dob_gusty_fused runs the observer+gust INSIDE the "
        "fused multi-tick kernel; gpmpc_online_gusty relearns "
        "in-flight through the gust)"
    )


def _default_gp_data() -> str:
    """The command line's ``--gp-data`` default (the reference's corpus)."""
    return cli.build_parser().parse_args(["fly"]).gp_data


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=132.0)
    ap.add_argument("--gp-data", default=_default_gp_data())
    ap.add_argument(
        "--only-gusty", action="store_true",
        help="recompute ONLY the gusty rows (deterministic seeds) and merge "
             "into the existing metrics_summary.json",
    )
    ap.add_argument("--device", default=None,
                    help="torch device: cuda (the default: the hand-written kernels; "
                         "raises without a GPU) or cpu (the kernels' plain PyTorch versions)")
    return ap


def _write_row_log(dev, merge: bool) -> None:
    """``kernel_launches.json``: each row's host seconds and kernel launches
    (none on the CPU, where the plain versions run) in this process, merged
    into the file's rows with ``merge``."""
    path = os.path.join(ARTIFACTS, "kernel_launches.json")
    rows = {}
    if merge and os.path.exists(path):
        with open(path) as f:
            rows = json.load(f)["rows"]
    with open(path, "w") as f:
        json.dump({"device": str(dev), "rows": rows | ROW_LOG}, f, indent=2)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    out_path = os.path.join(ARTIFACTS, "metrics_summary.json")
    ROW_LOG.clear()

    if args.only_gusty:
        with open(out_path) as f:
            payload = json.load(f)
        summary = payload["ours"]
        gusty_rows(summary, args.duration, dev)
        payload["note"] = note(args.duration)
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=2)
        _write_row_log(dev, merge=True)
        print("wrote", out_path, "(gusty rows merged)")
        gust_gates(summary)
        return 0

    # the GP posterior from the reference's offline corpus; none, no flight
    X, Y = load_corpus(args.gp_data)
    if X.shape[0] == 0:
        print(f"no usable GP corpus rows match --gp-data {args.gp_data!r}: the corpus is "
              f"missing; pass a glob of CSVs in the reference's layout "
              f"(io.save_gp_dataset)", file=sys.stderr)
        return 1
    residual_fn = fit_corpus_gp(X, Y, dev)

    summary: dict = {}
    kw = dict(device=dev)
    baseline_rows(summary, args.duration, residual_fn, **kw)
    tuner_rows(summary, args.duration, **kw)
    population_rows(summary, **kw)
    comparison_rows(summary, **kw)
    online_rows(summary, args.duration, **kw)
    mismatched_rows(summary, args.duration, **kw)
    fused_online_rows(summary, args.duration, **kw)
    noisy_rows(summary, args.duration, **kw)
    gusty_rows(summary, args.duration, **kw)

    payload = {
        "ours": summary,
        "reference_baselines": REFERENCE_BASELINES,
        "note": note(args.duration),
    }
    os.makedirs(ARTIFACTS, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=2)
    _write_row_log(dev, merge=False)
    print("wrote", out_path)
    gates(summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
