"""Plotting utilities for flight logs and controller comparisons (port of
``metrics/plots.py``).

The reference's matplotlib surfaces — the 12-panel rosbag analysis
(``src/px4/enhanced_plot_mpc_bag.py:863+``), the 8-panel PID-vs-MPC
comparison (``quadrotor_gp_mpc/main.py:629-763``) and the GP and MPC metric
plots (``performance_metrics.py:137-447``) — drawn from the stacked arrays
of rollouts or saved flight logs. NumPy arrays in (tensors on the CPU
convert through ``np.asarray``). matplotlib with the Agg backend, imported
only inside the functions: importing this module does not need it.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_flight_log(log: dict, save_path: str, title: str = "flight",
                    dt: float = 0.02):
    """12-panel flight analysis — the full ``enhanced_plot_mpc_bag`` layout
    (``create_analysis_plots`` panels at :863-990 plus the attitude/rate
    channels its monitoring topics carry and the ``plot_metrics_summary``
    card at :727-765, all in one figure):

    XY tracking / altitude / position errors / velocity tracking /
    XY trajectory / control outputs / attitude tracking / attitude errors /
    body rates vs commands / thrust + saturation bands / error histogram /
    metrics summary card.

    Optional log keys (``att_ref``, ``vel_ref``, ``rates_cmd``, ``u_mpc``,
    ``accel_cmd``, ``thrust``) populate their panels when present."""
    plt = _plt()
    state = np.asarray(log["state"])
    pos_ref = np.asarray(log["pos_ref"])
    T = state.shape[0]
    t = np.arange(T) * dt

    fig, axes = plt.subplots(4, 3, figsize=(19, 16))
    fig.suptitle(f"Flight Analysis — {title}")

    # 1. Position XY tracking (:882-895)
    ax = axes[0, 0]
    ax.plot(t, pos_ref[:, 0], "b-", label="X setpoint")
    ax.plot(t, state[:, 0], "r--", label="X actual")
    ax.plot(t, pos_ref[:, 1], "g-", label="Y setpoint")
    ax.plot(t, state[:, 1], "m--", label="Y actual")
    ax.set_title("Position XY Tracking")
    ax.set_xlabel("Time [s]")
    ax.legend(fontsize=7)

    # 2. Altitude tracking (:898-910)
    ax = axes[0, 1]
    ax.plot(t, pos_ref[:, 2], "b-", label="Z setpoint")
    ax.plot(t, state[:, 2], "r--", label="Z actual")
    ax.set_title("Altitude Tracking")
    ax.legend(fontsize=7)

    # 3. Position errors (:913-926)
    err_vec = pos_ref - state[:, 0:3]
    err = np.linalg.norm(err_vec, axis=1)
    ax = axes[0, 2]
    ax.plot(t, err, "r-", lw=2, label="‖pos error‖")
    for i, (name, style) in enumerate(zip("XYZ", ["b--", "g--", "m--"])):
        ax.plot(t, np.abs(err_vec[:, i]), style, lw=0.8, label=f"|{name} error|")
    ax.set_title("Position Errors")
    ax.legend(fontsize=7)

    # 4. Velocity tracking (:929-945): speed setpoint vs actual + vz
    ax = axes[1, 0]
    if "vel_ref" in log:
        vr = np.asarray(log["vel_ref"])
        ax.plot(t, np.linalg.norm(vr[:, 0:2], axis=1), "b-", label="speed setpoint")
        ax.plot(t, vr[:, 2], "g:", label="Vz setpoint")
    ax.plot(t, np.linalg.norm(state[:, 3:5], axis=1), "r--", label="speed actual")
    ax.plot(t, state[:, 5], "k:", label="Vz actual")
    ax.set_title("Velocity Tracking")
    ax.legend(fontsize=7)

    # 5. XY trajectory (:948-960)
    ax = axes[1, 1]
    ax.plot(pos_ref[:, 0], pos_ref[:, 1], "b-", label="setpoint trajectory")
    ax.plot(state[:, 0], state[:, 1], "r--", label="actual trajectory")
    ax.set_title("XY Trajectory")
    ax.axis("equal")
    ax.legend(fontsize=7)

    # 6. Control outputs (:963-976)
    ax = axes[1, 2]
    ctrl = None
    for key in ("u_mpc", "accel_cmd"):
        if key in log:
            ctrl = np.asarray(log[key])
            break
    if ctrl is not None:
        for i in range(min(4, ctrl.shape[1])):
            ax.plot(t, ctrl[:, i], label=f"Output {i + 1}")
        ax.legend(fontsize=7)
    ax.set_title("Control Outputs")

    # 7. Attitude tracking
    ax = axes[2, 0]
    att = np.degrees(state[:, 6:9])
    if "att_ref" in log:
        ar = np.degrees(np.asarray(log["att_ref"]))
        ax.plot(t, ar[:, 0], "b-", label="roll sp")
        ax.plot(t, ar[:, 1], "g-", label="pitch sp")
    ax.plot(t, att[:, 0], "r--", label="roll")
    ax.plot(t, att[:, 1], "m--", label="pitch")
    ax.plot(t, att[:, 2], "k:", label="yaw")
    ax.set_title("Attitude Tracking [deg]")
    ax.legend(fontsize=7)

    # 8. Attitude errors (metric def :699-720)
    ax = axes[2, 1]
    if "att_ref" in log:
        ae = np.degrees(np.asarray(log["att_ref"])) - att
        rmse = np.sqrt((ae**2).mean(axis=0))
        for i, name in enumerate(["roll", "pitch", "yaw"]):
            ax.plot(t, ae[:, i], label=f"{name} (RMSE {rmse[i]:.2f}°)")
        ax.legend(fontsize=7)
    ax.set_title("Attitude Errors [deg]")

    # 9. Body rates vs commands
    ax = axes[2, 2]
    for i, name in enumerate("pqr"):
        ax.plot(t, state[:, 9 + i], label=name)
    if "rates_cmd" in log:
        rc = np.asarray(log["rates_cmd"])
        for i, name in enumerate("pqr"):
            ax.plot(t, rc[:, i], "--", lw=0.7, label=f"{name} cmd")
    ax.set_title("Body Rates [rad/s]")
    ax.legend(fontsize=6, ncol=2)

    # 10. Thrust + saturation bands (:683-695 thresholds)
    ax = axes[3, 0]
    sat_line = ""
    if "thrust" in log:
        thrust = np.asarray(log["thrust"])
        ax.plot(t, thrust, "r-")
        ax.axhline(0.99, color="k", ls="--", lw=0.7)
        ax.axhline(0.11, color="k", ls="--", lw=0.7)
        sat = 100.0 * np.mean((thrust >= 0.99) | (thrust <= 0.11))
        near_hover = np.abs(thrust - 1.0) <= 0.05
        sat_inf = 100.0 * np.mean(
            ((thrust >= 0.99) | (thrust <= 0.11)) & ~near_hover
        )
        sat_line = (f"Thrust saturation: {sat:.1f} % (quirk) / "
                    f"{sat_inf:.1f} % (non-hover)")
        ax.set_title(f"Normalized Thrust — {sat_line}", fontsize=9)
    else:
        ax.set_title("Normalized Thrust")

    # 11. Error histogram
    ax = axes[3, 1]
    ax.hist(err, bins=40, color="tab:red", alpha=0.8)
    ax.set_title("Position-Error Distribution [m]")

    # 12. Metrics summary card (plot_metrics_summary, :727-765)
    ax = axes[3, 2]
    ax.axis("off")
    lines = [
        f"RMS position error: {np.sqrt((err**2).mean()):.3f} m",
        f"Max position error: {err.max():.3f} m",
    ]
    if "vel_ref" in log:
        sp = np.linalg.norm(np.asarray(log["vel_ref"]), axis=1)
        act = np.linalg.norm(state[:, 3:6], axis=1)
        lines.append(f"RMS velocity error: {np.sqrt(((sp - act) ** 2).mean()):.3f} m/s")
    if "att_ref" in log:
        ae = np.degrees(np.asarray(log["att_ref"])) - att
        rmse = np.sqrt((ae**2).mean(axis=0))
        lines += [f"RMS roll error:  {rmse[0]:.2f} deg",
                  f"RMS pitch error: {rmse[1]:.2f} deg",
                  f"RMS yaw error:   {rmse[2]:.2f} deg"]
    if sat_line:
        lines.append(sat_line)
    ax.text(0.0, 0.95, "Metrics Summary", fontsize=13, fontweight="bold",
            va="top", family="monospace")
    ax.text(0.0, 0.80, "\n".join(lines), fontsize=10, va="top",
            family="monospace")

    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
    return save_path


def plot_comparison(outs: dict, save_path: str, traj_type: str = ""):
    """PID-vs-GP-MPC comparison panels (``main.py:629-763``): trajectories,
    tracking errors, error statistics, control signals."""
    plt = _plt()
    t = np.arange(np.asarray(outs["pid_error"]).shape[0])

    fig, axes = plt.subplots(2, 2, figsize=(14, 9))
    fig.suptitle(f"Cascade PID vs GP-MPC — {traj_type}")

    ax = axes[0, 0]
    ref = np.asarray(outs["ref_pos"])
    ax.plot(ref[:, 0], ref[:, 1], "k--", label="reference")
    ax.plot(np.asarray(outs["pid_pos"])[:, 0], np.asarray(outs["pid_pos"])[:, 1],
            label="PID")
    ax.plot(np.asarray(outs["mpc_pos"])[:, 0], np.asarray(outs["mpc_pos"])[:, 1],
            label="GP-MPC")
    ax.set_title("XY trajectories")
    ax.legend()
    ax.axis("equal")

    pid_e = np.asarray(outs["pid_error"])
    mpc_e = np.asarray(outs["mpc_error"])
    axes[0, 1].plot(t, pid_e, label="PID")
    axes[0, 1].plot(t, mpc_e, label="GP-MPC")
    axes[0, 1].set_title("tracking error [m]")
    axes[0, 1].legend()

    axes[1, 0].bar(
        ["PID avg", "PID rms", "MPC avg", "MPC rms"],
        [pid_e.mean(), np.sqrt((pid_e**2).mean()),
         mpc_e.mean(), np.sqrt((mpc_e**2).mean())],
    )
    axes[1, 0].set_title("error statistics [m]")

    axes[1, 1].plot(t, np.asarray(outs["pid_control"])[:, 0], label="PID thrust")
    axes[1, 1].plot(t, np.asarray(outs["mpc_control"])[:, 0], label="MPC thrust")
    axes[1, 1].set_title("thrust command")
    axes[1, 1].legend()

    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
    return save_path


def plot_robustness(stats: dict, save_path: str, title: str = "Monte-Carlo"):
    """Dispersion figure for a ``loop.monte_carlo`` study (no reference
    counterpart — its campaigns evaluate one nominal plant per run).

    Panels: per-rollout RMS histogram with p50/p90/p99 markers /
    RMS-vs-worst-excursion scatter (crashes highlighted) / summary card.
    """
    plt = _plt()
    rms = np.asarray(stats["rms_pos"], np.float64)
    max_pos = np.asarray(stats["max_pos"], np.float64)
    success = np.asarray(stats["success"], bool)

    fig, axes = plt.subplots(1, 3, figsize=(15, 4.2))
    fig.suptitle(f"{title} — {rms.size} rollouts")

    ok = success & np.isfinite(rms)
    ax = axes[0]
    if ok.any():
        ax.hist(rms[ok], bins=min(40, max(8, ok.sum() // 8)),
                color="tab:blue", alpha=0.8)
        for key, style in (("rms_p50", "-"), ("rms_p90", "--"),
                           ("rms_p99", ":")):
            v = float(np.asarray(stats[key]))
            if np.isfinite(v):
                ax.axvline(v, color="tab:red", linestyle=style,
                           label=f"{key[4:]} = {v:.3f} m")
        ax.legend(fontsize=8)
    ax.set_xlabel("RMS position error [m]")
    ax.set_ylabel("rollouts")
    ax.set_title("tracking dispersion (successes)")

    ax = axes[1]
    finite = np.isfinite(rms) & np.isfinite(max_pos)
    ax.scatter(rms[finite & success], max_pos[finite & success], s=10,
               color="tab:blue", alpha=0.6, label="success")
    crashed = finite & ~success
    if crashed.any():
        ax.scatter(rms[crashed], max_pos[crashed], s=18, color="tab:red",
                   marker="x", label="crashed")
        ax.legend(fontsize=8)
    ax.set_xlabel("RMS position error [m]")
    ax.set_ylabel("max excursion [m]")
    ax.set_title("RMS vs worst excursion")

    ax = axes[2]
    ax.axis("off")
    lines = [f"success rate: {float(np.asarray(stats['success_rate'])) * 100:.1f} %"]
    for key in ("rms_mean", "rms_p50", "rms_p90", "rms_p99",
                "worst_max_pos"):
        v = float(np.asarray(stats[key]))
        lines.append(f"{key}: {v:.3f} m" if np.isfinite(v)
                     else f"{key}: n/a")
    ax.text(0.05, 0.9, "\n".join(lines), va="top", family="monospace",
            fontsize=11)
    ax.set_title("summary")

    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


# ---------------------------------------------------------------------------
# GP model analysis figures (the reference's GPModelEvaluator plot surfaces,
# the reference's src/px4/gp_evaluation.py:335-500)
# ---------------------------------------------------------------------------


def plot_gp_prediction_distributions(mean, std, save_path: str,
                                     output_names=None):
    """Per-output histograms of predicted mean and std
    (``gp_evaluation.py:335-396``): overlaid densities with the mu/sigma
    stat box. ``mean``/``std``: (n, out)."""
    plt = _plt()
    mean = np.asarray(mean)
    std = np.asarray(std)
    n_out = mean.shape[1]
    if output_names is None:
        output_names = [f"out{j}" for j in range(n_out)]
    cols = min(3, n_out)
    rows = int(np.ceil(n_out / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(6 * cols, 4 * rows))
    axes = np.atleast_1d(axes).ravel()
    for j in range(n_out):
        ax = axes[j]
        ax.hist(mean[:, j], bins=50, alpha=0.7, label="predicted mean",
                color="skyblue", density=True)
        ax.hist(std[:, j], bins=50, alpha=0.7, label="predicted std",
                color="orange", density=True)
        ax.set_title(f"{output_names[j]} predictions")
        ax.set_xlabel("value")
        ax.set_ylabel("density")
        ax.legend(fontsize=8)
        ax.grid(True, alpha=0.3)
        ax.text(0.02, 0.98,
                f"mu={mean[:, j].mean():.4f}\nsigma={std[:, j].mean():.4f}",
                transform=ax.transAxes, va="top",
                bbox=dict(boxstyle="round", facecolor="white", alpha=0.8))
    for j in range(n_out, len(axes)):
        axes[j].set_visible(False)
    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


def plot_gp_uncertainty_analysis(X, std, save_path: str):
    """2x2 uncertainty-vs-state panel (``gp_evaluation.py:398-473``):
    average predictive std against velocity magnitude, acceleration
    magnitude and altitude, plus the std histogram. ``X``: (n, >=9) rows in
    the flight-input layout [x,y,z,vx,vy,vz,ax,ay,az,...]."""
    plt = _plt()
    X = np.asarray(X)
    avg_std = np.asarray(std).mean(axis=1)
    vel = np.linalg.norm(X[:, 3:6], axis=1)
    acc = np.linalg.norm(X[:, 6:9], axis=1)
    alt = X[:, 2]

    fig, axes = plt.subplots(2, 2, figsize=(12, 9))
    for ax, (xv, name) in zip(
        axes.ravel()[:3],
        [(vel, "velocity magnitude [m/s]"),
         (acc, "acceleration magnitude [m/s^2]"),
         (alt, "altitude z [m]")],
    ):
        ax.scatter(xv, avg_std, alpha=0.5, s=12)
        ax.set_xlabel(name)
        ax.set_ylabel("average predictive std")
        ax.set_title(f"uncertainty vs {name.split(' [')[0]}")
        ax.grid(True, alpha=0.3)
    ax = axes.ravel()[3]
    ax.hist(avg_std, bins=50, alpha=0.7, color="green")
    ax.set_xlabel("average predictive std")
    ax.set_ylabel("count")
    ax.set_title("uncertainty distribution")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


def plot_gp_output_correlations(corr, save_path: str, output_names=None):
    """Output-output correlation heatmap of the predicted residual means
    (``gp_evaluation.py:476-500``)."""
    plt = _plt()
    corr = np.asarray(corr)
    n = corr.shape[0]
    if output_names is None:
        output_names = [f"out{j}" for j in range(n)]
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(corr, cmap="RdBu_r", vmin=-1.0, vmax=1.0)
    ax.set_xticks(range(n), output_names, rotation=45, ha="right")
    ax.set_yticks(range(n), output_names)
    for i in range(n):
        for j in range(n):
            ax.text(j, i, f"{corr[i, j]:.2f}", ha="center", va="center",
                    fontsize=8,
                    color="white" if abs(corr[i, j]) > 0.6 else "black")
    fig.colorbar(im, ax=ax, shrink=0.85)
    ax.set_title("residual correlations between outputs")
    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
