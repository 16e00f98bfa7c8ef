"""The experiment campaign (``tools_torch/run_campaign.py``) against the JAX
package's campaign (``tools/run_campaign.py``) on the CPU.

Section parity: rows of the port's sections, flown at short lengths
(48-96 ticks) with ``device="cpu"`` (every kernel's plain version), against
the same rows built from the JAX package's functions with the JAX tool's
configurations (its Pallas kernels in interpret mode):

- the staged ``mpc_flight_figure8`` and ``gpmpc_flight_figure8`` (the same
  seeded corpus on both sides; the port fits it in float64 on the CPU, the
  JAX tool in float32), ``pid_flight_circle`` and the mismatched
  ``mpc_perturbed_figure8``: the port flies them through K3's and K1's/K2's
  plain versions, the JAX tool through its staged solve and plant;
- ``gpmpc_online_fresh_windy_figure8`` (K5's route, 96 ticks: the refit
  at tick 64 flies for 32 ticks);
- ``mpc_oracle_residual_windy_figure8`` (K4's route);
- ``mpc_dob_gusty_fused_figure8`` (K9's route, the observer and the gust),
  both packages flying the JAX package's own sensor draws (``noise=``).

Bars: position gap <= 1e-4 m at every tick and the rows' ``rms_pos``
within the same 1e-4 m (``test_torch_flight.py``'s and
``test_torch_noisy_flight.py``'s bar for the float32 flights; the staged
flights agree to ~1e-6 m, ``test_torch_cli_flights.py``).

Schema: ``main`` at ``--duration 1`` with the window constants shortened
writes exactly the 29 rows and per-row metric keys of the JAX tool's
``artifacts/metrics_summary.json`` (read only), its reference baselines,
the JAX tool's note for 1 s, a log for each row the JAX tool saves and
``kernel_launches.json`` (each row's seconds and launches: none on the CPU).
``--only-gusty`` merges into an existing summary. A ``--gp-data`` glob
that yields no usable rows exits 1 before any flight (F18), and the
default device without a GPU raises. The JAX tool itself is never
imported (it turns on a compilation cache in the repository): its note and
baselines are read from its source.
"""

import ast
import contextlib
import glob
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.estimation import EKFConfig as JEKFCfg
from unmanned_aerial_vehicles_tpu.estimation import noisy_mpc_flight_rollout as j_noisy
from unmanned_aerial_vehicles_tpu.gp import build_horizon_residuals as j_residuals
from unmanned_aerial_vehicles_tpu.gp import fit_residual_gp as j_fit
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig as JGPCfg
from unmanned_aerial_vehicles_tpu.io import load_gp_datasets as j_load
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig as JLoopCfg,
    OnlineFusedGPConfig as JOnline,
    mpc_flight_rollout as j_mpc,
    pid_flight_rollout as j_pid,
)
from unmanned_aerial_vehicles_tpu.models import PID_CAMPAIGN_RATE_LOOP as J_PID_RATE_LOOP
from unmanned_aerial_vehicles_tpu.models import RigidBodyParams as JBody
from unmanned_aerial_vehicles_tpu.trajectories import (
    ramped_circle_reference as j_circle_ref,
    ramped_figure8_reference as j_fig8_ref,
)
from unmanned_aerial_vehicles_tpu_torch.io import save_gp_dataset

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GAP_M = 1e-4
STAGED_S, FUSED_S, ONLINE_S = 0.96, 0.96, 1.92     # 48, 48 and 96 ticks


def _load_campaign():
    spec = importlib.util.spec_from_file_location(
        "torch_run_campaign", REPO / "tools_torch" / "run_campaign.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


campaign = _load_campaign()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A seeded corpus in the reference's CSV layout (two flights)."""
    d = tmp_path_factory.mktemp("campaign_corpus")
    rng = np.random.default_rng(2026)
    for k in range(2):
        X = rng.normal(size=(150, 10))
        X[:, 2] += 3.0
        Y = 0.05 * rng.normal(size=(150, 6)) + 0.02 * X[:, 3:9]
        save_gp_dataset(str(d / f"flight_{k}.csv"), X, Y)
    return str(d / "*.csv")


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    """The campaign's output directory in ``tmp_path``, its plots off."""
    out = tmp_path / "artifacts_torch"
    monkeypatch.setattr(campaign, "ARTIFACTS", str(out))
    monkeypatch.setattr(campaign, "_plot_flight", lambda *a: None)
    monkeypatch.setattr(campaign, "_plot_comparison", lambda *a: None)
    return out


# ---------------------------------------------------------------------------
# the JAX tool's rows, built from the JAX package's functions
# ---------------------------------------------------------------------------


def j_fig8(t):
    pos, yaw = j_fig8_ref(t, amplitude=6.0)
    return pos + jnp.asarray([0.0, 0.0, 3.0], pos.dtype), yaw


def j_circle(t):
    pos, _, yaw = j_circle_ref(t, amplitude=6.0, height=3.0)
    return pos, yaw


J_WINDY = JBody(wind=(1.5, 0.8, 0.0))


def j_fused_mpc():
    return JMPC(JCfg(horizon=20, admm_iterations=60, use_fused_controller=True), dtype=jnp.float32)


def j_oracle_residual(Xg, Ug):
    kd = J_WINDY.k_drag_linear / J_WINDY.mass
    wvec = jnp.asarray(J_WINDY.wind[:3], jnp.float32)
    n_st = Ug.shape[0]
    v = Xg[:n_st, 3:6]
    av = v - wvec[None, :]
    a_res = -kd * (jnp.linalg.norm(av, axis=1, keepdims=True) * av
                   - jnp.linalg.norm(v, axis=1, keepdims=True) * v)
    return jnp.zeros((n_st, 6), jnp.float32).at[:, 3:6].set(a_res)


def j_draws(T, seed=2):
    """The JAX fused noisy tiers' float32 sensor draws for PRNGKey(seed)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), T)
    return np.array(jax.vmap(lambda k: jax.random.normal(k, (9,), jnp.float32))(keys))


def j_host(outs):
    return {k: np.asarray(v) for k, v in outs.items()}


@pytest.fixture(scope="module")
def jax_staged(corpus):
    """The JAX tool's staged rows at STAGED_S (tools/run_campaign.py:279-305,
    :420-430, :434-441)."""
    T = int(STAGED_S / 0.02)
    cfg = JLoopCfg()
    gp_cfg = JGPCfg()
    X, Y = j_load(sorted(glob.glob(corpus)), max_samples=gp_cfg.max_data_points)
    post = j_fit(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), gp_cfg)
    residual_fn = lambda Xg, Ug: j_residuals(post, Xg, Ug, gp_cfg)
    mpc = JMPC(JCfg())
    perturbed = JBody(mass=0.55, k_drag_linear=0.375, wind=(1.0, 0.5, 0.0))
    runs = {
        "mpc_flight_figure8": lambda: j_mpc(mpc, j_fig8, T, cfg=cfg),
        "gpmpc_flight_figure8": lambda: j_mpc(mpc, j_fig8, T, cfg=cfg, residual_fn=residual_fn),
        "pid_flight_circle": lambda: j_pid(j_circle, T, cfg=cfg, rate_loop=J_PID_RATE_LOOP),
        "mpc_perturbed_figure8": lambda: j_mpc(mpc, j_fig8, T, body=perturbed, cfg=cfg,
                                               preview=True),
    }
    return {name: j_host(jax.jit(fn)()) for name, fn in runs.items()}


def assert_row_agrees(name, got_outs, got_row, want_outs):
    got_pos, want_pos = got_outs["state"][:, 0:3], want_outs["state"][:, 0:3]
    assert got_pos.shape == want_pos.shape, name
    assert np.all(np.isfinite(got_pos)), name
    gap = float(np.max(np.abs(got_pos - want_pos)))
    assert gap <= GAP_M, (name, gap)
    e = np.linalg.norm(want_outs["pos_ref"] - want_pos, axis=1)
    want_rms = float(np.sqrt((e**2).mean()))
    assert abs(got_row["rms_pos"] - want_rms) <= GAP_M, (name, got_row["rms_pos"], want_rms)


@pytest.mark.parametrize("name", ["mpc_flight_figure8", "gpmpc_flight_figure8",
                                  "pid_flight_circle", "mpc_perturbed_figure8"])
def test_staged_rows_match_jax(name, corpus, jax_staged, artifacts):
    summary = {}
    if name == "mpc_perturbed_figure8":
        got = campaign.mismatched_rows(summary, STAGED_S, device="cpu", rows=(name,))
    else:
        X, Y = campaign.load_corpus(corpus)
        residual_fn = campaign.fit_corpus_gp(X, Y, device="cpu")
        got = campaign.baseline_rows(summary, STAGED_S, residual_fn, device="cpu", rows=(name,))
    assert list(got) == list(summary) == [name]
    assert_row_agrees(name, got[name], summary[name], jax_staged[name])
    assert (artifacts / f"{name}.npz").exists()


def test_fresh_online_row_matches_jax(artifacts):
    """K5's route with a refit every 64 ticks of a 128-point ring."""
    name = "gpmpc_online_fresh_windy_figure8"
    T = int(ONLINE_S / 0.02)
    ogp = JOnline(gp=JGPCfg(max_data_points=128, residual_gain=1.0), refit_every=64)
    want = j_host(jax.jit(lambda: j_mpc(
        j_fused_mpc(), j_fig8, T, body=J_WINDY,
        cfg=JLoopCfg(use_fused_tick=True, ticks_per_dispatch=8), preview=True,
        online_gp=ogp, gp_gain=1.0))())
    summary = {}
    got = campaign.fused_online_rows(summary, ONLINE_S, device="cpu", rows=(name,))
    assert_row_agrees(name, got[name], summary[name], want)
    assert summary[name]["gp_samples_collected"] == int(want["gp_count"][-1])


def test_oracle_row_matches_jax(artifacts):
    """K4's route: one tick a launch, the exact windy residual as ``residual_fn``."""
    name = "mpc_oracle_residual_windy_figure8"
    T = int(FUSED_S / 0.02)
    want = j_host(jax.jit(lambda: j_mpc(
        j_fused_mpc(), j_fig8, T, body=J_WINDY, cfg=JLoopCfg(use_fused_tick=True),
        preview=True, residual_fn=j_oracle_residual))())
    summary = {}
    got = campaign.fused_online_rows(summary, FUSED_S, device="cpu", rows=(name,))
    assert_row_agrees(name, got[name], summary[name], want)
    assert set(summary[name]) == {"rms_pos", "rms_pos_tail", "max_pos"}
    assert not (artifacts / f"{name}.npz").exists()      # the JAX tool saves no log for it


def test_fused_observer_row_matches_jax(artifacts, monkeypatch):
    """K9's route: the observer and the gust inside the multi-tick kernel,
    on the JAX package's own draws."""
    name = "mpc_dob_gusty_fused_figure8"
    T = int(FUSED_S / 0.02)
    monkeypatch.setattr(campaign, "GUST_SETTLE_S", 0.1)
    t_gust = FUSED_S / 2.0
    w_pre, w_post = jnp.asarray(J_WINDY.wind[:3], jnp.float32), jnp.asarray([-1.0, 1.5, 0.0],
                                                                           jnp.float32)
    want = j_host(jax.jit(lambda: j_noisy(
        j_fused_mpc(), j_fig8, T, jax.random.PRNGKey(2), ekf_cfg=JEKFCfg(), body=J_WINDY,
        cfg=JLoopCfg(use_fused_tick=True, ticks_per_dispatch=8), preview=True,
        disturbance_observer=True, wind_fn=lambda t: jnp.where(t < t_gust, w_pre, w_post),
        gp_gain=0.1))())
    summary = {}
    got = campaign.gusty_rows(summary, FUSED_S, device="cpu", rows=(name,),
                              noise=torch.from_numpy(j_draws(T)))
    assert_row_agrees(name, got[name], summary[name], want)
    i_post = int((t_gust + 0.1) / 0.02)
    np.testing.assert_allclose(summary[name]["disturbance_est_postgust_mean"],
                               want["disturbance_est"][i_post:].mean(axis=0), rtol=0, atol=GAP_M)


# ---------------------------------------------------------------------------
# the summary's schema, --only-gusty, F18 and the device
# ---------------------------------------------------------------------------


def _jax_tool_source():
    return ast.parse((REPO / "tools" / "run_campaign.py").read_text())


def jax_tool_note(duration: float) -> str:
    """The JAX tool's ``_note``, compiled from its source alone."""
    fn = next(n for n in _jax_tool_source().body
              if isinstance(n, ast.FunctionDef) and n.name == "_note")
    ns = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "run_campaign.py", "exec"), ns)
    return ns["_note"](duration)


def jax_tool_baselines() -> dict:
    node = next(n for n in _jax_tool_source().body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "REFERENCE_BASELINES")
    return ast.literal_eval(node.value)


def shorten(monkeypatch):
    for name, value in (("TUNE_WINDOW_S", 1.0), ("TUNE_ITERATIONS", 1), ("TUNE_SETTLE_S", 0.2),
                        ("MC_WINDOW_S", 1.0), ("MC_ROLLOUTS", 4), ("MC_SETTLE_S", 0.2),
                        ("COMPARISON_S", 1.0), ("GUST_SETTLE_S", 0.2)):
        monkeypatch.setattr(campaign, name, value)


def test_main_writes_the_jax_tools_rows_and_keys(corpus, artifacts, monkeypatch, capsys):
    shorten(monkeypatch)
    assert campaign.main(["--device", "cpu", "--duration", "1", "--gp-data", corpus]) == 0
    text = capsys.readouterr().out
    payload = json.loads((artifacts / "metrics_summary.json").read_text())
    jax_payload = json.loads((REPO / "artifacts" / "metrics_summary.json").read_text())
    assert list(payload) == list(jax_payload) == ["ours", "reference_baselines", "note"]
    assert list(payload["ours"]) == list(jax_payload["ours"])
    assert len(payload["ours"]) == 29      # 5 flights, 3 populations, 4 comparisons, 17 rows
    for name, row in jax_payload["ours"].items():
        assert list(payload["ours"][name]) == list(row), name
        for key, value in payload["ours"][name].items():
            assert isinstance(value, str) or np.all(np.isfinite(value)), (name, key)
    assert payload["reference_baselines"] == jax_tool_baselines()
    assert payload["reference_baselines"] == jax_payload["reference_baselines"]
    assert payload["note"] == jax_tool_note(1.0)
    log = json.loads((artifacts / "kernel_launches.json").read_text())
    assert log["device"] == "cpu" and list(log["rows"]) == list(payload["ours"])
    assert all(r["launches"] == {} and r["seconds"] > 0 for r in log["rows"].values())
    saved = sorted(p.stem for p in artifacts.glob("*.npz"))
    assert saved == sorted(p.stem for p in (REPO / "artifacts").glob("*.npz"))
    for line in ("mpc_flight_figure8: ", "pid_flight_circle: ", "(post-gust)",
                 "mpc_dob_gusty_fused_figure8: "):
        assert line in text
    assert sum(s in text for s in (" BEATS ", " WORSE THAN ")) == 2
    assert " TIES staged " in text or " DIVERGES FROM staged " in text


def test_only_gusty_merges_into_the_summary(artifacts, monkeypatch, capsys):
    monkeypatch.setattr(campaign, "GUST_SETTLE_S", 0.2)
    artifacts.mkdir()
    kept = {"rms_pos": 1.25, "max_pos": 2.5}
    stale = {"rms_pos": -1.0, "rms_pos_postgust": -1.0, "max_pos": -1.0}
    (artifacts / "metrics_summary.json").write_text(json.dumps({
        "ours": {"mpc_flight_figure8": kept, "mpc_noisy_gusty_figure8": stale},
        "reference_baselines": {"x": 1}, "note": "old"}))
    assert campaign.main(["--device", "cpu", "--duration", "0.64", "--only-gusty"]) == 0
    text = capsys.readouterr().out
    payload = json.loads((artifacts / "metrics_summary.json").read_text())
    ours = payload["ours"]
    assert ours["mpc_flight_figure8"] == kept
    assert list(ours) == ["mpc_flight_figure8", "mpc_noisy_gusty_figure8",
                          "mpc_stale_oracle_gusty_figure8", "mpc_dob_noisy_gusty_figure8",
                          "mpc_dob_gusty_fused_figure8", "gpmpc_online_gusty_figure8"]
    assert ours["mpc_noisy_gusty_figure8"]["rms_pos"] > 0
    assert payload["reference_baselines"] == {"x": 1}
    assert payload["note"] == jax_tool_note(0.64)
    assert list(json.loads((artifacts / "kernel_launches.json").read_text())["rows"]) == list(ours)[1:]
    assert "(gusty rows merged)" in text
    assert " TIES staged " in text or " DIVERGES FROM staged " in text


@pytest.mark.parametrize("kind", ["no file", "no usable rows"])
def test_missing_corpus_exits_1_before_any_flight(kind, tmp_path, artifacts, monkeypatch, capsys):
    """F18: the JAX tool fits its GP on zero points and flies NaN residuals."""
    if kind == "no usable rows":
        (tmp_path / "flight_metrics.csv").write_text("rms,max\n1.0,2.0\n")
    pattern = str(tmp_path / "*.csv")
    flown = []
    monkeypatch.setattr(campaign, "baseline_rows", lambda *a, **k: flown.append(a))
    with pytest.warns(UserWarning) if kind == "no usable rows" else contextlib.nullcontext():
        rc = campaign.main(["--device", "cpu", "--gp-data", pattern])
    assert rc == 1
    err = capsys.readouterr().err
    assert pattern in err and "corpus is missing" in err
    assert not flown and not artifacts.exists()


def test_default_device_without_a_gpu_raises(corpus, artifacts):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        campaign.main(["--gp-data", corpus])
    assert not artifacts.exists()



def test_a_skipped_plot_is_said_once(tmp_path, monkeypatch, capsys):
    """Without matplotlib the logs are written and one line says the plots
    were skipped."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(campaign, "ARTIFACTS", str(tmp_path))
    monkeypatch.setattr(campaign, "_plots_skipped", [])
    o = {"state": np.zeros((4, 12), np.float32), "pos_ref": np.zeros((4, 3), np.float32)}
    for name in ("a", "b"):
        campaign._save(name, o)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a.npz", "b.npz"]
    assert capsys.readouterr().out.count("plots skipped: matplotlib is not installed") == 1
