"""Port parity for the GP model analysis (``gp/analysis.py``) against the
JAX package on the CPU, and the port's plots, animation, profiling helpers
and examples' scaling.

The analysis runs both packages on the same posterior (a JAX fit carried
across with ``convert``) and the same test points: every statistic within
1e-9 relative (float64 predictions, the same NumPy reductions). The plots
and the animation are drawn under matplotlib's Agg backend into the test's
temporary directory and must write their files; the timers and the trace
run on CPU tensors.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

from unmanned_aerial_vehicles_tpu.gp import GPParams as JParams, fit_gp as j_fit_gp  # noqa: E402
from unmanned_aerial_vehicles_tpu.gp.analysis import (  # noqa: E402
    analyze_gp_model as j_analyze,
    generate_generic_test_points as j_generic,
    generate_physical_test_points as j_physical,
)
from unmanned_aerial_vehicles_tpu.gp.exact_gp import predict as j_predict  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch import convert  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.gp import (  # noqa: E402
    analyze_gp_model,
    generate_generic_test_points,
    generate_physical_test_points,
    predict,
)
from unmanned_aerial_vehicles_tpu_torch.gp.analysis import run_complete_gp_analysis  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.metrics import (  # noqa: E402
    plot_comparison,
    plot_flight_log,
    plot_robustness,
)
from unmanned_aerial_vehicles_tpu_torch.metrics.animate import animate_flight  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.utils import (  # noqa: E402
    device_timeit,
    fast_examples,
    scaled,
    scan_slope_timeit,
    trace,
)

torch.set_num_threads(1)

REL = 1e-9


@pytest.fixture(scope="module")
def posteriors():
    """A JAX GP fitted on seeded residual-like data, and the port's copy."""
    rng = np.random.default_rng(5)
    X = j_physical(200, seed=1)
    Y = np.column_stack([0.05 * np.tanh(X[:, 3 + k]) for k in range(6)])
    Y = Y + 0.01 * rng.normal(size=Y.shape)
    jpost = j_fit_gp(JParams.create(2.0, 0.5, 0.01), jnp.asarray(X), jnp.asarray(Y),
                     jitter=1e-4, normalize_y=True)
    a = lambda v: np.asarray(v)
    post = convert.gp_posterior_from_numpy(
        a(jpost.X_train), a(jpost.chol), a(jpost.alpha), a(jpost.y_mean), a(jpost.y_std),
        a(jpost.params.length_scale), a(jpost.params.signal_variance),
        a(jpost.params.noise_variance), device="cpu")
    return jpost, post


def _close(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)) and all(isinstance(v, str) for v in want):
        assert list(got) == list(want), what
    elif isinstance(want, (list, tuple, np.ndarray)):
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=REL, atol=REL, err_msg=what)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=REL, abs=REL), what
    else:
        assert got == want, what


def test_test_points_equal_jax():
    np.testing.assert_array_equal(generate_physical_test_points(700, 3), j_physical(700, 3))
    np.testing.assert_array_equal(generate_generic_test_points(4, 50, 9), j_generic(4, 50, 9))
    assert generate_physical_test_points(100).shape == (400, 10)


def test_analysis_matches_jax(posteriors):
    jpost, post = posteriors
    points = generate_physical_test_points(500, seed=2)
    got = analyze_gp_model(lambda X: predict(post, torch.from_numpy(X)), points)
    want = j_analyze(lambda X: j_predict(jpost, jnp.asarray(X)), points)
    for raw in ("_mean", "_std", "_X"):
        np.testing.assert_allclose(got.pop(raw), want.pop(raw), rtol=REL, atol=REL, err_msg=raw)
    _close(got, want, "report")
    assert set(got["uncertainty_stats"]["per_regime"]) == {"envelope", "hover", "trajectory"}


def test_complete_analysis_writes_the_three_figures(posteriors, tmp_path):
    _, post = posteriors
    prefix = str(tmp_path / "gp")
    report = run_complete_gp_analysis(lambda X: predict(post, torch.from_numpy(X)), prefix,
                                      generate_physical_test_points(300, seed=4))
    json.dumps(report)
    for suffix in ("distributions", "uncertainty", "correlations"):
        assert (tmp_path / f"gp_{suffix}.png").stat().st_size > 0


def _flight_log(T=60):
    t = np.arange(T) * 0.02
    state = np.zeros((T, 12))
    state[:, 0], state[:, 1], state[:, 2] = np.sin(t), np.cos(t), 3 + 0.1 * t
    state[:, 3:6] = 0.1
    return {"state": state, "pos_ref": state[:, 0:3] + 0.05, "vel_ref": state[:, 3:6],
            "att_ref": np.zeros((T, 3)), "thrust": np.linspace(0.05, 1.0, T),
            "u_mpc": np.ones((T, 4)), "rates_cmd": np.zeros((T, 3))}


def test_plots_write_their_files(tmp_path):
    log = _flight_log()
    assert plot_flight_log(log, str(tmp_path / "log.png"), "test") == str(tmp_path / "log.png")
    T = 40
    outs = {"pid_error": np.linspace(0, 1, T), "mpc_error": np.linspace(0, 0.5, T),
            "ref_pos": np.zeros((T, 3)), "pid_pos": np.ones((T, 3)), "mpc_pos": np.ones((T, 3)),
            "pid_control": np.ones((T, 4)), "mpc_control": np.ones((T, 4))}
    plot_comparison(outs, str(tmp_path / "cmp.png"), "circle")
    rms = np.linspace(0.1, 1.0, 32)
    stats = {"rms_pos": rms, "max_pos": 2 * rms, "success": rms < 0.9, "rms_p50": 0.5,
             "rms_p90": 0.9, "rms_p99": 0.99, "success_rate": 0.9, "rms_mean": 0.55,
             "worst_max_pos": 2.0}
    plot_robustness(stats, str(tmp_path / "mc.png"))
    for name in ("log.png", "cmp.png", "mc.png"):
        assert (tmp_path / name).stat().st_size > 0


def test_animation_writes_a_gif(tmp_path):
    path = animate_flight(_flight_log(30), str(tmp_path / "flight.gif"), stride=10)
    assert path.endswith(".gif") and (tmp_path / "flight.gif").stat().st_size > 0
    with pytest.raises(ValueError, match="at least 2 ticks"):
        animate_flight({"state": np.zeros((1, 12)), "pos_ref": np.zeros((1, 3))},
                       str(tmp_path / "x.gif"))


def test_timers_and_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64, dtype=torch.float64, generator=torch.Generator().manual_seed(0)) / 8
    best = device_timeit(lambda a: a @ a, x, reps=2)
    assert 0.0 < best < 5.0
    seen = []
    t = device_timeit(lambda a: a + 1, x, reps=3, perturb=lambda rep, args: seen.append(rep) or args)
    assert t > 0.0 and seen == [0, 1, 2]

    def make_fn(T):
        def run(a):
            for _ in range(T):
                a = a @ x
            return {"out": (a,)}
        return run

    slope = scan_slope_timeit(make_fn, 2, 200, x, reps=2)
    assert set(slope) == {"per_iter_s", "fixed_overhead_s", "t_short_s", "t_long_s"}
    assert slope["t_long_s"] > slope["t_short_s"] > 0.0
    with trace(str(tmp_path / "prof")) as log_dir:
        (x @ x).sum()
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert log_dir == str(tmp_path / "prof")


def test_examples_scaling(monkeypatch):
    monkeypatch.delenv("UAV_FAST_EXAMPLES", raising=False)
    assert not fast_examples() and scaled(100, 5) == 100
    monkeypatch.setenv("UAV_FAST_EXAMPLES", "1")
    assert fast_examples() and scaled(100, 5) == 5
