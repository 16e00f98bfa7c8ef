"""The GP, analysis and tuning commands of both command lines on the CPU.

- ``train-gp`` (200 samples, and ``--all-samples``) on seeded CSVs written
  here: each package's checkpoint, loaded by both packages, predicts
  within 1e-10 of every other load in float64 (a checkpoint holds the
  training set and hyperparameters; loading refits the Cholesky factor),
  and the dense trainer writes the ``gp_model_latest.npz`` symlink.
- ``evaluate-gp`` (also ``--full-analysis`` under Agg): the JSON of both
  within 1e-8 relative.
- ``analyze`` of a log the port wrote (npz and ``.uavlog``) against the JAX
  package's ``analyze`` of the same file, and the port's ``--plot`` and
  ``--animate``.
- ``tune pid`` and ``tune mpc`` (2 iterations): the initial loss within
  1e-5 relative and the final within 1e-3 (``tests/test_torch_tuning.py``'s
  bars), the RMS before and after within 5e-4 m.

Every port call passes ``--device cpu``.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.cli import main as jax_main
from unmanned_aerial_vehicles_tpu.gp import predict_mean as j_predict_mean
from unmanned_aerial_vehicles_tpu.io import load_gp_checkpoint as j_load
from unmanned_aerial_vehicles_tpu_torch.cli import main as port_main
from unmanned_aerial_vehicles_tpu_torch.gp import predict_mean
from unmanned_aerial_vehicles_tpu_torch.io import load_gp_checkpoint, save_gp_dataset

torch.set_num_threads(1)

PREDICT_TOL = 1e-10
EVAL_RTOL = 1e-8
LOSS_INITIAL_RTOL, LOSS_FINAL_RTOL, RMS_TOL_M = 1e-5, 1e-3, 5e-4


def cli(main, argv):
    """``main(argv)``'s exit code 0, and every JSON object it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    assert rc == 0, out
    decoder, objs, i = json.JSONDecoder(), [], out.find("{")
    while i >= 0:
        obj, end = decoder.raw_decode(out, i)
        objs.append(obj)
        i = out.find("{", end)
    return objs, out


def close(got, want, rtol, atol=1e-12, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            close(got[k], want[k], rtol, atol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, rtol, atol, f"{path}[{i}]")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert np.isclose(got, want, rtol=rtol, atol=atol), (path, got, want)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_gp")
    rng = np.random.default_rng(7)
    for k in range(2):
        X = rng.normal(size=(160, 10))
        X[:, 2] += 3.0
        Y = 0.05 * rng.normal(size=(160, 6)) + 0.03 * np.tanh(X[:, 3:9])
        save_gp_dataset(str(d / f"flight_{k}.csv"), X, Y)
    return d


@pytest.fixture(scope="module")
def checkpoints(corpus):
    """Each package's dense (200 samples) and full-corpus checkpoint."""
    out = {}
    for pkg, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        for kind, flags in (("dense", ["--max-samples", "200"]),
                            ("all", ["--all-samples", "--cg-iterations", "120"])):
            path = str(corpus / f"{pkg}_{kind}" / "gp.npz")
            os.makedirs(os.path.dirname(path))
            _, text = cli(main, ["train-gp", "--data", str(corpus / "*.csv"),
                                 "--output", path] + flags + extra)
            out[pkg, kind] = (path, text)
    return out


@pytest.mark.parametrize("kind", ["dense", "all"])
def test_train_gp_checkpoints_predict_alike_in_both_packages(kind, checkpoints):
    q = np.random.default_rng(11).normal(size=(25, 10))
    q[:, 2] += 3.0
    means = []
    for pkg in ("jax", "port"):
        path, text = checkpoints[pkg, kind]
        post_j = j_load(path)[0]
        means.append(np.asarray(j_predict_mean(post_j, q)))
        post_t = load_gp_checkpoint(path, device="cpu")[0]
        means.append(predict_mean(post_t, torch.as_tensor(q)).numpy())
        assert f"saved checkpoint to {path}" in text
        if kind == "dense":
            latest = os.path.join(os.path.dirname(path), "gp_model_latest.npz")
            assert os.path.islink(latest) and os.readlink(latest) == "gp.npz"
        else:
            world = "1 device(s)" if pkg == "port" else "8 device(s)"
            assert f"sharded fit: n=320 over {world}" in text
    for m in means[1:]:
        np.testing.assert_allclose(m, means[0], rtol=0, atol=PREDICT_TOL)


def test_evaluate_gp_json_matches_jax(checkpoints, corpus, tmp_path):
    model = checkpoints["port", "dense"][0]
    data = str(corpus / "flight_1.csv")
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "port")
    want, _ = cli(jax_main, ["evaluate-gp", "--model", model, "--data", data, "--output", pj,
                             "--full-analysis"])
    got, _ = cli(port_main, ["evaluate-gp", "--model", model, "--data", data, "--output", pt,
                             "--full-analysis", "--device", "cpu"])
    assert len(got) == len(want) == 2
    close(got, want, EVAL_RTOL)
    assert os.path.exists(pt + "_metrics.csv")
    for suffix in ("_distributions.png", "_uncertainty.png", "_correlations.png"):
        assert os.path.exists(pt + suffix)


@pytest.mark.parametrize("suffix", [".npz", ".uavlog"])
def test_analyze_of_a_port_log_matches_jax(suffix, tmp_path):
    log = str(tmp_path / f"flight{suffix}")
    cli(port_main, ["fly", "--controller", "pid", "--duration", "1", "--amplitude", "2",
                    "--trajectory", "circle", "--save-log", log, "--device", "cpu"])
    (got,), _ = cli(port_main, ["analyze", "--log", log, "--device", "cpu"])
    (want,), _ = cli(jax_main, ["analyze", "--log", log])
    close(got, want, 1e-6, 1e-9)
    assert got["rms_pos"] >= 0.0
    if suffix == ".npz":
        png, gif = str(tmp_path / "flight.png"), str(tmp_path / "replay.gif")
        _, text = cli(port_main, ["analyze", "--log", log, "--plot", png, "--animate", gif,
                                  "--device", "cpu"])
        assert f"plot written to {png}" in text and "animation written" in text
        assert os.path.getsize(png) > 10_000 and os.path.getsize(gif) > 10_000


@pytest.mark.parametrize("argv", [
    ["tune", "--controller", "pid", "--duration", "1", "--amplitude", "2", "--iterations", "2"],
    ["tune", "--controller", "mpc", "--duration", "0.5", "--amplitude", "2", "--iterations", "2"],
], ids=["pid", "mpc"])
def test_tune_loss_trace_matches_jax(argv, tmp_path):
    saved = str(tmp_path / "tuned.json")
    (got,), text = cli(port_main, argv + ["--save", saved, "--device", "cpu"])
    (want,), _ = cli(jax_main, argv)
    assert set(got) == set(want)
    assert abs(got["loss_initial"] - want["loss_initial"]) <= (
        LOSS_INITIAL_RTOL * abs(want["loss_initial"]) + 5e-6)   # printed to 5 places
    assert abs(got["loss_final"] - want["loss_final"]) <= (
        LOSS_FINAL_RTOL * abs(want["loss_final"]) + 5e-6)
    for key in ("rms_pos_m_before", "rms_pos_m_after"):
        assert abs(got[key] - want[key]) <= RMS_TOL_M, key
    assert got["loss_final"] <= got["loss_initial"]
    close(got["tuned"], want["tuned"], LOSS_FINAL_RTOL, 1e-3)
    with open(saved) as f:
        assert json.load(f)["loss_final"] == got["loss_final"]
    assert f"saved tuned parameters to {saved}" in text
