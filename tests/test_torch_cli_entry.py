"""The port's command line as a program, and its commands whose random
draws differ between the packages.

- ``python -m unmanned_aerial_vehicles_tpu_torch --help`` lists the ten
  commands, and a 1 s ``fly ... --device cpu`` exits 0 with JSON (both in
  a subprocess);
- without a GPU, a command given no ``--device`` raises ``RuntimeError``
  and flies nothing on the CPU;
- ``fly --controller mppi12``, the ``--noisy`` flights and ``montecarlo``
  draw from ``torch.Generator`` streams that are not the JAX package's
  (equal-draw parity is shown at the module level:
  ``tests/test_torch_mppi.py``, ``test_torch_noisy_flight.py``,
  ``test_torch_monte_carlo.py``), so they are held to the JAX package's own
  bars in ``tests/test_cli.py`` and to finite values, some at shorter
  lengths than there (the bars are RMS bounds over ramped references).
  The 12-state noisy flights and the disturbance-observer flights only
  repeat, through the command line, what ``test_torch_noisy_rigid.py``,
  ``test_torch_noisy_flight.py`` and ``test_torch_estimation.py`` show at
  the module level, and ``test_torch_cli_dispatch.py`` holds their configs:
  they are marked ``slow`` (10-20 s each here on one thread).

Every in-process call passes ``--device cpu``.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu_torch.cli import build_parser, main
from unmanned_aerial_vehicles_tpu_torch.io import save_gp_dataset

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
COMMANDS = {"train-gp", "evaluate-gp", "fly", "mission", "online", "analyze", "compare",
            "sweep", "tune", "montecarlo"}


def module(*argv):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "unmanned_aerial_vehicles_tpu_torch", *argv],
                          capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO))


def cli(argv):
    """``main(argv + --device cpu)``: exit 0, its JSON (from the first
    ``{``) and its text."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv + ["--device", "cpu"])
    text = buf.getvalue()
    assert rc == 0, text
    return json.JSONDecoder().raw_decode(text, text.index("{"))[0], text


def test_python_m_help_lists_the_ten_commands():
    res = module("--help")
    assert res.returncode == 0, res.stderr
    listed = res.stdout.split("{", 1)[1].split("}", 1)[0].split(",")
    assert set(listed) == COMMANDS


def test_python_m_flies_on_the_cpu():
    res = module("fly", "--controller", "pid", "--duration", "1", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout[res.stdout.index("{"):])
    assert math.isfinite(out["rms_pos"])


def test_every_command_takes_device():
    parser = build_parser()
    for command in COMMANDS:
        required = {"evaluate-gp": ["--model", "m", "--data", "d"],
                    "analyze": ["--log", "l"]}.get(command, [])
        args = parser.parse_args([command, *required, "--device", "cpu"])
        assert args.device == "cpu" and parser.parse_args([command, *required]).device is None


@pytest.mark.parametrize("argv", [
    ["fly", "--controller", "pid", "--duration", "1"],
    ["compare", "--duration", "1"],
    ["train-gp", "--data", "/nonexistent/*.csv"],
], ids=["fly", "compare", "train-gp"])
def test_without_a_gpu_a_command_given_no_device_raises(argv):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)


def test_fly_mppi12_meets_its_bar():
    out, _ = cli(["fly", "--controller", "mppi12", "--duration", "2", "--amplitude", "2",
                  "--trajectory", "circle"])
    assert out["rms_pos"] < 1.3                       # tests/test_cli.py:145-150


def test_fly_noisy_flights_meet_their_bars():
    out, _ = cli(["fly", "--controller", "mpc", "--duration", "5", "--amplitude", "2",
                  "--trajectory", "circle", "--noisy"])
    assert out["rms_pos"] < 2.0                       # test_cli.py:138-143
    for argv in (["fly", "--controller", "mpc", "--noisy", "--fast", "--duration", "3"],
                 ["fly", "--controller", "gp-mpc", "--fast", "--online", "--duration", "3"]):
        out, _ = cli(argv)                            # :172-188
        assert np.isfinite(out["rms_pos"])


@pytest.mark.slow
@pytest.mark.parametrize("controller, banner", [("mpc12", "# noisy tier: mpc12"),
                                                ("direct-rate12", "rate-lag EKF")])
def test_fly_noisy_12_state_meets_its_bar(controller, banner):
    out, text = cli(["fly", "--controller", controller, "--duration", "2", "--amplitude", "2",
                     "--trajectory", "circle", "--noisy"])
    assert banner in text and out["rms_pos"] < 2.0    # test_cli.py:259-284


@pytest.mark.slow
def test_fly_ltv12_noisy_meets_its_bar():
    out, text = cli(["fly", "--controller", "ltv12", "--duration", "2", "--amplitude", "1.5",
                     "--trajectory", "circle", "--noisy"])
    assert "# noisy tier: ltv12" in text and out["rms_pos"] < 1.0   # test_cli.py:287-300


@pytest.mark.slow
def test_fly_gust_observer_points_into_the_post_gust_wind():
    """test_cli.py:334-349: the observer's tail estimate reflects the
    post-gust wind, staged and on the fused tier."""
    for extra in ([], ["--fast"]):
        out, text = cli(["fly", "--controller", "mpc", "--duration", "6", "--noisy",
                         "--wind", "1.5", "0", "0", "--gust", "2", "-1.5", "0", "0",
                         "--disturbance-observer"] + extra)
        line = [ln for ln in text.splitlines() if "disturbance observer" in ln]
        assert np.isfinite(out["rms_pos"])
        assert line and "-" in line[0].split("[")[1]


@pytest.mark.slow
def test_fly_push_observer_direct_rate12():
    out, text = cli(["fly", "--controller", "direct-rate12", "--duration", "4", "--noisy",
                     "--push", "0.6", "-0.4", "0.3", "--disturbance-observer"])
    assert "disturbance observer (direct-rate12)" in text and np.isfinite(out["rms_pos"])


def test_montecarlo_meets_its_bars(tmp_path):
    out, _ = cli(["montecarlo", "--controller", "mpc", "--duration", "4", "--amplitude", "2",
                  "--rollouts", "4"])
    assert 0.0 <= out["success_rate"] <= 1.0           # test_cli.py:120-125
    assert out["rms_pos_m_p50"] <= out["rms_pos_m_p99"] + 1e-9
    rng = np.random.default_rng(3)
    X = rng.normal(size=(120, 10))
    X[:, 2] += 3.0
    save_gp_dataset(str(tmp_path / "f.csv"), X, 0.05 * rng.normal(size=(120, 6)))
    out, _ = cli(["montecarlo", "--controller", "gp-mpc", "--duration", "4", "--amplitude",
                  "2", "--rollouts", "4", "--gp-data", str(tmp_path / "*.csv")])
    assert 0.0 <= out["success_rate"] <= 1.0           # :153-157
    png = str(tmp_path / "mc.png")
    out, text = cli(["montecarlo", "--controller", "pid", "--duration", "2", "--rollouts", "4",
                     "--plot", png])
    assert f"dispersion figure written to {png}" in text and os.path.getsize(png) > 10_000
