"""The 6-state commands of both command lines, flown end to end on the CPU.

Both packages run the same argv lists, at the short lengths of the JAX
package's ``tests/test_cli.py`` or shorter (``mission`` 21 s: its trajectory
phase starts at 20 s; ``online`` 6 s: three GP refits), and print their
JSON; the key sets must be equal and every flight metric (``rms_*``,
errors, altitudes) within 5e-4 absolute: the JSON is rounded to 4 places,
and the flights agree to ~1e-6 m (``tests/test_torch_flight.py``). Counts
and flags must be equal.

``sweep`` flies 8 flights: the JAX package shards its batch over the
8-device CPU mesh of ``tests/conftest.py``, which needs a multiple of 8.
Its ``devices`` key is the world size: 8 there, 1 in the port.

``compare`` is held to ``tests/test_torch_compare_demo.py``'s bars (F15:
the reference's comparison PID is chaotic on moving references, so its
average error within 1e-3 m; the MPC's errors within 1e-4 m).
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.cli import main as jax_main
from unmanned_aerial_vehicles_tpu_torch.cli import main as port_main
from unmanned_aerial_vehicles_tpu_torch.io import save_gp_dataset

torch.set_num_threads(1)

METRIC_TOL = 5e-4
COMPARE_MPC_TOL_M, COMPARE_PID_AVG_TOL_M = 1e-4, 1e-3


def cli_json(main, argv):
    """``main(argv)``'s exit code 0 and its JSON (from the first ``{``)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    assert rc == 0, out
    return json.loads(out[out.index("{"): out.rindex("}") + 1])


def assert_json_agrees(got, want, tol=METRIC_TOL, skip=()):
    assert set(got) == set(want)
    for key, w in want.items():
        if key in skip:
            continue
        g = got[key]
        if isinstance(w, (bool, str)) or (isinstance(w, int) and isinstance(g, int)):
            assert g == w, (key, g, w)
        else:
            assert abs(g - w) <= tol, (key, g, w)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_flights")
    rng = np.random.default_rng(2026)
    X = rng.normal(size=(150, 10))
    X[:, 2] += 3.0
    Y = 0.05 * rng.normal(size=(150, 6)) + 0.02 * X[:, 3:9]
    save_gp_dataset(str(d / "flight_0.csv"), X, Y)
    return str(d / "*.csv")


CASES = {
    "fly-mpc-fast": ["fly", "--controller", "mpc", "--fast", "--duration", "2",
                     "--amplitude", "2"],
    "fly-gpmpc-staged": ["fly", "--controller", "gp-mpc", "--duration", "2", "--amplitude", "2",
                         "--trajectory", "circle", "--gp-data", "{corpus}"],
    "fly-pid": ["fly", "--controller", "pid", "--duration", "4", "--amplitude", "2",
                "--trajectory", "circle"],
    "mission": ["mission", "--duration", "21", "--amplitude", "3"],
    "online": ["online", "--duration", "6", "--gp-capacity", "64", "--refit-every", "100"],
    "sweep": ["sweep", "--flights", "8", "--duration", "1"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_command_json_matches_jax(name, corpus):
    argv = [a.format(corpus=corpus) for a in CASES[name]]
    got, want = cli_json(port_main, argv + ["--device", "cpu"]), cli_json(jax_main, argv)
    if name == "sweep":
        assert (got["devices"], want["devices"]) == (1, 8)
        assert_json_agrees(got, want, skip=("devices",))
    else:
        assert_json_agrees(got, want)
    if name == "mission":
        assert got["phases_reached"] == 5
    if name == "online":
        assert got["gp_samples_collected"] > 30 and got["gp_active_final"] is True


def test_compare_json_matches_jax():
    argv = ["compare", "--duration", "5"]
    got, want = cli_json(port_main, argv + ["--device", "cpu"]), cli_json(jax_main, argv)
    assert list(got) == list(want) == ["hover", "circle", "figure8", "step"]
    for traj, w in want.items():
        g = got[traj]
        assert set(g) == set(w)
        for key in ("mpc_avg_error", "mpc_rmse", "mpc_max_error"):
            assert abs(g[key] - w[key]) <= COMPARE_MPC_TOL_M, (traj, key)
        assert abs(g["pid_avg_error"] - w["pid_avg_error"]) <= COMPARE_PID_AVG_TOL_M, traj
        if abs(w["mpc_avg_error"] - w["pid_avg_error"]) > 2 * COMPARE_PID_AVG_TOL_M:
            assert g["winner"] == w["winner"], traj

