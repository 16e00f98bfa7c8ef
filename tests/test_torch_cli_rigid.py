"""The 12-state commands of both command lines, flown end to end on the CPU.

Both packages run ``fly`` with the 12-state controllers at the short
lengths of the JAX package's ``tests/test_cli.py`` and print their JSON:
the key sets must be equal and every flight metric within 5e-4 absolute
(the JSON is rounded to 4 places).

The LTV flight with an obstacle (``test_cli.py``'s 8 s circle past a 0.3 m
sphere) is chaotic in float32 once the obstacle rows bind (``PERF.md`` §2:
float32 runs started 1e-6 m apart part by 6.5e-4 m within 30 ticks and
0.175 m over 200). Its metrics are held here to 8e-3 m, the RMS gap at
which ``chip_smoke.py`` holds this flight against its plain twin on the
card (``CHAOTIC_BOUNDS_M``); the same tier without the obstacle is held to
5e-4.
"""

import contextlib
import io
import json

import pytest
import torch

from unmanned_aerial_vehicles_tpu.cli import main as jax_main
from unmanned_aerial_vehicles_tpu_torch.cli import main as port_main

torch.set_num_threads(1)

METRIC_TOL = 5e-4
CHAOTIC_OBSTACLE_TOL_M = 8e-3


def cli_run(main, argv):
    """``main(argv)``'s exit code 0, its JSON (from the first ``{``) and
    its comment lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    assert rc == 0, out
    return json.loads(out[out.index("{"): out.rindex("}") + 1]), out[: out.index("{")]


FLY = ["fly", "--amplitude", "2"]
CASES = {
    "mpc12": (FLY + ["--controller", "mpc12", "--duration", "2"], METRIC_TOL),
    "direct-rate12-fast": (FLY + ["--controller", "direct-rate12", "--fast", "--duration", "2"],
                           METRIC_TOL),
    "ilqr12-fast": (FLY + ["--controller", "ilqr12", "--fast", "--duration", "2"], METRIC_TOL),
    "ltv12-fast": (["fly", "--controller", "ltv12", "--fast", "--duration", "2", "--trajectory",
                    "circle", "--amplitude", "1.5"], METRIC_TOL),
    "ltv12-fast-obstacle": (["fly", "--controller", "ltv12", "--fast", "--duration", "8",
                             "--trajectory", "circle", "--amplitude", "1.5",
                             "--obstacle", "0,1.5,3.0,0.3"], CHAOTIC_OBSTACLE_TOL_M),
}


@pytest.mark.parametrize("name", list(CASES))
def test_rigid_command_json_matches_jax(name):
    argv, tol = CASES[name]
    (got, banner), (want, jax_banner) = (cli_run(port_main, argv + ["--device", "cpu"]),
                                         cli_run(jax_main, argv))
    assert banner == jax_banner
    assert set(got) == set(want)
    for key, w in want.items():
        assert abs(got[key] - w) <= tol, (key, got[key], w)
    if name == "ltv12-fast-obstacle":
        assert "multitick tier: ltv12" in banner
        assert got["rms_pos"] < 1.0 and got["min_obstacle_clearance"] > 0.0
