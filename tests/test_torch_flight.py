"""Port parity for the slice as a whole: the online GP-MPC multi-tick flight
(the main path at test size) and the frozen-GP multi-tick flight against
the JAX package on the CPU, plus the port's hygiene rules.

Tolerance: position gap <= 1e-4 m. Both packages fly in float32; the JAX
package's own fused-vs-staged bar is 2e-5 m over 200 ticks, and the online
flight adds refits whose float32 GP operands round differently. The ring
buffer's sample count must be identical at every tick.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig as JGPCfg, fit_residual_gp as j_fit
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig as JLoopCfg,
    OnlineFusedGPConfig as JOnline,
    mpc_flight_rollout as j_rollout,
)
from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams as JBody
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference as j_fig8
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    OnlineFusedGPConfig,
    mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "unmanned_aerial_vehicles_tpu_torch"
HORIZON, K = 10, 4
WIND = (0.8, 0.4, 0.0)


def j_ref(t):
    pos, yaw = j_fig8(t, 6.0, 0.02)
    return pos + jnp.asarray([0.0, 0.0, 3.0], pos.dtype), yaw


def t_ref(t):
    pos, yaw = ramped_figure8_reference(t, 6.0, 0.02)
    return pos + torch.tensor([0.0, 0.0, 3.0], dtype=pos.dtype), yaw


def mpcs():
    cfg = dict(horizon=HORIZON, admm_iterations=20, use_fused_controller=True)
    return JMPC(JCfg(**cfg)), LinearMPC(LinearMPCConfig(**cfg), device="cpu")


def assert_flights_agree(got, want, pos_tol=1e-4):
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
    gap = np.max(np.abs(got["state"][:, 0:3].numpy() - np.asarray(want["state"][:, 0:3])))
    assert gap <= pos_tol, gap
    assert np.all(np.isfinite(got["state"].numpy()))


def test_online_flight_matches_jax():
    T = 48
    jm, tm = mpcs()
    want = j_rollout(
        jm, j_ref, T, body=JBody(wind=WIND),
        cfg=JLoopCfg(use_fused_tick=True, ticks_per_dispatch=K),
        online_gp=JOnline(gp=JGPCfg(max_data_points=32, residual_gain=1.0),
                          refit_every=16, min_samples=4),
        gp_gain=1.0,
    )
    got = mpc_flight_rollout(
        tm, t_ref, T, body=RigidBodyParams(wind=WIND),
        cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=K),
        online_gp=OnlineFusedGPConfig(gp=ResidualGPConfig(max_data_points=32, residual_gain=1.0),
                                      refit_every=16, min_samples=4),
        gp_gain=1.0, device="cpu",
    )
    np.testing.assert_array_equal(got["gp_count"].numpy(), np.asarray(want["gp_count"]))
    assert int(got["gp_count"][-1]) > 4          # the refits had data to fit
    assert_flights_agree(got, want)


def test_frozen_gp_multitick_flight_matches_jax():
    T = 24
    rng = np.random.default_rng(1)
    X = rng.normal(size=(48, 10)) * 0.5
    X[:, 2] += 3.0
    Y = 0.05 * rng.normal(size=(48, 6)) + 0.02
    jpost = j_fit(jnp.asarray(X), jnp.asarray(Y), JGPCfg())
    post = convert.gp_posterior_from_numpy(
        np.asarray(jpost.X_train), np.asarray(jpost.chol), np.asarray(jpost.alpha),
        np.asarray(jpost.y_mean), np.asarray(jpost.y_std),
        np.asarray(jpost.params.length_scale), np.asarray(jpost.params.signal_variance),
        np.asarray(jpost.params.noise_variance), device="cpu",
    )
    jm, tm = mpcs()
    kw = dict(gp_gain=1.0)
    want = j_rollout(jm, j_ref, T, body=JBody(wind=WIND), gp_posterior=jpost,
                     cfg=JLoopCfg(use_fused_tick=True, ticks_per_dispatch=K), **kw)
    got = mpc_flight_rollout(tm, t_ref, T, body=RigidBodyParams(wind=WIND), gp_posterior=post,
                             cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=K),
                             device="cpu", **kw)
    assert_flights_agree(got, want)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import unmanned_aerial_vehicles_tpu_torch.loop.closed_loop\n"
        "import unmanned_aerial_vehicles_tpu_torch.convert\n"
        "import unmanned_aerial_vehicles_tpu_torch.ops.tick_pallas\n"
        "import unmanned_aerial_vehicles_tpu_torch.ops.controller_pallas\n"
        "import unmanned_aerial_vehicles_tpu_torch.ops.admm_pallas\n"
        "import unmanned_aerial_vehicles_tpu_torch.ops.rbf_pallas\n"
        "import unmanned_aerial_vehicles_tpu_torch.parallel.sweep\n"
        "import unmanned_aerial_vehicles_tpu_torch.estimation.ekf\n"
        "import unmanned_aerial_vehicles_tpu_torch.estimation.disturbance\n"
        "import unmanned_aerial_vehicles_tpu_torch.estimation.noisy_loop\n"
        "import unmanned_aerial_vehicles_tpu_torch.io.checkpoint\n"
        "import unmanned_aerial_vehicles_tpu_torch.ops.tick_ad\n"
        "import unmanned_aerial_vehicles_tpu_torch.tuning\n"
        "import unmanned_aerial_vehicles_tpu_torch.loop.monte_carlo\n"
        "import unmanned_aerial_vehicles_tpu_torch.loop.mission\n"
        "import unmanned_aerial_vehicles_tpu_torch.loop.full_system\n"
        "import unmanned_aerial_vehicles_tpu_torch.control.mpc_demo\n"
        "import unmanned_aerial_vehicles_tpu_torch.gp.per_dim\n"
        "import unmanned_aerial_vehicles_tpu_torch.io.synthetic\n"
        "import unmanned_aerial_vehicles_tpu_torch.metrics\n"
        "import unmanned_aerial_vehicles_tpu_torch.parallel\n"
        "import unmanned_aerial_vehicles_tpu_torch.io\n"
        "import unmanned_aerial_vehicles_tpu_torch.gp\n"
        "import unmanned_aerial_vehicles_tpu_torch.utils\n"
        "import unmanned_aerial_vehicles_tpu_torch.metrics.animate\n"
        "import unmanned_aerial_vehicles_tpu_torch.cli\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('run_campaign', "
        "'tools_torch/run_campaign.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('sklearn', 'matplotlib')], "
        "'sklearn or matplotlib imported'\n"
        "assert not any(m.startswith('unmanned_aerial_vehicles_tpu.') or "
        "m == 'unmanned_aerial_vehicles_tpu' for m in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the JAX package's name followed by ".", whitespace or end of line: the
# port's own name starts with it and must not match
_JAX_PKG = re.compile(r"^\s*(from|import)\s+(jax\b|unmanned_aerial_vehicles_tpu(\.|\s|$))", re.M)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    sources = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
               + sorted((REPO / "tools_torch").glob("*.py")))
    assert len(sources) > 10
    assert PORT / "tuning" / "autotune.py" in sources and PORT / "ops" / "tick_ad.py" in sources
    assert PORT / "loop" / "monte_carlo.py" in sources
    for path in sources:
        text = path.read_text()
        assert not _JAX_PKG.search(text), path
    assert _JAX_PKG.search("from unmanned_aerial_vehicles_tpu.ops import qp")
    assert _JAX_PKG.search("import unmanned_aerial_vehicles_tpu\n")
    assert not _JAX_PKG.search("from unmanned_aerial_vehicles_tpu_torch.ops import qp")


def test_entry_points_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LinearMPC(LinearMPCConfig(horizon=HORIZON))
    tm = LinearMPC(LinearMPCConfig(horizon=HORIZON), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mpc_flight_rollout(tm, t_ref, 4)


@pytest.mark.parametrize("path", ["polish", "tightening", "resume", "output_correction",
                                  "fused_tick_ad"])
def test_queued_paths_raise_and_point_at_the_roadmap(path):
    """Every path once queued in ROADMAP.md now flies: the staged
    active-set polish (a tick of the polished ``LinearMPC``, held to the
    JAX package by ``tests/test_torch_qp_polish.py``), multi-tick
    tightening, resume, the staged output correction and ``fused_tick_ad``
    (here on the single-tick tier, which it leaves as it is)."""
    cfg = dict(horizon=HORIZON, use_fused_controller=True)
    kw = dict(cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=K), device="cpu")
    if path == "polish":
        cfg = dict(horizon=HORIZON, polish=True)
    elif path == "tightening":
        cfg["tightening_factor"] = 1.0
    elif path == "resume":
        kw["return_resume"] = True
    elif path == "output_correction":
        kw = dict(output_correction_fn=lambda x, u, p: u, device="cpu")
    else:
        kw["cfg"] = FlightLoopConfig(use_fused_tick=True, fused_tick_ad=True)
    tm = LinearMPC(LinearMPCConfig(**cfg), device="cpu")
    if path in ("tightening", "resume", "output_correction", "fused_tick_ad"):
        out = mpc_flight_rollout(tm, t_ref, K, **kw)
        outs = out[0] if path == "resume" else out
        assert tuple(outs["state"].shape) == (K, 12)
        assert bool(torch.isfinite(outs["state"]).all())
        return
    u0, X_opt, carry = tm.solve(tm.init_carry(), torch.zeros(6), torch.zeros(3))
    assert tuple(X_opt.shape) == (HORIZON + 1, 6)
    assert bool(torch.isfinite(u0).all()) and bool(torch.isfinite(carry.dual).all())


@pytest.mark.parametrize("path", ["tightening", "resume", "uncertainty_fn",
                                  "output_correction_fn"])
def test_single_tick_tier_refuses_what_jax_refuses(path):
    """The JAX package raises ``ValueError`` for these on its single-tick
    tier (``closed_loop.py:274-330``); so does the port."""
    cfg = dict(horizon=HORIZON, use_fused_controller=True)
    kw = dict(cfg=FlightLoopConfig(use_fused_tick=True), device="cpu")
    if path == "tightening":
        cfg["tightening_factor"] = 1.0
    elif path == "resume":
        kw["return_resume"] = True
    elif path == "uncertainty_fn":
        kw["uncertainty_fn"] = lambda X, U: torch.zeros(HORIZON, 6)
    else:
        kw["output_correction_fn"] = lambda x, u, p: u
    tm = LinearMPC(LinearMPCConfig(**cfg), device="cpu")
    with pytest.raises(ValueError):
        mpc_flight_rollout(tm, t_ref, K, **kw)
