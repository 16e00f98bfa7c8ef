"""The port's command line picks the same callee, with the same configs,
as the JAX package's, for every branch of its ten commands, without flying.

Each argv list runs through both ``main`` functions with the terminal call
(the rollout, trainer, sweep, tuner, Monte Carlo function, or, for the
staged 12-state flights that have no rollout function, the engine's
constructor) replaced in both packages by a recorder that keeps its bound
arguments and raises. Both command lines import that callee lazily from the
same subpackage, so the same attribute is patched in each. Held:

- the same callee and the same ``num_steps``;
- the same set of passed arguments, apart from the random key or
  generator, the device and the working dtype;
- every config dataclass equal field by field (``LinearMPCConfig``,
  ``FlightLoopConfig``, ``ResidualGPConfig``, ``OnlineFusedGPConfig``,
  ``EKFConfig``, ``MonteCarloConfig``, ``TuneConfig``, the bodies), apart
  from the two switches that route the port's staged paths through the
  kernels (``use_pallas_plant``, ``use_fused_controller``: the port's
  ``cli.KERNEL_LOOP`` and ``KERNEL_MPC``, on wherever the JAX command line
  flies the staged path; a test below holds them), arrays
  (obstacle rows, starts, corpora, hover controls) within 1e-6, and the
  callables that carry the flight's settings (the reference, the wind and
  push rows of the true plant, the GP residuals, the fallback) evaluated on
  the same probe inputs within 1e-5.

Every guard of the JAX command line returns 1 in both with nothing called;
the two flags that the JAX command line accepts and ignores (``--gust``
with ltv12, ``--push`` without ``--noisy``) return 1 in the port, while
the JAX command line goes on to its callee. Every call passes
``--device cpu``.
"""

import dataclasses
import inspect
import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.cli import main as jax_main
from unmanned_aerial_vehicles_tpu_torch.cli import main as port_main
from unmanned_aerial_vehicles_tpu_torch.io import save_gp_dataset

torch.set_num_threads(1)

JAX_PKG = "unmanned_aerial_vehicles_tpu"
PORT_PKG = "unmanned_aerial_vehicles_tpu_torch"

# callee -> (subpackage, attribute), the same in both packages
TARGETS = {
    "pid": ("loop", "pid_flight_rollout"),
    "mpc": ("loop", "mpc_flight_rollout"),
    "noisy": ("estimation", "noisy_mpc_flight_rollout"),
    "noisy_rigid": ("estimation.noisy_loop", "noisy_rigid_mpc_rollout"),
    "noisy_ltv": ("estimation.noisy_loop", "noisy_ltv_rollout"),
    "sqp": ("loop.rigid_loop", "sqp_multitick_rollout"),
    "ilqr_multitick": ("loop.rigid_loop", "ilqr_multitick_rollout"),
    "direct_rate_fused": ("loop.rigid_loop", "direct_rate_multitick_fused"),
    "mission": ("loop", "mission_rollout"),
    "online": ("loop", "online_gp_mpc_rollout"),
    "compare": ("loop", "run_full_comparison"),
    "sweep": ("parallel", "sharded_flight_sweep"),
    "tune_pid": ("tuning", "tune_cascade_gains"),
    "tune_mpc": ("tuning", "tune_mpc_weights"),
    "mc_pid": ("loop", "monte_carlo_pid"),
    "mc_mpc": ("loop", "monte_carlo_mpc"),
    "fit_gp": ("gp.exact_gp", "fit_gp"),
    "optimize": ("gp", "optimize_hyperparameters"),
    "fit_sharded": ("parallel", "fit_residual_gp_sharded"),
    "optimize_sharded": ("parallel", "optimize_hyperparameters_sharded"),
    "evaluate": ("gp", "evaluate_gp"),
    "analyze": ("io", "analyze_flight_log"),
}
# the staged 12-state flights' engines: patched only where they are the callee
ENGINES = {
    "RigidBodyMPC": ("control", "RigidBodyMPC"),
    "DirectRateMPC": ("control", "DirectRateMPC"),
    "ILQRRigidBodyMPC": ("control", "ILQRRigidBodyMPC"),
    "MPPIController": ("control", "MPPIController"),
    "LTVTrackingMPC": ("control", "LTVTrackingMPC"),
}
ALL = {**TARGETS, **ENGINES}
EXCLUDED = {"key", "generator", "device", "dtype"}
KERNEL_ROUTES = {"use_pallas_plant", "use_fused_controller"}
TIME_REFERENCE_CALLEES = {"pid", "mpc", "noisy", "noisy_rigid", "mission", "online", "mc_pid",
                          "mc_mpc", "tune_pid", "tune_mpc"}


class Called(Exception):
    pass


TRACED = "<traced>"


def _traced(v):
    return "Tracer" in type(v).__name__


def _recorder(store, name, real):
    sig = inspect.signature(real)

    def record(*args, **kwargs):
        bound = sig.bind(*args, **kwargs).arguments
        # the JAX package traces its 12-state tiers' start state under jit
        store.append((name, {k: TRACED if _traced(v) else v for k, v in bound.items()}))
        raise Called
    return record


def run(pkg, main, argv, names, monkeypatch):
    """``main(argv)`` with each of ``names`` recorded: ``(rc, calls)``, rc
    None when a callee was reached."""
    store = []
    for name in names:
        sub, attr = ALL[name]
        module = importlib.import_module(f"{pkg}.{sub}")
        monkeypatch.setattr(module, attr, _recorder(store, name, getattr(module, attr)))
    try:
        rc = main(argv)
    except Called:
        rc = None
    return rc, store


# ---- values of both packages in one comparable form --------------------------

def _array(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().double().numpy()
    return np.asarray(v, dtype=np.float64)


def _is_array(v):
    return isinstance(v, (torch.Tensor, np.ndarray)) or type(v).__module__.startswith("jax")


def norm(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if _is_array(v):
        return _array(v)
    if hasattr(v, "X_train") and hasattr(v, "y_std"):      # a GP posterior
        X = v.X_train
        if getattr(v, "x_shift", None) is not None:
            X = X + v.x_shift
        return {"X_train": _array(X), "y_mean": _array(v.y_mean), "y_std": _array(v.y_std)}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: norm(getattr(v, f.name)) for f in dataclasses.fields(v)
                if f.name not in KERNEL_ROUTES}
    if hasattr(v, "_fields"):                               # NamedTuples of arrays
        return {k: norm(getattr(v, k)) for k in v._fields}
    if isinstance(v, (tuple, list)):
        return [norm(x) for x in v]
    if hasattr(v, "keys") and hasattr(v, "__getitem__"):    # a flight log
        return {k: norm(v[k]) for k in v.keys()}
    if callable(v) and not hasattr(v, "__dict__") or inspect.isfunction(v):
        return "<callable>"
    out = {"type": type(v).__name__}
    config = getattr(v, "config", None)
    if dataclasses.is_dataclass(config):
        out["config"] = norm(config)
    if hasattr(v, "mpc") and not isinstance(v.mpc, (int, float)):
        out["mpc"] = norm(v.mpc)
    scalars = {k: x for k, x in vars(v).items()
               if not k.startswith("_") and isinstance(x, (bool, int, float, str))}
    return ("object", out, scalars)


def same(a, b, path="", tol=1e-6):
    if isinstance(a, tuple) and a and a[0] == "object":
        assert isinstance(b, tuple) and b[0] == "object", path
        same(a[1], b[1], path, tol)
        common = set(a[2]) & set(b[2])
        assert {k: a[2][k] for k in common} == {k: b[2][k] for k in common}, path
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        assert np.allclose(a, b, rtol=tol, atol=tol, equal_nan=True), (path, a, b)
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            same(a[k], b[k], f"{path}.{k}", tol)
        return
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]", tol)
        return
    if isinstance(a, float) or isinstance(b, float):
        assert np.isclose(float(a), float(b), rtol=tol, atol=tol), (path, a, b)
        return
    assert a == b, (path, a, b)


# ---- the callables: evaluated on the same probe inputs -----------------------

def _jx(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _tx(a):
    return torch.as_tensor(np.asarray(a, np.float32))


STATE = np.array([0.2, -0.1, 3.1, 0.3, -0.2, 0.1, 0.05, -0.04, 0.1, 0.02, -0.01, 0.03])
CONTROL = np.array([20.0, 0.01, -0.02, 0.005])


def probes(callee, name, fn, jax_side):
    """Outputs of a callable argument on fixed inputs (as numpy)."""
    cast = _jx if jax_side else _tx
    ints = (lambda a: jnp.asarray(a)) if jax_side else (lambda a: torch.as_tensor(a))
    flat = lambda out: [_array(o) for o in (out if isinstance(out, tuple) else (out,))]
    if name == "reference_fn" and callee in TIME_REFERENCE_CALLEES:
        return [flat(fn(cast(t))) for t in (0.0, 1.3, 7.7)]
    if name in ("reference_fn", "position_ref_fn"):
        return flat(fn(ints(np.arange(3, 5))))
    if name == "reference_window_fn":
        return [flat(fn(i)) for i in (0, 5)]
    if name == "wind_fn":
        return [flat(fn(cast(t))) for t in (0.0, 2.0, 5.0)]
    if name in ("plant_step_fn", "process_step_fn", "plant_step"):
        return flat(fn(cast(STATE), cast(CONTROL)))
    if name == "plant_step_tfn":
        return [flat(fn(cast(STATE), cast(CONTROL), cast(t))) for t in (0.0, 20.0)]
    if name == "residual_fn":
        rng = np.random.default_rng(3)
        X = 0.5 * rng.normal(size=(26, 6)) + np.array([0, 0, 3, 0, 0, 0])
        return flat(fn(cast(X), cast(0.5 * rng.normal(size=(25, 4)))))
    if name == "output_correction_fn":
        return flat(fn(cast(STATE[:6]), cast(CONTROL), cast(STATE[:3] + 0.3)))
    if name == "fallback_fn":
        return flat(fn(cast(STATE), cast(CONTROL)))
    if name == "plan_roll_fn":
        U = np.tile(np.array([4.9, 0.0, 0.0, 0.0]), (20, 1))
        return flat(fn(cast(STATE), cast(U), None))
    return None


def compare_calls(jcall, pcall):
    jname, jargs = jcall
    pname, pargs = pcall
    assert jname == pname
    jkeys, pkeys = set(jargs) - EXCLUDED, set(pargs) - EXCLUDED
    assert jkeys == pkeys, (jkeys ^ pkeys)
    if "num_steps" in jargs:
        assert int(jargs["num_steps"]) == int(pargs["num_steps"])
    for key in jkeys:
        if key == "mesh":
            continue
        jv, pv = jargs[key], pargs[key]
        if jv is TRACED:
            continue
        if callable(jv) and not hasattr(jv, "config") and (inspect.isfunction(jv) or
                                                         not hasattr(jv, "__dict__")):
            assert callable(pv), key
            want = probes(jname, key, jv, True)
            if want is not None:
                same(probes(pname, key, pv, False), want, key, tol=1e-5)
            continue
        same(norm(pv), norm(jv), key)


# ---- seeded inputs ------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two seeded CSVs in the reference's layout, a GP checkpoint written by
    the port (600 rows, under the flight GP's 800), a single-GP and a
    per-dimension sklearn pickle, and a flight log."""
    d = tmp_path_factory.mktemp("cli_dispatch")
    rng = np.random.default_rng(2026)
    for k in range(2):
        X = rng.normal(size=(150, 10))
        X[:, 2] += 3.0
        Y = 0.05 * rng.normal(size=(150, 6)) + 0.02 * X[:, 3:9]
        save_gp_dataset(str(d / f"flight_{k}.csv"), X, Y)
    from unmanned_aerial_vehicles_tpu_torch.gp.exact_gp import fit_gp
    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig, default_params
    from unmanned_aerial_vehicles_tpu_torch.io import save_gp_checkpoint

    Xc = rng.normal(size=(600, 10))
    Yc = 0.05 * rng.normal(size=(600, 6))
    cfg = ResidualGPConfig()
    post = fit_gp(default_params(cfg, device="cpu"), torch.as_tensor(Xc), torch.as_tensor(Yc),
                  jitter=cfg.alpha, normalize_y=True)
    save_gp_checkpoint(str(d / "gp.npz"), post, Xc, Yc, jitter=cfg.alpha)
    out = {"dir": str(d), "csv": str(d / "flight_0.csv"), "glob": str(d / "*.csv"),
           "npz": str(d / "gp.npz"), "log": str(d / "flight.npz")}
    np.savez(out["log"], state=np.zeros((10, 12)), pos_ref=np.zeros((10, 3)))
    sklearn = pytest.importorskip("sklearn")
    del sklearn
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import RBF, ConstantKernel, WhiteKernel
    from sklearn.preprocessing import StandardScaler

    gpr = GaussianProcessRegressor(kernel=RBF(0.5) + WhiteKernel(0.1), alpha=1e-4,
                                   normalize_y=True, optimizer=None).fit(Xc[:60], Yc[:60])
    out["pkl"] = str(d / "gp_model.pkl")
    with open(out["pkl"], "wb") as f:
        pickle.dump({"gp_model": gpr, "training_count": 1, "data_points_used": 60,
                     "timestamp": "2026-10-18T00:00:00", "is_trained": True}, f)
    names = ["x_residual", "y_residual", "z_residual", "vx_residual", "vy_residual",
             "vz_residual"]
    models, sxs, sys_ = {}, {}, {}
    for i, name in enumerate(names):
        sx, sy = StandardScaler().fit(Xc[:50]), StandardScaler().fit(Yc[:50, i:i + 1])
        kernel = (ConstantKernel(1.0, constant_value_bounds="fixed")
                  * RBF(length_scale=[1.0] * 10) + WhiteKernel(noise_level=0.01))
        models[name] = GaussianProcessRegressor(kernel=kernel, alpha=1e-6, optimizer=None).fit(
            sx.transform(Xc[:50]), sy.transform(Yc[:50, i:i + 1]).ravel())
        sxs[name], sys_[name] = sx, sy
    out["perdim"] = str(d / "gp_perdim.pkl")
    with open(out["perdim"], "wb") as f:
        pickle.dump({"gp_models": models, "scalers_X": sxs, "scalers_y": sys_,
                     "training_stats": {}, "model_name": "cli", "creation_time": 0.0}, f)
    return out


# (id, argv, callee); "{glob}" and the like are filled from the files fixture
FLY = ["fly", "--duration", "2", "--amplitude", "2"]
CASES = [
    ("fly-pid", FLY + ["--controller", "pid", "--trajectory", "circle"], "pid"),
    ("fly-mpc-staged", FLY + ["--controller", "mpc"], "mpc"),
    ("fly-mpc-fast", FLY + ["--controller", "mpc", "--fast"], "mpc"),
    ("fly-mpc-preview-wind", FLY + ["--controller", "mpc", "--preview", "--wind", "1", "0.5", "0"],
     "mpc"),
    ("fly-gpmpc-staged", FLY + ["--controller", "gp-mpc", "--gp-data", "{glob}"], "mpc"),
    ("fly-gpmpc-fast", FLY + ["--controller", "gp-mpc", "--fast", "--gp-data", "{glob}"], "mpc"),
    ("fly-gpmpc-online", FLY + ["--controller", "gp-mpc", "--fast", "--online"], "mpc"),
    ("fly-gpmpc-output", FLY + ["--controller", "gp-mpc", "--gp-mode", "output",
                                "--gp-data", "{glob}"], "mpc"),
    ("fly-gpmpc-model-npz", FLY + ["--controller", "gp-mpc", "--gp-model", "{npz}"], "mpc"),
    ("fly-gpmpc-model-pkl", FLY + ["--controller", "gp-mpc", "--fast", "--gp-model", "{pkl}"],
     "mpc"),
    ("fly-gpmpc-model-perdim", FLY + ["--controller", "gp-mpc", "--gp-model", "{perdim}"], "mpc"),
    ("fly-mpc-noisy", FLY + ["--controller", "mpc", "--noisy", "--seed", "3"], "noisy"),
    ("fly-mpc-noisy-fast", FLY + ["--controller", "mpc", "--noisy", "--fast", "--ekf-relin",
                                  "dispatch", "--ekf-cov", "bf16"], "noisy"),
    ("fly-mpc-noisy-gust", FLY + ["--controller", "mpc", "--noisy", "--wind", "1.5", "0", "0",
                                  "--gust", "1", "-1.5", "0", "0", "--disturbance-observer",
                                  "--preview"], "noisy"),
    ("fly-gpmpc-online-noisy", FLY + ["--controller", "gp-mpc", "--fast", "--online", "--noisy"],
     "noisy"),
    ("fly-mpc12", FLY + ["--controller", "mpc12"], "RigidBodyMPC"),
    ("fly-mpc12-fast", FLY + ["--controller", "mpc12", "--fast"], "sqp"),
    ("fly-mpc12-noisy", FLY + ["--controller", "mpc12", "--noisy"], "noisy_rigid"),
    ("fly-dr12", FLY + ["--controller", "direct-rate12"], "DirectRateMPC"),
    ("fly-dr12-fast", FLY + ["--controller", "direct-rate12", "--fast"], "direct_rate_fused"),
    ("fly-dr12-push", FLY + ["--controller", "direct-rate12", "--noisy", "--push", "0.6", "-0.4",
                             "0.3", "--disturbance-observer"], "noisy_rigid"),
    ("fly-dr12-push-step", FLY + ["--controller", "direct-rate12", "--noisy", "--push", "0.6",
                                  "-0.4", "0.3", "--push-step", "1", "-0.5", "0.7", "-0.2"],
     "noisy_rigid"),
    ("fly-ilqr12", FLY + ["--controller", "ilqr12"], "ILQRRigidBodyMPC"),
    ("fly-ilqr12-fast", FLY + ["--controller", "ilqr12", "--fast"], "ilqr_multitick"),
    ("fly-ilqr12-noisy", FLY + ["--controller", "ilqr12", "--noisy"], "noisy_rigid"),
    ("fly-mppi12", FLY + ["--controller", "mppi12"], "MPPIController"),
    ("fly-mppi12-noisy", FLY + ["--controller", "mppi12", "--noisy"], "noisy_rigid"),
    ("fly-ltv12", FLY + ["--controller", "ltv12", "--obstacle", "0,1.5,3,0.3"], "LTVTrackingMPC"),
    ("fly-ltv12-fast", FLY + ["--controller", "ltv12", "--fast", "--trajectory", "circle",
                              "--obstacle", "0,1.5,3.0,0.3", "--obstacle", "1,1,3,0.2"], "sqp"),
    ("fly-ltv12-noisy", FLY + ["--controller", "ltv12", "--noisy", "--wind", "1", "0", "0",
                               "--disturbance-observer", "--obstacle", "0,1.5,3,0.3"],
     "noisy_ltv"),
    ("mission", ["mission", "--duration", "25", "--amplitude", "3"], "mission"),
    ("mission-noisy", ["mission", "--noisy", "--wind", "1", "0.5", "0", "--disturbance-observer",
                       "--seed", "4"], "mission"),
    ("online", ["online", "--duration", "12", "--gp-capacity", "64", "--refit-every", "100",
                "--preview"], "online"),
    ("compare", ["compare", "--duration", "5"], "compare"),
    ("sweep", ["sweep", "--flights", "4", "--duration", "2"], "sweep"),
    ("tune-pid", ["tune", "--controller", "pid", "--duration", "5", "--iterations", "2"],
     "tune_pid"),
    ("tune-mpc", ["tune", "--controller", "mpc", "--trajectory", "figure8", "--learning-rate",
                  "0.1"], "tune_mpc"),
    ("montecarlo-pid", ["montecarlo", "--controller", "pid", "--rollouts", "8", "--duration", "4"],
     "mc_pid"),
    ("montecarlo-mpc", ["montecarlo", "--controller", "mpc", "--wind-std", "0.5", "--seed", "2"],
     "mc_mpc"),
    ("montecarlo-gpmpc", ["montecarlo", "--controller", "gp-mpc", "--gp-data", "{glob}",
                          "--trajectory", "figure8"], "mc_mpc"),
    ("train-gp", ["train-gp", "--data", "{glob}", "--max-samples", "200",
                  "--output", "{dir}/t.npz"], "fit_gp"),
    ("train-gp-optimize", ["train-gp", "--data", "{glob}", "--optimize", "--opt-steps", "3"],
     "optimize"),
    ("train-gp-all", ["train-gp", "--data", "{glob}", "--all-samples", "--cg-iterations", "50"],
     "fit_sharded"),
    ("train-gp-all-optimize", ["train-gp", "--data", "{glob}", "--all-samples", "--optimize"],
     "optimize_sharded"),
    ("evaluate-gp", ["evaluate-gp", "--model", "{npz}", "--data", "{csv}"], "evaluate"),
    ("analyze", ["analyze", "--log", "{log}"], "analyze"),
]


def fill(argv, files):
    return [a.format(**files) for a in argv]


def patched_for(callee):
    """The callees to record: every rollout-like function and the case's
    own engine. ``fit_gp`` only where it is the callee: the port's
    checkpoint loader refits through it."""
    names = [n for n in TARGETS if n != "fit_gp" or callee == "fit_gp"]
    return names + ([callee] if callee in ENGINES else [])


@pytest.mark.parametrize("argv, callee", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_both_command_lines_call_the_same_callee_with_the_same_configs(argv, callee, files,
                                                                       monkeypatch):
    argv = fill(argv, files)
    names = patched_for(callee)
    rc_j, calls_j = run(JAX_PKG, jax_main, argv, names, monkeypatch)
    rc_p, calls_p = run(PORT_PKG, port_main, argv + ["--device", "cpu"], names, monkeypatch)
    assert rc_j is None and rc_p is None, (rc_j, rc_p)
    assert [c[0] for c in calls_j] == [callee] == [c[0] for c in calls_p]
    compare_calls(calls_j[0], calls_p[0])


GUARDS = [
    FLY + ["--controller", "pid", "--noisy"],
    FLY + ["--controller", "mpc12", "--wind", "1", "0", "0"],
    FLY + ["--controller", "ltv12", "--wind", "1", "0", "0"],
    FLY + ["--controller", "mpc", "--disturbance-observer"],
    FLY + ["--controller", "mpc12", "--noisy", "--disturbance-observer"],
    FLY + ["--controller", "direct-rate12", "--noisy", "--fast", "--disturbance-observer"],
    FLY + ["--controller", "mpc", "--noisy", "--push", "1", "0", "0"],
    FLY + ["--controller", "direct-rate12", "--noisy", "--push-step", "1", "0", "0", "0"],
    FLY + ["--controller", "mpc", "--noisy", "--gust", "1", "1", "0", "0"],
    FLY + ["--controller", "mpc", "--wind", "1", "0", "0", "--gust", "1", "0", "1", "0"],
    FLY + ["--controller", "mpc12", "--obstacle", "0,0,3,0.3"],
    FLY + ["--controller", "ltv12", "--obstacle", "bogus"],
    FLY + ["--controller", "ltv12", "--obstacle", "1,2,3"],
    FLY + ["--controller", "ltv12", "--noisy", "--fast"],
    FLY + ["--controller", "mpc12", "--noisy", "--fast"],
    FLY + ["--controller", "mppi12", "--fast"],
    FLY + ["--controller", "mpc", "--fast", "--gp-mode", "output"],
    FLY + ["--controller", "mpc", "--online"],
    FLY + ["--controller", "gp-mpc", "--fast", "--online", "--gp-model", "{npz}"],
    FLY + ["--controller", "gp-mpc", "--gp-model", "{dir}/missing.npz"],
    FLY + ["--controller", "gp-mpc", "--gp-data", "{dir}/none/*.csv"],
    FLY + ["--controller", "gp-mpc", "--gp-mode", "output", "--noisy", "--gp-data", "{glob}"],
    FLY + ["--controller", "gp-mpc", "--fast", "--gp-model", "{perdim}"],
    FLY + ["--controller", "gp-mpc", "--gp-mode", "output", "--gp-model", "{perdim}"],
    ["mission", "--duration", "5", "--disturbance-observer"],
    ["train-gp", "--data", "{dir}/none/*.csv"],
    ["montecarlo", "--controller", "gp-mpc", "--gp-data", "{dir}/none/*.csv"],
    ["evaluate-gp", "--model", "{perdim}", "--data", "{csv}"],
]


@pytest.mark.parametrize("argv", GUARDS, ids=[" ".join(a[5:] if a[0] == "fly" else a[:2])
                                              for a in GUARDS])
def test_every_guard_returns_1_in_both_and_calls_nothing(argv, files, monkeypatch):
    argv = fill(argv, files)
    names = patched_for(None)
    assert run(JAX_PKG, jax_main, argv, names, monkeypatch) == (1, [])
    assert run(PORT_PKG, port_main, argv + ["--device", "cpu"], names, monkeypatch) == (1, [])


F3 = [
    (FLY + ["--controller", "ltv12", "--noisy", "--wind", "1", "0", "0",
            "--gust", "1", "0", "0", "0"], "noisy_ltv"),
    (FLY + ["--controller", "direct-rate12", "--push", "1", "0", "0"], "DirectRateMPC"),
]


@pytest.mark.parametrize("argv, jax_callee", F3, ids=["ltv12-gust", "direct-rate12-push"])
def test_f3_flags_the_jax_command_line_ignores_are_rejected(argv, jax_callee, files,
                                                             monkeypatch, capsys):
    """The JAX command line passes both guards and flies (its callee is
    reached: it would exit 0 with the flag dropped); the port exits 1 with
    a message that says what the flag needs, and calls nothing."""
    names = patched_for(jax_callee)
    rc_j, calls_j = run(JAX_PKG, jax_main, argv, names, monkeypatch)
    assert rc_j is None and [c[0] for c in calls_j] == [jax_callee]
    capsys.readouterr()
    assert run(PORT_PKG, port_main, argv + ["--device", "cpu"], list(ALL), monkeypatch) == (1, [])
    err = capsys.readouterr().err
    assert ("--gust" in err and "wind" in err) if "--gust" in argv else "--noisy" in err


STAGED = [("fly-pid", "pid"), ("fly-mpc-staged", "mpc"), ("fly-mpc-noisy", "noisy"),
          ("mission", "mission"), ("online", "online"),
          ("tune-pid", "tune_pid"), ("montecarlo-mpc", "mc_mpc"), ("montecarlo-pid", "mc_pid")]


@pytest.mark.parametrize("case, callee", STAGED, ids=[c[0] for c in STAGED])
def test_the_staged_paths_route_through_the_kernels(case, callee, files, monkeypatch):
    """Where the JAX command line flies a staged path, the port's configs
    turn on the plant kernels and the fused controller kernel."""
    argv = fill(dict((c[0], c[1]) for c in CASES)[case], files)
    _, calls = run(PORT_PKG, port_main, argv + ["--device", "cpu"], patched_for(callee),
                   monkeypatch)
    args = calls[0][1]
    loop = args.get("loop_cfg") or args["cfg"]
    loop = getattr(loop, "flight", loop)   # online: the loop config inside its own
    assert loop.use_pallas_plant
    if "mpc" in args:
        assert args["mpc"].config.use_fused_controller


def test_dispatch_table_covers_every_command_and_fly_branch():
    commands = {c[1][0] for c in CASES}
    assert commands == {"train-gp", "evaluate-gp", "fly", "mission", "online", "analyze",
                        "compare", "sweep", "tune", "montecarlo"}
    controllers = {c[1][c[1].index("--controller") + 1] for c in CASES if c[1][0] == "fly"}
    assert controllers == {"pid", "mpc", "gp-mpc", "mpc12", "direct-rate12", "ilqr12", "mppi12",
                           "ltv12"}
    assert len(CASES) >= 40
