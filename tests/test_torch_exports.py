"""The port's subpackages export what the JAX package's export, where the
port defines it.

Each JAX subpackage ``__init__.py`` is read as text (JAX is not imported)
and its relative imports parsed: for every name that one of them imports
from a module the port has, and that the port's module defines, the
port's matching subpackage must export it, so that code written against
the JAX package (``from ...control import pid_step``) runs on the port.
Names whose module the port has not ported or that the port's module
does not define are left out of that check; since every module is ported
(the command-line interface and ``__main__`` last), a second check requires
every exported name of every shared subpackage, a third that no JAX module
lacks a counterpart, and a fourth the names of the last modules ported (the
full-corpus GP, the sharded sweeps, the IO readers, the sklearn import, the
GP analysis, the plots, the profiling helpers).
"""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "unmanned_aerial_vehicles_tpu"
PORT_NAME = "unmanned_aerial_vehicles_tpu_torch"
PORT = REPO / PORT_NAME

# the JAX package's subpackages that the port has
SUBPACKAGES = ("control", "estimation", "gp", "io", "loop", "metrics", "models", "ops",
               "parallel", "trajectories", "tuning", "utils")


def jax_exports(sub: str) -> list[tuple[str, str, str]]:
    """``(module, name, exported name)`` for each name the JAX subpackage's
    ``__init__.py`` imports from one of its own modules."""
    tree = ast.parse((JAX_PKG / sub / "__init__.py").read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1 and node.module:
            out.extend((node.module, a.name, a.asname or a.name) for a in node.names)
    return out


def port_has_module(sub: str, module: str) -> bool:
    path = PORT / sub / Path(*module.split("."))
    return path.with_suffix(".py").exists() or (path / "__init__.py").exists()


def test_subpackage_list_is_every_shared_one():
    shared = {p.parent.name for p in JAX_PKG.glob("*/__init__.py")
              if (PORT / p.parent.name / "__init__.py").exists()}
    assert shared == set(SUBPACKAGES)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_subpackage_exports_the_jax_names_it_defines(sub):
    package = importlib.import_module(f"{PORT_NAME}.{sub}")
    missing, checked = [], 0
    for module, name, exported in jax_exports(sub):
        if not port_has_module(sub, module):
            continue
        defined = importlib.import_module(f"{PORT_NAME}.{sub}.{module}")
        if not hasattr(defined, name):
            continue
        checked += 1
        if getattr(package, exported, None) is not getattr(defined, name):
            missing.append(f"{module}.{name}")
    assert not missing, f"{PORT_NAME}.{sub} does not export {missing}"
    exported_all = getattr(package, "__all__", None)
    if exported_all is not None:
        assert not [n for n in exported_all if not hasattr(package, n)]


def test_f14_names_import():
    from unmanned_aerial_vehicles_tpu_torch.control import (  # noqa: F401
        CascadePidGains,
        CascadeState,
        PIDGains,
        PIDState,
        cascade_init,
        cascade_pid_step,
        pid_init,
        pid_step,
    )
    from unmanned_aerial_vehicles_tpu_torch.models import double_integrator_derivative  # noqa: F401
    from unmanned_aerial_vehicles_tpu_torch.ops import (  # noqa: F401
        admm_box_qp,
        admm_box_qp_chol,
        condense_dynamics,
        condense_ltv,
        condense_ltv_doubling,
    )


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_subpackage_exports_every_jax_name(sub):
    package = importlib.import_module(f"{PORT_NAME}.{sub}")
    missing = [f"{module}.{name}" for module, name, exported in jax_exports(sub)
               if not hasattr(package, exported)]
    assert not missing, f"{PORT_NAME}.{sub} does not export {missing}"


def test_every_jax_module_has_a_port_counterpart():
    jax_files = {p.relative_to(JAX_PKG) for p in JAX_PKG.rglob("*.py")}
    jax_files |= {p.relative_to(JAX_PKG) for p in (JAX_PKG / "native").glob("*.cpp")}
    missing = sorted(str(p) for p in jax_files if not (PORT / p).exists())
    assert missing == []


def test_new_names_import():
    from unmanned_aerial_vehicles_tpu_torch.gp import (  # noqa: F401
        analyze_gp_model,
        generate_generic_test_points,
        generate_physical_test_points,
    )
    from unmanned_aerial_vehicles_tpu_torch.io import (  # noqa: F401
        CSV_HEADER,
        UavLogWriter,
        analyze_flight_log,
        load_flight_log,
        load_gp_dataset,
        load_gp_datasets,
        load_numeric_csv,
        load_reference_gp,
        load_sklearn_gp_pickle,
        load_sklearn_perdim_pickle,
        native_available,
        read_uavlog,
        save_flight_log,
        save_gp_dataset,
        write_uavlog,
    )
    from unmanned_aerial_vehicles_tpu_torch.metrics import (  # noqa: F401
        plot_comparison,
        plot_flight_log,
        plot_robustness,
    )
    from unmanned_aerial_vehicles_tpu_torch.parallel import (  # noqa: F401
        PerDimShardedGP,
        ShardedGPPosterior,
        SweepResult,
        batch_sharding,
        fit_per_dim_gp_sharded,
        fit_residual_gp_sharded,
        hyperparameter_search_step,
        lml_grad_sharded,
        make_mesh,
        optimize_hyperparameters_sharded,
        predict_mean_sharded,
        predict_per_dim_sharded,
        predict_sharded,
        replicated_sharding,
        shard_batch,
        sharded_flight_sweep,
        sharded_structured_flight_sweep,
    )
    from unmanned_aerial_vehicles_tpu_torch.utils import (  # noqa: F401
        device_timeit,
        fast_examples,
        scaled,
        scan_slope_timeit,
        trace,
    )
