"""The port's subpackages export what the JAX package's export, where the
port defines it.

Each JAX subpackage ``__init__.py`` is read as text (JAX is not imported)
and its relative imports parsed: for every name that one of them imports
from a module the port has, and that the port's module defines, the
port's matching subpackage must export it, so that code written against
the JAX package (``from ...control import pid_step``) runs on the port.
Names whose module the port has not ported (``metrics.plots``) or that
the port's module does not define are left out.
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
