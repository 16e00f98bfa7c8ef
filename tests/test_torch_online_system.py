"""Port parity for the online GP-MPC system (``loop.full_system``) against
the JAX package on the CPU: fly, collect and refit in one loop, in float64
with the default configuration, with preview, with standardized-input
refits and with the MPC at a fifth of the tick rate; in float32 through
the port's K3 and K1 routes and through K6 (``use_fused_admm``), their
plain versions on the CPU, against the JAX package's staged float32
flight. The flights are 300 ticks with a 64-point ring refitted every 100
ticks: the ring fills and wraps, three refits happen.

Tolerances: float64 positions within 1e-8 m of the JAX package at every
tick, ``gp_count`` and ``gp_active`` equal, the final ring buffer within
1e-8 and the posterior's ``alpha`` within 1e-8 in the targets' units
(``alpha * y_std``: the position residuals' std is ~1e-9, so the
normalised targets of those columns carry the ring's rounding 1e7-fold);
float32 positions within 1e-4 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig as JGPCfg
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig as JLoopCfg,
    OnlineGPMPCConfig as JOnlineCfg,
    online_gp_mpc_rollout as j_online,
)
from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams as JBody
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference as j_fig8
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    OnlineGPMPCConfig,
    online_gp_mpc_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

torch.set_num_threads(1)

T, HORIZON, ITERS, RING, REFIT = 300, 10, 20, 64, 100
WIND = (0.8, 0.4, 0.0)
F64_TOL, F32_TOL_M = 1e-8, 1e-4
VARIANTS = {"default": {}, "preview": dict(preview=True),
            "standardized": dict(standardize_inputs=True), "mpc_every_5": dict(mpc_every=5)}


def j_ref(t):
    pos, yaw = j_fig8(t, 3.0, 0.05)
    return pos + jnp.asarray([0.0, 0.0, 3.0], pos.dtype), yaw


def t_ref(t):
    pos, yaw = ramped_figure8_reference(t, 3.0, 0.05)
    return pos + torch.tensor([0.0, 0.0, 3.0], dtype=pos.dtype), yaw


def j_fly(dtype, loop=None, **kw):
    cfg = JOnlineCfg(flight=JLoopCfg(**(loop or {})), gp=JGPCfg(max_data_points=RING),
                     gp_refit_every=REFIT, **kw)
    mpc = JMPC(JCfg(horizon=HORIZON, admm_iterations=ITERS), dtype=dtype)
    return jax.jit(lambda: j_online(mpc, j_ref, T, cfg=cfg, body=JBody(wind=WIND),
                                    dtype=dtype))()


def t_fly(dtype, loop=None, mpc_kw=None, **kw):
    cfg = OnlineGPMPCConfig(flight=FlightLoopConfig(**(loop or {})),
                            gp=ResidualGPConfig(max_data_points=RING), gp_refit_every=REFIT, **kw)
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ITERS, **(mpc_kw or {})),
                    dtype=dtype, device="cpu")
    return online_gp_mpc_rollout(mpc, t_ref, T, cfg=cfg, body=RigidBodyParams(wind=WIND),
                                 dtype=dtype, device="cpu")


def position_gap(got, want):
    return float(np.max(np.abs(got["state"][:, 0:3].numpy() - np.asarray(want["state"])[:, 0:3])))


@pytest.fixture(scope="module")
def jax_f32():
    return j_fly(jnp.float32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_online_system_float64_matches_jax(variant):
    (want, jds, jpost) = j_fly(jnp.float64, **VARIANTS[variant])
    got, ds, post = t_fly(torch.float64, **VARIANTS[variant])
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
    assert position_gap(got, want) <= F64_TOL
    np.testing.assert_array_equal(got["gp_count"].numpy(), np.asarray(want["gp_count"]))
    np.testing.assert_array_equal(got["gp_active"].numpy(), np.asarray(want["gp_active"]))
    assert int(ds.count) == int(jds.count) == RING and int(ds.head) == int(jds.head)
    for name in ("X", "Y"):
        np.testing.assert_allclose(getattr(ds, name).numpy(), np.asarray(getattr(jds, name)),
                                   rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(post.y_std.numpy(), np.asarray(jpost.y_std), rtol=1e-8, atol=0)
    np.testing.assert_allclose((post.alpha * post.y_std).numpy(),
                               np.asarray(jpost.alpha) * np.asarray(jpost.y_std),
                               rtol=0, atol=F64_TOL)
    assert not bool(got["gp_active"][0]) and bool(got["gp_active"][-1])


@pytest.mark.parametrize("route", ["staged", "k3_k1", "k6"])
def test_online_system_float32_matches_jax(jax_f32, route):
    """Float32 through the port's kernel routes: K3 solves and the K1 plant,
    or the staged solve's ADMM in K6, against the JAX staged flight."""
    loop = dict(use_pallas_plant=True) if route == "k3_k1" else None
    mpc_kw = {"staged": None, "k3_k1": dict(use_fused_controller=True),
              "k6": dict(use_fused_admm=True)}[route]
    got, ds, _ = t_fly(torch.float32, loop=loop, mpc_kw=mpc_kw)
    want, jds, _ = jax_f32
    assert got["state"].dtype == torch.float32
    assert np.all(np.isfinite(got["state"].numpy()))
    assert position_gap(got, want) <= F32_TOL_M
    np.testing.assert_array_equal(got["gp_count"].numpy(), np.asarray(want["gp_count"]))


def test_online_system_initial_dataset_and_state():
    """A flight repeats bit for bit, and continues from a given ring
    buffer and start with the GP trained from its first tick."""
    cfg = OnlineGPMPCConfig(gp=ResidualGPConfig(max_data_points=RING), gp_refit_every=50)
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ITERS),
                    dtype=torch.float64, device="cpu")
    outs, ds, _ = online_gp_mpc_rollout(mpc, t_ref, 100, cfg=cfg, dtype=torch.float64,
                                        device="cpu")
    again, ds2, _ = online_gp_mpc_rollout(mpc, t_ref, 100, cfg=cfg, dtype=torch.float64,
                                          device="cpu")
    assert torch.equal(outs["state"], again["state"]) and torch.equal(ds.X, ds2.X)
    cont, ds3, _ = online_gp_mpc_rollout(mpc, t_ref, 20, cfg=cfg, initial_state=outs["final_state"],
                                         initial_dataset=ds, dtype=torch.float64, device="cpu")
    assert int(ds3.count) >= int(ds.count) and bool(cont["gp_active"][0])
    assert np.all(np.isfinite(cont["state"].numpy()))


def test_online_system_hover_fallback_on_nonfinite_command():
    """A non-finite MPC command falls back to hover on the device."""
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ITERS),
                    dtype=torch.float64, device="cpu")
    solve = mpc.solve

    def broken(*args, **kw):
        u, X, carry = solve(*args, **kw)
        return torch.full_like(u, float("nan")), X, carry

    mpc.solve = broken
    outs, _, _ = online_gp_mpc_rollout(mpc, t_ref, 20, cfg=OnlineGPMPCConfig(),
                                       dtype=torch.float64, device="cpu")
    assert np.all(np.isfinite(outs["state"].numpy()))
    # hover: zero acceleration, so the thrust is the hover thrust at level attitude
    assert abs(float(outs["thrust"][0]) - float(outs["thrust"][1])) < 1e-6


def test_online_system_device_guard():
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON), device="cpu")
    mpc.device = torch.device("meta")
    with pytest.raises(ValueError, match="lives on"):
        online_gp_mpc_rollout(mpc, t_ref, 2, device="cpu")
