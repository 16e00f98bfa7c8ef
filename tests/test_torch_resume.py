"""Mid-flight resume of the multi-tick tier on the CPU: a flight stopped at
a launch boundary, saved with ``io.save_resume_state``, loaded and continued
is bit for bit the unbroken flight (online learning with the variance rows,
and a frozen GP); a checkpoint of another configuration or a tick off a
launch boundary raises ``ValueError`` as in the JAX package; and a flight
saved by the JAX package (its ``save_resume_state`` file) is carried across
exactly (``convert.flight_resume_state_from_numpy``) and continued by the
port within the flight bar of the JAX package's own continuation.

Tolerance: bit-exact for the port's own resumes (the same arithmetic on the
same carries); position gap 1e-4 m against the JAX package (the port's
flight bar: both fly float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig as JGPCfg
from unmanned_aerial_vehicles_tpu.io import save_resume_state as j_save
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig as JLoopCfg,
    OnlineFusedGPConfig as JOnline,
    mpc_flight_rollout as j_rollout,
)
from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams as JBody
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig, fit_residual_gp
from unmanned_aerial_vehicles_tpu_torch.io import load_resume_state, save_resume_state
from unmanned_aerial_vehicles_tpu_torch.loop import (
    FlightLoopConfig,
    OnlineFusedGPConfig,
    mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams

torch.set_num_threads(1)

N, K, T_HALF = 8, 4, 24
WIND = (0.8, 0.3, 0.0)
MPC_CFG = dict(horizon=N, admm_iterations=20, use_fused_controller=True)


def j_ref(t):
    return jnp.stack([1.5 * jnp.sin(0.5 * t), 1.5 * jnp.cos(0.5 * t), 3.0 + 0.0 * t]), \
        jnp.float32(0.0)


def t_ref(t):
    return torch.stack([1.5 * torch.sin(0.5 * t), 1.5 * torch.cos(0.5 * t), 3.0 + 0.0 * t],
                       dim=-1), 0.0 * t


def online_cfg():
    return OnlineFusedGPConfig(gp=ResidualGPConfig(max_data_points=32, residual_gain=1.0),
                               refit_every=16, min_samples=4)


def port_fly(T, mpc, **kw):
    return mpc_flight_rollout(mpc, t_ref, T, body=RigidBodyParams(wind=WIND),
                              cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=K),
                              gp_gain=1.0, device="cpu", **kw)


def frozen_posterior():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(24, 10)) * 0.5
    X[:, 2] += 3.0
    Y = 0.05 * rng.normal(size=(24, 6))
    return fit_residual_gp(torch.tensor(X, dtype=torch.float32),
                           torch.tensor(Y, dtype=torch.float32))


@pytest.mark.parametrize("mode", ["online_tightened", "frozen_gp"])
def test_saved_and_loaded_flight_resumes_bit_exactly(tmp_path, mode):
    kappa = 2.0 if mode == "online_tightened" else 0.0
    mpc = LinearMPC(LinearMPCConfig(tightening_factor=kappa, **MPC_CFG), device="cpu")
    kw = (dict(online_gp=online_cfg()) if mode == "online_tightened"
          else dict(gp_posterior=frozen_posterior()))
    full = port_fly(2 * T_HALF, mpc, **kw)
    seg1, rs = port_fly(T_HALF, mpc, return_resume=True, **kw)
    assert rs.tick == T_HALF
    assert rs.meta == (N, K, 32 if mode == "online_tightened" else 0, kappa > 0, False)
    path = tmp_path / "resume.npz"
    save_resume_state(path, rs)
    rs2 = load_resume_state(path, device="cpu")
    assert rs2.tick == T_HALF and rs2.meta == rs.meta
    if mode == "online_tightened":
        assert rs2.carry[6].kinv is not None and rs2.carry[5] is not None
    else:
        assert rs2.carry[6].kinv is None and rs2.carry[5] is None
    seg2 = port_fly(T_HALF, mpc, resume=rs2, **kw)
    for key in ("state", "u_mpc", "pos_ref"):
        assert torch.equal(torch.cat([seg1[key], seg2[key]]), full[key]), key
    assert torch.equal(seg2["final_state"], full["final_state"])
    if mode == "online_tightened":
        assert torch.equal(torch.cat([seg1["gp_count"], seg2["gp_count"]]), full["gp_count"])
        assert int(seg2["gp_count"][-1]) > int(seg1["gp_count"][-1])


def test_resume_refuses_another_configuration_or_a_tick_off_a_boundary():
    mpc = LinearMPC(LinearMPCConfig(**MPC_CFG), device="cpu")
    _, rs = port_fly(K, mpc, online_gp=online_cfg(), return_resume=True)
    other = LinearMPC(LinearMPCConfig(**dict(MPC_CFG, horizon=6)), device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        port_fly(K, other, online_gp=online_cfg(), resume=rs)
    with pytest.raises(ValueError, match="mismatch"):
        port_fly(K, LinearMPC(LinearMPCConfig(tightening_factor=1.0, **MPC_CFG), device="cpu"),
                 online_gp=online_cfg(), resume=rs)
    with pytest.raises(ValueError, match="dispatch boundary"):
        port_fly(K, mpc, online_gp=online_cfg(), resume=rs._replace(tick=K + 1))


def test_flight_saved_by_jax_resumes_in_the_port(tmp_path):
    kappa = 2.0
    jm = JMPC(JCfg(tightening_factor=kappa, **MPC_CFG))
    jkw = dict(body=JBody(wind=WIND), cfg=JLoopCfg(use_fused_tick=True, ticks_per_dispatch=K),
               online_gp=JOnline(gp=JGPCfg(max_data_points=32, residual_gain=1.0),
                                 refit_every=16, min_samples=4),
               gp_gain=1.0)
    _, jrs = j_rollout(jm, j_ref, T_HALF, return_resume=True, **jkw)
    jseg2 = j_rollout(jm, j_ref, T_HALF, resume=jrs, **jkw)
    path = tmp_path / "jax_resume.npz"
    j_save(str(path), jrs)
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(int(data["__n_leaves__"]))]
        rs = convert.flight_resume_state_from_numpy(leaves, int(data["__tick__"]),
                                                    data["__meta__"], N, device="cpu")
    assert rs.tick == T_HALF and rs.meta == tuple(int(v) for v in jrs.meta)
    # carried across exactly: the float32 carries, the ring buffer, K^-1
    state, aux, xtail, z, y, dataset, gp = rs.carry
    m = N * 10
    jstate, jaux, jxtail, jz, jy, jds, jgp = jrs.carry
    for got, want in ((state, np.asarray(jstate)[0, :12]), (xtail, np.asarray(jxtail)[0, :N * 6]),
                      (z, np.asarray(jz)[0, :m]), (y, np.asarray(jy)[0, :m]),
                      (aux, np.concatenate([np.asarray(jaux)[0, :6], np.asarray(jaux)[0, 8:11]])),
                      (dataset.X, np.asarray(jds.X)), (dataset.Y, np.asarray(jds.Y)),
                      (gp.kinv, np.asarray(jgp.kinv)), (gp.y_std, np.asarray(jgp.y_std_row)[0, :6])):
        np.testing.assert_array_equal(got.numpy(), want)
    assert (int(dataset.count), int(dataset.head)) == (int(jds.count), int(jds.head))

    mpc = LinearMPC(LinearMPCConfig(tightening_factor=kappa, **MPC_CFG), device="cpu")
    seg2 = port_fly(T_HALF, mpc, online_gp=online_cfg(), resume=rs)
    np.testing.assert_array_equal(seg2["gp_count"].numpy(), np.asarray(jseg2["gp_count"]))
    gap = np.max(np.abs(seg2["state"][:, 0:3].numpy() - np.asarray(jseg2["state"][:, 0:3])))
    assert gap <= 1e-4, gap
    # the port's own checkpoint of the carried-across state resumes bit for bit
    port_path = tmp_path / "port_resume.npz"
    save_resume_state(port_path, rs)
    again = port_fly(T_HALF, mpc, online_gp=online_cfg(),
                     resume=load_resume_state(port_path, device="cpu"))
    assert torch.equal(again["state"], seg2["state"])
