"""Port parity for the sweeps of ``parallel/sweep.py`` and the mesh helpers
against the JAX package on the CPU: the cases of the JAX package's
``tests/test_parallel.py`` at horizon 5, 20 ticks, B = 4 and 8.

The port runs each case in its world of one and, for the reductions over
ranks, in a gloo world of two (``torch.multiprocessing`` "spawn", a
``FileStore`` under the test's temporary directory, spawned once); the JAX
package on its mesh of two virtual CPU devices.

Tolerances: flights in float32 within 1e-4 m per flight of the JAX
package's (the online-flight bar of the other sweep tests); the port's
sharded flight sweep equal to its flights flown one by one; the structured
sweep within 5e-4 m of the staged flights (the JAX test's bar: the fused
and the staged controllers round differently); the world of two within
1e-6 m of the world of one (each rank's batch is another width); the
hyperparameter search's scores within 1e-6 relative (the JAX test's data
is float32, and so are the targets' normalisation statistics, summed in
another order by each package; the fit itself works in float64).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp import GPParams as JParams
from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig as JLoop, mpc_flight_rollout as j_rollout
from unmanned_aerial_vehicles_tpu.parallel import (
    hyperparameter_search_step as j_search,
    make_mesh as j_mesh,
    sharded_flight_sweep as j_sweep,
    sharded_structured_flight_sweep as j_structured,
)
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference as j_fig8
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp import GPParams
from unmanned_aerial_vehicles_tpu_torch.gp.kernels import rbf_kernel
from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig, mpc_flight_rollout
from unmanned_aerial_vehicles_tpu_torch.parallel import (
    SweepResult,
    hyperparameter_search_step,
    make_mesh,
    shard_batch,
    sharded_flight_sweep,
    sharded_structured_flight_sweep,
    structured_flight_sweep,
)
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

torch.set_num_threads(1)

HORIZON, ITERATIONS, T = 5, 15, 20
B_FLIGHTS, B_STRUCTURED = 4, 8
LS_GRID = (0.05, 0.2, 0.8, 3.0, 10.0, 30.0, 100.0, 300.0)
FLIGHT_TOL_M = 1e-4
STRUCTURED_TOL_M = 5e-4
WORLD_TOL_M = 1e-6
SEARCH_RTOL = 1e-6


def t_ref(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=2.0, frequency=0.05)
    return pos + torch.tensor([0.0, 0.0, 3.0], dtype=pos.dtype), yaw


def j_ref(t):
    pos, yaw = j_fig8(t, amplitude=2.0, frequency=0.05)
    return pos + jnp.array([0.0, 0.0, 3.0], pos.dtype), yaw


def starts(B):
    s = np.zeros((B, 12), np.float32)
    s[:, 2] = 3.0
    s[:, 0] = np.linspace(-0.5, 0.5, B, dtype=np.float32)
    return s


def search_data():
    """A GP draw of known length scale 0.8 (float32 inputs, as the JAX test)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    K = rbf_kernel(torch.from_numpy(X).double(), torch.from_numpy(X).double(),
                   torch.tensor(0.8, dtype=torch.float64)) + 0.01 * torch.eye(64, dtype=torch.float64)
    Y = (torch.linalg.cholesky(K) @ torch.from_numpy(rng.normal(size=(64, 2)))).numpy()
    return X, Y.astype(np.float32)


def port_mpc(fused: bool):
    return LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ITERATIONS,
                                     use_fused_controller=fused), device="cpu")


def one_flight(mpc):
    return lambda x0: mpc_flight_rollout(mpc, t_ref, T, cfg=FlightLoopConfig(),
                                         initial_state=x0, device="cpu")


def port_cases(mesh) -> dict:
    """Every sweep on ``mesh``: numpy results."""
    staged, fused = port_mpc(False), port_mpc(True)
    flights = sharded_flight_sweep(mesh, one_flight(staged), torch.from_numpy(starts(B_FLIGHTS)))
    structured = sharded_structured_flight_sweep(
        mesh, fused, t_ref, T, torch.from_numpy(starts(B_STRUCTURED)), cfg=FlightLoopConfig())
    staged8 = sharded_flight_sweep(mesh, one_flight(staged), torch.from_numpy(starts(B_STRUCTURED)))
    X, Y = search_data()
    cands = GPParams(*(torch.stack(v) for v in zip(*(
        GPParams.create(ls, 1.0, 0.01, device="cpu") for ls in LS_GRID))))
    search = hyperparameter_search_step(mesh, cands, *(torch.from_numpy(a) for a in
                                                        (X[:48], Y[:48], X[48:], Y[48:])))
    out = {f"flights_{k}": v for k, v in flights.items()}
    out.update({f"structured_{k}": v for k, v in structured.items()})
    out["staged8_rms_per_flight"] = staged8["rms_per_flight"]
    out.update(search_best=search.best_index, search_mse=search.val_mse, search_lml=search.lml,
               search_ls=search.best_params.length_scale, world=torch.tensor(mesh.world_size),
               rows=shard_batch(torch.arange(B_FLIGHTS * 3.0).reshape(B_FLIGHTS, 3), mesh))
    return {k: v.detach().numpy() for k, v in out.items()}


def _gloo_worker(rank: int, world: int, store_path: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **port_cases(make_mesh(device="cpu")))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """``{1: [results], 2: [rank 0's, rank 1's]}``; the gloo world runs
    while this process flies the world of one."""
    tmp = tmp_path_factory.mktemp("gloo_sweep")
    gloo = mp.spawn(_gloo_worker, args=(2, str(tmp / "store"), str(tmp)), nprocs=2, join=False)
    one = [port_cases(make_mesh(device="cpu"))]
    while not gloo.join():
        pass
    return {1: one, 2: [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]}


@pytest.fixture(scope="module")
def jax_runs():
    mesh = j_mesh(2)
    kw = dict(horizon=HORIZON, admm_iterations=ITERATIONS)
    staged, fused = JMPC(JCfg(**kw)), JMPC(JCfg(**kw, use_fused_controller=True))
    flight = lambda x0: j_rollout(staged, j_ref, num_steps=T, cfg=JLoop(), initial_state=x0)
    flights = j_sweep(mesh, flight, jnp.asarray(starts(B_FLIGHTS)))
    structured = j_structured(mesh, fused, j_ref, T, jnp.asarray(starts(B_STRUCTURED)),
                              cfg=JLoop())
    X, Y = search_data()
    cands = jax.vmap(lambda l: JParams.create(l, 1.0, 0.01))(jnp.asarray(LS_GRID))
    search = j_search(mesh, cands, *(jnp.asarray(a) for a in (X[:48], Y[:48], X[48:], Y[48:])))
    return {"flights": {k: np.asarray(v) for k, v in flights.items()},
            "structured": {k: np.asarray(v) for k, v in structured.items()},
            "search": search}


WORLDS = pytest.mark.parametrize("world", [1, 2])


@WORLDS
def test_mesh_spans_the_world(port_runs, world):
    for rank, got in enumerate(port_runs[world]):
        assert int(got["world"]) == world
        per = B_FLIGHTS // world
        np.testing.assert_array_equal(got["rows"], np.arange(B_FLIGHTS * 3.0).reshape(-1, 3)
                                      [rank * per:(rank + 1) * per])


def test_shard_batch_refuses_a_batch_the_world_does_not_divide():
    mesh = make_mesh(device="cpu")._replace(world_size=2, rank=1)
    np.testing.assert_array_equal(shard_batch(torch.arange(4.0), mesh).numpy(), [2.0, 3.0])
    with pytest.raises(ValueError, match="divide"):
        shard_batch(torch.zeros(3, 12), mesh)


@WORLDS
def test_hyperparameter_search_step_finds_best(port_runs, jax_runs, world):
    want = jax_runs["search"]
    for got in port_runs[world]:
        assert int(got["search_best"]) == int(want.best_index)
        assert LS_GRID[int(got["search_best"])] in (0.2, 0.8, 3.0)
        for key, field in (("search_mse", "val_mse"), ("search_lml", "lml")):
            np.testing.assert_allclose(got[key], np.asarray(getattr(want, field)),
                                       rtol=SEARCH_RTOL)
        np.testing.assert_allclose(got["search_ls"], float(want.best_params.length_scale),
                                   rtol=1e-12)


@WORLDS
def test_sharded_flight_sweep_matches_single_flights(port_runs, jax_runs, world):
    staged = port_mpc(False)
    x0s = torch.from_numpy(starts(B_FLIGHTS))
    single = []
    for i in (0, B_FLIGHTS - 1):
        outs = one_flight(staged)(x0s[i])
        err = outs["pos_ref"] - outs["state"][:, 0:3]
        single.append(float(torch.sqrt(torch.mean(torch.sum(err**2, dim=-1)))))
    want = jax_runs["flights"]
    for got in port_runs[world]:
        rms = got["flights_rms_per_flight"]
        assert rms.shape == (B_FLIGHTS,)
        assert rms[0] == np.float32(single[0]) and rms[-1] == np.float32(single[1])
        np.testing.assert_allclose(rms, want["rms_per_flight"], rtol=0, atol=FLIGHT_TOL_M)
        np.testing.assert_allclose(got["flights_final_states"], want["final_states"], rtol=0,
                                   atol=FLIGHT_TOL_M * 10)
        np.testing.assert_allclose(float(got["flights_rms_mean"]), rms.mean(), rtol=1e-6)
        assert float(got["flights_rms_max"]) == rms.max()


@WORLDS
def test_sharded_structured_sweep_matches_staged_flights_and_jax(port_runs, jax_runs, world):
    want = jax_runs["structured"]
    for got in port_runs[world]:
        rms = got["structured_rms_per_flight"]
        np.testing.assert_allclose(rms, got["staged8_rms_per_flight"], rtol=0,
                                   atol=STRUCTURED_TOL_M)
        np.testing.assert_allclose(rms, want["rms_per_flight"], rtol=0, atol=FLIGHT_TOL_M)
        np.testing.assert_allclose(float(got["structured_rms_mean"]), rms.mean(), rtol=1e-6)
        assert abs(float(got["structured_rms_mean"]) - float(want["rms_mean"])) < FLIGHT_TOL_M
        assert float(got["structured_rms_max"]) == rms.max()


def test_world_of_two_reduces_as_the_world_of_one(port_runs):
    one = port_runs[1][0]
    for got in port_runs[2]:
        for key in ("flights_rms_per_flight", "structured_rms_per_flight", "flights_rms_mean",
                    "structured_rms_mean", "structured_rms_max", "flights_rms_max"):
            np.testing.assert_allclose(got[key], one[key], rtol=0, atol=WORLD_TOL_M)
        np.testing.assert_array_equal(got["search_mse"], one["search_mse"])


def test_one_card_sweep_is_the_sharded_sweep_on_a_world_of_one(port_runs):
    agg = structured_flight_sweep(port_mpc(True), t_ref, T, torch.from_numpy(starts(B_STRUCTURED)),
                                  device="cpu")
    one = port_runs[1][0]
    np.testing.assert_array_equal(agg["rms_per_flight"].numpy(), one["structured_rms_per_flight"])
    assert float(agg["rms_max"]) == float(one["structured_rms_max"])
    assert isinstance(SweepResult._fields, tuple)
