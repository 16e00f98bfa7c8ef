"""Port parity for the row-sharded full-corpus GP (``parallel.distributed_gp``)
and the mesh helpers (``parallel.sharding``) against the JAX package on the
CPU.

The port's collectives run for real: one gloo world of two processes is
spawned once for the module (``torch.multiprocessing`` "spawn", a
``FileStore`` under the test's temporary directory) and held against a JAX
mesh of two virtual CPU devices; the port's world of one (no process group)
is held against a JAX mesh of one. The corpus is seeded numpy data at the
JAX tests' widths: 301 rows (odd, so that a world of two pads a row and the
mask is exercised), d = 10 inputs, 6 outputs, float64.

Cases, on both worlds: the fit's ``alpha`` and posterior mean, the host
view; mean and variance; the exact-trace LML gradient (isotropic); a JAX
posterior carried across (``convert``) predicting the same; the CG on a
known system; the Nystrom preconditioner cutting the residual at a fixed
iteration count. On the world of two also: the exact-trace ARD gradient;
gradients on the JAX run's own Rademacher probes; three Adam steps fed each
step's JAX probes (replayed from the JAX function's key splits); the
per-dimension fit. Tolerance: 1e-9 of each output's scale (max abs
difference over max abs value) in float64; float32 through the K15
wrapper's CPU route within 1e-4 of the JAX package's float32 fit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from unmanned_aerial_vehicles_tpu.gp import GPParams as JParams
from unmanned_aerial_vehicles_tpu.gp.per_dim import default_per_dim_params as j_per_dim_params
from unmanned_aerial_vehicles_tpu.parallel import (
    fit_per_dim_gp_sharded as j_fit_per_dim,
    fit_residual_gp_sharded as j_fit,
    lml_grad_sharded as j_grad,
    make_mesh as j_mesh,
    optimize_hyperparameters_sharded as j_adam,
    predict_mean_sharded as j_mean,
    predict_per_dim_sharded as j_predict_per_dim,
    predict_sharded as j_predict,
)
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.gp import GPParams
from unmanned_aerial_vehicles_tpu_torch.parallel import (
    batch_sharding,
    fit_per_dim_gp_sharded,
    fit_residual_gp_sharded,
    lml_grad_sharded,
    make_mesh,
    optimize_hyperparameters_sharded,
    predict_mean_sharded,
    predict_per_dim_sharded,
    predict_sharded,
    replicated_sharding,
    shard_batch,
)
from unmanned_aerial_vehicles_tpu_torch.parallel import distributed_gp as dgp
from unmanned_aerial_vehicles_tpu_torch.parallel.sharding import gather_rows, pmax, psum

torch.set_num_threads(1)

N_ROWS, D, OUT = 301, 10, 6
# one CG length for every solve, so that the JAX package compiles each
# program once per mesh (the Nystrom preconditioner, 256 anchors of 301
# rows, converges the fits within it)
ITERS = 60
# the per-dimension variance is an unpreconditioned CG on a diagonal of
# 0.01: short of convergence its iterates carry the two packages' rounding
# far apart, so it runs to convergence (the JAX tests' length)
PER_DIM_ITERS = 250
ADAM_STEPS, ADAM_LR, PROBES = 3, 0.1, 16
PER_DIM_OUT = 2
REL64 = 1e-9
REL32 = 1e-4
GRAD_FIELDS = ("log_length_scale", "log_signal_variance", "log_noise_variance")


def corpus():
    """Smooth flight-like inputs (neighbouring rows close, as in a flight
    log) and smooth residual-like outputs plus noise."""
    rng = np.random.default_rng(21)
    t = np.linspace(0.0, 6.0, N_ROWS)
    X = np.column_stack([(1 + 0.1 * k) * np.sin(t + k) for k in range(D)])
    X = X + 0.3 * rng.normal(size=(N_ROWS, D))
    Y = np.column_stack([np.cos(X[:, k]) + 0.1 * rng.normal(size=N_ROWS) for k in range(OUT)])
    return X, Y


def per_dim_params():
    p = j_per_dim_params(D, PER_DIM_OUT)
    return p.replace(
        log_length_scale=p.log_length_scale + jnp.linspace(-0.3, 0.3, PER_DIM_OUT)[:, None],
        log_noise_variance=p.log_noise_variance + jnp.linspace(0.0, 0.5, PER_DIM_OUT),
    )


ISO = (0.7, 1.3, 0.15)
ARD = (np.linspace(0.4, 1.5, D), 1.3, 0.15)
ADAM_START = (3.0, 0.2, 0.5)


def known_system():
    rng = np.random.default_rng(0)
    n = 64
    A_half = rng.normal(size=(n, n))
    return A_half @ A_half.T + n * np.eye(n), rng.normal(size=(n, 3))


def close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= rel, f"{what}: {err:.3e} of scale > {rel}"


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------


def jax_inputs(world: int) -> dict:
    """Everything the port needs from the JAX run of a mesh of ``world``:
    the corpus, the JAX probes and the JAX posterior's arrays."""
    X, Y = corpus()
    n_pad = -(-N_ROWS // world) * world
    probes = np.asarray(jax.random.rademacher(jax.random.PRNGKey(3), (n_pad, PROBES),
                                              dtype=jnp.float64))
    key, adam_probes = jax.random.PRNGKey(0), []
    for _ in range(ADAM_STEPS):
        key, sub = jax.random.split(key)
        adam_probes.append(np.asarray(jax.random.rademacher(sub, (n_pad, PROBES),
                                                            dtype=jnp.float64)))
    post = j_fit(X, Y, mesh=j_mesh(world), cg_iterations=ITERS)
    pp = per_dim_params()
    A, b = known_system()
    model = j_fit_per_dim(X, Y[:, :PER_DIM_OUT], mesh=j_mesh(world), params=pp,
                          cg_iterations=PER_DIM_ITERS)
    carried_per_dim = {f"pdj{i}_{k}": np.asarray(v) for i, p in enumerate(model.posteriors)
                       for k, v in _fields(p).items()}
    return dict(
        **carried_per_dim, pdj_x_mean=np.asarray(model.x_mean), pdj_x_std=np.asarray(model.x_std),
        X=X, Y=Y, probes=probes, adam_probes=np.stack(adam_probes),
        pd_ls=np.asarray(pp.log_length_scale), pd_sf=np.asarray(pp.log_signal_variance),
        pd_sn=np.asarray(pp.log_noise_variance),
        **{f"j_{k}": v for k, v in _fields(post).items()}, A=A, b=b,
    )


def _fields(post) -> dict:
    """A JAX ``ShardedGPPosterior``'s fields as numpy (``convert``'s keys)."""
    names = ("X_train", "mask", "alpha", "y_mean", "y_std", "cg_residual")
    out = {k: np.asarray(getattr(post, k)) for k in names}
    out.update(log_length_scale=np.asarray(post.params.log_length_scale),
               log_signal_variance=np.asarray(post.params.log_signal_variance),
               log_noise_variance=np.asarray(post.params.log_noise_variance))
    return out


def jax_results(world: int, inputs: dict) -> dict:
    """The JAX package's results on a mesh of ``world``: every case on the
    mesh of two, the core cases (fit, prediction, exact isotropic
    gradient) on the mesh of one."""
    mesh = j_mesh(world)
    X, Y = inputs["X"], inputs["Y"]
    post = j_fit(X, Y, mesh=mesh, cg_iterations=ITERS)
    view = post.to_gp_posterior()
    mean, var = j_predict(post, X[::41], mesh=mesh, cg_iterations=ITERS)
    out = dict(
        fit_alpha=post.alpha, fit_mean=j_mean(post, X[::17], mesh=mesh),
        view_X=view.X_train, view_alpha=view.alpha, pred_mean=mean, pred_var=var,
    )
    for label, args in (("iso", ISO), ("ard", ARD))[:2 if world == 2 else 1]:
        g = j_grad(JParams.create(*args), X, Y, mesh=mesh, exact_trace=True,
                   cg_iterations=ITERS)
        out.update({f"g_{label}_{f}": getattr(g, f) for f in GRAD_FIELDS})
    if world == 1:
        return {k: np.asarray(v) for k, v in out.items()}
    g = j_grad(JParams.create(*ISO), X, Y, mesh=mesh, num_probes=PROBES,
               cg_iterations=ITERS, key=jax.random.PRNGKey(3))
    out.update({f"g_probes_{f}": getattr(g, f) for f in GRAD_FIELDS})
    p = j_adam(JParams.create(*ADAM_START), X, Y, mesh=mesh, steps=ADAM_STEPS,
               learning_rate=ADAM_LR, num_probes=PROBES, cg_iterations=ITERS,
               key=jax.random.PRNGKey(0))
    out.update({f"adam_{f}": getattr(p, f) for f in GRAD_FIELDS})
    model = j_fit_per_dim(X, Y[:, :PER_DIM_OUT], mesh=mesh, params=per_dim_params(),
                          cg_iterations=PER_DIM_ITERS)
    out["pd_mean"], out["pd_var"] = j_predict_per_dim(model, X[::23], mesh=mesh,
                                                      cg_iterations=PER_DIM_ITERS)
    return {k: np.asarray(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# The port's side: the same calls on a mesh of the port (a world of one in
# this process, or each rank of the gloo world)
# ---------------------------------------------------------------------------


def port_results(inp: dict, mesh, full: bool = True) -> dict:
    """The port's results on ``mesh``: every case, or (``full=False``) the
    core cases of ``jax_results``."""
    X, Y = inp["X"], inp["Y"]
    fields = lambda prefix: {k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)}
    post = fit_residual_gp_sharded(X, Y, mesh=mesh, cg_iterations=ITERS)
    view = post.to_gp_posterior(mesh)
    mean, var = predict_sharded(post, X[::41], mesh=mesh, cg_iterations=ITERS)
    out = dict(
        fit_alpha=gather_rows(post.alpha, mesh), fit_residual=post.cg_residual,
        fit_mean=predict_mean_sharded(post, X[::17], mesh=mesh),
        view_X=view.X_train, view_alpha=view.alpha, pred_mean=mean, pred_var=var,
    )
    for label, args in (("iso", ISO), ("ard", ARD))[:2 if full else 1]:
        g = lml_grad_sharded(GPParams.create(*args, device="cpu"), X, Y, mesh=mesh,
                             exact_trace=True, cg_iterations=ITERS)
        out.update({f"g_{label}_{f}": getattr(g, f) for f in GRAD_FIELDS})
    if full:
        g = lml_grad_sharded(GPParams.create(*ISO, device="cpu"), X, Y, mesh=mesh,
                             cg_iterations=ITERS, probes=inp["probes"])
        out.update({f"g_probes_{f}": getattr(g, f) for f in GRAD_FIELDS})
        p = optimize_hyperparameters_sharded(
            GPParams.create(*ADAM_START, device="cpu"), X, Y, mesh=mesh, steps=ADAM_STEPS,
            learning_rate=ADAM_LR, num_probes=PROBES, cg_iterations=ITERS,
            probes=inp["adam_probes"])
        out.update({f"adam_{f}": getattr(p, f) for f in GRAD_FIELDS})
        params = convert.gp_params_from_numpy(inp["pd_ls"], inp["pd_sf"], inp["pd_sn"], "cpu")
        model = fit_per_dim_gp_sharded(X, Y[:, :PER_DIM_OUT], mesh=mesh, params=params,
                                       cg_iterations=PER_DIM_ITERS)
        out["pd_mean"], out["pd_var"] = predict_per_dim_sharded(
            model, X[::23], mesh=mesh, cg_iterations=PER_DIM_ITERS)
        jmodel = convert.per_dim_sharded_gp_from_numpy(
            [fields(f"pdj{i}_") for i in range(PER_DIM_OUT)], inp["pdj_x_mean"],
            inp["pdj_x_std"], mesh)
        out["pdj_mean"], out["pdj_var"] = predict_per_dim_sharded(
            jmodel, X[::23], mesh=mesh, cg_iterations=PER_DIM_ITERS)
    carried = convert.sharded_gp_posterior_from_numpy(fields("j_"), mesh)
    out["carried_mean"], out["carried_var"] = predict_sharded(
        carried, X[::41], mesh=mesh, cg_iterations=ITERS)
    # the CG on a known SPD system, the rows split over the ranks
    rows = slice(mesh.rank * 64 // mesh.world_size, (mesh.rank + 1) * 64 // mesh.world_size)
    A_loc = torch.as_tensor(inp["A"][rows])
    x, res = dgp._cg(lambda v: A_loc @ gather_rows(v, mesh), lambda r: r,
                     torch.as_tensor(inp["b"][rows]), 200, mesh)
    out["cg_x"], out["cg_res"] = gather_rows(x, mesh), res
    # 12 iterations with 128 anchors against plain CG (one anchor)
    for label, m in (("nystrom", 128), ("plain", 1)):
        out[f"res12_{label}"] = fit_residual_gp_sharded(
            X, Y, mesh=mesh, cg_iterations=12, precond_size=m).cg_residual
    # the collectives themselves
    out["psum_rank"] = psum(torch.tensor(float(mesh.rank + 1)), mesh)
    out["pmax_rank"] = pmax(torch.tensor(float(mesh.rank)), mesh)
    out["rows"] = shard_batch(torch.arange(8.0)[:, None], mesh)
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def _gloo_worker(rank: int, world: int, store_path: str, inputs_path: str, out_dir: str):
    """One rank of the gloo world: the port's results on this rank."""
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        inp = dict(np.load(inputs_path))
        out = port_results(inp, make_mesh(device="cpu"))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{world: (jax results, port results by rank)}`` for worlds 1 and 2;
    the gloo world runs while this process computes the rest."""
    inputs = {world: jax_inputs(world) for world in (1, 2)}
    tmp = tmp_path_factory.mktemp("gloo")
    np.savez(tmp / "inputs.npz", **inputs[2])
    gloo = mp.spawn(_gloo_worker, args=(2, str(tmp / "store"), str(tmp / "inputs.npz"),
                                        str(tmp)), nprocs=2, join=False)
    one = [port_results(inputs[1], make_mesh(device="cpu"), full=False)]
    want = {world: jax_results(world, inputs[world]) for world in (1, 2)}
    while not gloo.join():
        pass
    two = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return {1: (want[1], one), 2: (want[2], two)}


WORLDS = pytest.mark.parametrize("world", [1, 2])
WORLD_OF_TWO = pytest.mark.parametrize("world", [2])   # the full set runs on the world of two


@WORLDS
def test_fit_alpha_and_mean_match_jax(runs, world):
    want, ports = runs[world]
    for got in ports:
        close(got["fit_alpha"], want["fit_alpha"], REL64, "alpha")
        close(got["fit_mean"], want["fit_mean"], REL64, "posterior mean")
        assert float(got["fit_residual"]) < 1e-10
        close(got["view_X"], want["view_X"], 0.0, "host view X")
        close(got["view_alpha"], want["view_alpha"], REL64, "host view alpha")


@WORLDS
def test_mean_and_variance_match_jax(runs, world):
    want, ports = runs[world]
    for got in ports:
        close(got["pred_mean"], want["pred_mean"], REL64, "mean")
        close(got["pred_var"], want["pred_var"], REL64, "variance")


@pytest.mark.parametrize("world,kind", [(1, "iso"), (2, "iso"), (2, "ard")])
def test_exact_trace_gradients_match_jax(runs, world, kind):
    want, ports = runs[world]
    for got in ports:
        for f in GRAD_FIELDS:
            close(got[f"g_{kind}_{f}"], want[f"g_{kind}_{f}"], REL64, f)
    assert ports[0][f"g_{kind}_log_length_scale"].shape == ((D,) if kind == "ard" else ())


@WORLD_OF_TWO
def test_gradients_on_the_jax_probes_match(runs, world):
    want, ports = runs[world]
    for got in ports:
        for f in GRAD_FIELDS:
            close(got[f"g_probes_{f}"], want[f"g_probes_{f}"], REL64, f)


@WORLD_OF_TWO
def test_adam_steps_on_the_jax_probes_match(runs, world):
    want, ports = runs[world]
    for got in ports:
        for f in GRAD_FIELDS:
            close(got[f"adam_{f}"], want[f"adam_{f}"], REL64, f)
    assert abs(float(ports[0]["adam_log_length_scale"]) - np.log(ADAM_START[0])) > 0.1


@WORLD_OF_TWO
def test_per_dim_fit_matches_jax(runs, world):
    want, ports = runs[world]
    for got in ports:
        close(got["pd_mean"], want["pd_mean"], REL64, "per-dim mean")
        close(got["pd_var"], want["pd_var"], REL64, "per-dim variance")
        close(got["pdj_mean"], want["pd_mean"], REL64, "carried per-dim mean")
        close(got["pdj_var"], want["pd_var"], REL64, "carried per-dim variance")


@WORLDS
def test_carried_jax_posterior_predicts_the_same(runs, world):
    want, ports = runs[world]
    for got in ports:
        close(got["carried_mean"], want["pred_mean"], REL64, "mean")
        close(got["carried_var"], want["pred_var"], REL64, "variance")


@WORLDS
def test_cg_solves_a_known_system(runs, world):
    A, b = known_system()
    for got in runs[world][1]:
        np.testing.assert_allclose(got["cg_x"], np.linalg.solve(A, b), atol=1e-8)
        assert float(got["cg_res"]) < 1e-8


@WORLDS
def test_nystrom_preconditioner_cuts_the_residual(runs, world):
    for got in runs[world][1]:
        assert float(got["res12_nystrom"]) < float(got["res12_plain"]) / 10.0


def test_collectives_over_the_gloo_world(runs):
    ports = runs[2][1]
    for rank, got in enumerate(ports):
        assert float(got["psum_rank"]) == 3.0 and float(got["pmax_rank"]) == 1.0
        np.testing.assert_array_equal(got["rows"][:, 0], np.arange(4.0) + 4 * rank)
    for key in ("fit_alpha", "pred_var", "g_ard_log_length_scale", "pd_mean"):
        np.testing.assert_array_equal(ports[0][key], ports[1][key])


def test_world_of_one_mesh_and_its_checks():
    mesh = make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    assert batch_sharding(mesh).axis_name == "batch" and replicated_sharding(mesh).axis_name is None
    with pytest.raises(ValueError, match="requested 2 devices"):
        make_mesh(2, device="cpu")
    t = torch.arange(6.0)
    assert gather_rows(t, mesh) is t and psum(t, mesh) is t
    torch.testing.assert_close(shard_batch(t, mesh), t)


def test_float32_fit_goes_through_the_k15_wrapper(monkeypatch):
    """float32 takes K15's wrapper (its plain version for CPU tensors) for
    every Gram block, one call per tile of rows: the fit's block, W and C;
    prediction's block."""
    calls = []
    real = dgp.rbf_kernel_matrix_pallas
    monkeypatch.setattr(dgp, "rbf_kernel_matrix_pallas",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    X, Y = corpus()
    X32, Y32 = X.astype(np.float32), Y.astype(np.float32)
    post = fit_residual_gp_sharded(X32, Y32, device="cpu", cg_iterations=ITERS)
    mean = predict_mean_sharded(post, X32[::17])
    tiles = lambda n: -(-n // dgp.GRAM_SHIFT_ROWS)
    assert post.alpha.dtype == torch.float32
    assert len(calls) == 2 * tiles(N_ROWS) + tiles(256) + tiles(N_ROWS)
    jpost = j_fit(X32, Y32, mesh=j_mesh(1), cg_iterations=ITERS, dtype=jnp.float32)
    close(mean.numpy(), np.asarray(j_mean(jpost, X32[::17], mesh=j_mesh(1))), REL32, "mean")
    calls.clear()
    fit_residual_gp_sharded(X32, Y32, device="cpu", cg_iterations=4, plain_kernels=True)
    assert not calls
