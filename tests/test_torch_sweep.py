"""Port parity for the throughput sweep: the plain versions of the
structured batched controller K8 and the fused GP posterior mean K7 (which
the wrappers run for CPU tensors), the batched horizon residuals, and
``batched_mpc_flight_sweep`` against the JAX package on the CPU, from
identical operands built by JAX and carried across with ``convert``.

Tolerances:
- K8 1e-5 on all six outputs: float32 on both sides, the products summed
  in different orders (~1e-7 relative each), 20 ADMM iterations amplify
  that by at most ~10x on O(1) iterates.
- K7 and the batched residuals 1e-6: the port computes in plain float32
  against the JAX kernel's "highest" tier and the float64 ``predict_mean``;
  outputs are O(0.1), where float32 rounds at ~1e-8.
- The sweep 1e-4 m on positions over 30 ticks, the bar of the online
  flight test; thrust 1e-4 (O(1) values through the same chain); the
  reference positions 1e-6 (the same float32 formula).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.exact_gp import predict_mean as j_predict_mean
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    ResidualDataset as JDataset,
    ResidualGPConfig as JGPCfg,
    build_horizon_residuals as j_residuals,
    build_horizon_residuals_batched_fused as j_residuals_fused,
    fit_residual_gp as j_fit,
    fit_residual_gp_masked as j_fit_masked,
)
from unmanned_aerial_vehicles_tpu.loop.closed_loop import (
    FlightLoopConfig as JLoopCfg,
    batched_mpc_flight_sweep as j_sweep,
)
from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams as JBody
from unmanned_aerial_vehicles_tpu.ops.controller_pallas import (
    build_structured_batch_data as j_sdata,
    gpmpc_controller_structured_batched as j_k8,
)
from unmanned_aerial_vehicles_tpu.ops.rbf_pallas import rbf_posterior_mean_pallas as j_k7
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference as j_fig8
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
    ResidualGPConfig,
    build_horizon_residuals,
    build_horizon_residuals_batched_fused,
)
from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig, batched_mpc_flight_sweep
from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.ops import controller_pallas, rbf_pallas
from unmanned_aerial_vehicles_tpu_torch.parallel import structured_flight_sweep
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

torch.set_num_threads(1)

N = 10
NNU, NNX = N * 4, N * 6
WIND = (0.8, 0.4, 0.0)


def j_ref(t):
    pos, yaw = j_fig8(t, 6.0, 0.02)
    return pos + jnp.asarray([0.0, 0.0, 3.0], pos.dtype), yaw


def t_ref(t):
    pos, yaw = ramped_figure8_reference(t, 6.0, 0.02)
    return pos + torch.tensor([0.0, 0.0, 3.0], dtype=pos.dtype), yaw


def port_posterior(jpost):
    a = lambda v: None if v is None else np.asarray(v)
    return convert.gp_posterior_from_numpy(
        a(jpost.X_train), a(jpost.chol), a(jpost.alpha), a(jpost.y_mean), a(jpost.y_std),
        a(jpost.params.length_scale), a(jpost.params.signal_variance),
        a(jpost.params.noise_variance), x_shift=a(jpost.x_shift), device="cpu",
    )


def t32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


# ---------------------------------------------------------------------------
# K8: structured batched controller
# ---------------------------------------------------------------------------

B8 = 6


@pytest.fixture(scope="module")
def k8_operands():
    """JAX-built padded operands, with slack planes large enough that the
    box projections bind."""
    rng = np.random.default_rng(2)
    jm = JMPC(JCfg(horizon=N, admm_iterations=20, use_fused_controller=True))
    sd = j_sdata(jm._fc_data, N, 4, 6, jm._u_lo, jm._u_hi, jm._x_lo, jm._x_hi)
    n_pad = sd.SxT.shape[0]

    def plane(width, scale, rows=B8):
        p = np.zeros((rows, n_pad), np.float32)
        p[:, :width] = scale * rng.normal(size=(rows, width))
        return p

    x0 = plane(6, 1.0)
    x0[:, 2] += 3.0
    ref = plane(NNX, 0.0)
    # references up to ~20 m away: the accelerations saturate
    ref[:, :NNX] = np.tile(rng.normal(size=(B8, 1, 6)) * [10, 10, 1, 0, 0, 0],
                           (1, N, 1)).reshape(B8, NNX)
    ref[:, 2:NNX:6] += 3.0
    ops = dict(X0=x0, W=plane(NNX, 0.05), REF=ref,
               ZU=plane(NNU, 4.0), ZX=plane(NNX, 2.0), YU=plane(NNU, 1.0), YX=plane(NNX, 1.0))
    return jm, sd, ops


@pytest.mark.parametrize("iterations", [0, 20])
@pytest.mark.parametrize("ref_rows", ["broadcast", "per_flight"])
@pytest.mark.parametrize("w_rows", ["per_flight", "zero_row"])
def test_k8_plain_matches_jax_kernel_interpret(k8_operands, w_rows, ref_rows, iterations):
    jm, sd, o = k8_operands
    W = o["W"] if w_rows == "per_flight" else np.zeros_like(o["W"][:1])
    REF = o["REF"] if ref_rows == "per_flight" else o["REF"][:1]
    planes = [o[k] for k in ("ZU", "ZX", "YU", "YX")]
    want = j_k8(sd, jnp.asarray(o["X0"]), jnp.asarray(W), jnp.asarray(REF),
                *(jnp.asarray(p) for p in planes), 8.0, iterations, 1.6, interpret=True)

    psd = convert.structured_batch_data_from_numpy(sd._asdict(), N, device="cpu")
    got = controller_pallas.gpmpc_controller_structured_batched(
        psd, t32(o["X0"][:, :6]), t32(W[:, :NNX]), t32(REF[:, :NNX]),
        *convert.split_planes_from_numpy(*planes, N, device="cpu"), 8.0, iterations, 1.6,
    )
    widths = (NNU, NNX, NNU, NNX, NNU, NNX)
    for name, g, w, width in zip(("ZU", "ZX", "YU", "YX", "U", "X_tail"), got, want, widths):
        assert tuple(g.shape) == (B8, width), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :width], rtol=0, atol=1e-5,
                                   err_msg=name)
    if iterations:
        # the projections bind: some slack sits on its box
        zu = got[0].numpy()
        lo, hi = np.tile(jm.config.control_lower, N), np.tile(jm.config.control_upper, N)
        assert np.any(np.isclose(zu, hi, atol=1e-6) | np.isclose(zu, lo, atol=1e-6))


def test_structured_batch_data_built_by_port_matches_jax(k8_operands):
    _, sd, _ = k8_operands
    tm = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=20, use_fused_controller=True),
                   device="cpu")
    got = controller_pallas.build_structured_batch_data(
        tm._fc_data, N, 4, 6, tm._u_lo, tm._u_hi, tm._x_lo, tm._x_hi, device="cpu")
    want = convert.structured_batch_data_from_numpy(sd._asdict(), N, device="cpu")
    for name in controller_pallas.StructuredBatchData._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, int):
            assert g == w, name
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)


def test_k8_wrapper_checks_layout_and_operands(k8_operands):
    _, sd, o = k8_operands
    psd = convert.structured_batch_data_from_numpy(sd._asdict(), N, device="cpu")
    planes = convert.split_planes_from_numpy(o["ZU"], o["ZX"], o["YU"], o["YX"], N, device="cpu")
    args = (psd, t32(o["X0"][:, :6]), torch.zeros(1, NNX), torch.zeros(1, NNX))
    with pytest.raises(ValueError, match="layout"):
        controller_pallas.gpmpc_controller_structured_batched(*args, *planes, 8.0, 2, horizon=N + 1)
    with pytest.raises(ValueError, match="shape"):
        controller_pallas.gpmpc_controller_structured_batched(
            *args, planes[0][:, :-1].contiguous(), *planes[1:], 8.0, 2)
    with pytest.raises(ValueError, match="float32"):
        controller_pallas.gpmpc_controller_structured_batched(
            *args, planes[0].double(), *planes[1:], 8.0, 2)
    out = controller_pallas.gpmpc_controller_structured_batched(*args, *planes, 8.0, 2, horizon=N)
    assert [tuple(t.shape) for t in out] == [(B8, NNU), (B8, NNX)] * 2 + [(B8, NNU), (B8, NNX)]


def test_k8_shared_memory_fits_horizon_26_not_27():
    limit = 232448   # H100: the most dynamic shared memory one block may opt into
    assert controller_pallas.structured_shared_memory_bytes(20) <= limit
    assert controller_pallas.structured_shared_memory_bytes(26) <= limit
    assert controller_pallas.structured_shared_memory_bytes(27) > limit


# ---------------------------------------------------------------------------
# K7: fused GP posterior mean
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def k7_posteriors():
    """P=300 posteriors (plain, with x_shift, and a ring of 300 rows holding
    180 samples, whose masked rows sit at the 1e6 sentinel) and 777 queries,
    half of them near training points so the kernel values are not all 0."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 10)).astype(np.float32)
    Y = (0.05 * rng.normal(size=(300, 6)) + 0.02).astype(np.float32)
    near = X[rng.integers(0, 180, size=388)] + 0.2 * rng.normal(size=(388, 10))
    Xt = np.concatenate([near, rng.normal(size=(389, 10))]).astype(np.float32)
    base = j_fit(jnp.asarray(X), jnp.asarray(Y), JGPCfg())
    shifted = base.replace(x_shift=jnp.asarray(0.3 * rng.normal(size=10), jnp.float32))
    ring = JDataset(X=jnp.asarray(X), Y=jnp.asarray(Y), head=jnp.asarray(180, jnp.int32),
                    count=jnp.asarray(180, jnp.int32))
    masked = j_fit_masked(ring, JGPCfg())
    return {"plain": base, "x_shift": shifted, "masked": masked}, Xt


@pytest.mark.parametrize("case", ["plain", "x_shift", "masked"])
def test_k7_plain_matches_jax_kernel_and_predict_mean(k7_posteriors, case):
    posts, Xt = k7_posteriors
    jpost = posts[case]
    if case == "masked":
        assert np.max(np.asarray(jpost.X_train)) == 1e6
    want_kernel = np.asarray(j_k7(jpost, jnp.asarray(Xt), interpret=True, precision="highest"))
    want_mean = np.asarray(j_predict_mean(jpost, jnp.asarray(Xt)))
    post = port_posterior(jpost)
    got = rbf_pallas.rbf_posterior_mean_pallas(post, torch.from_numpy(Xt)).numpy()
    assert got.shape == (777, 6) and got.dtype == np.float32
    assert np.all(np.isfinite(got))
    # the near queries see the training data: the mean moves off y_mean
    assert np.max(np.abs(got - np.asarray(jpost.y_mean))) > 1e-3
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want_mean, rtol=0, atol=1e-6)
    ops = rbf_pallas.posterior_mean_operands(post)
    np.testing.assert_array_equal(
        rbf_pallas.rbf_posterior_mean_plain(ops, torch.from_numpy(Xt)).numpy(), got)


def test_k7_rejects_unknown_precision(k7_posteriors):
    posts, Xt = k7_posteriors
    with pytest.raises(ValueError, match="precision"):
        rbf_pallas.rbf_posterior_mean_pallas(port_posterior(posts["plain"]),
                                             torch.from_numpy(Xt), precision="bf16")


# ---------------------------------------------------------------------------
# Batched horizon residuals (and the vmap fault of build_horizon_residuals)
# ---------------------------------------------------------------------------


def test_batched_fused_residuals_match_jax_and_vmap():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(150, 10)).astype(np.float32)
    Y = (0.05 * rng.normal(size=(150, 6))).astype(np.float32)
    jcfg = JGPCfg()
    jpost = j_fit(jnp.asarray(X), jnp.asarray(Y), jcfg)
    B, Nh = 5, 12
    Xg = (0.5 * rng.normal(size=(B, Nh + 1, 6))).astype(np.float32)
    Ug = (0.5 * rng.normal(size=(B, Nh, 4))).astype(np.float32)
    want = np.asarray(j_residuals_fused(jpost, jnp.asarray(Xg), jnp.asarray(Ug), jcfg,
                                        precision="highest", interpret=True))
    want_vmap = np.asarray(jax.vmap(lambda a, b: j_residuals(jpost, a, b, jcfg))(
        jnp.asarray(Xg), jnp.asarray(Ug)))

    post = port_posterior(jpost)
    cfg = ResidualGPConfig()
    got = build_horizon_residuals_batched_fused(post, torch.from_numpy(Xg), torch.from_numpy(Ug),
                                                cfg)
    got_vmap = torch.func.vmap(lambda a, b: build_horizon_residuals(post, a, b, cfg))(
        torch.from_numpy(Xg), torch.from_numpy(Ug))
    assert tuple(got.shape) == tuple(got_vmap.shape) == (B, Nh, 6)
    assert np.max(np.abs(want[:, :, 3:6])) > 1e-2
    np.testing.assert_array_equal(got[:, :, 0:3].numpy(), 0.0)
    for g in (got.numpy(), got_vmap.numpy()):
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g, want_vmap, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The sweep as a whole
# ---------------------------------------------------------------------------

B, T = 4, 30
SWEEP_CASES = {
    "no_gp": {},
    "residual_fn": {"residual_fn": True},
    "gp_posterior": {"gp": True},
    "gp_posterior_every_3": {"gp": True, "gp_every": 3},
    "fallback": {"fallback_error_m": 0.3},
}


@pytest.fixture(scope="module")
def sweep_setup():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(200, 10)) * 0.5
    X[:, 2] += 3.0
    Y = 0.05 * rng.normal(size=(200, 6)) + 0.02
    jpost = j_fit(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), JGPCfg())
    starts = np.zeros((B, 12), np.float32)
    starts[:, 2] = 3.0
    starts[:, 0] = np.linspace(-1.0, 1.0, B)
    cfg = dict(horizon=N, admm_iterations=20, use_fused_controller=True)
    return (JMPC(JCfg(**cfg)), LinearMPC(LinearMPCConfig(**cfg), device="cpu"),
            jpost, port_posterior(jpost), starts)


def sweep_kwargs(case, jpost, post):
    spec = SWEEP_CASES[case]
    jkw = dict(cfg=JLoopCfg(fallback_error_m=spec.get("fallback_error_m", 0.0)),
               gp_every=spec.get("gp_every", 1), body=JBody(wind=WIND))
    tkw = dict(cfg=FlightLoopConfig(fallback_error_m=spec.get("fallback_error_m", 0.0)),
               gp_every=spec.get("gp_every", 1), body=RigidBodyParams(wind=WIND))
    if spec.get("residual_fn"):
        jkw["residual_fn"] = lambda a, b: j_residuals(jpost, a, b, JGPCfg())
        tkw["residual_fn"] = lambda a, b: build_horizon_residuals(post, a, b, ResidualGPConfig())
    if spec.get("gp"):
        jkw.update(gp_posterior=jpost, gp_cfg=JGPCfg(), gp_fused_precision="highest")
        tkw.update(gp_posterior=post, gp_cfg=ResidualGPConfig(), gp_fused_precision="highest")
    return jkw, tkw


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_sweep_matches_jax(sweep_setup, case):
    jm, tm, jpost, post, starts = sweep_setup
    jkw, tkw = sweep_kwargs(case, jpost, post)
    want = j_sweep(jm, j_ref, T, jnp.asarray(starts), **jkw)
    got = batched_mpc_flight_sweep(tm, t_ref, T, torch.from_numpy(starts), device="cpu", **tkw)
    assert set(got) == set(want) == {"state", "pos_ref", "thrust"}
    assert tuple(got["state"].shape) == (T, B, 12)
    assert tuple(got["thrust"].shape) == (T, B)
    assert tuple(got["pos_ref"].shape) == (T, 3)
    assert np.all(np.isfinite(got["state"].numpy()))
    gap = np.max(np.abs(got["state"][:, :, 0:3].numpy() - np.asarray(want["state"])[:, :, 0:3]))
    assert gap <= 1e-4, gap
    np.testing.assert_allclose(got["thrust"].numpy(), np.asarray(want["thrust"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["pos_ref"].numpy(), np.asarray(want["pos_ref"]), rtol=0,
                               atol=1e-6)
    if case == "fallback":
        # every flight starts more than 0.3 m off the reference: the hover
        # fallback law, not the MPC command, flew the first ticks
        plain = batched_mpc_flight_sweep(tm, t_ref, T, torch.from_numpy(starts), device="cpu",
                                         body=RigidBodyParams(wind=WIND))
        assert np.max(np.abs(plain["state"].numpy() - got["state"].numpy())) > 1e-3


def test_structured_flight_sweep_aggregates_the_sweep(sweep_setup):
    _, tm, _, _, starts = sweep_setup
    outs = batched_mpc_flight_sweep(tm, t_ref, 20, torch.from_numpy(starts), device="cpu")
    agg = structured_flight_sweep(tm, t_ref, 20, torch.from_numpy(starts), device="cpu")
    err = outs["pos_ref"].numpy()[:, None, :] - outs["state"].numpy()[:, :, 0:3]
    rms = np.sqrt(np.mean(np.sum(err**2, axis=-1), axis=0))
    assert rms.shape == (B,)
    np.testing.assert_allclose(agg["rms_per_flight"].numpy(), rms, rtol=1e-6)
    np.testing.assert_allclose(float(agg["rms_mean"]), rms.mean(), rtol=1e-6)
    np.testing.assert_allclose(float(agg["rms_max"]), rms.max(), rtol=1e-6)


@pytest.mark.parametrize("fault", ["unfused_mpc", "both_gp_routes", "gp_every_0", "precision"])
def test_sweep_argument_checks_raise(sweep_setup, fault):
    _, tm, _, post, starts = sweep_setup
    kw = dict(device="cpu")
    mpc = tm
    if fault == "unfused_mpc":
        mpc = LinearMPC(LinearMPCConfig(horizon=N), device="cpu")
    elif fault == "both_gp_routes":
        kw.update(gp_posterior=post, residual_fn=lambda a, b: build_horizon_residuals(post, a, b))
    elif fault == "gp_every_0":
        kw.update(gp_posterior=post, gp_every=0)
    else:
        kw.update(gp_posterior=post, gp_fused_precision="bf16")
    with pytest.raises(ValueError):
        batched_mpc_flight_sweep(mpc, t_ref, 4, torch.from_numpy(starts), **kw)
