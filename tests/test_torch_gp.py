"""Port parity: exact GP, the masked ring-buffer refit, horizon residuals
and the ring buffer's batched and single inserts against the JAX package,
on the CPU; the predictive variance and what reads it (``predict``,
``predict_residual``, ``build_horizon_uncertainty``, the output
correction).

Tolerance 1e-6 on posteriors (the bar JAX itself holds against sklearn,
``tests/test_gp.py``): the fits share float64 Gram matrices and Cholesky
factors, and the float32 ring-buffer statistics differ only in summation
order. Ring-buffer inserts are exact: same slots, same rows, same count.
The variance and its consumers compute from one carried-across float64
posterior: 1e-10 (float64 triangular solves in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.gp.exact_gp import (
    GPParams as JParams,
    fit_gp as j_fit_gp,
    predict as j_predict,
    predict_mean as j_predict_mean,
)
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    OutputCorrectionConfig as JOCCfg,
    ResidualGPConfig as JGPCfg,
    add_training_sample as j_add_one,
    add_training_samples_batch as j_add,
    build_horizon_uncertainty as j_uncertainty,
    output_correction as j_output_correction,
    predict_residual as j_predict_residual,
    build_horizon_residuals as j_residuals,
    empty_dataset as j_empty,
    fit_residual_gp_masked as j_fit_masked,
    masked_input_stats as j_stats,
    standardized_params as j_std_params,
)
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.gp.exact_gp import GPParams, fit_gp, predict, predict_mean
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
    OutputCorrectionConfig,
    ResidualGPConfig,
    add_training_sample,
    add_training_samples_batch,
    build_horizon_uncertainty,
    make_output_correction_fn,
    output_correction,
    predict_residual,
    build_horizon_residuals,
    empty_dataset,
    fit_residual_gp_masked,
    masked_input_stats,
    standardized_params,
)

torch.set_num_threads(1)


def to_port(jpost):
    return convert.gp_posterior_from_numpy(
        np.asarray(jpost.X_train), np.asarray(jpost.chol), np.asarray(jpost.alpha),
        np.asarray(jpost.y_mean), np.asarray(jpost.y_std),
        np.asarray(jpost.params.length_scale), np.asarray(jpost.params.signal_variance),
        np.asarray(jpost.params.noise_variance),
        x_shift=None if jpost.x_shift is None else np.asarray(jpost.x_shift),
        y_train_norm=np.asarray(jpost.y_train_norm), device="cpu",
    )


def assert_posteriors_close(post, jpost, atol=1e-6):
    for name in ("X_train", "chol", "alpha", "y_mean", "y_std", "y_train_norm"):
        np.testing.assert_allclose(getattr(post, name).double().numpy(),
                                   np.asarray(getattr(jpost, name), np.float64),
                                   rtol=0, atol=atol, err_msg=name)


def ring_data(seed, capacity, count):
    """A ring buffer filled (float32) with ``count`` quality-passing rows."""
    rng = np.random.default_rng(seed)
    X = np.zeros((capacity, 10), np.float32)
    Y = np.zeros((capacity, 6), np.float32)
    X[:count] = rng.normal(size=(count, 10)) * np.array([2, 2, 0.3, 1, 1, 0.5, 1, 1, 1, 0.3])
    X[:count, 2] += 3.0
    Y[:count] = 0.02 * rng.normal(size=(count, 6)) + 0.01
    return X, Y


def test_fit_gp_and_predict_mean_match_jax():
    rng = np.random.default_rng(0)
    X, Y = rng.normal(size=(40, 10)), rng.normal(size=(40, 6))
    Xq = rng.normal(size=(7, 10))
    jp = JParams.create(length_scale=0.9, signal_variance=1.3, noise_variance=0.05)
    tp = GPParams.create(length_scale=0.9, signal_variance=1.3, noise_variance=0.05,
                         device="cpu")
    jpost = j_fit_gp(jp, jnp.asarray(X), jnp.asarray(Y), jitter=1e-4, normalize_y=True)
    post = fit_gp(tp, torch.from_numpy(X), torch.from_numpy(Y), jitter=1e-4, normalize_y=True)
    assert_posteriors_close(post, jpost)
    want = np.asarray(j_predict_mean(jpost, jnp.asarray(Xq)))
    np.testing.assert_allclose(predict_mean(post, torch.from_numpy(Xq)).numpy(), want,
                               rtol=0, atol=1e-6)
    # the carried-across posterior predicts the same
    np.testing.assert_allclose(predict_mean(to_port(jpost), torch.from_numpy(Xq)).numpy(),
                               want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("standardize", [False, True])
def test_masked_refit_half_full_ring_matches_jax(standardize):
    capacity, count = 32, 16
    X, Y = ring_data(1, capacity, count)
    jds = j_empty(capacity, jnp.float32).replace(
        X=jnp.asarray(X), Y=jnp.asarray(Y), head=jnp.int32(count), count=jnp.int32(count))
    ds = convert.dataset_from_numpy(X, Y, count, count, device="cpu")
    cfg, jcfg = ResidualGPConfig(), JGPCfg()
    if standardize:
        jshift, jstd = j_stats(jds)
        shift, std = masked_input_stats(ds)
        np.testing.assert_allclose(shift.numpy(), np.asarray(jshift), rtol=0, atol=1e-6)
        np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=0, atol=1e-6)
        jpost = j_fit_masked(jds, jcfg, params=j_std_params(jds, jcfg, std=jstd), x_shift=jshift)
        post = fit_residual_gp_masked(ds, cfg, params=standardized_params(ds, cfg, std=std),
                                      x_shift=shift)
    else:
        jpost = j_fit_masked(jds, jcfg)
        post = fit_residual_gp_masked(ds, cfg)
    assert_posteriors_close(post, jpost)
    assert np.all(post.X_train[count:].numpy() == 1e6)

    rng = np.random.default_rng(2)
    N = 10
    Xg = rng.normal(size=(N + 1, 6)).astype(np.float32)
    Xg[:, 2] += 3.0
    Ug = rng.normal(size=(N, 4)).astype(np.float32)
    want = np.asarray(j_residuals(jpost, jnp.asarray(Xg), jnp.asarray(Ug), jcfg))
    got = build_horizon_residuals(post, torch.from_numpy(Xg), torch.from_numpy(Ug), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # and from the posterior carried across
    got = build_horizon_residuals(to_port(jpost), torch.from_numpy(Xg), torch.from_numpy(Ug), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_batched_inserts_match_jax_through_wraparound():
    capacity, K = 16, 6
    cfg, jcfg = ResidualGPConfig(), JGPCfg()
    ds = empty_dataset(capacity, torch.float32, device="cpu")
    jds = j_empty(capacity, jnp.float32)
    rng = np.random.default_rng(5)
    for batch in range(7):
        s = rng.normal(size=(K, 12)).astype(np.float32)
        s[:, 3:6] *= 2.5           # some samples fail the velocity filter
        c = (rng.normal(size=(K, 4)) * 1.5).astype(np.float32)
        nxt = s.copy()
        nxt[:, :6] += 0.02 * rng.normal(size=(K, 6)).astype(np.float32)
        if batch == 3:
            nxt[0, :3] += 5.0      # residual filter rejection
        ds = add_training_samples_batch(ds, torch.from_numpy(s), torch.from_numpy(c),
                                        torch.from_numpy(nxt), cfg)
        jds = j_add(jds, jnp.asarray(s), jnp.asarray(c), jnp.asarray(nxt), jcfg)
        assert int(ds.count) == int(jds.count)
        assert int(ds.head) == int(jds.head)
        np.testing.assert_array_equal(ds.X.numpy(), np.asarray(jds.X))
        np.testing.assert_array_equal(ds.Y.numpy(), np.asarray(jds.Y))
    assert int(ds.head) > capacity     # the ring wrapped


def test_single_inserts_match_jax_through_wraparound():
    capacity = 8
    cfg, jcfg = ResidualGPConfig(), JGPCfg()
    ds = empty_dataset(capacity, torch.float32, device="cpu")
    jds = j_empty(capacity, jnp.float32)
    rng = np.random.default_rng(6)
    accepted = 0
    for i in range(20):
        s = rng.normal(size=12).astype(np.float32)
        s[3:6] *= 2.5 if i % 5 == 0 else 1.0        # some fail the velocity filter
        c = rng.normal(size=4).astype(np.float32)
        nxt = s.copy()
        nxt[:6] += 0.02 * rng.normal(size=6).astype(np.float32)
        ds = add_training_sample(ds, torch.from_numpy(s), torch.from_numpy(c),
                                 torch.from_numpy(nxt), cfg)
        jds = j_add_one(jds, jnp.asarray(s), jnp.asarray(c), jnp.asarray(nxt), jcfg)
        assert (int(ds.count), int(ds.head)) == (int(jds.count), int(jds.head))
        np.testing.assert_array_equal(ds.X.numpy(), np.asarray(jds.X))
        np.testing.assert_array_equal(ds.Y.numpy(), np.asarray(jds.Y))
        accepted = int(ds.head)
    assert capacity < accepted < 20 and int(ds.count) == capacity   # wrapped, some rejected


@pytest.fixture(scope="module")
def variance_case():
    """A masked float64 refit with an input shift (standardized mode), the
    JAX posterior and the port's copy of it, and query points some near the
    data, some far."""
    capacity, count = 32, 20
    X, Y = ring_data(3, capacity, count)
    jds = j_empty(capacity, jnp.float32).replace(
        X=jnp.asarray(X), Y=jnp.asarray(Y), head=jnp.int32(count), count=jnp.int32(count))
    jcfg = JGPCfg()
    jshift, jstd = j_stats(jds)
    jpost = j_fit_masked(jds, jcfg, params=j_std_params(jds, jcfg, std=jstd), x_shift=jshift)
    rng = np.random.default_rng(4)
    Xq = np.concatenate([X[:4] + 0.05 * rng.normal(size=(4, 10)),
                         rng.normal(size=(4, 10)) * 3.0]).astype(np.float32)
    return jpost, to_port(jpost), Xq


@pytest.mark.parametrize("with_noise", [True, False])
def test_predict_mean_and_variance_match_jax(variance_case, with_noise):
    jpost, post, Xq = variance_case
    jm, jv = j_predict(jpost, jnp.asarray(Xq), include_noise_in_variance=with_noise)
    m, v = predict(post, torch.from_numpy(Xq), include_noise_in_variance=with_noise)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0, atol=1e-10)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-10)
    # the latent variance is smaller near the data than far from it
    assert float(v.min()) > 0.0 and float(v[:4, 0].max()) < float(v[4:, 0].min())
    jr = j_predict_residual(jpost, jnp.asarray(Xq[0, :6]), jnp.asarray(Xq[0, 6:]))
    r = predict_residual(post, torch.from_numpy(Xq[0, :6]), torch.from_numpy(Xq[0, 6:]))
    for g, w in zip(r, jr):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


def test_horizon_uncertainty_matches_jax(variance_case):
    jpost, post, Xq = variance_case
    N = 6
    rng = np.random.default_rng(8)
    Xg = (Xq[:N + 1, :6] + 0.1 * rng.normal(size=(N + 1, 6))).astype(np.float32)
    Ug = Xq[:N, 6:].copy()
    cfg, jcfg = ResidualGPConfig(residual_gain=0.7), JGPCfg(residual_gain=0.7)
    want = np.asarray(j_uncertainty(jpost, jnp.asarray(Xg), jnp.asarray(Ug), jcfg))
    got = build_horizon_uncertainty(post, torch.from_numpy(Xg), torch.from_numpy(Ug), cfg)
    assert tuple(got.shape) == (N, 6) and np.all(got[:, :3].numpy() == 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


# (state6, u_opt, target, n_train, config fields): every gate open, then
# each gate closed in turn
_OC = dict(min_train_samples=10, confidence_threshold=2.0, correction_gain=0.5)
OUTPUT_CORRECTION_CASES = {
    "applied": ([0.1, 0.2, 3.0, 0.3, -0.2, 0.1], 20, _OC),
    "too_few_samples": ([0.1, 0.2, 3.0, 0.3, -0.2, 0.1], 5, _OC),
    "unstable_velocity": ([0.1, 0.2, 3.0, 2.5, -0.2, 0.1], 20, _OC),
    "far_from_target": ([6.0, 0.2, 3.0, 0.3, -0.2, 0.1], 20, _OC),
    "uncertain": ([0.1, 0.2, 3.0, 0.3, -0.2, 0.1], 20, dict(_OC, confidence_threshold=0.005)),
    "defaults": ([0.1, 0.2, 3.0, 0.3, -0.2, 0.1], 20, {}),
}


@pytest.mark.parametrize("case", sorted(OUTPUT_CORRECTION_CASES))
def test_output_correction_matches_jax(variance_case, case):
    jpost, post, _ = variance_case
    state, n_train, fields = OUTPUT_CORRECTION_CASES[case]
    state = np.asarray(state, np.float32)
    u = np.asarray([0.4, -0.3, 0.2, 0.05], np.float32)
    target = np.asarray([0.0, 0.0, 3.0], np.float32)
    want = np.asarray(j_output_correction(jpost, jnp.asarray(state), jnp.asarray(u),
                                          jnp.asarray(target), n_train, JOCCfg(**fields)))
    cfg = convert.output_correction_config_from_fields(fields)
    got = output_correction(post, torch.from_numpy(state), torch.from_numpy(u),
                            torch.from_numpy(target), n_train, cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    assert (not np.array_equal(got.numpy(), u)) == (case == "applied")
    hook = make_output_correction_fn(post, n_train, cfg)
    assert torch.equal(hook(torch.from_numpy(state), torch.from_numpy(u),
                            torch.from_numpy(target)), got)
