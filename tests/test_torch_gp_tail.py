"""Port parity for the GP tail and the small ported helpers against the JAX
package on the CPU: the log marginal likelihood and its maximisation, the
GP checkpoint (each package reads the other's files), the per-dimension
GPs, posterior compression, the offline evaluation, synthetic excitation
data and system identification, the tracking and performance metrics,
and the quaternion and discrete-system helpers.

The data is the JAX package's own synthetic excitation flight (its
``generate_excitation_data``, seed 4, 200 steps: the surrogate plant's
residuals against the double integrator), float64.

Tolerances: the log marginal likelihood within 1e-10 relative;
``per_dim``, ``sparse`` and ``evaluate`` within 1e-8; a checkpoint written
by either package predicts within 1e-12 in the other; the excitation data
on the JAX package's command noise within 1e-8. The optimisers differ
(``torch.optim.LBFGS`` against ``optax.lbfgs``), so theirs is held by
what it achieves: a better log marginal likelihood than the start, and
restarts no worse than one run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.gp import (
    GPParams as JParams,
    compress_posterior as j_compress,
    compression_error as j_compression_error,
    evaluate_gp_residuals as j_evaluate_residuals,
    fit_gp as j_fit_gp,
    fit_per_dim_gp as j_fit_per_dim,
    fit_residual_gp as j_fit_residual,
    log_marginal_likelihood as j_lml,
    per_dim_training_report as j_report,
    predict as j_predict,
    predict_mean as j_predict_mean,
    predict_per_dim as j_predict_per_dim,
    build_horizon_residuals_per_dim as j_horizon_per_dim,
)
from unmanned_aerial_vehicles_tpu.gp.sparse import select_anchors as j_anchors
from unmanned_aerial_vehicles_tpu.io import (
    generate_excitation_data as j_excitation,
    identify_linear_dynamics as j_identify,
    load_gp_checkpoint as j_load,
    save_gp_checkpoint as j_save,
)
from unmanned_aerial_vehicles_tpu.metrics.performance import (
    constraint_violations as j_violations,
    gp_metrics_summary as j_gp_summary,
    mpc_metrics_summary as j_mpc_summary,
)
from unmanned_aerial_vehicles_tpu.metrics.tracking import tracking_metrics as j_tracking
from unmanned_aerial_vehicles_tpu.models.double_integrator import (
    discrete_system_matrices as j_discrete,
)
from unmanned_aerial_vehicles_tpu.utils.rotations import (
    euler_to_quaternion as j_e2q,
    quaternion_to_euler as j_q2e,
)
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.gp import (
    GPParams,
    build_horizon_residuals_per_dim,
    compress_posterior,
    compression_error,
    evaluate_gp,
    evaluate_gp_residuals,
    fit_gp,
    fit_per_dim_gp,
    fit_residual_gp,
    log_marginal_likelihood,
    optimize_hyperparameters,
    optimize_hyperparameters_restarts,
    per_dim_training_report,
    predict,
    predict_mean,
    predict_per_dim,
    select_anchors,
)
from unmanned_aerial_vehicles_tpu_torch.io import (
    generate_excitation_data,
    identify_linear_dynamics,
    load_gp_checkpoint,
    save_gp_checkpoint,
)
from unmanned_aerial_vehicles_tpu_torch.metrics import (
    MetricsLogger,
    constraint_violations,
    gp_metrics_summary,
    mpc_metrics_summary,
    tracking_metrics,
)
from unmanned_aerial_vehicles_tpu_torch.models import discrete_system_matrices
from unmanned_aerial_vehicles_tpu_torch.utils import euler_to_quaternion, quaternion_to_euler

torch.set_num_threads(1)

LML_RTOL, TAIL_TOL, CHECKPOINT_TOL = 1e-10, 1e-8, 1e-12


EXCITATION_SEED, EXCITATION_STEPS = 4, 200


@pytest.fixture(scope="module")
def data():
    """The JAX package's excitation flight: 150 training and 50 test pairs."""
    X, Y = j_excitation(seed=EXCITATION_SEED, num_steps=EXCITATION_STEPS)
    return X[:150], Y[:150], X[150:], Y[150:]


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def posterior_pair(X, Y):
    """The residual GP (``RBF(0.5) + White(0.1)``, alpha 1e-4, normalized
    targets) fitted by both packages."""
    return j_fit_residual(jnp.asarray(X), jnp.asarray(Y)), fit_residual_gp(t64(X), t64(Y))


@pytest.mark.parametrize("case", ["iso_normalized", "ard_raw", "single_output"])
def test_log_marginal_likelihood_matches_jax(data, case):
    X, Y, _, _ = data
    rng = np.random.default_rng(3)
    if case == "iso_normalized":
        ls, kw, Yc = 0.5, dict(jitter=1e-4, normalize_y=True), Y
    elif case == "ard_raw":
        ls, kw, Yc = rng.uniform(0.5, 3.0, 10), dict(jitter=0.0, normalize_y=False), Y
    else:
        ls, kw, Yc = 1.5, dict(jitter=1e-6, normalize_y=True), Y[:, 4]
    jp = JParams.create(ls, 1.3, 0.1)
    p = GPParams.create(ls, 1.3, 0.1, device="cpu")
    want = float(jax.jit(lambda p, X, Y: j_lml(p, X, Y, **kw))(jp, jnp.asarray(X), jnp.asarray(Yc)))
    got = float(log_marginal_likelihood(p, t64(X), t64(Yc), **kw))
    assert abs(got - want) <= LML_RTOL * abs(want), (got, want)


def test_log_marginal_likelihood_gradient_matches_jax(data):
    X, Y, _, _ = data
    jp = JParams.create(np.full(10, 0.8), 1.0, 0.2)
    jg = jax.jit(jax.grad(lambda p: j_lml(p, jnp.asarray(X), jnp.asarray(Y), 1e-4, True)))(jp)
    names = ("log_length_scale", "log_signal_variance", "log_noise_variance")
    p = GPParams(*(t64(getattr(jp, k)).requires_grad_(True) for k in names))
    g = torch.autograd.grad(log_marginal_likelihood(p, t64(X), t64(Y), 1e-4, True), list(p))
    for got, want in zip(g, (getattr(jg, k) for k in names)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)


def test_optimizer_improves_lml(data):
    """From a deliberately bad start, as the JAX package's test does; the
    returned value is the best parameters' negative LML."""
    X, Y, _, _ = data
    Xt, Yt = t64(X), t64(Y)
    start = GPParams.create(2.0, 0.5, 0.5, device="cpu")
    lml0 = float(log_marginal_likelihood(start, Xt, Yt, 1e-4, True))
    best, nll = optimize_hyperparameters(start, Xt, Yt, jitter=1e-4, normalize_y=True, steps=20)
    lml1 = float(log_marginal_likelihood(best, Xt, Yt, 1e-4, True))
    assert lml1 > lml0 + 10.0
    np.testing.assert_allclose(float(nll), -lml1, rtol=1e-6)
    assert all(torch.isfinite(v).all() for v in best) and not best.log_noise_variance.requires_grad


def test_restarts_no_worse_than_single_run(data):
    X, Y, _, _ = data
    Xt, Yt = t64(X[:100]), t64(Y[:100])
    start = GPParams.create(np.full(10, 2.0), 0.5, 0.5, device="cpu")
    _, single = optimize_hyperparameters(start, Xt, Yt, jitter=1e-4, normalize_y=True, steps=15)
    best, multi = optimize_hyperparameters_restarts(
        start, Xt, Yt, torch.Generator().manual_seed(0), restarts=3, jitter=1e-4,
        normalize_y=True, steps=15)
    assert float(multi) <= float(single) + 1e-6
    assert tuple(best.log_length_scale.shape) == (10,)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gp_checkpoint_crosses_packages(data, tmp_path, writer):
    """A checkpoint written by either package, read by the other (the same
    ``.npz`` keys), predicts what the writer's posterior predicts."""
    X, Y, Xq, _ = data
    jpost, post = posterior_pair(X, Y)
    path = tmp_path / "gp.npz"
    if writer == "port":
        save_gp_checkpoint(path, post, t64(X), t64(Y), jitter=1e-4, metadata={"tick": 7})
        jpost2, *_ , jitter, normalize_y = j_load(str(path))
        mean, var = j_predict(jpost2, jnp.asarray(Xq))
        want_mean, want_var = predict(post, t64(Xq))
        got = (np.asarray(mean), np.asarray(var))
        want = (want_mean.numpy(), want_var.numpy())
        assert int(np.load(path)["meta_tick"]) == 7
    else:
        j_save(str(path), jpost, X, Y, jitter=1e-4)
        post2, X2, _, jitter, normalize_y = load_gp_checkpoint(path, device="cpu")
        mean, var = predict(post2, t64(Xq))
        want_mean, want_var = j_predict(jpost, jnp.asarray(Xq))
        got = (mean.numpy(), var.numpy())
        want = (np.asarray(want_mean), np.asarray(want_var))
        assert X2.dtype == torch.float64 and tuple(X2.shape) == X.shape
    assert jitter == 1e-4 and normalize_y is True
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=CHECKPOINT_TOL)


@pytest.fixture(scope="module")
def per_dim_pair(data):
    X, Y, _, _ = data
    return jax.jit(j_fit_per_dim)(jnp.asarray(X), jnp.asarray(Y)), fit_per_dim_gp(t64(X), t64(Y))


def test_per_dim_predictions_match_jax(data, per_dim_pair):
    _, _, Xq, Yq = data
    jmodel, model = per_dim_pair
    jmean, jvar = jax.jit(j_predict_per_dim)(jmodel, jnp.asarray(Xq))
    mean, var = predict_per_dim(model, t64(Xq))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=TAIL_TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=TAIL_TOL, atol=0)
    Xg, Ug = Xq[:11, :6], Xq[:10, 6:10]
    np.testing.assert_allclose(
        build_horizon_residuals_per_dim(model, t64(Xg), t64(Ug)).numpy(),
        np.asarray(jax.jit(j_horizon_per_dim)(jmodel, jnp.asarray(Xg), jnp.asarray(Ug))),
        rtol=0, atol=TAIL_TOL)


def test_per_dim_report_and_conversion_match_jax(data, per_dim_pair):
    """The training report; the JAX model carried across
    (``convert.per_dim_gp_from_numpy``) predicts as the JAX model does."""
    X, Y, Xq, Yq = data
    jmodel, model = per_dim_pair
    want = j_report(jmodel, jnp.asarray(Xq), jnp.asarray(Yq), jnp.asarray(X), jnp.asarray(Y))
    got = per_dim_training_report(model, t64(Xq), t64(Yq), t64(X), t64(Y))
    assert list(got) == list(want)
    for name in want:
        for key in want[name]:
            assert abs(got[name][key] - want[name][key]) <= TAIL_TOL * max(1.0, abs(want[name][key]))
    post = jmodel.posteriors
    fields = {k: (None if getattr(post, k) is None else np.asarray(getattr(post, k)))
              for k in post.__dataclass_fields__ if k != "params"}
    fields.update({k: np.asarray(getattr(post.params, k)) for k in
                   ("log_length_scale", "log_signal_variance", "log_noise_variance")})
    carried = convert.per_dim_gp_from_numpy(
        fields, {"mean": np.asarray(jmodel.scaler_X.mean), "std": np.asarray(jmodel.scaler_X.std)},
        {"mean": np.asarray(jmodel.scaler_Y.mean), "std": np.asarray(jmodel.scaler_Y.std)},
        device="cpu")
    mean, _ = predict_per_dim(carried, t64(Xq))
    want_mean = jax.jit(j_predict_per_dim)(jmodel, jnp.asarray(Xq))[0]
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=0, atol=1e-12)


def test_per_dim_optimize_improves_each_output(data):
    X, Y, _, _ = data
    Xt, Yt = t64(X[:120]), t64(Y[:120])
    base = fit_per_dim_gp(Xt, Yt)
    tuned = fit_per_dim_gp(Xt, Yt, optimize=True, opt_steps=5)
    Xs, Ys = base.scaler_X.transform(Xt), base.scaler_Y.transform(Yt)
    for i in range(Y.shape[1]):
        params = lambda m: GPParams(*(v[i] for v in m.posteriors.params))
        lml = lambda m: float(log_marginal_likelihood(params(m), Xs, Ys[:, i:i + 1], 1e-6))
        assert lml(tuned) >= lml(base) - 1e-9


@pytest.mark.parametrize("n,m", [(300, 64), (300, 48), (128, 128), (97, 10)])
def test_select_anchors_match_jax(n, m):
    X = np.arange(n, dtype=np.float64)[:, None] * np.ones((1, 3))
    np.testing.assert_array_equal(select_anchors(t64(X), m).numpy(),
                                  np.asarray(j_anchors(jnp.asarray(X), m)))


def test_compression_matches_jax():
    """The smooth regime of the JAX package's test (length scale ~ the
    data's spread), where compression is accurate."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (300, 2))
    Y = np.sin(2.0 * X[:, :1]) + 0.01 * rng.normal(size=(300, 1))
    Xq = rng.uniform(-1, 1, (100, 2))
    jpost = jax.jit(lambda X, Y: j_fit_gp(JParams.create(length_scale=1.0, noise_variance=0.01),
                                          X, Y, jitter=1e-6, normalize_y=True))(
        jnp.asarray(X), jnp.asarray(Y))
    post = fit_gp(GPParams.create(length_scale=1.0, noise_variance=0.01, device="cpu"), t64(X),
                  t64(Y), jitter=1e-6, normalize_y=True)
    jcomp, comp = jax.jit(lambda p: j_compress(p, m=64))(jpost), compress_posterior(post, m=64)
    np.testing.assert_array_equal(comp.X_train.numpy(), np.asarray(jcomp.X_train))
    for key in ("chol", "y_train_norm"):
        np.testing.assert_allclose(getattr(comp, key).numpy(), np.asarray(getattr(jcomp, key)),
                                   rtol=0, atol=TAIL_TOL)
    # the anchor weights solve a system conditioned ~1e8 (the 1e-8 jitter):
    # they are held by the compressed mean they produce
    np.testing.assert_allclose(predict_mean(comp, t64(Xq)).numpy(),
                               np.asarray(j_predict_mean(jcomp, jnp.asarray(Xq))), rtol=0,
                               atol=TAIL_TOL)
    err = compression_error(post, comp, t64(Xq))
    jerr = jax.jit(j_compression_error)(jpost, jcomp, jnp.asarray(Xq))
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0, atol=TAIL_TOL)
    assert float(err.max()) < 0.05


def test_evaluation_matches_jax(data, tmp_path):
    X, Y, Xq, Yq = data
    jpost, post = posterior_pair(X, Y)
    R_pred = predict(post, t64(Xq))[0].numpy()
    want = j_evaluate_residuals(Yq, R_pred)
    got = evaluate_gp_residuals(Yq, R_pred)

    def close(a, b):
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                close(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                close(x, y)
        elif isinstance(a, str):
            assert a == b
        else:
            assert abs(a - b) <= TAIL_TOL * max(1.0, abs(b))

    close(got, want)
    # a predictor returning a tensor, and the CSV in the reference's layout
    via_csv = evaluate_gp(lambda x: predict(post, t64(x))[0], Xq, Yq,
                          save_prefix=str(tmp_path / "run"))
    close(via_csv, want)
    header = (tmp_path / "run_metrics.csv").read_text().splitlines()[0]
    assert header == "component,mse_nom,mse_gp,rmse_nom,rmse_gp,improvement_%,r2_nom,r2_gp,frac_better"


def test_excitation_data_on_jax_noise_matches_jax(data):
    """The excitation flight on the JAX package's command noise (``noise=``,
    its standard normals before the command scaling)."""
    n = EXCITATION_STEPS
    want_X, want_Y = (np.concatenate(pair) for pair in ((data[0], data[2]), (data[1], data[3])))
    normals = np.asarray(jax.random.normal(jax.random.PRNGKey(EXCITATION_SEED), (n, 4),
                                           jnp.float64))
    X, Y = generate_excitation_data(num_steps=n, noise=torch.tensor(normals), device="cpu")
    np.testing.assert_allclose(X, want_X, rtol=0, atol=TAIL_TOL)
    np.testing.assert_allclose(Y, want_Y, rtol=0, atol=TAIL_TOL)
    a, b = (generate_excitation_data(seed=2, num_steps=50, device="cpu") for _ in range(2))
    assert np.array_equal(a[0], b[0]) and a[0].shape == (50, 10) and a[1].shape == (50, 6)
    with pytest.raises(ValueError, match="noise has shape"):
        generate_excitation_data(num_steps=5, noise=torch.zeros(4, 4), device="cpu")


def test_identify_linear_dynamics_matches_jax():
    rng = np.random.default_rng(0)
    s, u = rng.normal(size=(200, 6)), rng.normal(size=(200, 4))
    nxt = s + 0.02 * np.concatenate([s[:, 3:6], u[:, 0:3]], axis=1) + 1e-3 * rng.normal(size=(200, 6))
    for got, want in zip(identify_linear_dynamics(t64(s), t64(u), t64(nxt)), j_identify(s, u, nxt)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_tracking_and_performance_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    sig = {k: rng.normal(size=(3, 40, 3)) for k in ("ps", "pc", "vs", "vc", "as", "ac")}
    thrust = rng.uniform(0.0, 1.2, (3, 40))
    want = j_tracking(*(jnp.asarray(sig[k]) for k in ("ps", "pc", "vs", "vc", "as", "ac")),
                      thrust_normalized=jnp.asarray(thrust))
    got = tracking_metrics(*(t64(sig[k]) for k in ("ps", "pc", "vs", "vc", "as", "ac")),
                           thrust_normalized=t64(thrust))
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-12, atol=1e-12)
    e, u = rng.normal(size=(50, 9)), rng.normal(size=(50, 4))
    lo, hi = -np.ones(4), np.ones(4)
    assert mpc_metrics_summary(e, u, np.abs(e[:, 0]), constraint_violations(u, lo, hi)) == \
        j_mpc_summary(e, u, np.abs(e[:, 0]), j_violations(u, lo, hi))
    assert gp_metrics_summary(e[:, :6], np.abs(e[:, :6]), np.arange(50)) == \
        j_gp_summary(e[:, :6], np.abs(e[:, :6]), np.arange(50))
    path = MetricsLogger(str(tmp_path)).save_mpc_metrics({"rmse": 1.0}, "m.json")
    assert path.endswith("m.json") and (tmp_path / "m.json").exists()


def test_quaternions_and_discrete_system_match_jax():
    rng = np.random.default_rng(6)
    angles = rng.uniform(-3.0, 3.0, (64, 3))
    angles[:, 1] = np.clip(angles[:, 1], -1.5, 1.5)
    q = euler_to_quaternion(*(t64(angles[:, i]) for i in range(3)))
    jq = jax.jit(j_e2q)(*(jnp.asarray(angles[:, i]) for i in range(3)))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-14)
    np.testing.assert_allclose(quaternion_to_euler(q).numpy(), np.asarray(jax.jit(j_q2e)(jq)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(quaternion_to_euler(q).numpy(), angles, rtol=0, atol=1e-9)
    pole = np.array([[np.sqrt(0.5), 0.0, np.sqrt(0.5) + 1e-9, 0.0]])   # |sin p| >= 1: clamped
    np.testing.assert_array_equal(quaternion_to_euler(t64(pole)).numpy(), np.asarray(j_q2e(pole)))
    for dtype, jd in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        A, B = discrete_system_matrices(0.02, dtype, device="cpu")
        jA, jB = j_discrete(0.02, jd)
        assert A.dtype == dtype
        np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
        np.testing.assert_array_equal(B.numpy(), np.asarray(jB))
