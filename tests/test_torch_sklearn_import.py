"""Port parity for loading the reference's sklearn GP pickles
(``io/sklearn_import.py``) against the JAX package and sklearn on the CPU.

The cases of the JAX package's ``tests/test_sklearn_import.py``: models are
fitted and pickled the way the reference writes them (the single-GP dict of
its offline trainer, the per-dimension package of its ``GPTrainer``, a bare
regressor), then both packages load the same file. Tolerances: the port's
predictions within 1e-10 of the JAX package's (both rebuild the Cholesky
factor in float64) and within 1e-6 of sklearn's own (the JAX tests' bar).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sklearn = pytest.importorskip("sklearn")

from sklearn.gaussian_process import GaussianProcessRegressor  # noqa: E402
from sklearn.gaussian_process.kernels import RBF, ConstantKernel, WhiteKernel  # noqa: E402
from sklearn.preprocessing import StandardScaler  # noqa: E402

from unmanned_aerial_vehicles_tpu.gp.exact_gp import predict as j_predict  # noqa: E402
from unmanned_aerial_vehicles_tpu.gp.per_dim import predict_per_dim as j_predict_per_dim  # noqa: E402
from unmanned_aerial_vehicles_tpu.io import (  # noqa: E402
    load_reference_gp as j_load_reference,
    load_sklearn_gp_pickle as j_load_single,
    load_sklearn_perdim_pickle as j_load_perdim,
)
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.gp import build_horizon_residuals  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.gp.exact_gp import predict  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.gp.per_dim import predict_per_dim  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig  # noqa: E402
from unmanned_aerial_vehicles_tpu_torch.io import (  # noqa: E402
    load_reference_gp,
    load_sklearn_gp_pickle,
    load_sklearn_perdim_pickle,
)
from unmanned_aerial_vehicles_tpu_torch.loop import mpc_flight_rollout  # noqa: E402

torch.set_num_threads(1)

JAX_TOL = 1e-10
SKLEARN_TOL = 1e-6
NAMES = ["x_residual", "y_residual", "z_residual", "vx_residual", "vy_residual", "vz_residual"]


def _single_pickle(tmp_path, rng, optimizer=None):
    """The offline trainer's format: RBF(0.5) + White(0.1), alpha 1e-4,
    normalize_y."""
    X = rng.normal(size=(60, 10))
    Y = 0.1 * rng.normal(size=(60, 6)) + 0.03 * X[:, :6]
    gpr = GaussianProcessRegressor(kernel=RBF(length_scale=0.5) + WhiteKernel(noise_level=0.1),
                                   alpha=1e-4, normalize_y=True, optimizer=optimizer)
    gpr.fit(X, Y)
    path = tmp_path / "gp_model.pkl"
    with open(path, "wb") as f:
        pickle.dump({"gp_model": gpr, "training_count": 3, "data_points_used": len(X),
                     "timestamp": "2026-08-17T00:00:00", "is_trained": True}, f)
    return str(path), gpr, X


def _perdim_pickle(tmp_path, rng):
    """The per-dimension trainer's format: Const(fixed) * RBF(ARD) + White
    per output, alpha 1e-6, standard scalers on both sides."""
    X = rng.normal(size=(50, 10))
    Y = 0.1 * rng.normal(size=(50, 6)) + 0.05 * X[:, :6]
    models, sxs, sys_ = {}, {}, {}
    for i, name in enumerate(NAMES):
        sx = StandardScaler().fit(X)
        sy = StandardScaler().fit(Y[:, i:i + 1])
        kernel = (ConstantKernel(1.0, constant_value_bounds="fixed") * RBF(length_scale=[1.0] * 10)
                  + WhiteKernel(noise_level=0.01))
        gpr = GaussianProcessRegressor(kernel=kernel, alpha=1e-6, normalize_y=False,
                                       optimizer=None)
        gpr.fit(sx.transform(X), sy.transform(Y[:, i:i + 1]).ravel())
        models[name], sxs[name], sys_[name] = gpr, sx, sy
    path = tmp_path / "gp_perdim.pkl"
    with open(path, "wb") as f:
        pickle.dump({"gp_models": models, "scalers_X": sxs, "scalers_y": sys_,
                     "training_stats": {}, "model_name": "test", "creation_time": 0.0}, f)
    return str(path), models, sxs, sys_, X


def test_single_pickle_matches_jax_and_sklearn(tmp_path, rng):
    path, gpr, _ = _single_pickle(tmp_path, rng)
    post, meta = load_sklearn_gp_pickle(path, device="cpu")
    jpost, jmeta = j_load_single(path)
    assert meta == jmeta and meta["is_trained"] and meta["training_count"] == 3
    assert post.alpha.dtype == torch.float64
    Xq = rng.normal(size=(20, 10))
    mean, var = predict(post, torch.from_numpy(Xq))
    jmean, jvar = j_predict(jpost, jnp.asarray(Xq))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=0, atol=JAX_TOL)
    mean_ref, std_ref = gpr.predict(Xq, return_std=True)
    np.testing.assert_allclose(mean.numpy(), mean_ref, atol=SKLEARN_TOL)
    np.testing.assert_allclose(np.sqrt(var.numpy()), std_ref, atol=SKLEARN_TOL)


def test_single_pickle_optimized_kernel(tmp_path, rng):
    """The hyperparameters are read off the fitted ``kernel_``."""
    path, gpr, _ = _single_pickle(tmp_path, rng, optimizer="fmin_l_bfgs_b")
    post, _ = load_sklearn_gp_pickle(path, device="cpu")
    np.testing.assert_allclose(float(post.params.length_scale),
                               float(gpr.kernel_.k1.length_scale), rtol=1e-12)
    Xq = rng.normal(size=(10, 10))
    mean, _ = predict(post, torch.from_numpy(Xq))
    jmean, _ = j_predict(j_load_single(path)[0], jnp.asarray(Xq))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(mean.numpy(), gpr.predict(Xq), atol=SKLEARN_TOL)


def test_perdim_pickle_matches_jax_and_sklearn(tmp_path, rng):
    path, models, sxs, sys_, _ = _perdim_pickle(tmp_path, rng)
    model = load_sklearn_perdim_pickle(path, device="cpu")
    Xq = rng.normal(size=(15, 10))
    mean, var = predict_per_dim(model, torch.from_numpy(Xq))
    jmean, jvar = j_predict_per_dim(j_load_perdim(path), jnp.asarray(Xq))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=0, atol=JAX_TOL)
    for i, name in enumerate(NAMES):
        m_s, s_s = models[name].predict(sxs[name].transform(Xq), return_std=True)
        m_ref = sys_[name].inverse_transform(m_s.reshape(-1, 1)).ravel()
        np.testing.assert_allclose(mean[:, i].numpy(), m_ref, atol=SKLEARN_TOL)
        np.testing.assert_allclose(np.sqrt(var[:, i].numpy()), np.abs(s_s * sys_[name].scale_[0]),
                                   atol=SKLEARN_TOL)


def test_autodetect_and_a_loaded_model_flies(tmp_path, rng):
    spath, _, _ = _single_pickle(tmp_path, rng)
    ppath, *_ = _perdim_pickle(tmp_path, rng)
    kind_s, post, meta = load_reference_gp(spath, device="cpu")
    kind_p, _, _ = load_reference_gp(ppath, device="cpu")
    assert (kind_s, kind_p) == ("single", "per_dim")
    assert (kind_s, kind_p) == (j_load_reference(spath)[0], j_load_reference(ppath)[0])
    post32 = load_reference_gp(spath, dtype=torch.float32, device="cpu")[1]
    assert post32.X_train.dtype == torch.float32
    mpc = LinearMPC(LinearMPCConfig(horizon=5, admm_iterations=20), device="cpu")

    def ref(t):
        return torch.stack([0.2 * torch.sin(t), 0.2 * torch.cos(t), 3.0 + 0 * t], dim=-1), t * 0

    outs = mpc_flight_rollout(mpc, ref, 30, device="cpu", residual_fn=lambda Xg, Ug:
                              build_horizon_residuals(post32, Xg, Ug, ResidualGPConfig()))
    assert bool(torch.isfinite(outs["state"]).all())


def test_perdim_partial_package(tmp_path, rng):
    """An output the trainer skipped predicts exactly zero; the others are
    untouched."""
    path, models, sxs, sys_, _ = _perdim_pickle(tmp_path, rng)
    with open(path, "rb") as f:
        data = pickle.load(f)
    for store in ("gp_models", "scalers_X", "scalers_y"):
        del data[store]["vz_residual"]
    ppath = str(tmp_path / "gp_perdim_partial.pkl")
    with open(ppath, "wb") as f:
        pickle.dump(data, f)
    model = load_sklearn_perdim_pickle(ppath, device="cpu")
    Xq = rng.normal(size=(12, 10))
    mean, _ = predict_per_dim(model, torch.from_numpy(Xq))
    jmean, _ = j_predict_per_dim(j_load_perdim(ppath), jnp.asarray(Xq))
    np.testing.assert_allclose(mean[:, 5].numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=JAX_TOL)
    m_ref = sys_["x_residual"].inverse_transform(
        models["x_residual"].predict(sxs["x_residual"].transform(Xq)).reshape(-1, 1)).ravel()
    np.testing.assert_allclose(mean[:, 0].numpy(), m_ref, atol=SKLEARN_TOL)


def test_single_pickle_meta_fit_settings(tmp_path, rng):
    """A bare regressor's own alpha and normalize_y come back in ``meta``."""
    X = rng.normal(size=(30, 10))
    gpr = GaussianProcessRegressor(kernel=RBF(0.5) + WhiteKernel(0.1), alpha=3e-3,
                                   normalize_y=False, optimizer=None)
    gpr.fit(X, 0.1 * rng.normal(size=(30, 6)))
    path = str(tmp_path / "bare.pkl")
    with open(path, "wb") as f:
        pickle.dump(gpr, f)
    kind, post, meta = load_reference_gp(path, device="cpu")
    assert kind == "single" and meta == j_load_reference(path)[2]
    assert meta["jitter"] == pytest.approx(3e-3) and meta["normalize_y"] is False
    Xq = rng.normal(size=(5, 10))
    np.testing.assert_allclose(predict(post, torch.from_numpy(Xq))[0].numpy(), gpr.predict(Xq),
                               atol=SKLEARN_TOL)


def test_loading_refuses_kernels_it_cannot_carry(tmp_path, rng):
    X = rng.normal(size=(20, 3))
    gpr = GaussianProcessRegressor(kernel=RBF(1.0) + RBF(2.0), optimizer=None)
    gpr.fit(X, rng.normal(size=20))
    path = str(tmp_path / "two_rbf.pkl")
    with open(path, "wb") as f:
        pickle.dump(gpr, f)
    with pytest.raises(ValueError, match="multiple RBF"):
        load_sklearn_gp_pickle(path, device="cpu")
