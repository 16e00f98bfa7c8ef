"""Port parity for the 12-state rigid body against the JAX package on the
CPU: the model (derivative, RK4, Euler) in float64, the parameter sets,
the circle reference, and kernel K10's plain version (which the wrapper
runs for CPU tensors) against the JAX kernel in interpret mode.

Tolerances: the model in float64 to 1e-12 (the same expressions, summed in
another order); K10 in float32 to 2e-6, relative to the state's size (the
same scalar expressions; the sines and tangents of two libraries differ in
the last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.models import params as jparams
from unmanned_aerial_vehicles_tpu.models import rigid_body as jrb
from unmanned_aerial_vehicles_tpu.ops import rigid_plant_pallas as jk10
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference as j_circle
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.models import params as tparams
from unmanned_aerial_vehicles_tpu_torch.models import rigid_body as trb
from unmanned_aerial_vehicles_tpu_torch.ops import rigid_plant_pallas as tk10
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

torch.set_num_threads(1)

FIELDS = ("mass", "gravity", "inertia_xx", "inertia_yy", "inertia_zz", "k_drag_linear",
          "k_drag_angular", "wind")
SETS = ("GZ_QUADROTOR_PARAMS", "X500_PARAMS", "COMPARISON_PARAMS")
WIND = (0.6, -0.4, 0.2)


def states(rng, n):
    return rng.normal(size=(n, 12)) * np.array([2, 2, 1, 3, 3, 2, 0.6, 0.6, 2.0, 2, 2, 1.5])


def param_pair(name, wind=WIND):
    jp = getattr(jparams, name).replace(wind=wind)
    return jp, convert.rigid_params_from_numpy({f: getattr(jp, f) for f in FIELDS})


@pytest.mark.parametrize("name", SETS)
def test_param_sets_match_field_by_field(name):
    jp, tp = getattr(jparams, name), getattr(tparams, name)
    for f in FIELDS:
        assert np.allclose(np.asarray(getattr(jp, f)), np.asarray(getattr(tp, f)), rtol=0, atol=0), f
    np.testing.assert_array_equal(np.asarray(jp.inertia_diag), np.asarray(tp.inertia_diag))
    assert convert.rigid_params_from_numpy({f: getattr(jp, f) for f in FIELDS}) == tp


@pytest.mark.parametrize("fn", ["derivative", "rk4", "euler"])
def test_model_matches_jax_f64(rng, fn):
    jp, tp = param_pair("GZ_QUADROTOR_PARAMS")
    x, u, res = states(rng, 8), rng.normal(size=(8, 4)), 0.1 * rng.normal(size=(8, 12))
    u[:, 0] = 4.0 + np.abs(u[:, 0])
    jx, ju, jr = (jnp.asarray(a) for a in (x, u, res))
    tx, tu, tr = (torch.tensor(a) for a in (x, u, res))
    if fn == "derivative":
        want = jrb.rigid_body_derivative(jx, ju, jp, jr)
        got = trb.rigid_body_derivative(tx, tu, tp, tr)
    elif fn == "rk4":
        want = jrb.rigid_body_rk4_step(jx, ju, jp, 0.02, jr)
        got = trb.rigid_body_rk4_step(tx, tu, tp, 0.02, tr)
    else:
        want = jrb.rigid_body_euler_step(jx, ju, jp, 0.02, jr)
        got = trb.rigid_body_euler_step(tx, tu, tp, 0.02, tr)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_jacobian_at_hover_is_finite_and_matches_jax():
    """The gradient-safe norm: jacfwd at zero airspeed gives no NaN."""
    jp, tp = jparams.X500_PARAMS, tparams.X500_PARAMS
    x = np.zeros(12)
    x[2] = 3.0
    u = np.array([jp.mass * jp.gravity, 0.0, 0.0, 0.0])
    want = jax.jacfwd(lambda s, c: jrb.rigid_body_euler_step(s, c, jp, 0.02), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(u))
    got = torch.func.jacfwd(lambda s, c: trb.rigid_body_euler_step(s, c, tp, 0.02), argnums=(0, 1))(
        torch.tensor(x), torch.tensor(u))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-14)


def test_circle_reference_matches_jax():
    t = np.linspace(-1.0, 30.0, 97)
    want = j_circle(jnp.asarray(t), amplitude=2.0, frequency=0.05, height=3.0)
    got = ramped_circle_reference(torch.tensor(t), amplitude=2.0, frequency=0.05, height=3.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-14)


def _rollout_case(rng, n):
    """A random state and controls around hover (GZ mass): one step, or a
    20-step plan roll at 10 Hz as the LTV flight's re-anchor makes."""
    x0 = states(rng, 1)[0] * 0.3
    U = np.array([4.9, 0.0, 0.0, 0.0]) + rng.normal(size=(n, 4)) * np.array([0.5, 2e-3, 2e-3, 2e-3])
    res = 0.1 * rng.normal(size=(n, 12))
    return [np.asarray(a, np.float32) for a in (x0, U, res)]


def _k10_pair(x0, U, res, jp, tp, dt, substeps):
    want = np.asarray(jk10.rigid_body_rollout_fused(
        jnp.asarray(x0), jnp.asarray(U), jp, dt, substeps, jnp.asarray(res), interpret=True))
    got = tk10.rigid_body_rollout_fused(torch.tensor(x0), torch.tensor(U), tp, dt, substeps,
                                        torch.tensor(res))
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("n", [1, 20])
@pytest.mark.parametrize("substeps", [1, 2])
def test_k10_plain_matches_jax_kernel(rng, n, substeps):
    jp, tp = param_pair("GZ_QUADROTOR_PARAMS")
    x0, U, res = _rollout_case(rng, n)
    _k10_pair(x0, U, res, jp, tp, 0.1 if n == 20 else 0.02, substeps)


@pytest.mark.parametrize("pitch", [np.pi / 2 - 1e-7, np.pi / 2 + 1e-7, -np.pi / 2])
@pytest.mark.parametrize("substeps", [1, 2])
def test_k10_plain_near_singular_pitch(pitch, substeps):
    """The |cos(theta)| >= 1e-6 guard (the JAX package's own case)."""
    jp, tp = param_pair("GZ_QUADROTOR_PARAMS")
    x0 = np.zeros(12, np.float32)
    x0[7], x0[10] = pitch, 0.5
    U = np.array([[5.0, 0.01, 0.0, 0.0]], np.float32)
    _k10_pair(x0, U, np.zeros((1, 12), np.float32), jp, tp, 0.01, substeps)


def test_k10_step_forms_match_jax(rng):
    """The one-step kernel form and the flights' backend-aware step."""
    jp, tp = param_pair("X500_PARAMS")
    x0, U, res = _rollout_case(rng, 1)
    want = np.asarray(jk10.rigid_body_rk4_step_fused(
        jnp.asarray(x0), jnp.asarray(U[0]), jp, 0.02, 2, jnp.asarray(res[0]), interpret=True))
    got = tk10.rigid_body_rk4_step_fused(torch.tensor(x0), torch.tensor(U[0]), tp, 0.02, 2,
                                         torch.tensor(res[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    x64, u64 = x0.astype(np.float64), U[0].astype(np.float64)
    want = np.asarray(jk10.rigid_body_rk4_step_fast(jnp.asarray(x64), jnp.asarray(u64), jp, 0.02, 2))
    fast = tk10.rigid_body_rk4_step_fast(torch.tensor(x64), torch.tensor(u64), tp, 0.02, 2)
    assert fast.dtype == torch.float64
    np.testing.assert_allclose(fast.numpy(), want, rtol=1e-12, atol=1e-12)
