"""Port parity: the plain version of the multi-tick kernel K5
(``ops.tick_pallas.multitick_staged``, which the wrapper runs for CPU
tensors) against the JAX package's staged twin
(``ops/tick_ad.py:multitick_staged``) and its Pallas kernel in interpret
mode, from identical operands built by JAX and carried across.

Tolerance 1e-5 on the packed lanes 0:32 and every carry-out: all three are
float32 with HIGHEST-precision products; the GP cross-kernel, the offset
and the ADMM matvecs sum in different orders (~1e-7 relative each), and 4
ticks of 20 ADMM iterations amplify that by at most ~10x on O(1) values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig as JGPCfg, fit_residual_gp as j_fit
from unmanned_aerial_vehicles_tpu.ops.plant_pallas import build_plant_row as j_plant_row
from unmanned_aerial_vehicles_tpu.ops.tick_ad import multitick_staged as j_staged
from unmanned_aerial_vehicles_tpu.ops.tick_pallas import (
    build_gp_rows as j_gp_rows,
    build_tick_data as j_tick_data,
    gpmpc_multitick_fused as j_kernel,
)
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.ops import tick_pallas

torch.set_num_threads(1)

N, K, P = 10, 4, 32
CASES = {
    "gp": dict(use_gp=True, fallback_error_m=0.0),
    "no_gp": dict(use_gp=False, fallback_error_m=0.0),
    "gp_fallback": dict(use_gp=True, fallback_error_m=0.3),
}


def statics(case):
    return dict(
        k_ticks=K, use_gp=CASES[case]["use_gp"], rho=8.0, iterations=20, over_relax=1.6,
        dt=0.02, substeps=2, accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0),
        yawrate_limit=0.8, loop_precision="highest", n=N, nu=4, nx=6,
        fallback_error_m=CASES[case]["fallback_error_m"], fallback_thrust_ceiling=1.5,
        fallback_accel_scale=1.5,
    )


@pytest.fixture(scope="module")
def operands():
    """JAX-built operands (float32 rows as the JAX flight loop builds them)."""
    rng = np.random.default_rng(0)
    jm = JMPC(JCfg(horizon=N, admm_iterations=20, use_fused_controller=True))
    data = j_tick_data(jm._fc_data, N, 4, 6)
    n_pad, m_pad = jm._fc_data.SxT.shape[0], jm._fc_data.P1.shape[0]
    m = jm.n_constraints
    X = rng.normal(size=(P, 10)) * 0.5
    X[:, 2] += 3.0
    Y = 0.05 * rng.normal(size=(P, 6)) + 0.02
    jpost = j_fit(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), JGPCfg())
    gp = j_gp_rows(jpost, 1.0)
    x0 = np.zeros(12, np.float32)
    x0[:3] = [0.2, -0.1, 2.7]
    x0[3:6] = [0.3, 0.1, -0.2]
    x0[6:9] = [0.05, -0.04, 0.3]

    def row(v, size):
        r = np.zeros((1, size), np.float32)
        r[0, : len(v)] = v
        return jnp.asarray(r)

    aux = np.zeros(11, np.float32)
    aux[:6] = x0[:6] + 0.01
    aux[8:11] = [0.02, -0.01, 0.05]
    xtail = np.tile(x0[:6], N) + 0.05 * rng.normal(size=N * 6).astype(np.float32)
    z0 = np.zeros(m, np.float32)
    z0[: N * 4] = 0.3 * rng.normal(size=N * 4)
    y0 = (0.1 * rng.normal(size=m)).astype(np.float32)
    refs = np.zeros((K, n_pad), np.float32)
    for k in range(K):
        refs[k, : N * 6] = np.tile([0.5 + 0.05 * k, 0.2, 3.0, 0, 0, 0], N)
        refs[k, n_pad - 1] = 0.1 * k                 # yaw_ref lane
    rows = (row(x0, n_pad), row(aux, n_pad), row(xtail, n_pad), row(z0, m_pad),
            row(y0, m_pad), jnp.asarray(refs),
            j_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81, (0.8, 0.4, 0.0)))
    return jm, data, gp, rows


@pytest.fixture(scope="module", params=sorted(CASES))
def case_results(request, operands):
    case = request.param
    jm, data, gp, rows = operands
    st = statics(case)
    gp_arg = gp if st["use_gp"] else None
    staged = j_staged(data, gp_arg, *rows, **st)
    kernel = j_kernel(data, gp_arg, *rows, interpret=True, **st)

    n_pad = jm._fc_data.SxT.shape[0]
    pdata = convert.fused_tick_data_from_numpy(jm._fc_data._asdict(), N, device="cpu")
    pgp = convert.gp_rows_from_numpy(*(np.asarray(a) for a in gp[:6]), device="cpu")
    carry = convert.multitick_carry_from_numpy(*(np.asarray(r) for r in rows[:5]), N,
                                               device="cpu")
    refs = np.asarray(rows[5])
    prefs = torch.from_numpy(np.ascontiguousarray(refs[:, : N * 6]))
    pyaw = torch.from_numpy(np.ascontiguousarray(refs[:, n_pad - 1]))
    pplant = torch.from_numpy(np.asarray(rows[6])[0, :10].copy())
    got = tick_pallas.gpmpc_multitick_fused(
        pdata, pgp if st["use_gp"] else None, *carry, prefs, pyaw, pplant, **st
    )
    return case, got, staged, kernel


def port_view(jax_out):
    """The JAX outputs cut to the port's semantic shapes."""
    packed, state, aux, xtail, z, y = (np.asarray(a) for a in jax_out)
    m = N * 10
    return (packed[:, :32], state[0, :12], np.concatenate([aux[0, :6], aux[0, 8:11]]),
            xtail[0, : N * 6], z[0, :m], y[0, :m])


NAMES = ("packed", "state", "aux", "xtail", "z", "y")


def test_k5_plain_matches_jax_staged_twin(case_results):
    case, got, staged, _ = case_results
    for name, g, w in zip(NAMES, got, port_view(staged)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5, err_msg=f"{case}: {name}")


def test_k5_plain_matches_jax_kernel_interpret(case_results):
    case, got, _, kernel = case_results
    for name, g, w in zip(NAMES, got, port_view(kernel)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5, err_msg=f"{case}: {name}")
    if case == "gp_fallback":
        # tick 0 starts 0.52 m from its reference: the hover fallback, not
        # the clipped MPC command, is what the allocation consumed
        packed = got[0].numpy()
        mpc_cmd = np.clip(packed[0, 25:28], (-3.5, -3.5, -4.0), (3.5, 3.5, 6.0))
        assert np.max(np.abs(packed[0, 22:25] - mpc_cmd)) > 1e-3


def test_gp_rows_built_by_port_match_jax(operands):
    jm, data, gp, rows = operands
    rng = np.random.default_rng(0)
    X = rng.normal(size=(P, 10)) * 0.5
    X[:, 2] += 3.0
    Y = 0.05 * rng.normal(size=(P, 6)) + 0.02
    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import fit_residual_gp

    post = fit_residual_gp(torch.tensor(X, dtype=torch.float32),
                           torch.tensor(Y, dtype=torch.float32))
    got = tick_pallas.build_gp_rows(post, 1.0)
    want = convert.gp_rows_from_numpy(*(np.asarray(a) for a in gp[:6]), device="cpu")
    assert got.kinv is None and got.y_std is None
    for name, g, w in zip(got._fields[:6], got, want):
        # float32 values up to ~70 (squared norms): relative 1e-6
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
    # with the variance operands: K^-1 (entries up to ~10) and y_std
    jpost = j_fit(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), JGPCfg())
    got = tick_pallas.build_gp_rows(post, 1.0, with_variance=True)
    want = convert.gp_rows_from_numpy(*(np.asarray(a) for a in j_gp_rows(jpost, 1.0,
                                                                         with_variance=True)),
                                      device="cpu")
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
    from unmanned_aerial_vehicles_tpu_torch.gp.kernels import rbf_kernel

    Xt = post.X_train.double()
    K_train = (rbf_kernel(Xt, Xt, post.params.length_scale, post.params.signal_variance)
               + (post.params.noise_variance + JGPCfg().alpha) * torch.eye(P, dtype=torch.float64))
    resid = got.kinv.double() @ K_train - torch.eye(P, dtype=torch.float64)
    assert float(resid.abs().max()) < 1e-5


def test_shared_memory_fits_horizon_20_not_25():
    limit = 232448   # H100: the most dynamic shared memory one block may opt into
    assert tick_pallas.shared_memory_bytes(20) <= limit
    assert tick_pallas.shared_memory_bytes(23) <= limit
    assert tick_pallas.shared_memory_bytes(25) > limit


def test_k5_wrapper_checks_operands(operands):
    jm, _, _, _ = operands
    pdata = convert.fused_tick_data_from_numpy(jm._fc_data._asdict(), N, device="cpu")
    m = N * 10
    args = [torch.zeros(12), torch.zeros(9), torch.zeros(N * 6), torch.zeros(m),
            torch.zeros(m), torch.zeros(K, N * 6), torch.zeros(K), torch.zeros(10)]
    st = statics("no_gp")
    with pytest.raises(ValueError, match="shape"):
        tick_pallas.gpmpc_multitick_fused(pdata, None, torch.zeros(11), *args[1:], **st)
    with pytest.raises(ValueError, match="float32"):
        tick_pallas.gpmpc_multitick_fused(pdata, None, *args[:3], torch.zeros(m).double(),
                                          *args[4:], **st)
    out = tick_pallas.gpmpc_multitick_fused(pdata, None, *args, **st)
    assert [tuple(o.shape) for o in out] == [(K, 32), (12,), (9,), (N * 6,), (m,), (m,)]
    # tighten_kappa acts only with the GP on (as in the JAX package), and
    # then needs the variance rows
    again = tick_pallas.gpmpc_multitick_fused(pdata, None, *args, **{**st, "tighten_kappa": 1.0})
    torch.testing.assert_close(again, out, rtol=0, atol=0, equal_nan=True)
    _, _, gp, _ = operands
    rows = convert.gp_rows_from_numpy(*(np.asarray(a) for a in gp[:6]), device="cpu")
    with pytest.raises(ValueError, match="with_variance"):
        tick_pallas.gpmpc_multitick_fused(pdata, rows, *args,
                                          **{**statics("gp"), "tighten_kappa": 1.0})
