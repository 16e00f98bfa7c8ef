"""Port parity: the plain version of the noisy multi-tick kernel K9
(``ops.tick_pallas.noisy_multitick_staged``, which the wrapper runs for CPU
tensors) against the JAX package's Pallas kernel in interpret mode, from
identical carries built by JAX and carried across with
``convert.noisy_carry_from_numpy``.

Tolerance 1e-5 on the packed rows and the carries, 1e-5 * max|P| on the
covariance: both sides are float32; the Jacobian chain, the covariance
products and the ADMM matvecs sum in different orders (~1e-7 relative each)
and 4 ticks of 20 ADMM iterations amplify that by at most ~10x.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC, LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig as JGPCfg, fit_residual_gp as j_fit
from unmanned_aerial_vehicles_tpu.ops.plant_pallas import build_plant_row as j_plant_row
from unmanned_aerial_vehicles_tpu.ops.tick_pallas import (
    EKF_MEAS_IDX as J_MEAS_IDX,
    PK,
    build_dob_bdist as j_bdist,
    build_gp_rows as j_gp_rows,
    build_tick_data as j_tick_data,
    gpmpc_noisy_multitick_fused as j_kernel,
)
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.ops import tick_pallas

torch.set_num_threads(1)

N, K, P = 10, 4, 32
WIND = (0.8, 0.4, 0.0)
CASES = {
    "gp_gust_rows": dict(use_gp=True, rows=True),
    "no_gp": dict(use_gp=False),
    "observer_gp_gust_rows": dict(use_gp=True, use_dob=True, rows=True),
    "dispatch": dict(use_gp=True, relinearize_per_tick=False),
    "fallback": dict(use_gp=True, fallback_error_m=0.3),
}


def statics(case):
    c = CASES[case]
    return dict(
        k_ticks=K, use_gp=c["use_gp"], rho=8.0, iterations=20, over_relax=1.6,
        dt=0.02, substeps=2, accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0),
        yawrate_limit=0.8, loop_precision="highest", n=N, nu=4, nx=6,
        fallback_error_m=c.get("fallback_error_m", 0.0), fallback_thrust_ceiling=1.5,
        fallback_accel_scale=1.5, relinearize_per_tick=c.get("relinearize_per_tick", True),
        use_dob=c.get("use_dob", False),
    )


@pytest.fixture(scope="module")
def operands():
    """JAX-built operands, in the layouts the JAX noisy flight builds."""
    rng = np.random.default_rng(0)
    jm = JMPC(JCfg(horizon=N, admm_iterations=20, use_fused_controller=True))
    data = j_tick_data(jm._fc_data, N, 4, 6)
    n_pad, m_pad = jm._fc_data.SxT.shape[0], jm._fc_data.P1.shape[0]
    m = jm.n_constraints
    X = rng.normal(size=(P, 10)) * 0.5
    X[:, 2] += 3.0
    Y = 0.05 * rng.normal(size=(P, 6)) + 0.02
    gp = j_gp_rows(j_fit(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), JGPCfg()), 1.0)

    def row(v, size):
        r = np.zeros((1, size), np.float32)
        r[0, : len(v)] = v
        return jnp.asarray(r)

    x0 = np.zeros(12, np.float32)
    x0[:3] = [0.2, -0.1, 2.7]
    x0[3:6] = [0.3, 0.1, -0.2]
    x0[6:9] = [0.05, -0.04, 0.3]
    x0[9:12] = [0.1, -0.05, 0.02]
    est = np.zeros(15, np.float32)
    est[:12] = x0 + 0.02 * rng.normal(size=12)
    est[12:] = [0.4, -0.2, 0.1]                                   # observer's d
    A = 0.02 * rng.normal(size=(15, 15))
    P0 = (np.diag(np.linspace(0.01, 0.002, 15)) + A @ A.T).astype(np.float32)
    p_mat = np.zeros((PK, PK), np.float32)
    p_mat[:15, :15] = P0
    aux = np.zeros(15, np.float32)
    aux[:6] = est[:6] + 0.01
    aux[8:11] = [0.02, -0.01, 0.05]
    aux[11:15] = [1.02, 0.1, -0.05, 0.03]                        # applied control
    xtail = np.tile(x0[:6], N) + 0.05 * rng.normal(size=N * 6).astype(np.float32)
    z0 = np.zeros(m, np.float32)
    z0[: N * 4] = 0.3 * rng.normal(size=N * 4)
    y0 = (0.1 * rng.normal(size=m)).astype(np.float32)
    refs = np.zeros((K, n_pad), np.float32)
    for k in range(K):
        refs[k, : N * 6] = np.tile([0.5 + 0.05 * k, 0.2, 3.0, 0, 0, 0], N)
        refs[k, n_pad - 1] = 0.1 * k                               # yaw_ref lane
    r9 = np.array([0.05**2] * 3 + [0.01**2] * 3 + [0.02**2] * 3, np.float32)
    noise = np.zeros((K, n_pad), np.float32)
    noise[:, list(J_MEAS_IDX)] = np.sqrt(r9) * rng.normal(size=(K, 9))
    q15 = np.array([1e-3**2] * 3 + [2e-2**2] * 3 + [1e-3**2] * 3 + [5e-2**2] * 3 + [0.05**2] * 3,
                   np.float32)
    q_mat = np.zeros((PK, PK), np.float32)
    q_mat[np.arange(15), np.arange(15)] = q15
    rdiag = np.zeros((1, PK), np.float32)
    rdiag[0, list(J_MEAS_IDX)] = r9
    plant = j_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81, WIND)
    gust = jnp.concatenate([j_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81,
                                        (0.8 + 0.5 * k, 0.4 - 0.3 * k, 0.1))
                            for k in range(K)])
    nominal = j_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81, (0.0, 0.0, 0.0))
    return dict(jm=jm, data=data, gp=gp, x0=row(x0, n_pad), est=est, p_mat=p_mat,
                aux=row(aux, n_pad), xtail=row(xtail, n_pad), z0=row(z0, m_pad),
                y0=row(y0, m_pad), refs=refs, noise=noise, q_mat=q_mat, q15=q15, rdiag=rdiag,
                r9=r9, plant=plant, gust=gust, nominal=nominal, n_pad=n_pad)


@pytest.fixture(scope="module", params=sorted(CASES))
def case_results(request, operands):
    case = request.param
    o = operands
    st = statics(case)
    c = CASES[case]
    use_dob = st["use_dob"]
    n_est = 15 if use_dob else 12
    est = o["est"] if use_dob else np.concatenate([o["est"][:12], np.zeros(3, np.float32)])
    p_mat = o["p_mat"].copy()
    if not use_dob:
        p_mat[12:, :] = 0.0
        p_mat[:, 12:] = 0.0
    q_mat = o["q_mat"].copy()
    if not use_dob:
        q_mat[12:15, 12:15] = 0.0
    plant = o["gust"] if c.get("rows") else o["plant"]
    gp = o["gp"] if st["use_gp"] else None
    n_pad = o["n_pad"]
    est_row = np.zeros((1, n_pad), np.float32)
    est_row[0, :15] = est
    jargs = (o["data"], gp, o["x0"], jnp.asarray(est_row), jnp.asarray(p_mat), o["aux"],
             o["xtail"], o["z0"], o["y0"], jnp.asarray(o["refs"]), jnp.asarray(o["noise"]), plant,
             jnp.asarray(q_mat), jnp.asarray(o["rdiag"]))
    jkw = dict(nominal_row=o["nominal"], bdist_mat=j_bdist(0.02)) if use_dob else {}
    want = j_kernel(*jargs, interpret=True, **jkw, **st)

    pdata = convert.fused_tick_data_from_numpy(o["jm"]._fc_data._asdict(), N, device="cpu")
    pgp = (convert.gp_rows_from_numpy(*(np.asarray(a) for a in gp[:6]), device="cpu")
           if gp is not None else None)
    carry = convert.noisy_carry_from_numpy(o["x0"], est_row, p_mat, o["aux"], o["xtail"], o["z0"],
                                           o["y0"], N, n_est=n_est, device="cpu")
    refs = o["refs"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    extra = {}
    if use_dob:
        extra = dict(nominal_row=convert.plant_rows_from_numpy(o["nominal"], device="cpu")[0],
                     bdist=tick_pallas.build_dob_bdist(0.02, device="cpu"))
    got = tick_pallas.gpmpc_noisy_multitick_fused(
        pdata, pgp, *carry[:5], carry[5], carry[6], t(refs[:, : N * 6]), t(refs[:, n_pad - 1]),
        t(o["noise"][:, list(J_MEAS_IDX)]), convert.plant_rows_from_numpy(plant, device="cpu"),
        t(o["q15"][:n_est]), t(o["r9"]), **extra, **st,
    )
    return case, n_est, got, want


def port_view(jax_out, n_est):
    """The JAX outputs cut to the port's semantic shapes."""
    packed, state, est, P, aux, xtail, z, y = (np.asarray(a) for a in jax_out)
    m = N * 10
    return (packed[:, :47], state[0, :12], est[0, :n_est], P[:n_est, :n_est],
            np.concatenate([aux[0, 0:6], aux[0, 8:11], aux[0, 11:15]]), xtail[0, : N * 6],
            z[0, :m], y[0, :m])


NAMES = ("packed", "state", "est", "P", "aux", "xtail", "z", "y")


def test_k9_plain_matches_jax_kernel_interpret(case_results):
    case, n_est, got, want = case_results
    shapes = [(K, 47), (12,), (n_est,), (n_est, n_est), (13,), (N * 6,), (N * 10,), (N * 10,)]
    assert [tuple(g.shape) for g in got] == shapes
    for name, g, w in zip(NAMES, got, port_view(want, n_est)):
        atol = 1e-5 * float(np.abs(w).max()) if name == "P" else 1e-5
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=f"{case}: {name}")
    packed = got[0].numpy()
    if case == "fallback":
        # the estimate starts 0.5 m from tick 0's reference: the hover
        # fallback, not the clipped MPC command, is what the allocation used
        mpc_cmd = np.clip(packed[0, 25:28], (-3.5, -3.5, -4.0), (3.5, 3.5, 6.0))
        assert np.max(np.abs(packed[0, 22:25] - mpc_cmd)) > 1e-3
    if n_est == 12:
        assert np.all(packed[:, 44:47] == 0.0)


def test_dob_bdist_matches_jax():
    got = tick_pallas.build_dob_bdist(0.02, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(j_bdist(0.02))[:15, :15])


def test_k9_shared_memory_fits_horizon_20():
    limit = 232448   # H100: the most dynamic shared memory one block may opt into
    assert tick_pallas.noisy_shared_memory_bytes(20) <= limit
    assert tick_pallas.noisy_shared_memory_bytes(20) > tick_pallas.shared_memory_bytes(20)


def test_k9_wrapper_checks_operands(operands):
    pdata = convert.fused_tick_data_from_numpy(operands["jm"]._fc_data._asdict(), N,
                                               device="cpu")
    m = N * 10
    args = [torch.zeros(12), torch.zeros(12), torch.eye(12), torch.zeros(13), torch.zeros(N * 6),
            torch.zeros(m), torch.zeros(m), torch.zeros(K, N * 6), torch.zeros(K),
            torch.zeros(K, 9), torch.zeros(1, 10), torch.ones(12), torch.ones(9)]
    st = statics("no_gp")
    with pytest.raises(ValueError, match="shape"):
        tick_pallas.gpmpc_noisy_multitick_fused(pdata, None, *args[:2], torch.eye(15), *args[3:],
                                                **st)
    with pytest.raises(ValueError, match="rows"):
        tick_pallas.gpmpc_noisy_multitick_fused(pdata, None, *args[:10], torch.zeros(2, 10),
                                                *args[11:], **st)
    with pytest.raises(ValueError, match="nominal_row"):
        tick_pallas.gpmpc_noisy_multitick_fused(pdata, None, args[0], torch.zeros(15),
                                                torch.eye(15), *args[3:11], torch.ones(15),
                                                args[12], **{**st, "use_dob": True})
    with pytest.raises(ValueError, match="cov_precision"):
        tick_pallas.gpmpc_noisy_multitick_fused(pdata, None, *args, **{**st, "cov_precision": "x"})
    out = tick_pallas.gpmpc_noisy_multitick_fused(pdata, None, *args, **st)
    assert [tuple(o.shape) for o in out] == [(K, 47), (12,), (12,), (12, 12), (13,), (N * 6,),
                                             (m,), (m,)]
