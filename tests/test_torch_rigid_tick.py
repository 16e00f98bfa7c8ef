"""Port parity for kernel K11 and the fused multi-tick tiers of the 12-state
family against the JAX package on the CPU.

K11's plain version (which the wrapper runs for CPU tensors) is held
against the JAX kernel in interpret mode on the JAX package's own padded
operands, cut to semantic shapes by ``convert.rigid_tick_operands_from_
numpy``, for both in-kernel plants at N=20 over one launch of K=4 ticks.
The flights ``direct_rate_multitick_fused`` and ``rigid_multitick_fused``
(horizon 8, K=4, 24 ticks) are held against the JAX tiers.

Tolerances: K11 2e-4 on every output (measured: over these 120 float32
ADMM steps the plain version's own float32 run differs from its float64 run
on the same operands by 2.0e-5 on u and 4.9e-5 on the equilibrated slack,
and from the JAX kernel by 1.8e-5 and 1.2e-4: the 320-term matvecs of two
libraries round differently, and the ADMM carries the rounding on); the
flights 1e-4 on u and the state, and the circle RMS within 5e-3 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control import mpc_rigid as jmr
from unmanned_aerial_vehicles_tpu.loop import rigid_loop as jloop
from unmanned_aerial_vehicles_tpu.models import X500_PARAMS as JX500
from unmanned_aerial_vehicles_tpu.ops import qp as jqp
from unmanned_aerial_vehicles_tpu.ops.rigid_tick_pallas import _pad_lane, direct_rate_multitick_kernel as j_k11
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference as j_circle
from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control import mpc_rigid as tmr
from unmanned_aerial_vehicles_tpu_torch.loop import rigid_loop as tloop
from unmanned_aerial_vehicles_tpu_torch.models import X500_PARAMS
from unmanned_aerial_vehicles_tpu_torch.ops import rigid_tick_pallas as tk11
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

torch.set_num_threads(1)

DT, H = 0.02, 3.0
K11_TOL, FLIGHT_TOL, RMS_TOL = 2e-4, 1e-4, 5e-3
STATICS = dict(iterations=30, over_relax=1.6, dt=DT, substeps=1, gravity=9.81,
               taus=(0.05, 0.05, 0.08))


def jax_operands(eng, x, z, y, refs, K):
    """The JAX fused tier's padded K11 operands for one dispatch about the
    hover plan at ``x`` (``loop/rigid_loop.py:direct_rate_multitick_fused``'s
    relinearisation and layouts), and its equilibrated constraint matrix Gs
    (m, N nu), the first factor of P1 that the port's kernel reads."""
    mpc, cost = eng.mpc, eng.cost
    N, nx, nu = mpc.config.horizon, mpc.nx, mpc.nu
    Nnu, Nnx = N * nu, N * nx
    m = Nnu + Nnx
    nu_pad, nx_pad, m_pad = _pad_lane(Nnu), _pad_lane(Nnx), _pad_lane(m)
    f32 = jnp.float32
    hi = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=hi)
    qbar = jnp.concatenate([jnp.tile(cost.q_stage, N - 1), cost.q_terminal]).astype(f32)
    rbar = jnp.tile(cost.r_control, N).astype(f32)
    X_bar = jnp.tile(x[None, :], (N + 1, 1))
    U_bar = jnp.tile(eng.u_hover[None, :], (N, 1))
    res = jnp.zeros((N, nx), f32)
    A, B = jax.vmap(jax.jacfwd(mpc.step_fn, argnums=(0, 1)))(X_bar[:-1], U_bar, res)
    X_next = jax.vmap(mpc.step_fn)(X_bar[:-1], U_bar, res)
    c = X_next - jnp.einsum("kij,kj->ki", A, X_bar[:-1]) - jnp.einsum("kij,kj->ki", B, U_bar)
    Sx, Su, Sc = jqp.condense_ltv_doubling(A, B, c)
    SuT_q = Su.T * qbar[None, :]
    Hm = mm(SuT_q, Su) + jnp.diag(rbar)
    G = jnp.concatenate([jnp.eye(Nnu, dtype=f32), Su], axis=0)
    d = 1.0 / jnp.sqrt(jnp.diagonal(Hm) + 1e-10)
    Gd = G * d[None, :]
    e = 1.0 / jnp.sqrt(jnp.sum(Gd**2, axis=1) + 1e-10)
    Gs = Gd * e[:, None]
    M = Hm * d[:, None] * d[None, :] + mpc.config.admm_rho * mm(Gs.T, Gs)
    Minv = jax.scipy.linalg.cho_solve((jnp.linalg.cholesky(M), True), jnp.eye(Nnu, dtype=f32))
    GMinvT_s = mm(Minv, Gs.T)
    roll = lambda v, w: jnp.concatenate([v.reshape(N, w)[1:], v.reshape(N, w)[-1:]]).reshape(-1)
    e_shift = jnp.concatenate([roll(e[:Nnu], nu), roll(e[Nnu:], nx)])
    row = lambda v, n: jnp.zeros((1, n), f32).at[0, : v.shape[0]].set(v)
    ops = dict(
        sxct=jnp.zeros((16, nx_pad), f32).at[0:nx, :Nnx].set(Sx.T).at[12, :Nnx].set(Sc),
        sutqt=jnp.zeros((nx_pad, nu_pad), f32).at[:Nnx, :Nnu].set(SuT_q.T),
        f0_row=row(-rbar * jnp.tile(cost.u_ref.astype(f32), N), nu_pad),
        gml=jnp.zeros((nu_pad, m_pad), f32).at[:Nnu, :m].set(GMinvT_s),
        p1=jnp.zeros((m_pad, m_pad), f32).at[:m, :m].set(mm(Gs, GMinvT_s)),
        d_row=row(d, nu_pad), e_row=row(e, m_pad), ie_row=row(1.0 / e, m_pad),
        ce_row=row(e / e_shift, m_pad), ice_row=row(e_shift / e, m_pad),
        lo_row=row(jnp.concatenate([mpc._u_lo, mpc._x_lo]), m_pad),
        hi_row=row(jnp.concatenate([mpc._u_hi, mpc._x_hi]), m_pad),
    )
    carry = dict(x_row=jnp.zeros((1, 16), f32).at[0, 0:nx].set(x).at[0, 12].set(1.0),
                 z_row=row(z, m_pad), y_row=row(y, m_pad),
                 refs=jnp.zeros((K, nx_pad), f32).at[:, :Nnx].set(refs))
    return ops, carry, Gs


@pytest.mark.parametrize("plant", ["direct_rate", "rigid"])
def test_k11_plain_matches_jax_kernel(rng, plant):
    N, K = 20, 4
    eng = jmr.DirectRateMPC() if plant == "direct_rate" else jmr.RigidBodyMPC(horizon=N)
    m, Nnx = N * 16, N * 12
    x = np.zeros(12, np.float32)
    x[2] = H
    x += (0.05 * rng.normal(size=12)).astype(np.float32)
    z = (0.3 * rng.normal(size=m)).astype(np.float32)
    y = (0.1 * rng.normal(size=m)).astype(np.float32)
    pos = np.stack([np.asarray(j_circle(jnp.float32(10.0 + DT * k), amplitude=2.0, height=H)[0])
                    for k in range(K)])
    refs = np.tile(np.concatenate([pos, np.zeros((K, 9))], 1)[:, None, :], (1, N, 1))
    refs = refs.reshape(K, Nnx).astype(np.float32)
    ops, carry, gs = jax_operands(eng, jnp.asarray(x), jnp.asarray(z), jnp.asarray(y),
                                  jnp.asarray(refs), K)
    rigid = (JX500.mass, JX500.k_drag_linear, JX500.k_drag_angular, JX500.inertia_xx,
             JX500.inertia_yy, JX500.inertia_zz, *JX500.wind) if plant == "rigid" else None
    want = j_k11(carry["x_row"], carry["z_row"], carry["y_row"], carry["refs"], *ops.values(),
                 k_ticks=K, n=N, nu=4, nx=12, rho=float(eng.mpc.config.admm_rho), plant=plant,
                 rigid_consts=rigid, interpret=True, **STATICS)
    want = [np.asarray(w) for w in want]

    t_ops = convert.rigid_tick_operands_from_numpy(*(np.asarray(v) for v in ops.values()),
                                                   horizon=N, gs=np.asarray(gs), device="cpu")
    np.testing.assert_allclose((t_ops.Gs.double() @ t_ops.GMinvT_s.double()).numpy(),
                               t_ops.P1.numpy(), rtol=0, atol=1e-5)
    tx, tz, ty, trefs = convert.rigid_tick_carry_from_numpy(
        *(np.asarray(carry[k]) for k in ("x_row", "z_row", "y_row", "refs")), horizon=N,
        device="cpu")
    out, x_fin, z_fin, y_fin = tk11.direct_rate_multitick_kernel(
        tx, tz, ty, trefs, t_ops, k_ticks=K, n=N, nu=4, nx=12,
        rho=float(eng.mpc.config.admm_rho), plant=plant,
        body=X500_PARAMS if plant == "rigid" else None, **STATICS)
    assert tuple(out.shape) == (K, tk11.OUT_LANES)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), want[0][:, :16], rtol=0, atol=K11_TOL)
    np.testing.assert_allclose(x_fin.numpy(), want[1][0, :12], rtol=0, atol=K11_TOL)
    np.testing.assert_allclose(z_fin.numpy(), want[2][0, :m], rtol=0, atol=K11_TOL)
    np.testing.assert_allclose(y_fin.numpy(), want[3][0, :m], rtol=0, atol=K11_TOL)
    # the controls moved off the hover guess: the ADMM did work
    assert float(np.abs(out.numpy()[:, 12:16] - np.asarray(eng.u_hover)).max()) > 1e-3


def _circle_refs(N, framework):
    if framework == "jax":
        def reference_fn(ticks):
            pos, _, _ = jax.vmap(lambda t: j_circle(t, amplitude=2.0, height=H))(
                ticks.astype(jnp.float32) * DT)
            stage = jnp.concatenate([pos, jnp.zeros((ticks.shape[0], 9))], axis=1)
            return jnp.tile(stage[:, None, :], (1, N, 1))
    else:
        def reference_fn(ticks):
            pos, _, _ = ramped_circle_reference(ticks.to(torch.float32) * DT, amplitude=2.0,
                                                height=H)
            stage = torch.cat([pos, torch.zeros(ticks.shape[0], 9)], dim=1)
            return stage[:, None, :].repeat(1, N, 1)
    return reference_fn


def _rms(states, T):
    pos, _, _ = ramped_circle_reference(torch.arange(T, dtype=torch.float32) * DT, amplitude=2.0,
                                        height=H)
    return float(np.sqrt(np.mean(np.sum((np.asarray(states)[:, 0:3] - pos.numpy()) ** 2, -1))))


@pytest.mark.parametrize("plant,plan_roll", [("direct_rate", "nonlinear"),
                                             ("direct_rate", "linear"), ("rigid", "linear")])
def test_fused_multitick_flight_matches_jax(plant, plan_roll):
    N, K, T = 8, 4, 24
    if plant == "direct_rate":
        jeng, teng = jmr.DirectRateMPC(horizon=N), tmr.DirectRateMPC(horizon=N, device="cpu")
        jfly, tfly = jloop.direct_rate_multitick_fused, tloop.direct_rate_multitick_fused
    else:
        jeng, teng = jmr.RigidBodyMPC(horizon=N), tmr.RigidBodyMPC(horizon=N, device="cpu")
        jfly, tfly = jloop.rigid_multitick_fused, tloop.rigid_multitick_fused
    x0 = np.zeros(12, np.float32)
    x0[2] = H
    kw = dict(ticks_per_dispatch=K, admm_iterations=30, dt=DT, plan_roll=plan_roll)
    want = jax.jit(lambda x: jfly(jeng.mpc, jeng.cost, _circle_refs(N, "jax"), x, T,
                                  u_init=jeng.u_hover, **kw))(jnp.asarray(x0))
    got = tfly(teng.mpc, teng.cost, _circle_refs(N, "torch"), torch.tensor(x0), T,
               u_init=teng.u_hover, **kw)
    assert got["state"].dtype == torch.float32 and tuple(got["u"].shape) == (T, 4)
    for key in ("state", "u"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=FLIGHT_TOL, err_msg=key)
    for name in ("state", "X_plan", "U_plan"):
        np.testing.assert_allclose(getattr(got["carry"], name).numpy(),
                                   np.asarray(getattr(want["carry"], name)), rtol=0,
                                   atol=FLIGHT_TOL, err_msg=name)
    assert abs(_rms(got["state"].numpy(), T) - _rms(want["state"], T)) <= RMS_TOL
