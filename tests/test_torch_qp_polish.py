"""Port parity for the QP verification tier against the JAX package on the
CPU, in float64: ``kkt_score``, ``kkt_residuals``, ``ip_box_qp`` and
``active_set_polish`` on a random strictly convex box QP with placeholder
(1e9) rows and on the LTV tracking MPC's own ill-conditioned QP (the
reference-anchored linearisation with an obstacle row, as in JAX
``tests/test_solver_parity_nonlinear.py``); then the paths they unlock:
``SQPConfig(polish=True)``, ``solve(return_kkt=True)``,
``nonlinear_kkt_score`` and the staged ``LinearMPC(polish=True)``.

Tolerance: 1e-8 (the same algebra in float64; products and factors round
differently), of the scale of the compared quantity where it passes 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control import mpc_rigid as jmr
from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC as JMPC
from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPCConfig as JCfg
from unmanned_aerial_vehicles_tpu.control.mpc_sqp import SQPConfig as JSQPConfig
from unmanned_aerial_vehicles_tpu.control.mpc_sqp import nonlinear_kkt_score as j_nl_kkt
from unmanned_aerial_vehicles_tpu.ops import qp as jqp
from unmanned_aerial_vehicles_tpu_torch.control import mpc_rigid as tmr
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.control.mpc_sqp import SQPConfig, nonlinear_kkt_score
from unmanned_aerial_vehicles_tpu_torch.ops import qp as tqp

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-8
LTV_N = 8
OBSTACLE = [[0.7, 0.35, 1.2, 0.25]]


def close(got, want, tol=TOL, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def random_qp(rng):
    """A strictly convex box QP (n=24, m=60) with five unbounded rows each
    way (JAX ``tests/test_qp.py::test_ip_box_qp_matches_reference``)."""
    n, m = 24, 60
    A = rng.standard_normal((n, n))
    H = A @ A.T + 0.5 * np.eye(n)
    G = rng.standard_normal((m, n))
    f = rng.standard_normal(n)
    center = G @ rng.standard_normal(n) * 0.1
    lo = center - rng.uniform(0.1, 1.0, m)
    hi = center + rng.uniform(0.1, 1.0, m)
    lo[:5] = -1e9
    hi[-5:] = 1e9
    return [H, G, f, lo, hi]


def ltv_qp():
    """The LTV tracking MPC's QP at horizon 8: linearised about a climbing
    reference line with hover controls, one obstacle row per stage."""
    eng = jmr.LTVTrackingMPC(config=JSQPConfig(horizon=LTV_N, admm_iterations=200,
                                               admm_rho=0.02),
                             num_obstacles=1, obstacle_margin=0.2, dtype=jnp.float64)
    state = jnp.zeros(12).at[2].set(1.0).at[3].set(0.3)
    ts = jnp.arange(LTV_N + 1, dtype=jnp.float64) * 0.1
    ref = (jnp.zeros((LTV_N + 1, 12)).at[:, 0].set(0.5 * ts).at[:, 2].set(1.0 + 0.2 * ts)
           .at[:, 3].set(0.5).at[:, 5].set(0.2))
    lin = (ref, jnp.tile(eng.u_hover[None, :], (LTV_N, 1)))
    qp = eng.mpc.qp_data(eng.init_carry(state), state, eng.cost, ref[1:], lin_trajectory=lin,
                         obstacles=jnp.asarray(OBSTACLE))
    return [np.asarray(a) for a in qp]


@pytest.fixture(scope="module")
def qps():
    return {"random": random_qp(np.random.default_rng(0)), "ltv": ltv_qp()}


@pytest.fixture(scope="module")
def jax_ip(qps):
    """JAX's interior-point solve of each QP (its default 60 iterations)."""
    return {name: jqp.ip_box_qp(*map(jnp.asarray, qp)) for name, qp in qps.items()}


def both(qp):
    return [jnp.asarray(a) for a in qp], [torch.tensor(a) for a in qp]


@pytest.mark.parametrize("name", ["random", "ltv"])
@pytest.mark.parametrize("iterate", ["interior_point", "perturbed"])
def test_kkt_score_and_residuals_match_jax(qps, jax_ip, name, iterate):
    """At the interior point's solution and at a perturbed iterate (a
    wrong-signed dual on a placeholder row among them)."""
    J, T = both(qps[name])
    U, y = np.asarray(jax_ip[name].primal), np.asarray(jax_ip[name].dual)
    if iterate == "perturbed":
        rng = np.random.default_rng(3)
        U = U + 0.05 * rng.standard_normal(U.shape)
        y = y + 0.05 * rng.standard_normal(y.shape)
    want = jqp.kkt_score(*J, jnp.asarray(U), jnp.asarray(y))
    got = tqp.kkt_score(*T, torch.tensor(U), torch.tensor(y))
    close(got, want)
    state_j = jqp.AdmmState(jnp.asarray(U), jnp.asarray(U), jnp.asarray(y))
    state_t = tqp.AdmmState(torch.tensor(U), torch.tensor(U), torch.tensor(y))
    for g, w in zip(tqp.kkt_residuals(*T, state_t), jqp.kkt_residuals(*J, state_j)):
        close(g, w)


@pytest.mark.parametrize("name", ["random", "ltv"])
@pytest.mark.parametrize("iterations", [8, 60])
def test_ip_box_qp_matches_jax(qps, jax_ip, name, iterations):
    """8 iterations (mid-path, every row live) and the default 60 (past the
    1e-13 barrier floor: the frozen iterate)."""
    J, T = both(qps[name])
    want = jax_ip[name] if iterations == 60 else jqp.ip_box_qp(*J, iterations=iterations)
    got = tqp.ip_box_qp(*T, iterations=iterations)
    for field in ("primal", "slack", "dual"):
        close(getattr(got, field), getattr(want, field), what=field)
    if iterations == 60:
        assert float(tqp.kkt_score(*T, got.primal, got.dual)) < 1e-8


def test_ip_box_qp_mu_floor_defaults_by_dtype(qps):
    """1e-13 in float64 and 1e-6 in float32: a float32 solve freezes where
    the float64 one goes on, and stays finite."""
    qp = qps["random"]
    T64 = [torch.tensor(a) for a in qp]
    T32 = [torch.tensor(a, dtype=torch.float32) for a in qp]
    got32 = tqp.ip_box_qp(*T32)
    assert got32.primal.dtype == torch.float32 and bool(torch.isfinite(got32.primal).all())
    same32 = tqp.ip_box_qp(*T32, mu_floor=1e-6)
    assert torch.equal(got32.primal, same32.primal)
    close(tqp.ip_box_qp(*T64).primal, tqp.ip_box_qp(*T64, mu_floor=1e-13).primal, tol=0.0)


@pytest.mark.parametrize("case", ["admm_random", "interior_point_ltv", "junk_random",
                                  "one_pass_no_refine_ltv"])
def test_active_set_polish_matches_jax(qps, jax_ip, case):
    """From a 60-iteration ADMM iterate, from the interior point's, from a
    junk iterate (no pass beats it: the input comes back) and with one pass
    and no refinement."""
    name = case.rsplit("_", 1)[1]
    J, T = both(qps[name])
    H, G, f, lo, hi = qps[name]
    kw = {}
    if case.startswith("admm"):
        rho = 10.0
        M_inv = np.linalg.inv(H + rho * G.T @ G)
        m = G.shape[0]
        start = jqp.admm_box_qp(jnp.asarray(M_inv), J[1], J[2], J[3], J[4], jnp.zeros(m),
                                jnp.zeros(m), rho, 60)
    elif case.startswith("junk"):
        rng = np.random.default_rng(5)
        start = jqp.AdmmState(jnp.asarray(rng.standard_normal(H.shape[0])),
                              jnp.zeros(G.shape[0]), jnp.asarray(rng.standard_normal(G.shape[0])))
    else:
        start = jax_ip[name]
        if case.startswith("one_pass"):
            kw = dict(passes=1, refine_steps=0)
    want = jqp.active_set_polish(*J, start, **kw)
    got = tqp.active_set_polish(*T, tqp.AdmmState(*[torch.tensor(np.asarray(a)) for a in start]),
                                **kw)
    for g, w, what in zip(got, want, ("U", "y", "score")):
        close(g, w, what=what)
    if case.startswith("junk"):
        close(got[0], np.asarray(start.primal), tol=0.0)
    else:
        assert float(got[2]) <= float(tqp.kkt_score(*T, torch.tensor(np.asarray(start.primal)),
                                                     torch.tensor(np.asarray(start.dual))))


# ---- the paths the verification tier unlocks ------------------------------------

H12 = 3.0


def rigid_pair(**cfg):
    jcfg = JSQPConfig(horizon=6, admm_rho=0.05, **cfg)
    tcfg = SQPConfig(horizon=6, admm_rho=0.05, **cfg)
    return (jmr.RigidBodyMPC(config=jcfg, dtype=jnp.float64),
            tmr.RigidBodyMPC(config=tcfg, dtype=F64, device="cpu"))


def start_state(rng):
    x = np.zeros(12)
    x[2] = H12
    return x + 0.02 * rng.normal(size=12)


@pytest.mark.parametrize("sqp_iterations", [1, 2])
def test_sqp_polish_solve_matches_jax(rng, sqp_iterations):
    """``SQPConfig(polish=True)``: the interior point then the polish in
    place of the ADMM, over two warm-started ticks."""
    jeng, teng = rigid_pair(polish=True, sqp_iterations=sqp_iterations, admm_iterations=40)
    x = start_state(rng)
    jc, tc = jeng.init_carry(jnp.asarray(x)), teng.init_carry(torch.tensor(x))
    for tick in range(2):
        target = np.array([0.5 + 0.2 * tick, -0.3, H12 + 0.2])
        ju, jX, jc = jeng.solve(jc, jnp.asarray(x), jnp.asarray(target), 0.2)
        tu, tX, tc = teng.solve(tc, torch.tensor(x), torch.tensor(target), 0.2)
        close(tu, ju, what=f"u0 tick {tick}")
        close(tX, jX, what=f"X tick {tick}")
        for name in ("slack", "dual", "X_prev", "U_prev"):
            close(getattr(tc, name), getattr(jc, name), what=f"{name} tick {tick}")
        x = np.asarray(jX[1])


@pytest.mark.parametrize("polish", [False, True])
def test_sqp_return_kkt_matches_jax(rng, polish):
    """``solve(return_kkt=True)`` over two relinearisations: the controls,
    the carry and each iteration's score against its own QP."""
    jeng, teng = rigid_pair(polish=polish, sqp_iterations=2, admm_iterations=60)
    x = start_state(rng)
    x_ref = np.tile(np.concatenate([[0.8, -0.4, H12 + 0.3], np.zeros(9)]), (6, 1))
    ju, jX, jc, jk = jeng.mpc.solve(jeng.init_carry(jnp.asarray(x)), jnp.asarray(x), jeng.cost,
                                    jnp.asarray(x_ref), return_kkt=True)
    tu, tX, tc, tk = teng.mpc.solve(teng.init_carry(torch.tensor(x)), torch.tensor(x), teng.cost,
                                    torch.tensor(x_ref), return_kkt=True)
    assert tuple(tk.shape) == (2,)
    close(tu, ju, what="u0")
    close(tc.dual, jc.dual, what="dual")
    for i in range(2):
        close(tk[i], jk[i], tol=1e-8 * max(1.0, float(jk[i])), what=f"kkt {i}")
    plain = teng.mpc.solve(teng.init_carry(torch.tensor(x)), torch.tensor(x), teng.cost,
                           torch.tensor(x_ref))
    assert len(plain) == 3 and torch.equal(plain[0], tu)


@pytest.mark.parametrize("kind", ["rigid", "ltv_obstacle"])
def test_nonlinear_kkt_score_matches_jax(rng, kind):
    """At the engine's own solve (its plan and duals), with obstacle rows
    for the LTV engine, and at a perturbed plan."""
    if kind == "rigid":
        jeng, teng = rigid_pair(admm_iterations=60)
        x = start_state(rng)
        x_ref = np.tile(np.concatenate([[0.8, -0.4, H12 + 0.3], np.zeros(9)]), (6, 1))
        obs_j = obs_t = None
    else:
        jeng = jmr.LTVTrackingMPC(config=JSQPConfig(horizon=LTV_N, admm_iterations=100,
                                                    admm_rho=0.02),
                                  num_obstacles=1, obstacle_margin=0.2, dtype=jnp.float64)
        teng = tmr.LTVTrackingMPC(config=SQPConfig(horizon=LTV_N, admm_iterations=100,
                                                   admm_rho=0.02),
                                  num_obstacles=1, obstacle_margin=0.2, dtype=F64, device="cpu")
        x = np.zeros(12)
        x[2], x[3] = 1.0, 0.3
        ts = 0.1 * np.arange(1, LTV_N + 1)
        x_ref = np.zeros((LTV_N, 12))
        x_ref[:, 0], x_ref[:, 2], x_ref[:, 3] = 0.5 * ts, 1.0 + 0.2 * ts, 0.5
        obs_j, obs_t = jnp.asarray(OBSTACLE), torch.tensor(OBSTACLE)
    _, _, jc = jeng.mpc.solve(jeng.init_carry(jnp.asarray(x)), jnp.asarray(x), jeng.cost,
                              jnp.asarray(x_ref), obstacles=obs_j)
    U, y = np.asarray(jc.U_prev), np.asarray(jc.dual)
    for shift in (0.0, 0.01):
        Up = U + shift
        want = j_nl_kkt(jeng.mpc, jeng.cost, jnp.asarray(x), jnp.asarray(x_ref), jnp.asarray(Up),
                        jnp.asarray(y), obstacles=obs_j)
        got = nonlinear_kkt_score(teng.mpc, teng.cost, torch.tensor(x), torch.tensor(x_ref),
                                  torch.tensor(Up), torch.tensor(y), obstacles=obs_t)
        close(got, want, what=f"shift {shift}")


def test_linear_mpc_polish_matches_jax(rng):
    """The staged ``LinearMPC(polish=True)`` over three warm-started ticks,
    and the fused ADMM path, which ignores ``polish`` as JAX's does."""
    cfg = dict(horizon=8, admm_iterations=30, polish=True, polish_passes=2)
    jm, tm = JMPC(JCfg(**cfg), dtype=jnp.float64), LinearMPC(LinearMPCConfig(**cfg), dtype=F64,
                                                            device="cpu")
    x = np.array([0.1, -0.2, 2.9, 0.3, 0.0, -0.1])
    jc, tc = jm.init_carry(jnp.asarray(x)), tm.init_carry(torch.tensor(x))
    for tick in range(3):
        target = np.array([1.0, 0.5 * tick, 3.0])
        res = 0.1 * rng.normal(size=(8, 6))
        ju, jX, jc = jm.solve(jc, jnp.asarray(x), jnp.asarray(target), jnp.asarray(res))
        tu, tX, tc = tm.solve(tc, torch.tensor(x), torch.tensor(target), torch.tensor(res))
        close(tu, ju, what=f"u0 tick {tick}")
        close(tX, jX, what=f"X tick {tick}")
        close(tc.slack, jc.slack, what=f"slack tick {tick}")
        close(tc.dual, jc.dual, what=f"dual tick {tick}")
        x = np.asarray(jX[1])
    fused = dict(horizon=8, admm_iterations=30, use_fused_admm=True)
    a = LinearMPC(LinearMPCConfig(**fused, polish=True), device="cpu")
    b = LinearMPC(LinearMPCConfig(**fused), device="cpu")
    xs, tgt = torch.tensor(x, dtype=torch.float32), torch.tensor([1.0, 0.5, 3.0])
    assert torch.equal(a.solve(a.init_carry(), xs, tgt)[0], b.solve(b.init_carry(), xs, tgt)[0])
