"""Tests of the port that need a CUDA card (marker ``cuda``); without one
they skip. The file imports neither JAX nor the JAX package, so it runs on
a machine without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

``--noconftest`` leaves out ``tests/conftest.py``, which imports JAX.
"""

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu_torch.control import MPPIConfig, MPPIController
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import fit_residual_gp
from unmanned_aerial_vehicles_tpu_torch.ops import (
    _cuda,
    admm_pallas,
    controller_pallas,
    plant_pallas,
    rbf_pallas,
    tick_ad,
    tick_pallas,
)
from unmanned_aerial_vehicles_tpu_torch.ops.plant_pallas import build_plant_row

K_SAMPLES, N = 128, 9
# a float32 sampling stage against the controller's own dtype: the softmax
# at temperature 0.3 amplifies the costs' rounding (about 1e-4 N on the
# thrust at this size)
U0_ATOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mppi_tick_samples_through_k12(cuda_device, dtype):
    """Every MPPI tick on the card launches K12 once, whatever the
    controller's dtype, and agrees with the plain sampling stage."""
    x = torch.zeros(12, dtype=dtype, device=cuda_device)
    x[2] = 3.0
    target = torch.tensor([0.3, -0.2, 3.1])
    us = {}
    for fused in (True, False):
        ctrl = MPPIController(MPPIConfig(horizon=N, num_samples=K_SAMPLES, fused_rollouts=fused),
                              dtype=dtype, device=cuda_device)
        _cuda.reset_launch_counts()
        us[fused], _, carry = ctrl.solve(ctrl.init_carry(x, seed=3), x, target, 0.1)
        torch.cuda.synchronize()
        assert _cuda.launch_counts["mppi_rollout_costs_fused"] == (1 if fused else 0)
        assert us[fused].dtype == dtype and carry.U_nom.dtype == dtype
        assert bool(torch.isfinite(us[fused]).all())
    torch.testing.assert_close(us[True], us[False], rtol=0, atol=U0_ATOL)


@pytest.mark.cuda
def test_tightened_k5_launches_once_and_agrees_with_its_plain_version(cuda_device):
    """A K5 call with tighten_kappa > 0 (N=20, P=800, K=8) launches the
    tightened kernel once, agrees with the plain version within 1e-4 of each
    output's scale and repeats bit for bit."""
    N, P, K = 20, 800, 8
    f32 = dict(dtype=torch.float32, device=cuda_device)
    mpc = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=10, use_fused_controller=True),
                    device=cuda_device)
    rng = np.random.default_rng(0)
    post = fit_residual_gp(torch.tensor(rng.normal(size=(P, 10)), **f32),
                           torch.tensor(2.0 * rng.normal(size=(P, 6)), **f32))
    gp = tick_pallas.build_gp_rows(post, 1.0, with_variance=True)
    x0 = torch.zeros(12, **f32)
    x0[:6] = torch.tensor([0.2, -0.1, 2.9, 7.8, 0.3, -0.1])   # near the 8 m/s box
    aux = torch.cat([x0[:6], torch.zeros(3, **f32)]).contiguous()
    refs = torch.tensor([3.0, 0.0, 3.0, 9.0, 0.0, 0.0], **f32).repeat(K, N).contiguous()
    plant_row = build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81, (0.8, 0.4, 0.0),
                                device=cuda_device)
    args = (mpc._tick_data, gp, x0, aux, x0[:6].repeat(N).contiguous(),
            torch.zeros(10 * N, **f32), torch.zeros(10 * N, **f32), refs,
            torch.zeros(K, **f32), plant_row)
    statics = dict(k_ticks=K, use_gp=True, rho=8.0, iterations=10, over_relax=1.6, dt=0.02,
                   substeps=2, accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0),
                   yawrate_limit=0.8, n=N, tighten_kappa=2.0)
    _cuda.reset_launch_counts()
    got = tick_pallas.gpmpc_multitick_fused(*args, **statics)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["gpmpc_multitick_fused_tightened"] == 1
    assert _cuda.launch_counts["gpmpc_multitick_fused"] == 0
    want = tick_pallas.multitick_staged(*args, **statics)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol
    again = tick_pallas.gpmpc_multitick_fused(*args, **statics)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 1024])
def test_plant_vjp_kernels_agree_with_their_plain_versions(cuda_device, batch):
    """K13a and K13b launch once per call, agree with ``torch.func.vjp`` of
    K1's and K2's plain versions within 1e-5 of each cotangent's scale
    (around hover with wind, a quarter of the states at zero airspeed) and
    repeat bit for bit."""
    f32 = dict(dtype=torch.float32, device=cuda_device)
    gen = torch.Generator().manual_seed(batch)
    wind = (0.8, 0.4, 0.0)
    prow = build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81 / 0.7, wind,
                           device=cuda_device)
    s = 0.3 * torch.randn(batch, 12, generator=gen)
    s[:, 2] += 3.0
    s[: batch // 4 + 1, 3:6] = torch.tensor(wind)
    s = s.to(**f32).contiguous()
    c = torch.cat([1.4 + 0.1 * torch.randn(batch, 1, generator=gen),
                   0.3 * torch.randn(batch, 3, generator=gen)], 1).to(**f32).contiguous()
    cmd = torch.cat([torch.randn(batch, 3, generator=gen), 0.3 * torch.randn(batch, 2, generator=gen),
                     torch.full((batch, 1), 1.2)], 1).to(**f32).contiguous()
    integ = (0.05 * torch.randn(batch, 3, generator=gen)).to(**f32).contiguous()
    cts = [torch.randn(batch, n, generator=gen).to(**f32).contiguous() for n in (12, 7, 3)]
    cases = {
        "px4_plant_step_vjp": (
            lambda: tick_ad.px4_plant_step_vjp(s, c, prow, cts[0], 0.02, 2),
            lambda: tick_ad.px4_plant_step_vjp_plain(s, c, prow, cts[0], 0.02, 2)),
        "allocation_plant_tick_vjp": (
            lambda: tick_ad.allocation_plant_tick_vjp(s, cmd, integ, prow, *cts, 0.02, 2),
            lambda: tick_ad.allocation_plant_tick_vjp_plain(s, cmd, integ, prow, *cts, 0.02, 2)),
    }
    for name, (kernel, plain) in cases.items():
        _cuda.reset_launch_counts()
        got = kernel()
        torch.cuda.synchronize()
        assert _cuda.launch_counts[name] == 1
        want = plain()
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all())
            assert float((g - w).abs().max()) <= 1e-5 * max(1.0, float(w.abs().max()))
        again = kernel()
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("n,substeps,with_res", [(1, 1, True), (20, 2, True), (20, 1, False),
                                                  (150, 1, True), (150, 2, False)])
def test_k10_rollout_agrees_with_its_plain_version(cuda_device, n, substeps, with_res):
    """K10 (one warp, the controls and residuals staged 64 steps at a time)
    launches once per call, agrees with its plain version within 1e-5 of
    the state's size (around hover with wind) and repeats bit for bit."""
    import dataclasses

    from unmanned_aerial_vehicles_tpu_torch.models.params import GZ_QUADROTOR_PARAMS
    from unmanned_aerial_vehicles_tpu_torch.ops import rigid_plant_pallas as rp

    f32 = dict(dtype=torch.float32, device=cuda_device)
    gen = torch.Generator().manual_seed(n + substeps)
    body = dataclasses.replace(GZ_QUADROTOR_PARAMS, wind=(0.6, -0.4, 0.2))
    x0 = (0.1 * torch.randn(12, generator=gen)).to(**f32)
    U = (torch.tensor([4.9, 0.0, 0.0, 0.0]) + torch.randn(n, 4, generator=gen)
         * torch.tensor([0.5, 2e-3, 2e-3, 2e-3])).to(**f32)
    res = (0.1 * torch.randn(n, 12, generator=gen)).to(**f32) if with_res else None
    _held(lambda: (rp.rigid_body_rollout_fused(x0, U, body, 0.02, substeps, res),),
          lambda: (rp.rigid_body_rollout_plain(x0, U, body, 0.02, substeps, res),),
          "rigid_body_rollout_fused", 1e-5)


def _held(kernel, plain, name, tol):
    """One launch of ``kernel`` (counted), within ``tol`` of each output's
    scale of ``plain``, and a second launch bit-identical."""
    _cuda.reset_launch_counts()
    got = kernel()
    torch.cuda.synchronize()
    assert _cuda.launch_counts[name] == 1
    for g, w in zip(got, plain()):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= tol * max(1.0, float(w.abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(got, kernel()))


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [20, 25])
def test_k14_and_k16_agree_with_their_plain_versions(cuda_device, horizon):
    """K14 on the staged MPC's own M^-1 and G and K16 for 64 flights, at
    N=20 and N=25 (K14's slices of G and M^-1 in registers; K16's P1 split
    over a thread-block cluster), within 2e-5 of scale, a second launch
    bit-identical."""
    f32 = dict(dtype=torch.float32, device=cuda_device)
    gen = torch.Generator().manual_seed(horizon)
    mpc = LinearMPC(LinearMPCConfig(horizon=horizon, use_fused_controller=True),
                    device=cuda_device)
    m, Nnx = mpc.n_constraints, 6 * horizon
    x0 = torch.tensor([2.0, -1.5, 1.0, 1.0, -0.5, 0.3], **f32)
    offset = mpc._Sx @ x0
    f = (mpc._SuT_q @ (offset - torch.tensor([0.0, 0.0, 3.0, 0, 0, 0], **f32).repeat(horizon)))
    k14 = (mpc._M_inv.contiguous(), mpc._G.contiguous(), mpc._G.T.contiguous(), f.contiguous(),
           torch.cat([mpc._u_lo, mpc._x_lo - offset]), torch.cat([mpc._u_hi, mpc._x_hi - offset]),
           torch.zeros(m, **f32), torch.zeros(m, **f32), 8.0, 80, 1.6)
    _held(lambda: admm_pallas.admm_box_qp_fused(*k14),
          lambda: admm_pallas.admm_box_qp_fused_plain(*k14), "admm_box_qp_fused", 2e-5)
    B = 64
    data = mpc._tick_data
    X0 = (torch.randn(B, 6, generator=gen) + torch.tensor([0, 0, 3.0, 0, 0, 0])).to(**f32)
    k16 = (data, data.ShiftT, X0, (0.02 * torch.randn(B, Nnx, generator=gen)).to(**f32),
           torch.tensor([3.0, 0.0, 3.0, 0.0, 0.0, 0.0], **f32).repeat(horizon)[None],
           (0.3 * torch.randn(B, m, generator=gen)).to(**f32),
           (0.1 * torch.randn(B, m, generator=gen)).to(**f32), 8.0, 80, 1.6)
    _held(lambda: controller_pallas.gpmpc_controller_fused_batched(*k16),
          lambda: controller_pallas.gpmpc_controller_fused_batched_plain(*k16),
          "gpmpc_controller_fused_batched", 2e-5)


@pytest.mark.cuda
def test_k15_and_the_plant_block_agree_with_their_plain_versions(cuda_device):
    """K15 (ARD, 777 x 501 x 10: ragged tiles, scalar stores) within 5e-5 of
    sigma^2 of its plain version (``chip_smoke.py`` GRAM_TOL gives the
    reason), and K1/K2 on a (300, 10) plant block within 2e-5."""
    f32 = dict(dtype=torch.float32, device=cuda_device)
    gen = torch.Generator().manual_seed(15)
    X1 = torch.randn(777, 10, generator=gen).to(**f32)
    X2 = torch.randn(501, 10, generator=gen).to(**f32)
    ls = (0.4 + torch.rand(10, generator=gen)).to(**f32)
    _held(lambda: (rbf_pallas.rbf_kernel_matrix_pallas(X1, X2, ls, 1.3),),
          lambda: (rbf_pallas.rbf_kernel_matrix_plain(X1, X2, ls, 1.3),),
          "rbf_kernel_matrix_pallas", 5e-5)
    B = 300
    block = torch.stack([0.5 + 0.05 * torch.randn(B, generator=gen), torch.full((B,), 9.81),
                         0.25 + 0.05 * torch.rand(B, generator=gen),
                         *(0.05 + 0.01 * torch.rand(3, B, generator=gen)),
                         9.81 + 0.3 * torch.randn(B, generator=gen),
                         *(0.8 * torch.randn(3, B, generator=gen))], 1).to(**f32).contiguous()
    s = (0.3 * torch.randn(B, 12, generator=gen)).to(**f32)
    c = torch.cat([torch.ones(B, 1), 0.1 * torch.randn(B, 3, generator=gen)], 1).to(**f32)
    cmd = torch.cat([torch.randn(B, 3, generator=gen), torch.zeros(B, 2),
                     torch.full((B, 1), 1.2)], 1).to(**f32)
    integ = torch.zeros(B, 3, **f32)
    _held(lambda: (plant_pallas._px4_plant_rows(s, c, block, 0.02, 2),),
          lambda: (plant_pallas.px4_plant_step_plain(s, c, block, 0.02, 2),),
          "px4_plant_step_fused", 2e-5)
    _held(lambda: plant_pallas._allocation_plant_rows(s, cmd, integ, block, 0.02, 2),
          lambda: plant_pallas.allocation_plant_tick_plain(s, cmd, integ, block, 0.02, 2),
          "allocation_plant_tick_fused", 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 17, 257])
def test_k16_over_clusters_agrees_with_its_plain_version(cuda_device, batch):
    """K16 at N=25 for a lone flight, a ragged tile of flights and one
    flight past the 256-flight population (a cluster more than the card
    runs at once with 8 blocks each): three warm-started ticks, each one
    launch within 2e-5 of scale of the plain version and a second launch
    bit-identical."""
    N = 25
    f32 = dict(dtype=torch.float32, device=cuda_device)
    gen = torch.Generator().manual_seed(batch)
    mpc = LinearMPC(LinearMPCConfig(horizon=N, use_fused_controller=True), device=cuda_device)
    data = mpc._tick_data
    X0 = (torch.randn(batch, 6, generator=gen) + torch.tensor([0, 0, 3.0, 0, 0, 0])).to(**f32)
    W = (0.02 * torch.randn(batch, 6 * N, generator=gen)).to(**f32)
    REF = torch.tensor([3.0, 0.0, 3.0, 0.0, 0.0, 0.0], **f32).repeat(N)[None]
    Z = torch.zeros(batch, 10 * N, **f32)
    Y = torch.zeros(batch, 10 * N, **f32)
    for _ in range(3):
        args = (data, data.ShiftT, X0, W, REF, Z, Y, 8.0, 80, 1.6)
        _held(lambda: controller_pallas.gpmpc_controller_fused_batched(*args),
              lambda: controller_pallas.gpmpc_controller_fused_batched_plain(*args),
              "gpmpc_controller_fused_batched", 2e-5)
        Z, Y, _, _ = controller_pallas.gpmpc_controller_fused_batched(*args)


@pytest.mark.cuda
def test_tightened_k5_at_horizon_23_agrees_with_its_plain_version(cuda_device):
    """The tightened K5 at N=23 (the longest horizon whose tick fits one
    block) with P=800 and K=8: one cluster launch within 1e-4 of each
    output's scale of the plain version, a second launch bit-identical."""
    N, P, K = 23, 800, 8
    f32 = dict(dtype=torch.float32, device=cuda_device)
    mpc = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=10, use_fused_controller=True),
                    device=cuda_device)
    rng = np.random.default_rng(23)
    post = fit_residual_gp(torch.tensor(rng.normal(size=(P, 10)), **f32),
                           torch.tensor(2.0 * rng.normal(size=(P, 6)), **f32))
    gp = tick_pallas.build_gp_rows(post, 1.0, with_variance=True)
    x0 = torch.zeros(12, **f32)
    x0[:6] = torch.tensor([0.2, -0.1, 2.9, 7.8, 0.3, -0.1])
    aux = torch.cat([x0[:6], torch.zeros(3, **f32)]).contiguous()
    refs = torch.tensor([3.0, 0.0, 3.0, 9.0, 0.0, 0.0], **f32).repeat(K, N).contiguous()
    plant_row = build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81, (0.8, 0.4, 0.0),
                                device=cuda_device)
    args = (mpc._tick_data, gp, x0, aux, x0[:6].repeat(N).contiguous(),
            torch.zeros(10 * N, **f32), torch.zeros(10 * N, **f32), refs,
            torch.zeros(K, **f32), plant_row)
    statics = dict(k_ticks=K, use_gp=True, rho=8.0, iterations=10, over_relax=1.6, dt=0.02,
                   substeps=2, accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0),
                   yawrate_limit=0.8, n=N, tighten_kappa=2.0)
    _held(lambda: tick_pallas.gpmpc_multitick_fused(*args, **statics),
          lambda: tick_pallas.multitick_staged(*args, **statics),
          "gpmpc_multitick_fused_tightened", 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("plant,horizon", [("direct_rate", 20), ("rigid", 15), ("direct_rate", 25)])
def test_k11_on_the_factors_agrees_with_its_plain_version(cuda_device, plant, horizon):
    """K11 launches once per call with the ADMM operator's factors in shared
    memory (N=20, 15) or read through L2 (N=25), agrees with its plain
    version (which multiplies by P1) within chip_smoke.py's K11_TOL, and a
    second launch is bit-identical."""
    from unmanned_aerial_vehicles_tpu_torch.control import DirectRateMPC, RigidBodyMPC
    from unmanned_aerial_vehicles_tpu_torch.loop.rigid_loop import dispatch_tick_operands
    from unmanned_aerial_vehicles_tpu_torch.models import X500_PARAMS
    from unmanned_aerial_vehicles_tpu_torch.ops import rigid_tick_pallas

    eng = (DirectRateMPC if plant == "direct_rate" else RigidBodyMPC)(horizon=horizon,
                                                                      device=cuda_device)
    K, m = 8, 16 * horizon
    x0 = torch.zeros(12, device=cuda_device)
    x0[2] = 3.0
    _, ops = dispatch_tick_operands(eng.mpc, eng.cost, x0[None, :].repeat(horizon + 1, 1),
                                    eng.u_hover[None, :].repeat(horizon, 1))
    refs = torch.zeros(K, horizon, 12, device=cuda_device)
    refs[..., 0] = 0.3
    refs[..., 2] = 3.2
    args = (x0, torch.zeros(m, device=cuda_device), torch.zeros(m, device=cuda_device),
            refs.reshape(K, -1).contiguous(), ops)
    statics = dict(k_ticks=K, n=horizon, nu=4, nx=12, iterations=30, over_relax=1.6,
                   rho=float(eng.mpc.config.admm_rho), dt=0.02, substeps=1, plant=plant,
                   body=X500_PARAMS if plant == "rigid" else None)
    shared, _ = rigid_tick_pallas.factor_placement(cuda_device, horizon)
    assert shared == (horizon <= 21)
    _cuda.reset_launch_counts()
    got = rigid_tick_pallas.direct_rate_multitick_kernel(*args, **statics)
    again = rigid_tick_pallas.direct_rate_multitick_kernel(*args, **statics)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["direct_rate_multitick_kernel"] == 2
    want = rigid_tick_pallas.direct_rate_multitick_plain(*args, **statics)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=0, atol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K4", "K5", "K6", "K10"])
def test_population_kernels_run_one_block_per_flight(cuda_device, kernel):
    """K4, K5 and K6 with a flight axis and K10 with a member axis (a body
    per member): one launch for the batch, every block bit-identical to a
    one-flight launch on its operands, and the batch within 1e-4 (K10: 1e-5
    of the state's size) of the plain version."""
    from unmanned_aerial_vehicles_tpu_torch.loop import MonteCarloConfig, plant_block, sample_conditions
    from unmanned_aerial_vehicles_tpu_torch.models.params import GZ_QUADROTOR_PARAMS, RigidBodyParams
    from unmanned_aerial_vehicles_tpu_torch.ops import rigid_plant_pallas

    B, N, dev = 9, 6, cuda_device
    g = torch.Generator().manual_seed(19)
    rnd = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=g)).to(dev)
    bodies, rates, x0 = sample_conditions(None, MonteCarloConfig(n_rollouts=B), device=dev)
    block = plant_block(bodies, rates, B, dev)
    statics = dict(rho=8.0, iterations=20, over_relax=1.6, dt=0.02, substeps=2,
                   accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0), yawrate_limit=0.8)
    mpc = LinearMPC(LinearMPCConfig(horizon=N, use_fused_controller=True, use_fused_admm=True),
                    device=dev)
    m, n = mpc.n_constraints, mpc.n_primal
    z, y = rnd(B, m, scale=0.3), rnd(B, m, scale=0.1)
    tol = 1e-4
    if kernel == "K4":
        ref = torch.tensor([0.5, 1.0, 3.0, 0.0, 0.0, 0.0], device=dev).repeat(N)
        w, misc = rnd(B, 6 * N, scale=0.02), rnd(B, 4, scale=0.02)
        kw = dict(statics, n=N, fallback_error_m=1.0)
        name, run, plain = "gpmpc_tick_fused", (lambda b=slice(None): tick_pallas.gpmpc_tick_fused(
            mpc._tick_data, x0[b], w[b], ref, misc[b], z[b], y[b], block[b], **kw)), (
            lambda: tick_pallas.gpmpc_tick_fused_plain(mpc._tick_data, x0, w, ref, misc, z, y,
                                                       block, **kw))
    elif kernel == "K5":
        aux = torch.cat([x0[:, 0:6], rnd(B, 3, scale=0.02)], 1).contiguous()
        xtail = (x0[:, 0:6].repeat(1, N) + rnd(B, 6 * N, scale=0.05)).contiguous()
        refs = torch.tensor([0.5, 1.0, 3.0, 0.0, 0.0, 0.0], device=dev).repeat(4, N)
        yaw = torch.zeros(4, device=dev)
        kw = dict(statics, k_ticks=4, use_gp=False, n=N)
        name, run, plain = "gpmpc_multitick_fused", (
            lambda b=slice(None): tick_pallas.gpmpc_multitick_fused(
                mpc._tick_data, None, x0[b], aux[b], xtail[b], z[b], y[b], refs, yaw, block[b],
                **kw)), (lambda: tick_pallas.multitick_staged(mpc._tick_data, None, x0, aux, xtail,
                                                             z, y, refs, yaw, block, **kw))
    elif kernel == "K6":
        f = rnd(B, n)
        p0, minv_f = (-(f @ mpc._GMinv.T)).contiguous(), (f @ mpc._M_inv.T).contiguous()
        lo = torch.cat([mpc._u_lo.expand(B, n), mpc._x_lo - rnd(B, 6 * N, scale=0.3)], 1)
        hi = torch.cat([mpc._u_hi.expand(B, n), mpc._x_hi + rnd(B, 6 * N, scale=0.3)], 1)
        args = lambda b: (mpc._P1_f32, p0[b], mpc._GMinvT_f32, minv_f[b], lo[b], hi[b], z[b],
                          y[b], 8.0, 20, 1.6)
        name, run, plain = "admm_box_qp_fused_composite", (
            lambda b=slice(None): admm_pallas.admm_box_qp_fused_composite(
                *args(b), SuT=mpc._SuT_f32)), (
            lambda: admm_pallas.admm_box_qp_fused_composite_plain(*args(slice(None))))
    else:
        gz, _, xg = sample_conditions(None, MonteCarloConfig(n_rollouts=B, mass_jitter_pct=0.15),
                                      body=GZ_QUADROTOR_PARAMS, device=dev)
        U = ((gz.mass * gz.gravity)[:, None, None] * torch.tensor([1.0, 0, 0, 0], device=dev)
             + rnd(B, 3, 4, scale=1e-3)).contiguous()
        one = lambda b: RigidBodyParams(
            mass=float(gz.mass[b]), k_drag_linear=float(gz.k_drag_linear[b]),
            k_drag_angular=float(gz.k_drag_angular[b]), wind=tuple(float(v[b]) for v in gz.wind))
        name = "rigid_body_rollout_fused"
        run = lambda b=slice(None): (rigid_plant_pallas.rigid_body_rollout_fused(
            xg[b], U[b], gz if isinstance(b, slice) else one(b), 0.02),)
        plain = lambda: (rigid_plant_pallas.rigid_body_rollout_plain(xg, U, gz, 0.02),)
        tol = 1e-5 * max(1.0, float(xg.abs().max()))
    _cuda.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert _cuda.launch_counts[name] == 1
    for g_, w_ in zip(got, plain()):
        torch.testing.assert_close(g_, w_, rtol=0, atol=tol)
    for b in range(B):
        for g_, s_ in zip(got, run(b)):
            assert torch.equal(g_[b], s_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rk4_demo_mpc_solves_through_k14(cuda_device, dtype):
    """Every ``RK4DemoMPC`` solve on the card is one K14 launch (n=30, m=90),
    whatever the MPC's dtype, and agrees with K14's plain version."""
    from unmanned_aerial_vehicles_tpu_torch.control import RK4DemoMPC

    mpc = RK4DemoMPC(dtype=dtype, device=cuda_device)
    state = torch.tensor([0.0, 2.0, -2.0, 0.6, 0.0, 0.0], dtype=dtype, device=cuda_device)
    X_ref = torch.tensor([1.0, 1.0, -2.0, 0.0, 0.0, 0.0], dtype=dtype,
                         device=cuda_device).repeat(mpc.N + 1, 1)
    out = {}
    for plain in (False, True):
        _cuda.reset_launch_counts()
        out[plain] = mpc.solve(mpc.init_carry(), state, X_ref, plain_kernels=plain)
        torch.cuda.synchronize()
        assert _cuda.launch_counts["admm_box_qp_fused"] == (0 if plain else 1)
    assert out[False][0].dtype == dtype
    for got, want in zip(out[False][:2], out[True][:2]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _flight_corpus(n: int, seed: int = 3):
    """Time-ordered flight-like inputs (a figure-8 with noise) and smooth
    outputs, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.02
    s, c = np.sin(0.3 * t), np.cos(0.3 * t)
    X = np.column_stack([4 * s, 2 * np.sin(0.6 * t), 3 + 0.2 * s, 1.2 * c, 1.2 * np.cos(0.6 * t),
                         0.06 * c, -0.36 * s, -0.72 * np.sin(0.6 * t), 0 * t, 0.1 * s])
    X = X + 0.05 * rng.normal(size=X.shape)
    Y = np.column_stack([np.tanh(X[:, k]) for k in range(3, 9)]) + 0.01 * rng.normal(size=(n, 6))
    return X.astype(np.float32), Y.astype(np.float32)


@pytest.mark.cuda
def test_sharded_fit_builds_every_gram_block_through_k15(cuda_device):
    """On the card the float32 fit and prediction launch K15 once per tile of
    rows of each Gram block and agree with the plain route; float64 on the
    card raises unless ``plain_kernels=True``."""
    from unmanned_aerial_vehicles_tpu_torch.parallel import (
        fit_residual_gp_sharded,
        predict_mean_sharded,
    )
    from unmanned_aerial_vehicles_tpu_torch.parallel.distributed_gp import GRAM_SHIFT_ROWS

    X, Y = _flight_corpus(1000)
    tiles = lambda n: -(-n // GRAM_SHIFT_ROWS)
    means = {}
    for plain in (False, True):
        _cuda.reset_launch_counts()
        post = fit_residual_gp_sharded(X, Y, device=cuda_device, plain_kernels=plain)
        means[plain] = predict_mean_sharded(post, X[::7], plain_kernels=plain)
        torch.cuda.synchronize()
        want = 0 if plain else 2 * tiles(1000) + tiles(256) + tiles(1000)
        assert _cuda.launch_counts["rbf_kernel_matrix_pallas"] == want
    gap = float(((means[False] - means[True]).abs() / post.y_std).max())
    assert gap <= 1e-3, gap
    with pytest.raises(ValueError, match="plain_kernels=True"):
        fit_residual_gp_sharded(X.astype(np.float64), Y, device=cuda_device, cg_iterations=2)
    post64 = fit_residual_gp_sharded(X.astype(np.float64), Y.astype(np.float64),
                                     device=cuda_device, plain_kernels=True)
    assert post64.alpha.dtype == torch.float64 and bool(torch.isfinite(post64.alpha).all())


@pytest.mark.cuda
def test_sharded_structured_sweep_on_a_world_of_one(cuda_device):
    """The sharded sweep on one card launches K8, K7 and K2 once a tick and
    equals the one-card sweep bit for bit."""
    from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig
    from unmanned_aerial_vehicles_tpu_torch.parallel import (
        make_mesh,
        sharded_structured_flight_sweep,
        structured_flight_sweep,
    )
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

    def ref(t):
        p, y = ramped_figure8_reference(t, 6.0, 0.02)
        return p + torch.tensor([0.0, 0.0, 3.0], dtype=p.dtype, device=p.device), y

    rng = np.random.default_rng(0)
    post = fit_residual_gp(torch.tensor(rng.normal(size=(200, 10)), dtype=torch.float32,
                                        device=cuda_device),
                           torch.tensor(0.05 * rng.normal(size=(200, 6)), dtype=torch.float32,
                                        device=cuda_device))
    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=10, use_fused_controller=True),
                    device=cuda_device)
    starts = torch.zeros(16, 12, device=cuda_device)
    starts[:, 2] = 3.0
    starts[:, 0] = torch.linspace(-1, 1, 16, device=cuda_device)
    _cuda.reset_launch_counts()
    agg = sharded_structured_flight_sweep(make_mesh(device=cuda_device), mpc, ref, 10, starts,
                                          cfg=FlightLoopConfig(), gp_posterior=post)
    torch.cuda.synchronize()
    for name in ("gpmpc_controller_structured_batched", "rbf_posterior_mean_pallas",
                 "allocation_plant_tick_fused"):
        assert _cuda.launch_counts[name] == 10, name
    one = structured_flight_sweep(mpc, ref, 10, starts, gp_posterior=post, device=cuda_device)
    assert torch.equal(agg["rms_per_flight"], one["rms_per_flight"])
    assert torch.equal(agg["rms_max"], one["rms_max"])


def _cli_run(argv):
    """The port's ``cli.main(argv)`` on the default device: exit 0, its
    JSON (from the first ``{``, or None) and its printed text."""
    import contextlib
    import io
    import json

    from unmanned_aerial_vehicles_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    assert rc == 0, text
    payload = json.JSONDecoder().raw_decode(text, text.index("{"))[0] if "{" in text else None
    return payload, text


@pytest.mark.cuda
def test_cli_fly_fast_launches_the_multitick_kernel(cuda_device):
    """``fly --controller mpc --fast`` with no ``--device`` runs on the card:
    one K5 launch per 8 ticks."""
    _cuda.reset_launch_counts()
    out, _ = _cli_run(["fly", "--controller", "mpc", "--fast", "--duration", "2",
                       "--amplitude", "2"])
    torch.cuda.synchronize()
    assert _cuda.launch_counts["gpmpc_multitick_fused"] == 100 // 8
    assert np.isfinite(out["rms_pos"]) and out["rms_pos"] < 3.0


@pytest.mark.cuda
def test_cli_train_gp_all_samples_through_k15(cuda_device, tmp_path):
    """``train-gp --all-samples`` on the card: every Gram block through K15,
    a checkpoint written."""
    from unmanned_aerial_vehicles_tpu_torch.io import save_gp_dataset

    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 10))
    save_gp_dataset(str(tmp_path / "f.csv"), X, 0.05 * rng.normal(size=(300, 6)))
    _cuda.reset_launch_counts()
    _, text = _cli_run(["train-gp", "--data", str(tmp_path / "*.csv"), "--all-samples",
                        "--output", str(tmp_path / "gp.npz")])
    torch.cuda.synchronize()
    assert "sharded fit: n=300 over 1 device(s)" in text
    assert _cuda.launch_counts["rbf_kernel_matrix_pallas"] > 0
    assert (tmp_path / "gp.npz").exists()
