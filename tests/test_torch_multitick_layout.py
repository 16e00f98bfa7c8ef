"""The host-side layout of the multi-tick kernels K5 (``gpmpc_multitick_fused``)
and K9 (``gpmpc_noisy_multitick_fused``) on their wide blocks, and the
arithmetic of their summation orders, on the CPU (no card or ``nvcc``):

- K5's block (512 threads; the tightened cluster's rank 0 on 256) fits one
  H100 block (232,448 bytes) up to N=23 in both modes, K9's (512) up to
  N=22;
- the GP's groups of lanes fit the GP warps at every horizon the kernels
  reach;
- a float32 emulation of the kernels' summation orders (the products with
  the fixed operators in matvec_partial's slices at the block's thread
  count, the ADMM's column dots, the GP's per-slice sums over its stage
  groups, the 8-lane xor tree and the groups added in order) over one K5
  launch and one K9 launch holds
  ``multitick_staged`` / ``noisy_multitick_staged`` within ``TICK_TOL``
  (1e-4, ``chip_smoke.py``), the bar the card check holds the kernels to;
- the overlap's read set: the next tick's GP reads tick t's x0 (K5: the
  state at the tick's start; K9: the estimate), X_tail and unshifted slack,
  which are the operands the plain version's next tick reads.
"""

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.estimation import EKFConfig
from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig, fit_residual_gp
from unmanned_aerial_vehicles_tpu_torch.ops import plant_pallas, tick_pallas

torch.set_num_threads(1)

SMEM_LIMIT = 232448   # one H100 block's opt-in shared memory
TICK_TOL = 1e-4
NU, NX = 4, 6


# ---------------------------------------------------------------------------
# shared memory, slices and groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tighten", [False, True])
@pytest.mark.parametrize("N", [20, 21, 22, 23])
def test_k5_block_fits_one_h100_block(N, tighten):
    threads = tick_pallas.TIGHT_KERNEL_THREADS if tighten else tick_pallas.KERNEL_THREADS
    group, stages = ((tick_pallas.TIGHT_GP_GROUP, 1) if tighten
                     else (tick_pallas.GP_GROUP, tick_pallas.GP_STAGES))
    m, Nnu, Nnx = N * (NU + NX), N * NU, N * NX
    smem = tick_pallas.shared_memory_bytes(N, tighten=tighten)
    # P1, va and vb (16-byte aligned), 7 m-vectors, [x0 | w], 4 more Nnx
    # rows, 3 Nnu rows, the slices, the GP's features and group sums (warps
    # 1..), the state, aux and anchor; rank 0's variance and back-off rows
    floats = (m * m + 2 * ((m + 3) // 4 * 4) + 7 * m + NX + 5 * Nnx + 3 * Nnu
              + max(threads, m + Nnu) + N * (NU + NX) + 3 * ((threads - 32) // group) * stages
              + 12 + 9 + NX)
    if tighten:
        floats += Nnx + m
    assert smem == 4 * floats <= SMEM_LIMIT
    assert tick_pallas.shared_memory_bytes(24, tighten=tighten) > SMEM_LIMIT


@pytest.mark.parametrize("N", [20, 21, 22])
def test_k9_block_fits_one_h100_block(N):
    threads = tick_pallas.NOISY_KERNEL_THREADS
    smem = tick_pallas.noisy_shared_memory_bytes(N)
    assert smem <= SMEM_LIMIT
    # K5's vectors with the GP on warps 2..; the truth, aux (16) and anchor
    # (8); then the filter's arrays
    vectors = tick_pallas._vector_floats(N, NU, NX, threads, threads - 64, tick_pallas.GP_GROUP,
                                         tick_pallas.NOISY_GP_STAGES)
    assert smem == 4 * (vectors + 12 + 16 + 8 + tick_pallas._FILTER_FLOATS)
    assert tick_pallas.noisy_shared_memory_bytes(23) > SMEM_LIMIT


def gp_layouts():
    """(GP threads, lane group, stages per thread) of K5, the tightened K5's
    rank 0 and K9."""
    return [(tick_pallas.KERNEL_THREADS - 32, tick_pallas.GP_GROUP, tick_pallas.GP_STAGES),
            (tick_pallas.TIGHT_KERNEL_THREADS - 32, tick_pallas.TIGHT_GP_GROUP, 1),
            (tick_pallas.NOISY_KERNEL_THREADS - 64, tick_pallas.GP_GROUP,
             tick_pallas.NOISY_GP_STAGES)]


@pytest.mark.parametrize("layout", gp_layouts())
@pytest.mark.parametrize("N", [8, 20, 23])
def test_gp_groups_fit_the_gp_warps(N, layout):
    gp_threads, group, stages = layout
    groups = -(-N // stages)
    h = gp_threads // (group * groups)
    assert h >= 1 and 32 % group == 0   # a group never straddles two warps
    assert groups * h * group <= gp_threads
    assert 3 * N * h <= 3 * (gp_threads // group) * stages   # red's floats
    # every GP thread busy but fewer than one lane group per stage group
    assert gp_threads - groups * h * group < groups * group


# ---------------------------------------------------------------------------
# the kernels' summation orders in float32
# ---------------------------------------------------------------------------


def col_dot_order(v, A):
    """``sum_i v[i] A[i, :]`` as col_dot, col_dot_smem and col_dot_batched
    add it: accumulator ``i % 4`` in order of i, then ``(a0 + a1) + (a2 +
    a3)``."""
    acc = [torch.zeros(A.shape[1], dtype=A.dtype) for _ in range(4)]
    for i in range(v.shape[0]):
        acc[i & 3] = acc[i & 3] + v[i] * A[i]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def matvec_order(v, A, threads):
    """``matvec_slices`` then ``matvec_total``: each column's sum in
    ``threads // n_out`` slices (one if the outputs outnumber the threads),
    added from zero in slice order."""
    n_in, n_out = A.shape
    parts = 1 if n_out >= threads else threads // n_out
    chunk = -(-n_in // parts)
    total = torch.zeros(n_out, dtype=A.dtype)
    for q in range(parts):
        i0 = min(n_in, q * chunk)
        i1 = min(n_in, i0 + chunk)
        if i1 > i0:
            total = total + col_dot_order(v[i0:i1], A[i0:i1])
    return total


def controller_order(threads):
    """``controller_plain`` with the kernel's sums (``condensed_solve``):
    the products with the fixed operators in matvec_partial's slices, the
    ADMM's column dots in col_dot's order."""

    def product(v, A):
        return matvec_order(v, A, threads)

    def controller(data, x0, w, ref, z, y, rho, iterations, over_relax, tight=None):
        Nnu, m = data.Nnu, data.P1.shape[0]
        offset = product(torch.cat([x0, w]), data.SxSwT)
        f = product(offset - ref, data.SuTqT)
        off_z = torch.cat([torch.zeros(Nnu), offset])
        lo, hi = data.lo_row, data.hi_row
        if tight is not None:
            lo, hi = lo + tight, hi - tight
        lower, upper = lo - off_z, hi - off_z
        pm = product(f, data.PM)
        p0 = -pm[:m]
        for _ in range(iterations):
            GU = p0 + col_dot_order(rho * z - y, data.P1)
            Gt = over_relax * GU + (1.0 - over_relax) * z
            z_new = torch.minimum(torch.maximum(Gt + y / rho, lower), upper)
            y = y + rho * (Gt - z_new)
            z = z_new
        U = -pm[m:] + product(rho * z - y, data.P0matT)
        return z, y, U, offset + product(U, data.SuT)

    return controller


def gp_rows_order(gp_threads, group, stages):
    """``gp_horizon_rows`` with the kernel's sums on its ``gp_threads``: h
    groups of G lanes per group of ``stages`` stages, slice s summing every
    S-th point from s in order for each of its stages, the group's G sums in
    the xor tree (offsets G/2, ..., 1: lane 0's order), the h group sums
    added from zero in order."""

    def rows(gp, anchor, xtail, z_prev, N, nu=NU, nx=NX):
        h = gp_threads // (group * -(-N // stages))
        S = group * h
        Xs = torch.cat([anchor[None, :], xtail[: (N - 1) * nx].reshape(N - 1, nx)], dim=0)
        Zf = torch.cat([Xs, z_prev[: N * nu].reshape(N, nu)], dim=1) * gp.inv_ls[0] - gp.inv_ls[1]
        q1 = torch.zeros(N)
        cross = torch.zeros(N, gp.sq2.shape[0])
        for c in range(nu + nx):
            q1 = q1 + Zf[:, c] * Zf[:, c]
            cross = cross + Zf[:, c:c + 1] * gp.ztrT[c][None, :]
        Kst = gp.scal[0] * torch.exp(-0.5 * torch.clamp(q1[:, None] + gp.sq2[None, :]
                                                        - 2.0 * cross, min=0.0))
        P = Kst.shape[1]
        R = -(-P // S)
        kst = torch.zeros(N, R * S)
        kst[:, :P] = Kst
        alpha = torch.zeros(R * S, 3)
        alpha[:P] = gp.alpha_s[:, 3:6]
        kst, alpha = kst.reshape(N, R, S), alpha.reshape(R, S, 3)
        acc = torch.zeros(N, S, 3)
        for r in range(R):
            acc = acc + kst[:, r, :, None] * alpha[None, r]
        lanes = acc.reshape(N, h, group, 3)
        off = group // 2
        while off:
            lanes = lanes + lanes[:, :, [i ^ off for i in range(group)]]
            off //= 2
        total = torch.zeros(N, 3)
        for g in range(h):
            total = total + lanes[:, g, 0]
        return gp.scal[1] * (total + gp.y_mean[3:6]), Kst

    return rows


N_SMALL, K_SMALL, P_SMALL = 8, 4, 32
STATICS = dict(use_gp=True, rho=8.0, iterations=10, over_relax=1.6, dt=0.02, substeps=2,
               accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0), yawrate_limit=0.8,
               nu=NU, nx=NX)


def flight_operands(N, K, P, seed=0):
    """K5's operands at horizon N with a P-point GP fitted on a seeded set,
    hovering near a figure-8 reference at 3 m."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    mpc = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=10, use_fused_controller=True),
                    device="cpu")
    X = rng.normal(size=(P, 10)) * 0.5
    X[:, 2] += 3.0
    post = fit_residual_gp(f32(X), f32(0.05 * rng.normal(size=(P, 6)) + 0.02),
                           ResidualGPConfig(max_data_points=P))
    gp = tick_pallas.build_gp_rows(post, 1.0)
    m = mpc.n_constraints
    x0 = torch.zeros(12)
    x0[:9] = f32([0.2, -0.1, 2.7, 0.3, 0.1, -0.2, 0.05, -0.04, 0.3])
    aux = torch.cat([x0[:6] + 0.01, f32([0.02, -0.01, 0.03])])
    xtail = x0[:6].repeat(N) + f32(0.05 * rng.normal(size=N * NX))
    z0 = torch.cat([f32(0.3 * rng.normal(size=N * NU)), torch.zeros(m - N * NU)])
    y0 = f32(0.1 * rng.normal(size=m))
    ts = 10.0 + 0.02 * np.arange(K)
    pos = np.stack([2.0 * np.sin(0.5 * ts), np.sin(ts), 3.0 + 0 * ts], 1)
    refs = torch.cat([f32(pos), torch.zeros(K, 3)], 1).repeat(1, N)
    yaw = f32(0.1 * ts)
    prow = plant_pallas.build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81,
                                        (0.8, 0.4, 0.0), device="cpu")
    return mpc._tick_data, gp, (x0, aux, xtail, z0, y0, refs, yaw, prow)


def noisy_operands(data, gp, k5_args, K, seed=1):
    """K9's operands (the online-noisy EKF case) over K5's."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    x0, aux5, xtail, z0, y0, refs, yaw, prow = k5_args
    ekf = EKFConfig()
    r9 = ekf.r_diag("cpu")
    noise = torch.sqrt(r9) * f32(rng.normal(size=(K, 9)))
    est = x0 + f32(0.02 * rng.normal(size=12))
    A = f32(0.02 * rng.normal(size=(12, 12)))
    P = torch.diag(ekf.q_diag("cpu")) * 10.0 + A @ A.T
    aux = torch.cat([est[:6] + 0.01, f32([0.02, -0.01, 0.03, 1.02, 0.1, -0.05, 0.03])])
    return (data, gp, x0, est, P, aux, xtail, z0, y0, refs, yaw, noise, prow[None],
            ekf.q_diag("cpu"), r9)


def worst(got, want):
    errs = []
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        errs.append(float((g - w).abs().max()))
    return max(errs)


@pytest.mark.parametrize("N,K,P", [(N_SMALL, K_SMALL, P_SMALL), (20, 2, 800)])
def test_k5_kernel_order_holds_plain(monkeypatch, N, K, P):
    data, gp, args = flight_operands(N, K, P)
    statics = dict(STATICS, k_ticks=K, n=N)
    want = tick_pallas.multitick_staged(data, gp, *args, **statics)
    threads = tick_pallas.KERNEL_THREADS
    monkeypatch.setattr(tick_pallas, "controller_plain", controller_order(threads))
    monkeypatch.setattr(tick_pallas, "gp_horizon_rows",
                        gp_rows_order(threads - 32, tick_pallas.GP_GROUP, tick_pallas.GP_STAGES))
    got = tick_pallas.multitick_staged(data, gp, *args, **statics)
    assert worst(got, want) <= TICK_TOL
    # the ADMM and the GP did work: the slack and the GP rows moved
    assert float((want[4] - args[3]).abs().max()) > 1e-3


def test_k9_kernel_order_holds_plain(monkeypatch):
    N, K, P = N_SMALL, K_SMALL, P_SMALL
    data, gp, args = flight_operands(N, K, P)
    noisy = noisy_operands(data, gp, args, K)
    statics = dict(STATICS, k_ticks=K, n=N)
    want = tick_pallas.noisy_multitick_staged(*noisy, **statics)
    threads = tick_pallas.NOISY_KERNEL_THREADS
    monkeypatch.setattr(tick_pallas, "controller_plain", controller_order(threads))
    monkeypatch.setattr(tick_pallas, "gp_horizon_rows",
                        gp_rows_order(threads - 64, tick_pallas.GP_GROUP,
                                      tick_pallas.NOISY_GP_STAGES))
    got = tick_pallas.noisy_multitick_staged(*noisy, **statics)
    assert worst(got, want) <= TICK_TOL


@pytest.mark.parametrize("noisy", [False, True])
def test_next_ticks_gp_reads_what_the_solve_fixed(monkeypatch, noisy):
    """Tick by tick, the GP rows the plain version forms at tick t+1 come
    from tick t's x0 (packed lanes 0:6 for K5, the estimate in lanes 32:38
    for K9), X_tail and unshifted slack (the carries tick t returns): the
    operands the kernels' GP warps read beside tick t's scalar section."""
    N, K, P = N_SMALL, K_SMALL, P_SMALL
    data, gp, args = flight_operands(N, K, P)
    statics = dict(STATICS, k_ticks=1, n=N)
    plain_rows = tick_pallas.gp_horizon_rows
    calls = []

    def recording(gp_, anchor, xtail, z_prev, N_, nu=NU, nx=NX):
        out = plain_rows(gp_, anchor, xtail, z_prev, N_, nu, nx)
        calls.append((anchor.clone(), xtail.clone(), z_prev.clone(), out[0]))
        return out

    monkeypatch.setattr(tick_pallas, "gp_horizon_rows", recording)
    if noisy:
        # (data, gp, state, est, P, aux, xtail, z, y, refs, yaw, noise, rows, q, r)
        ops, per_tick, fn, x0_lanes = list(noisy_operands(data, gp, args, K)), (9, 10, 11), \
            tick_pallas.noisy_multitick_staged, slice(32, 38)
        carried, xtail_at, z_at = range(2, 9), 6, 7
    else:
        # (data, gp, state, aux, xtail, z, y, refs, yaw, prow)
        ops, per_tick, fn, x0_lanes = [data, gp, *args], (7, 8), tick_pallas.multitick_staged, \
            slice(0, 6)
        carried, xtail_at, z_at = range(2, 7), 4, 5
    reads = []
    for t in range(K):
        step = list(ops)
        for i in per_tick:
            step[i] = ops[i][t:t + 1]
        out = fn(*step, **statics)
        for i in carried:
            step[i] = out[i - 1]
        reads.append((out[0][0, x0_lanes], step[xtail_at], step[z_at]))
        for i in carried:
            ops[i] = step[i]
    assert len(calls) == K
    for t in range(K - 1):
        anchor, xtail, z, rows = calls[t + 1]
        for got, want in zip((anchor, xtail, z), reads[t]):
            assert torch.equal(got, want), t
        assert torch.equal(plain_rows(gp, *reads[t], N)[0], rows)
