"""The host-side layout of K3 (``gpmpc_controller_fused``) and of K6
(``admm_box_qp_fused_composite``) on P1's two factors, and the arithmetic
of their factored ADMM step, on the CPU (no card or ``nvcc``):

- each thread's slices of the two factors fit the register variants'
  bounds up to N=25 (the variant with the smaller bounds to N=20), the
  wrappers take the variant reading the factors through L2 beyond, and the
  layouts (the vectors only) fit one H100 block (232,448 bytes); the
  slices' loads are aligned;
- ``G = [I; Su]`` with GM^-1 reproduces ``LinearMPC``'s P1, which is what
  lets the kernels apply P1 as ``v @ P1 = [t | t @ Su']``, t = v GM^-1;
- a float32 emulation of the factored step's summation order
  (``block_linalg.cuh``: t and t Su' in aligned_slice's slices, whether
  held in registers or read through L2, or t in the eight-row xor tree of
  K6's L2 variant; y / rho as a multiply) holds
  ``gpmpc_controller_fused_plain`` and
  ``admm_box_qp_fused_composite_plain`` within ``SINGLE_TOL`` (1e-4,
  ``chip_smoke.py``), the bar the card check holds K3 and K6 to, with boxes
  active and inactive;
- K6's wrapper refuses a malformed ``SuT``; the section clocks read the
  kernels' slots.
"""

import numpy as np
import pytest
import torch

from test_torch_multitick_layout import matvec_order
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, admm_pallas, controller_pallas, tick_pallas

torch.set_num_threads(1)

SMEM_LIMIT = 232448   # one H100 block's opt-in shared memory
SINGLE_TOL = 1e-4
NU, NX = 4, 6
THREADS = 512         # csrc/single_tick_kernels.cu kTickThreads
REGS_LIMIT_N = 25    # the register variants' reach
r4 = lambda v: (v + 3) // 4 * 4


# ---------------------------------------------------------------------------
# layouts and copies
# ---------------------------------------------------------------------------


def k3_floats(N):
    m, Nnu, Nnx = N * (NU + NX), N * NU, N * NX
    # va, vb and t, 5 m-vectors, [x0 | w], offset and ref error, f, M^-1 f
    # and U, the slices, x0's copy
    return 2 * r4(m) + Nnu + 5 * m + NX + 3 * Nnx + 3 * Nnu + max(THREADS, m + Nnu) + NX


def k6_floats(n, m):
    # va, vb and t, 5 m-vectors, the slices
    return 2 * r4(m) + r4(n) + 5 * m + THREADS


def slice_rows(n_in, n_out):
    """aligned_slice's rows: threads // n_out slices of a multiple of 4."""
    parts = 1 if n_out >= THREADS else THREADS // n_out
    return r4(-(-n_in // parts))


@pytest.mark.parametrize("N", range(1, REGS_LIMIT_N + 2))
def test_factor_slices_fit_the_register_bounds(N):
    n_t, m = NU * N, (NU + NX) * N
    rows = (slice_rows(m, n_t), slice_rows(n_t, m - n_t))
    assert rows == (controller_pallas.aligned_slice_rows(m, n_t),
                    controller_pallas.aligned_slice_rows(n_t, m - n_t))
    bounds = controller_pallas.FACTOR_SLICE_ROWS
    assert all(ka % 4 == 0 and kb % 4 == 0 for ka, kb in bounds.values())
    fits = [v for v, (ka, kb) in bounds.items() if rows[0] <= ka and rows[1] <= kb]
    assert bool(fits) == (N <= REGS_LIMIT_N)
    if fits:
        assert fits[0] == (controller_pallas.FACTORS_REGS20 if N <= 20
                           else controller_pallas.FACTORS_REGS25)
        # every slice's rows lie inside the product, and the slices cover it
        for n_in, n_out in ((m, n_t), (n_t, m - n_t)):
            parts = 1 if n_out >= THREADS else THREADS // n_out
            chunk = slice_rows(n_in, n_out)
            starts = [q * chunk for q in range(parts) if q * chunk < n_in]
            assert parts * n_out <= THREADS and starts[-1] + chunk >= n_in
            assert all(s0 % 4 == 0 for s0 in starts)   # empty slices read nothing


@pytest.mark.parametrize("N", [8, 20, 25, 26, 29, 40])
def test_factor_variant_choice(monkeypatch, N):
    monkeypatch.setattr(_cuda, "shared_memory_optin", lambda device: SMEM_LIMIT)
    n, m = NU * N, (NU + NX) * N
    want = (controller_pallas.FACTORS_REGS20 if N <= 20 else
            controller_pallas.FACTORS_REGS25 if N <= REGS_LIMIT_N else controller_pallas.FACTORS_L2)
    assert controller_pallas.CONTROLLER_THREADS == admm_pallas.FACTORED_THREADS == THREADS
    k3 = controller_pallas.controller_shared_memory_bytes(N)
    k6 = admm_pallas.factored_shared_memory_bytes(n, m)
    assert k3 == 4 * k3_floats(N) <= SMEM_LIMIT and k6 == 4 * k6_floats(n, m) <= SMEM_LIMIT
    assert controller_pallas.factor_variant(None, n, m, k3) == (want, k3)
    assert controller_pallas.factor_variant(None, n, m, k6, even_rows=True) == (want, k6)
    # K6 reads GMinvT's rows 8 bytes a load: an odd m takes L2
    assert controller_pallas.factor_variant(None, 3, 7, k6, even_rows=True)[0] == \
        controller_pallas.FACTORS_L2
    with pytest.raises(ValueError):
        controller_pallas.factor_variant(None, n, m, SMEM_LIMIT + 4)


@pytest.mark.parametrize("N", range(1, REGS_LIMIT_N + 1))
def test_factor_slice_loads_are_aligned(N):
    m, Nnu = N * (NU + NX), N * NU
    # t follows va and vb (16-byte aligned), the slices start on multiples
    # of 4 rows: the float4 reads of v and t are aligned
    assert (4 * 2 * r4(m)) % 16 == 0 and slice_rows(m, Nnu) % 4 == 0
    assert slice_rows(Nnu, m - Nnu) % 4 == 0
    # K6's rows of GMinvT (m floats): 8-byte aligned, 16 where m % 4 == 0
    assert m % 2 == 0


@pytest.mark.parametrize("N", [8, 20, 25])
def test_identity_over_su_reproduces_p1(N):
    mpc = LinearMPC(LinearMPCConfig(horizon=N, use_fused_controller=True, use_fused_admm=True),
                    dtype=torch.float64, device="cpu")
    Nnu = N * NU
    assert torch.equal(mpc._G[:Nnu], torch.eye(Nnu, dtype=torch.float64))
    assert torch.equal(mpc._G[Nnu:], mpc._Su)
    factored = torch.cat([mpc._GMinv[:, :Nnu] @ torch.eye(Nnu, dtype=torch.float64),
                          mpc._GMinv @ mpc._Su.T], dim=1)
    assert torch.allclose(factored, mpc._P1, rtol=1e-12, atol=1e-12 * float(mpc._P1.abs().max()))
    # the float32 operands the kernels read: K3's P0matT and SuT, K6's
    # GMinvT and SuT
    fc = mpc._fc_data
    assert mpc._tick_data.factored
    p1_32 = fc.P0matT.astype(np.float64) @ np.hstack([np.eye(Nnu), fc.SuT.astype(np.float64)])
    assert np.abs(p1_32 - fc.P1).max() <= 1e-6 * np.abs(fc.P1).max()
    assert torch.equal(mpc._SuT_f32, torch.as_tensor(fc.SuT))
    assert torch.equal(mpc._GMinvT_f32.T, torch.as_tensor(fc.P0matT))
    # a G that is not [I; Su] is recorded as such
    G = mpc._G.numpy().copy()
    G[0, 1] = 0.5
    other = controller_pallas.build_fused_controller_data(
        mpc._Sx.numpy(), mpc._Su.numpy(), mpc._Sw.numpy(), mpc._SuT_q.numpy(),
        mpc._M_inv.numpy(), G, mpc._u_lo.numpy(), mpc._u_hi.numpy(), mpc._x_lo.numpy(),
        mpc._x_hi.numpy())
    assert not tick_pallas.build_tick_data(other, N, NU, NX, device="cpu").factored


# ---------------------------------------------------------------------------
# the factored step's summation order in float32
# ---------------------------------------------------------------------------


def col_dot_order(v, A):
    """``sum_i v[i] A[i, :]`` as col_dot_smem adds it: accumulator ``i % 4``
    in order of i, then ``(a0 + a1) + (a2 + a3)``."""
    acc = torch.zeros(4, A.shape[1], dtype=A.dtype)
    for i0 in range(0, v.shape[0], 4):
        k = min(4, v.shape[0] - i0)
        acc[:k] = acc[:k] + v[i0:i0 + k, None] * A[i0:i0 + k]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def matvec_aligned_order(v, A, threads=THREADS):
    """``matvec_partial_aligned`` then ``matvec_total``: matvec_partial's
    slices with each slice's length rounded up to a multiple of 4, added
    from zero in slice order."""
    n_in, n_out = A.shape
    parts = 1 if n_out >= threads else threads // n_out
    chunk = r4(-(-n_in // parts))
    total = torch.zeros(n_out, dtype=A.dtype)
    for q in range(parts):
        i0 = min(n_in, q * chunk)
        i1 = min(n_in, i0 + chunk)
        if i1 > i0:
            total = total + col_dot_order(v[i0:i1], A[i0:i1])
    return total


def row_xor_order(v, AT):
    """``factor_t``'s row form: row c of AT (n_t x m) against v, lane l
    summing elements l, l + 32, ... in order, then the xor tree over the 32
    lanes (offsets 16, 8, 4, 2, 1)."""
    n_t, m = AT.shape
    K = -(-m // 32)
    Ap = torch.zeros(n_t, K * 32, dtype=AT.dtype)
    Ap[:, :m] = AT
    vp = torch.zeros(K * 32, dtype=v.dtype)
    vp[:m] = v
    Ap, vp = Ap.reshape(n_t, K, 32), vp.reshape(K, 32)
    lanes = torch.zeros(n_t, 32, dtype=AT.dtype)
    for k in range(K):
        lanes = lanes + Ap[:, k] * vp[k]
    off = 16
    while off:
        lanes = lanes + lanes[:, [i ^ off for i in range(32)]]
        off //= 2
    return lanes[:, 0]


def factored_steps(t_of, SuT, p0, lower, upper, z, y, rho, iterations, over_relax):
    """``factored_admm``: t = t_of(v), GU = p0 + [t | t Su'] (Su' in
    slices), the relaxation, clip (y / rho as y * (1 / rho)) and dual
    update. Returns ``(z, y, rows clipped in the last step)``."""
    n_t = SuT.shape[0]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    rho_, a, am, inv_rho = f32(rho), f32(over_relax), f32(1.0 - over_relax), f32(1.0) / f32(rho)
    clipped = 0
    for _ in range(iterations):
        t = t_of(rho_ * z - y)
        GU = p0 + torch.cat([t, matvec_aligned_order(t, SuT)])
        Gt = a * GU + am * z
        free = Gt + y * inv_rho
        z_new = torch.minimum(torch.maximum(free, lower), upper)
        clipped = int((z_new != free).sum())
        y = y + rho_ * (Gt - z_new)
        z = z_new
    return z, y, clipped


def k3_order(data, x0, w, ref, z, y, rho, iterations, over_relax):
    """``gpmpc_controller_fused_plain`` with K3's sums: condensed_solve's
    products in matvec_partial's slices on 512 threads, the factored steps
    (t and t Su' in aligned_slice's slices, in registers or through L2
    alike), U from t in slices."""
    Nnu, m = data.Nnu, data.P1.shape[0]
    prod = lambda v, A: matvec_order(v, A, THREADS)
    offset = prod(torch.cat([x0, w]), data.SxSwT)
    f = prod(offset - ref, data.SuTqT)
    off_z = torch.cat([torch.zeros(Nnu), offset])
    lower, upper = data.lo_row - off_z, data.hi_row - off_z
    pm = prod(f, data.PM)
    t_of = lambda v: matvec_aligned_order(v, data.P0matT)
    z, y, clipped = factored_steps(t_of, data.SuT, -pm[:m], lower, upper, z, y, rho, iterations,
                                   over_relax)
    U = -pm[m:] + t_of(torch.tensor(rho, dtype=torch.float32) * z - y)
    return (z, y, U, offset + prod(U, data.SuT)), clipped


WIDE_BOXES = dict(state_lower=(-1e4,) * 6, state_upper=(1e4,) * 6,
                  control_lower=(-1e4,) * 4, control_upper=(1e4,) * 4)


def k3_case(N, iterations, boxes, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    cfg = dict(WIDE_BOXES) if boxes == "inactive" else {}
    mpc = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=iterations,
                                    use_fused_controller=True, **cfg), device="cpu")
    m = mpc.n_constraints
    x0 = f32([0.2, -0.1, 2.7, 0.3, 0.1, -0.2])
    w = torch.cat([torch.zeros(N, 3), f32(0.02 * rng.normal(size=(N, 3)))], 1).reshape(-1)
    # a reference 12 m away saturates the controls (active boxes)
    far = 12.0 if boxes == "active" else 0.0
    ref = f32([0.8 + far, 0.3, 3.0, 0.0, 0.0, 0.0]).repeat(N)
    z0, y0 = f32(0.3 * rng.normal(size=m)), f32(0.1 * rng.normal(size=m))
    return mpc._tick_data, x0, w, ref, z0, y0


@pytest.mark.parametrize("boxes", ["active", "inactive"])
@pytest.mark.parametrize("N, iterations", [(8, 10), (20, 10), (25, 10), (25, 80), (26, 10)])
def test_k3_factored_order_holds_plain(N, iterations, boxes):
    args = k3_case(N, iterations, boxes)
    want = controller_pallas.gpmpc_controller_fused_plain(*args, 8.0, iterations, 1.6)
    got, clipped = k3_order(*args, 8.0, iterations, 1.6)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert max(errs) <= SINGLE_TOL, errs
    assert (clipped > 0) == (boxes == "active"), clipped
    # the ADMM did work: the slack left its warm start
    assert float((want[0] - args[4]).abs().max()) > 1e-3


def k6_case(N, iterations, boxes, seed=1):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    cfg = dict(WIDE_BOXES) if boxes == "inactive" else {}
    mpc = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=iterations, use_fused_admm=True,
                                    **cfg), device="cpu")
    m, Nnu, Nnx = mpc.n_constraints, N * NU, N * NX
    # a large gradient saturates the controls (active boxes)
    f = f32((20.0 if boxes == "active" else 1.0) * rng.normal(size=Nnu))
    off = f32(0.3 * rng.normal(size=Nnx))
    return (mpc._P1_f32, (-(mpc._GMinv @ f)).contiguous(), mpc._GMinvT_f32,
            (mpc._M_inv @ f).contiguous(), torch.cat([mpc._u_lo, mpc._x_lo - off]),
            torch.cat([mpc._u_hi, mpc._x_hi - off]), f32(0.3 * rng.normal(size=m)),
            f32(0.1 * rng.normal(size=m))), mpc._SuT_f32


@pytest.mark.parametrize("boxes", ["active", "inactive"])
@pytest.mark.parametrize("N, iterations", [(8, 10), (20, 10), (25, 10), (25, 80), (26, 10)])
def test_k6_factored_order_holds_plain(N, iterations, boxes):
    (P1, p0, GMinvT, minvf, lower, upper, z0, y0), SuT = k6_case(N, iterations, boxes)
    want = admm_pallas.admm_box_qp_fused_composite_plain(P1, p0, GMinvT, minvf, lower, upper,
                                                         z0, y0, 8.0, iterations)
    # the wrapper with the new operand runs the plain version on the CPU
    on_cpu = admm_pallas.admm_box_qp_fused_composite(P1, p0, GMinvT, minvf, lower, upper, z0,
                                                     y0, 8.0, iterations, SuT=SuT)
    assert all(torch.equal(a, b) for a, b in zip(on_cpu, want))
    # the register slices (to N=25) sum t in aligned_slice's slices, the L2
    # variant beyond in the row form's xor tree
    if N <= REGS_LIMIT_N:
        t_of = lambda v: matvec_aligned_order(v, GMinvT.T.contiguous())
    else:
        t_of = lambda v: row_xor_order(v, GMinvT)
    z, y, clipped = factored_steps(t_of, SuT, p0, lower, upper, z0, y0, 8.0, iterations, 1.6)
    U = -minvf + t_of(torch.tensor(8.0) * z - y)
    errs = [float((g - w).abs().max()) for g, w in zip((U, z, y), want)]
    assert max(errs) <= SINGLE_TOL, errs
    assert (clipped > 0) == (boxes == "active"), clipped


@pytest.mark.parametrize("case", ["shape", "dtype", "strided", "device"])
def test_k6_wrapper_refuses_a_malformed_factor(case):
    (P1, p0, GMinvT, minvf, lower, upper, z0, y0), SuT = k6_case(8, 10, "active")
    bad = {
        "shape": torch.zeros(SuT.shape[0], SuT.shape[1] + 1),
        "dtype": SuT.double(),
        "strided": SuT.T.contiguous().T,
        "device": SuT.to("meta"),
    }[case]
    with pytest.raises(ValueError):
        admm_pallas.admm_box_qp_fused_composite(P1, p0, GMinvT, minvf, lower, upper, z0, y0,
                                                8.0, 10, SuT=bad)


def test_section_clocks_read_the_kernels_slots():
    # csrc/single_tick_kernels.cu: K3 and K6 add to K4's slots 2-7 (the
    # solve's phases: K6 5, the ADMM, and 6, U) and 9 (the whole launch),
    # and factored_steps to 10-12 (clock_base 10)
    counters = tick_pallas.SINGLE_TICK_COUNTERS
    slots = {"solve: offset": 2, "ADMM": 5, "solve: U": 6, "solve: X_tail": 7,
             "whole launch": 9, "ADMM: t and the U-block update": 10, "ADMM: t Su'": 11,
             "ADMM: the X-block update": 12}
    assert len(counters) == 13 and all(counters[i] == name for name, i in slots.items())
    assert set(controller_pallas.CONTROLLER_SECTIONS) <= set(counters)
    assert set(admm_pallas.COMPOSITE_SECTIONS) <= set(controller_pallas.CONTROLLER_SECTIONS)
