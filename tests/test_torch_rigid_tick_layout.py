"""The host-side layout of kernel K11 (``direct_rate_multitick_kernel``), which
holds the ADMM operator P1 = Gs GMinvT_s as its two factors, and the
arithmetic of its factored product, on the CPU (no card or ``nvcc``):

- the layout with the factors in shared memory fits one H100 block
  (232,448 bytes) at the direct-rate width N=20 and the rigid width N=15,
  up to N=21; past that the wrapper takes the variant that reads the
  factors through L2;
- ``dispatch_tick_operands`` gives ``Gs @ GMinvT_s`` equal to its ``P1``
  within float32 rounding, with Gs's top N nu rows diagonal (the kernel
  reads only that diagonal of them);
- without ``with_p1`` the dispatch forms no P1 and the same factors, which
  the plain version (and so the wrapper on CPU tensors) refuses;
- ``convert.rigid_tick_operands_from_numpy`` refuses a Gs whose top block
  is not diagonal and a P1 that is not its factors' product;
- the factored product (v Gs) GMinvT_s equals v P1 in float64;
- a float32 emulation of the kernel's ticks on the factors, every sum in
  the kernel's order (the first product's lane slices and transposed
  shuffle reduction, or the L2 variant's row slices; the column-owned
  second product's four accumulators) and y / rho taken as y times the
  float32 reciprocal of rho, as the kernel takes it, over one launch (K=8,
  30 iterations) holds ``direct_rate_multitick_plain`` within ``K11_TOL``
  (5e-4, ``chip_smoke.py``), the bar the card check holds the kernel to.

Tolerances: 2e-6 relative for P1 formed in float32 against its factors'
product in float64 (sums of N nu = 80 terms, ~sqrt(80) 6e-8 each, beside
the float32 rounding of P1's own product); 1e-12 relative for the
factored product against v P1 in float64.
"""

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu_torch import convert
from unmanned_aerial_vehicles_tpu_torch.control.mpc_rigid import DirectRateMPC, RigidBodyMPC
from unmanned_aerial_vehicles_tpu_torch.loop.rigid_loop import dispatch_tick_operands
from unmanned_aerial_vehicles_tpu_torch.models import X500_PARAMS
from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, rigid_tick_pallas as k11
from unmanned_aerial_vehicles_tpu_torch.ops.qp import roll_block
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

torch.set_num_threads(1)

SMEM_LIMIT = 232448   # one H100 block's opt-in shared memory
K11_TOL = 5e-4
NU, NX = 4, 12


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def engine(plant, N):
    cls = DirectRateMPC if plant == "direct_rate" else RigidBodyMPC
    return cls(horizon=N, device="cpu")


def dispatch(plant, N):
    """One dispatch's operands about hover at 3 m, as the fused tier forms
    them (``loop.rigid_loop.dispatch_tick_operands``)."""
    eng = engine(plant, N)
    x0 = torch.zeros(12)
    x0[2] = 3.0
    _, ops = dispatch_tick_operands(eng.mpc, eng.cost, x0[None, :].repeat(N + 1, 1),
                                    eng.u_hover[None, :].repeat(N, 1))
    return eng, ops


# ---------------------------------------------------------------------------
# shared memory and the choice of layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,shared", [(15, 1), (20, 1), (21, 1), (22, 0), (25, 0), (40, 0)])
def test_k11_layout_fits_one_h100_block(monkeypatch, N, shared):
    monkeypatch.setattr(_cuda, "shared_memory_optin", lambda device: SMEM_LIMIT)
    got_shared, smem = k11.factor_placement(None, N)
    assert got_shared == shared
    assert smem == k11.shared_memory_bytes(N, factors_shared=bool(shared)) <= SMEM_LIMIT
    m, Nnu, Nnx = N * (NU + NX), N * NU, N * NX
    vectors = 4 * (m + 2 * Nnu + 10 * m + 3 * Nnx + 12)
    if shared:
        # the two factors (GsL' with its padded rows, GMinvT_s) and Gs's diagonal
        assert smem == vectors + 4 * (Nnu * (Nnx + 4) + Nnu * m + Nnu)
    else:
        assert k11.shared_memory_bytes(N, factors_shared=True) > SMEM_LIMIT
        assert smem == vectors + 4 * max(k11.KERNEL_THREADS, Nnu)


# ---------------------------------------------------------------------------
# the factors the dispatch hands over
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plant,N", [("direct_rate", 20), ("rigid", 15)])
def test_dispatch_factors_give_p1(plant, N):
    _, ops = dispatch(plant, N)
    Nnu, m = N * NU, N * (NU + NX)
    assert tuple(ops.Gs.shape) == (m, Nnu) and ops.Gs.is_contiguous()
    assert tuple(ops.GMinvT_s.shape) == (Nnu, m)
    # [I; Su] equilibrated: the top block is exactly diagonal, diag(e[:Nnu] d)
    top = ops.Gs[:Nnu]
    assert torch.equal(top, torch.diag(torch.diagonal(top)))
    np.testing.assert_allclose(torch.diagonal(top).numpy(), (ops.e[:Nnu] * ops.d).numpy(),
                               rtol=2e-7)
    factored = ops.Gs.double() @ ops.GMinvT_s.double()
    assert rel(ops.P1, factored) <= 2e-6


@pytest.mark.parametrize("plant,N", [("direct_rate", 20), ("rigid", 15)])
def test_dispatch_without_p1_keeps_the_factors(plant, N):
    eng, ops = dispatch(plant, N)
    x0 = torch.zeros(12)
    x0[2] = 3.0
    _, bare = dispatch_tick_operands(eng.mpc, eng.cost, x0[None, :].repeat(N + 1, 1),
                                     eng.u_hover[None, :].repeat(N, 1), with_p1=False)
    assert bare.P1 is None
    for name, t in ops._asdict().items():
        if name != "P1":
            assert torch.equal(getattr(bare, name), t), name
    m = N * (NU + NX)
    args = (x0, torch.zeros(m), torch.zeros(m), torch.zeros(2, N * NX), bare)
    statics = dict(k_ticks=2, n=N, nu=NU, nx=NX, iterations=2, over_relax=1.6, rho=0.1, dt=0.02,
                   substeps=1)
    with pytest.raises(ValueError, match="P1"):
        k11.direct_rate_multitick_plain(*args, **statics)
    with pytest.raises(TypeError, match="P1"):
        k11.direct_rate_multitick_kernel(*args, **statics)


def padded_layouts(ops, N):
    """``ops`` in the JAX kernel's layouts (unpadded) for
    ``convert.rigid_tick_operands_from_numpy``, with Gs beside them."""
    Nnx = N * NX
    sxct = np.zeros((16, Nnx), np.float32)
    sxct[0:NX] = ops.Sx.numpy().T
    sxct[12] = ops.Sc.numpy()
    row = lambda t: t.numpy()[None, :]
    layouts = [sxct, ops.SuT_q.numpy().T, row(ops.f0), ops.GMinvT_s.numpy(), ops.P1.numpy(),
               *(row(getattr(ops, k)) for k in ("d", "e", "ie", "ce", "ice", "lo", "hi"))]
    return layouts, ops.Gs.numpy().copy()


@pytest.mark.parametrize("fault", [None, "gs_top_not_diagonal", "p1_not_factored"])
def test_convert_checks_the_factors(fault):
    N = 15
    _, ops = dispatch("rigid", N)
    layouts, gs = padded_layouts(ops, N)
    if fault == "gs_top_not_diagonal":
        gs[0, 1] = 1e-3
    elif fault == "p1_not_factored":
        layouts[4] = layouts[4].copy()
        layouts[4][3, 5] += 1e-4 * np.abs(layouts[4]).max()
    if fault is None:
        got = convert.rigid_tick_operands_from_numpy(*layouts, horizon=N, gs=gs, device="cpu")
        for name, t in ops._asdict().items():
            assert torch.equal(getattr(got, name), t), name
    else:
        with pytest.raises(ValueError, match="diagonal" if "gs" in fault else "rounding"):
            convert.rigid_tick_operands_from_numpy(*layouts, horizon=N, gs=gs, device="cpu")


@pytest.mark.parametrize("plant,N", [("direct_rate", 20), ("rigid", 15)])
def test_factored_product_equals_p1_product_in_float64(plant, N):
    _, ops = dispatch(plant, N)
    Nnu, m = N * NU, N * (NU + NX)
    Gs, GM = ops.Gs.double(), ops.GMinvT_s.double()
    P1 = Gs @ GM
    v = torch.tensor(np.random.default_rng(N).normal(size=(5, m)))
    want = v @ P1
    assert rel((v @ Gs) @ GM, want) <= 1e-12
    # the kernel's split of the first product: Gs's diagonal top block and its lower rows
    w = v[:, :Nnu] * torch.diagonal(Gs[:Nnu]) + v[:, Nnu:] @ Gs[Nnu:]
    assert rel(w @ GM, want) <= 1e-12


# ---------------------------------------------------------------------------
# the kernel's ticks in float32, every sum in its order
# ---------------------------------------------------------------------------


def col_dot_order(v, A):
    """``sum_i v[i] A[i, :]`` as ``block_linalg.cuh``'s col_dot and
    col_dot_smem add it: accumulator ``i % 4`` in order of i, then
    ``(a0 + a1) + (a2 + a3)``."""
    acc = [torch.zeros(A.shape[1], dtype=A.dtype) for _ in range(4)]
    for i in range(v.shape[0]):
        acc[i & 3] = acc[i & 3] + v[i] * A[i]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def product_shared_order(v, GsL, gd, Nnu):
    """``factor_product_shared``: lane l holds rows 4 l + 128 k + j of the
    lower block (k = 0, 1; j = 0..3), sums ``((j0 + j1) + (j2 + j3))`` per
    k, then k0 + k1; the warp pairs lanes over bits 4, 3, 2, 1, 0 in turn;
    the diagonal term comes first."""
    Nnx = GsL.shape[0]
    rows = torch.zeros(256, Nnu, dtype=GsL.dtype)
    rows[:Nnx] = v[Nnu:, None] * GsL
    p = rows.reshape(2, 32, 4, Nnu)
    lanes = (p[:, :, 0] + p[:, :, 1]) + (p[:, :, 2] + p[:, :, 3])
    x = lanes[0] + lanes[1]
    while x.shape[0] > 1:
        x = x[: x.shape[0] // 2] + x[x.shape[0] // 2:]
    return v[:Nnu] * gd + x[0]


def product_l2_order(v, GsL, gd, Nnu, nth=k11.KERNEL_THREADS):
    """The L2 variant: ``matvec_partial``'s row slices (col_dot each), added
    in order by ``matvec_total``, after the diagonal term."""
    Nnx = GsL.shape[0]
    parts = 1 if Nnu >= nth else nth // Nnu
    chunk = -(-Nnx // parts)
    total = torch.zeros(Nnu, dtype=GsL.dtype)
    for q in range(parts):
        i0 = min(Nnx, q * chunk)
        i1 = min(Nnx, i0 + chunk)
        total = total + (col_dot_order(v[Nnu + i0:Nnu + i1], GsL[i0:i1]) if i1 > i0 else 0.0)
    return v[:Nnu] * gd + total


def k11_emulated(x, z, y, refs, ops, *, k_ticks, n, iterations, over_relax, rho, dt, substeps,
                 plant, body, shared):
    """``direct_rate_multitick_plain``'s ticks with the kernel's ADMM: p0 and
    the second product in col_dot's order on GMinvT_s, the first product
    on Gs's diagonal and lower rows in the chosen variant's order, y / rho
    as y times the float32 ``1 / rho``."""
    Nnu = n * NU
    inv_rho = torch.tensor(1.0) / torch.tensor(rho, dtype=torch.float32)
    GsL, gd, GM = ops.Gs[Nnu:], torch.diagonal(ops.Gs[:Nnu]), ops.GMinvT_s
    product = product_shared_order if shared else product_l2_order
    sub = k11.plant_substep(plant, dt, substeps, 9.81, (0.05, 0.05, 0.08), body)
    shift = lambda v: torch.cat([roll_block(v[:Nnu], n), roll_block(v[Nnu:], n)])
    rows = []
    for t in range(k_ticks):
        z = shift(z) * ops.ce
        y = shift(y) * ops.ice
        offset = ops.Sx @ x + ops.Sc
        fs = (ops.SuT_q @ (offset - refs[t]) + ops.f0) * ops.d
        p0 = -col_dot_order(fs, GM)
        off_z = torch.cat([torch.zeros_like(fs), offset])
        lower = (ops.lo - off_z) * ops.e
        upper = (ops.hi - off_z) * ops.e
        for _ in range(iterations):
            w = product(rho * z - y, GsL, gd, Nnu)
            GU = p0 + col_dot_order(w, GM)
            Gt = over_relax * GU + (1.0 - over_relax) * z
            z_new = torch.minimum(torch.maximum(Gt + y * inv_rho, lower), upper)
            y = y + rho * (Gt - z_new)
            z = z_new
        u0 = z[:NU] * ops.ie[:NU]
        rows.append(torch.cat([x, u0]))
        s = tuple(x[i] for i in range(12))
        for _ in range(substeps):
            s = sub(s, tuple(u0[j] for j in range(NU)))
        x = torch.stack(s)
    return torch.stack(rows), x, z, y


@pytest.mark.parametrize("plant,N,shared", [("direct_rate", 20, True), ("rigid", 15, True),
                                            ("direct_rate", 25, False)])
def test_kernel_order_factored_admm_holds_plain(plant, N, shared):
    eng, ops = dispatch(plant, N)
    K, m = 8, N * (NU + NX)
    rng = np.random.default_rng(7)
    x = torch.zeros(12)
    x[2] = 3.0
    x += torch.tensor(0.05 * rng.normal(size=12), dtype=torch.float32)
    z = torch.tensor(0.3 * rng.normal(size=m), dtype=torch.float32) * ops.e
    y = torch.tensor(0.1 * rng.normal(size=m), dtype=torch.float32) / ops.e
    pos, _, _ = ramped_circle_reference(10.0 + 0.02 * torch.arange(K, dtype=torch.float32),
                                        amplitude=2.0, height=3.0)
    refs = torch.cat([pos, torch.zeros(K, 9)], 1)[:, None, :].repeat(1, N, 1).reshape(K, -1)
    statics = dict(k_ticks=K, n=N, iterations=30, over_relax=1.6,
                   rho=float(eng.mpc.config.admm_rho), dt=0.02, substeps=1, plant=plant,
                   body=X500_PARAMS if plant == "rigid" else None)
    assert k11.shared_memory_bytes(N, factors_shared=True) <= SMEM_LIMIT or not shared
    got = k11_emulated(x, z, y, refs, ops, shared=shared, **statics)
    want = k11.direct_rate_multitick_plain(x, z, y, refs, ops, nu=NU, nx=NX, **statics)
    for name, g, w in zip(("out", "x", "z", "y"), got, want):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
        err = float((g - w).abs().max())
        assert err <= K11_TOL, (name, err)
    # the ADMM did work: the controls moved off the hover guess
    assert float((want[0][:, 12:16] - eng.u_hover).abs().max()) > 1e-3
