"""The host-side layout of K14 (``admm_box_qp_fused``, the explicit-inverse
ADMM box QP) on 512 threads, and the arithmetic of its sums, on the CPU (no
card or ``nvcc``):

- each thread's slices (16 rows x q columns of G, r x q of M^-1) fit a
  register variant at the staged MPC's QP (N=20: n=80, m=200, q=3, r=6;
  N=25: n=100, m=250, q=4, r=7) and at the JAX tests' 128-lane padding
  (128 x 128, q=4, r=8), the first variant that holds the row; past one
  16-row group or one 128-column block the wrapper takes the variant that
  reads the slices from shared memory where G and M^-1 fit one H100 block
  (232,448 bytes), else through L2; the layout's bytes are its reckoning;
- a float32 emulation of the kernel's summation order
  (``csrc/single_tick_kernels.cu``: each band's FMA chain for v G and for
  rhs M^-1, the 16 warps' partials added by lane groups and xor shuffles,
  G u as a chain over a lane's columns reduced by a plain xor butterfly
  over the warp, y / rho as a multiply) holds ``admm_box_qp_fused_plain``
  within ``TAIL_TOL`` (2e-5 of each output's scale, ``chip_smoke.py``),
  the bar the card check holds K14 to, at N=20, 25 and 30 with boxes
  binding, and the JAX package's interpret-mode kernel on its own padded
  QP (``test_torch_kernel_tail.py``'s ``k14_case``) within 2e-5, with
  exact zeros in the padded lanes.
"""

import numpy as np
import pytest
import torch

from test_torch_kernel_tail import K14_ITERS, K14_M, K14_N, K14_RHO, PAD, k14_case  # noqa: F401
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, admm_pallas

torch.set_num_threads(1)

SMEM_LIMIT = 232448   # one H100 block's opt-in shared memory
TAIL_TOL = 2e-5
WARPS, ROWS, COLS, MROWS = 16, 16, 128, 8   # bands, a group's rows, a block's columns
# the register variants: (n bound, G's columns a lane, M^-1's rows), a
# thread's slices 16 x q of G and r x q of M^-1
REG_VARIANTS = ((96, 3, 6), (112, 4, 7), (128, 4, 8))
# (n, m): the staged MPC's QP at N=20, 25, 30, the 128-lane padding, past
# one block of columns
SHAPES = {"N20": (80, 200), "N25": (100, 250), "pad128": (128, 128), "N30": (120, 300),
          "n160_m400": (160, 400), "n200_m500": (200, 500)}


def shape_floats(n, m, shared):
    """The layout by hand: 16 bands of ceil(m / 16) rows in 16-row groups,
    128-column blocks, partial rows of 128 blocks + 8 floats."""
    band = -(-m // WARPS)
    slots = ROWS * -(-band // ROWS)
    ldp = COLS * -(-n // COLS) + 8
    floats = 2 * WARPS * ldp + ldp + (ldp - 8) + WARPS * MROWS + 5 * WARPS * slots
    return floats + ((m * n + 3) // 4 * 4 + n * n if shared else 0)


@pytest.mark.parametrize("name", list(SHAPES))
def test_k14_variant_follows_the_slices_fit(monkeypatch, name):
    monkeypatch.setattr(_cuda, "shared_memory_optin", lambda device: SMEM_LIMIT)
    n, m = SHAPES[name]
    S = admm_pallas.explicit_shape(n, m)
    assert S.band == -(-m // WARPS) and S.mband == -(-n // WARPS)
    for shared in (False, True):
        assert admm_pallas.explicit_shared_memory_bytes(n, m, shared) == 4 * shape_floats(n, m,
                                                                                        shared)
    variant, shared, smem = admm_pallas.explicit_variant(None, n, m)
    fits_regs = S.band <= ROWS and S.mband <= MROWS and n <= COLS
    assert fits_regs == (name in ("N20", "N25", "pad128"))
    if fits_regs:
        # every slice row of the band and every column of the lane in
        # registers, in the first variant that holds the row
        assert admm_pallas.EXPLICIT_REG_VARIANTS == REG_VARIANTS and not shared
        n_max, q, r = REG_VARIANTS[variant - 1]
        assert n <= n_max and all(n > b for b, _, _ in REG_VARIANTS[: variant - 1])
        assert variant == {"N20": 1, "N25": 2, "pad128": 3}[name]
        assert S.band <= ROWS and S.mband <= r and n <= 32 * q
        assert ROWS * q + r * q <= 96 and S.groups == S.mgroups == S.blocks == 1
    else:
        assert variant == admm_pallas.EXPLICIT_MEMORY
        assert shared == (4 * shape_floats(n, m, True) <= SMEM_LIMIT)
        assert shared == (name == "N30")
    assert smem == admm_pallas.explicit_shared_memory_bytes(n, m, shared) <= SMEM_LIMIT
    # the bands and the M^-1 groups cover the rows; (b)'s reads stay inside
    # a partial row: the last warp's last rhs row is below ldp
    assert WARPS * S.band >= m and WARPS * S.mband >= n
    assert (WARPS - 1) * S.mband + MROWS * S.mgroups - 1 < S.ldp
    assert S.ldp % 32 == 8   # the four lane groups of a sum read distinct banks


def test_k14_vectors_refuse_past_one_block(monkeypatch):
    monkeypatch.setattr(_cuda, "shared_memory_optin", lambda device: SMEM_LIMIT)
    with pytest.raises(ValueError, match="vectors"):
        admm_pallas.explicit_variant(None, 4000, 40000)


# ---------------------------------------------------------------------------
# the kernel's summation order
# ---------------------------------------------------------------------------


def fma(a, b, c):
    """fmaf in float32 (the product exact in float64, one rounding)."""
    return (a.double() * b.double() + c.double()).float()


def warps_total(part):
    """The 16 warps' partials (rows of ``part``) as the kernel adds them:
    lane group g adds warps g, g + 4, g + 8, g + 12 in order, then the
    groups meet at xor 8 and 16: (s0 + s1) + (s2 + s3)."""
    s = [((part[g] + part[g + 4]) + part[g + 8]) + part[g + 12] for g in range(4)]
    return (s[0] + s[1]) + (s[2] + s[3])


def butterfly(x):
    """A plain xor butterfly over the last axis (32 lanes)."""
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., [i ^ off for i in range(32)]]
    return x[..., 0]


def k14_order(M_inv, G, f, lower, upper, z0, y0, rho, iterations, over_relax):
    """``admm_box_qp_fused`` with the kernel's sums: ``(U, z, y)``."""
    n, m = M_inv.shape[0], G.shape[0]
    S = admm_pallas.explicit_shape(n, m)
    C = COLS * S.blocks
    Gb = torch.zeros(WARPS, S.slots, C)
    Mb = torch.zeros(WARPS, MROWS * S.mgroups, C)
    slot = torch.zeros(4, WARPS, S.slots)          # z, y, lower, upper by row slot
    for w in range(WARPS):
        r0, r1 = min(m, w * S.band), min(m, (w + 1) * S.band)
        Gb[w, : r1 - r0, :n] = G[r0:r1]
        for i, vec in enumerate((z0, y0, lower, upper)):
            slot[i, w, : r1 - r0] = vec[r0:r1]
        k0, k1 = min(n, w * S.mband), min(n, (w + 1) * S.mband)
        Mb[w, : k1 - k0, :n] = M_inv[k0:k1]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    rho_, a, am = f32(rho), f32(over_relax), f32(1.0 - over_relax)
    inv_rho = f32(1.0) / rho_
    z, y, lo, hi = slot
    v = rho_ * z - y
    fpad = torch.zeros(S.ldp)
    fpad[:n] = f
    part = torch.zeros(WARPS, S.ldp)
    lanes = Gb.reshape(WARPS, S.slots, C // 32, 32)
    for it in range(iterations + 1):
        # (a) v G: each band's chain over its rows
        p = torch.zeros(WARPS, C)
        for h in range(S.band):
            p = fma(v[:, h, None], Gb[:, h], p)
        part[:, :C] = p
        # (b) rhs for each warp's M^-1 band, (c) rhs M^-1 in a chain over it
        rhs = -fpad + warps_total(part)
        p = torch.zeros(WARPS, C)
        for j in range(S.mband):
            k = torch.arange(WARPS) * S.mband + j
            p = fma(rhs[k][:, None], Mb[:, j], p)
        # (d) u
        u = warps_total(p)[:n]
        if it == iterations:
            break
        # (e) G u: a lane's chain over its columns, then the butterfly
        upad = torch.zeros(C)
        upad[:n] = u
        acc = torch.zeros(WARPS, S.slots, 32)
        for q in range(C // 32):
            if 32 * q < n:
                acc = fma(lanes[:, :, q], upad[32 * q: 32 * q + 32], acc)
        gu = butterfly(acc)
        Gt = a * gu + am * z
        zn = torch.minimum(torch.maximum(Gt + y * inv_rho, lo), hi)
        y = y + rho_ * (Gt - zn)
        z = zn
        v = rho_ * z - y
    rows = lambda t: torch.cat([t[w, : min(m, (w + 1) * S.band) - min(m, w * S.band)]
                                for w in range(WARPS)])
    return u, rows(z), rows(y)


def mpc_qp(N, seed=0):
    """The staged MPC's QP at horizon N (``LinearMPC``'s own M^-1 and G),
    off hover so that boxes bind; 80 iterations, rho 8, relaxation 1.6."""
    mpc = LinearMPC(LinearMPCConfig(horizon=N), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    m = mpc.n_constraints
    x0 = torch.tensor([2.0, -1.5, 1.0, 1.0, -0.5, 0.3])
    ref = torch.tensor([0.0, 0.0, 3.0, 0.0, 0.0, 0.0]).repeat(N)
    offset = mpc._Sx @ x0
    f = mpc._SuT_q @ (offset - ref)
    lower = torch.cat([mpc._u_lo, mpc._x_lo - offset])
    upper = torch.cat([mpc._u_hi, mpc._x_hi - offset])
    z0, y0 = 0.1 * torch.randn(m, generator=gen), 0.1 * torch.randn(m, generator=gen)
    return mpc._M_inv, mpc._G, f, lower, upper, z0, y0, 8.0, 80, 1.6


def scale_err(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("N", [20, 25, 30])
def test_k14_kernel_order_holds_plain(N):
    M_inv, G, f, lower, upper, z0, y0, rho, iters, a = mpc_qp(N)
    got = k14_order(M_inv, G, f, lower, upper, z0, y0, rho, iters, a)
    want = admm_pallas.admm_box_qp_fused_plain(M_inv, G, G.T, f, lower, upper, z0, y0, rho,
                                               iters, a)
    errs = [scale_err(g, w) for g, w in zip(got, want)]
    assert max(errs) <= TAIL_TOL, errs
    # the solve is not trivial: rows sit on their boxes
    assert int(((want[1] == lower) | (want[1] == upper)).sum()) > 0


def test_k14_kernel_order_holds_jax_kernel_on_padded_lanes(k14_case):  # noqa: F811
    c = k14_case
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    zeros = torch.zeros(PAD)
    U, z, y = k14_order(t(c["Mp"]), t(c["Gp"]), t(c["pad"](c["f"])), t(c["pad"](c["lo"])),
                        t(c["pad"](c["hi"])), zeros, zeros, K14_RHO, K14_ITERS, 1.6)
    for name, g, w, k in zip(("U", "z", "y"), (U, z, y), c["want"], (K14_N, K14_M, K14_M)):
        np.testing.assert_allclose(g[:k].numpy(), w[:k], rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(w).max()), err_msg=name)
    assert torch.all(U[K14_N:] == 0) and torch.all(z[K14_M:] == 0) and torch.all(y[K14_M:] == 0)
