"""The host-side layout of the single-tick kernel K4 (``gpmpc_tick_fused``)
on its 512-thread block, and the arithmetic of its summation order, on the
CPU (no card or ``nvcc``):

- K4's block fits one H100 block (232,448 bytes) up to N=23 with P1 in
  shared memory and takes the variant reading P1 through L2 beyond;
- P1's bulk copies: 16-byte aligned, whole 16-byte units, one transaction
  count within the barrier's range;
- the warm start's index remap (``warm_shift``) is the plain version's
  ``ShiftT`` product;
- a float32 emulation of the kernel's sums (``condensed_solve`` at 512
  threads: the products with the fixed operators in matvec_partial's
  slices, the ADMM's column dots) holds ``gpmpc_tick_fused_plain`` within
  ``SINGLE_TOL`` (1e-4, ``chip_smoke.py``), the bar the card check holds K4
  to, with and without ``ctrl_state``, a ``tight`` row and the fallback.
"""

import numpy as np
import pytest
import torch

from test_torch_multitick_layout import controller_order
from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, plant_pallas, tick_pallas

torch.set_num_threads(1)

SMEM_LIMIT = 232448   # one H100 block's opt-in shared memory
SINGLE_TOL = 1e-4
NU, NX = 4, 6
COPY_CHUNK = 16384    # csrc/single_tick_kernels.cu kCopyChunk
TX_LIMIT = 2**20 - 1  # an mbarrier's transaction count


@pytest.mark.parametrize("N", [20, 21, 22, 23])
def test_k4_block_fits_with_p1_shared(N):
    threads = tick_pallas.SINGLE_TICK_THREADS
    assert threads == 512
    m, Nnu, Nnx = N * (NU + NX), N * NU, N * NX
    m4 = (m + 3) // 4 * 4
    # the barrier (4 floats), P1, va and vb, 5 m-vectors, [x0 | w], offset
    # and ref error, 3 Nnu rows, the slices, x0's copy
    floats = 4 + m * m + 2 * m4 + 5 * m + NX + 3 * Nnx + 3 * Nnu + max(threads, m + Nnu) + NX
    assert tick_pallas.single_tick_shared_memory_bytes(N) == 4 * floats <= SMEM_LIMIT


@pytest.mark.parametrize("N", [20, 23, 24, 25, 40])
def test_k4_variant_choice(monkeypatch, N):
    monkeypatch.setattr(_cuda, "shared_memory_optin", lambda device: SMEM_LIMIT)
    layout = tick_pallas.single_tick_shared_memory_bytes
    p1_shared, smem = _cuda.p1_variant(None, layout(N, True), layout(N, False))
    assert p1_shared == (N <= 23)
    assert smem == layout(N, bool(p1_shared)) <= SMEM_LIMIT


@pytest.mark.parametrize("N", range(1, 24))
def test_k4_p1_bulk_copies(N):
    m = N * (NU + NX)
    nbytes = 4 * m * m
    # P1 starts after the 16-byte barrier, va and vb after P1: all 16-byte
    # aligned; the copies are whole 16-byte units of at most COPY_CHUNK
    assert nbytes % 16 == 0 and COPY_CHUNK % 16 == 0
    chunks = [min(nbytes - off, COPY_CHUNK) for off in range(0, nbytes, COPY_CHUNK)]
    assert sum(chunks) == nbytes and all(c % 16 == 0 and c > 0 for c in chunks)
    assert nbytes <= TX_LIMIT


def warm_shift(v, N):
    """``multitick_phases.cuh:warm_shift``'s gather: index i takes i + 4 in
    the U-block and i + 6 in the X-block but for the last stage's."""
    Nnu, Nnx = N * NU, N * NX
    src = []
    for i in range(v.shape[0]):
        if i < Nnu - NU:
            src.append(i + NU)
        elif Nnu <= i < Nnu + Nnx - NX:
            src.append(i + NX)
        else:
            src.append(i)
    return v[src]


@pytest.mark.parametrize("N", [8, 20, 25])
def test_warm_shift_is_the_shift_matrix(N):
    mpc = LinearMPC(LinearMPCConfig(horizon=N, use_fused_controller=True), device="cpu")
    v = torch.tensor(np.random.default_rng(N).normal(size=mpc.n_constraints), dtype=torch.float32)
    assert torch.equal(warm_shift(v, N), v @ mpc._tick_data.ShiftT)


def k4_operands(N, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    mpc = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=10, use_fused_controller=True),
                    device="cpu")
    m = mpc.n_constraints
    state = torch.zeros(12)
    state[:9] = f32([0.2, -0.1, 2.7, 0.3, 0.1, -0.2, 0.05, -0.04, 0.3])
    w = torch.cat([torch.zeros(N, 3), f32(0.02 * rng.normal(size=(N, 3)))], 1).reshape(-1)
    ref = f32([0.8, 0.3, 3.0, 0.0, 0.0, 0.0]).repeat(N)
    misc = f32([0.1, 0.02, -0.01, 0.03])
    z0, y0 = f32(0.3 * rng.normal(size=m)), f32(0.1 * rng.normal(size=m))
    prow = plant_pallas.build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81,
                                        (0.8, 0.4, 0.0), device="cpu")
    tight = torch.zeros(m)
    tight[N * NU:] = f32(0.2 * rng.random(N * NX))
    cover = dict(ctrl_state=state + f32(0.05 * rng.normal(size=12)), tight=tight,
                 fallback_error_m=0.3)
    return (mpc._tick_data, state, w, ref, misc, z0, y0, prow), cover


STATICS = dict(rho=8.0, iterations=10, over_relax=1.6, dt=0.02, substeps=2,
               accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0), yawrate_limit=0.8)


@pytest.mark.parametrize("cover", [False, True], ids=["plain", "ctrl_state_tight_fallback"])
@pytest.mark.parametrize("N", [8, 20, 25])
def test_k4_kernel_order_holds_plain(monkeypatch, N, cover):
    args, extra = k4_operands(N)
    kw = dict(STATICS, n=N, **(extra if cover else {}))
    want = tick_pallas.gpmpc_tick_fused_plain(*args, **kw)
    monkeypatch.setattr(tick_pallas, "controller_plain",
                        controller_order(tick_pallas.SINGLE_TICK_THREADS))
    got = tick_pallas.gpmpc_tick_fused_plain(*args, **kw)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert max(errs) <= SINGLE_TOL, errs
    # the ADMM did work: the slack left its shifted warm start
    assert float((want[1] - warm_shift(args[5], N)).abs().max()) > 1e-3
