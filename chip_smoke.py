#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernels from ``unmanned_aerial_vehicles_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once) and print the build time and register report;
2. hold every kernel against its plain PyTorch version on the card: K1 and
   K2 over the flight loops' batch of one and a batch of random states
   (tolerance 1e-5), K5 for one launch at full width (N=20, P=800, K=20,
   10 ADMM iterations, GP fitted on the seeded synthetic set) on the packed
   lanes and every carry (tolerance 1e-4), K8 at the sweep's width
   (B=1024, N=20, 10 ADMM iterations, random planes; tolerance 1e-4 on all
   six outputs) and K7 at the sweep's width (20480 queries against the
   800-point GP; tolerance 1e-5); time each kernel and its plain version
   alone: device time from CUDA events around a replayed CUDA graph of
   many calls, and time with the host's overhead, eagerly; time K5 also
   without its GP section and without its ADMM iterations, and K2 also at
   the sweep's batch of 1024;
3. fly every path of the slices through the user entry points with the
   launch counts set to 0 just before and read just after: the online
   GP-MPC figure-8 (K=20, P=800, N=20, 500 ticks, refit every 250; K5 must
   launch 25 times), a staged 100-tick flight with the fused allocation +
   plant (K2, 100 launches), a cascade-PID flight with the fused plant (K1,
   100 launches), and the throughput sweep (1024 figure-8 flights, N=20,
   P=800, 100 ticks: K8, K7 and K2 100 launches each; again with
   ``gp_every=5``: K7 20 launches); each is held against the same flight
   through the plain versions on the card;
4. time microseconds per online tick as the slope between two flight
   lengths, for the kernel path and the plain path, and microseconds per
   flight-tick of the 1024-flight sweep as the slope between 200 and 700
   ticks (``gp_posterior`` with ``gp_every`` 1 and 5, and ``residual_fn``),
   and the device's busy time per sweep tick by kernel from a
   ``torch.profiler`` window of 50 ticks;
5. print the kernels' JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits 2 without one, or when run outside a checkout of
the repository.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "unmanned_aerial_vehicles_tpu_torch"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 non-tensor op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

PLANT_TOL = 1e-5
TICK_TOL = 1e-4
ONLINE_GAP_BOUND_M = 1e-3    # kernel vs plain flight, 500 online ticks
STAGED_GAP_BOUND_M = 1e-4    # kernel vs plain flight, 100 ticks

HORIZON, K_TICKS, GP_POINTS, ADMM_ITERS = 20, 20, 800, 10
T_MAIN = 500
T_SLOPE = (1000, 3000)        # kernel path
T_SLOPE_PLAIN = (100, 300)    # plain path (hundreds of small launches per tick)

SWEEP_B, SWEEP_T = 1024, 100  # the throughput sweep (bench.py:301-307)
T_SWEEP_SLOPE = (200, 700)    # bench.py:301
K8_TOL = 1e-4
K7_TOL = 1e-5
SWEEP_GAP_BOUND_M = 1e-3      # kernel vs plain sweep, max over all flights


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in
    one CUDA graph, replayed and timed with CUDA events, so the host's
    Python and launch overhead is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# operation counts of the plant math (one per add, multiply, division,
# comparison-select, sqrt or transcendental), read off csrc/plant_math.cuh
OPS_DERIVATIVE = 62
OPS_RK4_SUBSTEP = 4 * OPS_DERIVATIVE + 3 * 24 + 12 * 7
OPS_ALLOCATION = 75


def ops_structured_controller(N: int, iterations: int, nx: int = 6) -> int:
    """FP32 operations of one K8 flight-tick (an FMA counts 2), read off
    csrc/controller_kernels.cu."""
    Nnu, Nnx = 4 * N, 6 * N
    setup = 2 * (nx + Nnx) * Nnx + 4 * Nnx + 2 * Nnx * Nnu + 2 * (Nnu + Nnx)
    phase_t = Nnu * (2 * Nnx + 2)
    iteration = phase_t + Nnu * (2 * Nnu + 12) + Nnx * (2 * Nnu + 12)
    final = phase_t + 2 * Nnu * Nnu + Nnx * (2 * Nnu + 1)
    return setup + iterations * iteration + final


def ops_posterior_mean(m: int, P: int, d: int = 10, out: int = 6) -> int:
    """FP32 operations of K7 (csrc/rbf_kernels.cu): per (query, training
    point) pair the d-term dot, the distance (4), the scale and expf (2) and
    the out accumulations; per query its features, norm and offset."""
    return m * P * (2 * d + 4 + 2 + 2 * out) + m * (3 * d + out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: run from a checkout of the repository ({PKG}/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
        ResidualGPConfig,
        build_horizon_residuals,
        fit_residual_gp,
    )
    from unmanned_aerial_vehicles_tpu_torch.loop import (
        FlightLoopConfig,
        OnlineFusedGPConfig,
        batched_mpc_flight_sweep,
        mpc_flight_rollout,
        pid_flight_rollout,
    )
    from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
    from unmanned_aerial_vehicles_tpu_torch.ops import (
        _cuda,
        controller_pallas,
        plant_pallas,
        rbf_pallas,
        tick_pallas,
    )
    from unmanned_aerial_vehicles_tpu_torch.parallel import structured_flight_sweep
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    _cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(_cuda.LIBRARIES)} libraries")
    for name, log in _cuda.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    gen = torch.Generator(device="cpu").manual_seed(0)
    f32 = dict(dtype=torch.float32, device=dev)
    taus = (0.05, 0.05, 0.08)
    wind = (0.8, 0.4, 0.0)
    prow = plant_pallas.build_plant_row(0.5, 9.81, 0.25, taus, 9.81, wind, device=dev)

    def random_states(B):
        s = torch.randn(B, 12, generator=gen)
        s[:, 6:9] = (torch.rand(B, 3, generator=gen) - 0.5) * 1.2
        s[:, 9:12] *= 0.5
        return s.to(**f32).contiguous()

    kernels = {}

    # ---- phase 2: kernels against their plain versions ---------------------
    # K1
    errs = []
    for B in (1, 4096):
        s = random_states(B)
        c = torch.cat([0.6 + 0.7 * torch.rand(B, 1, generator=gen),
                       torch.randn(B, 3, generator=gen)], 1).to(**f32).contiguous()
        got = plant_pallas._px4_plant_rows(s, c, prow, 0.02, 2)
        torch.cuda.synchronize()
        want = plant_pallas.px4_plant_step_plain(s, c, prow, 0.02, 2)
        errs.append(float((got - want).abs().max()))
    s1, c1 = s[:1].contiguous(), c[:1].contiguous()
    k1_fn = lambda: plant_pallas._px4_plant_rows(s1, c1, prow, 0.02, 2)
    k1_plain = lambda: plant_pallas.px4_plant_step_plain(s1, c1, prow, 0.02, 2)
    k1 = dict(
        err=max(errs),
        ms=graph_ms(k1_fn, 200), plain_ms=graph_ms(k1_plain, 5),
        host_ms=cuda_ms(k1_fn, 500), host_plain_ms=cuda_ms(k1_plain, 20),
        bound=bound_ms(nbytes(s1, c1, prow) + nbytes(s1), 2 * OPS_RK4_SUBSTEP),
    )
    kernels["px4_plant_step_fused"] = k1
    print(f"K1 px4_plant_step_fused: max_abs_err {k1['err']:.3e} (B=1, 4096)")
    if not k1["err"] <= PLANT_TOL:
        fail(f"K1 disagrees with its plain version: {k1['err']}")

    # K2
    errs = []
    for B in (1, 4096):
        s = random_states(B)
        # roll and yaw across the +-pi wrap; pitch kept off the Euler-rate
        # singularity (1/cos(theta) would amplify float32 rounding)
        s[:, 6] = ((torch.rand(B, generator=gen) - 0.5) * 7.0).to(dev)
        s[:, 8] = ((torch.rand(B, generator=gen) - 0.5) * 7.0).to(dev)
        cmd = torch.cat([
            2.0 * torch.randn(B, 3, generator=gen), torch.randn(B, 1, generator=gen),
            6.0 * (torch.rand(B, 1, generator=gen) - 0.5),
            torch.where(torch.rand(B, 1, generator=gen) < 0.5, 1.2, 1.5),
        ], 1).to(**f32).contiguous()
        integ = (0.6 * (torch.rand(B, 3, generator=gen) - 0.5)).to(**f32).contiguous()
        got = plant_pallas._allocation_plant_rows(s, cmd, integ, prow, 0.02, 2)
        torch.cuda.synchronize()
        want = plant_pallas.allocation_plant_tick_plain(s, cmd, integ, prow, 0.02, 2)
        errs.append(max(float((g - w).abs().max()) for g, w in zip(got, want)))
    def k2_timing(B):
        sb, cb, ib = s[:B].contiguous(), cmd[:B].contiguous(), integ[:B].contiguous()
        fn = lambda: plant_pallas._allocation_plant_rows(sb, cb, ib, prow, 0.02, 2)
        plain = lambda: plant_pallas.allocation_plant_tick_plain(sb, cb, ib, prow, 0.02, 2)
        return dict(
            ms=graph_ms(fn, 200), plain_ms=graph_ms(plain, 5),
            host_ms=cuda_ms(fn, 500), host_plain_ms=cuda_ms(plain, 20),
            bound=bound_ms(nbytes(sb, cb, ib, prow) + 4 * B * (12 + 7 + 3),
                           B * (OPS_ALLOCATION + 2 * OPS_RK4_SUBSTEP)),
        )

    # the JSON line carries K2 at the sweep's batch (its launches are the
    # sweep's); the staged flight's batch of one is printed beside it
    k2 = dict(err=max(errs), **k2_timing(SWEEP_B), batch_1=k2_timing(1))
    kernels["allocation_plant_tick_fused"] = k2
    print(f"K2 allocation_plant_tick_fused: max_abs_err {k2['err']:.3e} (B=1, 4096)")
    if not k2["err"] <= PLANT_TOL:
        fail(f"K2 disagrees with its plain version: {k2['err']}")

    # K5: one launch at full width from a GP fitted on the seeded synthetic set
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ADMM_ITERS,
                                    use_fused_controller=True), device=dev)
    data = tick_pallas.build_tick_data(mpc._fc_data, HORIZON, 4, 6, device=dev)
    rng = np.random.default_rng(0)
    Xs = rng.normal(size=(GP_POINTS, 10))
    Ys = 0.05 * rng.normal(size=(GP_POINTS, 6))
    post = fit_residual_gp(torch.tensor(Xs, **f32), torch.tensor(Ys, **f32), ResidualGPConfig())
    gp = tick_pallas.build_gp_rows(post, 0.1)
    m, Nnx = mpc.n_constraints, HORIZON * 6
    x0 = torch.zeros(12, **f32)
    x0[:3] = torch.tensor([0.3, -0.2, 2.9])
    x0[3:9] = torch.tensor([0.5, 0.2, -0.1, 0.05, -0.03, 0.1])
    aux = torch.cat([x0[:6] + 0.01, torch.tensor([0.02, -0.01, 0.03], **f32)]).contiguous()
    xtail = (x0[:6].repeat(HORIZON) + 0.05 * torch.randn(Nnx, generator=gen).to(dev)).contiguous()
    z0 = (0.3 * torch.randn(m, generator=gen)).to(**f32).contiguous()
    y0 = (0.1 * torch.randn(m, generator=gen)).to(**f32).contiguous()
    ts = 10.0 + 0.02 * torch.arange(K_TICKS, **f32)
    pos, yaw = ramped_figure8_reference(ts)
    pos = pos + torch.tensor([0.0, 0.0, 3.0], **f32)
    refs = torch.cat([pos, torch.zeros(K_TICKS, 3, **f32)], 1).repeat(1, HORIZON).contiguous()
    yaw = yaw.contiguous()
    statics = dict(
        k_ticks=K_TICKS, use_gp=True, rho=8.0, iterations=ADMM_ITERS, over_relax=1.6,
        dt=0.02, substeps=2, accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0),
        yawrate_limit=0.8, n=HORIZON, nu=4, nx=6,
    )
    args = (data, gp, x0, aux, xtail, z0, y0, refs, yaw, prow)
    got = tick_pallas.gpmpc_multitick_fused(*args, **statics)
    torch.cuda.synchronize()
    want = tick_pallas.multitick_staged(*args, **statics)
    k5_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g in got:
        if not torch.isfinite(g).all():
            fail("K5 produced non-finite values")
    gp_ops = HORIZON * GP_POINTS * (2 * 10 + 6 + 6)
    admm_ops = ADMM_ITERS * (2 * m * m + 10 * m)
    Nnu = HORIZON * 4
    rest_ops = (2 * (6 + Nnx) * Nnx + 2 * Nnx * Nnu + 2 * Nnu * (m + Nnu)
                + 2 * m * Nnu + 2 * Nnu * Nnx + OPS_ALLOCATION + 2 * OPS_RK4_SUBSTEP)
    k5_bytes = (nbytes(data.SxSwT, data.SuTqT, data.PM, data.P1, data.P0matT, data.SuT,
                       data.lo_row, data.hi_row, *gp, x0, aux, xtail, z0, y0, refs, yaw, prow)
                + nbytes(*got))
    k5_fn = lambda: tick_pallas.gpmpc_multitick_fused(*args, **statics)
    k5_plain = lambda: tick_pallas.multitick_staged(*args, **statics)
    k5 = dict(
        err=k5_err,
        ms=graph_ms(k5_fn, 20), plain_ms=graph_ms(k5_plain, 1, replays=3),
        host_ms=cuda_ms(k5_fn, 50), host_plain_ms=cuda_ms(k5_plain, 3, warmup=1),
        bound=bound_ms(k5_bytes, K_TICKS * (gp_ops + admm_ops + rest_ops)),
    )
    kernels["gpmpc_multitick_fused"] = k5
    print(f"K5 gpmpc_multitick_fused: max_abs_err {k5_err:.3e} over packed lanes 0:32 "
          f"and the carries (N={HORIZON}, P={GP_POINTS}, K={K_TICKS}); "
          f"shared memory {tick_pallas.shared_memory_bytes(HORIZON)} B")
    if not k5_err <= TICK_TOL:
        fail(f"K5 disagrees with its plain version: {k5_err}")
    # where K5's time goes: the same launch without the GP section, and
    # without the ADMM iterations
    k5_without = {
        what: graph_ms(lambda: tick_pallas.gpmpc_multitick_fused(*args, **{**statics, **change}), 20)
        for what, change in (("the GP", {"use_gp": False}), ("the ADMM iterations", {"iterations": 0}))
    }
    print(f"K5 device time per launch: {k5['ms'] * 1e3:.2f} us; "
          + "; ".join(f"without {w} {ms * 1e3:.2f} us" for w, ms in k5_without.items()))

    # K8 at the sweep's width, from random planes (a few slacks on their boxes)
    B = SWEEP_B
    sdata = controller_pallas.build_structured_batch_data(
        mpc._fc_data, HORIZON, 4, 6, mpc._u_lo, mpc._u_hi, mpc._x_lo, mpc._x_hi, device=dev)
    rnd = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(**f32).contiguous()
    X0 = rnd(B, 6)
    X0[:, 2] += 3.0
    k8_args = (sdata, X0, rnd(B, Nnx, scale=0.02), refs[:1].contiguous(),
               rnd(B, Nnu, scale=3.0), rnd(B, Nnx), rnd(B, Nnu), rnd(B, Nnx),
               8.0, ADMM_ITERS, 1.6)
    got = controller_pallas.gpmpc_controller_structured_batched(*k8_args)
    torch.cuda.synchronize()
    want = controller_pallas.gpmpc_controller_structured_batched_plain(*k8_args)
    k8_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(bool(torch.isfinite(g).all()) for g in got):
        fail("K8 produced non-finite values")
    k8_fn = lambda: controller_pallas.gpmpc_controller_structured_batched(*k8_args)
    k8_plain = lambda: controller_pallas.gpmpc_controller_structured_batched_plain(*k8_args)
    k8 = dict(
        err=k8_err,
        ms=graph_ms(k8_fn, 20), plain_ms=graph_ms(k8_plain, 2, replays=3),
        host_ms=cuda_ms(k8_fn, 50), host_plain_ms=cuda_ms(k8_plain, 5, warmup=1),
        bound=bound_ms(nbytes(*(a for a in k8_args if torch.is_tensor(a)), *sdata[:10])
                       + nbytes(*got), B * ops_structured_controller(HORIZON, ADMM_ITERS)),
    )
    kernels["gpmpc_controller_structured_batched"] = k8
    print(f"K8 gpmpc_controller_structured_batched: max_abs_err {k8_err:.3e} over the six "
          f"outputs (B={B}, N={HORIZON}, {ADMM_ITERS} iterations); shared memory "
          f"{controller_pallas.structured_shared_memory_bytes(HORIZON)} B per block")
    if not k8_err <= K8_TOL:
        fail(f"K8 disagrees with its plain version: {k8_err}")

    # K7 at the sweep's width: B*N queries, a quarter of them near training points
    mq = SWEEP_B * HORIZON
    Xq = rnd(mq, 10)
    near = torch.randint(0, GP_POINTS, (mq // 4,), generator=gen).to(dev)
    Xq[: mq // 4] = post.X_train[near] + rnd(mq // 4, 10, scale=0.2)
    gp_ops = rbf_pallas.posterior_mean_operands(post)
    got = rbf_pallas.rbf_posterior_mean_pallas(gp_ops, Xq)
    torch.cuda.synchronize()
    want = rbf_pallas.rbf_posterior_mean_plain(gp_ops, Xq)
    k7_err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()):
        fail("K7 produced non-finite values")
    k7_fn = lambda: rbf_pallas.rbf_posterior_mean_pallas(gp_ops, Xq)
    k7_plain = lambda: rbf_pallas.rbf_posterior_mean_plain(gp_ops, Xq)
    k7 = dict(
        err=k7_err,
        ms=graph_ms(k7_fn, 20), plain_ms=graph_ms(k7_plain, 2, replays=3),
        host_ms=cuda_ms(k7_fn, 50), host_plain_ms=cuda_ms(k7_plain, 5, warmup=1),
        bound=bound_ms(nbytes(Xq, *gp_ops, got), ops_posterior_mean(mq, GP_POINTS)),
    )
    kernels["rbf_posterior_mean_pallas"] = k7
    print(f"K7 rbf_posterior_mean_pallas: max_abs_err {k7_err:.3e} on outputs up to "
          f"{float(want.abs().max()):.3f} ({mq} queries, P={GP_POINTS})")
    if not k7_err <= K7_TOL:
        fail(f"K7 disagrees with its plain version: {k7_err}")

    # ---- phase 3: fly every path ------------------------------------------
    def ref(t):
        p, y = ramped_figure8_reference(t, 6.0, 0.02)
        return p + torch.tensor([0.0, 0.0, 3.0], dtype=p.dtype, device=p.device), y

    def rms(outs):
        """Per-flight RMS position error: 0-d for one flight, (B,) for a sweep."""
        ref_pos, pos = outs["pos_ref"], outs["state"][..., 0:3]
        if pos.ndim == 3:
            ref_pos = ref_pos[:, None, :]
        return torch.sqrt(torch.mean(torch.sum((ref_pos - pos) ** 2, dim=-1), dim=0))

    def describe(r):
        if r.ndim == 0:
            return f"{float(r):.6f} m"
        return f"mean {float(r.mean()):.6f} m, max {float(r.max()):.6f} m over {r.numel()} flights"

    online_cfg = FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=K_TICKS)
    ogp = OnlineFusedGPConfig(gp=ResidualGPConfig(max_data_points=GP_POINTS), refit_every=250)

    def online(T, plain=False):
        return mpc_flight_rollout(mpc, ref, T, cfg=online_cfg, online_gp=ogp, gp_gain=0.1,
                                  device=dev, plain_kernels=plain)

    def check_path(label, fly, expected, bound, record=True):
        _cuda.reset_launch_counts()
        outs = fly(False)
        torch.cuda.synchronize()
        counts = dict(_cuda.launch_counts)
        plain = fly(True)
        torch.cuda.synchronize()
        for key, val in outs.items():
            if not torch.isfinite(val.float()).all():
                fail(f"{label}: non-finite {key}")
            if val.shape != plain[key].shape:
                fail(f"{label}: {key} shape {tuple(val.shape)} != {tuple(plain[key].shape)}")
        gap = float((outs["state"][..., 0:3] - plain["state"][..., 0:3]).abs().max())
        print(f"{label}: launches {counts}, figure-8 RMS {describe(rms(outs))} "
              f"(plain {describe(rms(plain))}), max position gap to plain {gap:.3e} m")
        for kernel, n in expected.items():
            if counts[kernel] != n:
                fail(f"{label}: {kernel} launched {counts[kernel]} times, expected {n}")
            if record:
                kernels[kernel]["launches"] = counts[kernel]
        if not gap <= bound:
            fail(f"{label}: position gap {gap} > {bound}")
        return outs, plain

    outs, plain = check_path(
        f"online GP-MPC figure-8 (N={HORIZON}, P={GP_POINTS}, K={K_TICKS}, {T_MAIN} ticks)",
        lambda p: online(T_MAIN, p), {"gpmpc_multitick_fused": T_MAIN // K_TICKS},
        ONLINE_GAP_BOUND_M,
    )
    print(f"  gp_count at refits (ticks 250, 500): kernel "
          f"{int(outs['gp_count'][249])}, {int(outs['gp_count'][-1])}; plain "
          f"{int(plain['gp_count'][249])}, {int(plain['gp_count'][-1])}")

    staged_mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ADMM_ITERS),
                           device=dev)
    check_path(
        "staged MPC flight, fused allocation + plant (100 ticks)",
        lambda p: mpc_flight_rollout(staged_mpc, ref, 100, body=RigidBodyParams(wind=wind),
                                     cfg=FlightLoopConfig(use_pallas_plant=True), device=dev,
                                     plain_kernels=p),
        {"allocation_plant_tick_fused": 100}, STAGED_GAP_BOUND_M,
    )
    check_path(
        "cascade-PID flight, fused plant (100 ticks)",
        lambda p: pid_flight_rollout(ref, 100, body=RigidBodyParams(wind=wind),
                                     cfg=FlightLoopConfig(use_pallas_plant=True), device=dev,
                                     plain_kernels=p),
        {"px4_plant_step_fused": 100}, STAGED_GAP_BOUND_M,
    )

    # the throughput sweep (bench.py:301-307): 1024 figure-8 flights from
    # x = linspace(-1, 1), z = 3, the GP fitted on the seeded synthetic set
    starts = torch.zeros(SWEEP_B, 12, **f32)
    starts[:, 2] = 3.0
    starts[:, 0] = torch.linspace(-1.0, 1.0, SWEEP_B, **f32)
    gp_kw = dict(gp_posterior=post, gp_cfg=ResidualGPConfig())

    def sweep(T, plain=False, **kw):
        return batched_mpc_flight_sweep(mpc, ref, T, starts, device=dev, plain_kernels=plain, **kw)

    sweep_label = f"throughput sweep (B={SWEEP_B}, N={HORIZON}, P={GP_POINTS}, {SWEEP_T} ticks"
    sweep_outs, sweep_plain = check_path(
        sweep_label + ")", lambda p: sweep(SWEEP_T, p, **gp_kw),
        {"gpmpc_controller_structured_batched": SWEEP_T, "rbf_posterior_mean_pallas": SWEEP_T,
         "allocation_plant_tick_fused": SWEEP_T},
        SWEEP_GAP_BOUND_M,
    )
    check_path(
        sweep_label + ", gp_every=5)", lambda p: sweep(SWEEP_T, p, gp_every=5, **gp_kw),
        {"gpmpc_controller_structured_batched": SWEEP_T, "rbf_posterior_mean_pallas": SWEEP_T // 5,
         "allocation_plant_tick_fused": SWEEP_T},
        SWEEP_GAP_BOUND_M, record=False,
    )
    # the kernels sum in a fixed order: the same sweep again, reduced by
    # parallel.structured_flight_sweep, is bit-identical
    agg = structured_flight_sweep(mpc, ref, SWEEP_T, starts, device=dev, **gp_kw)
    sweep_rms, sweep_rms_plain = rms(sweep_outs), rms(sweep_plain)
    print(f"  structured_flight_sweep: rms_mean {float(agg['rms_mean']):.6f} m, rms_max "
          f"{float(agg['rms_max']):.6f} m (plain sweep: rms_mean "
          f"{float(sweep_rms_plain.mean()):.6f} m, rms_max {float(sweep_rms_plain.max()):.6f} m)")
    if not torch.equal(agg["rms_per_flight"], sweep_rms):
        fail("a second kernel sweep differs from the first")

    # ---- phase 4: microseconds per online tick (slope of two lengths) ------
    def slope_us(plain, lengths):
        times = {}
        for T in lengths:
            online(T, plain)          # warm
            torch.cuda.synchronize()
            best = math.inf
            for _ in range(2):
                t0 = time.perf_counter()
                online(T, plain)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            times[T] = best
        a, b = lengths
        return (times[b] - times[a]) / (b - a) * 1e6

    us_kernel = slope_us(False, T_SLOPE)
    us_plain = slope_us(True, T_SLOPE_PLAIN)
    print(f"online tick: {us_kernel:.2f} us/tick through K5 (slope {T_SLOPE[0]}->{T_SLOPE[1]} "
          f"ticks), {us_plain:.2f} us/tick through the plain version "
          f"(slope {T_SLOPE_PLAIN[0]}->{T_SLOPE_PLAIN[1]}); card: {card}")

    def sweep_slope_us(**kw):
        """Microseconds per sweep tick, slope between the two lengths."""
        times = {}
        for T in T_SWEEP_SLOPE:
            sweep(T, **kw)          # warm
            torch.cuda.synchronize()
            best = math.inf
            for _ in range(2):
                t0 = time.perf_counter()
                sweep(T, **kw)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            times[T] = best
        a, b = T_SWEEP_SLOPE
        return (times[b] - times[a]) / (b - a) * 1e6

    gp_cfg = ResidualGPConfig()
    sweep_routes = {
        "gp_posterior, gp_every=1": dict(gp_kw),
        "gp_posterior, gp_every=5": dict(gp_kw, gp_every=5),
        "residual_fn (vmapped plain GP)": dict(
            residual_fn=lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gp_cfg)),
    }
    us_sweep_tick = {route: sweep_slope_us(**kw) for route, kw in sweep_routes.items()}
    us_flight_tick = {route: us / SWEEP_B for route, us in us_sweep_tick.items()}
    for route, us in us_sweep_tick.items():
        print(f"sweep ({route}): {us_flight_tick[route]:.5f} us per flight-tick, {us:.2f} us "
              f"per tick of {SWEEP_B} flights (slope {T_SWEEP_SLOPE[0]}->{T_SWEEP_SLOPE[1]} "
              f"ticks); card: {card}")
    device_tick_us = 1e3 * (k8["ms"] + k7["ms"] + k2["ms"])
    print(f"  device time per sweep tick at that width: K8 {k8['ms'] * 1e3:.2f} us, K7 "
          f"{k7['ms'] * 1e3:.2f} us, K2 {k2['ms'] * 1e3:.2f} us, together {device_tick_us:.2f} "
          f"us; K8 bound {k8['bound'][0] * 1e3:.2f} us, K7 bound {k7['bound'][0] * 1e3:.2f} us")
    # device time per sweep tick by kernel name, from a torch.profiler trace
    # of 50 ticks; against the unprofiled tick above it gives the idle share
    from torch.profiler import ProfilerActivity, profile

    sweep(50, **gp_kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sweep(50, **gp_kw)
        torch.cuda.synchronize()
    # device-side events only: a CPU op's entry repeats its kernels' time
    by_name = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(t for t, _ in by_name) / 50
    tick_us = us_sweep_tick["gp_posterior, gp_every=1"]
    print(f"  profiler, 50 sweep ticks (gp_every=1): device busy {busy_us:.2f} us per tick of "
          f"{tick_us:.2f} us, idle share {1.0 - busy_us / tick_us:.3f}; by kernel (us per tick): "
          + "; ".join(f"{name[:60]} {t / 50:.2f}" for t, name in by_name[:8]))
    k2_1 = k2["batch_1"]
    print(f"  K2 at batch 1 (staged flight): device {k2_1['ms'] * 1e3:.2f} us, plain "
          f"{k2_1['plain_ms'] * 1e3:.2f} us; with host overhead {k2_1['host_ms'] * 1e3:.2f} us, "
          f"plain {k2_1['host_plain_ms'] * 1e3:.2f} us; bound {k2_1['bound'][0] * 1e3:.6f} us")
    for name, k in kernels.items():
        print(f"  {name}: device {k['ms'] * 1e3:.2f} us per launch (CUDA graph), plain "
              f"{k['plain_ms'] * 1e3:.2f} us; with host overhead {k['host_ms'] * 1e3:.2f} us, "
              f"plain {k['host_plain_ms'] * 1e3:.2f} us; bound {k['bound'][0] * 1e3:.4f} us "
              f"({k['bound'][1]}); no single PyTorch call computes this function, so there "
              "is no library yardstick")

    # ---- phase 5: result lines --------------------------------------------
    meta = {
        "px4_plant_step_fused": ("plant_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/plant_pallas.py:377"),
        "allocation_plant_tick_fused": ("plant_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/plant_pallas.py:312"),
        "gpmpc_multitick_fused": ("tick_kernel.cu", "unmanned_aerial_vehicles_tpu/ops/tick_pallas.py:686"),
        "gpmpc_controller_structured_batched": (
            "controller_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/controller_pallas.py:449"),
        "rbf_posterior_mean_pallas": ("rbf_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/rbf_pallas.py:221"),
    }
    line = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/csrc/{meta[name][0]}",
            "replaces": meta[name][1],
            "launches": k["launches"],
            "max_abs_err": k["err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1],
            "library_ms": None,
        }
        for name, k in kernels.items()
    ], "us_per_online_tick": us_kernel, "us_per_online_tick_plain": us_plain,
        "fig8_rms_m_online_500": float(rms(outs)),
        "us_per_flight_tick_sweep_1024": us_flight_tick,
        "sweep_rms_mean_m": float(sweep_rms.mean()), "sweep_rms_max_m": float(sweep_rms.max()),
        "sweep_rms_mean_m_plain": float(sweep_rms_plain.mean())}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
