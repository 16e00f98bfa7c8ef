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
   lanes and every carry (tolerance 1e-4); time each kernel and its plain
   version alone: device time from CUDA events around a replayed CUDA
   graph of many calls, and time with the host's overhead, eagerly; time
   K5 also without its GP section and without its ADMM iterations;
3. fly every path of the slice through the user entry points with the
   launch counts set to 0 just before and read just after: the online GP-MPC
   figure-8 (the main path: K=20, P=800, N=20, 500 ticks, refit every 250;
   K5 must launch 25 times), a staged 100-tick flight with the fused
   allocation + plant (K2, 100 launches) and a cascade-PID flight with the
   fused plant (K1, 100 launches); each is held against the same flight
   through the plain versions on the card;
4. time microseconds per online tick as the slope between two flight
   lengths, for the kernel path and the plain path;
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
    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig, fit_residual_gp
    from unmanned_aerial_vehicles_tpu_torch.loop import (
        FlightLoopConfig,
        OnlineFusedGPConfig,
        mpc_flight_rollout,
        pid_flight_rollout,
    )
    from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, plant_pallas, tick_pallas
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
    s1, cmd1, int1 = s[:1].contiguous(), cmd[:1].contiguous(), integ[:1].contiguous()
    k2_fn = lambda: plant_pallas._allocation_plant_rows(s1, cmd1, int1, prow, 0.02, 2)
    k2_plain = lambda: plant_pallas.allocation_plant_tick_plain(s1, cmd1, int1, prow, 0.02, 2)
    k2 = dict(
        err=max(errs),
        ms=graph_ms(k2_fn, 200), plain_ms=graph_ms(k2_plain, 5),
        host_ms=cuda_ms(k2_fn, 500), host_plain_ms=cuda_ms(k2_plain, 20),
        bound=bound_ms(nbytes(s1, cmd1, int1, prow) + 4 * (12 + 7 + 3),
                       OPS_ALLOCATION + 2 * OPS_RK4_SUBSTEP),
    )
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

    # ---- phase 3: fly every path ------------------------------------------
    def ref(t):
        p, y = ramped_figure8_reference(t, 6.0, 0.02)
        return p + torch.tensor([0.0, 0.0, 3.0], dtype=p.dtype, device=p.device), y

    def rms(outs):
        err = outs["pos_ref"] - outs["state"][:, 0:3]
        return float(torch.sqrt(torch.mean(torch.sum(err**2, dim=-1))))

    online_cfg = FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=K_TICKS)
    ogp = OnlineFusedGPConfig(gp=ResidualGPConfig(max_data_points=GP_POINTS), refit_every=250)

    def online(T, plain=False):
        return mpc_flight_rollout(mpc, ref, T, cfg=online_cfg, online_gp=ogp, gp_gain=0.1,
                                  device=dev, plain_kernels=plain)

    def check_path(label, fly, kernel, expected, bound):
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
        gap = float((outs["state"][:, 0:3] - plain["state"][:, 0:3]).abs().max())
        print(f"{label}: launches {counts}, figure-8 RMS {rms(outs):.6f} m "
              f"(plain {rms(plain):.6f} m), max position gap to plain {gap:.3e} m")
        if counts[kernel] != expected:
            fail(f"{label}: {kernel} launched {counts[kernel]} times, expected {expected}")
        if not gap <= bound:
            fail(f"{label}: position gap {gap} > {bound}")
        kernels[kernel]["launches"] = counts[kernel]
        return outs, plain

    outs, plain = check_path(
        f"online GP-MPC figure-8 (N={HORIZON}, P={GP_POINTS}, K={K_TICKS}, {T_MAIN} ticks)",
        lambda p: online(T_MAIN, p), "gpmpc_multitick_fused", T_MAIN // K_TICKS,
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
        "allocation_plant_tick_fused", 100, STAGED_GAP_BOUND_M,
    )
    check_path(
        "cascade-PID flight, fused plant (100 ticks)",
        lambda p: pid_flight_rollout(ref, 100, body=RigidBodyParams(wind=wind),
                                     cfg=FlightLoopConfig(use_pallas_plant=True), device=dev,
                                     plain_kernels=p),
        "px4_plant_step_fused", 100, STAGED_GAP_BOUND_M,
    )

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
        "fig8_rms_m_online_500": rms(outs)}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
