#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernels from ``unmanned_aerial_vehicles_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once) and print the build time and register report;
2. hold every kernel against its plain PyTorch version on the card: K1 at
   B = 1, 17, 1024, 4096 and on a dispersed (256, 10) plant block (tolerance
   1e-5, a second launch bit-identical, timed at each) and K2 over the
   flight loops' batch of one and a batch of random states (tolerance
   1e-5), K5 for one launch at full width (N=20, P=800, K=20,
   10 ADMM iterations, GP fitted on the seeded synthetic set) on the packed
   lanes and every carry (tolerance 1e-4; a second launch bit-identical; its
   cycles per tick by section from the build with section clocks), K8 at the sweep's width
   (B=1024, N=20, 10 ADMM iterations, random planes; tolerance 1e-4 on all
   six outputs; a second launch bit-identical; again at N=25 with B=257,
   an odd horizon and a tail tile of one flight; its cycles per block by
   section from the build with section clocks), K7 at the sweep's width
   (20480 queries against the 800-point GP; tolerance 1e-5; a second launch
   bit-identical; its bound also on the units that do its work; its cycles
   per block by section from the build with section clocks; again at
   P=2000, 25600 queries and on a masked ring buffer), K4 at N=20
   (P1 in shared memory) and N=25 (P1 read through L2), also with a
   separate controller state, a tightening row and the hover fallback, K3
   at N=20 and N=25 (P1's factors' slices in registers at both), and K6 at
   N=20 and N=25 on P1's factors (as ``LinearMPC`` calls it) and on P1
   (without ``SuT``), K3 and K6 at N=30 (the factors through L2)
   (tolerance 1e-4 on every output, a second launch bit-identical;
   K4's, K3's and K6's cycles by section from the build with section clocks
   at both horizons; K3's and K6's bounds also in the P1 form), and
   ``LinearMPC.solve`` through
   K3 and K6 at both horizons in float32 and float64 against the same
   solves through the plain versions (1e-4); K9 over K5's operands in four
   configurations (the online-noisy filter, the observer with per-tick gust
   rows, ``relinearize_every="dispatch"``, the hover fallback engaged;
   tolerance 1e-4 on the packed lanes, the estimate, P and every carry, and
   a second launch bit-identical); K10 over random states around hover at
   n=1 and n=20 with wind and residuals, at the Euler-rate singularity and
   at n=150 (past the 64 steps it stages at a time) with and without
   residuals (tolerance 1e-5 of the state's size; a second launch
   bit-identical at each), and at n=15 (the iLQR engine's rollout), K11 for
   one launch per plant at
   full width (direct-rate N=20, rigid N=15, K=8, 30 iterations) on the
   port's own relinearisation at the circle task's start (5e-4 on every
   output, a second launch bit-identical, the layout of the ADMM operator's
   factors printed), and at N=25 where the factors are read through L2, with
   each section's share of a launch from the build with section clocks, K12 at
   512 x 25 and at K = 1, 17, 513, 2048 with N = 1, 7, 25 (1e-5 relative,
   a second launch bit-identical at each; its cycles per RK4 step and per
   derivative from the build with section clocks; a float64 MPPI
   controller's tick must launch it once), K5 with the variance section over a thread-block cluster
   (``tighten_kappa`` 2, 10 iterations, K=8 at N=20 with P=800, N=23 with
   P=800, N=20 with P=2000; 1e-4 of each output's and of each tick's
   back-off row's scale, a second launch bit-identical, in a case where the
   backed-off bound binds) and timed with K^-1 in the workers' shared
   memory and streamed, with 8 blocks, and without the section; the plant
   VJP kernels K13a and K13b
   against ``torch.func.vjp`` of K1's and K2's plain versions at B=1 and
   B=1024 (around hover with wind, a quarter at zero airspeed, a quarter
   of K13b's with every clamp binding; 1e-5 of each cotangent's scale, a
   second launch bit-identical; K13a's ``plant_vjp_lane_owned`` ablation
   timed beside it; K13b's cycles per state by phase from the
   ``plant_vjp_clocks`` build: forward allocation, plant forward, plant
   adjoint, allocation VJP); ``gpmpc_multitick_ad`` (K5 with its VJP
   rule) over two launches at N=20, P=800, K=20 and tightened at K=8:
   forward bit-identical to K5, weight gradient within 1e-4 of the plain
   route's; the last three kernels at the system's shapes, each with a
   second launch bit-identical: K14 (the explicit-inverse ADMM) on the
   staged MPC's own M^-1 and G at N=20 and N=25 (the register slices), N=30
   (the slices from shared memory) and N=40 (through L2) (80 iterations,
   rho 8, relaxation 1.6; 2e-5 of each output's scale) and on the JAX
   tests' QP padded to 128 lanes (300 iterations; the padded lanes exactly
   0), K15 (the RBF Gram) at the GP refit's 800 x 800 x 10 and the
   corpus's 19,800^2 x 10, isotropic and ARD (5e-5 of sigma^2 against the
   plain version, 2e-5 against float64 on rows holding the diagonal: see
   GRAM_TOL; the diagonal exactly sigma^2), at a ragged 801 x 257 and on
   coincident points (exactly sigma^2), K16 (the
   fused controller for a batch of flights, over thread-block clusters) at
   B = 1, 17, 256 and 257, N=20 and N=25, over three warm-started ticks
   (timed at B=256, with its cluster shape and the clusters the card runs
   at once), and K1
   and K2 on a dispersed (256, 10) plant block (2e-5 of scale); the
   population kernels at the campaign's 256 flights, each against its plain
   version (K4 at N=25 with 80 iterations and the fallback engaged on some
   flights, K5 at N=20, K=20, 80 iterations, K6 at N=25 on P1's factors:
   1e-4; K10 at n=1 and at n=20 with residuals, a body per member: 1e-5 of
   the state's size), every block bit-identical to a one-flight launch on
   its operands, a relaunch bit-identical, each timed at B = 1, 132 and 256
   with its bound at each; time each kernel and its plain
   version alone: device time from CUDA events around a replayed CUDA
   graph of many calls, and time with the host's overhead, eagerly; time
   K5 also without its GP section and without its ADMM iterations, K2 also
   at the sweep's batch of 1024, K4, K3, K6 also at N=25, and K10 also at
   n=20; with ``--parent DIR`` (DIR holding an older checkout's package),
   K4 at N=20 and N=25, K8 at B=1024, K3 and K6 (with and without ``SuT``)
   at N=20 and N=25, K16 at B=256, the tightened K5, K5 and K9 at the main
   path's shape (N=20, P=800, K=20), K11 at both plants, K7 at the sweep's
   width, K2 and K1 at B=1, on a dispersed (256, 10) plant block and at
   B=1024, K12 at 512 x 25, K13b at B=1 and 1024, K10 at n=1 and 20, K14
   at N=20, N=25 and on 128 lanes and K15 at 800^2 and 19,800^2 (and K2's,
   K1's, K12's, K13a's, K13b's, K10's, K14's and K15's outputs of both
   checkouts on the same inputs compared, K10's also on its checked
   rollouts; the machine code of the kernels this checkout keeps compared:
   ``SASS_KEPT``) and K13a at B=1 and
   1024 of that package and of this one, and the device-busy and idle
   shares of the staged flights through K3 and K6, of the sweep (with
   K8's, K7's and K2's device time per tick) and of the mppi12 flight
   (with K12's and K10's), timed in turns (older, this, this, older; each
   older run a subprocess that builds its own sources, K11's operands
   through its own ``dispatch_tick_operands``, K3's and K6's through its
   own ``LinearMPC``);
3. fly every path of the slices through the user entry points with the
   launch counts set to 0 just before and read just after: the online
   GP-MPC figure-8 (K=20, P=800, N=20, 500 ticks, refit every 250; K5 must
   launch 25 times), a staged 100-tick flight with the fused allocation +
   plant (K2, 100 launches), a cascade-PID flight with the fused plant (K1,
   100 launches), and the throughput sweep (1024 figure-8 flights, N=20,
   P=800, 100 ticks: K8, K7 and K2 100 launches each; again with
   ``gp_every=5``: K7 20 launches), the single-tick figure-8 with the
   800-point GP as ``residual_fn`` (N=20, 500 ticks: K4 500 launches;
   again with preview: 500), the frozen-GP multi-tick flight with preview
   (K=8, 400 ticks: K5 50 launches), and 100-tick staged flights with a
   ``use_fused_controller`` MPC (K3, 100 launches) and a ``use_fused_admm``
   MPC (K6, 100 launches), and the noisy tiers on one seeded sensor stream:
   the online-noisy figure-8 (the EKF in K9, 500 ticks: K9 must launch 25
   times, the ring buffer's count equal to the plain flight's), the 15-state
   observer with a gust at 5 s (K9 25 launches; its disturbance estimate
   must point into the wind), a 100-tick staged noisy flight (K3 and K1 100
   launches each) and a 100-tick single-tick noisy flight (K4 100
   launches); and the 12-state family on the circle task
   (``ramped_circle_reference``, 2 m, 3 m high, 50 Hz, 400 ticks): the
   direct-rate12 and mpc12 fused multi-tick tiers (K11 50 launches each),
   mpc12 through ``sqp_multitick_rollout`` (K10 400), the LTV obstacle flight
   at 10 Hz (K=2, 100 iterations, fallback, 200 ticks: K10 300) and the
   staged MPPI flight (K12 400, K10 400); the iLQR engine on the same task:
   the staged RK4 engine (N=15, 3 iterations, its rollouts and the plant
   step through K10: 150 launches in 30 ticks) and the K=2 policy tier (1
   iteration: K10 200 in 100 ticks), each RMS also within 5e-3 m of the
   JAX package's (``jax_reference_rms.py --ilqr``, JAX on the CPU); the
   12-state noisy loops on a seeded generator each: the staged RK4 iLQR
   engine on the rigid-body EKF's estimate (8 ticks: K10 40) and the LTV
   MPC at 10 Hz over the 100 Hz filter (4 control ticks: K10 40 truth
   steps); GP-variance tightening:
   ``bench.py``'s tightening mode (the frozen GP, kappa 2, K=8, 400 ticks:
   the tightened K5 50 launches), ``examples/09``'s online flight (wind,
   preview, fallback, P=256, refit every 250, K=8, 1000 ticks: 125
   launches, the ring buffer's count equal to the plain flight's), a
   100-tick staged flight tightened through ``uncertainty_fn`` and K6 (100
   launches), a 100-tick staged output-correction flight (K3 100 launches),
   and the online flight stopped at tick 496, saved, loaded and continued
   (bit-identical to the unbroken flight); each is held against the same
   flight through the plain versions on the card (1e-3 m; the LTV obstacle
   and MPPI flights, chaotic in float32, 5e-3 m over their first 30 ticks
   and their RMS within 8e-3 m and 2e-3 m over the whole flight); and
   the three auto-tuners: the cascade-PID tuner on the JAX CLI's task
   (circle 6 m, 1500 ticks, ``PID_CAMPAIGN_RATE_LOOP``, 3 iterations: K1
   7500 launches, K13a 4497: the last tick's new state enters no loss
   term, so its backward never runs), the fused MPC tuner (N=20, K=20, 200 ticks, 2
   iterations: K5 40) and the staged MPC tuner with the fused allocation +
   plant (N=25, 80 ADMM iterations, 200 ticks, 2 iterations: K2 800, K13b
   400); each must lower its loss, and at 60 ticks its loss trace must
   agree with the plain route's within 1e-3 relative; K14 and K15 once
   each at their own entry points (the staged MPC's QP at N=25, the
   800-point Gram); the Monte Carlo robustness study at the campaign's
   width (256 flights, 500 ticks of the campaign's 1500: ``MC_T``; the 6 m
   circle at 3 m, wind 0.8 m/s):
   the MPC population with ``use_fused_controller`` (N=25, 80 iterations)
   and ``use_pallas_plant`` (K16 500 launches, K2 500), the same with
   the 1.5 m hover fallback, and the PID population with
   ``PID_CAMPAIGN_RATE_LOOP`` (K1 500), each against its plain twin (equal
   success flags, per-flight RMS within 1e-3 m where both succeed), and two
   flights of the MPC population flown alone through K3 (within 1e-3 m of
   their population rows); the population tiers on the same draw and
   circle, 300 ticks each (``POP_T``, RMS after 100), against their plain
   twins alike: the fused single-tick population
   (N=25, 80 iterations: K4 300 launches), the multi-tick one (N=20, K=20:
   K5 15), ``use_fused_admm`` with the fused plant (K6 300, K2 300), the
   fused single-tick one with the 1.5 m fallback (K4 300), and
   ``monte_carlo_mpc12`` (64 X500 members on their own bodies, 200 ticks:
   K10 200); the polished population (16 flights, 50 ticks, no kernel)
   must fly finite; the orchestration tier (``run_orchestration``) against
   its plain twins: the mission at the CLI's settings (``mission_rollout``,
   K3 at N=25 with 80 iterations and K1, the figure-8 at amplitude 6 over
   the take-off height, 24 s: all five phases, K3 and K1 1200 launches
   each, the trajectory phase's RMS gap within 1e-3 m), the noisy mission
   with the disturbance observer under a steady (1.5, 0.8, 0) m/s wind on
   one seeded draw (22 s, 1100 ticks; the estimate must point into the
   wind),
   the online learner (``online_gp_mpc_rollout``, the CLI's 400-point ring
   refitted every 250 ticks, 600 ticks: K3 and K1 600 each, two refits, the
   sample counts equal), ``RK4DemoMPC`` tracking a moving reference for 200
   solves (K14 200 launches at n=30, m=90, the states within 1e-4 m; K14
   timed there against its plain version and its bound), and, with no
   kernel, ten ticks of the attitude MPC's hover and the comparison
   harness's winner table; the full-corpus GP and the sharded sweeps
   (``run_distributed``, a world of one): a seeded 19,816 x 10 float32
   corpus fitted by ``fit_residual_gp_sharded`` through K15 and its plain
   twin (posterior means within 1e-3 of y_std), a 4000-row fit against a
   dense float64 Cholesky fit (5e-3 of y_std) and through a one-rank NCCL
   group (bit for bit), ``predict_sharded`` and ``lml_grad_sharded``
   against the plain route (1e-3), three Adam steps and the per-dimension
   fit finite, one fit under ``torch.profiler`` (K15's and the products'
   shares), ``sharded_structured_flight_sweep`` (K8, K7, K2: 100 launches
   each) and ``sharded_flight_sweep`` (K5: 40) equal bit for bit to their
   one-card runs, and ``utils.profiling.scan_slope_timeit`` within 10% of
   ``graph_ms`` on K15 at the corpus; the block must take at most 60 s;
   the command line and the examples (``run_surface``): the seeded corpus
   written as CSVs, 21 commands through ``cli.main`` on the default device
   at the CLI's widths cut in length (every ``fly`` controller, ``mission``,
   ``online``, ``compare``, ``sweep``, both tuners, ``montecarlo``,
   ``train-gp`` dense and ``--all-samples``, ``evaluate-gp``, ``analyze``),
   each held to its bar from the JAX package's ``tests/test_cli.py``, each
   expected to launch its kernels (every launch recorded by path), the
   online flight's JSON equal to the same ``mpc_flight_rollout`` called
   directly, then ``python -m unmanned_aerial_vehicles_tpu_torch fly`` in a
   process of its own and the 15 ``examples_torch/`` scripts with
   ``UAV_FAST_EXAMPLES=1`` through ``runpy`` in five worker processes
   (``--run-examples``), and beside them ``fly mpc12`` and ``tune mpc``
   (flown shorter than their bars need) again with ``--device cpu``, held
   to the card's JSON; the block must take at most 90 s; the experiment
   campaign (``run_campaign_block``): ``tools_torch/run_campaign.py``'s
   ``main`` at ``--duration 4`` (200 ticks) on the seeded corpus's CSVs,
   the tuner 2 iterations of 2 s, the populations 2 s, the settle windows
   0.5 s: all 29 rows present and finite, K1, K2, K3, K4, K5, K9, K13a and
   K16 launched, K4 200 times, all by the oracle row; the staged
   ``mpc_flight_figure8`` and the oracle row within 1e-3 m of their plain
   twins, the fresh online row (K5) and the fused observer row (K9) within
   1e-3 m; the block must take at most 60 s;
4. time microseconds per online tick, per online-noisy tick, per
   single-tick tick and per tightened tick (``bench.py``'s tightening mode)
   as the slope between two flight lengths, for the kernel path and the
   plain path (the single-tick tick also without its GP), the device's
   busy time and idle share from ``torch.profiler`` windows (sweep,
   single-tick, online-noisy, tightened), and microseconds per
   flight-tick of the 1024-flight sweep as the
   slope between 200 and 700 ticks (``gp_posterior`` with ``gp_every`` 1
   and 5, and ``residual_fn``), and the device's busy time per sweep tick
   by kernel from a ``torch.profiler`` window of 50 ticks; microseconds per
   tick of the direct-rate12 fused, mpc12 fused and mppi12 flights as the
   slope between 200 and 1000 ticks (the plain versions at shorter
   lengths), with profiler windows of the first and the last;
   microseconds per tick of the staged iLQR engine (slope 4->12 ticks) and
   of its K=2 policy tier (20->60), with profiler windows of each and the
   host time of an iteration's parts; and the
   seconds of one tuning iteration of each tuner, forward and backward,
   for both routes at 60 ticks and the cascade-PID tuner's kernel route at
   its width; microseconds per Monte Carlo flight-tick (the MPC
   population's slope between 300 and 1500 ticks, over 256) and its
   device-busy share; the same for the fused single-tick, multi-tick and
   ``use_fused_admm`` populations (slope between 100 and 500 ticks, a
   profiler window of 60); the multi-start cascade-PID tuner (8 starts, 300
   ticks, 2 iterations) as one batch against its starts one after another
   (host wall clock of each; the best start equal, the final losses within
   1e-5 relative);
5. print the kernels' JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits 2 without one, or when run outside a checkout of
the repository.

    python3 chip_smoke.py --run-examples GLOB CLAIMS   # the block's example worker
    python3 chip_smoke.py --write-corpus DIR   # the seeded corpus as CSVs, for
                                               # tools_torch/run_campaign.py --gp-data 'DIR/*.csv'
    python3 chip_smoke.py --parent DIR   # also time an older checkout's K4, K8, K3, K6, K16,
                                         # K5, K9, K11, K7, K2, K13a, K1, K12, K13b, K10,
                                         # K14 and K15 and its
                                         # staged flights', sweep's and mppi12 flight's
                                         # device-busy shares in turns with this one's,
                                         # and its sweep, single-tick, online and mppi12
                                         # ticks in E2E_PAIRS pairs
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
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
T_SLOPE_PLAIN = (40, 160)     # plain path (hundreds of small launches per tick; multiples of K=20)
T_SLOPE_TIGHT_PLAIN = (48, 152)    # the same at K=8 (lengths a multiple of K)

SWEEP_B, SWEEP_T = 1024, 100  # the throughput sweep (bench.py:301-307)
T_SWEEP_SLOPE = (200, 700)    # bench.py:301
K8_TOL = 1e-4
K7_TOL = 1e-5
SWEEP_GAP_BOUND_M = 1e-3      # kernel vs plain sweep, max over all flights

SINGLE_TOL = 1e-4             # K4, K3, K6 against their plain versions
SINGLE_GAP_BOUND_M = 1e-3     # kernel vs plain flight: single-tick, preview, K3/K6 staged
LONG_HORIZON = 25             # the package default: P1 read through L2
L2_FACTOR_HORIZON = 30        # K3's and K6's factors read through L2
K5_PREVIEW_K, K5_PREVIEW_T = 8, 400   # bench.py's frozen-GP preview flight

TIGHTEN_KAPPA = 2.0           # bench.py:262-270's tightening mode and examples/09
TIGHT_T = 400                 # the tightened frozen-GP flight (bench.py's mode)
ONLINE09_T, ONLINE09_P = 1000, 256   # examples/09's online flight, shortened
RESUME_AT = 496               # a launch boundary of the K=8 online flight

K9_TOL = 1e-4                 # K9 against its plain version
NOISY_GAP_BOUND_M = 1e-3      # kernel vs plain noisy flights
NOISY_SHORT_T = 100           # the staged and single-tick noisy flights
GUST_T_S = 5.0                # the observer flight's wind step


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


def slope_us(fly, lengths, reps=2, warm_T=None):
    """Microseconds per tick of ``fly(T)``: the slope of the best of
    ``reps`` host wall clocks between the two lengths, each ended by
    ``torch.cuda.synchronize()``. Warm at each length, or once at
    ``warm_T`` ticks."""
    import torch

    if warm_T is not None:
        fly(warm_T)
    times = {}
    for T in lengths:
        if warm_T is None:
            fly(T)
        torch.cuda.synchronize()
        best = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            fly(T)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        times[T] = best
    a, b = lengths
    return (times[b] - times[a]) / (b - a) * 1e6


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
OPS_JACOBIAN = 120


def ops_structured_controller(N: int, iterations: int, nx: int = 6) -> int:
    """FP32 operations of one K8 flight-tick (an FMA counts 2), read off
    csrc/controller_kernels.cu."""
    Nnu, Nnx = 4 * N, 6 * N
    setup = 2 * (nx + Nnx) * Nnx + 4 * Nnx + 2 * Nnx * Nnu + 2 * (Nnu + Nnx)
    phase_t = Nnu * (2 * Nnx + 2)
    iteration = phase_t + Nnu * (2 * Nnu + 12) + Nnx * (2 * Nnu + 12)
    final = phase_t + 2 * Nnu * Nnu + Nnx * (2 * Nnu + 1)
    return setup + iterations * iteration + final


def ops_admm(m: int, n: int, iterations: int, factored: bool = False) -> int:
    """FP32 operations of K6 (csrc/single_tick_kernels.cu): per iteration
    and constraint row ~12 for the relaxation, clip and dual update, and the
    product with P1 (an m-term dot per row) or, ``factored``, with its two
    factors for G = [I; Su] (t = v GM^-1: n m-term dots; t Su': m - n
    n-term dots); then the primal recovery (n m-term dots)."""
    step = 2 * n * m + 2 * n * (m - n) if factored else 2 * m * m
    return iterations * (step + 12 * m) + 2 * n * m + n


def ops_controller(N: int, iterations: int, factored: bool = False) -> int:
    """FP32 operations of the condensed solve of K3 (``factored``: its ADMM
    on P1's factors), K4 and K16 (on P1): offset, gradient, bounds, p0 and
    M^-1 f, the ADMM loop, U and X_tail."""
    Nnu, Nnx, m = 4 * N, 6 * N, 10 * N
    return (2 * (6 + Nnx) * Nnx + Nnx + 2 * Nnx * Nnu + 3 * m + 2 * Nnu * (m + Nnu)
            + ops_admm(m, Nnu, iterations, factored) + 2 * Nnu * Nnx + Nnx)


def ops_posterior_mean(m: int, P: int, d: int = 10, out: int = 6) -> int:
    """FP32 operations of K7 (csrc/rbf_kernels.cu): per (query, training
    point) pair the d-term dot, the distance (4), the scale and expf (2) and
    the out accumulations; per query its features, norm and offset."""
    return m * P * (2 * d + 4 + 2 + 2 * out) + m * (3 * d + out)


PEAK_TF32_OPS_PER_S = 495e12   # the tensor cores, dense TF32
PEAK_SM_CLOCK_HZ = 1.98e9      # 67 TFLOP/s = 132 SMs x 128 lanes x 2 x 1.98 GHz
SFU_PER_CLOCK_PER_SM = 16      # ex2 and the other special functions


def bound_posterior_mean_units(m: int, P: int, n_bytes: int, sms: int, d: int = 10,
                               out: int = 6):
    """K7's bound: its work (``ops_posterior_mean``'s count) on the units
    that can do it, side by side: the two products (2 d + 2 out operations
    a pair) at the TF32 tensor rate, tripled for 3xTF32; the exps at the
    SFU's 16 a clock per SM; the rest of a pair's elementwise work (the
    distance's four operations with the clamp, the scale) and the queries'
    set-up on the FP32 pipe; the bytes. Returns the slowest unit's time
    (ms), its kind and its name: ``(ms, "bytes" or "operations", unit)``.
    The FP32 form (``bound_ms`` of ``ops_posterior_mean``) is kept beside
    it."""
    times = {
        "tensor cores, 3xTF32": 3 * m * P * (2 * d + 2 * out) / PEAK_TF32_OPS_PER_S,
        "SFU exps": m * P / (sms * SFU_PER_CLOCK_PER_SM * PEAK_SM_CLOCK_HZ),
        "FP32 pipe": (5 * m * P + m * (3 * d + out)) / PEAK_F32_OPS_PER_S,
        "bytes": n_bytes / PEAK_BYTES_PER_S,
    }
    unit = max(times, key=times.get)
    return times[unit] * 1e3, "bytes" if unit == "bytes" else "operations", unit


def ops_filter(n: int, relinearize_per_tick: bool = True) -> int:
    """FP32 operations of one tick of K9's filter (csrc/noisy_tick_kernel.cu,
    an FMA counts 2) at n = 12 or 15 states: the RK4 prediction, the four
    stage Jacobians, the chain K2..K4 and Fd (per tick, or once per launch
    with ``relinearize_per_tick`` False), the propagation of P and the 9
    scalar fusions."""
    fd = 4 * OPS_JACOBIAN + 3 * 144 * (2 * 12 + 2) + 144 * 7 + (n * n if n > 12 else 0)
    propagate = n * n * 2 * n + n * n * (2 * n + 4)
    fuse = 9 * (2 * n * n + 3 * n + 6)
    return OPS_RK4_SUBSTEP + (fd if relinearize_per_tick else 0) + propagate + fuse + 3


def check_k9(dev, mpc, gp, gen, x0, xtail, z0, y0, refs, yaw, prow, statics, k5_ops, fail_fn):
    """Hold K9 against its plain version on the card in four
    configurations (online-noisy operands; the observer with per-tick gust
    rows; relinearize_every "dispatch"; the hover fallback engaged), over
    K5's full-width operands (N=20, P=800, K=20), and time the first.
    Returns the kernel's record for the JSON line."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.estimation import DisturbanceEKFConfig, EKFConfig
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, tick_pallas

    f32 = dict(dtype=torch.float32, device=dev)
    K, N = statics["k_ticks"], statics["n"]
    ekf, dob = EKFConfig(), DisturbanceEKFConfig()
    rnd = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(**f32)
    r9 = ekf.r_diag(dev)
    noise = (torch.sqrt(r9) * rnd(K, 9)).contiguous()
    est12 = (x0 + rnd(12, scale=0.02)).contiguous()
    A = rnd(15, 15, scale=0.02)
    P15 = (torch.diag(dob.p0_diag(dev)) + A @ A.T).contiguous()
    aux = torch.cat([est12[:6] + 0.01, torch.tensor([0.02, -0.01, 0.03, 1.02, 0.1, -0.05, 0.03],
                                                    **f32)]).contiguous()
    gust = torch.stack([torch.cat([prow[:7], torch.tensor([0.8 + 0.05 * k, 0.4 - 0.03 * k, 0.1],
                                                          **f32)]) for k in range(K)])
    nominal = torch.cat([prow[:7], torch.zeros(3, **f32)]).contiguous()
    # the fallback case: every tick's reference 0.5 m from the estimate
    ref_fb = torch.cat([est12[:3] + torch.tensor([0.5, 0.0, 0.0], **f32), torch.zeros(3, **f32)])
    refs_fb = ref_fb.repeat(K, N).contiguous()
    observer = dict(use_dob=True, nominal_row=nominal, bdist=tick_pallas.build_dob_bdist(0.02, dev))
    base = dict(est=est12, P=P15[:12, :12].contiguous(), rows=prow[None], q=ekf.q_diag(dev),
                refs=refs, kw={})
    cases = {
        "online-noisy": base,
        "observer, per-tick gust rows": dict(
            base, est=torch.cat([est12, torch.tensor([0.4, -0.2, 0.1], **f32)]), P=P15,
            rows=gust.contiguous(), q=dob.q_diag(dev), kw=observer),
        "relinearize_every=dispatch": dict(base, kw=dict(relinearize_per_tick=False)),
        "fallback engaged": dict(base, refs=refs_fb, kw=dict(fallback_error_m=0.3)),
    }
    errs = {}
    for label, c in cases.items():
        args = (mpc._tick_data, gp, x0, c["est"], c["P"], aux, xtail, z0, y0, c["refs"], yaw,
                noise, c["rows"], c["q"], r9)
        kw = dict(statics, **c["kw"])
        got = tick_pallas.gpmpc_noisy_multitick_fused(*args, **kw)
        torch.cuda.synchronize()
        want = tick_pallas.noisy_multitick_staged(*args, **kw)
        if not all(bool(torch.isfinite(g).all()) for g in got):
            fail_fn(f"K9 ({label}) produced non-finite values")
        errs[label] = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if label == "fallback engaged":
            lo, hi = (torch.tensor(v, **f32) for v in (statics["accel_lo"], statics["accel_hi"]))
            mpc_cmd = torch.minimum(torch.maximum(want[0][0, 25:28], lo), hi)
            if not float((want[0][0, 22:25] - mpc_cmd).abs().max()) > 1e-3:
                fail_fn("K9's fallback case did not engage the hover fallback")
        if label == "online-noisy":
            main_args, main_out = args, got
        again = tick_pallas.gpmpc_noisy_multitick_fused(*args, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail_fn(f"K9 ({label}): a second launch on the same inputs differs")
    print("K9 gpmpc_noisy_multitick_fused: max_abs_err against the plain version over the "
          f"packed lanes 0:47, the estimate, P and the carries (N={N}, K={K}): "
          + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; shared memory {tick_pallas.noisy_shared_memory_bytes(N)} B")
    for label, err in errs.items():
        if not err <= K9_TOL:
            fail_fn(f"K9 ({label}) disagrees with its plain version: {err}")
    fn = lambda: tick_pallas.gpmpc_noisy_multitick_fused(*main_args, **statics)
    plain = lambda: tick_pallas.noisy_multitick_staged(*main_args, **statics)
    data = mpc._tick_data
    n_bytes = (nbytes(data.SxSwT, data.SuTqT, data.PM, data.P1, data.P0matT, data.SuT,
                      data.lo_row, data.hi_row, *gp, *main_args[2:])
               + nbytes(*main_out))
    # where K9's time goes: the same launch without the GP section (the
    # filter then runs beside idle warps), and with one Fd per launch
    variants = {
        what: graph_ms(lambda: tick_pallas.gpmpc_noisy_multitick_fused(
            *main_args, **{**statics, **change}), 20)
        for what, change in (("without the GP", {"use_gp": False}),
                             ("relinearize_every=dispatch", {"relinearize_per_tick": False}))
    }
    # cycles per tick by section, from the build with section clocks (the
    # solve, then warp 0's scalar section, the filter warp's four steps and
    # the GP warps side by side)
    with _cuda.library_variant("noisy_tick", "noisy_tick_clocks"):
        tick_pallas.noisy_section_cycles()
        fn()
        torch.cuda.synchronize()
        sections = {k: v / K for k, v in tick_pallas.noisy_section_cycles().items()}
    return dict(err=max(errs.values()), errs=errs, variants=variants, sections=sections,
                ms=graph_ms(fn, 20), plain_ms=graph_ms(plain, 1, replays=3),
                host_ms=cuda_ms(fn, 50), host_plain_ms=cuda_ms(plain, 3, warmup=1),
                bound=bound_ms(n_bytes, k5_ops + K * ops_filter(12)),
                filter_ops_per_tick=ops_filter(12))


def ops_tightening(N: int, P: int) -> int:
    """FP32 operations of K5's variance section per tick: the quadratic form
    K* K^-1 K*' (2 N P^2 + 2 N P, the same work whatever form computes it),
    the variance row (6 per stage row), the SwSqT matvec (2 Nnx^2) and the
    back-off (5 per state row)."""
    Nnx = 6 * N
    return 2 * N * P * P + 2 * N * P + 6 * Nnx + 2 * Nnx * Nnx + 5 * Nnx


# (N, P): the tightening mode's width; N=23; P=2000, whose triangle shares
# do not fit the workers' shared memory (K^-1 streamed from L2)
TIGHT_CASES = ((20, 800), (23, 800), (20, 2000))


def tightened_case(dev, mpc, post, prow, K: int):
    """Operands of the tightened K5's check launch at the MPC's horizon:
    flying at 7.9 m/s into the 8 m/s box toward a 9 m/s reference, so the
    backed-off bound binds (kappa 2, 10 ADMM iterations)."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.ops import tick_pallas

    f32 = dict(dtype=torch.float32, device=dev)
    N, m = mpc.config.horizon, mpc.n_constraints
    gp = tick_pallas.build_gp_rows(post, 0.1, with_variance=True)
    x0 = torch.zeros(12, **f32)
    x0[:6] = torch.tensor([0.2, -0.1, 2.9, 7.9, 0.3, -0.1])
    aux = torch.cat([x0[:6], torch.zeros(3, **f32)]).contiguous()
    refs = torch.tensor([3.0, 0.0, 3.0, 9.0, 0.0, 0.0], **f32).repeat(K, N).contiguous()
    args = (mpc._tick_data, gp, x0, aux, x0[:6].repeat(N).contiguous(), torch.zeros(m, **f32),
            torch.zeros(m, **f32), refs, torch.zeros(K, **f32), prow)
    statics = dict(k_ticks=K, use_gp=True, rho=8.0, iterations=ADMM_ITERS, over_relax=1.6,
                   dt=0.02, substeps=2, accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0),
                   yawrate_limit=0.8, n=N, nu=4, nx=6, tighten_kappa=TIGHTEN_KAPPA,
                   loop_precision="highest", fallback_error_m=0.0, fallback_thrust_ceiling=1.5,
                   fallback_accel_scale=1.5)
    return args, statics


def plain_tight_rows(args, statics):
    """Each tick's back-off row through the plain version: ``tightening_row``
    on that tick's cross-kernel (the features of the previous solution, as
    ``multitick_staged`` forms them), then ``multitick_staged`` one tick on."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.ops import tick_pallas

    data, gp, state, aux, xtail, z, y, refs, yaw, prow = args
    N, nu, nx = statics["n"], statics["nu"], statics["nx"]
    rows = []
    for t in range(statics["k_ticks"]):
        Xs = torch.cat([aux[None, :nx], xtail[: (N - 1) * nx].reshape(N - 1, nx)], dim=0)
        Zf = torch.cat([Xs, z[: N * nu].reshape(N, nu)], dim=1) * gp.inv_ls[0] - gp.inv_ls[1]
        sq1 = torch.sum(Zf * Zf, dim=1, keepdim=True)
        dists = torch.clamp(sq1 + gp.sq2[None, :] - 2.0 * (Zf @ gp.ztrT), min=0.0)
        rows.append(tick_pallas.tightening_row(data, gp, gp.scal[0] * torch.exp(-0.5 * dists),
                                               statics["tighten_kappa"]))
        _, state, aux, xtail, z, y = tick_pallas.multitick_staged(
            data, gp, state, aux, xtail, z, y, refs[t:t + 1], yaw[t:t + 1], prow,
            **dict(statics, k_ticks=1))
    return torch.stack(rows)


def check_tightened_k5(dev, mpc, post, prow, k5_tick_ops, fail_fn):
    """Hold K5's tightened variant (a cluster of VAR_CLUSTER blocks a
    flight) against its plain version on the card, on the packed lanes,
    every carry and each tick's back-off row, at bench.py's tightening
    width (N=20, P=800, K=8, 10 iterations, kappa 2) in a case where the
    back-off binds, at N=23 and at P=1000 (K^-1 streamed from L2); launch
    each twice (bit-identical); time it, with K^-1 in the workers' shared
    memory and streamed, next to the same launch without the variance
    section. Returns the kernel's record for the JSON line."""
    import numpy as np
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig, fit_residual_gp
    from unmanned_aerial_vehicles_tpu_torch.ops import tick_pallas

    f32 = dict(dtype=torch.float32, device=dev)
    K = K5_PREVIEW_K
    posts = {GP_POINTS: post}
    recs = {}
    for N, P in TIGHT_CASES:
        if P not in posts:
            rng = np.random.default_rng(P)
            posts[P] = fit_residual_gp(torch.tensor(rng.normal(size=(P, 10)), **f32),
                                       torch.tensor(0.05 * rng.normal(size=(P, 6)), **f32),
                                       ResidualGPConfig(max_data_points=P))
        case_mpc = mpc if N == mpc.config.horizon else LinearMPC(
            LinearMPCConfig(horizon=N, admm_iterations=ADMM_ITERS, use_fused_controller=True),
            device=dev)
        args, statics = tightened_case(dev, case_mpc, posts[P], prow, K)
        m = case_mpc.n_constraints
        got = tick_pallas.gpmpc_multitick_fused(*args, **statics)
        torch.cuda.synchronize()
        want = tick_pallas.multitick_staged(*args, **statics)
        loose = tick_pallas.multitick_staged(*args, **dict(statics, tighten_kappa=0.0))
        tight = torch.empty(K, m, **f32)
        again = tick_pallas._launch_multitick(args[0], args[1], args[2:], statics, True,
                                              tight_out=tight)
        cluster, shared, smem = tick_pallas.variance_cluster(dev, N, P)
        variants = {"shared" if shared else "streamed": got}
        if shared:   # the same launch with K^-1 streamed from L2
            variants["streamed"] = tick_pallas._launch_multitick(args[0], args[1], args[2:],
                                                                 statics, True, kinv_shared=False)
        torch.cuda.synchronize()
        tight_want = plain_tight_rows(args, statics)
        for g in got:
            if not torch.isfinite(g).all():
                fail_fn(f"tightened K5 (N={N}, P={P}) produced non-finite values")
        errs = [float((g - w).abs().max()) for g, w in zip((*got, tight), (*want, tight_want))]
        scales = [max(1.0, float(w.abs().max())) for w in (*want, tight_want)]
        bind = float((want[0][:, 25:29] - loose[0][:, 25:29]).abs().max())
        same = {name: all(torch.equal(a, b) for a, b in zip(out, again))
                for name, out in variants.items()}
        print(f"K5 tightened (gpmpc_multitick_fused, tighten_kappa {TIGHTEN_KAPPA}, N={N}, P={P}, "
              f"K={K}; a cluster of {cluster} blocks, K^-1 {next(iter(variants))} in the "
              "workers): max_abs_err against the plain "
              "version per output (packed, state, aux, xtail, z, y, back-off rows): "
              + ", ".join(f"{e:.3e}" for e in errs)
              + f" (output scales {', '.join(f'{v:.1f}' for v in scales)}); the back-off moves "
              f"u_mpc by {bind:.3e} against kappa 0; bit-identical to a second launch "
              + ", ".join(f"{k} {v}" for k, v in same.items())
              + f"; shared memory {tick_pallas.shared_memory_bytes(N, tighten=True)} B (rank 0), "
              f"{smem} B a block")
        if not all(e <= TICK_TOL * sc for e, sc in zip(errs, scales)):
            fail_fn(f"tightened K5 (N={N}, P={P}) disagrees with its plain version: {errs}")
        if not all(same.values()):
            fail_fn(f"tightened K5 (N={N}, P={P}): a second launch on the same inputs differs")
        if not bind > 1e-3:
            fail_fn(f"tightened K5's check case (N={N}, P={P}) does not bind ({bind})")
        recs[(N, P)] = dict(args=args, statics=statics, err=max(errs))
    N, P = TIGHT_CASES[0]
    args, statics = recs[(N, P)]["args"], recs[(N, P)]["statics"]
    fn = lambda: tick_pallas.gpmpc_multitick_fused(*args, **statics)
    streamed = lambda: tick_pallas._launch_multitick(args[0], args[1], args[2:], statics, True,
                                                     kinv_shared=False)
    cluster, _, _ = tick_pallas.variance_cluster(dev, N, P)
    portable = lambda: tick_pallas._launch_multitick(args[0], args[1], args[2:], statics, True,
                                                     cluster=tick_pallas.VAR_CLUSTER)
    plain = lambda: tick_pallas.multitick_staged(*args, **statics)
    untightened = graph_ms(lambda: tick_pallas.gpmpc_multitick_fused(
        *args, **dict(statics, tighten_kappa=0.0)), 20)
    data, gp = args[0], args[1]
    n_bytes = (nbytes(data.SxSwT, data.SuTqT, data.PM, data.P1, data.P0matT, data.SuT,
                      data.lo_row, data.hi_row, data.SwSqT, *gp, *args[2:])
               + nbytes(*fn()))
    rec = dict(err=max(r["err"] for r in recs.values()), ms=graph_ms(fn, 20),
               streamed_ms=graph_ms(streamed, 20), cluster=cluster,
               portable_ms=graph_ms(portable, 20), plain_ms=graph_ms(plain, 1, replays=3),
               host_ms=cuda_ms(fn, 50), host_plain_ms=cuda_ms(plain, 3, warmup=1),
               bound=bound_ms(n_bytes, K * (k5_tick_ops + ops_tightening(N, P))),
               untightened_ms=untightened)
    section = lambda ms: (ms - untightened) * 1e3 / K
    print(f"K5 tightened device time per launch (N={N}, P={P}, K={K}), a cluster of {cluster} "
          f"blocks: {rec['ms'] * 1e3:.2f} us with K^-1 in the workers' shared memory (the section "
          f"{section(rec['ms']):.2f} us per tick), {rec['streamed_ms'] * 1e3:.2f} us streamed from "
          f"L2 (the section {section(rec['streamed_ms']):.2f} us per tick); with "
          f"{tick_pallas.VAR_CLUSTER} blocks {rec['portable_ms'] * 1e3:.2f} us (the section "
          f"{section(rec['portable_ms']):.2f} us per tick); the same launch without the "
          f"variance section {untightened * 1e3:.2f} us ({untightened * 1e3 / K:.2f} us per "
          f"tick); plain {rec['plain_ms'] * 1e3:.2f} us; bound {rec['bound'][0] * 1e3:.4f} us "
          f"({rec['bound'][1]}; {ops_tightening(N, P)} operations per tick in the section)")
    return rec


# ---- the 12-state SQP and MPPI family (K10, K11, K12) ----------------------

RIGID_PLANT_TOL = 1e-5        # K10 against its plain version, relative to the state's size
# K11 against its plain version on out, x, z and y. Measured on the H100 at
# the direct-rate width (8 ticks of 30 iterations): 2.0e-5 on the controls,
# 1.6e-4 on the equilibrated slack. The plain version's own float32 and
# float64 runs differ by as much on the same operands (4.9e-5 on the slack
# over 4 ticks, tests/test_torch_rigid_tick.py): each iteration's 320-term
# sums round in another order, and the ADMM carries the rounding on
K11_TOL = 5e-4
K12_RTOL = 1e-5               # K12's costs against its plain version, relative
SQP_GAP_BOUND_M = 1e-3        # kernel vs plain 12-state SQP flights
# Two flights are chaotic in float32, so each is held over its first 30
# ticks, and over the whole flight by its RMS gap to the plain twin (and
# both LTV flights clear the obstacle), each bound a little above what the
# H100 gave (the kernels and the plain versions are deterministic: every
# run gave the same readings):
# - MPPI: its update is a softmax over the K costs at temperature 0.3, so a
#   cost that rounds differently by 1e-7 of ~5000 moves its weight by
#   ~0.2%. On the CPU, costs perturbed by 2e-7 (relative, random) move the
#   flight by 2.2e-4 m within 30 ticks, 3.7e-2 m over 400 and its RMS by
#   4.0e-3 m. On the H100: 1.42e-3 m within 30 ticks, 4.6e-2 m over 400,
#   RMS gap 2.16e-4 m.
# - The LTV obstacle flight: the rows' normals follow the warm plan and the
#   100-iteration ADMM does not converge on the active rows. On the CPU its
#   plain version started 1e-6 m apart parts by 1.6e-4 m within 10 ticks,
#   6.5e-4 m within 30 and 0.175 m over 200. On the H100: 1.94e-3 m within
#   30 ticks, 9.6e-2 m over 200, RMS gap 5.78e-3 m.
CHAOTIC_GAP_TICKS = 30
CHAOTIC_BOUNDS_M = {           # (gap over the first 30 ticks, RMS gap)
    "ltv12_obstacle": (5e-3, 8e-3),
    "mppi12": (5e-3, 2e-3),
}
CIRCLE_T = 400                # the circle task (bench_controllers.py:61), 2 m, 3 m high, 50 Hz
LTV_T = 200                   # the obstacle flight at 10 Hz (bench_controllers.py:449-512)
LTV_OBSTACLE = (0.0, 1.5, 1.0, 0.3)
# bench_controllers.py:61,72-87 slopes 400 -> 2000; cut for the run's time limit
T_SLOPE_12 = (200, 1000)
T_SLOPE_12_PLAIN = (48, 144)  # multiples of K=8
T_SLOPE_MPPI_PLAIN = (10, 30)   # ~213 ms a plain tick
# the iLQR engine and the 12-state noisy loops (cli.py fly --controller
# ilqr12 [--fast] [--noisy], --controller ltv12 --noisy)
ILQR_HORIZON = 15
# These flights are host-bound, tens to hundreds of milliseconds a tick
# (PERF.md §5), so they are cut to keep the plain run near 900 s.
ILQR_STAGED_T = 30            # the staged RK4 engine, 3 iterations
ILQR_K2_T = 100               # the policy tier, K=2, 1 iteration
NOISY12_T = 8                 # the iLQR engine on the EKF's estimate
NOISY_LTV_T = 4               # control ticks at 10 Hz, 10 sensor substeps each
T_SLOPE_ILQR_STAGED = (4, 12)
T_SLOPE_ILQR_K2 = (20, 60)
ILQR_SHARE_T = 20             # the K=2 tier's profiler window (ticks)
JAX_RMS_GAP_M = 5e-3          # the port's circle RMS against the JAX package's
# jax_reference_rms.py --ilqr (the JAX package on the CPU, float32): the
# circle task's RMS over ILQR_STAGED_T and ILQR_K2_T ticks
JAX_ILQR_RMS_M = {"ilqr12_staged": 0.13116547465324402, "ilqr12_k2": 0.35347670316696167}

# operation counts read off csrc/rigid_math.cuh, rigid_tick_kernel.cu and
# mppi_kernels.cu (one per add, multiply, division, select or
# transcendental)
OPS_RIGID_DERIVATIVE = 85
OPS_RIGID_RK4 = 4 * OPS_RIGID_DERIVATIVE + 3 * 24 + 12 * 7
OPS_DIRECT_RATE_SUBSTEP = 66
OPS_MPPI_STAGE_COST = 50


def ops_rigid_tick(N: int, iterations: int, plant_ops: int, nu: int = 4, nx: int = 12) -> int:
    """FP32 operations of one K11 tick (an FMA counts 2): the shift, offset,
    gradient, bounds, p0, the ADMM iterations and the plant."""
    Nnu, Nnx, m = N * nu, N * nx, N * (nu + nx)
    return (2 * m + Nnx * (2 * 12 + 2) + Nnu * (2 * Nnx + 2) + 6 * m + 2 * Nnu * m
            + iterations * (2 * m * m + 12 * m) + plant_ops + nu)


def ops_rigid_tick_factored(N: int, iterations: int, plant_ops: int, nu: int = 4,
                            nx: int = 12) -> int:
    """``ops_rigid_tick`` with each ADMM step's (m, m) product by P1 counted
    as the kernel runs it, on P1's factors: v[N nu:] GsL (N nx x N nu), the
    diagonal term, then w GMinvT_s (N nu x m)."""
    Nnu, Nnx, m = N * nu, N * nx, N * (nu + nx)
    p1_product = 2 * m * m
    factored = 2 * Nnx * Nnu + 2 * Nnu + 2 * Nnu * m
    return ops_rigid_tick(N, iterations, plant_ops, nu, nx) - iterations * (p1_product - factored)


def k11_case(dev, plant: str, N: int | None = None):
    """K11's operands at full width on the package's own relinearisation at
    the circle task's start (hover at 3 m, the first dispatch's references,
    K=8, 30 iterations): ``(args, statics)``. Built through the public API
    only, so an older checkout's package builds its own."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control import DirectRateMPC, RigidBodyMPC
    from unmanned_aerial_vehicles_tpu_torch.loop.rigid_loop import dispatch_tick_operands
    from unmanned_aerial_vehicles_tpu_torch.models.params import X500_PARAMS
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

    f32 = dict(dtype=torch.float32, device=dev)
    kw = {} if N is None else dict(horizon=N)
    eng = (DirectRateMPC if plant == "direct_rate" else RigidBodyMPC)(device=dev, **kw)
    N = eng.mpc.config.horizon
    K, m = 8, N * 16
    pos, _, _ = ramped_circle_reference(0.02 * torch.arange(K, **f32), amplitude=2.0, height=3.0)
    x0 = torch.zeros(12, **f32)
    x0[2] = 3.0
    _, ops = dispatch_tick_operands(eng.mpc, eng.cost, x0[None, :].repeat(N + 1, 1),
                                    eng.u_hover[None, :].repeat(N, 1))
    refs = torch.cat([pos, torch.zeros(K, 9, **f32)], 1)[:, None, :].repeat(1, N, 1)
    refs = refs.reshape(K, N * 12).contiguous()
    z0, y0 = torch.zeros(m, **f32), torch.zeros(m, **f32)
    statics = dict(k_ticks=K, n=N, nu=4, nx=12, iterations=30, over_relax=1.6,
                   rho=float(eng.mpc.config.admm_rho), dt=0.02, substeps=1, plant=plant,
                   body=X500_PARAMS if plant == "rigid" else None)
    return (x0, z0, y0, refs, ops), statics


K11_LONG_HORIZON = 25         # past the factors' fit in one block: read through L2


def rel_err(got, want) -> float:
    """Max abs error over a tensor, relative to its size (at least 1)."""
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def k10_cases(rnd) -> list:
    """K10's checked rollouts, ``(x0, U, res, dt, substeps)`` on the CPU:
    random states around hover with residuals at the plant step's n=1
    (dt 0.02) and the plan roll's n=20 (dt 0.1), 4 each at substeps 1 and 2,
    then hover at the Euler-rate singularity (pitch pi/2 -+ 1e-7, -pi/2)
    without residuals. ``rnd(*shape)`` draws standard normals."""
    import torch

    scale = torch.tensor([2, 2, 1, 3, 3, 2, 0.6, 0.6, 2.0, 2, 2, 1.5])
    cases = []
    for n, dt in ((1, 0.02), (20, 0.1)):
        for substeps in (1, 2):
            for _ in range(4):
                U = torch.tensor([4.9, 0.0, 0.0, 0.0]) + rnd(n, 4) * torch.tensor(
                    [0.5, 2e-3, 2e-3, 2e-3])
                cases.append((0.3 * rnd(12) * scale, U, 0.1 * rnd(n, 12), dt, substeps))
    for pitch in (math.pi / 2 - 1e-7, math.pi / 2 + 1e-7, -math.pi / 2):
        x0 = torch.zeros(12)
        x0[7], x0[10] = pitch, 0.5
        cases.append((x0, torch.tensor([[5.0, 0.01, 0.0, 0.0]]), None, 0.01, 1))
    return cases


K10_BODY_WIND = (0.6, -0.4, 0.2)   # the checked rollouts' wind (GZ quadrotor)
K10_LONG_N = 150                   # past the 64 steps K10 stages at a time


def k10_timed_operands(f32: dict):
    """K10's timed operands: hover at 3 m with a thrust step, X500 for the
    plant step (n=1, dt 0.02) and its control repeated 20 times for the GZ
    quadrotor's plan roll (n=20, dt 0.1). ``(x1, u1, U20)``."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.models.params import X500_PARAMS

    x1 = torch.zeros(12, **f32)
    x1[2] = 3.0
    u1 = torch.tensor([[X500_PARAMS.mass * X500_PARAMS.gravity + 0.3, 0.01, -0.01, 0.0]], **f32)
    return x1, u1, u1.repeat(20, 1).contiguous()


def check_rigid_kernels(dev, gen, fail_fn) -> dict:
    """Hold K10, K11 (both plants; the direct-rate engine also at N=25) and
    K12 against their plain versions on the card at the flights' shapes and
    time them. Returns the kernels' records for the JSON line (K11's from
    the direct-rate plant, the rigid plant's under ``"rigid"``, N=25's under
    ``"long"``)."""
    import dataclasses

    import torch

    from unmanned_aerial_vehicles_tpu_torch.control import MPPIController
    from unmanned_aerial_vehicles_tpu_torch.models.params import GZ_QUADROTOR_PARAMS, X500_PARAMS
    from unmanned_aerial_vehicles_tpu_torch.ops import (
        _cuda,
        mppi_pallas,
        rigid_plant_pallas,
        rigid_tick_pallas,
    )

    f32 = dict(dtype=torch.float32, device=dev)
    rnd = lambda *shape: torch.randn(*shape, generator=gen)
    recs = {}

    # K10: random states around hover with wind and residuals, at the plant
    # step's n=1 and the plan roll's n=20, and the Euler-rate singularity;
    # then a rollout past the steps staged at a time, with and without
    # residuals, on its own generator (the later draws stay as they were)
    body = dataclasses.replace(GZ_QUADROTOR_PARAMS, wind=K10_BODY_WIND)
    cases = k10_cases(rnd)
    long_gen = torch.Generator().manual_seed(10)
    long_x0 = 0.1 * torch.randn(12, generator=long_gen)
    long_U = torch.tensor([4.9, 0.0, 0.0, 0.0]) + torch.randn(
        K10_LONG_N, 4, generator=long_gen) * torch.tensor([0.5, 2e-3, 2e-3, 2e-3])
    long_res = 0.1 * torch.randn(K10_LONG_N, 12, generator=long_gen)
    cases += [(long_x0, long_U, long_res, 0.02, 1), (long_x0, long_U, None, 0.02, 2)]
    err = 0.0
    for x0, U, res, dt, substeps in cases:
        x0, U = x0.to(**f32).contiguous(), U.to(**f32).contiguous()
        res = None if res is None else res.to(**f32).contiguous()
        got = rigid_plant_pallas.rigid_body_rollout_fused(x0, U, body, dt, substeps, res)
        torch.cuda.synchronize()
        want = rigid_plant_pallas.rigid_body_rollout_plain(x0, U, body, dt, substeps, res)
        if not bool(torch.isfinite(got).all()):
            fail_fn("K10 produced non-finite values")
        if not torch.equal(got, rigid_plant_pallas.rigid_body_rollout_fused(x0, U, body, dt,
                                                                             substeps, res)):
            fail_fn(f"K10 (n={U.shape[0]}): a second launch on the same inputs differs")
        err = max(err, rel_err(got, want))
    print(f"K10 rigid_body_rollout_fused: max error {err:.3e} relative to the state's size over "
          f"{len(cases)} rollouts (n=1 and 20, substeps 1 and 2, wind, residuals, pitch at the "
          f"Euler-rate singularity, n={K10_LONG_N} with and without residuals); a second launch "
          "bit-identical at each")
    if not err <= RIGID_PLANT_TOL:
        fail_fn(f"K10 disagrees with its plain version: {err}")
    x1, u1, U20 = k10_timed_operands(f32)
    k10_fn = lambda: rigid_plant_pallas.rigid_body_rollout_fused(x1, u1, X500_PARAMS, 0.02)
    k10_plain = lambda: rigid_plant_pallas.rigid_body_rollout_plain(x1, u1, X500_PARAMS, 0.02)
    k10_20 = lambda: rigid_plant_pallas.rigid_body_rollout_fused(x1, U20, GZ_QUADROTOR_PARAMS, 0.1)
    # the iLQR engine's rollout: N=15 steps of the X500 at 50 Hz
    U15 = u1.repeat(ILQR_HORIZON, 1).contiguous()
    k10_15 = lambda: rigid_plant_pallas.rigid_body_rollout_fused(x1, U15, X500_PARAMS, 0.02)
    k10_15_plain = lambda: rigid_plant_pallas.rigid_body_rollout_plain(x1, U15, X500_PARAMS, 0.02)
    got15 = k10_15()
    torch.cuda.synchronize()
    err15 = rel_err(got15, k10_15_plain())
    if not (err15 <= RIGID_PLANT_TOL and torch.equal(got15, k10_15())):
        fail_fn(f"K10 at n={ILQR_HORIZON}: error {err15}, or a second launch differs")
    recs["rigid_body_rollout_fused"] = dict(
        err=max(err, err15), ms=graph_ms(k10_fn, 200), plain_ms=graph_ms(k10_plain, 5),
        host_ms=cuda_ms(k10_fn, 500), host_plain_ms=cuda_ms(k10_plain, 20),
        bound=bound_ms(nbytes(x1, u1) + 4 * 12, OPS_RIGID_RK4),
        n20_ms=graph_ms(k10_20, 50),
        n20_bound=bound_ms(nbytes(x1, U20) + 4 * 12 * 20, 20 * OPS_RIGID_RK4),
        n15_err=err15, n15_ms=graph_ms(k10_15, 50), n15_plain_ms=graph_ms(k10_15_plain, 2),
        n15_host_ms=cuda_ms(k10_15, 200),
        n15_bound=bound_ms(nbytes(x1, U15) + 4 * 12 * ILQR_HORIZON,
                           ILQR_HORIZON * OPS_RIGID_RK4))

    # K11 at full width on the port's own relinearisation at the circle
    # task's start (hover at 3 m, the first dispatch's references); the
    # direct-rate engine also at N=25, where the factors go through L2
    for plant, N in (("direct_rate", None), ("rigid", None), ("direct_rate", K11_LONG_HORIZON)):
        args, statics = k11_case(dev, plant, N)
        N, K = statics["n"], statics["k_ticks"]
        x0, z0, y0, refs, ops = args
        got = rigid_tick_pallas.direct_rate_multitick_kernel(*args, **statics)
        torch.cuda.synchronize()
        want = rigid_tick_pallas.direct_rate_multitick_plain(*args, **statics)
        if not all(bool(torch.isfinite(g).all()) for g in got):
            fail_fn(f"K11 ({plant}, N={N}) produced non-finite values")
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        again = rigid_tick_pallas.direct_rate_multitick_kernel(*args, **statics)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail_fn(f"K11 ({plant}, N={N}): a second launch on the same inputs differs")
        shared, smem = rigid_tick_pallas.factor_placement(dev, N)
        variant = "factors in shared memory" if shared else "factors through L2"
        print(f"K11 direct_rate_multitick_kernel ({plant} plant, N={N}, m={N * 16}, K={K}, 30 "
              f"iterations, {variant}, {smem} B of shared memory): max_abs_err out "
              f"{errs[0]:.3e}, x {errs[1]:.3e}, z {errs[2]:.3e}, y {errs[3]:.3e}; a second launch "
              "bit-identical")
        if not max(errs) <= K11_TOL:
            fail_fn(f"K11 ({plant}, N={N}) disagrees with its plain version: {errs}")
        fn = lambda a=args, s=statics: rigid_tick_pallas.direct_rate_multitick_kernel(*a, **s)
        if N == K11_LONG_HORIZON:
            k11_long = dict(err=max(errs), errs=errs, ms=graph_ms(fn, 5), variant=variant)
            print(f"  K11 (N={N}, {variant}): device {k11_long['ms'] * 1e3:.2f} us per launch")
            continue
        plain = lambda a=args, s=statics: rigid_tick_pallas.direct_rate_multitick_plain(*a, **s)
        plant_ops = OPS_RIGID_RK4 if plant == "rigid" else OPS_DIRECT_RATE_SUBSTEP
        # the bound is the kernel's own work: the factored product, and
        # every operand but P1 (which only the plain version reads), of Gs
        # its lower N nx rows and its top block's diagonal; the P1 form's,
        # which earlier rows of PERF.md give, is kept beside it
        Nnu = N * 4
        kernel_ops = [t for name, t in ops._asdict().items() if name not in ("P1", "Gs")]
        kernel_ops += [ops.Gs[Nnu:], ops.Gs[:Nnu].diagonal()]
        # each section's cycles per launch, from the build with section clocks
        with _cuda.library_variant("rigid_tick", "rigid_tick_clocks"):
            rigid_tick_pallas.rigid_section_cycles()
            fn()
            torch.cuda.synchronize()
            cycles = rigid_tick_pallas.rigid_section_cycles()
        shares = {k: v / cycles["whole tick"] for k, v in cycles.items() if k != "whole tick"}
        rec = dict(err=max(errs), errs=errs, ms=graph_ms(fn, 5), plain_ms=graph_ms(plain, 1, replays=3),
                   host_ms=cuda_ms(fn, 20), host_plain_ms=cuda_ms(plain, 2, warmup=1),
                   bound=bound_ms(nbytes(x0, z0, y0, refs, *kernel_ops) + nbytes(*got),
                                  K * ops_rigid_tick_factored(N, 30, plant_ops)),
                   bound_p1_form=bound_ms(nbytes(x0, z0, y0, refs, *ops) + nbytes(*got),
                                          K * ops_rigid_tick(N, 30, plant_ops)),
                   variant=variant, n=N, cycles_per_launch=cycles, section_shares=shares)
        print(f"  K11 ({plant}): device {rec['ms'] * 1e3:.2f} us per launch of {K} ticks "
              f"({rec['ms'] * 1e3 / K:.2f} us per tick), plain {rec['plain_ms'] * 1e3:.2f} us; "
              f"bound {rec['bound'][0] * 1e3:.4f} us on the factors ({rec['bound'][1]}; "
              f"the P1 form's {rec['bound_p1_form'][0] * 1e3:.4f} us, "
              f"{rec['bound_p1_form'][1]})")
        print(f"  K11 ({plant}) sections, share of the launch's tick cycles (clocked build, "
              f"{cycles['whole tick']} cycles): "
              + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
        if plant == "direct_rate":
            recs["direct_rate_multitick_kernel"] = rec
        else:
            recs["direct_rate_multitick_kernel"]["rigid"] = rec
    k11 = recs["direct_rate_multitick_kernel"]
    k11["long"] = k11_long
    k11["err"] = max(k11["err"], k11["rigid"]["err"], k11_long["err"])

    # K12 at the controller's width (512 samples x 25 steps)
    ctrl = MPPIController(device=dev)
    cfg = ctrl.config
    x0 = torch.zeros(12, **f32)
    x0[2] = 3.0
    x0 += 0.1 * rnd(12).to(**f32)
    x0[8] = 3.0
    eps = rnd(cfg.num_samples, cfg.horizon, 4).to(**f32)
    U = torch.minimum(torch.maximum(ctrl.u_hover + ctrl._noise_std * eps, ctrl.u_lo), ctrl.u_hi)
    U = U.contiguous()
    targets = (torch.tensor([0.5, -0.3, 3.2]) + 0.05 * torch.arange(cfg.horizon)[:, None]).to(**f32)
    yaw = torch.tensor(-3.0, **f32)
    k12_args = (x0, U, targets, yaw, X500_PARAMS, cfg.dt, ctrl._u_hover_host, cfg.weights)
    got = mppi_pallas.mppi_rollout_costs_fused(*k12_args)
    torch.cuda.synchronize()
    want = mppi_pallas.mppi_rollout_costs_plain(*k12_args)
    if not bool(torch.isfinite(got).all()):
        fail_fn("K12 produced non-finite values")
    k12_err = float(((got - want).abs() / want.abs()).max())
    print(f"K12 mppi_rollout_costs_fused: max relative error {k12_err:.3e} over "
          f"{cfg.num_samples} costs ({cfg.num_samples} x {cfg.horizon} RK4 steps; costs "
          f"{float(want.min()):.1f}..{float(want.max()):.1f})")
    if not k12_err <= K12_RTOL:
        fail_fn(f"K12 disagrees with its plain version: {k12_err}")
    if not torch.equal(got, mppi_pallas.mppi_rollout_costs_fused(*k12_args)):
        fail_fn("K12: a second launch on the same inputs differs")
    # the tails of the launch shape (blocks of 8 samples) and other
    # horizons, on their own generator
    k12_gen = torch.Generator().manual_seed(12)
    shape_errs = {}
    for K, N in K12_SHAPES:
        args = k12_operands(k12_gen, ctrl, K, N, f32)
        got_c = mppi_pallas.mppi_rollout_costs_fused(*args)
        torch.cuda.synchronize()
        want_c = mppi_pallas.mppi_rollout_costs_plain(*args)
        if not bool(torch.isfinite(got_c).all()):
            fail_fn(f"K12 at {K} x {N} produced non-finite values")
        shape_errs[f"{K}x{N}"] = float(((got_c - want_c).abs() / want_c.abs()).max())
        if not torch.equal(got_c, mppi_pallas.mppi_rollout_costs_fused(*args)):
            fail_fn(f"K12 at {K} x {N}: a second launch on the same inputs differs")
    print("  K12 at other sample counts and horizons, max relative error (a second launch "
          "bit-identical at each): " + ", ".join(f"{k} {e:.3e}" for k, e in shape_errs.items()))
    if not max(shape_errs.values()) <= K12_RTOL:
        fail_fn(f"K12 disagrees with its plain version: {shape_errs}")
    # cycles per RK4 step and per derivative, from the build with section clocks
    with _cuda.library_variant("mppi", "mppi_clocks"):
        mppi_pallas.mppi_section_cycles()
        mppi_pallas.mppi_rollout_costs_fused(*k12_args)
        torch.cuda.synchronize()
        k12_cycles = mppi_pallas.mppi_section_cycles()
    print(f"  K12 clock cycles (mppi_clocks build, lane 0 of each sample's group, "
          f"{cfg.num_samples} x {cfg.horizon}): "
          + "; ".join(f"{k} {v:.0f}" for k, v in k12_cycles.items()))
    # a float64 controller samples through K12 too (in float32, costs cast
    # back): one launch per tick
    ctrl64 = MPPIController(dtype=torch.float64, device=dev)
    before = _cuda.launch_counts["mppi_rollout_costs_fused"]
    u64, _, _ = ctrl64.solve(ctrl64.init_carry(x0), x0, targets[0], 0.0)
    launched = _cuda.launch_counts["mppi_rollout_costs_fused"] - before
    print(f"  a float64 MPPIController tick: {launched} K12 launch, u0 {u64.dtype}")
    if launched != 1 or u64.dtype != torch.float64 or not bool(torch.isfinite(u64).all()):
        fail_fn(f"a float64 MPPI tick launched K12 {launched} times (u0 {u64})")
    fn = lambda: mppi_pallas.mppi_rollout_costs_fused(*k12_args)
    plain = lambda: mppi_pallas.mppi_rollout_costs_plain(*k12_args)
    recs["mppi_rollout_costs_fused"] = dict(
        err=max(k12_err, *shape_errs.values()), err_by_shape=shape_errs, cycles=k12_cycles,
        ms=graph_ms(fn, 20), plain_ms=graph_ms(plain, 1, replays=3),
        host_ms=cuda_ms(fn, 50), host_plain_ms=cuda_ms(plain, 2, warmup=1),
        bound=bound_ms(nbytes(x0, U, targets, yaw, got),
                       cfg.num_samples * (cfg.horizon * (OPS_RIGID_RK4 + OPS_MPPI_STAGE_COST) + 20)))
    r = recs["rigid_body_rollout_fused"]
    print(f"K10 device time per launch: n=1 {r['ms'] * 1e3:.2f} us (plain {r['plain_ms'] * 1e3:.2f} "
          f"us, bound {r['bound'][0] * 1e3:.6f} us, {r['bound'][1]}); n={ILQR_HORIZON} (the iLQR "
          f"rollout; max error {r['n15_err']:.3e}, a second launch bit-identical) "
          f"{r['n15_ms'] * 1e3:.2f} us (plain {r['n15_plain_ms'] * 1e3:.2f} us, with host overhead "
          f"{r['n15_host_ms'] * 1e3:.2f} us, bound {r['n15_bound'][0] * 1e3:.6f} us, "
          f"{r['n15_bound'][1]}); n=20 (the LTV plan roll) "
          f"{r['n20_ms'] * 1e3:.2f} us (bound {r['n20_bound'][0] * 1e3:.6f} us); K12 "
          f"{recs['mppi_rollout_costs_fused']['ms'] * 1e3:.2f} us (plain "
          f"{recs['mppi_rollout_costs_fused']['plain_ms'] * 1e3:.2f} us, bound "
          f"{recs['mppi_rollout_costs_fused']['bound'][0] * 1e3:.4f} us)")
    return recs


K12_SHAPES = tuple((K, N) for K in (1, 17, 513, 2048) for N in (1, 7, 25))


def k12_operands(gen, ctrl, K: int, N: int, f32: dict) -> tuple:
    """K12's operands for K samples of N steps: a perturbed hover state with
    its yaw near the wrap, candidates drawn around hover and clipped as
    ``ctrl`` (an ``MPPIController``) clips them, a rising line of targets
    and a target yaw across the wrap; ``ctrl``'s weights and step."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.models.params import X500_PARAMS

    x0 = torch.zeros(12)
    x0[2] = 3.0
    x0 += 0.1 * torch.randn(12, generator=gen)
    x0[8] = 3.0
    x0 = x0.to(**f32)
    eps = torch.randn(K, N, 4, generator=gen).to(**f32)
    U = torch.minimum(torch.maximum(ctrl.u_hover + ctrl._noise_std * eps, ctrl.u_lo), ctrl.u_hi)
    targets = (torch.tensor([0.5, -0.3, 3.2]) + 0.05 * torch.arange(N)[:, None]).to(**f32)
    yaw = torch.tensor(-3.0, **f32)
    cfg = ctrl.config
    return (x0, U.contiguous(), targets, yaw, X500_PARAMS, cfg.dt, ctrl._u_hover_host,
            cfg.weights)


class RigidFamily:
    """The 12-state family's flights on the card (the circle task of
    ``tools/bench_controllers.py``; the LTV obstacle flight at 10 Hz), each
    callable as ``fly(T, plain)``, with ``plain=True`` flying the kernels'
    plain versions. Each returns ``state`` and ``pos_ref`` (T, .)."""

    def __init__(self, dev):
        import torch

        from unmanned_aerial_vehicles_tpu_torch.control import (
            DirectRateMPC,
            LTVTrackingMPC,
            RigidBodyMPC,
        )
        from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

        self.torch, self.dev = torch, dev
        self.f32 = dict(dtype=torch.float32, device=dev)
        self.circle = lambda t: ramped_circle_reference(t, amplitude=2.0, height=3.0)
        self.dr = DirectRateMPC(device=dev)
        self.rigid = RigidBodyMPC(device=dev)
        self.ltv = LTVTrackingMPC(num_obstacles=1, obstacle_margin=0.2, device=dev)
        self.x0 = torch.zeros(12, **self.f32)
        self.x0[2] = 3.0

    def circle_pos(self, T):
        return self.circle(0.02 * self.torch.arange(T, **self.f32))[0]

    def reference_fn(self, N):
        torch = self.torch

        def reference_fn(ticks):
            pos = self.circle(0.02 * ticks.to(torch.float32))[0]
            stage = torch.cat([pos, torch.zeros(ticks.shape[0], 9, **self.f32)], 1)
            return stage[:, None, :].repeat(1, N, 1)
        return reference_fn

    def multitick_kw(self, eng):
        return dict(ticks_per_dispatch=8, admm_iterations=30, u_init=eng.u_hover)

    def direct_rate12_fused(self, T, plain=False):
        from unmanned_aerial_vehicles_tpu_torch.loop import direct_rate_multitick_fused

        eng = self.dr
        outs = direct_rate_multitick_fused(
            eng.mpc, eng.cost, self.reference_fn(eng.mpc.config.horizon), self.x0, T,
            dt=0.02, plan_roll="linear", plain_kernels=plain, **self.multitick_kw(eng))
        return {"state": outs["state"], "u": outs["u"], "pos_ref": self.circle_pos(T)}

    def mpc12_fused(self, T, plain=False):
        from unmanned_aerial_vehicles_tpu_torch.loop import rigid_multitick_fused

        eng = self.rigid
        outs = rigid_multitick_fused(
            eng.mpc, eng.cost, self.reference_fn(eng.mpc.config.horizon), self.x0, T,
            dt=0.02, plan_roll="linear", plain_kernels=plain, **self.multitick_kw(eng))
        return {"state": outs["state"], "u": outs["u"], "pos_ref": self.circle_pos(T)}

    def mpc12_multitick(self, T, plain=False):
        from unmanned_aerial_vehicles_tpu_torch.loop import sqp_multitick_rollout
        from unmanned_aerial_vehicles_tpu_torch.models.params import X500_PARAMS
        from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import rigid_body_rk4_step_fast

        eng = self.rigid
        plant = lambda x, u: rigid_body_rk4_step_fast(x, u, X500_PARAMS, 0.02, plain_kernels=plain)
        outs = sqp_multitick_rollout(
            eng.mpc, eng.cost, self.reference_fn(eng.mpc.config.horizon), plant, self.x0, T,
            plan_roll="linear", **self.multitick_kw(eng))
        return {"state": outs["state"], "u": outs["u"], "pos_ref": self.circle_pos(T)}

    def ltv_ref(self, t):
        """The LTV flight's reference: a 1.5 m circle at 1 m, period 20 s."""
        torch = self.torch
        w = 2.0 * math.pi / 20.0
        zero = torch.zeros_like(t)
        return torch.stack([1.5 * torch.cos(w * t), 1.5 * torch.sin(w * t), zero + 1.0,
                            -1.5 * w * torch.sin(w * t), 1.5 * w * torch.cos(w * t)]
                           + [zero] * 7, -1)

    def ltv12_obstacle(self, T, plain=False):
        """bench_controllers.py:449-512: 10 Hz, K=2, 100 ADMM iterations, the
        obstacle on the path, the attitude-recovery fallback, the plant (RK4,
        2 substeps) and the plan re-anchor through K10."""
        from unmanned_aerial_vehicles_tpu_torch.loop import (
            make_attitude_recovery_fallback,
            sqp_multitick_rollout,
        )
        from unmanned_aerial_vehicles_tpu_torch.models.params import GZ_QUADROTOR_PARAMS as GZ
        from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import (
            rigid_body_rk4_step_fast,
            rigid_body_rollout_fused,
            rigid_body_rollout_plain,
        )

        torch, eng = self.torch, self.ltv
        N = eng.mpc.config.horizon
        roll = rigid_body_rollout_plain if plain else rigid_body_rollout_fused

        def reference_fn(ticks):
            t = 0.1 * (ticks[:, None] + 1 + torch.arange(N, device=self.dev)[None, :]).to(torch.float32)
            return self.ltv_ref(t)

        outs = sqp_multitick_rollout(
            eng.mpc, eng.cost, reference_fn,
            lambda x, u: rigid_body_rk4_step_fast(x, u, GZ, 0.1, substeps=2, plain_kernels=plain),
            self.ltv_ref(torch.zeros((), **self.f32)), T, ticks_per_dispatch=2,
            admm_iterations=100, u_init=eng.u_hover,
            obstacles=torch.tensor([LTV_OBSTACLE], **self.f32),
            plan_roll_fn=lambda x, U, residuals: roll(x, U, GZ, 0.1),
            fallback_fn=make_attitude_recovery_fallback(GZ))
        ts = 0.1 * torch.arange(T, **self.f32)
        return {"state": outs["state"], "u": outs["u"], "pos_ref": self.ltv_ref(ts)[:, 0:3]}

    def mppi12(self, T, plain=False):
        return mppi12_flight(self.dev, T, plain)

    def ilqr_engine(self, plain, iterations=3):
        from unmanned_aerial_vehicles_tpu_torch.control import ILQRRigidBodyMPC

        return ILQRRigidBodyMPC(integrator="rk4", iterations=iterations, device=self.dev,
                                plain_kernels=plain)

    def ilqr12_staged(self, T, plain=False):
        """cli.py fly --controller ilqr12 (bench_controllers.py's
        ilqr12_rk4_staged row): the RK4 iLQR engine (N=15, 3 iterations,
        its rollouts through K10) per tick, the plant step through K10; the
        state after each step against the reference at its tick."""
        from unmanned_aerial_vehicles_tpu_torch.models.params import X500_PARAMS
        from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import rigid_body_rk4_step_fast

        eng = self.ilqr_engine(plain)
        pos_ref, _, yaw_ref = self.circle(0.02 * self.torch.arange(T, **self.f32))
        x = self.x0.clone()
        carry, states = eng.init_carry(x), []
        for i in range(T):
            u, _, carry = eng.solve(carry, x, pos_ref[i], yaw_ref[i])
            x = rigid_body_rk4_step_fast(x, u, X500_PARAMS, 0.02, plain_kernels=plain)
            states.append(x)
        return {"state": self.torch.stack(states), "pos_ref": pos_ref}

    def ilqr12_k2(self, T, plain=False):
        """cli.py fly --controller ilqr12 --fast (the ilqr12_multitick_rk4_k2
        row): the policy tier, one RK4 solve of 1 iteration per K=2 ticks,
        the plant step through K10; the pre-step state against the
        reference."""
        from unmanned_aerial_vehicles_tpu_torch.loop import ilqr_multitick_rollout
        from unmanned_aerial_vehicles_tpu_torch.models.params import X500_PARAMS
        from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import rigid_body_rk4_step_fast

        outs = ilqr_multitick_rollout(
            self.ilqr_engine(plain, iterations=1),
            lambda ticks: self.circle(0.02 * ticks.to(self.torch.float32))[0],
            lambda x, u: rigid_body_rk4_step_fast(x, u, X500_PARAMS, 0.02, plain_kernels=plain),
            self.x0, T, ticks_per_dispatch=2)
        return {"state": outs["state"], "u": outs["u"], "pos_ref": self.circle_pos(T)}

    def noisy_ilqr12(self, T, plain=False):
        """cli.py fly --controller ilqr12 --noisy: the RK4 iLQR engine on the
        rigid-body EKF's estimate, ``EKFConfig()``, the truth through K10,
        the sensor draws from a generator seeded 12."""
        from unmanned_aerial_vehicles_tpu_torch.estimation import noisy_rigid_mpc_rollout

        def reference_fn(t):
            pos, _, yaw = self.circle(t)
            return pos, yaw

        gen = self.torch.Generator(device=self.dev).manual_seed(12)
        return noisy_rigid_mpc_rollout(self.ilqr_engine(plain), reference_fn, T, generator=gen,
                                       device=self.dev, plain_kernels=plain)

    def noisy_ltv12(self, T, plain=False):
        """cli.py fly --controller ltv12 --noisy: the LTV MPC (N=20, 200
        iterations) at 10 Hz on the 100 Hz rigid-body EKF (10 sensor
        substeps per control tick, the truth through K10), the LTV flight's
        circle as its shifting window, the draws from a generator seeded
        13."""
        from unmanned_aerial_vehicles_tpu_torch.control import LTVTrackingMPC
        from unmanned_aerial_vehicles_tpu_torch.estimation import noisy_ltv_rollout

        torch = self.torch
        eng = LTVTrackingMPC(device=self.dev)
        N = eng.mpc.config.horizon
        window = lambda i: self.ltv_ref(0.1 * (i + torch.arange(N + 1, device=self.dev))
                                        .to(torch.float32))
        gen = torch.Generator(device=self.dev).manual_seed(13)
        return noisy_ltv_rollout(eng, window, T, generator=gen, device=self.dev,
                                 plain_kernels=plain)


def ilqr_iteration_parts(dev) -> dict:
    """Host milliseconds of the parts of one iteration of the RK4 iLQR
    engine at hover (N=15), each call ended by ``torch.cuda.synchronize()``,
    best of 3: the vmapped ``jacfwd`` of the step, the Riccati pass, the
    forward rollout through K10 and through the plain loop of the step."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control import ILQRRigidBodyMPC
    from unmanned_aerial_vehicles_tpu_torch.ops.riccati import lqr_tracking_solve

    f32 = dict(dtype=torch.float32, device=dev)
    eng = ILQRRigidBodyMPC(integrator="rk4", device=dev)
    N = eng.N
    X = torch.zeros(N + 1, 12, **f32)
    X[:, 2] = 3.0
    U = eng.u_hover[None, :].repeat(N, 1)
    jac = torch.func.vmap(torch.func.jacfwd(eng.step_fn, argnums=(0, 1)))
    A, B = jac(X[:-1], U)
    lqr_args = (A, B, torch.zeros(N, 12, **f32), eng.q_diag, eng.r_diag + eng.reg,
                torch.zeros(N + 1, 12, **f32), torch.zeros(N, 4, **f32), torch.zeros(12, **f32))

    def plain_rollout():
        x = X[0]
        for k in range(N):
            x = eng.step_fn(x, U[k])
        return x

    parts = {"vmapped jacfwd": lambda: jac(X[:-1], U),
             "Riccati pass": lambda: lqr_tracking_solve(*lqr_args),
             "K10 rollout": lambda: eng.rollout_fn(X[0], U),
             "plain rollout": plain_rollout}
    out = {}
    for name, fn in parts.items():
        fn()
        best = math.inf
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        out[name] = best * 1e3
    return out


def mppi12_flight(dev, T, plain=False):
    """The staged MPPI flight (cli.py fly --controller mppi12) on the circle
    task from hover at 3 m: one sampling stage (K12) and one plant step
    (K10) per tick; the state after each step against the reference at its
    tick. ``plain=True`` flies the kernels' plain versions."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control import MPPIConfig, MPPIController
    from unmanned_aerial_vehicles_tpu_torch.models.params import X500_PARAMS
    from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import rigid_body_rk4_step_fast
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

    f32 = dict(dtype=torch.float32, device=dev)
    ctrl = MPPIController(MPPIConfig(fused_rollouts=not plain), device=dev)
    pos_ref, _, yaw_ref = ramped_circle_reference(0.02 * torch.arange(T, **f32), amplitude=2.0,
                                                  height=3.0)
    x = torch.zeros(12, **f32)
    x[2] = 3.0
    carry = ctrl.init_carry(x, seed=0)
    states = []
    for i in range(T):
        u, _, carry = ctrl.solve(carry, x, pos_ref[i], yaw_ref[i])
        x = rigid_body_rk4_step_fast(x, u, X500_PARAMS, 0.02, plain_kernels=plain)
        states.append(x)
    return {"state": torch.stack(states), "pos_ref": pos_ref}


# ---- K13: the autodiff routes and the auto-tuners ---------------------------

# operation counts of the plant VJPs, read off csrc/plant_math.cuh
# (derivative_vjp_warp: the forward's trigonometry and products recomputed,
# then the adjoint of each row; rk4_substeps_vjp_warp: the forward once, its
# stage states kept, then per substep four derivative VJPs and the stage
# sums; allocation_vjp_warp: the allocation recomputed and its adjoint)
OPS_DERIVATIVE_VJP = 214
OPS_RK4_SUBSTEP_ADJOINT = 4 * OPS_DERIVATIVE_VJP + 12 + 3 * 48
OPS_PLANT_VJP = 2 * (OPS_RK4_SUBSTEP + OPS_RK4_SUBSTEP_ADJOINT)
OPS_ALLOCATION_VJP = OPS_ALLOCATION + 70
VJP_TOL = 1e-5                # of each cotangent's max-abs scale
AD_GRAD_RTOL = 1e-4           # K5 route's weight gradient against the plain route's
TUNER_TRACE_RTOL = 1e-3       # a tuner's loss trace, kernel route against plain route

# the tuners' widths: the JAX CLI's `tune` task (cli.py:1095-1176, 1458-1469:
# a circle of 6 m at 3 m, 30 s = 1500 ticks, settle 250, learning rate 0.06,
# PID_CAMPAIGN_RATE_LOOP), 3 iterations instead of 40; the MPC tuners at
# bench.py's fused width (N=20, 10 ADMM iterations, K=20) and at the
# LinearMPCConfig() default (N=25, 80 iterations) on the staged tier, 2
# iterations and 200 ticks each
PID_TUNE_T, PID_TUNE_ITERS, PID_TUNE_LR, PID_TUNE_SETTLE = 1500, 3, 0.06, 250
MPC_TUNE_T, MPC_TUNE_ITERS, MPC_TUNE_LR, MPC_TUNE_SETTLE = 200, 2, 0.08, 50
TUNE_SHORT_T, TUNE_SHORT_ITERS, TUNE_SHORT_SETTLE = 60, 2, 15    # against the plain route


def tune_circle(t):
    """The CLI's tune task: the ramped circle of 6 m at the 3 m take-off height."""
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

    pos, _, yaw = ramped_circle_reference(t, amplitude=6.0, height=3.0)
    return pos, yaw


def vjp_operands(gen, B: int, wind, f32: dict) -> list:
    """The plant VJPs' operands for a batch of B: states around hover with
    the wind ``wind`` (3,), a quarter at zero airspeed and, for B >= 4, a
    quarter with the tilt, integral, rate and thrust clamps binding;
    controls, commands (thrust ceiling 1.2), integrals, and the cotangents
    of K2's three outputs. ``[s, c, cmd, integ, ct_s, ct_c, ct_i]``."""
    import torch

    s = 0.3 * torch.randn(B, 12, generator=gen)
    s[:, 2] += 3.0
    q = B // 4
    s[:q, 3:6] = torch.tensor(wind)                       # zero airspeed
    c = torch.cat([1.0 + 0.1 * torch.randn(B, 1, generator=gen),
                   0.3 * torch.randn(B, 3, generator=gen)], 1)
    cmd = torch.cat([torch.randn(B, 3, generator=gen), 0.3 * torch.randn(B, 2, generator=gen),
                     torch.full((B, 1), 1.2)], 1)
    integ = 0.05 * torch.randn(B, 3, generator=gen)
    if B >= 4:                                            # every clamp binding
        s[q:2 * q, 6:12] = torch.tensor([0.9, -0.9, 2.0, 2.0, -2.0, 1.5])
        cmd[q:2 * q] = torch.tensor([5.0, -5.0, 9.0, 0.5, -1.0, 1.2])
        integ[q:2 * q] = torch.tensor([0.299, -0.299, 0.299])
    cts = [torch.randn(B, n, generator=gen) for n in (12, 7, 3)]
    return [t.to(**f32).contiguous() for t in (s, c, cmd, integ, *cts)]


def k13b_cycles(dev, prow) -> dict:
    """K13b's cycles per state by phase at B=1 (the tuners' batch), from
    the ``plant_vjp_clocks`` build, on ``vjp_operands``' draw from its own
    generator (the mean over 20 launches)."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, tick_ad

    f32 = dict(dtype=torch.float32, device=dev)
    wind = tuple(float(v) for v in prow[7:10])
    s, _, cmd, integ, ct_s, ct_c, ct_i = vjp_operands(torch.Generator().manual_seed(13), 1,
                                                      wind, f32)
    with _cuda.library_variant("plant_vjp", "plant_vjp_clocks"):
        tick_ad.plant_vjp_section_cycles()
        for _ in range(20):
            tick_ad.allocation_plant_tick_vjp(s, cmd, integ, prow, ct_s, ct_c, ct_i, 0.02, 2)
        torch.cuda.synchronize()
        return tick_ad.plant_vjp_section_cycles()


def check_plant_vjps(dev, gen, prow, fail_fn) -> dict:
    """Hold K13a and K13b against their plain versions (``torch.func.vjp`` of
    K1's and K2's plain versions) at B=1 and B=1024 on states around hover
    with wind: a quarter at zero airspeed, and for K13b a quarter with the
    tilt, integral, rate and thrust clamps binding; 1e-5 of each cotangent's
    scale; a second launch bit-identical. Time both at B=1 (the tuners'
    batch) and B=1024, K13a's lane-owned ablation beside it, and print
    K13b's cycles by phase at B=1 (``k13b_cycles``). Returns their records
    for the JSON line."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, tick_ad

    f32 = dict(dtype=torch.float32, device=dev)
    wind = tuple(float(v) for v in prow[7:10])

    recs = {}
    for name in ("px4_plant_step_vjp", "allocation_plant_tick_vjp"):
        recs[name] = dict(errs={}, timing={})
    recs["px4_plant_step_vjp"]["lane_owned"] = {}
    for B in (1, 1024):
        s, c, cmd, integ, ct_s, ct_c, ct_i = vjp_operands(gen, B, wind, f32)
        calls = {
            "px4_plant_step_vjp": (
                lambda: tick_ad.px4_plant_step_vjp(s, c, prow, ct_s, 0.02, 2),
                lambda: tick_ad.px4_plant_step_vjp_plain(s, c, prow, ct_s, 0.02, 2),
                nbytes(s, c, prow, ct_s) + 4 * (B * 16 + 10),
                B * (OPS_PLANT_VJP + 10)),
            "allocation_plant_tick_vjp": (
                lambda: tick_ad.allocation_plant_tick_vjp(s, cmd, integ, prow, ct_s, ct_c, ct_i,
                                                          0.02, 2),
                lambda: tick_ad.allocation_plant_tick_vjp_plain(s, cmd, integ, prow, ct_s, ct_c,
                                                                ct_i, 0.02, 2),
                nbytes(s, cmd, integ, prow, ct_s, ct_c, ct_i) + 4 * (B * 21 + 10),
                B * (OPS_ALLOCATION_VJP + OPS_PLANT_VJP + 10)),
        }
        for name, (kernel, plain, n_bytes, n_ops) in calls.items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            again = kernel()
            errs = [float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                    for g, w in zip(got, want)]
            if not all(bool(torch.isfinite(g).all()) for g in got):
                fail_fn(f"{name} produced non-finite values (B={B})")
            if not max(errs) <= VJP_TOL:
                fail_fn(f"{name} disagrees with its plain version at B={B}: {errs}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail_fn(f"{name}: a second launch on the same inputs differs (B={B})")
            recs[name]["errs"][B] = errs
            recs[name]["timing"][B] = dict(
                ms=graph_ms(kernel, 200), plain_ms=graph_ms(plain, 5),
                host_ms=cuda_ms(kernel, 500), host_plain_ms=cuda_ms(plain, 20),
                bound=bound_ms(n_bytes, n_ops))
            if name == "px4_plant_step_vjp":
                # the ablation: K13a with lanes 0-11 owning a state component
                # each, held to the same tolerance and timed beside it
                with _cuda.library_variant("plant_vjp", "plant_vjp_lane_owned"):
                    lanes = kernel()
                    torch.cuda.synchronize()
                    lane_errs = [float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                                 for g, w in zip(lanes, want)]
                    if not max(lane_errs) <= VJP_TOL:
                        fail_fn(f"K13a's lane-owned ablation disagrees at B={B}: {lane_errs}")
                    recs[name]["lane_owned"][B] = dict(err=max(lane_errs),
                                                       ms=graph_ms(kernel, 200))
    for name, rec in recs.items():
        t1 = rec["timing"][1]
        rec.update(err=max(max(e) for e in rec["errs"].values()), ms=t1["ms"],
                   plain_ms=t1["plain_ms"], host_ms=t1["host_ms"],
                   host_plain_ms=t1["host_plain_ms"], bound=t1["bound"])
        print(f"K13 {name}: max error per cotangent relative to its scale, B=1 "
              + ", ".join(f"{e:.3e}" for e in rec["errs"][1]) + "; B=1024 "
              + ", ".join(f"{e:.3e}" for e in rec["errs"][1024]) + "; device us per launch "
              + "; ".join(f"B={B} {t['ms'] * 1e3:.2f} (plain {t['plain_ms'] * 1e3:.2f}, bound "
                          f"{t['bound'][0] * 1e3:.5f} {t['bound'][1]})"
                          for B, t in rec["timing"].items()))
    print("  K13a with lanes 0-11 owning a state component each (ablation): device us per "
          "launch " + "; ".join(f"B={B} {t['ms'] * 1e3:.2f} (max error {t['err']:.3e}; shipped "
                                f"{recs['px4_plant_step_vjp']['timing'][B]['ms'] * 1e3:.2f})"
                                for B, t in recs["px4_plant_step_vjp"]["lane_owned"].items()))
    k13b = recs["allocation_plant_tick_vjp"]
    k13b["cycles"] = k13b_cycles(dev, prow)
    print("  K13b clock cycles per state at B=1 (plant_vjp_clocks build, lane 0 of the warp, "
          "20 launches): " + "; ".join(f"{k} {v:.0f}" for k, v in k13b["cycles"].items()))
    return recs


def check_multitick_ad(dev, post, prow, fail_fn) -> dict:
    """``gpmpc_multitick_ad`` at full width (N=20, P=800, K=20 with the
    frozen GP; the tightened K=8 at kappa 2): two chained launches from the
    traced-weight MPC's operands, forward bit-identical to
    ``gpmpc_multitick_fused``, and the weight gradient of a tracking loss
    over both launches within 1e-4 (norm-relative, per leaf) of the same
    gradient through the plain route (autograd straight through
    ``multitick_staged``). Returns the gaps and the route's forward and
    backward seconds."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.ops import tick_ad, tick_pallas
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference
    from unmanned_aerial_vehicles_tpu_torch.tuning import mpc_weights_theta
    from unmanned_aerial_vehicles_tpu_torch.tuning.autotune import _TracedWeightMPC

    f32 = dict(dtype=torch.float32, device=dev)
    out = {}
    for label, K, kappa in (("frozen GP", K_TICKS, 0.0), ("tightened", K5_PREVIEW_K, TIGHTEN_KAPPA)):
        N = HORIZON
        cfg = LinearMPCConfig(horizon=N, admm_iterations=ADMM_ITERS, use_fused_controller=True,
                              tightening_factor=kappa)
        gp = tick_pallas.build_gp_rows(post, 0.1, with_variance=kappa > 0.0)
        ts = 10.0 + 0.02 * torch.arange(2 * K, **f32)
        pos, yaw = ramped_figure8_reference(ts)
        pos = pos + torch.tensor([0.0, 0.0, 3.0], **f32)
        refs = torch.cat([pos, torch.zeros(2 * K, 3, **f32)], 1).repeat(1, N).contiguous()
        x0 = torch.zeros(12, **f32)
        x0[:6] = torch.cat([pos[0] + torch.tensor([0.2, -0.1, 0.05], **f32),
                            torch.tensor([0.5, 0.2, -0.1], **f32)])
        m = 10 * N
        statics = dict(k_ticks=K, use_gp=True, rho=8.0, iterations=ADMM_ITERS, over_relax=1.6,
                       dt=0.02, substeps=2, accel_lo=(-3.5, -3.5, -4.0),
                       accel_hi=(3.5, 3.5, 6.0), yawrate_limit=0.8, n=N, nu=4, nx=6,
                       tighten_kappa=kappa)

        def run(route, grad=True):
            theta = {k: v.requires_grad_(grad) for k, v in mpc_weights_theta(cfg, device=dev).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data = _TracedWeightMPC(theta, cfg)._tick_data
            carry = (x0, torch.cat([x0[:6], torch.zeros(3, **f32)]), x0[:6].repeat(N).contiguous(),
                     torch.zeros(m, **f32), torch.zeros(m, **f32))
            packs = []
            for i in range(2):
                packed, *carry = route(data, gp, *carry, refs[i * K:(i + 1) * K],
                                       yaw[i * K:(i + 1) * K].contiguous(), prow, **statics)
                packs.append(packed)
            packed = torch.cat(packs)
            loss = (torch.mean(torch.sum((packed[:, 0:3] - pos) ** 2, dim=1))
                    + 1e-3 * torch.mean(packed[:, 13:16] ** 2))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads = torch.autograd.grad(loss, list(theta.values())) if grad else None
            torch.cuda.synchronize()
            return packed.detach(), grads, (t1 - t0, time.perf_counter() - t1)

        packed_ad, g_ad, sec_ad = run(tick_ad.gpmpc_multitick_ad)
        packed_plain, g_plain, sec_plain = run(tick_pallas.multitick_staged)
        with torch.no_grad():
            packed_fused, _, _ = run(tick_pallas.gpmpc_multitick_fused, grad=False)
        gaps = {k: float((a - b).norm() / b.norm()) for k, a, b in
                zip(mpc_weights_theta(cfg, device=dev), g_ad, g_plain)}
        finite = all(bool(torch.isfinite(g).all()) for g in g_ad)
        print(f"gpmpc_multitick_ad, {label} (N={N}, P={GP_POINTS}, K={K}, kappa {kappa}, two "
              f"launches): forward bit-identical to gpmpc_multitick_fused "
              f"{torch.equal(packed_ad, packed_fused)}; weight gradient against the plain "
              "route, norm-relative per leaf: "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
              + f"; seconds forward/backward: K5 route {sec_ad[0]:.3f}/{sec_ad[1]:.3f}, plain "
              f"route {sec_plain[0]:.3f}/{sec_plain[1]:.3f}")
        if not torch.equal(packed_ad, packed_fused):
            fail_fn(f"gpmpc_multitick_ad ({label}): forward differs from gpmpc_multitick_fused")
        if not finite or not max(gaps.values()) <= AD_GRAD_RTOL:
            fail_fn(f"gpmpc_multitick_ad ({label}): gradient gap to the plain route {gaps}")
        out[label] = dict(gaps=gaps, seconds=sec_ad, seconds_plain=sec_plain)
    return out


def run_tuners(dev, fail_fn, kernels) -> dict:
    """Phase 3's tuners through the user entry points at the widths above,
    each with the launch counts from 0: the cascade-PID tuner on the CLI
    task (K1 T (I+2) launches, K13a T I), the fused MPC tuner (K5 (T/K)
    (I+2)) and the staged MPC tuner with the fused allocation + plant (K2
    T (I+2), K13b T I). Each must improve its loss, and each is run again
    at 60 ticks through the kernels (counted) and through their plain
    versions on the card: the loss traces within 1e-3 relative."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig
    from unmanned_aerial_vehicles_tpu_torch.models import PID_CAMPAIGN_RATE_LOOP
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda
    from unmanned_aerial_vehicles_tpu_torch.tuning import (
        TuneConfig,
        tune_cascade_gains,
        tune_mpc_weights,
    )

    tuners = {
        "cascade-PID tuner (K1 + K13a)": (
            lambda T, I, settle, plain: tune_cascade_gains(
                tune_circle, T, tune_cfg=TuneConfig(iterations=I, learning_rate=PID_TUNE_LR,
                                                    settle_steps=settle),
                rate_loop=PID_CAMPAIGN_RATE_LOOP,
                loop_cfg=FlightLoopConfig(use_pallas_plant=True, fused_tick_ad=True),
                device=dev, plain_kernels=plain),
            (PID_TUNE_T, PID_TUNE_ITERS, PID_TUNE_SETTLE),
            # the last tick's new state enters no loss term, so autograd
            # never runs its plant step's backward: T - 1 VJPs per iteration
            lambda T, I: {"px4_plant_step_fused": T * (I + 2), "px4_plant_step_vjp": (T - 1) * I}),
        "fused MPC tuner (K5 forward, staged-twin VJP)": (
            lambda T, I, settle, plain: tune_mpc_weights(
                tune_circle, T, base_config=LinearMPCConfig(horizon=HORIZON,
                                                            admm_iterations=ADMM_ITERS),
                tune_cfg=TuneConfig(iterations=I, learning_rate=MPC_TUNE_LR, settle_steps=settle),
                loop_cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=K_TICKS),
                device=dev, plain_kernels=plain)[0],
            (MPC_TUNE_T, MPC_TUNE_ITERS, MPC_TUNE_SETTLE),
            lambda T, I: {"gpmpc_multitick_fused": T // K_TICKS * (I + 2)}),
        "staged MPC tuner (K2 + K13b)": (
            lambda T, I, settle, plain: tune_mpc_weights(
                tune_circle, T, base_config=LinearMPCConfig(),
                tune_cfg=TuneConfig(iterations=I, learning_rate=MPC_TUNE_LR, settle_steps=settle),
                loop_cfg=FlightLoopConfig(use_pallas_plant=True), device=dev,
                plain_kernels=plain)[0],
            (MPC_TUNE_T, MPC_TUNE_ITERS, MPC_TUNE_SETTLE),
            lambda T, I: {"allocation_plant_tick_fused": T * (I + 2),
                          "allocation_plant_tick_vjp": T * I}),
    }
    results = {}
    for label, (tune, (T, I, settle), expected) in tuners.items():
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = tune(T, I, settle, False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in _cuda.launch_counts.items() if v}
        _cuda.reset_launch_counts()
        short = {plain: tune(TUNE_SHORT_T, TUNE_SHORT_ITERS, TUNE_SHORT_SETTLE, plain)
                 for plain in (False, True)}
        torch.cuda.synchronize()
        short_counts = {k: v for k, v in _cuda.launch_counts.items() if v}
        trace = [float(v) for v in res.losses]
        trace_gap = max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(
            [short[False].initial_loss, *short[False].losses],
            [short[True].initial_loss, *short[True].losses]))
        print(f"{label}: {T} ticks, {I} iterations, {seconds:.2f} s; launches {counts}; loss "
              f"initial {float(res.initial_loss):.6f}, trace "
              + ", ".join(f"{v:.6f}" for v in trace)
              + f", final (best) {float(res.final_loss):.6f}; at {TUNE_SHORT_T} ticks (launches "
              f"{short_counts}) against the plain route: initial loss and trace within "
              f"{trace_gap:.3e} relative (kernel route "
              + ", ".join(f"{float(v):.9f}" for v in (short[False].initial_loss,
                                                      *short[False].losses))
              + "; plain route "
              + ", ".join(f"{float(v):.9f}" for v in (short[True].initial_loss,
                                                      *short[True].losses)) + ")")
        for kernel, n in expected(T, I).items():
            if counts.get(kernel, 0) != n:
                fail_fn(f"{label}: {kernel} launched {counts.get(kernel, 0)} times, expected {n}")
            if kernel.endswith("_vjp"):
                kernels[kernel]["launches"] = n
        if not all(math.isfinite(v) for v in trace):
            fail_fn(f"{label}: non-finite loss trace {trace}")
        if not float(res.final_loss) < float(res.initial_loss):
            fail_fn(f"{label}: final loss {float(res.final_loss)} not below the initial "
                    f"{float(res.initial_loss)}")
        if set(short_counts) != set(expected(T, I)):
            fail_fn(f"{label}: the short kernel-route run launched {short_counts}")
        if not trace_gap <= TUNER_TRACE_RTOL:
            fail_fn(f"{label}: loss trace {trace_gap} from the plain route's")
        results[label] = dict(initial=float(res.initial_loss), trace=trace,
                              final=float(res.final_loss), seconds=seconds,
                              short_trace_gap=trace_gap)
    return results


def time_tuner_iterations(dev) -> dict:
    """Seconds of one tuning iteration (value and gradient of a whole
    flight), split into forward and backward, for each tuner: both routes
    at 60 ticks, and the cascade-PID tuner's kernel route at its 1500."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.cascade_pid import CascadePidGains
    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig
    from unmanned_aerial_vehicles_tpu_torch.models import PID_CAMPAIGN_RATE_LOOP
    from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
    from unmanned_aerial_vehicles_tpu_torch.models.px4_surrogate import RateLoopParams
    from unmanned_aerial_vehicles_tpu_torch.tuning import TuneConfig, mpc_weights_theta
    from unmanned_aerial_vehicles_tpu_torch.tuning.autotune import (
        _cascade_loss_fn,
        _cascade_theta,
        _f32_gains,
        _mpc_loss_fn,
    )

    body = RigidBodyParams()
    template = _f32_gains(CascadePidGains.default(device=dev), dev)
    fused_base = LinearMPCConfig(horizon=HORIZON, admm_iterations=ADMM_ITERS,
                                 use_fused_controller=True)

    def pid(T, plain):
        loss = _cascade_loss_fn(tune_circle, T, template, TuneConfig(settle_steps=T // 6), body,
                                PID_CAMPAIGN_RATE_LOOP, FlightLoopConfig(use_pallas_plant=True),
                                dev, plain)
        return loss, _cascade_theta(template)

    def mpc(base, loop):
        def make(T, plain):
            loss = _mpc_loss_fn(tune_circle, T, base, TuneConfig(settle_steps=T // 4), body,
                                RateLoopParams(), loop, None, False, dev, plain)
            return loss, mpc_weights_theta(base, device=dev)
        return make

    def split(make, T, plain):
        loss_fn, theta0 = make(T, plain)
        theta = {k: v.detach().clone().requires_grad_(True) for k, v in theta0.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(theta)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(loss, list(theta.values()))
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    out = {}
    for label, make, T in (
        ("cascade-PID tuner", pid, PID_TUNE_T),
        ("fused MPC tuner", mpc(fused_base, FlightLoopConfig(use_fused_tick=True,
                                                             ticks_per_dispatch=K_TICKS)),
         MPC_TUNE_T),
        ("staged MPC tuner", mpc(LinearMPCConfig(), FlightLoopConfig(use_pallas_plant=True)),
         MPC_TUNE_T),
    ):
        split(make, TUNE_SHORT_T, False)                    # warm
        rec = {"kernel_short": split(make, TUNE_SHORT_T, False),
               "plain_short": split(make, TUNE_SHORT_T, True)}
        full = ""
        if label == "cascade-PID tuner":
            rec["kernel_full"] = split(make, T, False)
            full = (f"; kernel route at {T} ticks {rec['kernel_full'][0]:.3f}/"
                    f"{rec['kernel_full'][1]:.3f}")
        out[label] = rec
        print(f"{label} iteration seconds (forward/backward) at {TUNE_SHORT_T} ticks: kernel "
              f"route {rec['kernel_short'][0]:.3f}/{rec['kernel_short'][1]:.3f}, plain route "
              f"{rec['plain_short'][0]:.3f}/{rec['plain_short'][1]:.3f}{full}")
    launches = TUNE_SHORT_T // K_TICKS
    fwd, bwd = out["fused MPC tuner"]["kernel_short"]
    out["fused MPC tuner"]["backward_ms_per_k5_launch"] = 1e3 * bwd / launches
    print(f"  fused MPC tuner: backward (the staged twin's VJP) {1e3 * bwd / launches:.1f} ms per "
          f"K5 launch of {K_TICKS} ticks, forward {1e3 * fwd / launches:.1f} ms")
    return out


# ---- the last three TPU kernels (K14, K15, K16) and the plant block -------

TAIL_TOL = 2e-5               # K14, K16 and the plant block, of each output's scale
# K15 against its plain version, of sigma^2. The distance form cancels
# |z1|^2 + |z2|^2 against 2 z1.z2; on the Gram's diagonal (and at
# near-duplicate points) both are ~2 |z|^2, up to ~150 at the corpus's
# width (10 features / 0.5), where one float32 ulp is 1.5e-5. The plain
# version rounds each z^2 before summing and takes the cross term from a
# matrix product, so its diagonal distance is off by a few ulps; the
# kernel forms |z|^2 and z.z with the same fused chain, so its diagonal
# distance is exactly 0. On the H100 the two differ by 1.52e-5 of sigma^2 at
# 800 points and 2.28e-5 at 19,800. So the kernel is held to its plain
# version within GRAM_TOL and, on a block of rows that holds the diagonal,
# to a float64 evaluation of the same formula within TAIL_TOL.
GRAM_TOL = 5e-5
GRAM_F64_ROWS = 1024
MC_B = 256                    # the campaign's population (tools/run_campaign.py:336-365)
GRAM_SHAPES = ((800, 800), (19800, 19800))   # the GP refit's points; the full corpus
GRAM_D = 10
ADMM_RHO, ADMM_RELAX, ADMM_ITERS_DEFAULT = 8.0, 1.6, 80   # LinearMPCConfig() defaults


def ops_explicit_admm(n: int, m: int, iterations: int) -> int:
    """FP32 operations of K14 (csrc/single_tick_kernels.cu, an FMA counts
    2): per iteration rhs (2 m n + n), u (2 n^2), Gu (2 m n) and ~12 per
    constraint row; then the final rhs and u."""
    return iterations * (4 * m * n + 2 * n * n + n + 12 * m) + 2 * m * n + 2 * n * n + n


def ops_gram(n1: int, n2: int, d: int) -> int:
    """FP32 operations of K15 (csrc/rbf_kernels.cu): per entry the d-term
    dot, the distance (4) and the scale and expf (2); the rows' scaling and
    norms."""
    return n1 * n2 * (2 * d + 6) + (n1 + n2) * 3 * d


def ops_fused_batched(B: int, N: int, iterations: int) -> int:
    """FP32 operations of K16 (csrc/controller_kernels.cu) for B flights:
    the two shift products (4 m^2) and K3's controller tick per flight."""
    m = 10 * N
    return B * (4 * m * m + ops_controller(N, iterations))


K16_BATCHES = (1, 17, MC_B, MC_B + 1)


def k16_operands(gen, N: int, B: int, f32: dict):
    """K16's per-flight operands for B flights around the 3 m hover: states,
    disturbance rows and one shared reference row."""
    import torch

    X0 = torch.zeros(B, 6)
    X0[:, 0:3] = torch.randn(B, 3, generator=gen)
    X0[:, 2] += 3.0
    X0[:, 3:6] = 0.5 * torch.randn(B, 3, generator=gen)
    W = (0.02 * torch.randn(B, 6 * N, generator=gen)).to(**f32)
    REF = torch.tensor([3.0, 0.0, 3.0, 0.0, 0.0, 0.0]).repeat(N)[None].to(**f32)
    return X0.to(**f32).contiguous(), W, REF


K14_PAD = 128                 # the JAX tests' QP on 128 lanes (tests/test_pallas_ops.py)
K14_HORIZONS = (20, LONG_HORIZON, 30, 40)   # N=30: slices from shared memory; 40: through L2


def k14_operands(dev, gen, N=None) -> tuple:
    """K14's operands: the staged MPC's QP at horizon N (``LinearMPC``'s own
    M^-1 and G, the state off the reference so that boxes bind, z0 and y0
    drawn from ``gen``; 80 iterations, rho 8, relaxation 1.6), or, with N
    None, the JAX tests' QP (n=24, m=40, numpy seed 14) zero-padded to 128
    lanes (300 iterations, rho 10), whose padded lanes stay exactly 0."""
    import numpy as np
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig

    f32 = dict(dtype=torch.float32, device=dev)
    if N is None:
        rng = np.random.default_rng(14)
        n, m = 24, 40
        Q = rng.normal(size=(n, n))
        G = np.vstack([np.eye(n), rng.normal(size=(m - n, n))])
        Mp, Gp = np.zeros((K14_PAD, K14_PAD)), np.zeros((K14_PAD, K14_PAD))
        Mp[:n, :n] = np.linalg.inv(Q @ Q.T + n * np.eye(n) + 10.0 * G.T @ G)
        Gp[:m, :n] = G
        pad = lambda v: torch.tensor(np.concatenate([v, np.zeros(K14_PAD - len(v))]), **f32)
        dense = lambda a: torch.tensor(a, **f32).contiguous()
        zeros = torch.zeros(K14_PAD, **f32)
        return (dense(Mp), dense(Gp), dense(Gp.T), pad(rng.normal(size=n) * 50),
                pad(-0.5 * np.ones(m)), pad(0.5 * np.ones(m)), zeros, zeros.clone(), 10.0, 300,
                ADMM_RELAX)
    mpc = LinearMPC(LinearMPCConfig(horizon=N), device=dev)
    m = mpc.n_constraints
    x0 = torch.tensor([2.0, -1.5, 1.0, 1.0, -0.5, 0.3], **f32)
    ref = torch.tensor([0.0, 0.0, 3.0, 0.0, 0.0, 0.0], **f32).repeat(N)
    offset = mpc._Sx @ x0
    G = mpc._G.contiguous()
    return (mpc._M_inv.contiguous(), G, G.T.contiguous(),
            (mpc._SuT_q @ (offset - ref)).contiguous(),
            torch.cat([mpc._u_lo, mpc._x_lo - offset]).contiguous(),
            torch.cat([mpc._u_hi, mpc._x_hi - offset]).contiguous(),
            (0.1 * torch.randn(m, generator=gen)).to(**f32),
            (0.1 * torch.randn(m, generator=gen)).to(**f32), ADMM_RHO, ADMM_ITERS_DEFAULT,
            ADMM_RELAX)


def check_tail_kernels(dev, gen, fail_fn) -> dict:
    """Hold K14, K15 and K16, and K1 and K2 on a dispersed (256, 10) plant
    block, against their plain versions on the card at the system's shapes,
    each within TAIL_TOL of its outputs' scale with a second launch
    bit-identical, and time them. Returns the kernels' entries."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.gp.kernels import rbf_kernel
    from unmanned_aerial_vehicles_tpu_torch.ops import (
        _cuda,
        admm_pallas,
        controller_pallas,
        plant_pallas,
        rbf_pallas,
    )

    f32 = dict(dtype=torch.float32, device=dev)
    out = {}

    def held(label, got, want, again, tol=TAIL_TOL):
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"{label}: max_abs_err of scale {max(errs):.3e} (by output "
              + ", ".join(f"{e:.2e}" for e in errs) + f"), second launch bit-identical {same}")
        if not max(errs) <= tol:
            fail_fn(f"{label} disagrees with its plain version: {errs}")
        if not same:
            fail_fn(f"{label}: a second launch differs")
        return max(errs)

    # K14 at the staged MPC's QP (LinearMPC's own M^-1 and G), N=20 and N=25
    # (the register slices), N=30 (the slices from shared memory) and N=40
    # (through L2), and on the JAX tests' QP padded to 128 lanes
    k14 = {}
    for N in (*K14_HORIZONS, None):
        args = k14_operands(dev, gen, N)
        (Minv, G, GT, f, lower, upper, z0, y0), iters = args[:8], args[9]
        n, m = Minv.shape[0], G.shape[0]
        fn = lambda: admm_pallas.admm_box_qp_fused(*args)
        plain = lambda: admm_pallas.admm_box_qp_fused_plain(*args)
        got = fn()
        torch.cuda.synchronize()
        label = f"N={N}" if N is not None else f"the JAX tests' QP on {K14_PAD} lanes"
        err = held(f"K14 admm_box_qp_fused ({label}, n={n}, m={m}, {iters} iterations)",
                   got, plain(), fn())
        if N is None and not all(bool((v[k:] == 0).all()) for v, k in zip(got, (24, 40, 40))):
            fail_fn("K14 on the padded QP: a padded lane is not exactly 0")
        variant, shared, _ = admm_pallas.explicit_variant(dev, n, m)
        with _cuda.library_variant("single_tick", "single_tick_clocks"):
            admm_pallas.explicit_section_cycles()
            fn()
            torch.cuda.synchronize()
            cycles = admm_pallas.explicit_section_cycles()
        per_pass = {k: v / (iters + 1) for k, v in cycles.items()
                    if k not in ("whole launch", "set-up")}
        k14[N] = dict(
            err=err, ms=graph_ms(fn, 20), plain_ms=graph_ms(plain, 2),
            host_ms=cuda_ms(fn, 50), host_plain_ms=cuda_ms(plain, 5),
            bound=bound_ms(nbytes(Minv, G, f, lower, upper, z0, y0) + 4 * (n + 2 * m),
                           ops_explicit_admm(n, m, iters)),
            variant=("slices in registers, {1} columns a lane, {2} rows of M^-1".format(
                *admm_pallas.EXPLICIT_REG_VARIANTS[variant - 1]) if variant else
                     "slices from shared memory" if shared else "slices through L2"),
            cycles_per_pass=per_pass, cycles_whole=cycles["whole launch"],
            cycles_setup=cycles["set-up"],
        )
        print(f"  K14 at {label}: {k14[N]['ms'] * 1e3:.2f} us per launch ({k14[N]['variant']}), "
              f"plain {k14[N]['plain_ms'] * 1e3:.2f} us; clock cycles per pass (thread 0, the "
              f"build with section clocks) " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                         per_pass.items())
              + f"; whole launch {cycles['whole launch']}, set-up {cycles['set-up']}")
    out["admm_box_qp_fused"] = dict(k14[LONG_HORIZON], n20=k14[20], padded=k14[None],
                                    memory={N: k14[N] for N in K14_HORIZONS[2:]})

    # K15 at the GP refit's 800 x 800 x 10 and the corpus's 19,800^2 x 10,
    # isotropic and ARD, on seeded synthetic inputs
    ard = (0.3 + 1.2 * torch.rand(GRAM_D, generator=gen)).to(**f32)
    iso, sig = torch.tensor(0.5, **f32), torch.tensor(1.3, **f32)   # on the card: no copies
    k15 = {}
    for n1, n2 in GRAM_SHAPES:
        X1 = torch.randn(n1, GRAM_D, generator=gen).to(**f32)
        X2 = X1 if n1 == n2 else torch.randn(n2, GRAM_D, generator=gen).to(**f32)
        errs = []
        for ls, label in ((iso, "isotropic"), (ard, "ARD")):
            args = (X1, X2, ls, sig)
            got = rbf_pallas.rbf_kernel_matrix_pallas(*args)
            torch.cuda.synchronize()
            plain = rbf_pallas.rbf_kernel_matrix_plain(*args)
            what = f"K15 rbf_kernel_matrix_pallas ({n1} x {n2} x {GRAM_D}, {label})"
            errs.append(held(what, (got,), (plain,),
                             (rbf_pallas.rbf_kernel_matrix_pallas(*args),), tol=GRAM_TOL))
            if n1 == n2 and not bool((got.diagonal() == sig).all()):
                fail_fn(f"{what}: a diagonal entry (coincident points) is not exactly sigma^2")
            rows = slice(0, GRAM_F64_ROWS)
            exact = rbf_kernel(X1[rows].double(), X2.double(), ls.double(), sig.double())
            e_kernel, e_plain = rel_err(got[rows].double(), exact), rel_err(plain[rows].double(), exact)
            print(f"  against float64 on rows 0:{GRAM_F64_ROWS}: kernel {e_kernel:.3e}, plain "
                  f"{e_plain:.3e} of scale")
            if not e_kernel <= TAIL_TOL:
                fail_fn(f"{what} is {e_kernel} of scale from the float64 values")
            del got, plain, exact
        fn = lambda: rbf_pallas.rbf_kernel_matrix_pallas(X1, X2, iso, sig)
        plain = lambda: rbf_pallas.rbf_kernel_matrix_plain(X1, X2, iso, sig)
        Z1, Z2 = X1 / 0.5, X2 / 0.5
        cdist = lambda: torch.cdist(Z1, Z2).square_().mul_(-0.5).exp_()
        small = n1 * n2 < 10**7
        out_buf = torch.empty(n1, n2, **f32)
        fill = lambda: out_buf.fill_(1.0)   # the card's write rate on the same bytes
        k15[n1] = dict(
            err=max(errs), ms=graph_ms(fn, 20) if small else cuda_ms(fn, 10),
            plain_ms=graph_ms(plain, 5) if small else cuda_ms(plain, 5),
            host_ms=cuda_ms(fn, 50 if small else 5), host_plain_ms=cuda_ms(plain, 5),
            cdist_ms=cuda_ms(cdist, 10 if small else 5),
            fill_ms=graph_ms(fill, 20) if small else cuda_ms(fill, 10),
            bound=bound_ms(nbytes(X1, X2) + 4 * (GRAM_D + 1) + 4 * n1 * n2,
                           ops_gram(n1, n2, GRAM_D)),
        )
        print(f"  K15 at {n1} x {n2}: {k15[n1]['ms'] * 1e3:.2f} us per launch, plain "
              f"{k15[n1]['plain_ms'] * 1e3:.2f} us, torch.cdist + square/scale/exp (in place) "
              f"{k15[n1]['cdist_ms'] * 1e3:.2f} us, bound {k15[n1]['bound'][0] * 1e3:.2f} us "
              f"({k15[n1]['bound'][1]}), fill_ of the same output {k15[n1]['fill_ms'] * 1e3:.2f} "
              f"us")
        del out_buf
        torch.cuda.empty_cache()
    (small, _), (corpus, _) = GRAM_SHAPES
    out["rbf_kernel_matrix_pallas"] = dict(k15[small], n800=k15[small], corpus=k15[corpus])
    # a ragged shape (n1 past a tile, n2 not a multiple of 4), and coincident
    # points far from the origin (exactly sigma^2, every pair of them)
    X1 = torch.randn(801, GRAM_D, generator=gen).to(**f32)
    X2 = torch.randn(257, GRAM_D, generator=gen).to(**f32)
    for ls, label in ((iso, "isotropic"), (ard, "ARD")):
        args = (X1, X2, ls, sig)
        got = rbf_pallas.rbf_kernel_matrix_pallas(*args)
        torch.cuda.synchronize()
        held(f"K15 rbf_kernel_matrix_pallas (801 x 257 x {GRAM_D}, {label})", (got,),
             (rbf_pallas.rbf_kernel_matrix_plain(*args),),
             (rbf_pallas.rbf_kernel_matrix_pallas(*args),), tol=GRAM_TOL)
    X = (30.0 * torch.randn(64, GRAM_D, generator=gen)).to(**f32)
    X[32:] = X[:32]
    K = rbf_pallas.rbf_kernel_matrix_pallas(X, X, ard, sig)
    same = torch.cat([torch.arange(64), torch.arange(32), torch.arange(32, 64)])
    pair = torch.cat([torch.arange(64), torch.arange(32, 64), torch.arange(32)])
    exact = bool((K[same, pair] == sig).all())
    print(f"K15 on coincident points (64 x 64, every row twice, 30 times the corpus's spread, "
          f"ARD): every coincident pair exactly sigma^2 {exact}")
    if not exact:
        fail_fn("K15: a pair of coincident points is not exactly sigma^2")

    # K16 at B = 1, 17, 256 and 257 (a lone flight, a ragged tile, the
    # population, one flight past it), N=20 and N=25, three warm-started
    # ticks each; timed at the population's B=256
    k16 = {}
    for N in (20, LONG_HORIZON):
        mpc = LinearMPC(LinearMPCConfig(horizon=N, use_fused_controller=True), device=dev)
        data = mpc._tick_data
        m = 10 * N
        errs = []
        for B in K16_BATCHES:
            X0, W, REF = k16_operands(gen, N, B, f32)
            Z = torch.zeros(B, m, **f32)
            Y = torch.zeros(B, m, **f32)
            for tick in range(3):
                args = (data, data.ShiftT, X0, W, REF, Z, Y, ADMM_RHO, ADMM_ITERS_DEFAULT,
                        ADMM_RELAX)
                got = controller_pallas.gpmpc_controller_fused_batched(*args)
                torch.cuda.synchronize()
                errs.append(held(f"K16 gpmpc_controller_fused_batched (B={B}, N={N}, tick {tick})",
                                 got, controller_pallas.gpmpc_controller_fused_batched_plain(*args),
                                 controller_pallas.gpmpc_controller_fused_batched(*args)))
                Z, Y = got[0], got[1]
            if B == MC_B:
                population = (X0, W, REF, Z, Y)
        X0, W, REF, Z, Y = population
        args = (data, data.ShiftT, X0, W, REF, Z, Y, ADMM_RHO, ADMM_ITERS_DEFAULT, ADMM_RELAX)
        fn = lambda: controller_pallas.gpmpc_controller_fused_batched(*args)
        plain = lambda: controller_pallas.gpmpc_controller_fused_batched_plain(*args)
        cluster, smem, active = controller_pallas.fused_cluster_choice(dev, MC_B, N)
        ins = (data.ShiftT, data.SxSwT, data.SuTqT, data.PM, data.P1, data.P0matT, data.SuT,
               data.lo_row, data.hi_row, X0, W, REF, Z, Y)
        k16[N] = dict(
            err=max(errs), ms=graph_ms(fn, 10), plain_ms=graph_ms(plain, 2),
            host_ms=cuda_ms(fn, 20), host_plain_ms=cuda_ms(plain, 3),
            bound=bound_ms(nbytes(*ins) + 4 * MC_B * (2 * m + 10 * N),
                           ops_fused_batched(MC_B, N, ADMM_ITERS_DEFAULT)),
            cluster=cluster, flights=controller_pallas.FUSED_TILE_FLIGHTS, active=active,
            smem=smem,
        )
        print(f"  K16 at B={MC_B}, N={N}: {k16[N]['ms'] * 1e3:.2f} us per launch, plain "
              f"{k16[N]['plain_ms'] * 1e3:.2f} us, bound {k16[N]['bound'][0] * 1e3:.2f} us "
              f"({k16[N]['bound'][1]}); clusters of C={cluster} blocks x F="
              f"{controller_pallas.FUSED_TILE_FLIGHTS} flights, {smem} B of shared memory a "
              f"block, {active} such clusters run at once "
              f"({len(controller_pallas.fused_flight_tiles(MC_B))} needed)")
    out["gpmpc_controller_fused_batched"] = dict(k16[LONG_HORIZON], n20=k16[20])

    # K1 and K2 on a dispersed (256, 10) plant block (one row per flight)
    mass = 0.5 * torch.exp(0.1 * torch.randn(MC_B, generator=gen))
    hover = torch.exp(0.03 * torch.randn(MC_B, generator=gen))
    block = torch.stack([
        mass, torch.full((MC_B,), 9.81), 0.25 * torch.exp(0.3 * torch.randn(MC_B, generator=gen)),
        *(tau * torch.exp(0.2 * torch.randn(MC_B, generator=gen)) for tau in (0.05, 0.05, 0.08)),
        9.81 / hover, *(0.8 * torch.randn(3, MC_B, generator=gen)),
    ], dim=1).to(**f32).contiguous()
    s = torch.randn(MC_B, 12, generator=gen)
    s[:, 6:9] = (torch.rand(MC_B, 3, generator=gen) - 0.5) * 1.2
    s[:, 9:12] *= 0.5
    s = s.to(**f32).contiguous()
    c = torch.cat([0.6 + 0.7 * torch.rand(MC_B, 1, generator=gen),
                   torch.randn(MC_B, 3, generator=gen)], 1).to(**f32).contiguous()
    cmd = torch.cat([2.0 * torch.randn(MC_B, 3, generator=gen), torch.randn(MC_B, 1, generator=gen),
                     6.0 * (torch.rand(MC_B, 1, generator=gen) - 0.5),
                     torch.where(torch.rand(MC_B, 1, generator=gen) < 0.5, 1.2, 1.5)],
                    1).to(**f32).contiguous()
    integ = (0.6 * (torch.rand(MC_B, 3, generator=gen) - 0.5)).to(**f32).contiguous()
    k1 = lambda: (plant_pallas._px4_plant_rows(s, c, block, 0.02, 2),)
    k2 = lambda: plant_pallas._allocation_plant_rows(s, cmd, integ, block, 0.02, 2)
    got = k1()
    torch.cuda.synchronize()
    plant_errs = {"K1": held(f"K1 on a ({MC_B}, 10) plant block", got,
                             (plant_pallas.px4_plant_step_plain(s, c, block, 0.02, 2),), k1())}
    got = k2()
    torch.cuda.synchronize()
    plant_errs["K2"] = held(f"K2 on a ({MC_B}, 10) plant block", got,
                            plant_pallas.allocation_plant_tick_plain(s, cmd, integ, block, 0.02, 2),
                            k2())
    plant_ms = {"K1": graph_ms(k1, 200), "K2": graph_ms(k2, 200)}
    print(f"  the plant block at B={MC_B}: K1 {plant_ms['K1'] * 1e3:.2f} us, K2 "
          f"{plant_ms['K2'] * 1e3:.2f} us per launch")
    return out, dict(errs=plant_errs, ms=plant_ms, block=block)


# ---- K8 and K4 (with K3 and K6) against their plain versions ----------------

def figure8_launch(dev):
    """The main path's state and reference at one K5 launch of the
    figure-8 (t = 10 s, K=20 ticks): ``(x0 (12,), pos (K, 3), yaw (K,),
    refs (K, N 6))``."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.zeros(12, **f32)
    x0[:3] = torch.tensor([0.3, -0.2, 2.9])
    x0[3:9] = torch.tensor([0.5, 0.2, -0.1, 0.05, -0.03, 0.1])
    pos, yaw = ramped_figure8_reference(10.0 + 0.02 * torch.arange(K_TICKS, **f32))
    pos = pos + torch.tensor([0.0, 0.0, 3.0], **f32)
    refs = torch.cat([pos, torch.zeros(K_TICKS, 3, **f32)], 1).repeat(1, HORIZON).contiguous()
    return x0, pos, yaw.contiguous(), refs


def print_sections(label: str, sections: dict, whole: str) -> None:
    total = sections[whole]
    print(f"{label}: " + "; ".join(f"{name} {c:.0f} ({c / total:.1%})"
                                   for name, c in sections.items()))


def check_k8(dev, mpc, refs, gen, fail_fn) -> dict:
    """K8 at the sweep's width (B=1024, N=20, 10 iterations) from random
    planes (a few slacks on their boxes): all six outputs within ``K8_TOL``
    of the plain version, a second launch bit-identical, its device time,
    and its cycles per block by section from the build with section clocks."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, controller_pallas

    f32 = dict(dtype=torch.float32, device=dev)
    B, Nnu, Nnx = SWEEP_B, HORIZON * 4, HORIZON * 6
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
        fail_fn("K8 produced non-finite values")
    k8_fn = lambda: controller_pallas.gpmpc_controller_structured_batched(*k8_args)
    k8_plain = lambda: controller_pallas.gpmpc_controller_structured_batched_plain(*k8_args)
    k8 = dict(
        err=k8_err,
        ms=graph_ms(k8_fn, 20), plain_ms=graph_ms(k8_plain, 2, replays=3),
        host_ms=cuda_ms(k8_fn, 50), host_plain_ms=cuda_ms(k8_plain, 5, warmup=1),
        bound=bound_ms(nbytes(*(a for a in k8_args if torch.is_tensor(a)), *sdata[:10])
                       + nbytes(*got), B * ops_structured_controller(HORIZON, ADMM_ITERS)),
    )
    print(f"K8 gpmpc_controller_structured_batched: max_abs_err {k8_err:.3e} over the six "
          f"outputs (B={B}, N={HORIZON}, {ADMM_ITERS} iterations); shared memory "
          f"{controller_pallas.structured_shared_memory_bytes(HORIZON)} B per block; device "
          f"{k8['ms'] * 1e3:.2f} us per launch, bound {k8['bound'][0] * 1e3:.4f} us")
    if not k8_err <= K8_TOL:
        fail_fn(f"K8 disagrees with its plain version: {k8_err}")
    again = k8_fn()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail_fn("K8: a second launch on the same inputs differs")
    # an odd horizon (SuT's rows copied by the threads, the last X tile
    # partial) and a batch with a tail tile of one flight
    N25, B25 = LONG_HORIZON, 8 * 32 + 1
    m25 = LinearMPC(LinearMPCConfig(horizon=N25, admm_iterations=ADMM_ITERS,
                                    use_fused_controller=True), device=dev)
    sd25 = controller_pallas.build_structured_batch_data(
        m25._fc_data, N25, 4, 6, m25._u_lo, m25._u_hi, m25._x_lo, m25._x_hi, device=dev)
    X25 = rnd(B25, 6)
    X25[:, 2] += 3.0
    ref25 = torch.cat([refs[:1, :3], torch.zeros(1, 3, **f32)], 1).repeat(1, N25).contiguous()
    a25 = (sd25, X25, rnd(B25, 6 * N25, scale=0.02), ref25, rnd(B25, 4 * N25, scale=3.0),
           rnd(B25, 6 * N25), rnd(B25, 4 * N25), rnd(B25, 6 * N25), 8.0, ADMM_ITERS, 1.6)
    got25 = controller_pallas.gpmpc_controller_structured_batched(*a25)
    torch.cuda.synchronize()
    want25 = controller_pallas.gpmpc_controller_structured_batched_plain(*a25)
    k8["err_n25_b257"] = max(float((g - w).abs().max()) for g, w in zip(got25, want25))
    again25 = controller_pallas.gpmpc_controller_structured_batched(*a25)
    print(f"K8 at N={N25}, B={B25}: max_abs_err {k8['err_n25_b257']:.3e}")
    if not (k8["err_n25_b257"] <= K8_TOL
            and all(bool(torch.isfinite(g).all()) for g in got25)
            and all(torch.equal(a, b) for a, b in zip(got25, again25))):
        fail_fn(f"K8 at N={N25}, B={B25} disagrees with its plain version or with itself: "
                f"{k8['err_n25_b257']}")
    k8["err"] = max(k8_err, k8["err_n25_b257"])
    with _cuda.library_variant("controller", "controller_clocks"):
        controller_pallas.structured_section_cycles()
        k8_fn()
        torch.cuda.synchronize()
        blocks = -(-B // controller_pallas.FLIGHTS_PER_BLOCK)
        k8["sections"] = {k: v / blocks
                          for k, v in controller_pallas.structured_section_cycles().items()}
    print_sections("K8 clock cycles per block by section (build with section clocks; the "
                   "ADMM phases summed over the iterations)", k8["sections"], "whole launch")
    return k8


def check_single_tick(dev, mpc, x0, pos, gen, prow, fail_fn) -> dict:
    """K4, K3 and K6 at N=20 and N=25 against their plain versions
    (``SINGLE_TOL`` on every output; K4 also with ``ctrl_state``, a
    ``tight`` row and the hover fallback engaged; K6 on P1's factors, as
    ``LinearMPC`` calls it, and on P1, without ``SuT``), each timed, with
    its bound (K3's and K6's also in the P1 form, ``bound_p1_form``), and
    the cycles by section of K4, K3 and K6 (on the factors) from the build
    with section clocks at both horizons: the ``kernels`` entries, keyed by
    name."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.ops import (
        _cuda,
        admm_pallas,
        controller_pallas,
        tick_pallas,
    )

    f32 = dict(dtype=torch.float32, device=dev)
    rnd = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(**f32).contiguous()
    fail = fail_fn
    tick_statics = dict(rho=8.0, iterations=ADMM_ITERS, over_relax=1.6, dt=0.02, substeps=2,
                        accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0),
                        yawrate_limit=0.8)

    def single_tick_cases(N):
        """K4's, K3's and K6's inputs at horizon N from seeded random draws
        around a hovering flight near the figure-8, and K6's SuT."""
        tm = mpc if N == HORIZON else LinearMPC(LinearMPCConfig(
            horizon=N, admm_iterations=ADMM_ITERS, use_fused_controller=True), device=dev)
        am = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=ADMM_ITERS,
                                       use_fused_admm=True), device=dev)
        m, Nnu, Nnx = 10 * N, 4 * N, 6 * N
        state = x0.clone()
        w = torch.cat([torch.zeros(N, 3), 0.02 * torch.randn(N, 3, generator=gen)], 1)
        ref = torch.cat([pos[:1], torch.zeros(1, 3, **f32)], 1).repeat(1, N).reshape(-1)
        misc = torch.tensor([0.1, 0.02, -0.01, 0.03], **f32)
        z, y = rnd(m, scale=0.3), rnd(m, scale=0.1)
        k4 = (tm._tick_data, state, w.reshape(-1).to(**f32), ref.contiguous(), misc, z, y, prow)
        k3 = (tm._tick_data, state[:6].contiguous(), *k4[2:4], z, y, 8.0, ADMM_ITERS, 1.6)
        f = torch.randn(Nnu, generator=gen).to(**f32)
        off = rnd(Nnx, scale=0.3)
        k6 = (am._P1_f32, (-(am._GMinv @ f)).contiguous(), am._GMinvT_f32,
              (am._M_inv @ f).contiguous(),
              torch.cat([am._u_lo, am._x_lo - off]), torch.cat([am._u_hi, am._x_hi - off]),
              z, y, 8.0, ADMM_ITERS, 1.6)
        # K4 with the controller reading an estimate, tightened boxes and
        # the hover fallback engaged (0.5 m from its reference)
        tight = torch.zeros(m, **f32)
        tight[Nnu:] = 0.2 * torch.rand(Nnx, generator=gen).to(dev)
        cover = dict(ctrl_state=(state + rnd(12, scale=0.05)).contiguous(), tight=tight,
                     fallback_error_m=0.3)
        return k4, k3, k6, am._SuT_f32, cover

    def max_err(got, want):
        for g in got:
            if not torch.isfinite(g).all():
                fail("a single-tick kernel produced non-finite values")
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    def clocks(fn, read):
        with _cuda.library_variant("single_tick", "single_tick_clocks"):
            read()
            fn()
            torch.cuda.synchronize()
            return read()

    single = {}
    for N in (HORIZON, LONG_HORIZON):
        k4_args, k3_args, k6_args, SuT, cover = single_tick_cases(N)
        kw = dict(tick_statics, n=N)
        # the stacked device operands K3 and K4 read (FusedTickData: SxSwT
        # through hi_row; ShiftT is a gather in the kernel); K3 reads P1's
        # factors P0matT and SuT, not P1
        tick_data = list(k4_args[0][2:10])
        k3_data = [t for t in tick_data if t is not k4_args[0].P1]
        operands = lambda args: [a for a in args if torch.is_tensor(a)]
        k6_factored = [SuT if t is k6_args[0] else t for t in operands(k6_args)]
        ops_k4 = ops_controller(N, ADMM_ITERS)
        # name: (kernel, plain, tensors read, operations, the P1 form's
        # (tensors, operations) or None, the section clocks' reader or None)
        runs = {
            "gpmpc_tick_fused": (
                lambda a=k4_args, kw=kw: tick_pallas.gpmpc_tick_fused(*a, **kw),
                lambda a=k4_args, kw=kw: tick_pallas.gpmpc_tick_fused_plain(*a, **kw),
                operands(k4_args) + tick_data, ops_k4 + OPS_ALLOCATION + 2 * OPS_RK4_SUBSTEP,
                None, tick_pallas.single_tick_section_cycles),
            "gpmpc_controller_fused": (
                lambda a=k3_args: controller_pallas.gpmpc_controller_fused(*a),
                lambda a=k3_args: controller_pallas.gpmpc_controller_fused_plain(*a),
                operands(k3_args) + k3_data, ops_controller(N, ADMM_ITERS, factored=True),
                (operands(k3_args) + tick_data, ops_k4),
                controller_pallas.controller_section_cycles),
            "admm_box_qp_fused_composite": (
                lambda a=k6_args, s=SuT: admm_pallas.admm_box_qp_fused_composite(*a, SuT=s),
                lambda a=k6_args: admm_pallas.admm_box_qp_fused_composite_plain(*a),
                k6_factored, ops_admm(10 * N, 4 * N, ADMM_ITERS, factored=True),
                (operands(k6_args), ops_admm(10 * N, 4 * N, ADMM_ITERS)),
                admm_pallas.composite_section_cycles),
            # K6 without SuT: the kernel on P1, for a general G
            "admm_box_qp_fused_composite on P1": (
                lambda a=k6_args: admm_pallas.admm_box_qp_fused_composite(*a),
                lambda a=k6_args: admm_pallas.admm_box_qp_fused_composite_plain(*a),
                operands(k6_args), ops_admm(10 * N, 4 * N, ADMM_ITERS), None, None),
        }
        for name, (fn, plain, tensors, n_ops, p1_form, read_clocks) in runs.items():
            got = fn()
            torch.cuda.synchronize()
            err = max_err(got, plain())
            again = fn()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{name} at N={N}: a second launch on the same inputs differs")
            if name == "gpmpc_tick_fused":
                kw_cover = dict(kw, **cover)
                got = tick_pallas.gpmpc_tick_fused(*k4_args, **kw_cover)
                torch.cuda.synchronize()
                want = tick_pallas.gpmpc_tick_fused_plain(*k4_args, **kw_cover)
                lo, hi = (torch.tensor(v, **f32) for v in (tick_statics["accel_lo"],
                                                           tick_statics["accel_hi"]))
                mpc_cmd = torch.minimum(torch.maximum(want[1][0:3], lo), hi)
                if not float((want[0][22:25] - mpc_cmd).abs().max()) > 1e-3:
                    fail("K4's coverage case did not engage the hover fallback")
                err = max(err, max_err(got, want))
            rec = dict(err=err, ms=graph_ms(fn, 20), plain_ms=graph_ms(plain, 1, replays=3),
                       host_ms=cuda_ms(fn, 50), host_plain_ms=cuda_ms(plain, 3, warmup=1),
                       bound=bound_ms(nbytes(*tensors) + nbytes(*got), n_ops))
            if p1_form is not None:
                rec["bound_p1_form"] = bound_ms(nbytes(*p1_form[0]) + nbytes(*got), p1_form[1])
            single[(name, N)] = rec
            if read_clocks is not None:
                rec["sections"] = clocks(fn, read_clocks)
                print_sections(f"{name} clock cycles by section at N={N} (build with section "
                               "clocks)", rec["sections"], "whole launch")
            if name == "gpmpc_tick_fused" or name.endswith("on P1"):
                variant = "P1 in shared memory" if N <= 23 else "P1 through L2"
            else:
                variant = "P1's factors' slices in registers"
            p1_text = ("" if p1_form is None else
                       f"; the P1 form's bound {rec['bound_p1_form'][0] * 1e3:.4f} us")
            print(f"{name} (N={N}, {variant}): max_abs_err {err:.3e}; device "
                  f"{rec['ms'] * 1e3:.2f} us per launch, plain {rec['plain_ms'] * 1e3:.2f} us; "
                  f"with host overhead {rec['host_ms'] * 1e3:.2f} us; bound "
                  f"{rec['bound'][0] * 1e3:.4f} us ({rec['bound'][1]}){p1_text}")
            if not err <= SINGLE_TOL:
                fail(f"{name} at N={N} disagrees with its plain version: {err}")
    # K3 and K6 past the register slices' reach (N=25): the factors read
    # through L2 every step
    _, k3_args, k6_args, SuT, _ = single_tick_cases(L2_FACTOR_HORIZON)
    for name, fn, plain in (
            ("gpmpc_controller_fused",
             lambda: controller_pallas.gpmpc_controller_fused(*k3_args),
             lambda: controller_pallas.gpmpc_controller_fused_plain(*k3_args)),
            ("admm_box_qp_fused_composite",
             lambda: admm_pallas.admm_box_qp_fused_composite(*k6_args, SuT=SuT),
             lambda: admm_pallas.admm_box_qp_fused_composite_plain(*k6_args))):
        got = fn()
        torch.cuda.synchronize()
        err = max_err(got, plain())
        if not all(torch.equal(a, b) for a, b in zip(got, fn())):
            fail(f"{name} at N={L2_FACTOR_HORIZON}: a second launch on the same inputs differs")
        single[(name, L2_FACTOR_HORIZON)] = dict(err=err, ms=graph_ms(fn, 20))
        print(f"{name} (N={L2_FACTOR_HORIZON}, P1's factors through L2): max_abs_err {err:.3e}; "
              f"device {single[(name, L2_FACTOR_HORIZON)]['ms'] * 1e3:.2f} us per launch")
        if not err <= SINGLE_TOL:
            fail(f"{name} at N={L2_FACTOR_HORIZON} disagrees with its plain version: {err}")
    out = {}
    for name in ("gpmpc_tick_fused", "gpmpc_controller_fused", "admm_box_qp_fused_composite"):
        errs = [rec["err"] for (key, N), rec in single.items() if key == name]
        out[name] = dict(single[(name, HORIZON)], err=max(errs), long=single[(name, LONG_HORIZON)])
        if (name, L2_FACTOR_HORIZON) in single:
            out[name]["l2"] = single[(name, L2_FACTOR_HORIZON)]
    out["admm_box_qp_fused_composite"]["p1"] = {
        N: single[("admm_box_qp_fused_composite on P1", N)] for N in (HORIZON, LONG_HORIZON)}
    print(f"shared memory per block: K4 "
          f"{tick_pallas.single_tick_shared_memory_bytes(HORIZON)} B at N={HORIZON}, "
          f"{tick_pallas.single_tick_shared_memory_bytes(LONG_HORIZON, False)} B at "
          f"N={LONG_HORIZON}; K3 "
          f"{controller_pallas.controller_shared_memory_bytes(HORIZON)} B and "
          f"{controller_pallas.controller_shared_memory_bytes(LONG_HORIZON)} B; K6 on the "
          f"factors "
          f"{admm_pallas.factored_shared_memory_bytes(4 * HORIZON, 10 * HORIZON)} B and "
          f"{admm_pallas.factored_shared_memory_bytes(4 * LONG_HORIZON, 10 * LONG_HORIZON)} B, "
          f"on P1 {admm_pallas.shared_memory_bytes(10 * HORIZON)} B and "
          f"{admm_pallas.shared_memory_bytes(10 * LONG_HORIZON, False)} B")
    return out


# ---- the redesigned kernels, against an older checkout ----------------------

def main_path_k5_k9_operands(dev, mpc, post, prow):
    """K5's operands at the main path's shape (the online figure-8 launch:
    N=20, P=800, K=20, 10 ADMM iterations) from a seeded draw, and K9's for
    the online-noisy flight (the 12-state EKF) over them: ``(k5_args,
    k9_args, statics)``, public wrappers' arguments only."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.estimation import EKFConfig
    from unmanned_aerial_vehicles_tpu_torch.ops import tick_pallas
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

    f32 = dict(dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(11)
    rnd = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(**f32)
    m, Nnx = mpc.n_constraints, HORIZON * 6
    x0 = torch.zeros(12, **f32)
    x0[:3] = torch.tensor([0.3, -0.2, 2.9])
    x0[3:9] = torch.tensor([0.5, 0.2, -0.1, 0.05, -0.03, 0.1])
    aux = torch.cat([x0[:6] + 0.01, torch.tensor([0.02, -0.01, 0.03], **f32)]).contiguous()
    xtail = (x0[:6].repeat(HORIZON) + rnd(Nnx, scale=0.05)).contiguous()
    z0, y0 = rnd(m, scale=0.3).contiguous(), rnd(m, scale=0.1).contiguous()
    pos, yaw = ramped_figure8_reference(10.0 + 0.02 * torch.arange(K_TICKS, **f32))
    pos = pos + torch.tensor([0.0, 0.0, 3.0], **f32)
    refs = torch.cat([pos, torch.zeros(K_TICKS, 3, **f32)], 1).repeat(1, HORIZON).contiguous()
    gp = tick_pallas.build_gp_rows(post, 0.1)
    statics = dict(k_ticks=K_TICKS, use_gp=True, rho=8.0, iterations=ADMM_ITERS, over_relax=1.6,
                   dt=0.02, substeps=2, accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0),
                   yawrate_limit=0.8, n=HORIZON, nu=4, nx=6)
    ekf = EKFConfig()
    r9 = ekf.r_diag(dev)
    est = (x0 + rnd(12, scale=0.02)).contiguous()
    A = rnd(12, 12, scale=0.02)
    P = (torch.diag(ekf.p0_diag(dev)) + A @ A.T).contiguous()
    aux13 = torch.cat([est[:6] + 0.01, torch.tensor([0.02, -0.01, 0.03, 1.02, 0.1, -0.05, 0.03],
                                                    **f32)]).contiguous()
    noise = (torch.sqrt(r9) * rnd(K_TICKS, 9)).contiguous()
    k5_args = (mpc._tick_data, gp, x0, aux, xtail, z0, y0, refs, yaw.contiguous(), prow)
    k9_args = (mpc._tick_data, gp, x0, est, P, aux13, xtail, z0, y0, refs, yaw.contiguous(),
               noise, prow[None].contiguous(), ekf.q_diag(dev), r9)
    return k5_args, k9_args, statics


def time_k4_k8(dev) -> dict:
    """Device microseconds per launch of K4 at N=20 (P1 in shared memory)
    and N=25 (P1 through L2), and of K8 at the sweep's B=1024 (N=20, 10
    iterations), through the public wrappers, on seeded operands around
    the figure-8: the first keys of ``time_redesigned``."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.ops import controller_pallas, plant_pallas, tick_pallas

    f32 = dict(dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(12)
    rnd = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(**f32).contiguous()
    prow = plant_pallas.build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81,
                                        (0.8, 0.4, 0.0), device=dev)
    x0, pos, _, refs = figure8_launch(dev)
    statics = dict(rho=8.0, iterations=ADMM_ITERS, over_relax=1.6, dt=0.02, substeps=2,
                   accel_lo=(-3.5, -3.5, -4.0), accel_hi=(3.5, 3.5, 6.0), yawrate_limit=0.8)
    out = {}
    for N in (HORIZON, LONG_HORIZON):
        mpc = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=ADMM_ITERS,
                                        use_fused_controller=True), device=dev)
        if N == HORIZON:
            mpc20 = mpc
        w = torch.cat([torch.zeros(N, 3, **f32), rnd(N, 3, scale=0.02)], 1).reshape(-1)
        ref = torch.cat([pos[:1], torch.zeros(1, 3, **f32)], 1).repeat(1, N).reshape(-1)
        args = (mpc._tick_data, x0, w.contiguous(), ref.contiguous(),
                torch.tensor([0.1, 0.02, -0.01, 0.03], **f32), rnd(10 * N, scale=0.3),
                rnd(10 * N, scale=0.1), prow)
        out[f"k4_n{N}_us"] = graph_ms(
            lambda: tick_pallas.gpmpc_tick_fused(*args, n=N, **statics), 20) * 1e3
    B, Nnu, Nnx = SWEEP_B, HORIZON * 4, HORIZON * 6
    sdata = controller_pallas.build_structured_batch_data(
        mpc20._fc_data, HORIZON, 4, 6, mpc20._u_lo, mpc20._u_hi, mpc20._x_lo, mpc20._x_hi,
        device=dev)
    X0 = rnd(B, 6)
    X0[:, 2] += 3.0
    k8_args = (sdata, X0, rnd(B, Nnx, scale=0.02), refs[:1].contiguous(),
               rnd(B, Nnu, scale=3.0), rnd(B, Nnx), rnd(B, Nnu), rnd(B, Nnx), 8.0, ADMM_ITERS, 1.6)
    out["k8_b1024_us"] = graph_ms(
        lambda: controller_pallas.gpmpc_controller_structured_batched(*k8_args), 20) * 1e3
    return out


def time_k3_k6(dev) -> dict:
    """Device microseconds per launch of K3 and K6 at N=20 and N=25 (10
    iterations), through the public wrappers, each checkout's operands from
    its own ``LinearMPC`` on seeded draws around the figure-8: K6 as
    ``LinearMPC`` calls it (``k6_n*_us``: with ``SuT`` where the MPC holds
    it) and without ``SuT`` (``k6_p1_n*_us``: the kernel on P1)."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.ops import admm_pallas, controller_pallas

    f32 = dict(dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(13)
    rnd = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(**f32).contiguous()
    x0, pos, _, _ = figure8_launch(dev)
    out = {}
    for N in (HORIZON, LONG_HORIZON):
        m, Nnu, Nnx = 10 * N, 4 * N, 6 * N
        cm = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=ADMM_ITERS,
                                       use_fused_controller=True), device=dev)
        w = torch.cat([torch.zeros(N, 3, **f32), rnd(N, 3, scale=0.02)], 1).reshape(-1)
        ref = torch.cat([pos[:1], torch.zeros(1, 3, **f32)], 1).repeat(1, N).reshape(-1)
        z, y = rnd(m, scale=0.3), rnd(m, scale=0.1)
        k3 = (cm._tick_data, x0[:6].contiguous(), w.contiguous(), ref.contiguous(), z, y, 8.0,
              ADMM_ITERS, 1.6)
        out[f"k3_n{N}_us"] = graph_ms(lambda: controller_pallas.gpmpc_controller_fused(*k3),
                                      20) * 1e3
        am = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=ADMM_ITERS,
                                       use_fused_admm=True), device=dev)
        f = rnd(Nnu)
        off = rnd(Nnx, scale=0.3)
        k6 = (am._P1_f32, (-(am._GMinv @ f)).contiguous(), am._GMinvT_f32,
              (am._M_inv @ f).contiguous(), torch.cat([am._u_lo, am._x_lo - off]),
              torch.cat([am._u_hi, am._x_hi - off]), z, y, 8.0, ADMM_ITERS, 1.6)
        SuT = getattr(am, "_SuT_f32", None)
        kw = {} if SuT is None else {"SuT": SuT}
        out[f"k6_n{N}_us"] = graph_ms(
            lambda: admm_pallas.admm_box_qp_fused_composite(*k6, **kw), 20) * 1e3
        out[f"k6_p1_n{N}_us"] = graph_ms(
            lambda: admm_pallas.admm_box_qp_fused_composite(*k6), 20) * 1e3
    return out


def k2_operands(gen, B: int, f32: dict, dispersed: bool = False):
    """K2's operands for a batch of B: random states (roll and yaw across
    the +-pi wrap; pitch kept off the Euler-rate singularity, where
    1/cos(theta) would amplify float32 rounding), commands, integrals, and
    the shared plant row or a dispersed (B, 10) block (the Monte Carlo
    population's)."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.ops import plant_pallas

    s = torch.randn(B, 12, generator=gen)
    s[:, 6] = (torch.rand(B, generator=gen) - 0.5) * 7.0
    s[:, 7] = (torch.rand(B, generator=gen) - 0.5) * 1.2
    s[:, 8] = (torch.rand(B, generator=gen) - 0.5) * 7.0
    s[:, 9:12] *= 0.5
    cmd = torch.cat([2.0 * torch.randn(B, 3, generator=gen), torch.randn(B, 1, generator=gen),
                     6.0 * (torch.rand(B, 1, generator=gen) - 0.5),
                     torch.where(torch.rand(B, 1, generator=gen) < 0.5, 1.2, 1.5)], 1)
    integ = 0.6 * (torch.rand(B, 3, generator=gen) - 0.5)
    if dispersed:
        plant = torch.stack([
            0.5 * torch.exp(0.1 * torch.randn(B, generator=gen)), torch.full((B,), 9.81),
            0.25 * torch.exp(0.3 * torch.randn(B, generator=gen)),
            *(tau * torch.exp(0.2 * torch.randn(B, generator=gen)) for tau in (0.05, 0.05, 0.08)),
            9.81 / torch.exp(0.03 * torch.randn(B, generator=gen)),
            *(0.8 * torch.randn(3, B, generator=gen))], dim=1)
    else:
        plant = plant_pallas.build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81,
                                             (0.8, 0.4, 0.0), device=f32["device"])
    return tuple(t.to(**f32).contiguous() for t in (s, cmd, integ, plant))


K1_CASES = (("B=1", 1, False), ("B=17", 17, False), ("B=1024", 1024, False),
            ("B=4096", 4096, False), ("(256, 10) block", 256, True))


def k1_operands(gen, B: int, f32: dict, plant=None):
    """K1's operands for a batch of B: ``k2_operands``' states, controls
    (thrust 0.6-1.3, body rates), and ``plant`` or, if None, a dispersed
    (B, 10) plant block."""
    import torch

    s, _, _, block = k2_operands(gen, B, f32, dispersed=plant is None)
    c = torch.cat([0.6 + 0.7 * torch.rand(B, 1, generator=gen),
                   torch.randn(B, 3, generator=gen)], 1).to(**f32).contiguous()
    return s, c, block if plant is None else plant


def time_k7_k2(dev, post) -> dict:
    """Device microseconds per launch of K7 at the sweep's width (20480
    queries, a quarter within 0.2 of a training point, against the
    800-point GP) and of K2 at B=1, on a dispersed (256, 10) plant block
    and at B=1024, on seeded operands; K2's outputs (B=1024 and the block)
    go to a file named by ``_k2_outputs``, so that the caller can hold one
    checkout's K2 against another's on the same inputs."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.ops import plant_pallas, rbf_pallas

    f32 = dict(dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(14)
    mq = SWEEP_B * HORIZON
    Xq = torch.randn(mq, 10, generator=gen).to(**f32)
    near = torch.randint(0, GP_POINTS, (mq // 4,), generator=gen).to(dev)
    Xq[: mq // 4] = post.X_train[near] + 0.2 * torch.randn(mq // 4, 10, generator=gen).to(**f32)
    Xq = Xq.contiguous()
    gp_ops = rbf_pallas.posterior_mean_operands(post)
    out = {"k7_us": graph_ms(lambda: rbf_pallas.rbf_posterior_mean_pallas(gp_ops, Xq), 20) * 1e3}
    outputs = {}
    for key, B, dispersed in (("k2_b1_us", 1, False), ("k2_b256_dispersed_us", MC_B, True),
                              ("k2_b1024_us", SWEEP_B, False)):
        ops = k2_operands(gen, B, f32, dispersed)
        call = lambda: plant_pallas._allocation_plant_rows(*ops, 0.02, 2)
        outputs[key] = [t.cpu() for t in call()]
        out[key] = graph_ms(call, 200) * 1e3
    fd, path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    torch.save(outputs, path)
    out["_k2_outputs"] = path
    return out


def time_k1_k12(dev) -> dict:
    """Device microseconds per launch of K1 at B=1, on a dispersed (256, 10)
    plant block and at B=1024, and of K12 at the controller's width (512 x
    25), on seeded operands; the outputs go to a file named by
    ``_k1_k12_outputs``, so that the caller can hold one checkout's K1 and
    K12 against another's on the same inputs."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control import MPPIController
    from unmanned_aerial_vehicles_tpu_torch.ops import mppi_pallas, plant_pallas

    f32 = dict(dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(15)
    prow = plant_pallas.build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81,
                                        (0.8, 0.4, 0.0), device=dev)
    out, outputs = {}, {}
    for key, B, dispersed in (("k1_b1_us", 1, False), ("k1_b256_dispersed_us", MC_B, True),
                              ("k1_b1024_us", SWEEP_B, False)):
        s, c, plant = k1_operands(gen, B, f32, None if dispersed else prow)
        call = lambda: plant_pallas._px4_plant_rows(s, c, plant, 0.02, 2)
        outputs[key] = [call().cpu()]
        out[key] = graph_ms(call, 200) * 1e3
    ctrl = MPPIController(device=dev)
    args = k12_operands(gen, ctrl, ctrl.config.num_samples, ctrl.config.horizon, f32)
    call = lambda: mppi_pallas.mppi_rollout_costs_fused(*args)
    outputs["k12_us"] = [call().cpu()]
    out["k12_us"] = graph_ms(call, 20) * 1e3
    fd, path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    torch.save(outputs, path)
    out["_k1_k12_outputs"] = path
    return out


def time_k13b_k10(dev) -> dict:
    """Device microseconds per launch of K13b at B=1 and B=1024 (on
    ``vjp_operands``; also the kernel alone, ``plant_grad=False``, without
    the plant row's batch sum; K13a's outputs on the same operands are
    saved beside K13b's) and of K10 at n=1 and n=20
    (``k10_timed_operands``),
    on seeded operands; the outputs go to a file named by
    ``_k13b_k10_outputs``, with those of K10's checked rollouts
    (``k10_cases``: n=1 and 20, substeps 1 and 2, with and without
    residuals, the Euler-rate singularity), so that the caller can hold one
    checkout's K13b and K10 against another's on the same inputs."""
    import dataclasses

    import torch

    from unmanned_aerial_vehicles_tpu_torch.models.params import GZ_QUADROTOR_PARAMS, X500_PARAMS
    from unmanned_aerial_vehicles_tpu_torch.ops import plant_pallas, rigid_plant_pallas, tick_ad

    f32 = dict(dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(16)
    wind = (0.8, 0.4, 0.0)
    prow = plant_pallas.build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81, wind,
                                        device=dev)
    out, outputs = {}, {}
    for B in (1, 1024):
        s, c, cmd, integ, ct_s, ct_c, ct_i = vjp_operands(gen, B, wind, f32)
        outputs[f"k13a_b{B}"] = [t.cpu() for t in tick_ad.px4_plant_step_vjp(s, c, prow, ct_s,
                                                                              0.02, 2)]
        call = lambda: tick_ad.allocation_plant_tick_vjp(s, cmd, integ, prow, ct_s, ct_c, ct_i,
                                                         0.02, 2)
        key = f"k13b_b{B}_us"
        outputs[key] = [t.cpu() for t in call()]
        out[key] = graph_ms(call, 200) * 1e3
        # the kernel alone: no plant-row cotangent, so no batch sum
        out[f"k13b_b{B}_kernel_only_us"] = graph_ms(
            lambda: tick_ad.allocation_plant_tick_vjp(s, cmd, integ, prow, ct_s, ct_c, ct_i, 0.02,
                                                      2, plant_grad=False), 200) * 1e3
    x1, u1, U20 = k10_timed_operands(f32)
    for key, U, params, dt in (("k10_n1_us", u1, X500_PARAMS, 0.02),
                               ("k10_n20_us", U20, GZ_QUADROTOR_PARAMS, 0.1)):
        call = lambda: rigid_plant_pallas.rigid_body_rollout_fused(x1, U, params, dt)
        outputs[key] = [call().cpu()]
        out[key] = graph_ms(call, 200 if U.shape[0] == 1 else 50) * 1e3
    body = dataclasses.replace(GZ_QUADROTOR_PARAMS, wind=K10_BODY_WIND)
    rows = []
    for x0, U, res, dt, substeps in k10_cases(lambda *shape: torch.randn(*shape, generator=gen)):
        rows.append(rigid_plant_pallas.rigid_body_rollout_fused(
            x0.to(**f32), U.to(**f32).contiguous(), body, dt, substeps,
            None if res is None else res.to(**f32).contiguous()).cpu())
        if res is not None:   # the same rollout without its residuals
            rows.append(rigid_plant_pallas.rigid_body_rollout_fused(
                x0.to(**f32), U.to(**f32).contiguous(), body, dt, substeps).cpu())
    outputs["k10_checked_rollouts"] = rows
    fd, path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    torch.save(outputs, path)
    out["_k13b_k10_outputs"] = path
    return out


def time_k14_k15(dev) -> dict:
    """Device microseconds per launch of K14 at N=20, N=25, on the JAX
    tests' QP padded to 128 lanes and, past the register slices, at N=30
    and N=40 (``k14_operands``) and of K15 at 800 x
    800 and 19,800^2 x 10 (isotropic, seeded points), through the public
    wrappers; the outputs go to a file named by ``_k14_k15_outputs`` (K15's
    corpus every 199th row), so that the caller can hold one checkout's K14
    and K15 against another's on the same inputs."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.ops import admm_pallas, rbf_pallas

    f32 = dict(dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(17)
    out, outputs = {}, {}
    for key, N in (("k14_n20_us", 20), ("k14_n25_us", LONG_HORIZON), ("k14_pad128_us", None),
                   ("k14_n30_us", 30), ("k14_n40_us", 40)):
        args = k14_operands(dev, gen, N)
        call = lambda: admm_pallas.admm_box_qp_fused(*args)
        outputs[key] = [t.cpu() for t in call()]
        out[key] = graph_ms(call, 20) * 1e3
    iso, sig = torch.tensor(0.5, **f32), torch.tensor(1.3, **f32)
    for (n, _), key in zip(GRAM_SHAPES, ("k15_800_us", "k15_19800_us")):
        X = torch.randn(n, GRAM_D, generator=gen).to(**f32)
        call = lambda: rbf_pallas.rbf_kernel_matrix_pallas(X, X, iso, sig)
        K = call()
        outputs[key] = [(K if n < 10**4 else K[::199]).cpu()]
        del K
        out[key] = (graph_ms(call, 20) if n < 10**4 else cuda_ms(call, 10)) * 1e3
        torch.cuda.empty_cache()
    fd, path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    torch.save(outputs, path)
    out["_k14_k15_outputs"] = path
    return out


def outputs_difference(older: str, this: str) -> dict:
    """Per timing key, whether two checkouts' outputs saved by ``time_k7_k2``,
    ``time_k1_k12``, ``time_k13b_k10`` or ``time_k14_k15`` agree bit for bit,
    or their largest difference (both files are removed)."""
    import torch

    a, b = torch.load(older), torch.load(this)
    os.unlink(older)
    os.unlink(this)
    diff = {}
    for k in a:
        if all(torch.equal(x, y) for x, y in zip(a[k], b[k])):
            diff[k] = "bit-identical"
        else:
            worst = max(float((x - y).abs().max()) for x, y in zip(a[k], b[k]))
            diff[k] = f"largest difference {worst:.3e}"
    return diff


SWEEP_SHARE_T = 50    # the sweep's profiler window (ticks)


def sweep_shares(dev, post) -> dict:
    """The 1024-flight sweep (``gp_posterior``, ``gp_every`` 1, N=20, 10
    iterations) as phase 4 flies it: microseconds per tick (slope between
    200 and 700 ticks), device-busy microseconds per tick from a
    ``torch.profiler`` window of ``SWEEP_SHARE_T`` ticks (device events
    only), the idle share in percent, and K8's, K7's and K2's device
    microseconds per tick in that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig
    from unmanned_aerial_vehicles_tpu_torch.loop import batched_mpc_flight_sweep
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

    f32 = dict(dtype=torch.float32, device=dev)
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ADMM_ITERS,
                                    use_fused_controller=True), device=dev)

    def ref(t):
        p, y = ramped_figure8_reference(t, 6.0, 0.02)
        return p + torch.tensor([0.0, 0.0, 3.0], dtype=p.dtype, device=p.device), y

    starts = torch.zeros(SWEEP_B, 12, **f32)
    starts[:, 2] = 3.0
    starts[:, 0] = torch.linspace(-1.0, 1.0, SWEEP_B, **f32)
    fly = lambda T: batched_mpc_flight_sweep(mpc, ref, T, starts, device=dev, gp_posterior=post,
                                             gp_cfg=ResidualGPConfig())
    tick_us = slope_us(fly, T_SWEEP_SLOPE)
    fly(SWEEP_SHARE_T)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fly(SWEEP_SHARE_T)
        torch.cuda.synchronize()
    events = [(e.key, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    per_tick = lambda part: sum(t for k, t in events if part in k) / SWEEP_SHARE_T
    busy = per_tick("")
    return {"sweep_us_per_tick": tick_us, "sweep_busy_us_per_tick": busy,
            "sweep_idle_pct": 100.0 * (1.0 - busy / tick_us),
            "sweep_k8_us_per_tick": per_tick("structured_batched_kernel"),
            "sweep_k7_us_per_tick": per_tick("rbf_posterior_mean_kernel"),
            "sweep_k2_us_per_tick": per_tick("allocation_plant_tick_kernel")}


STAGED_SHARE_T = 50   # the staged flights' profiler window (ticks)


def staged_shares(dev, post) -> dict:
    """The 100-tick staged flights of phase 3 through K3 and K6 (N=20, 10
    iterations, the 800-point GP as ``residual_fn``): microseconds per tick
    (slope between 50 and 150 ticks), device-busy microseconds per tick from
    a ``torch.profiler`` window of ``STAGED_SHARE_T`` ticks (device events
    only) and the idle share in percent."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
        ResidualGPConfig,
        build_horizon_residuals,
    )
    from unmanned_aerial_vehicles_tpu_torch.loop import mpc_flight_rollout
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

    def ref(t):
        p, yaw = ramped_figure8_reference(t, 6.0, 0.02)
        return p + torch.tensor([0.0, 0.0, 3.0], dtype=p.dtype, device=p.device), yaw

    gp_cfg = ResidualGPConfig()
    resid = lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gp_cfg)
    out = {}
    for key, mode in (("k3", "use_fused_controller"), ("k6", "use_fused_admm")):
        sm = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ADMM_ITERS,
                                       **{mode: True}), device=dev)
        fly = lambda T, sm=sm: mpc_flight_rollout(sm, ref, T, residual_fn=resid, device=dev)
        tick_us = slope_us(fly, (50, 150))
        fly(STAGED_SHARE_T)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fly(STAGED_SHARE_T)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / STAGED_SHARE_T
        out[f"staged_{key}_us_per_tick"] = tick_us
        out[f"staged_{key}_busy_us_per_tick"] = busy
        out[f"staged_{key}_idle_pct"] = 100.0 * (1.0 - busy / tick_us)
    return out


MPPI_SHARE_T = 100    # the mppi12 flight's profiler window (ticks)


def mppi12_shares(dev) -> dict:
    """The staged mppi12 flight as phase 4 flies it: microseconds per tick
    (slope over T_SLOPE_12's lengths), device-busy microseconds per tick
    from a ``torch.profiler`` window of ``MPPI_SHARE_T`` ticks (device events
    only), the idle share in percent, and K12's and K10's device
    microseconds per tick in that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fly = lambda T: mppi12_flight(dev, T)
    tick_us = slope_us(fly, T_SLOPE_12)
    fly(MPPI_SHARE_T)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fly(MPPI_SHARE_T)
        torch.cuda.synchronize()
    events = [(e.key, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    per_tick = lambda part: sum(t for k, t in events if part in k) / MPPI_SHARE_T
    busy = per_tick("")
    return {"mppi12_us_per_tick": tick_us, "mppi12_busy_us_per_tick": busy,
            "mppi12_idle_pct": 100.0 * (1.0 - busy / tick_us),
            "mppi12_k12_us_per_tick": per_tick("mppi_costs_kernel"),
            "mppi12_k10_us_per_tick": per_tick("rigid_rollout_kernel")}


def time_end_to_end(dev) -> dict:
    """The host-bound paths of K8, K4, K5 and K12 as phase 4 flies them: the
    sweep's microseconds per flight-tick (B=1024, ``gp_posterior``,
    ``gp_every`` 1), the single-tick tick's (``residual_fn``), the online
    tick's and the staged mppi12 tick's, through the public entry points
    only."""
    import numpy as np
    import torch

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
    )
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

    f32 = dict(dtype=torch.float32, device=dev)
    mpc20 = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ADMM_ITERS,
                                      use_fused_controller=True), device=dev)
    rng = np.random.default_rng(0)
    post = fit_residual_gp(torch.tensor(rng.normal(size=(GP_POINTS, 10)), **f32),
                           torch.tensor(0.05 * rng.normal(size=(GP_POINTS, 6)), **f32),
                           ResidualGPConfig())
    out = {}

    def ref(t):
        p, y = ramped_figure8_reference(t, 6.0, 0.02)
        return p + torch.tensor([0.0, 0.0, 3.0], dtype=p.dtype, device=p.device), y

    starts = torch.zeros(SWEEP_B, 12, **f32)
    starts[:, 2] = 3.0
    starts[:, 0] = torch.linspace(-1.0, 1.0, SWEEP_B, **f32)
    out["sweep_us_per_flight_tick"] = slope_us(
        lambda T: batched_mpc_flight_sweep(mpc20, ref, T, starts, device=dev, gp_posterior=post,
                                           gp_cfg=ResidualGPConfig()), T_SWEEP_SLOPE) / SWEEP_B
    gp_cfg = ResidualGPConfig()
    out["single_tick_us_per_tick"] = slope_us(
        lambda T: mpc_flight_rollout(
            mpc20, ref, T, cfg=FlightLoopConfig(use_fused_tick=True), device=dev,
            residual_fn=lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gp_cfg)), T_SLOPE)
    # and the online tick (K5, whose solve K4 now shares)
    ogp = OnlineFusedGPConfig(gp=ResidualGPConfig(max_data_points=GP_POINTS), refit_every=250)
    out["online_us_per_tick"] = slope_us(
        lambda T: mpc_flight_rollout(
            mpc20, ref, T, cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=K_TICKS),
            online_gp=ogp, gp_gain=0.1, device=dev), T_SLOPE)
    # and the staged mppi12 tick (K12 and K10)
    out["mppi12_us_per_tick"] = slope_us(lambda T: mppi12_flight(dev, T), T_SLOPE_12)
    return out


def time_redesigned(dev) -> dict:
    """Device microseconds per launch of the redesigned kernels, through
    their public wrappers only, so that the same function times an older
    checkout of the package: K4 and K8 (``time_k4_k8``), K3 and K6
    (``time_k3_k6``), K16 at B=256,
    N=20 and N=25 (three warm-started ticks in, 80 iterations), K5 at N=20,
    P=800, K=8, tightened
    (kappa 2) and not, K5 and K9 at the main path's shape (N=20, P=800,
    K=20: the online and the online-noisy flights' launches), K11 at both
    plants (``k11_case``: the checkout's own relinearisation and layout),
    K7 and K2 (``time_k7_k2``), the sweep's device-busy share
    (``sweep_shares``), K13a at B=1 and 1024, the staged flights
    through K3 and K6 (``staged_shares``: their ticks and device-busy
    shares), K1 and K12 (``time_k1_k12``), the mppi12 flight's device-busy
    share (``mppi12_shares``), K13b and K10 (``time_k13b_k10``), and K14
    and K15 (``time_k14_k15``)."""
    import numpy as np
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig, fit_residual_gp
    from unmanned_aerial_vehicles_tpu_torch.ops import (
        controller_pallas,
        plant_pallas,
        rigid_tick_pallas,
        tick_ad,
        tick_pallas,
    )

    out = time_k4_k8(dev)
    out.update(time_k3_k6(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(9)
    for N in (20, LONG_HORIZON):
        mpc = LinearMPC(LinearMPCConfig(horizon=N, use_fused_controller=True), device=dev)
        data = mpc._tick_data
        X0, W, REF = k16_operands(gen, N, MC_B, f32)
        zy = [torch.zeros(MC_B, 10 * N, **f32), torch.zeros(MC_B, 10 * N, **f32)]
        call = lambda: controller_pallas.gpmpc_controller_fused_batched(
            data, data.ShiftT, X0, W, REF, zy[0], zy[1], ADMM_RHO, ADMM_ITERS_DEFAULT, ADMM_RELAX)
        for _ in range(3):
            zy[:] = call()[:2]
        out[f"k16_n{N}_us"] = graph_ms(call, 10) * 1e3
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ADMM_ITERS,
                                    use_fused_controller=True), device=dev)
    rng = np.random.default_rng(0)
    post = fit_residual_gp(torch.tensor(rng.normal(size=(GP_POINTS, 10)), **f32),
                           torch.tensor(0.05 * rng.normal(size=(GP_POINTS, 6)), **f32),
                           ResidualGPConfig())
    prow = plant_pallas.build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81,
                                        (0.8, 0.4, 0.0), device=dev)
    args, statics = tightened_case(dev, mpc, post, prow, K5_PREVIEW_K)
    for key, kappa in (("k5_tightened_us", TIGHTEN_KAPPA), ("k5_untightened_us", 0.0)):
        out[key] = graph_ms(lambda: tick_pallas.gpmpc_multitick_fused(
            *args, **dict(statics, tighten_kappa=kappa)), 20) * 1e3
    k5_args, k9_args, statics = main_path_k5_k9_operands(dev, mpc, post, prow)
    out["k5_main_us"] = graph_ms(
        lambda: tick_pallas.gpmpc_multitick_fused(*k5_args, **statics), 20) * 1e3
    out["k9_online_noisy_us"] = graph_ms(
        lambda: tick_pallas.gpmpc_noisy_multitick_fused(*k9_args, **statics), 20) * 1e3
    for plant in ("direct_rate", "rigid"):
        args, statics = k11_case(dev, plant)
        out[f"k11_{plant}_us"] = graph_ms(
            lambda: rigid_tick_pallas.direct_rate_multitick_kernel(*args, **statics), 5) * 1e3
    out.update(time_k7_k2(dev, post))
    out.update(sweep_shares(dev, post))
    for B in (1, 1024):
        s, c, ct = (t.to(**f32).contiguous() for t in (
            0.3 * torch.randn(B, 12, generator=gen) + torch.tensor([0, 0, 3.0] + [0] * 9),
            torch.cat([1.0 + 0.1 * torch.randn(B, 1, generator=gen),
                       0.3 * torch.randn(B, 3, generator=gen)], 1),
            torch.randn(B, 12, generator=gen)))
        out[f"k13a_b{B}_us"] = graph_ms(
            lambda: tick_ad.px4_plant_step_vjp(s, c, prow, ct, 0.02, 2), 200) * 1e3
    out.update(staged_shares(dev, post))
    out.update(time_k1_k12(dev))
    out.update(mppi12_shares(dev))
    out.update(time_k13b_k10(dev))
    out.update(time_k14_k15(dev))
    return out


E2E_PAIRS = 10     # the end-to-end ticks, older and this checkout in pairs


def sign_test_min(pairs: int) -> int:
    """The fewest pairs of ``pairs`` that must differ in one direction for
    the two-sided sign test to reject "no difference" at 5 %."""
    for k in range(pairs // 2 + 1, pairs + 1):
        if 2 * sum(math.comb(pairs, j) for j in range(k, pairs + 1)) / 2 ** pairs <= 0.05:
            return k
    return pairs + 1


class TimingWorker:
    """``chip_smoke.py --time-redesigned ROOT`` in a process of its own,
    importing the package under ROOT, kept alive to time on request."""

    def __init__(self, root: str | Path):
        self.root = Path(root).resolve()
        self.log = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--time-redesigned", str(self.root)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log, text=True)

    def ask(self, request: str) -> dict:
        self.proc.stdin.write(request + "\n")
        self.proc.stdin.flush()
        for line in self.proc.stdout:
            if line.startswith("{"):
                return json.loads(line)
        self.log.seek(0)
        fail(f"timing the checkout at {self.root} failed:\n{self.log.read()[-3000:]}")

    def close(self) -> None:
        self.proc.stdin.close()
        self.proc.wait(timeout=60)
        self.log.close()


# the kernels whose code this checkout leaves alone: the libraries of K11,
# K12, K1/K2, K5, K9, K8/K16, K13a/K13b and K10, and beside K14 in its
# library K4, K3 and K6 (on the factors and on P1), beside K15 K7; a kernel
# beside changed ones is named "library:kernel"
SASS_KEPT = ("rigid_tick", "mppi", "plant", "tick", "noisy_tick", "controller", "plant_vjp",
             "rigid_plant", "single_tick:gpmpc_tick_kernel", "single_tick:controller_kernel",
             "single_tick:admm_factored_kernel", "single_tick:admm_composite_kernel",
             "rbf:rbf_posterior_mean_kernel")


def sass_difference(parent: str, names=SASS_KEPT) -> dict:
    """Per library, or per kernel as ``"library:kernel"``, whether the
    machine code (``cuobjdump -sass``) that the checkout at ``parent``
    built equals this checkout's, with the anonymous namespace's per-build
    hash masked and runs of blanks read as one (cuobjdump pads its columns
    to the longest line of the library); else the first line that differs.
    Call after both checkouts built their libraries."""
    import re
    import shutil

    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def sass(path, kernel):
        text = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                              check=True).stdout
        text = re.sub(r"_GLOBAL__N__[0-9a-f]+", "_GLOBAL__N__", text)
        text = re.sub(r"_cu_[0-9a-f]{8}", "_cu_", text)   # the source's hash in the name
        text = re.sub(r"[ \t]+", " ", text)
        if kernel:   # that kernel's block, from its "Function :" line to the next
            blocks = re.split(r"(?m)^(?=\s*Function : )", text)
            text = "".join(b for b in blocks if b.lstrip().startswith("Function : ")
                           and kernel in b.splitlines()[0])
        return text.splitlines()

    older_builds = sorted((Path(parent) / PKG / "_build").glob("*/"),
                          key=lambda d: d.stat().st_mtime)
    out = {}
    for name in names:
        lib, _, kernel = name.partition(":")
        older = sass(older_builds[-1] / f"lib{lib}.so", kernel)
        this = sass(_cuda._build_dir() / f"lib{lib}.so", kernel)
        if older == this and this:
            out[name] = f"identical ({len(this)} lines)"
        else:
            first = next((i for i, (a, b) in enumerate(zip(older, this)) if a != b),
                         min(len(older), len(this)))
            out[name] = (f"differs at line {first} of {len(this)} (older {len(older)}): "
                         f"{older[first] if first < len(older) else ''!r} -> "
                         f"{this[first] if first < len(this) else ''!r}")
    return out


def compare_with_parent(dev, parent: str | None):
    """K4, K8, K3, K6, K16, K5 (tightened and not), K9, K11, K7, K2, K13a,
    K1, K12, K13b, K10, K14 and K15 and the staged flights', the sweep's and
    the mppi12 flight's device-busy shares of the checkout at ``parent`` and
    of this one, each package in a process of its own built from its own
    sources, timed in turns in this call: parent, this, this, parent; K2's,
    K1's, K12's, K13a's, K13b's, K10's, K14's and K15's outputs of the two
    on the same inputs compared, and the machine code of the kernels whose
    code is kept (``sass_difference``). Then the sweep's,
    single-tick, online and mppi12 ticks in ``E2E_PAIRS`` pairs,
    alternating which checkout goes first, each called changed only where
    the sign test over the pairs says so."""
    if parent is None:
        print("older checkout's K4, K8, K3, K6, K16, K5, K9, K11, K7, K2, K13a, K1, K12, K13b, "
              "K10, K14 and K15 and its end-to-end ticks: not measured in this run (pass "
              "--parent DIR, DIR holding the older package, to time them here)")
        return None
    workers = {"older": TimingWorker(parent), "this": TimingWorker(ROOT)}
    try:
        order = ["older", "this", "this", "older"]
        runs = [workers[who].ask("kernels") for who in order]
        for key in runs[0]:
            if not key.startswith("_"):
                print(f"  {key}: " + ", ".join(f"{who} {r[key]:.2f}" for who, r in zip(order, runs)))
        against_older = {}
        for name in ("_k2_outputs", "_k1_k12_outputs", "_k13b_k10_outputs", "_k14_k15_outputs"):
            files = [r.pop(name) for r in runs]
            against_older.update(outputs_difference(files[0], files[1]))
            for path in files[2:]:
                os.unlink(path)
        print("  this checkout's outputs against the older one's on the same inputs (K2 at B=1, "
              "1024 and on the (256, 10) plant block, K1 likewise, K12 at 512 x 25, K13a and "
              "K13b at B=1 and 1024, K10 at n=1 and 20 and on its checked rollouts, K14 at N=20, "
              "25, 30, 40 and on 128 lanes, K15 at 800^2 and every 199th row at 19,800^2): "
              + "; ".join(f"{k.removesuffix('_us')} {v}" for k, v in against_older.items()))
        sass = sass_difference(parent)
        print("  machine code of the kernels whose code is kept, against the older "
              "checkout's (cuobjdump -sass, the anonymous namespace's hash masked): "
              + "; ".join(f"{k} {v}" for k, v in sass.items()))
        e2e = {"older": [], "this": []}
        for i in range(E2E_PAIRS):
            for who in ("older", "this") if i % 2 == 0 else ("this", "older"):
                e2e[who].append(workers[who].ask("end_to_end"))
    finally:
        for w in workers.values():
            w.close()
    need = sign_test_min(E2E_PAIRS)
    verdicts = {}
    for key in e2e["this"][0]:
        old, new = ([r[key] for r in e2e[who]] for who in ("older", "this"))
        lower = sum(n < o for n, o in zip(new, old))
        higher = sum(n > o for n, o in zip(new, old))
        verdicts[key] = ("lower" if lower >= need else "higher" if higher >= need
                         else "no difference resolved")
        print(f"  {key}, {E2E_PAIRS} pairs (older, this), odd pairs this first: "
              + "; ".join(f"{o:.5f}, {n:.5f}" for o, n in zip(old, new))
              + f"; this lower in {lower}, higher in {higher} (sign test needs {need}): "
              + verdicts[key])
    return {"order": order, "runs": runs, "end_to_end": e2e, "end_to_end_verdict": verdicts,
            "outputs_against_older": against_older, "sass_against_older": sass}


def time_redesigned_main(package_root: str) -> int:
    """``--time-redesigned DIR``: import the package under DIR and answer
    each line of standard input, ``kernels`` (time_redesigned) or
    ``end_to_end`` (time_end_to_end), with a line of JSON."""
    import torch

    sys.path.insert(0, str(Path(package_root).resolve()))
    import unmanned_aerial_vehicles_tpu_torch as pkg

    print(f"package: {Path(pkg.__file__).resolve().parent}", flush=True)
    timers = {"kernels": time_redesigned, "end_to_end": time_end_to_end}
    for request in sys.stdin:
        print(json.dumps(timers[request.strip()](torch.device("cuda"))), flush=True)
    return 0


# ---- the Monte Carlo robustness study (K16 with K2; K1) --------------------

# 10 s at 50 Hz, not the campaign's 30 (tools/run_campaign.py:343-365): since
# the population tiers joined, the plain twins (13-42 s each at 256 flights)
# and the lone K3 flights would push the run past its time limit at 1500
MC_T = 500
T_MC_SLOPE = (300, 1500)
MC_RMS_GAP_M = 1e-3           # per-flight RMS, kernel population vs plain, where both succeed
MC_LONE_FLIGHTS = 2           # population flights flown again alone through K3


def campaign_circle(t):
    """The campaign's circle: 6 m radius at 3 m (tools/run_campaign.py:278-281)."""
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_circle_reference

    pos, _, yaw = ramped_circle_reference(t, amplitude=6.0, height=3.0)
    return pos, yaw


def drive_entry_points(dev, fail_fn, kernels) -> None:
    """Drive K14 and K15 once each through their own entry points at the
    system's shapes (the staged MPC's QP at N=25; the GP refit's 800-point
    Gram) with the counts from 0, and record K15's launches (K14's come
    from its flight path, ``RK4DemoMPC``: ``run_orchestration``)."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, admm_pallas, rbf_pallas

    mpc = LinearMPC(LinearMPCConfig(), device=dev)
    m = mpc.n_constraints
    x0 = torch.tensor([2.0, -1.5, 1.0, 1.0, -0.5, 0.3], device=dev)
    ref = torch.tensor([0.0, 0.0, 3.0, 0.0, 0.0, 0.0], device=dev).repeat(mpc.config.horizon)
    offset = mpc._Sx @ x0
    X = torch.randn(800, GRAM_D, generator=torch.Generator().manual_seed(1)).to(dev)
    _cuda.reset_launch_counts()
    U, z, y = admm_pallas.admm_box_qp_fused(
        mpc._M_inv.contiguous(), mpc._G.contiguous(), mpc._G.T.contiguous(),
        (mpc._SuT_q @ (offset - ref)).contiguous(),
        torch.cat([mpc._u_lo, mpc._x_lo - offset]), torch.cat([mpc._u_hi, mpc._x_hi - offset]),
        torch.zeros(m, device=dev), torch.zeros(m, device=dev),
        mpc.config.admm_rho, mpc.config.admm_iterations, mpc.config.admm_over_relax)
    K = rbf_pallas.rbf_kernel_matrix_pallas(X, X, 0.5, 1.3)
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    for name in ("admm_box_qp_fused", "rbf_kernel_matrix_pallas"):
        if counts[name] != 1:
            fail_fn(f"{name} launched {counts[name]} times at its entry point, expected 1")
    kernels["rbf_kernel_matrix_pallas"]["launches"] = counts["rbf_kernel_matrix_pallas"]
    if not all(torch.isfinite(v).all() for v in (U, z, y, K)):
        fail_fn("K14 or K15 produced non-finite values at its entry point")
    print(f"K14 and K15 at their own entry points: launches {counts['admm_box_qp_fused']} "
          f"(the staged MPC's QP, N=25) and {counts['rbf_kernel_matrix_pallas']} (800-point "
          f"Gram); K14's U[0:4] {[round(float(v), 4) for v in U[:4]]}")


def run_populations(dev, fail_fn, kernels) -> dict:
    """Fly the campaign's three 256-flight populations (MC_T ticks on the
    6 m circle, wind 0.8 m/s): the MPC population (K16 and K2 every tick), the
    same with the 1.5 m hover fallback, and the PID population (K1 every
    tick), each against its plain twin (equal success flags; per-flight RMS
    within MC_RMS_GAP_M where both succeed), with exact launch counts; then
    fly MC_LONE_FLIGHTS flights of the MPC population alone through K3 and
    hold them to their population rows."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.loop import (
        FlightLoopConfig,
        MonteCarloConfig,
        monte_carlo_mpc,
        monte_carlo_pid,
        mpc_flight_rollout,
        robustness_stats,
        sample_conditions,
    )
    from unmanned_aerial_vehicles_tpu_torch.models import PID_CAMPAIGN_RATE_LOOP
    from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
    from unmanned_aerial_vehicles_tpu_torch.models.px4_surrogate import RateLoopParams
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda

    mc = MonteCarloConfig(n_rollouts=MC_B, wind_std=0.8)
    cond = sample_conditions(None, mc, device=dev)
    cond_pid = sample_conditions(None, mc, rate_loop=PID_CAMPAIGN_RATE_LOOP, device=dev)
    mpc = LinearMPC(LinearMPCConfig(use_fused_controller=True), device=dev)
    plant = FlightLoopConfig(use_pallas_plant=True)
    guard = FlightLoopConfig(use_pallas_plant=True, fallback_error_m=1.5)

    def fly_mpc(T, plain=False, cfg=plant):
        return monte_carlo_mpc(mpc, campaign_circle, T, mc=mc, loop_cfg=cfg, conditions=cond,
                               device=dev, plain_kernels=plain)

    def fly_pid(T, plain=False):
        return monte_carlo_pid(campaign_circle, T, mc=mc, rate_loop=PID_CAMPAIGN_RATE_LOOP,
                               loop_cfg=plant, conditions=cond_pid, device=dev,
                               plain_kernels=plain)

    pops = {
        "mpc": (lambda p: fly_mpc(MC_T, p),
                {"gpmpc_controller_fused_batched": MC_T, "allocation_plant_tick_fused": MC_T}),
        "mpc_fallback": (lambda p: fly_mpc(MC_T, p, guard),
                         {"gpmpc_controller_fused_batched": MC_T,
                          "allocation_plant_tick_fused": MC_T}),
        "pid": (lambda p: fly_pid(MC_T, p), {"px4_plant_step_fused": MC_T}),
    }
    scalars = ("success_rate", "rms_mean", "rms_p50", "rms_p90", "rms_p99", "worst_max_pos")
    results = {}
    for key, (fly, expected) in pops.items():
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        got = fly(False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: _cuda.launch_counts[k] for k in expected}
        t0 = time.perf_counter()
        want = fly(True)
        torch.cuda.synchronize()
        seconds_plain = time.perf_counter() - t0
        for name, n in expected.items():
            if counts[name] != n:
                fail_fn(f"population {key}: {name} launched {counts[name]} times, expected {n}")
        if key == "mpc":
            kernels["gpmpc_controller_fused_batched"]["launches"] = counts[
                "gpmpc_controller_fused_batched"]
        if not torch.equal(got["success"], want["success"]):
            fail_fn(f"population {key}: the kernel and plain twins disagree on which flights "
                    "succeed")
        both = got["success"] & want["success"]
        gap = float((got["rms_pos"] - want["rms_pos"])[both].abs().max()) if bool(both.any()) else 0.0
        results[key] = dict(
            {s: float(got[s]) for s in scalars}, plain={s: float(want[s]) for s in scalars},
            rms_gap_m=gap, launches=counts, seconds=seconds, seconds_plain=seconds_plain,
            rms_pos=got["rms_pos"], success=got["success"],
        )
        print(f"Monte Carlo population {key} ({MC_B} flights, {MC_T} ticks, wind 0.8 m/s): "
              f"launches {counts}; success {float(got['success_rate']):.4f}, RMS mean "
              f"{float(got['rms_mean']):.6f} m, p50 {float(got['rms_p50']):.6f}, p90 "
              f"{float(got['rms_p90']):.6f}, p99 {float(got['rms_p99']):.6f}, worst max "
              f"{float(got['worst_max_pos']):.4f} m (plain: success "
              f"{float(want['success_rate']):.4f}, RMS mean {float(want['rms_mean']):.6f} m); "
              f"max per-flight RMS gap to plain {gap:.3e} m; {seconds:.1f} s (plain "
              f"{seconds_plain:.1f} s)")
        if not gap <= MC_RMS_GAP_M:
            fail_fn(f"population {key}: per-flight RMS gap {gap} > {MC_RMS_GAP_M}")

    # two flights of the MPC population alone, each on its own body and
    # start, through K3 (per-flight solve) and K2 (its own plant row)
    bodies, rate_loops, x0 = cond
    ok = torch.nonzero(results["mpc"]["success"]).flatten()[:MC_LONE_FLIGHTS].tolist()
    if len(ok) < MC_LONE_FLIGHTS:
        fail_fn("the MPC population has fewer successful flights than the lone check needs")
    lone = {}
    ts = torch.arange(MC_T, device=dev).to(torch.float32) * plant.control_dt
    pos_ref, _ = campaign_circle(ts)
    at = lambda v, i: float(v[i]) if isinstance(v, torch.Tensor) else v
    for i in ok:
        body = RigidBodyParams(**{f: at(getattr(bodies, f), i) for f in (
            "mass", "gravity", "inertia_xx", "inertia_yy", "inertia_zz", "k_drag_linear",
            "k_drag_angular")}, wind=tuple(at(w, i) for w in bodies.wind))
        rl = RateLoopParams(**{f: at(getattr(rate_loops, f), i) for f in (
            "tau_roll", "tau_pitch", "tau_yaw", "hover_thrust_norm")})
        _cuda.reset_launch_counts()
        outs = mpc_flight_rollout(mpc, campaign_circle, MC_T, body=body, rate_loop=rl, cfg=plant,
                                  initial_state=x0[i], device=dev)
        torch.cuda.synchronize()
        if _cuda.launch_counts["gpmpc_controller_fused"] != MC_T:
            fail_fn(f"lone flight {i}: K3 launched {_cuda.launch_counts['gpmpc_controller_fused']}"
                    f" times, expected {MC_T}")
        rms = float(robustness_stats(outs["state"][None, :, 0:3], pos_ref, mc.settle_steps,
                                     mc.crash_error_m)["rms_pos"][0])
        lone[i] = (rms, float(results["mpc"]["rms_pos"][i]))
    gaps = {i: abs(a - b) for i, (a, b) in lone.items()}
    print("lone flights through K3 against their population rows (K16): "
          + "; ".join(f"flight {i}: {a:.6f} m vs {b:.6f} m" for i, (a, b) in lone.items()))
    if not max(gaps.values()) <= MC_RMS_GAP_M:
        fail_fn(f"a lone K3 flight disagrees with its K16 population row: {gaps}")
    for r in results.values():
        del r["rms_pos"], r["success"]
    results["lone_flights_rms_m"] = {str(i): v for i, v in lone.items()}
    results["fly_mpc"] = lambda T: fly_mpc(T)
    return results


# ---- the population tier: K4, K5 and K6 with a flight axis, K10 with a
# member axis (a grid of one block per flight or member) --------------------
POP_BATCHES = (1, 132, 256)   # timed at each: one flight, one block per SM, the campaign's 256
POP_K5_N, POP_K5_K = 20, 20   # the multi-tick population (K5's P1 fits shared memory to N=23)
POP_FALLBACK_M = 1.2          # the checked K4 launch's fallback radius: some flights engage
MC12_B, MC12_T, MC12_SETTLE = 64, 200, 50   # monte_carlo_mpc12's members and ticks
POLISH_B, POLISH_T = 16, 50   # the polished population (no kernel: it must fly finite)
# the population tiers' plain twins take 26-35 ms a tick at 256 flights:
# 300 ticks each, their RMS after 100
POP_T, POP_SETTLE = 300, 100
T_POP_SLOPE = (100, 500)
TUNE_MS_STARTS, TUNE_MS_T, TUNE_MS_ITERS, TUNE_MS_SETTLE = 8, 300, 2, 50
TUNE_MS_RTOL = 1e-5           # batched multi-start against the starts run one after another


def pop_operands(dev):
    """The population kernels' shared inputs at the campaign's width
    (``MC_B`` flights): the Monte Carlo draw's dispersed plant block and
    take-off states, and a seeded generator for the rest."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.loop import MonteCarloConfig, plant_block, sample_conditions

    bodies, rate_loops, x0 = sample_conditions(None, MonteCarloConfig(n_rollouts=MC_B,
                                                                      wind_std=0.8), device=dev)
    gen = torch.Generator().manual_seed(19)
    return gen, plant_block(bodies, rate_loops, MC_B, dev), x0


def population_record(label, launch, plain, single, tol, shared_bytes, flight_bytes,
                      flight_ops, fail_fn, err_fn=None) -> dict:
    """Hold a batched kernel at ``MC_B`` flights against its plain version
    (``tol`` on every output, by ``err_fn(got, want)``, default the max abs
    difference), require every block bit-identical to a one-flight launch on
    that flight's operands (``single(b)``) and a relaunch bit-identical,
    time it at each of ``POP_BATCHES`` (``launch(B)`` on the first B
    flights) and its plain version at ``MC_B``, and reckon its bound at the
    population's shape (``shared_bytes`` + B x ``flight_bytes``, B x
    ``flight_ops``)."""
    import torch

    err_fn = err_fn or (lambda g, w: float((g - w).abs().max()))
    got = launch(MC_B)
    torch.cuda.synchronize()
    want = plain()
    for g in got:
        if not torch.isfinite(g).all():
            fail_fn(f"{label}: non-finite values at B={MC_B}")
    err = max(err_fn(g, w) for g, w in zip(got, want))
    if not err <= tol:
        fail_fn(f"{label} at B={MC_B} disagrees with its plain version: {err} > {tol}")
    if not all(torch.equal(g, a) for g, a in zip(got, launch(MC_B))):
        fail_fn(f"{label}: a second launch on the same inputs differs")
    differ = [b for b in range(MC_B)
              if not all(torch.equal(g[b], s) for g, s in zip(got, single(b)))]
    if differ:
        fail_fn(f"{label}: blocks {differ[:8]} differ from one-flight launches on their operands")
    ms = {B: graph_ms(lambda B=B: launch(B), 20) for B in POP_BATCHES}
    rec = dict(err=err, ms=ms[MC_B], by_batch=ms, plain_ms=graph_ms(plain, 1, replays=2),
               bound=bound_ms(shared_bytes + MC_B * flight_bytes, MC_B * flight_ops),
               bound_by_batch={B: bound_ms(shared_bytes + B * flight_bytes, B * flight_ops)[0]
                               for B in POP_BATCHES})
    print(f"{label}: max_abs_err {err:.3e} against the plain version at B={MC_B}; every block "
          f"bit-identical to a one-flight launch; device "
          + ", ".join(f"{v * 1e3:.2f} us at B={B}" for B, v in ms.items())
          + f" (bound {rec['bound'][0] * 1e3:.4f} us at B={MC_B}, {rec['bound'][1]}; plain "
          f"{rec['plain_ms'] * 1e3:.2f} us)")
    return rec


def check_population_kernels(dev, fail_fn) -> dict:
    """K4 (N=25, 80 iterations, the fallback engaged on some flights), K5
    (N=20, K=20, 80 iterations, no GP), K6 on P1's factors (N=25, 80
    iterations) and K10 (n=1, the population's truth step, and n=20 with
    residuals; a body per member) at ``MC_B`` flights, each through
    ``population_record``. Returns the records keyed by kernel name."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.loop import MonteCarloConfig, sample_conditions
    from unmanned_aerial_vehicles_tpu_torch.models.params import GZ_QUADROTOR_PARAMS, RigidBodyParams
    from unmanned_aerial_vehicles_tpu_torch.ops import admm_pallas, rigid_plant_pallas, tick_pallas

    f32 = dict(dtype=torch.float32, device=dev)
    gen, block, x0 = pop_operands(dev)
    rnd = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(**f32).contiguous()
    B = MC_B
    records = {}
    plant_statics = dict(dt=0.02, substeps=2, accel_lo=(-3.5, -3.5, -4.0),
                         accel_hi=(3.5, 3.5, 6.0), yawrate_limit=0.8)
    states = (x0 + rnd(B, 12, scale=0.05)).contiguous()
    first = lambda Bn, *ts: [t[:Bn] for t in ts]

    # K4: one tick of every flight of the fused single-tick population
    mpc = LinearMPC(LinearMPCConfig(use_fused_controller=True), device=dev)
    N, cfg = mpc.config.horizon, mpc.config
    m, Nnu, Nnx = mpc.n_constraints, 4 * N, 6 * N
    data = mpc._tick_data
    pos, _ = campaign_circle(torch.tensor([1.0], device=dev))
    ref = torch.cat([pos[0], torch.zeros(3, **f32)]).repeat(N).contiguous()
    w = torch.cat([torch.zeros(B, N, 3, **f32), rnd(B, N, 3, scale=0.02)], 2).reshape(B, Nnx)
    misc = torch.cat([torch.full((B, 1), 0.1, **f32), rnd(B, 3, scale=0.02)], 1)
    z, y = rnd(B, m, scale=0.3), rnd(B, m, scale=0.1)
    kw = dict(plant_statics, rho=cfg.admm_rho, iterations=cfg.admm_iterations,
              over_relax=cfg.admm_over_relax, n=N, fallback_error_m=POP_FALLBACK_M)
    engaged = int((((states[:, 0:3] - pos) ** 2).sum(1) > POP_FALLBACK_M ** 2).sum())
    per = (states, w, misc, z, y, block)
    k4_args = lambda Bn: (data, *first(Bn, states, w), ref, *first(Bn, misc, z, y, block))
    records["gpmpc_tick_fused"] = population_record(
        f"K4 gpmpc_tick_fused, population (N={N}, {cfg.admm_iterations} iterations, "
        f"fallback at {POP_FALLBACK_M} m: {engaged} of {B} flights engaged)",
        lambda Bn: tick_pallas.gpmpc_tick_fused(*k4_args(Bn), **kw),
        lambda: tick_pallas.gpmpc_tick_fused_plain(*k4_args(B), **kw),
        lambda b: tick_pallas.gpmpc_tick_fused(data, states[b], w[b], ref, misc[b], z[b], y[b],
                                               block[b], **kw),
        SINGLE_TOL, nbytes(*data[2:10], ref), nbytes(*(t[0] for t in per)) + 4 * (25 + 3 * m),
        ops_controller(N, cfg.admm_iterations) + OPS_ALLOCATION + 2 * OPS_RK4_SUBSTEP, fail_fn)

    # K5: one launch of K ticks of every flight of the multi-tick population
    mpc5 = LinearMPC(LinearMPCConfig(horizon=POP_K5_N, use_fused_controller=True), device=dev)
    N, K, cfg5 = POP_K5_N, POP_K5_K, mpc5.config
    m5, Nnx5, Nnu5 = mpc5.n_constraints, 6 * POP_K5_N, 4 * POP_K5_N
    data5 = mpc5._tick_data
    aux = torch.cat([states[:, 0:6] + 0.01, rnd(B, 3, scale=0.02)], 1).contiguous()
    xtail = (states[:, 0:6].repeat(1, N) + rnd(B, Nnx5, scale=0.05)).contiguous()
    z5, y5 = rnd(B, m5, scale=0.3), rnd(B, m5, scale=0.1)
    ts = 1.0 + 0.02 * torch.arange(K, device=dev).to(torch.float32)
    pk, _ = campaign_circle(ts)
    refs = torch.cat([pk, torch.zeros(K, 3, **f32)], 1).repeat(1, N).contiguous()
    yaw = torch.zeros(K, **f32)
    kw5 = dict(plant_statics, k_ticks=K, use_gp=False, rho=cfg5.admm_rho,
               iterations=cfg5.admm_iterations, over_relax=cfg5.admm_over_relax, n=N)
    per5 = (states, aux, xtail, z5, y5, block)
    k5_args = lambda Bn: (data5, None, *first(Bn, states, aux, xtail, z5, y5), refs, yaw,
                          block[:Bn])
    tick5_ops = (2 * (6 + Nnx5) * Nnx5 + 2 * Nnx5 * Nnu5 + 2 * Nnu5 * (m5 + Nnu5)
                 + cfg5.admm_iterations * (2 * m5 * m5 + 10 * m5) + 2 * m5 * Nnu5
                 + 2 * Nnu5 * Nnx5 + OPS_ALLOCATION + 2 * OPS_RK4_SUBSTEP)
    records["gpmpc_multitick_fused"] = population_record(
        f"K5 gpmpc_multitick_fused, population (N={N}, K={K}, {cfg5.admm_iterations} "
        "iterations, no GP)",
        lambda Bn: tick_pallas.gpmpc_multitick_fused(*k5_args(Bn), **kw5),
        lambda: tick_pallas.multitick_staged(*k5_args(B), **kw5),
        lambda b: tick_pallas.gpmpc_multitick_fused(data5, None, states[b], aux[b], xtail[b],
                                                    z5[b], y5[b], refs, yaw, block[b], **kw5),
        TICK_TOL, nbytes(*data5[2:10], refs, yaw),
        nbytes(*(t[0] for t in per5)) + 4 * (K * 32 + 12 + 9 + Nnx5 + 2 * m5), K * tick5_ops,
        fail_fn)

    # K6: every flight's ADMM of one staged tick (use_fused_admm)
    am = LinearMPC(LinearMPCConfig(use_fused_admm=True), device=dev)
    N, cfg6 = am.config.horizon, am.config
    m6, n6, Nnx6 = am.n_constraints, am.n_primal, 6 * am.config.horizon
    f = rnd(B, n6)
    off = rnd(B, Nnx6, scale=0.3)
    p0 = (-(f @ am._GMinv.T)).contiguous()
    minv_f = (f @ am._M_inv.T).contiguous()
    lower = torch.cat([am._u_lo.expand(B, n6), am._x_lo - off], 1).contiguous()
    upper = torch.cat([am._u_hi.expand(B, n6), am._x_hi - off], 1).contiguous()
    z6, y6 = rnd(B, m6, scale=0.3), rnd(B, m6, scale=0.1)
    k6_args = lambda Bn: (am._P1_f32, p0[:Bn], am._GMinvT_f32, minv_f[:Bn],
                          *first(Bn, lower, upper, z6, y6), cfg6.admm_rho, cfg6.admm_iterations,
                          cfg6.admm_over_relax)
    records["admm_box_qp_fused_composite"] = population_record(
        f"K6 admm_box_qp_fused_composite, population (N={N}, {cfg6.admm_iterations} "
        "iterations, P1's factors)",
        lambda Bn: admm_pallas.admm_box_qp_fused_composite(*k6_args(Bn), SuT=am._SuT_f32),
        lambda: admm_pallas.admm_box_qp_fused_composite_plain(*k6_args(B)),
        lambda b: admm_pallas.admm_box_qp_fused_composite(
            am._P1_f32, p0[b], am._GMinvT_f32, minv_f[b], lower[b], upper[b], z6[b], y6[b],
            cfg6.admm_rho, cfg6.admm_iterations, cfg6.admm_over_relax, SuT=am._SuT_f32),
        SINGLE_TOL, nbytes(am._GMinvT_f32, am._SuT_f32),
        4 * (5 * m6 + n6) + 4 * (n6 + 2 * m6),
        ops_admm(m6, n6, cfg6.admm_iterations, factored=True), fail_fn)

    # K10: every member's truth step, each on its own body (the dispersed
    # GZ quadrotor: drag, so the wind bites)
    gz, _, xg = sample_conditions(None, MonteCarloConfig(n_rollouts=B, mass_jitter_pct=0.15,
                                                         wind_std=0.8),
                                  body=GZ_QUADROTOR_PARAMS, device=dev)
    scale = torch.tensor([2, 2, 1, 3, 3, 2, 0.6, 0.6, 2.0, 2, 2, 1.5], **f32)
    xr = (xg + 0.3 * rnd(B, 12) * scale).contiguous()
    member = lambda b: RigidBodyParams(
        **{fl: float(getattr(gz, fl)[b]) for fl in (
            "mass", "gravity", "inertia_xx", "inertia_yy", "inertia_zz", "k_drag_linear",
            "k_drag_angular")}, wind=tuple(float(wv[b]) for wv in gz.wind))
    hover = (gz.mass * gz.gravity)[:, None, None]
    for n, dt, with_res in ((1, 0.02, False), (20, 0.1, True)):
        U = (torch.cat([hover, torch.zeros(B, 1, 3, **f32)], 2)
             + rnd(B, n, 4) * torch.tensor([0.5, 2e-3, 2e-3, 2e-3], **f32)).contiguous()
        res = rnd(B, n, 12, scale=0.1) if with_res else None
        sub = lambda t, Bn: None if t is None else t[:Bn]
        bodies_of = lambda Bn: RigidBodyParams(
            mass=gz.mass[:Bn], gravity=gz.gravity[:Bn], inertia_xx=gz.inertia_xx[:Bn],
            inertia_yy=gz.inertia_yy[:Bn], inertia_zz=gz.inertia_zz[:Bn],
            k_drag_linear=gz.k_drag_linear[:Bn], k_drag_angular=gz.k_drag_angular[:Bn],
            wind=tuple(wv[:Bn] for wv in gz.wind))
        rec = population_record(
            f"K10 rigid_body_rollout_fused, population (n={n}, a body per member"
            + (", residuals)" if with_res else ")"),
            lambda Bn, U=U, res=res, dt=dt: (rigid_plant_pallas.rigid_body_rollout_fused(
                xr[:Bn], U[:Bn], bodies_of(Bn), dt, residuals=sub(res, Bn)),),
            lambda U=U, res=res, dt=dt: (rigid_plant_pallas.rigid_body_rollout_plain(
                xr, U, bodies_of(B), dt, residuals=res),),
            lambda b, U=U, res=res, dt=dt: (rigid_plant_pallas.rigid_body_rollout_fused(
                xr[b], U[b], member(b), dt, residuals=None if res is None else res[b]),),
            RIGID_PLANT_TOL, 0, 4 * (12 + 4 * n + 10 + (12 * n if with_res else 0) + 12 * n),
            n * OPS_RIGID_RK4, fail_fn, err_fn=rel_err)
        if n == 1:
            records["rigid_body_rollout_fused"] = rec
        else:
            records["rigid_body_rollout_fused"]["n20"] = rec
    return records


def run_population_tiers(dev, fail_fn, kernels) -> dict:
    """Fly the population tiers on the Monte Carlo phase's conditions and
    the campaign's circle, each with the launch counts from 0 and against
    its plain twin (equal success flags; per-flight RMS within MC_RMS_GAP_M
    where both succeed), POP_T ticks (RMS after POP_SETTLE): the fused
    single-tick population
    (N=25: K4 POP_T), the multi-tick one (N=20, K=20: K5 POP_T / 20), the
    ``use_fused_admm`` one with the fused plant (K6 and K2 POP_T), the fused
    single-tick one with the 1.5 m fallback (K4 POP_T), and
    ``monte_carlo_mpc12`` (MC12_B
    members on their own X500 bodies, MC12_T ticks: K10 MC12_T); then the
    polished population (POLISH_B flights, POLISH_T ticks, no kernel) must
    fly finite. Returns the results and, under ``"fly"``, each timed
    population's ``fly(T)``."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.control.mpc_rigid import RigidBodyMPC
    from unmanned_aerial_vehicles_tpu_torch.loop import (
        FlightLoopConfig,
        MonteCarloConfig,
        batched_mpc_flight_rollout,
        monte_carlo_mpc,
        monte_carlo_mpc12,
        sample_conditions,
    )
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda

    cond = sample_conditions(None, MonteCarloConfig(n_rollouts=MC_B, wind_std=0.8), device=dev)
    mc = MonteCarloConfig(n_rollouts=MC_B, wind_std=0.8, settle_steps=POP_SETTLE)
    fused = LinearMPC(LinearMPCConfig(use_fused_controller=True), device=dev)
    fused20 = LinearMPC(LinearMPCConfig(horizon=POP_K5_N, use_fused_controller=True), device=dev)
    admm = LinearMPC(LinearMPCConfig(use_fused_admm=True), device=dev)
    tiers = {
        "fused_tick": (fused, FlightLoopConfig(use_fused_tick=True),
                       {"gpmpc_tick_fused": POP_T}),
        "multitick": (fused20, FlightLoopConfig(use_fused_tick=True,
                                                ticks_per_dispatch=POP_K5_K),
                      {"gpmpc_multitick_fused": POP_T // POP_K5_K}),
        "fused_admm": (admm, FlightLoopConfig(use_pallas_plant=True),
                       {"admm_box_qp_fused_composite": POP_T,
                        "allocation_plant_tick_fused": POP_T}),
        "fused_tick_fallback": (fused, FlightLoopConfig(use_fused_tick=True, fallback_error_m=1.5),
                                {"gpmpc_tick_fused": POP_T}),
    }
    fly = {key: (lambda T, plain=False, mpc=mpc, cfg=cfg: monte_carlo_mpc(
        mpc, campaign_circle, T, mc=mc, loop_cfg=cfg, conditions=cond, device=dev,
        plain_kernels=plain)) for key, (mpc, cfg, _) in tiers.items()}
    eng = RigidBodyMPC(device=dev)
    mc12 = MonteCarloConfig(n_rollouts=MC12_B, wind_std=0.8, settle_steps=MC12_SETTLE)
    fly["mpc12"] = lambda T, plain=False: monte_carlo_mpc12(eng, campaign_circle, T, mc=mc12,
                                                            device=dev, plain_kernels=plain)
    expected = {key: counts for key, (_, _, counts) in tiers.items()}
    expected["mpc12"] = {"rigid_body_rollout_fused": MC12_T}
    scalars = ("success_rate", "rms_mean", "rms_p50", "rms_p90", "rms_p99", "worst_max_pos")
    results = {}
    for key, counts_expected in expected.items():
        T = MC12_T if key == "mpc12" else POP_T
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        got = fly[key](T)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: _cuda.launch_counts[k] for k in counts_expected}
        t0 = time.perf_counter()
        want = fly[key](T, True)
        torch.cuda.synchronize()
        seconds_plain = time.perf_counter() - t0
        for name, n in counts_expected.items():
            if counts[name] != n:
                fail_fn(f"population tier {key}: {name} launched {counts[name]} times, "
                        f"expected {n}")
        if not torch.equal(got["success"], want["success"]):
            fail_fn(f"population tier {key}: the kernel and plain twins disagree on which "
                    "flights succeed")
        both = got["success"] & want["success"]
        gap = (float((got["rms_pos"] - want["rms_pos"])[both].abs().max())
               if bool(both.any()) else 0.0)
        results[key] = dict({s: float(got[s]) for s in scalars},
                            plain={s: float(want[s]) for s in scalars}, rms_gap_m=gap,
                            launches=counts, seconds=seconds, seconds_plain=seconds_plain)
        print(f"population tier {key} ({MC12_B if key == 'mpc12' else MC_B} flights, {T} ticks): "
              f"launches {counts}; success {float(got['success_rate']):.4f}, RMS mean "
              f"{float(got['rms_mean']):.6f} m, p50 {float(got['rms_p50']):.6f}, p90 "
              f"{float(got['rms_p90']):.6f}, worst max {float(got['worst_max_pos']):.4f} m "
              f"(plain: success {float(want['success_rate']):.4f}, RMS mean "
              f"{float(want['rms_mean']):.6f} m); max per-flight RMS gap to plain {gap:.3e} m; "
              f"{seconds:.1f} s (plain {seconds_plain:.1f} s)")
        if not gap <= MC_RMS_GAP_M:
            fail_fn(f"population tier {key}: per-flight RMS gap {gap} > {MC_RMS_GAP_M}")
    for key, kernel in (("fused_tick", "gpmpc_tick_fused"),
                        ("multitick", "gpmpc_multitick_fused"),
                        ("fused_admm", "admm_box_qp_fused_composite"),
                        ("mpc12", "rigid_body_rollout_fused")):
        kernels[kernel]["population"]["launches"] = results[key]["launches"][kernel]

    # the polished population: each flight's active-set polish, no kernel
    polish = LinearMPC(LinearMPCConfig(polish=True), device=dev)
    pb, pr, px = sample_conditions(None, MonteCarloConfig(n_rollouts=POLISH_B, wind_std=0.8),
                                   device=dev)
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    outs = batched_mpc_flight_rollout(polish, campaign_circle, POLISH_T, pb, pr, px, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: v for k, v in _cuda.launch_counts.items() if v}
    finite = bool(torch.isfinite(outs["state"]).all())
    print(f"population tier polish ({POLISH_B} flights, {POLISH_T} ticks, N="
          f"{polish.config.horizon}): finite {finite}, kernel launches {launched or 'none'}, "
          f"{seconds:.1f} s")
    if not finite or launched:
        fail_fn(f"the polished population: finite {finite}, launches {launched}")
    results["polish"] = dict(finite=finite, seconds=seconds)
    results["fly"] = fly
    return results


def time_population_tiers(fly: dict, staged_us: float, card: str, device_busy) -> dict:
    """Microseconds per flight-tick of the three fused populations (slope
    between T_POP_SLOPE's lengths over MC_B flights) and each one's
    device-busy share over a profiler window of 60 ticks, beside the staged
    population's."""
    out = {}
    for key in ("fused_tick", "multitick", "fused_admm"):
        us_tick = slope_us(fly[key], T_POP_SLOPE)
        busy_us, by_name = device_busy(fly[key], 60)
        out[key] = dict(us_per_flight_tick=us_tick / MC_B, us_per_tick=us_tick,
                        busy_us_per_tick=busy_us, idle_share=1.0 - busy_us / us_tick)
        print(f"population tier {key}: {us_tick / MC_B:.4f} us per flight-tick ({us_tick:.2f} us "
              f"per tick of {MC_B} flights, slope {T_POP_SLOPE[0]}->{T_POP_SLOPE[1]} ticks; the "
              f"staged population through K16 {staged_us / MC_B:.4f}); profiler over 60 ticks: "
              f"device busy {busy_us:.2f} us per tick, idle share {out[key]['idle_share']:.3f}; "
              "by kernel (us per tick): "
              + "; ".join(f"{name[:50]} {t / 60:.2f}" for t, name in by_name[:6])
              + f"; card: {card}")
    return out


# the orchestration block: the mission phase machine, the online learner,
# the demo MPCs and the comparison harness at the CLI's settings
MISSION_S = 24.0              # all five phases; the trajectory from 20 s: 200 ticks at 50 Hz
NOISY_MISSION_S = 22.0       # 100 trajectory ticks: the observer's tick is ~9x the mission's
MISSION_WIND = (1.5, 0.8, 0.0)
ONLINE_SYSTEM_T = 600         # two refits (ticks 250 and 500)
ONLINE_SYSTEM_P, ONLINE_SYSTEM_REFIT = 400, 250   # the CLI's online defaults
ORCHESTRATION_GAP_M = 1e-3    # kernel flight against its plain twin (RMS and max position gap)
DEMO_SOLVES = 200
DEMO_GAP_M = 1e-4             # RK4DemoMPC's states, K14 against its plain twin
ATTITUDE_TICKS = 10


def run_orchestration(dev, fail_fn, kernels, ref, card: str) -> dict:
    """Fly the orchestration tier at full width, each flight with the launch
    counts from 0 and against its plain twin (``plain_kernels=True``): the
    mission (``mission_rollout``, the CLI's ``LinearMPCConfig(
    use_fused_controller=True)``, N=25, 80 iterations, and
    ``FlightLoopConfig(use_pallas_plant=True)``; the figure-8 at amplitude 6
    over the take-off height; MISSION_S: K3 and K1 once a tick, all five
    phases), the noisy mission with the disturbance observer under a
    steady wind on one seeded draw (its estimate must point into the wind),
    the online learner (``online_gp_mpc_rollout``, the CLI's 400-point ring
    refitted every 250 ticks, ONLINE_SYSTEM_T ticks: K3 and K1 once a tick,
    at least two refits, the sample counts equal), ``RK4DemoMPC`` tracking a
    per-stage reference for DEMO_SOLVES solves (K14 once a solve, at n=30,
    m=90; timed there against its plain version and its bound), and the
    attitude MPC's hover and the comparison harness once (no kernel,
    finite). Records each path's launches under the kernel's ``paths``;
    K14's entry becomes its flight path's (the N=25 QP moves to ``n25``).
    Returns the results line's entries."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control import AttitudeMPC, RK4DemoMPC
    from unmanned_aerial_vehicles_tpu_torch.control.mpc_demo import attitude_mpc_step
    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig
    from unmanned_aerial_vehicles_tpu_torch.loop import (
        FlightLoopConfig,
        OnlineGPMPCConfig,
        mission_rollout,
        online_gp_mpc_rollout,
        run_full_comparison,
    )
    from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, admm_pallas

    f32 = dict(dtype=torch.float32, device=dev)
    started = time.perf_counter()
    mpc = LinearMPC(LinearMPCConfig(use_fused_controller=True), device=dev)
    loop = FlightLoopConfig(use_pallas_plant=True)
    results = {}

    def twins(label, fly, ticks, expected):
        """``fly(plain)`` with the counts from 0, timed, then its plain twin.
        Returns both outputs and the kernel flight's host us per tick."""
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = fly(False)
        torch.cuda.synchronize()
        us_tick = (time.perf_counter() - t0) / ticks * 1e6
        counts = {k: v for k, v in _cuda.launch_counts.items() if v}
        t0 = time.perf_counter()
        plain = fly(True)
        torch.cuda.synchronize()
        us_plain = (time.perf_counter() - t0) / ticks * 1e6
        o, p = (x[0] if isinstance(x, tuple) else x for x in (outs, plain))
        for key, val in o.items():
            if not torch.isfinite(val.float()).all():
                fail_fn(f"{label}: non-finite {key}")
        gap = float((o["state"][:, 0:3] - p["state"][:, 0:3]).abs().max())
        for kernel, n in expected.items():
            if counts.get(kernel, 0) != n:
                fail_fn(f"{label}: {kernel} launched {counts.get(kernel, 0)} times, expected {n}")
            kernels[kernel].setdefault("paths", {})[label.split(" (")[0]] = counts[kernel]
        unexpected = set(counts) - set(expected)
        if unexpected:
            fail_fn(f"{label}: launched {sorted(unexpected)} as well")
        print(f"{label}: launches {counts}, {us_tick:.1f} us per tick on the host through the "
              f"kernels ({us_plain:.1f} us plain), max position gap to the plain twin "
              f"{gap:.3e} m; card: {card}")
        if not gap <= ORCHESTRATION_GAP_M:
            fail_fn(f"{label}: position gap {gap} > {ORCHESTRATION_GAP_M}")
        return outs, plain, us_tick, us_plain, gap

    def trajectory_rms(o):
        traj = o["in_trajectory"]
        err = o["target"][traj] - o["state"][traj][:, 0:3]
        return float(torch.sqrt(torch.mean(torch.sum(err**2, dim=1))))

    # the mission at the CLI's settings
    ticks = int(MISSION_S / loop.control_dt)
    outs, plain, us_tick, us_plain, gap = twins(
        f"mission (K3 N=25, 80 iterations, K1; {MISSION_S} s, {ticks} ticks)",
        lambda p: mission_rollout(mpc, ref, MISSION_S, cfg=loop, device=dev,
                                  plain_kernels=p),
        ticks, {"gpmpc_controller_fused": ticks, "px4_plant_step_fused": ticks})
    phases = sorted(set(outs["phase"].tolist()))
    rms_k, rms_p = trajectory_rms(outs), trajectory_rms(plain)
    traj = outs["in_trajectory"]
    z_hover = float(outs["state"][int(19.0 / loop.control_dt), 2])
    print(f"  phases reached {phases}; height at 19 s {z_hover:.4f} m; trajectory-phase RMS "
          f"{rms_k:.6f} m over {int(traj.sum())} ticks (plain {rms_p:.6f} m, gap "
          f"{abs(rms_k - rms_p):.3e} m)")
    if phases != [0, 1, 2, 3, 4]:
        fail_fn(f"the mission reached phases {phases}")
    if not abs(rms_k - rms_p) <= ORCHESTRATION_GAP_M:
        fail_fn(f"the mission's trajectory RMS gap {abs(rms_k - rms_p)} > {ORCHESTRATION_GAP_M}")
    results["mission"] = dict(ticks=ticks, us_per_tick=us_tick, us_per_tick_plain=us_plain,
                              rms_m=rms_k, rms_m_plain=rms_p, gap_m=gap, phases=len(phases))

    # the noisy mission: the 15-state observer under a steady wind, one draw
    ticks = int(NOISY_MISSION_S / loop.control_dt)
    noise = torch.randn(ticks, 9, generator=torch.Generator(device=dev).manual_seed(0), **f32)
    windy = RigidBodyParams(wind=MISSION_WIND)
    outs, plain, us_tick, us_plain, gap = twins(
        f"noisy mission (observer, wind {MISSION_WIND}; {NOISY_MISSION_S} s, {ticks} ticks)",
        lambda p: mission_rollout(mpc, ref, NOISY_MISSION_S, cfg=loop, body=windy,
                                  noise=noise, disturbance_observer=True, device=dev,
                                  plain_kernels=p),
        ticks, {"gpmpc_controller_fused": ticks, "px4_plant_step_fused": ticks})
    rms_k, rms_p = trajectory_rms(outs), trajectory_rms(plain)
    d_tail = outs["disturbance_est"][-ticks // 4:].mean(dim=0)
    est = float(torch.sqrt(torch.mean(torch.sum(
        (outs["state_est"][:, 0:3] - outs["state"][:, 0:3]) ** 2, dim=1))))
    print(f"  trajectory-phase RMS {rms_k:.6f} m (plain {rms_p:.6f} m, gap {abs(rms_k - rms_p):.3e}"
          f" m); estimate RMS {est:.6f} m; disturbance estimate over the last quarter "
          f"{[round(float(v), 4) for v in d_tail]} (wind {list(MISSION_WIND)})")
    if not abs(rms_k - rms_p) <= ORCHESTRATION_GAP_M:
        fail_fn(f"the noisy mission's RMS gap {abs(rms_k - rms_p)} > {ORCHESTRATION_GAP_M}")
    if not all(float(d_tail[i]) * MISSION_WIND[i] > 0 for i in (0, 1)):
        fail_fn(f"the observer's estimate {d_tail.tolist()} does not point into the wind")
    results["noisy_mission"] = dict(ticks=ticks, us_per_tick=us_tick, us_per_tick_plain=us_plain,
                                    rms_m=rms_k, rms_m_plain=rms_p, gap_m=gap,
                                    disturbance_tail=d_tail.tolist())

    # the online learner at the CLI's settings
    ocfg = OnlineGPMPCConfig(flight=loop, gp=ResidualGPConfig(max_data_points=ONLINE_SYSTEM_P),
                             gp_refit_every=ONLINE_SYSTEM_REFIT)
    (outs, ds, _), (plain, ds_plain, _), us_tick, us_plain, gap = twins(
        f"online learner (K3 N=25, 80 iterations, K1; P={ONLINE_SYSTEM_P}, refit every "
        f"{ONLINE_SYSTEM_REFIT}; {ONLINE_SYSTEM_T} ticks)",
        lambda p: online_gp_mpc_rollout(mpc, ref, ONLINE_SYSTEM_T, cfg=ocfg, device=dev,
                                        plain_kernels=p),
        ONLINE_SYSTEM_T, {"gpmpc_controller_fused": ONLINE_SYSTEM_T,
                          "px4_plant_step_fused": ONLINE_SYSTEM_T})
    err = lambda o: o["pos_ref"] - o["state"][:, 0:3]
    rms_k, rms_p = (float(torch.sqrt(torch.mean(torch.sum(err(o) ** 2, dim=1))))
                    for o in (outs, plain))
    refit_ticks = range(ONLINE_SYSTEM_REFIT - 1, ONLINE_SYSTEM_T, ONLINE_SYSTEM_REFIT)
    refits = sum(int(outs["gp_count"][i]) >= ocfg.gp_min_samples for i in refit_ticks)
    same_counts = torch.equal(outs["gp_count"], plain["gp_count"])
    print(f"  RMS {rms_k:.6f} m (plain {rms_p:.6f} m, gap {abs(rms_k - rms_p):.3e} m); refits "
          f"{refits}; samples collected {int(ds.count)} (plain {int(ds_plain.count)}), counts "
          f"equal at every tick {same_counts}")
    if refits < 2 or not same_counts or not abs(rms_k - rms_p) <= ORCHESTRATION_GAP_M:
        fail_fn(f"the online learner: refits {refits}, counts equal {same_counts}, RMS gap "
                f"{abs(rms_k - rms_p)}")
    results["online_learner"] = dict(ticks=ONLINE_SYSTEM_T, us_per_tick=us_tick,
                                     us_per_tick_plain=us_plain, rms_m=rms_k, rms_m_plain=rms_p,
                                     gap_m=gap, refits=refits, samples=int(ds.count))

    # RK4DemoMPC tracking a moving NED reference: K14 once a solve
    demo = RK4DemoMPC(device=dev)
    ts = 0.1 * (torch.arange(DEMO_SOLVES, device=dev)[:, None]
                + torch.arange(demo.N + 1, device=dev)[None, :]).to(torch.float32)
    demo_refs = torch.stack([2.0 * torch.sin(0.3 * ts), 2.0 * torch.cos(0.3 * ts),
                             torch.full_like(ts, -2.0), 0.6 * torch.cos(0.3 * ts),
                             -0.6 * torch.sin(0.3 * ts), torch.zeros_like(ts)], dim=2)

    def fly_demo(plain):
        state = torch.tensor([0.0, 2.0, -2.0, 0.6, 0.0, 0.0], **f32)
        carry, rows = demo.init_carry(), []
        for i in range(DEMO_SOLVES):
            u, _, carry = demo.solve(carry, state, demo_refs[i], plain_kernels=plain)
            rows.append(state)
            state = torch.cat([state[0:3] + 0.1 * state[3:6] + 0.005 * u, state[3:6] + 0.1 * u])
        return {"state": torch.stack(rows), "last_carry": carry.slack, "last_dual": carry.dual}

    outs, plain, us_solve, us_plain, gap = twins(
        f"RK4DemoMPC ({DEMO_SOLVES} solves, n=30, m=90, 80 iterations)", fly_demo, DEMO_SOLVES,
        {"admm_box_qp_fused": DEMO_SOLVES})
    track = float((outs["state"][50:, 0:3] - demo_refs[50:, 0, 0:3]).norm(dim=1).mean())
    print(f"  mean tracking error after 50 solves {track:.4f} m; {us_solve:.1f} us per solve on "
          f"the host (plain {us_plain:.1f} us)")
    if not gap <= DEMO_GAP_M:
        fail_fn(f"RK4DemoMPC: states' gap to the plain twin {gap} > {DEMO_GAP_M}")
    # K14 at the demo's QP (n=30, m=90), on the flight's last operands
    state = outs["state"][-1]
    offset = demo._Sx @ state
    f = (demo._SuT_q @ (offset - demo_refs[-1][1:].reshape(-1))).contiguous()
    args = (demo._M_inv_f32, demo._G_f32, demo._GT_f32, f,
            torch.cat([demo._u_lo, demo._x_lo - offset]).contiguous(),
            torch.cat([demo._u_hi, demo._x_hi - offset]).contiguous(),
            outs["last_carry"].contiguous(), outs["last_dual"].contiguous(), demo.rho,
            demo.iterations)
    n, m = demo._M_inv_f32.shape[0], demo._G_f32.shape[0]
    fn = lambda: admm_pallas.admm_box_qp_fused(*args)
    plain_fn = lambda: admm_pallas.admm_box_qp_fused_plain(*args)
    got, want = fn(), plain_fn()
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    variant, shared, _ = admm_pallas.explicit_variant(dev, n, m)
    k14 = kernels["admm_box_qp_fused"]
    k14["n25"] = {key: k14[key] for key in ("err", "ms", "plain_ms", "host_ms", "host_plain_ms",
                                            "bound", "variant", "cycles_per_pass")}
    k14.update(
        err=max(errs), ms=graph_ms(fn, 20), plain_ms=graph_ms(plain_fn, 2),
        host_ms=cuda_ms(fn, 50), host_plain_ms=cuda_ms(plain_fn, 5),
        bound=bound_ms(nbytes(*args[:8]) + 4 * (n + 2 * m),
                       ops_explicit_admm(n, m, demo.iterations)),
        launches=DEMO_SOLVES, variant=f"register variant {variant} "
        f"{admm_pallas.EXPLICIT_REG_VARIANTS[variant - 1] if variant else ''}")
    print(f"  K14 at the demo's QP (n={n}, m={m}, {demo.iterations} iterations, "
          f"{k14['variant']}): max_abs_err of scale {max(errs):.3e} against its plain version; "
          f"{k14['ms'] * 1e3:.2f} us per launch (CUDA graph), plain {k14['plain_ms'] * 1e3:.2f} "
          f"us, bound {k14['bound'][0] * 1e3:.4f} us ({k14['bound'][1]}); with the host's "
          f"overhead {k14['host_ms'] * 1e3:.2f} us; card: {card}")
    if not max(errs) <= TAIL_TOL:
        fail_fn(f"K14 at the demo's QP disagrees with its plain version: {errs}")
    results["rk4_demo"] = dict(solves=DEMO_SOLVES, us_per_solve=us_solve,
                               us_per_solve_plain=us_plain, gap_m=gap, tracking_m=track)

    # the attitude MPC's hover and the comparison harness: no kernel
    _cuda.reset_launch_counts()
    att = AttitudeMPC(device=dev)
    target = torch.tensor([0.0, 0.0, 2.0, 0, 0, 0, 0, 0, 0], **f32)
    x = target.clone()
    x[0] = 0.3
    carry = att.init_carry(x)
    att.solve(carry, x, target)     # the first solve sets up the linear-algebra libraries
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ATTITUDE_TICKS):
        u, _, carry = att.solve(carry, x, target)
        x = attitude_mpc_step(x, u, torch.zeros(9, **f32))
    torch.cuda.synchronize()
    us_att = (time.perf_counter() - t0) / ATTITUDE_TICKS * 1e6
    t0 = time.perf_counter()
    table = run_full_comparison(device=dev)
    comparison_s = time.perf_counter() - t0
    launched = {k: v for k, v in _cuda.launch_counts.items() if v}
    print(f"attitude MPC hover ({ATTITUDE_TICKS} ticks, SQP engine, no kernel): u0 "
          f"{[round(float(v), 4) for v in u]}, final state {[round(float(v), 4) for v in x[:3]]}"
          f", {us_att:.1f} us per tick")
    for traj_type, row in table.items():
        print(f"  comparison {traj_type}: winner {row['winner']}, PID avg error "
              f"{row['pid_avg_error']:.4f} m, GP-MPC avg error {row['mpc_avg_error']:.4f} m, "
              f"improvement {row['improvement_%']:.1f} %")
    print(f"comparison harness (4 trajectories, 30 s at 10 Hz, no kernel): {comparison_s:.2f} s")
    finite = bool(torch.isfinite(x).all()) and all(
        math.isfinite(v) for row in table.values() for k, v in row.items() if k != "winner")
    if not finite or launched:
        fail_fn(f"attitude MPC / comparison: finite {finite}, launches {launched}")
    results["attitude_hover_u0"] = [float(v) for v in u]
    results["comparison"] = {k: {"winner": r["winner"], "pid_avg_error": r["pid_avg_error"],
                                 "mpc_avg_error": r["mpc_avg_error"]} for k, r in table.items()}
    results["seconds"] = time.perf_counter() - started
    print(f"orchestration block: {results['seconds']:.1f} s")
    return results


CORPUS_N, CORPUS_D, CORPUS_OUT = 19816, 10, 6   # the reference's flight corpus
CORPUS_FLIGHTS = 8            # the seeded corpus: figure-8 flights at 50 Hz
CORPUS_QUERIES = 2000
CORPUS_FIT_REL = 1e-3         # kernel fit against the plain fit: posterior mean, of y_std
DENSE_N = 4000
DENSE_FIT_REL = 5e-3          # float32 kernel fit against a dense float64 Cholesky fit, of y_std
PREDICT_Q = 256
PREDICT_REL = 1e-3            # predict_sharded's mean and variance, kernel against plain route
GRAD_PROBES = 16
GRAD_REL = 1e-3               # lml_grad_sharded on equal probes, kernel against plain route
ADAM_STEPS = 3
FLIGHT_SWEEP_B, FLIGHT_SWEEP_T = 4, 200
TIMER_LAUNCHES = (10, 50)     # scan_slope_timeit's two lengths of K15 launches
TIMER_REL = 0.10              # its per-launch time against graph_ms on the same launch
DISTRIBUTED_BUDGET_S = 60.0


def seeded_corpus(seed: int = 2026):
    """A float32 flight corpus of the reference's size: ``CORPUS_FLIGHTS``
    figure-8 flights at 50 Hz (position, velocity, acceleration with sensor
    noise, yaw rate: the GP's 10 inputs) and 6 smooth residual outputs of
    them (drag-like and tilt-like terms) plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = CORPUS_N
    per = -(-n // CORPUS_FLIGHTS)
    rows = []
    for _ in range(CORPUS_FLIGHTS):
        amp, freq = rng.uniform(2.0, 6.0), rng.uniform(0.02, 0.06)
        w, phase = 2 * np.pi * freq, rng.uniform(0, 2 * np.pi)
        t = np.arange(per) * 0.02
        s, c = np.sin(w * t + phase), np.cos(w * t + phase)
        s2, c2 = np.sin(2 * (w * t + phase)), np.cos(2 * (w * t + phase))
        pos = np.stack([amp * s, 0.5 * amp * s2, 3.0 + 0.3 * s], 1)
        vel = np.stack([amp * w * c, amp * w * c2, 0.3 * w * c], 1)
        acc = np.stack([-amp * w**2 * s, -2 * amp * w**2 * s2, -0.3 * w**2 * s], 1)
        acc = acc + 0.3 * rng.normal(size=acc.shape)
        yaw_rate = 0.2 * np.sin(0.5 * w * t) + 0.02 * rng.normal(size=per)
        rows.append(np.column_stack([pos, vel, acc, yaw_rate]))
    X = np.concatenate(rows)[:n]
    v, a = X[:, 3:6], X[:, 6:9]
    Y = np.column_stack([
        -0.02 * v[:, 0] * np.abs(v[:, 0]), -0.02 * v[:, 1] * np.abs(v[:, 1]),
        0.01 * np.sin(X[:, 2]) - 0.005 * a[:, 2],
        -0.1 * v[:, 0] + 0.05 * np.tanh(a[:, 0]), -0.1 * v[:, 1] + 0.05 * np.tanh(a[:, 1]),
        0.05 * np.cos(X[:, 9]) - 0.02 * v[:, 2],
    ]) + 0.01 * rng.normal(size=(n, CORPUS_OUT))
    return X.astype(np.float32), Y.astype(np.float32)


def write_corpus_csvs(directory: str) -> None:
    """``seeded_corpus`` as ``CORPUS_FLIGHTS`` CSVs in the reference's layout
    (``io.save_gp_dataset``), ``flight_<k>.csv`` in ``directory``."""
    import numpy as np

    from unmanned_aerial_vehicles_tpu_torch.io import save_gp_dataset

    X, Y = seeded_corpus()
    for k, rows in enumerate(np.array_split(np.arange(CORPUS_N), CORPUS_FLIGHTS)):
        save_gp_dataset(f"{directory}/flight_{k}.csv", X[rows].astype(np.float64),
                        Y[rows].astype(np.float64))


def run_distributed(dev, fail_fn, kernels, mpc, ref, starts, post, online_cfg, ogp,
                    card: str) -> dict:
    """The full-corpus GP and the sharded sweeps on a world of one (no
    process group; a one-rank NCCL group once), each kernel route against
    its plain twin (``plain_kernels=True``) with the launch counts from 0:

    - ``fit_residual_gp_sharded`` on the seeded corpus (19,816 x 10, 6
      outputs, float32; ``ResidualGPConfig()``, 200 CG iterations, 256
      anchors): every Gram block through K15 (a launch per tile of
      ``GRAM_SHIFT_ROWS`` rows, each on its own shifted coordinates); the posterior means at 2,000
      queries within CORPUS_FIT_REL of y_std of the plain route's;
    - the first DENSE_N rows' kernel fit within DENSE_FIT_REL of y_std of a
      dense float64 Cholesky fit (``fit_residual_gp``) on the card;
    - ``predict_sharded`` (mean and variance) at 256 queries and
      ``lml_grad_sharded`` on 16 probes of one seeded generator, each within
      its bound of the plain route's; three Adam steps
      (``optimize_hyperparameters_sharded``) finite; ``fit_per_dim_gp_sharded``
      (six K15-built fits) finite;
    - the DENSE_N-row fit through a one-rank NCCL group equal bit for bit to
      the fit without a group;
    - ``sharded_structured_flight_sweep`` (1024 flights x 100 ticks,
      ``gp_posterior=``: K8, K7, K2) equal bit for bit to
      ``structured_flight_sweep``'s; ``sharded_flight_sweep`` over the
      multi-tick online flight (K5), 4 flights x 200 ticks, equal per flight
      to the flights run one by one;
    - ``utils.profiling.scan_slope_timeit`` over 10 and 50 K15 launches at
      the corpus within TIMER_REL of ``graph_ms`` on the same launch.

    Records each path's launches under the kernel's ``paths``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
        ResidualGPConfig,
        default_params,
        fit_residual_gp,
    )
    from unmanned_aerial_vehicles_tpu_torch.gp.exact_gp import predict_mean
    from unmanned_aerial_vehicles_tpu_torch.loop import mpc_flight_rollout
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, rbf_pallas
    from unmanned_aerial_vehicles_tpu_torch.parallel import (
        fit_per_dim_gp_sharded,
        fit_residual_gp_sharded,
        lml_grad_sharded,
        make_mesh,
        optimize_hyperparameters_sharded,
        predict_mean_sharded,
        predict_sharded,
        sharded_flight_sweep,
        sharded_structured_flight_sweep,
        structured_flight_sweep,
    )
    from unmanned_aerial_vehicles_tpu_torch.parallel.distributed_gp import (
        GRAM_SHIFT_ROWS,
        rademacher_probes,
    )
    from unmanned_aerial_vehicles_tpu_torch.utils.profiling import scan_slope_timeit

    started = time.perf_counter()
    out = {}
    X, Y = seeded_corpus()
    rng = np.random.default_rng(7)
    queries = X[rng.choice(CORPUS_N, CORPUS_QUERIES, replace=False)]
    queries = queries + 0.05 * rng.normal(size=queries.shape).astype(np.float32)
    mesh = make_mesh(device=dev)
    cfg = ResidualGPConfig()

    def counted(label, fn):
        """``fn()`` with the counts from 0, synchronised and timed: (result,
        seconds, the launches it made)."""
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in _cuda.launch_counts.items() if v}
        return result, seconds, counts

    def record(path, counts, expected):
        for kernel, n in expected.items():
            if counts.get(kernel, 0) != n:
                fail_fn(f"{path}: {kernel} launched {counts.get(kernel, 0)} times, expected {n}")
            kernels[kernel].setdefault("paths", {})[path] = n
        if set(counts) - set(expected):
            fail_fn(f"{path}: launched {sorted(set(counts) - set(expected))} as well")

    def of_scale(got, want, scale):
        return float(((got - want).abs() / scale).max())

    k15 = "rbf_kernel_matrix_pallas"
    tiles = lambda rows: -(-rows // GRAM_SHIFT_ROWS)   # K15 launches of one Gram block
    system = lambda n: 2 * tiles(n) + tiles(min(256, n))   # the block, C and W
    fit = lambda plain, rows=slice(None), **kw: fit_residual_gp_sharded(
        X[rows], Y[rows], mesh=mesh, config=cfg, cg_iterations=200, precond_size=256,
        plain_kernels=plain, **kw)
    post_k, s_k, c_k = counted("fit", lambda: fit(False))
    kernels[k15].setdefault("paths", {})["its own entry point (800-point Gram)"] = (
        kernels[k15]["launches"])
    record("distributed GP: corpus fit", c_k, {k15: system(CORPUS_N)})
    kernels[k15]["launches"] = c_k.get(k15, 0)
    post_p, s_p, c_p = counted("fit plain", lambda: fit(True))
    record("distributed GP: corpus fit, plain twin", c_p, {})
    mean_k = predict_mean_sharded(post_k, queries)
    mean_p = predict_mean_sharded(post_p, queries, plain_kernels=True)
    gap = of_scale(mean_k, mean_p, post_p.y_std)
    rel_res = float(post_k.cg_residual) / math.sqrt(CORPUS_N)
    print(f"distributed GP fit ({CORPUS_N} x {CORPUS_D}, {CORPUS_OUT} outputs, float32, 200 CG "
          f"iterations, 256 anchors): {s_k:.3f} s through K15 ({c_k.get(k15, 0)} launches), "
          f"{s_p:.3f} s plain; CG relative residual {rel_res:.3e} (plain "
          f"{float(post_p.cg_residual) / math.sqrt(CORPUS_N):.3e}); posterior mean at "
          f"{CORPUS_QUERIES} queries within {gap:.3e} of y_std of the plain fit's; card: {card}")
    if not (gap <= CORPUS_FIT_REL and torch.isfinite(mean_k).all()):
        fail_fn(f"corpus fit: posterior mean {gap} of y_std from the plain fit's "
                f"(bound {CORPUS_FIT_REL})")
    out.update(fit_seconds=s_k, fit_seconds_plain=s_p, cg_relative_residual=rel_res,
               mean_gap_of_y_std=gap)
    del post_p, mean_p
    # where a fit's time goes: device-side events of one more kernel-route fit
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit(False)
        torch.cuda.synchronize()
        s_prof = time.perf_counter() - t0
    events = [(e.key, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    part = lambda test: sum(t for k, t in events if test(k.lower())) / 1e6
    busy = part(lambda k: True)
    gram_s = part(lambda k: "rbf_gram" in k)
    matmul_s = part(lambda k: "gemm" in k or "gemv" in k)
    shares = {"fit_seconds_profiled": s_prof, "device_busy_seconds": busy,
              "k15_seconds": gram_s, "matmul_seconds": matmul_s,
              "k15_share": gram_s / s_prof, "matmul_share": matmul_s / s_prof,
              "idle_share": 1.0 - busy / s_prof}
    print(f"  one fit under torch.profiler: {s_prof:.3f} s, device busy {busy * 1e3:.1f} ms "
          f"(K15 {gram_s * 1e3:.2f} ms, the products {matmul_s * 1e3:.1f} ms), K15's share "
          f"{shares['k15_share']:.4f}, the products' {shares['matmul_share']:.4f}, idle "
          f"{shares['idle_share']:.4f}; top device events "
          f"{sorted(events, key=lambda e: -e[1])[:4]}; card: {card}")
    out["fit_shares"] = shares

    # the float32 kernel fit of DENSE_N rows against a dense float64 Cholesky fit
    small = slice(0, DENSE_N)
    post_s, _, c_s = counted("dense", lambda: fit(False, small))
    record(f"distributed GP: {DENSE_N}-row fit", c_s, {k15: system(DENSE_N)})
    f64 = dict(dtype=torch.float64, device=dev)
    dense = fit_residual_gp(torch.tensor(X[small], **f64), torch.tensor(Y[small], **f64), cfg)
    want = predict_mean(dense, torch.tensor(queries, **f64))
    got = predict_mean_sharded(post_s, queries).double()
    dense_gap = of_scale(got, want, dense.y_std)
    print(f"  {DENSE_N}-row float32 kernel fit against a dense float64 Cholesky fit: "
          f"{dense_gap:.3e} of y_std")
    if not dense_gap <= DENSE_FIT_REL:
        fail_fn(f"{DENSE_N}-row fit: {dense_gap} of y_std from the dense float64 fit "
                f"(bound {DENSE_FIT_REL})")
    out["dense_gap_of_y_std"] = dense_gap

    # one-rank NCCL group: the same fit through the collectives, bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            group_mesh = make_mesh(device=dev)
            if group_mesh.group is None:
                fail_fn("make_mesh under a process group made a mesh without it")
            post_g, _, c_g = counted("nccl", lambda: fit_residual_gp_sharded(
                X[small], Y[small], mesh=group_mesh, config=cfg, cg_iterations=200,
                precond_size=256))
        finally:
            dist.destroy_process_group()
    record(f"distributed GP: {DENSE_N}-row fit, one-rank NCCL group", c_g,
           {k15: system(DENSE_N)})
    same = all(torch.equal(a, b) for a, b in ((post_g.alpha, post_s.alpha),
                                               (post_g.cg_residual, post_s.cg_residual)))
    print(f"  the same fit through a one-rank NCCL group: alpha equal bit for bit {same}")
    if not same:
        fail_fn("the fit through a one-rank NCCL group differs from the fit without a group")
    del post_s, post_g, dense

    # mean and variance at PREDICT_Q queries; the LML gradient; Adam; per-dim
    q = queries[:PREDICT_Q]
    (mk, vk), s_pk, c_pk = counted("predict", lambda: predict_sharded(post_k, q, mesh=mesh))
    record("distributed GP: predict_sharded", c_pk, {k15: 2 * tiles(CORPUS_N)})
    mp_, vp = predict_sharded(post_k, q, mesh=mesh, plain_kernels=True)
    pred_gap = max(of_scale(mk, mp_, mp_.abs().max()), of_scale(vk, vp, vp.abs().max()))
    probes = rademacher_probes(CORPUS_N, GRAD_PROBES, torch.Generator().manual_seed(11))
    params = default_params(cfg, device=dev)
    grad = lambda plain: lml_grad_sharded(params, X, Y, mesh=mesh, config=cfg, probes=probes,
                                          plain_kernels=plain)
    g_k, s_gk, c_gk = counted("grad", lambda: grad(False))
    record("distributed GP: lml_grad_sharded", c_gk, {k15: system(CORPUS_N)})
    g_p = grad(True)
    grad_gap = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_k, g_p))
    print(f"  predict_sharded at {PREDICT_Q} queries: {s_pk:.3f} s, mean and variance within "
          f"{pred_gap:.3e} of the plain route's; lml_grad_sharded ({GRAD_PROBES} probes): "
          f"{s_gk:.3f} s, within {grad_gap:.3e} relative of the plain route's "
          f"({[round(float(v), 3) for v in g_k]})")
    if not (pred_gap <= PREDICT_REL and grad_gap <= GRAD_REL):
        fail_fn(f"predict_sharded {pred_gap} (bound {PREDICT_REL}) or lml_grad_sharded "
                f"{grad_gap} (bound {GRAD_REL}) from the plain route")
    del post_k
    p_opt, s_opt, c_opt = counted("adam", lambda: optimize_hyperparameters_sharded(
        params, X, Y, mesh=mesh, config=cfg, steps=ADAM_STEPS,
        generator=torch.Generator().manual_seed(5)))
    record("distributed GP: optimize_hyperparameters_sharded", c_opt,
           {k15: ADAM_STEPS * system(CORPUS_N)})
    model, s_pd, c_pd = counted("per-dim", lambda: fit_per_dim_gp_sharded(X, Y, mesh=mesh))
    record("distributed GP: fit_per_dim_gp_sharded", c_pd, {k15: CORPUS_OUT * system(CORPUS_N)})
    finite = all(bool(torch.isfinite(v).all()) for v in p_opt) and all(
        bool(torch.isfinite(p.alpha).all()) for p in model.posteriors)
    print(f"  {ADAM_STEPS} Adam steps: {s_opt:.3f} s, length scale "
          f"{float(p_opt.length_scale):.4f}, signal variance {float(p_opt.signal_variance):.4f}, "
          f"noise variance {float(p_opt.noise_variance):.4f}; fit_per_dim_gp_sharded: "
          f"{s_pd:.3f} s; all finite {finite}")
    if not finite:
        fail_fn("the Adam steps or the per-dimension fit produced non-finite values")
    out.update(predict_gap=pred_gap, grad_gap=grad_gap, predict_seconds=s_pk,
               grad_seconds=s_gk, adam_seconds=s_opt, per_dim_seconds=s_pd)
    del model
    torch.cuda.empty_cache()

    # the sharded sweeps on the world of one
    gp_kw = dict(gp_posterior=post, gp_cfg=ResidualGPConfig())
    agg, s_sw, c_sw = counted("sweep", lambda: sharded_structured_flight_sweep(
        mesh, mpc, ref, SWEEP_T, starts, **gp_kw))
    record("sharded structured sweep", c_sw, {
        "gpmpc_controller_structured_batched": SWEEP_T, "rbf_posterior_mean_pallas": SWEEP_T,
        "allocation_plant_tick_fused": SWEEP_T})
    one = structured_flight_sweep(mpc, ref, SWEEP_T, starts, device=dev, **gp_kw)
    sweep_equal = (torch.equal(agg["rms_per_flight"], one["rms_per_flight"])
                   and torch.equal(agg["rms_max"], one["rms_max"])
                   and abs(float(agg["rms_mean"]) - float(one["rms_mean"]))
                   <= 1e-7 * float(one["rms_mean"]))
    rollout = lambda x0: mpc_flight_rollout(mpc, ref, FLIGHT_SWEEP_T, cfg=online_cfg,
                                            online_gp=ogp, gp_gain=0.1, initial_state=x0,
                                            device=dev)
    x0s = starts[:FLIGHT_SWEEP_B].clone()
    flights, s_fl, c_fl = counted("flights", lambda: sharded_flight_sweep(mesh, rollout, x0s))
    record("sharded flight sweep (multi-tick online flight)", c_fl, {
        "gpmpc_multitick_fused": FLIGHT_SWEEP_B * FLIGHT_SWEEP_T // K_TICKS})
    alone = []
    for x0 in x0s:
        o = rollout(x0)
        alone.append(torch.sqrt(torch.mean(torch.sum((o["pos_ref"] - o["state"][:, 0:3]) ** 2,
                                                     dim=-1))))
    flights_equal = torch.equal(flights["rms_per_flight"], torch.stack(alone))
    print(f"  sharded_structured_flight_sweep ({SWEEP_B} flights x {SWEEP_T} ticks, K8, K7, K2): "
          f"{s_sw:.3f} s, rms_mean {float(agg['rms_mean']):.6f} m, rms_max "
          f"{float(agg['rms_max']):.6f} m, equal to structured_flight_sweep's {sweep_equal}; "
          f"sharded_flight_sweep ({FLIGHT_SWEEP_B} online flights x {FLIGHT_SWEEP_T} ticks, K5): "
          f"{s_fl:.3f} s, equal per flight to the flights alone {flights_equal}")
    if not (sweep_equal and flights_equal):
        fail_fn("a sharded sweep on the world of one differs from the sweep on one card")
    out.update(sweep_rms_mean_m=float(agg["rms_mean"]), sweep_seconds=s_sw,
               flight_sweep_rms_m=[float(v) for v in flights["rms_per_flight"]])

    # the profiling timer against graph_ms on the same K15 launch
    Xc = torch.tensor(X, dtype=torch.float32, device=dev)
    iso, sig = torch.tensor(0.5, device=dev), torch.tensor(1.0, device=dev)
    launch = lambda: rbf_pallas.rbf_kernel_matrix_pallas(Xc, Xc, iso, sig)

    def make_fn(T):
        def run():
            K = None
            for _ in range(T):
                K = launch()
            return K
        return run

    slope = scan_slope_timeit(make_fn, *TIMER_LAUNCHES)
    graph = graph_ms(launch, 5)
    timer_gap = abs(slope["per_iter_s"] * 1e3 - graph) / graph
    print(f"  utils.profiling.scan_slope_timeit over {TIMER_LAUNCHES} K15 launches at the "
          f"corpus: {slope['per_iter_s'] * 1e6:.2f} us a launch against graph_ms "
          f"{graph * 1e3:.2f} us ({timer_gap:.3%} apart); card: {card}")
    if not timer_gap <= TIMER_REL:
        fail_fn(f"scan_slope_timeit is {timer_gap:.3%} from graph_ms (bound {TIMER_REL:.0%})")
    out.update(timer_us=slope["per_iter_s"] * 1e6, graph_us=graph * 1e3)
    del Xc
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - started
    print(f"distributed block: {out['seconds']:.1f} s")
    if not out["seconds"] <= DISTRIBUTED_BUDGET_S:
        fail_fn(f"the distributed block took {out['seconds']:.1f} s, over its "
                f"{DISTRIBUTED_BUDGET_S:.0f} s")
    return out


# ---- the command line and the examples (run_surface) -------------------------

SURFACE_BUDGET_S = 90.0
SURFACE_WORKER_S = 300        # a worker's time limit (its process builds nothing)
SURFACE_EXAMPLE_WORKERS = 5   # worker processes for the examples, each claiming the next
SURFACE_WORKER_THREADS = 2    # CPU threads of each process beside them
K1, K2, K3 = "px4_plant_step_fused", "allocation_plant_tick_fused", "gpmpc_controller_fused"
K5, K9, K10 = "gpmpc_multitick_fused", "gpmpc_noisy_multitick_fused", "rigid_body_rollout_fused"
K11, K12 = "direct_rate_multitick_kernel", "mppi_rollout_costs_fused"
K13A, K13B = "px4_plant_step_vjp", "allocation_plant_tick_vjp"
K15, K16 = "rbf_kernel_matrix_pallas", "gpmpc_controller_fused_batched"
# (label, argv after the command's own name, kernels it must launch); the
# CLI's widths, cut in length only; "{tmp}" is the block's directory
SURFACE_COMMANDS = (
    ("fly gp-mpc --fast --online", ["fly", "--controller", "gp-mpc", "--fast", "--online",
                                    "--duration", "20"], (K5,)),
    ("fly mpc --fast --noisy", ["fly", "--controller", "mpc", "--fast", "--noisy",
                                "--duration", "10"], (K9,)),
    ("fly gp-mpc --fast --gp-data", ["fly", "--controller", "gp-mpc", "--fast", "--gp-data",
                                     "{tmp}/*.csv", "--duration", "10"], (K5,)),
    ("fly pid --save-log", ["fly", "--controller", "pid", "--duration", "10", "--save-log",
                            "{tmp}/f.uavlog"], (K1,)),
    ("analyze", ["analyze", "--log", "{tmp}/f.uavlog"], ()),
    ("fly mpc12", ["fly", "--controller", "mpc12", "--duration", "0.6", "--amplitude", "2"],
     (K10,)),
    ("fly mpc12 --fast", ["fly", "--controller", "mpc12", "--fast", "--duration", "4",
                          "--amplitude", "2"], (K10,)),
    ("fly direct-rate12 --fast", ["fly", "--controller", "direct-rate12", "--fast",
                                  "--duration", "10", "--amplitude", "2"], (K11,)),
    ("fly ilqr12 --fast", ["fly", "--controller", "ilqr12", "--fast", "--duration", "1",
                           "--amplitude", "2"], (K10,)),
    ("fly mppi12", ["fly", "--controller", "mppi12", "--duration", "4", "--amplitude", "2",
                    "--trajectory", "circle"], (K12, K10)),
    ("fly ltv12 --fast --obstacle", ["fly", "--controller", "ltv12", "--fast", "--duration", "8",
                                     "--trajectory", "circle", "--amplitude", "1.5",
                                     "--obstacle", "0,1.5,3.0,0.3"], (K10,)),
    ("mission", ["mission", "--duration", "25", "--amplitude", "3"], (K3, K1)),
    ("online", ["online", "--duration", "12", "--gp-capacity", "64", "--refit-every", "100"],
     (K3, K1)),
    ("compare", ["compare", "--duration", "5"], ()),
    ("sweep", ["sweep", "--flights", "8", "--duration", "4"], (K3, K2)),
    ("tune pid", ["tune", "--controller", "pid", "--iterations", "2", "--duration", "5"],
     (K1, K13A)),
    ("tune mpc", ["tune", "--controller", "mpc", "--iterations", "2", "--duration", "0.5"],
     (K2, K13B)),
    ("montecarlo mpc", ["montecarlo", "--controller", "mpc", "--duration", "4"], (K16, K2)),
    ("train-gp --all-samples", ["train-gp", "--data", "{tmp}/*.csv", "--all-samples",
                                "--output", "{tmp}/all/gp.npz"], (K15,)),
    ("train-gp", ["train-gp", "--data", "{tmp}/*.csv", "--output", "{tmp}/dense/gp.npz"], ()),
    ("evaluate-gp", ["evaluate-gp", "--model", "{tmp}/dense/gp.npz", "--data",
                     "{tmp}/flight_0.csv", "--output", "{tmp}/dense/eval"], ()),
)
SURFACE_DATA_EXAMPLES = ("01", "02", "06")    # take the CSVs' glob as their argument
# commands flown shorter than their tests/test_cli.py bar needs, so that the
# bar cannot fail; each is flown again with --device cpu (the plain versions)
# and held to the card's JSON
SURFACE_CPU_TWINS = ("fly mpc12", "tune mpc")


def surface_bars(label: str, out: dict, text: str, tmp: str):
    """The bar of each command, from the JAX package's ``tests/test_cli.py``
    (``None`` when it holds)."""
    finite = all(v is None or math.isfinite(v) for v in out.values()
                 if isinstance(v, (int, float)))
    if label.startswith("fly") and not finite:
        return "non-finite metrics"
    bars = {
        "fly mpc12": out.get("rms_pos", 9) < 1.3,                       # test_cli.py:76-80
        "fly mpc12 --fast": out.get("rms_pos", 9) < 1.5,                # :217-228
        "fly direct-rate12 --fast": out.get("rms_pos", 9) < 1.5,
        "fly ilqr12 --fast": out.get("rms_pos", 9) < 3.0,
        "fly mppi12": out.get("rms_pos", 9) < 1.3,                      # :145-150
        "fly ltv12 --fast --obstacle": (out.get("rms_pos", 9) < 1.0     # :240-256
                                        and "multitick tier: ltv12" in text
                                        and "min_obstacle_clearance" in out),
        "fly pid --save-log": os.path.exists(f"{tmp}/f.uavlog"),
        "analyze": out.get("rms_pos", -1) >= 0.0,                       # :128-136
        "mission": (out.get("phases_reached") == 5                      # :50-54
                    and abs(out.get("takeoff_altitude_m", 0) - 3.0) < 0.5),
        "online": out.get("gp_samples_collected", 0) > 30 and out.get("gp_active_final") is True,
        "compare": set(out) == {"hover", "circle", "figure8", "step"},
        "sweep": out.get("devices") == 1 and out.get("flights") == 8 and finite,
        "tune pid": out.get("rms_pos_m_after", 9) <= out.get("rms_pos_m_before", 0),
        "tune mpc": out.get("loss_final", 9) <= out.get("loss_initial", 0),
        "montecarlo mpc": (0.0 <= (out.get("success_rate") or 0.0) <= 1.0
                           and out.get("rms_pos_m_p50", 9) <= out.get("rms_pos_m_p99", 0) + 1e-9),
        "train-gp --all-samples": ("sharded fit: n=" in text and "over 1 device(s)" in text
                                   and os.path.exists(f"{tmp}/all/gp.npz")),
        "train-gp": os.path.islink(f"{tmp}/dense/gp_model_latest.npz"),
        "evaluate-gp": "global" in out and "acc_only" in out,
    }
    return None if bars.get(label, finite) else f"its bar failed: {out}"


def twin_gaps(label: str, card: dict, cpu: dict) -> dict:
    """The keys of a SURFACE_CPU_TWINS command's JSON on which the card
    and the CPU twin disagree beyond the bars of the kernel-against-plain
    flights and tuners (empty when they agree): ``fly mpc12`` its positions
    within SQP_GAP_BOUND_M; ``tune mpc`` its losses within TUNER_TRACE_RTOL
    (printed to 5 places), the flights' RMS within SINGLE_GAP_BOUND_M and
    the tuned weights within TUNER_TRACE_RTOL (printed to 3 places)."""
    if label == "fly mpc12":
        pairs = [(k, card[k], cpu[k], SQP_GAP_BOUND_M) for k in ("rms_pos", "max_pos")]
    else:
        pairs = [(k, card[k], cpu[k], TUNER_TRACE_RTOL * abs(cpu[k]) + 5e-6)
                 for k in ("loss_initial", "loss_final")]
        pairs += [(k, card[k], cpu[k], SINGLE_GAP_BOUND_M)
                  for k in ("rms_pos_m_before", "rms_pos_m_after")]
        as_list = lambda v: v if isinstance(v, list) else [v]
        for k, want in cpu["tuned"].items():
            got = as_list(card["tuned"].get(k, []))
            if len(got) != len(as_list(want)):
                pairs.append((f"tuned.{k}", math.inf, 0.0, 0.0))
            for i, (a, b) in enumerate(zip(got, as_list(want))):
                pairs.append((f"tuned.{k}[{i}]", a, b, TUNER_TRACE_RTOL * abs(b) + 1e-3))
    return {k: (a, b) for k, a, b, bound in pairs if not abs(a - b) <= bound}


def run_examples(data_glob: str, claims: str) -> dict:
    """The numbered ``examples_torch/`` scripts from the last to the first,
    each that this process is the first to claim (a file of its two-digit
    prefix created in the directory ``claims``), through ``runpy`` in this
    process with ``UAV_FAST_EXAMPLES=1`` on the default device
    (``SURFACE_DATA_EXAMPLES`` given ``data_glob``), the launch counts from
    0 around each: seconds, launches and the last printed line of each.
    Raises SystemExit when one exits or prints nothing."""
    import contextlib
    import io
    import runpy

    import torch

    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda

    out = {}
    os.environ["UAV_FAST_EXAMPLES"] = "1"
    os.environ.pop("UAV_EXAMPLES_DEVICE", None)
    for path in sorted((ROOT / "examples_torch").glob("[0-9]*.py"), reverse=True):
        name = path.name[:2]
        try:
            os.close(os.open(os.path.join(claims, name), os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            continue
        sys.argv = [str(path)] + ([data_glob] if name in SURFACE_DATA_EXAMPLES else [])
        _cuda.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(str(path), run_name="__main__")
        except SystemExit as exit_:
            fail(f"{path.name} exited: {exit_}")
        torch.cuda.synchronize()
        text = buf.getvalue().strip()
        if not text:
            fail(f"{path.name} printed nothing")
        out[path.name] = {"seconds": time.perf_counter() - t0,
                          "launches": {k: v for k, v in _cuda.launch_counts.items() if v},
                          "last_line": text.splitlines()[-1][:200]}
    return out


def run_examples_main(data_glob: str, claims: str) -> int:
    """``--run-examples GLOB CLAIMS``: ``run_examples`` in a worker process
    of ``run_surface``, on SURFACE_WORKER_THREADS threads; its result as the
    last line of standard output."""
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(SURFACE_WORKER_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(run_examples(data_glob, claims)), flush=True)
    return 0


def run_surface(dev, fail_fn, kernels, card: str) -> dict:
    """The command line and the examples on the card, with the launch
    counts from 0 around each part:

    - the seeded corpus (``seeded_corpus``: 19,816 rows) written as CSVs in
      the reference's layout into a temporary directory;
    - each of SURFACE_COMMANDS through ``cli.main`` in this process (the
      default device, ``cuda``), one after another with nothing else on
      the card or the host, its JSON parsed from its first ``{`` and held
      to its bar from the JAX package's ``tests/test_cli.py``; each must
      launch the kernels listed beside it;
    - the JSON of ``fly --controller gp-mpc --fast --online`` equal to the
      metrics of the same ``mpc_flight_rollout`` called directly with the
      same configs;
    - then the 15 ``examples_torch/`` scripts in SURFACE_EXAMPLE_WORKERS
      worker processes (``--run-examples``: each claims the next script
      from the last to the first and runs it through ``runpy`` in its own
      process, ``UAV_FAST_EXAMPLES=1``, the default device, 01, 02 and 06
      given the CSVs' glob), ``python -m
      unmanned_aerial_vehicles_tpu_torch fly --controller mpc --fast
      --duration 2`` in a process of its own, and beside them in this
      process the SURFACE_CPU_TWINS commands again with ``--device cpu``,
      held to the card's JSON (``twin_gaps``); each process must exit 0,
      the examples print something, ``python -m`` JSON.

    Every command's and example's launches are recorded under the kernels'
    ``paths``. The block must take at most SURFACE_BUDGET_S."""
    import contextlib
    import io

    import torch

    from unmanned_aerial_vehicles_tpu_torch import cli
    from unmanned_aerial_vehicles_tpu_torch.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import ResidualGPConfig
    from unmanned_aerial_vehicles_tpu_torch.loop import (
        FlightLoopConfig,
        OnlineFusedGPConfig,
        mpc_flight_rollout,
    )
    from unmanned_aerial_vehicles_tpu_torch.metrics import tracking_metrics
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda

    started = time.perf_counter()
    out = {"seconds_by_part": {}, "commands": {}, "examples": {}, "cpu_twins": {}}
    parts = out["seconds_by_part"]

    def record(path, counts, expected=()):
        for kernel, n in counts.items():
            kernels[kernel].setdefault("paths", {})[path] = n
        missing = [k for k in expected if not counts.get(k)]
        if missing:
            fail_fn(f"{path}: launched no {missing} (launched {counts})")

    def run_cli(argv):
        """``cli.main(argv)``: its exit code, its printed text and its
        JSON from the first ``{`` (train-gp prints none)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        text = buf.getvalue()
        payload = json.JSONDecoder().raw_decode(text, text.index("{"))[0] if "{" in text else {}
        return rc, text, payload

    scripts = sorted(p.name for p in (ROOT / "examples_torch").glob("[0-9]*.py"))
    if len(scripts) != 15:
        fail_fn(f"examples_torch/ holds {len(scripts)} numbered scripts, not 15")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS=str(SURFACE_WORKER_THREADS))
    popen = lambda argv: subprocess.Popen(argv, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True)
    workers = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_corpus_csvs(tmp)
        for sub in ("all", "dense", "claims"):
            os.makedirs(f"{tmp}/{sub}")
        parts["corpus CSVs"] = time.perf_counter() - t0

        argvs = {}
        for label, argv, expected in SURFACE_COMMANDS:
            argvs[label] = argv = [a.format(tmp=tmp) for a in argv]
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            rc, text, payload = run_cli(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = {k: v for k, v in _cuda.launch_counts.items() if v}
            record(f"cli: {label}", counts, expected)
            if rc != 0:
                fail_fn(f"cli {label}: exit {rc}, printed {text[-500:]!r}")
            bar = surface_bars(label, payload, text, tmp)
            if bar is not None:
                fail_fn(f"cli {label}: {bar}")
            parts[f"cli: {label}"] = seconds
            out["commands"][label] = {"seconds": seconds, "launches": counts, "json": payload}
            print(f"  cli {label}: {seconds:.2f} s, launches {counts}; "
                  f"{json.dumps(payload)[:160]}")

        # the CLI passes its configs through intact: the same flight called directly
        t0 = time.perf_counter()
        flight = FlightLoopConfig(use_fused_tick=True, fused_tick_loop_precision="default",
                                  ticks_per_dispatch=8)
        steps = int(20.0 / flight.control_dt)
        steps -= steps % 8
        mpc = LinearMPC(LinearMPCConfig(horizon=20, admm_iterations=10,
                                        use_fused_controller=True), device=dev)
        gcfg = ResidualGPConfig()
        ref = cli._reference_fn("figure8", 6.0, flight.takeoff_height)
        o = mpc_flight_rollout(mpc, ref, steps, cfg=flight,
                               online_gp=OnlineFusedGPConfig(gp=gcfg),
                               gp_gain=gcfg.residual_gain, device=dev)
        m = tracking_metrics(o["pos_ref"], o["state"][:, 0:3], vel_setpoint=o["vel_ref"],
                             vel_current=o["state"][:, 3:6], att_setpoint=o["att_ref"],
                             att_current=o["state"][:, 6:9], thrust_normalized=o["thrust"])
        direct = {k: round(float(v), 4) for k, v in m.items()}
        via_cli = out["commands"]["fly gp-mpc --fast --online"]["json"]
        print(f"  the CLI's online flight against mpc_flight_rollout called directly: "
              f"equal {direct == via_cli} (rms_pos {via_cli['rms_pos']} and "
              f"{direct['rms_pos']})")
        if direct != via_cli:
            fail_fn(f"the CLI's online flight {via_cli} differs from the direct call "
                    f"{direct}")
        out["cli_equals_direct_call"] = True
        parts["direct call"] = time.perf_counter() - t0

        # the examples and python -m in processes of their own, the CPU twins here
        t0 = time.perf_counter()
        try:
            for _ in range(SURFACE_EXAMPLE_WORKERS):
                workers.append(popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                      "--run-examples", f"{tmp}/*.csv", f"{tmp}/claims"]))
            workers.append(popen([sys.executable, "-m", PKG, "fly", "--controller", "mpc",
                                  "--fast", "--duration", "2"]))
            threads = torch.get_num_threads()
            torch.set_num_threads(SURFACE_WORKER_THREADS)
            try:
                for label in SURFACE_CPU_TWINS:
                    t1 = time.perf_counter()
                    rc, text, twin = run_cli(argvs[label] + ["--device", "cpu"])
                    if rc != 0:
                        fail_fn(f"cli {label} --device cpu: exit {rc}, printed {text[-500:]!r}")
                    card_json = out["commands"][label]["json"]
                    gaps = twin_gaps(label, card_json, twin)
                    out["cpu_twins"][label] = {"seconds": time.perf_counter() - t1,
                                               "json": twin}
                    print(f"  cli {label} --device cpu (its plain twin, beside the workers): "
                          f"{out['cpu_twins'][label]['seconds']:.2f} s; "
                          f"{json.dumps(twin)[:160]}; gaps over the bars {gaps}")
                    if gaps:
                        fail_fn(f"cli {label}: the card's JSON and --device cpu's differ "
                                f"beyond their bars: {gaps}")
            finally:
                torch.set_num_threads(threads)
            results = []
            for proc in workers:
                try:
                    results.append(proc.communicate(timeout=SURFACE_WORKER_S))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    results.append(proc.communicate())
            parts["examples, python -m and the CPU twins, side by side"] = (
                time.perf_counter() - t0)
        finally:
            for proc in workers:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    for proc, (stdout, stderr) in zip(workers, results):
        if proc.returncode != 0 or "{" not in stdout:
            fail_fn(f"{' '.join(proc.args[1:4])}: exit {proc.returncode}, "
                    f"{stdout[-400:]} {stderr[-1200:]}")
    module_json = json.loads(results[-1][0][results[-1][0].index("{"):])
    print(f"  python -m {PKG} fly --controller mpc --fast --duration 2: exit 0, "
          f"rms_pos {module_json['rms_pos']}")
    out["python_m_rms_pos"] = module_json["rms_pos"]
    for k, (stdout, _) in enumerate(results[:-1]):
        for name, ex in json.loads(stdout.strip().splitlines()[-1]).items():
            record(f"examples_torch/{name}", ex["launches"])
            out["examples"][name] = ex | {"worker": k}
            print(f"  examples_torch/{name}: {ex['seconds']:.2f} s (worker {k}, beside the "
                  f"others), launches {ex['launches']}; {ex['last_line'][:120]}")
    if sorted(out["examples"]) != scripts:
        fail_fn(f"the workers ran {sorted(out['examples'])}, not {scripts}")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - started
    print(f"surface block: {out['seconds']:.1f} s (by part: "
          f"{ {k: round(v, 2) for k, v in parts.items()} }; the commands alone, one after "
          f"another; the examples in their workers: "
          f"{ {k: round(v['seconds'], 2) for k, v in out['examples'].items()} }); card: {card}")
    if not out["seconds"] <= SURFACE_BUDGET_S:
        fail_fn(f"the surface block took {out['seconds']:.1f} s, over its "
                f"{SURFACE_BUDGET_S:.0f} s")
    return out


CAMPAIGN_BUDGET_S = 60.0
CAMPAIGN_DURATION_S = 4.0     # 200 ticks: a multiple of the fused rows' 8
# the campaign's windows cut for the block (tools_torch/run_campaign.py's
# module constants; the comparisons keep their 30 s): the tuner 2 iterations
# of 2 s, the populations 2 s, every settle window 0.5 s
CAMPAIGN_WINDOWS = dict(TUNE_WINDOW_S=2.0, TUNE_ITERATIONS=2, TUNE_SETTLE_S=0.5,
                        MC_WINDOW_S=2.0, MC_SETTLE_S=0.5, GUST_SETTLE_S=0.5)
CAMPAIGN_ROWS = 29
K4 = "gpmpc_tick_fused"
CAMPAIGN_KERNELS = (K1, K2, K3, K4, K5, K9, K13A, K16)
CAMPAIGN_ORACLE = "mpc_oracle_residual_windy_figure8"
GATE_WORDS = (" BEATS ", " WORSE THAN ", " TIES ", " DIVERGES FROM ")


def load_campaign():
    """``tools_torch/run_campaign.py`` as a module (it is a script, not a
    package member)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("run_campaign",
                                                  ROOT / "tools_torch" / "run_campaign.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_campaign_block(dev, fail_fn, kernels, card: str) -> dict:
    """The experiment campaign (``tools_torch/run_campaign.py``) on the card:

    - ``main(["--duration", "4", "--gp-data", ...])`` on the default device
      over the seeded corpus's CSVs (``write_corpus_csvs``), its windows cut
      by CAMPAIGN_WINDOWS, with the launch counts from 0 around it: every
      one of the CAMPAIGN_ROWS rows present and finite, K1, K2, K3, K4, K5,
      K9, K13a and K16 each launched, K4 exactly once a tick of the oracle
      row and by no other; each row's launches (the tool's
      ``kernel_launches.json``) recorded under the kernels' ``paths``;
    - four rows flown again with ``plain_kernels=True``, each against the
      same row through the kernels, its position gap at every tick within
      the bar of its tier: the staged ``mpc_flight_figure8`` (K3, K2) and
      the oracle row (K4) within SINGLE_GAP_BOUND_M, the fresh online row
      (K5) within ONLINE_GAP_BOUND_M, the fused observer row under the gust
      (K9, the same generator seed) within NOISY_GAP_BOUND_M. The kernel
      rows are main's own logs; the oracle row, which has none, is flown
      again through K4 (its RMS printed beside main's).

    The block must take at most CAMPAIGN_BUDGET_S."""
    import contextlib
    import importlib.util
    import io

    import numpy as np
    import torch

    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda

    started = time.perf_counter()
    campaign = load_campaign()
    for name, value in CAMPAIGN_WINDOWS.items():
        setattr(campaign, name, value)
    duration = CAMPAIGN_DURATION_S
    out = {"windows": CAMPAIGN_WINDOWS, "duration_s": duration, "twins": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_corpus_csvs(tmp)
        out["corpus_csv_s"] = time.perf_counter() - t0
        campaign.ARTIFACTS = f"{tmp}/main"
        buf = io.StringIO()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = campaign.main(["--duration", str(duration), "--gp-data", f"{tmp}/*.csv"])
        torch.cuda.synchronize()
        out["main_s"] = time.perf_counter() - t0
        counts = {k: v for k, v in _cuda.launch_counts.items() if v}
        text = buf.getvalue()
        if rc != 0:
            fail_fn(f"campaign main: exit {rc}, printed {text[-500:]!r}")
        with open(f"{tmp}/main/metrics_summary.json") as f:
            rows = json.load(f)["ours"]
        with open(f"{tmp}/main/kernel_launches.json") as f:
            row_log = json.load(f)["rows"]
        numbers = lambda row: [v for x in row.values() if not isinstance(x, str)
                               for v in (x if isinstance(x, list) else [x])]
        bad = [name for name, row in rows.items()
               if not all(math.isfinite(v) for v in numbers(row))]
        if len(rows) != CAMPAIGN_ROWS or bad:
            fail_fn(f"campaign: {len(rows)} rows (want {CAMPAIGN_ROWS}), non-finite {bad}")
        missing = [k for k in CAMPAIGN_KERNELS if not counts.get(k)]
        ticks = int(round(duration / 0.02))
        k4_rows = {name: r["launches"][K4] for name, r in row_log.items() if K4 in r["launches"]}
        if missing or counts.get(K4) != ticks or k4_rows != {CAMPAIGN_ORACLE: ticks}:
            fail_fn(f"campaign: launched no {missing}; K4 {counts.get(K4)} times by {k4_rows}, "
                    f"want {ticks} by {CAMPAIGN_ORACLE} alone (launched {counts})")
        if importlib.util.find_spec("matplotlib") is None and "plots skipped" not in text:
            fail_fn("campaign: matplotlib is missing and no line said the plots were skipped")
        for name, r in row_log.items():
            for kernel, n in r["launches"].items():
                kernels[kernel].setdefault("paths", {})[f"campaign: {name}"] = n
        out |= {"launches": counts, "rows": rows, "row_log": row_log,
                "gates": [ln for ln in text.splitlines() if any(w in ln for w in GATE_WORDS)]}
        print(f"  campaign main (--duration {duration:g}, windows {CAMPAIGN_WINDOWS}): "
              f"{out['main_s']:.2f} s, launches {counts}")
        for name, r in row_log.items():
            first = next(iter(rows[name].items()))
            print(f"    {name}: {first[0]} {first[1]}, "
                  f"{r['seconds']:.2f} s, launches {r['launches']}")
        for line in out["gates"]:
            print(f"    {line}")

        # the plain twins on the card, beside the kernel rows
        campaign.ARTIFACTS = f"{tmp}/twins"
        scratch = {}
        kw = dict(device=dev, plain_kernels=True)
        twins = (
            ("mpc_flight_figure8", SINGLE_GAP_BOUND_M,
             lambda **k: campaign.baseline_rows(scratch, duration, None, **k)),
            (CAMPAIGN_ORACLE, SINGLE_GAP_BOUND_M,
             lambda **k: campaign.fused_online_rows(scratch, duration, **k)),
            ("gpmpc_online_fresh_windy_figure8", ONLINE_GAP_BOUND_M,
             lambda **k: campaign.fused_online_rows(scratch, duration, **k)),
            ("mpc_dob_gusty_fused_figure8", NOISY_GAP_BOUND_M,
             lambda **k: campaign.gusty_rows(scratch, duration, **k)),
        )
        for name, bound, section in twins:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                if name == CAMPAIGN_ORACLE:
                    kernel_pos = section(device=dev, rows=(name,))[name]["state"][:, 0:3]
                    again = scratch[name]["rms_pos"]
                else:
                    kernel_pos = np.load(f"{tmp}/main/{name}.npz")["state"][:, 0:3]
                plain = section(rows=(name,), **kw)[name]
            torch.cuda.synchronize()
            plain_pos = plain["state"][:, 0:3]
            if plain_pos.shape != kernel_pos.shape or not np.isfinite(plain_pos).all():
                fail_fn(f"campaign twin {name}: shape {plain_pos.shape} against "
                        f"{kernel_pos.shape}, or non-finite")
            gap = float(np.abs(plain_pos - kernel_pos).max())
            out["twins"][name] = {"gap_m": gap, "bound_m": bound,
                                  "plain_rms_pos": scratch[name]["rms_pos"],
                                  "seconds": time.perf_counter() - t0}
            again_note = (f"; flown again through K4: rms_pos {again} (main's "
                          f"{rows[name]['rms_pos']})" if name == CAMPAIGN_ORACLE else "")
            print(f"  campaign twin {name}: max position gap to the plain versions "
                  f"{gap:.3e} m (bar {bound:g}), rms_pos plain {scratch[name]['rms_pos']} "
                  f"against {rows[name]['rms_pos']}{again_note}")
            if not gap <= bound:
                fail_fn(f"campaign twin {name}: position gap {gap} > {bound}")
    out["seconds"] = time.perf_counter() - started
    print(f"campaign block: {out['seconds']:.1f} s (main {out['main_s']:.1f} s, the twins "
          f"{ {k: round(v['seconds'], 2) for k, v in out['twins'].items()} }); card: {card}")
    if not out["seconds"] <= CAMPAIGN_BUDGET_S:
        fail_fn(f"the campaign block took {out['seconds']:.1f} s, over its "
                f"{CAMPAIGN_BUDGET_S:.0f} s")
    return out


def write_corpus_main(directory: str) -> int:
    """``--write-corpus DIR``: the seeded corpus's CSVs into DIR (for a
    campaign run from the command line: ``--gp-data 'DIR/*.csv'``)."""
    sys.path.insert(0, str(ROOT))
    os.makedirs(directory, exist_ok=True)
    write_corpus_csvs(directory)
    print(f"wrote {CORPUS_FLIGHTS} CSVs of the seeded corpus ({CORPUS_N} rows) into {directory}")
    return 0


def time_multistart_tuner(dev, fail_fn, card: str) -> dict:
    """The multi-start cascade-PID tuner (TUNE_MS_STARTS starts, TUNE_MS_T
    ticks of the CLI task, TUNE_MS_ITERS iterations, K1 forward and K13a
    backward) flown as one batch (``tune_cascade_gains_multistart``) and
    the same starts run one after another (``tune_parameters`` per start);
    the best start must agree and every start's final loss within
    TUNE_MS_RTOL relative. Host wall clocks of both, each ended by a
    synchronize, with the batched run's launch counts."""
    import torch

    from unmanned_aerial_vehicles_tpu_torch.control.cascade_pid import CascadePidGains
    from unmanned_aerial_vehicles_tpu_torch.loop import FlightLoopConfig
    from unmanned_aerial_vehicles_tpu_torch.models import PID_CAMPAIGN_RATE_LOOP
    from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda
    from unmanned_aerial_vehicles_tpu_torch.tuning import (
        TuneConfig,
        tune_cascade_gains_multistart,
        tune_parameters,
    )
    from unmanned_aerial_vehicles_tpu_torch.tuning.autotune import (
        _cascade_loss_fn,
        _cascade_population_loss_fn,
        _cascade_theta,
        _f32_gains,
        _multistart_thetas,
        _tune_stacked,
    )

    cfg = TuneConfig(iterations=TUNE_MS_ITERS, learning_rate=PID_TUNE_LR,
                     settle_steps=TUNE_MS_SETTLE)
    loop = FlightLoopConfig(use_pallas_plant=True, fused_tick_ad=True)
    args = (tune_circle, TUNE_MS_T)
    template = _f32_gains(CascadePidGains.default(device=dev), dev)
    thetas = _multistart_thetas(_cascade_theta(template), TUNE_MS_STARTS, 0.3, 0)
    common = (template, cfg, RigidBodyParams(), PID_CAMPAIGN_RATE_LOOP, loop, dev, False)
    batched_loss = _cascade_population_loss_fn(*args, *common)
    one_loss = _cascade_loss_fn(*args, *common)
    # warm both routes (first calls allocate and load)
    _tune_stacked(batched_loss, {k: v[:2] for k, v in thetas.items()}, 1, cfg.learning_rate)
    tune_parameters(one_loss, {k: v[0] for k, v in thetas.items()}, 1, cfg.learning_rate)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    result = tune_cascade_gains_multistart(*args, n_starts=TUNE_MS_STARTS, tune_cfg=cfg,
                                           rate_loop=PID_CAMPAIGN_RATE_LOOP, loop_cfg=loop,
                                           device=dev)
    float(result.final_loss)
    batched_s = time.perf_counter() - t0
    counts = {k: _cuda.launch_counts[k] for k in ("px4_plant_step_fused", "px4_plant_step_vjp")}
    _, _, finals = _tune_stacked(batched_loss, thetas, cfg.iterations, cfg.learning_rate)
    t0 = time.perf_counter()
    runs = [tune_parameters(one_loss, {k: v[i] for k, v in thetas.items()}, cfg.iterations,
                            cfg.learning_rate) for i in range(TUNE_MS_STARTS)]
    seq = torch.stack([r[2] for r in runs])
    float(seq.sum())
    sequential_s = time.perf_counter() - t0
    T, I = TUNE_MS_T, TUNE_MS_ITERS
    # I flights with their backward, the final iterate's and start 0's
    # initial loss: T (I + 2) K1 launches, (T - 1) I K13a (the last tick's
    # new state enters no loss term)
    expected = {"px4_plant_step_fused": T * (I + 2), "px4_plant_step_vjp": (T - 1) * I}
    if counts != expected:
        fail_fn(f"batched multi-start tuner: launches {counts}, expected {expected}")
    best_b, best_s = int(torch.argmin(finals)), int(torch.argmin(seq))
    rel = float(((finals - seq).abs() / seq.abs()).max())
    print(f"multi-start tuner ({TUNE_MS_STARTS} starts, {T} ticks, {I} iterations, K1 + K13a): "
          f"one batch {batched_s:.3f} s, one start after another {sequential_s:.3f} s "
          f"({sequential_s / batched_s:.2f}x); best start {best_b} and {best_s}; final losses "
          f"{[round(float(v), 6) for v in finals]}, max relative gap {rel:.3e}; launches "
          f"{counts}; card: {card}")
    if best_b != best_s or not rel <= TUNE_MS_RTOL:
        fail_fn(f"batched multi-start tuner disagrees with the sequential starts: best "
                f"{best_b} vs {best_s}, relative gap {rel}")
    return dict(batched_s=batched_s, sequential_s=sequential_s, best=best_b, rel_gap=rel,
                final_losses=[float(v) for v in finals], launches=counts)


def main(parent: str | None = None) -> int:
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
    from unmanned_aerial_vehicles_tpu_torch.estimation import noisy_mpc_flight_rollout
    from unmanned_aerial_vehicles_tpu_torch.gp.residual_gp import (
        ResidualDataset,
        ResidualGPConfig,
        build_horizon_residuals,
        build_horizon_uncertainty,
        fit_residual_gp,
        fit_residual_gp_masked,
        make_output_correction_fn,
    )
    from unmanned_aerial_vehicles_tpu_torch.io import load_resume_state, save_resume_state
    from unmanned_aerial_vehicles_tpu_torch.loop import (
        FlightLoopConfig,
        OnlineFusedGPConfig,
        batched_mpc_flight_sweep,
        mpc_flight_rollout,
        pid_flight_rollout,
    )
    from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
    from unmanned_aerial_vehicles_tpu_torch.ops import _cuda, plant_pallas, rbf_pallas, tick_pallas
    from unmanned_aerial_vehicles_tpu_torch.parallel import structured_flight_sweep
    from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    started = time.perf_counter()
    phase_clock = lambda phase: print(f"chip_smoke: {phase} done at "
                                      f"{time.perf_counter() - started:.1f} s")
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
    # the batches of the tail and the launch shape, and the Monte Carlo
    # population's dispersed plant block, on their own generator (the
    # draws of the later checks stay as they were)
    k1_gen = torch.Generator().manual_seed(15)
    k1["by_batch"] = {}
    for label, B, dispersed in K1_CASES:
        s, c, plant = k1_operands(k1_gen, B, f32, prow if not dispersed else None)
        fn = lambda: plant_pallas._px4_plant_rows(s, c, plant, 0.02, 2)
        got = fn()
        torch.cuda.synchronize()
        err = float((got - plant_pallas.px4_plant_step_plain(s, c, plant, 0.02, 2)).abs().max())
        if not torch.equal(got, fn()):
            fail(f"K1 ({label}): a second launch on the same inputs differs")
        k1["by_batch"][label] = dict(err=err, ms=graph_ms(fn, 200))
        errs.append(err)
    k1["err"] = max(errs)
    kernels["px4_plant_step_fused"] = k1
    print(f"K1 px4_plant_step_fused: max_abs_err {k1['err']:.3e} (B=1, 4096; "
          + ", ".join(f"{label} {r['err']:.3e}" for label, r in k1["by_batch"].items())
          + f"); device {k1['ms'] * 1e3:.2f} us per launch at B=1, "
          + ", ".join(f"{label} {r['ms'] * 1e3:.2f} us" for label, r in k1["by_batch"].items()))
    if not k1["err"] <= PLANT_TOL:
        fail(f"K1 disagrees with its plain version: {k1['err']}")

    # K2
    errs = []
    for B in (1, 4096):
        s, cmd, integ, _ = k2_operands(gen, B, f32)
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
    print(f"K2 allocation_plant_tick_fused: max_abs_err {k2['err']:.3e} (B=1, 4096); "
          f"{k2['batch_1']['ms'] * 1e3:.2f} us at B=1, {k2['ms'] * 1e3:.2f} us at B={SWEEP_B}")
    if not k2["err"] <= PLANT_TOL:
        fail(f"K2 disagrees with its plain version: {k2['err']}")

    # K13a and K13b: the plant VJPs against torch.func.vjp of K1's and K2's
    # plain versions
    kernels.update(check_plant_vjps(dev, gen, prow, fail))

    # K5: one launch at full width from a GP fitted on the seeded synthetic set
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ADMM_ITERS,
                                    use_fused_controller=True), device=dev)
    data = mpc._tick_data
    rng = np.random.default_rng(0)
    Xs = rng.normal(size=(GP_POINTS, 10))
    Ys = 0.05 * rng.normal(size=(GP_POINTS, 6))
    post = fit_residual_gp(torch.tensor(Xs, **f32), torch.tensor(Ys, **f32), ResidualGPConfig())
    gp = tick_pallas.build_gp_rows(post, 0.1)
    m, Nnx = mpc.n_constraints, HORIZON * 6
    x0, pos, yaw, refs = figure8_launch(dev)
    aux = torch.cat([x0[:6] + 0.01, torch.tensor([0.02, -0.01, 0.03], **f32)]).contiguous()
    xtail = (x0[:6].repeat(HORIZON) + 0.05 * torch.randn(Nnx, generator=gen).to(dev)).contiguous()
    z0 = (0.3 * torch.randn(m, generator=gen)).to(**f32).contiguous()
    y0 = (0.1 * torch.randn(m, generator=gen)).to(**f32).contiguous()
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
    again = k5_fn()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("K5: a second launch on the same inputs differs")
    # cycles per tick by section, from the build with section clocks
    with _cuda.library_variant("tick", "tick_clocks"):
        tick_pallas.tick_section_cycles()
        k5_fn()
        torch.cuda.synchronize()
        k5["sections"] = sections = {k: v / K_TICKS
                                     for k, v in tick_pallas.tick_section_cycles().items()}
    sections["solve matvecs"] = sections["solve"] - sections["ADMM"]
    whole = sections["whole tick"]
    print("K5 clock cycles per tick by section (build with section clocks; the solve's matvecs "
          "are the solve less its ADMM): "
          + "; ".join(f"{name} {c:.0f} ({c / whole:.1%})" for name, c in sections.items()))

    # K5 with the variance section (tighten_kappa > 0): bench.py's tightening
    # mode's launch (N=20, P=800, K=8, kappa 2), flying at 7.9 m/s into the
    # 8 m/s box toward a 9 m/s reference, so the backed-off bound binds
    kt = check_tightened_k5(dev, mpc, post, prow, gp_ops + admm_ops + rest_ops, fail)
    kernels["gpmpc_multitick_fused_tightened"] = kt

    # K5 with its VJP rule (the fused MPC tuner's route), untightened and tightened
    multitick_ad = check_multitick_ad(dev, post, prow, fail)

    # K9: K5's operands with the filter inside, four configurations
    k9 = check_k9(dev, mpc, gp, gen, x0, xtail, z0, y0, refs, yaw, prow, statics,
                  K_TICKS * (gp_ops + admm_ops + rest_ops), fail)
    kernels["gpmpc_noisy_multitick_fused"] = k9
    print(f"K9 device time per launch: {k9['ms'] * 1e3:.2f} us ({k9['ms'] * 1e3 / K_TICKS:.2f} "
          f"us per tick; K5 on the same operands {k5['ms'] * 1e3:.2f} us), plain "
          f"{k9['plain_ms'] * 1e3:.2f} us; with host overhead {k9['host_ms'] * 1e3:.2f} us; bound "
          f"{k9['bound'][0] * 1e3:.4f} us ({k9['bound'][1]}; the filter "
          f"{k9['filter_ops_per_tick']} operations per tick); "
          + "; ".join(f"{w} {ms * 1e3:.2f} us" for w, ms in k9["variants"].items())
          + f"; card: {card}")
    k9["sections"]["solve matvecs"] = k9["sections"]["solve"] - k9["sections"]["ADMM"]
    whole = k9["sections"]["whole tick"]
    print("K9 clock cycles per tick by section (build with section clocks; warp 0's chain and "
          "the GP warps run side by side; the solve's matvecs are the solve less its ADMM): "
          + "; ".join(f"{name} {c:.0f} ({c / whole:.1%})" for name, c in k9["sections"].items()))

    k8 = kernels["gpmpc_controller_structured_batched"] = check_k8(dev, mpc, refs, gen, fail)

    rnd = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(**f32).contiguous()
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
    if not torch.equal(got, k7_fn()):
        fail("K7: a second launch on the same inputs differs")
    # the bytes the kernel moves: the queries, the packed training set, the
    # scalars and the outputs
    k7_bytes = nbytes(Xq, gp_ops.tiles, gp_ops.y_mean, gp_ops.ls, gp_ops.shift, got)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k7 = dict(
        err=k7_err,
        ms=graph_ms(k7_fn, 20), plain_ms=graph_ms(k7_plain, 2, replays=3),
        host_ms=cuda_ms(k7_fn, 50), host_plain_ms=cuda_ms(k7_plain, 5, warmup=1),
        bound_fp32_form=bound_ms(k7_bytes, ops_posterior_mean(mq, GP_POINTS)),
    )
    # the bound: the same work on the units that do it (the tensor cores,
    # the SFU, the FP32 pipe, the bytes), the slowest of them
    k7_bound_ms, k7_bound_by, k7["bound_unit"] = bound_posterior_mean_units(
        mq, GP_POINTS, k7_bytes, sms)
    k7["bound"] = (k7_bound_ms, k7_bound_by)
    kernels["rbf_posterior_mean_pallas"] = k7
    # cycles per block by section, from the build with section clocks
    with _cuda.library_variant("rbf", "rbf_clocks"):
        rbf_pallas.posterior_mean_section_cycles()
        k7_fn()
        torch.cuda.synchronize()
        k7["sections"] = rbf_pallas.posterior_mean_section_cycles()
    print(f"K7 rbf_posterior_mean_pallas: max_abs_err {k7_err:.3e} on outputs up to "
          f"{float(want.abs().max()):.3f} ({mq} queries, P={GP_POINTS}; a second launch "
          f"bit-identical); {k7['ms'] * 1e3:.2f} us; bound {k7['bound'][0] * 1e3:.4f} us on the "
          f"units that do the work ({k7['bound_unit']}), "
          f"{k7['bound_fp32_form'][0] * 1e3:.4f} us in the FP32 form; layout "
          f"{rbf_pallas.posterior_mean_layout(GP_POINTS, _cuda.shared_memory_optin(dev))}")
    whole = k7["sections"]["whole"]
    print("K7 clock cycles per block by section (warp 0, build with section clocks; each "
          "phase waits for its results): "
          + "; ".join(f"{name} {c:.0f} ({c / whole:.1%})" for name, c in k7["sections"].items()))
    if not k7_err <= K7_TOL:
        fail(f"K7 disagrees with its plain version: {k7_err}")
    # K7's other layouts: a training set that streams through the ring of
    # stages (P=2000) in one round of queries a block (4096) and in two
    # (25600: the ring wraps across the rounds), a resident set in two
    # rounds (25600), and a masked ring buffer at the 1e6 sentinel (P=300,
    # 180 valid)
    k7["cases"] = {}
    ring = ResidualDataset(X=rnd(300, 10), Y=rnd(300, 6, scale=0.05),
                           head=torch.tensor(180, device=dev), count=torch.tensor(180, device=dev))
    post_2000 = fit_residual_gp(rnd(2000, 10), rnd(2000, 6, scale=0.05), ResidualGPConfig())
    for label, case_post, mq_case in (
            ("P=2000", post_2000, 4096),
            ("P=2000, 25600 queries", post_2000, 25600),
            ("25600 queries", post, 25600),
            ("masked ring", fit_residual_gp_masked(ring, ResidualGPConfig()), 777)):
        case_ops = rbf_pallas.posterior_mean_operands(case_post)
        Xc = rnd(mq_case, 10)
        valid_rows = case_post.X_train[case_post.X_train[:, 0] < 1e5]
        pick = torch.randint(0, valid_rows.shape[0], (mq_case // 4,), generator=gen).to(dev)
        Xc[: mq_case // 4] = valid_rows[pick] + rnd(mq_case // 4, 10, scale=0.2)
        got_c = rbf_pallas.rbf_posterior_mean_pallas(case_ops, Xc)
        torch.cuda.synchronize()
        err_c = float((got_c - rbf_pallas.rbf_posterior_mean_plain(case_ops, Xc)).abs().max())
        same_c = torch.equal(got_c, rbf_pallas.rbf_posterior_mean_pallas(case_ops, Xc))
        k7["cases"][label] = err_c
        print(f"K7 at {label} ({mq_case} queries, layout "
              f"{rbf_pallas.posterior_mean_layout(case_ops.rec.shape[0], _cuda.shared_memory_optin(dev))}"
              f"): max_abs_err {err_c:.3e}; a second launch bit-identical {same_c}")
        if not (err_c <= K7_TOL and same_c and bool(torch.isfinite(got_c).all())):
            fail(f"K7 at {label}: error {err_c}, second launch bit-identical {same_c}")

    kernels.update(check_single_tick(dev, mpc, x0, pos, gen, prow, fail))

    # LinearMPC.solve through K3 and K6 at N=20 and N=25 in float32 and
    # float64 (the kernels compute in float32, the solve casts back): three
    # warm-started ticks, each solved again from the same carry through the
    # plain versions
    solve_errs = {}
    for N in (HORIZON, LONG_HORIZON):
        for dtype in (torch.float32, torch.float64):
            for mode in ("use_fused_controller", "use_fused_admm"):
                sm = LinearMPC(LinearMPCConfig(horizon=N, admm_iterations=ADMM_ITERS,
                                               **{mode: True}), dtype=dtype, device=dev)
                x = torch.tensor([0.3, -0.2, 2.8, 0.4, 0.1, -0.1], dtype=dtype, device=dev)
                target = torch.tensor([0.8, 0.3, 3.0], dtype=dtype, device=dev)
                carry, err = sm.init_carry(x), 0.0
                for _ in range(3):
                    res = (0.5 * torch.randn(N, 6, generator=gen)).to(dtype=dtype, device=dev)
                    u, X, new = sm.solve(carry, x, target, res)
                    torch.cuda.synchronize()
                    up, Xp, newp = sm.solve(carry, x, target, res, plain_kernels=True)
                    if not (u.dtype == X.dtype == new.slack.dtype == dtype):
                        fail(f"the {mode} solve at N={N} returned another dtype than {dtype}")
                    if not all(torch.isfinite(v).all() for v in (u, X, new.slack, new.dual)):
                        fail(f"the {mode} solve at N={N} produced non-finite values")
                    err = max([err] + [float((a - b).abs().max()) for a, b in (
                        (u, up), (X, Xp), (new.slack, newp.slack), (new.dual, newp.dual))])
                    carry, x = new, X[1]
                solve_errs[(mode, N, str(dtype).split(".")[1])] = err
    print("LinearMPC.solve through K3 (use_fused_controller) and K6 (use_fused_admm), 3 ticks, "
          "max_abs_err against the plain versions: "
          + "; ".join(f"{m} N={n} {d} {e:.3e}" for (m, n, d), e in solve_errs.items()))
    if not max(solve_errs.values()) <= SINGLE_TOL:
        fail(f"a fused solve disagrees with its plain version: {solve_errs}")

    # K10, K11 (both plants) and K12: the 12-state family
    kernels.update(check_rigid_kernels(dev, gen, fail))

    # K14, K15, K16 and K1/K2 on a dispersed plant block
    tail, plant_block_check = check_tail_kernels(dev, gen, fail)
    kernels.update(tail)
    # K4, K5, K6 and K10 on a grid of one block per flight or member
    for name, rec in check_population_kernels(dev, fail).items():
        kernels[name]["population"] = rec
    # the redesigned kernels against an older checkout's, in turns
    redesign = compare_with_parent(dev, parent)

    phase_clock("phase 2")
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

    def check_path(label, fly, expected, bound, record=True, gap_ticks=None):
        """Fly ``fly(False)`` with the launch counts from 0 and its plain
        twin ``fly(True)``; hold the position gap over the first
        ``gap_ticks`` ticks (all by default) to ``bound``."""
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
        diff = (outs["state"][..., 0:3] - plain["state"][..., 0:3]).abs()
        gap = float(diff[:gap_ticks].max())
        over = "" if gap_ticks is None else (f" over the first {gap_ticks} ticks (over all "
                                             f"{float(diff.max()):.3e} m)")
        print(f"{label}: launches {counts}, RMS {describe(rms(outs))} "
              f"(plain {describe(rms(plain))}), max position gap to plain {gap:.3e} m{over}")
        for kernel, n in expected.items():
            if counts[kernel] != n:
                fail(f"{label}: {kernel} launched {counts[kernel]} times, expected {n}")
            if record == "add":
                kernels[kernel]["launches"] += counts[kernel]
            elif record:
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

    # the single-tick tier (one K4 launch per tick, the 800-point GP as
    # residual_fn between launches), with and without preview; the
    # frozen-GP multi-tick flight with preview (bench.py's rms_preview);
    # staged flights solving through K3 and K6
    gp_cfg = ResidualGPConfig()
    resid = lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gp_cfg)

    def single_tick(T, plain=False, preview=False, gp=True):
        return mpc_flight_rollout(mpc, ref, T, cfg=FlightLoopConfig(use_fused_tick=True),
                                  residual_fn=resid if gp else None, preview=preview,
                                  device=dev, plain_kernels=plain)

    single_outs, _ = check_path(
        f"single-tick GP-MPC figure-8 (N={HORIZON}, P={GP_POINTS} residual_fn, {T_MAIN} ticks)",
        lambda p: single_tick(T_MAIN, p), {"gpmpc_tick_fused": T_MAIN}, SINGLE_GAP_BOUND_M,
    )
    preview_outs, _ = check_path(
        f"single-tick GP-MPC figure-8 with preview ({T_MAIN} ticks)",
        lambda p: single_tick(T_MAIN, p, preview=True), {"gpmpc_tick_fused": T_MAIN},
        SINGLE_GAP_BOUND_M, record=False,
    )
    frozen_preview_outs, _ = check_path(
        f"frozen-GP multi-tick figure-8 with preview (K={K5_PREVIEW_K}, {K5_PREVIEW_T} ticks)",
        lambda p: mpc_flight_rollout(
            mpc, ref, K5_PREVIEW_T, gp_posterior=post, gp_gain=gp_cfg.residual_gain,
            cfg=FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=K5_PREVIEW_K),
            preview=True, device=dev, plain_kernels=p),
        {"gpmpc_multitick_fused": K5_PREVIEW_T // K5_PREVIEW_K}, SINGLE_GAP_BOUND_M,
        record=False,
    )
    admm_mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON, admm_iterations=ADMM_ITERS,
                                         use_fused_admm=True), device=dev)
    for label, solver_mpc, kernel in (("use_fused_controller", mpc, "gpmpc_controller_fused"),
                                      ("use_fused_admm", admm_mpc, "admm_box_qp_fused_composite")):
        check_path(
            f"staged MPC flight solving through {kernel} ({label}, residual_fn, 100 ticks)",
            lambda p, m_=solver_mpc: mpc_flight_rollout(m_, ref, 100, residual_fn=resid,
                                                        device=dev, plain_kernels=p),
            {kernel: 100}, SINGLE_GAP_BOUND_M,
        )
    print(f"  figure-8 RMS: single-tick {float(rms(single_outs)):.6f} m, with preview "
          f"{float(rms(preview_outs)):.6f} m; frozen-GP multi-tick with preview "
          f"{float(rms(frozen_preview_outs)):.6f} m")

    # GP-variance tightening: (a) bench.py:262-270's tightening mode (the
    # frozen GP, K=8, kappa 2); (b) examples/09's online flight (wind, preview,
    # the fallback, P=256, refit every 250, K=8); (c) the staged tightening
    # through uncertainty_fn and K6; (d) the staged output correction; (e)
    # flight (b) stopped at a launch boundary, saved, loaded and continued
    tight_cfg = dict(horizon=HORIZON, admm_iterations=ADMM_ITERS, tightening_factor=TIGHTEN_KAPPA)
    mpc_tight = LinearMPC(LinearMPCConfig(use_fused_controller=True, **tight_cfg), device=dev)
    loop8 = FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=K5_PREVIEW_K)

    def tightened(T, plain=False):
        return mpc_flight_rollout(mpc_tight, ref, T, gp_posterior=post,
                                  gp_gain=gp_cfg.residual_gain, cfg=loop8, device=dev,
                                  plain_kernels=plain)

    tight_outs, _ = check_path(
        f"tightened frozen-GP multi-tick figure-8 (kappa {TIGHTEN_KAPPA}, N={HORIZON}, "
        f"P={GP_POINTS}, K={K5_PREVIEW_K}, {TIGHT_T} ticks)",
        lambda p: tightened(TIGHT_T, p),
        {"gpmpc_multitick_fused_tightened": TIGHT_T // K5_PREVIEW_K}, SINGLE_GAP_BOUND_M,
    )
    loop09 = FlightLoopConfig(use_fused_tick=True, ticks_per_dispatch=K5_PREVIEW_K,
                              fallback_error_m=1.5)
    ogp09 = OnlineFusedGPConfig(gp=ResidualGPConfig(max_data_points=ONLINE09_P, residual_gain=1.0),
                                refit_every=250)
    wind09 = RigidBodyParams(wind=(1.5, 0.8, 0.0))

    def online09(T, plain=False, **kw):
        return mpc_flight_rollout(mpc_tight, ref, T, body=wind09, cfg=loop09, preview=True,
                                  online_gp=ogp09, gp_gain=1.0, device=dev, plain_kernels=plain,
                                  **kw)

    online09_outs, online09_plain = check_path(
        f"examples/09 online figure-8 (tightening kappa {TIGHTEN_KAPPA}, wind, preview, "
        f"fallback, P={ONLINE09_P}, K={K5_PREVIEW_K}, {ONLINE09_T} ticks)",
        lambda p: online09(ONLINE09_T, p),
        {"gpmpc_multitick_fused_tightened": ONLINE09_T // K5_PREVIEW_K}, SINGLE_GAP_BOUND_M,
        record=False,
    )
    if not torch.equal(online09_outs["gp_count"], online09_plain["gp_count"]):
        fail("examples/09 online flight: the ring buffer's count differs from the plain flight's")
    admm_tight = LinearMPC(LinearMPCConfig(use_fused_admm=True, **tight_cfg), device=dev)
    unc = lambda Xg, Ug: build_horizon_uncertainty(post, Xg, Ug, gp_cfg)
    staged_tight_outs, _ = check_path(
        f"staged tightened flight (uncertainty_fn, use_fused_admm, kappa {TIGHTEN_KAPPA}; "
        f"{NOISY_SHORT_T} ticks)",
        lambda p: mpc_flight_rollout(admm_tight, ref, NOISY_SHORT_T, residual_fn=resid,
                                     uncertainty_fn=unc, device=dev, plain_kernels=p),
        {"admm_box_qp_fused_composite": NOISY_SHORT_T}, SINGLE_GAP_BOUND_M, record=False,
    )
    correction = make_output_correction_fn(post, GP_POINTS)
    correction_outs, _ = check_path(
        f"staged output-correction flight (solve through K3; {NOISY_SHORT_T} ticks)",
        lambda p: mpc_flight_rollout(mpc, ref, NOISY_SHORT_T, output_correction_fn=correction,
                                     device=dev, plain_kernels=p),
        {"gpmpc_controller_fused": NOISY_SHORT_T}, SINGLE_GAP_BOUND_M, record=False,
    )
    uncorrected = mpc_flight_rollout(mpc, ref, NOISY_SHORT_T, device=dev)
    moved = float((correction_outs["u_mpc"] - uncorrected["u_mpc"]).abs().max())
    if not moved > 0.0:
        fail("the output correction never applied")
    _cuda.reset_launch_counts()
    seg1, resume_state = online09(RESUME_AT, return_resume=True)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = Path(tmp) / "resume.npz"
        save_resume_state(path, resume_state)
        seg2 = online09(ONLINE09_T - RESUME_AT, resume=load_resume_state(path, device=dev))
    torch.cuda.synchronize()
    resumed_launches = _cuda.launch_counts["gpmpc_multitick_fused_tightened"]
    for key in ("state", "gp_count"):
        if not torch.equal(torch.cat([seg1[key], seg2[key]]), online09_outs[key]):
            fail(f"the resumed examples/09 flight's {key} differs from the unbroken flight's")
    print(f"  resumed at tick {RESUME_AT} from a saved checkpoint: bit-identical to the unbroken "
          f"flight over {ONLINE09_T} ticks ({resumed_launches} launches of the tightened K5)")
    tight_rms = {"frozen_400": float(rms(tight_outs)), "online09_1000": float(rms(online09_outs)),
                 "staged_uncertainty_100": float(rms(staged_tight_outs)),
                 "output_correction_100": float(rms(correction_outs))}
    print("  figure-8 RMS: " + "; ".join(f"{k} {v:.6f} m" for k, v in tight_rms.items())
          + f"; examples/09 ring buffer count at tick {ONLINE09_T} "
          f"{int(online09_outs['gp_count'][-1])}; the output correction moved u_mpc by up to "
          f"{moved:.3e}")

    # the noisy tiers: sensors -> filter -> MPC on the estimate -> plant on
    # the truth, the same seeded sensor stream for the kernel and plain runs
    def noisy(T, plain=False, **kw):
        return noisy_mpc_flight_rollout(mpc, ref, T, generator=torch.Generator(device=dev).manual_seed(0),
                                        device=dev, plain_kernels=plain, **kw)

    def online_noisy(T, plain=False):
        return noisy(T, plain, cfg=online_cfg, online_gp=ogp, gp_gain=0.1)

    noisy_outs, noisy_plain = check_path(
        f"online-noisy GP-MPC figure-8 (EKF in K9; N={HORIZON}, P={GP_POINTS}, K={K_TICKS}, "
        f"{T_MAIN} ticks)",
        lambda p: online_noisy(T_MAIN, p), {"gpmpc_noisy_multitick_fused": T_MAIN // K_TICKS},
        NOISY_GAP_BOUND_M,
    )
    if not torch.equal(noisy_outs["gp_count"], noisy_plain["gp_count"]):
        fail("online-noisy flight: the ring buffer's count differs from the plain flight's")
    est_err = float((noisy_outs["state_est"] - noisy_outs["state"]).norm(dim=1).mean())
    print(f"  gp_count at refits (ticks 250, 500): {int(noisy_outs['gp_count'][249])}, "
          f"{int(noisy_outs['gp_count'][-1])}; mean estimate error {est_err:.4f} m "
          "(12-state norm)")

    gust_wind = torch.tensor([1.5, 0.8, 0.0], **f32)
    base_wind = torch.tensor(wind, **f32)

    def wind_fn(t):
        return torch.where((t >= GUST_T_S)[:, None], gust_wind, base_wind)

    observer_outs, _ = check_path(
        f"observer figure-8 with a gust at {GUST_T_S} s (15-state observer in K9, K={K_TICKS}, "
        f"{T_MAIN} ticks)",
        lambda p: noisy(T_MAIN, p, cfg=online_cfg, body=RigidBodyParams(wind=wind),
                        disturbance_observer=True, wind_fn=wind_fn),
        {"gpmpc_noisy_multitick_fused": T_MAIN // K_TICKS}, NOISY_GAP_BOUND_M, record=False,
    )
    d_tail = observer_outs["disturbance_est"][-100:].mean(dim=0)
    print(f"  disturbance estimate over the last 100 ticks: {[round(float(v), 4) for v in d_tail]}"
          f" (wind after the gust {gust_wind.tolist()})")
    if not all(float(d_tail[i]) * float(gust_wind[i]) > 0 for i in (0, 1)):
        fail(f"the observer's disturbance estimate {d_tail.tolist()} does not point into the wind")
    check_path(
        f"staged noisy flight (EKF as PyTorch ops, solve through K3, plant K1; "
        f"{NOISY_SHORT_T} ticks)",
        lambda p: noisy(NOISY_SHORT_T, p, body=RigidBodyParams(wind=wind),
                        cfg=FlightLoopConfig(use_pallas_plant=True)),
        {"gpmpc_controller_fused": NOISY_SHORT_T, "px4_plant_step_fused": NOISY_SHORT_T},
        NOISY_GAP_BOUND_M, record=False,
    )
    check_path(
        f"single-tick noisy flight (K4 on the estimate, the GP as residual_fn; "
        f"{NOISY_SHORT_T} ticks)",
        lambda p: noisy(NOISY_SHORT_T, p, cfg=FlightLoopConfig(use_fused_tick=True),
                        residual_fn=resid),
        {"gpmpc_tick_fused": NOISY_SHORT_T}, NOISY_GAP_BOUND_M, record=False,
    )
    print(f"  figure-8 RMS: online-noisy {float(rms(noisy_outs)):.6f} m (online without noise "
          f"{float(rms(outs)):.6f} m); observer with the gust {float(rms(observer_outs)):.6f} m")

    # the 12-state family on the circle task (and the LTV obstacle flight)
    fam = RigidFamily(dev)
    rigid_outs, rigid_plains = {}, {}
    for key, label, fly, T, expected, bound, record in (
        ("direct_rate12_fused", "direct-rate12 fused multi-tick (K11, N=20, K=8, 30 iterations)",
         fam.direct_rate12_fused, CIRCLE_T, {"direct_rate_multitick_kernel": CIRCLE_T // 8},
         SQP_GAP_BOUND_M, True),
        ("mpc12_fused", "mpc12 fused multi-tick (K11 with the rigid plant, N=15, K=8)",
         fam.mpc12_fused, CIRCLE_T, {"direct_rate_multitick_kernel": CIRCLE_T // 8},
         SQP_GAP_BOUND_M, False),
        ("mpc12_multitick", "mpc12 sqp_multitick_rollout (K=8, plan_roll linear, plant K10)",
         fam.mpc12_multitick, CIRCLE_T, {"rigid_body_rollout_fused": CIRCLE_T},
         SQP_GAP_BOUND_M, True),
        ("ltv12_obstacle", "ltv12 obstacle multi-tick (10 Hz, K=2, 100 iterations, fallback, "
         "plant and plan roll K10)", fam.ltv12_obstacle, LTV_T,
         {"rigid_body_rollout_fused": LTV_T + LTV_T // 2}, CHAOTIC_BOUNDS_M["ltv12_obstacle"][0],
         False),
        ("mppi12", "mppi12 staged (K12 512 x 25, plant K10)", fam.mppi12, CIRCLE_T,
         {"mppi_rollout_costs_fused": CIRCLE_T, "rigid_body_rollout_fused": CIRCLE_T},
         CHAOTIC_BOUNDS_M["mppi12"][0], True),
    ):
        rigid_outs[key], rigid_plains[key] = check_path(
            f"{label}, {T} ticks", lambda p, f=fly, T=T: f(T, p), expected, bound, record=record,
            gap_ticks=CHAOTIC_GAP_TICKS if key in CHAOTIC_BOUNDS_M else None)
    centre = torch.tensor(LTV_OBSTACLE[:3], **f32)
    clearance, clearance_plain = (
        float((o["state"][:, 0:3] - centre).norm(dim=1).min() - LTV_OBSTACLE[3])
        for o in (rigid_outs["ltv12_obstacle"], rigid_plains["ltv12_obstacle"]))
    rms_gap = {key: abs(float(rms(rigid_outs[key])) - float(rms(rigid_plains[key])))
               for key in CHAOTIC_BOUNDS_M}
    if not (clearance > 0.0 and clearance_plain > 0.0):
        fail(f"ltv12 obstacle flight: clearance {clearance}, plain {clearance_plain}")
    for key, (_, rms_bound) in CHAOTIC_BOUNDS_M.items():
        if not rms_gap[key] <= rms_bound:
            fail(f"{key}: RMS gap to the plain flight {rms_gap[key]} > {rms_bound}")
    circle_rms = {key: float(rms(o)) for key, o in rigid_outs.items()}
    print(f"  circle RMS ({CIRCLE_T} ticks; ltv12 obstacle {LTV_T} ticks at 10 Hz): "
          + "; ".join(f"{k} {v:.6f} m" for k, v in circle_rms.items())
          + f"; ltv12 minimum clearance from the obstacle's surface {clearance:.4f} m (plain "
          f"{clearance_plain:.4f} m); RMS gaps to the plain flights: ltv12 "
          f"{rms_gap['ltv12_obstacle']:.3e} m, mppi12 {rms_gap['mppi12']:.3e} m")

    # the iLQR engine (staged, and the K=2 policy tier) and the 12-state
    # noisy loops: the iLQR rollouts and every truth step through K10, each
    # flight's K10 launches added to K10's count
    k10_by_path = {}
    for key, label, fly, T, n_k10 in (
        ("ilqr12_staged", f"ilqr12 staged (RK4 engine, N={ILQR_HORIZON}, 3 iterations: 4 K10 "
         "rollouts and the K10 plant step a tick)", fam.ilqr12_staged, ILQR_STAGED_T,
         5 * ILQR_STAGED_T),
        ("ilqr12_k2", "ilqr12 policy tier (K=2, 1 iteration: 2 K10 rollouts a dispatch, the K10 "
         "plant step a tick)", fam.ilqr12_k2, ILQR_K2_T, 2 * ILQR_K2_T),
        ("noisy_ilqr12", "noisy ilqr12 (the staged RK4 engine on the EKF's estimate, the truth "
         "through K10)", fam.noisy_ilqr12, NOISY12_T, 5 * NOISY12_T),
        ("noisy_ltv12", "noisy ltv12 (10 Hz LTV over the 100 Hz EKF, 10 K10 truth steps a "
         "control tick)", fam.noisy_ltv12, NOISY_LTV_T, 10 * NOISY_LTV_T),
    ):
        rigid_outs[key], rigid_plains[key] = check_path(
            f"{label}, {T} ticks", lambda p, f=fly, T=T: f(T, p),
            {"rigid_body_rollout_fused": n_k10}, SQP_GAP_BOUND_M, record="add")
        k10_by_path[key] = n_k10
    ilqr_rms = {key: float(rms(rigid_outs[key]))
                for key in ("ilqr12_staged", "ilqr12_k2", "noisy_ilqr12", "noisy_ltv12")}
    ilqr_rms_plain = {key: float(rms(rigid_plains[key])) for key in ilqr_rms}
    estimate_rms = {key: float(torch.sqrt(torch.mean(torch.sum(
        (rigid_outs[key]["state_est"][:, 0:3] - rigid_outs[key]["state"][:, 0:3]) ** 2, -1))))
        for key in ("noisy_ilqr12", "noisy_ltv12")}
    jax_gap = {key: abs(ilqr_rms[key] - JAX_ILQR_RMS_M[key]) for key in JAX_ILQR_RMS_M}
    print(f"  circle RMS: ilqr12 staged {ilqr_rms['ilqr12_staged']:.6f} m over {ILQR_STAGED_T} "
          f"ticks (JAX {JAX_ILQR_RMS_M['ilqr12_staged']:.6f} m), K=2 tier "
          f"{ilqr_rms['ilqr12_k2']:.6f} m over {ILQR_K2_T} (JAX "
          f"{JAX_ILQR_RMS_M['ilqr12_k2']:.6f} m); noisy ilqr12 {ilqr_rms['noisy_ilqr12']:.6f} m "
          f"(estimate against truth {estimate_rms['noisy_ilqr12']:.6f} m), noisy ltv12 "
          f"{ilqr_rms['noisy_ltv12']:.6f} m (estimate {estimate_rms['noisy_ltv12']:.6f} m); "
          f"K10 launches by path {k10_by_path}")
    for key, gap in jax_gap.items():
        if not gap <= JAX_RMS_GAP_M:
            fail(f"{key}: RMS {ilqr_rms[key]} is {gap} m from the JAX package's "
                 f"{JAX_ILQR_RMS_M[key]} (bound {JAX_RMS_GAP_M})")

    # the auto-tuners (K1 + K13a, K5 with its VJP rule, K2 + K13b)
    tuners = run_tuners(dev, fail, kernels)

    # K14 and K15 at their own entry points; the Monte Carlo populations
    # (K16 + K2, K1) and the lone K3 flights
    drive_entry_points(dev, fail, kernels)
    populations = run_populations(dev, fail, kernels)
    fly_population = populations.pop("fly_mpc")
    population_tiers = run_population_tiers(dev, fail, kernels)
    fly_tiers = population_tiers.pop("fly")
    # the mission, the online learner, the demo MPCs (K14's flight path) and
    # the comparison harness
    orchestration = run_orchestration(dev, fail, kernels, ref, card)
    # the full-corpus GP (K15's path) and the sharded sweeps (K8, K7, K5)
    distributed = run_distributed(dev, fail, kernels, mpc, ref, starts, post, online_cfg, ogp,
                                  card)
    # the command line, python -m and the examples (every command's launches)
    surface = run_surface(dev, fail, kernels, card)
    # the experiment campaign (K4's first user entry: the oracle row)
    campaign = run_campaign_block(dev, fail, kernels, card)

    phase_clock("phase 3")
    # ---- phase 4: microseconds per tick (slope of two lengths) --------------
    us_kernel = slope_us(lambda T: online(T), T_SLOPE)
    us_plain = slope_us(lambda T: online(T, True), T_SLOPE_PLAIN)
    print(f"online tick: {us_kernel:.2f} us/tick through K5 (slope {T_SLOPE[0]}->{T_SLOPE[1]} "
          f"ticks), {us_plain:.2f} us/tick through the plain version "
          f"(slope {T_SLOPE_PLAIN[0]}->{T_SLOPE_PLAIN[1]}); card: {card}")
    us_single = slope_us(lambda T: single_tick(T), T_SLOPE)
    us_single_plain = slope_us(lambda T: single_tick(T, True), T_SLOPE_PLAIN, reps=1,
                               warm_T=100)
    print(f"single-tick tick: {us_single:.2f} us/tick through K4 (slope {T_SLOPE[0]}->"
          f"{T_SLOPE[1]} ticks; K4's device time {kernels['gpmpc_tick_fused']['ms'] * 1e3:.2f} "
          f"us of it), {us_single_plain:.2f} us/tick through the plain version (slope "
          f"{T_SLOPE_PLAIN[0]}->{T_SLOPE_PLAIN[1]}, one run per length); card: {card}")
    # the same slope without the GP: what the residual_fn costs per tick
    us_single_no_gp = slope_us(lambda T: single_tick(T, gp=False), T_SLOPE)
    print(f"single-tick tick without the GP (residual_fn=None): {us_single_no_gp:.2f} us/tick "
          f"through K4 (same slope); card: {card}")
    us_noisy = slope_us(lambda T: online_noisy(T), T_SLOPE)
    us_noisy_plain = slope_us(lambda T: online_noisy(T, True), T_SLOPE_PLAIN)
    print(f"online-noisy tick: {us_noisy:.2f} us/tick through K9 (slope {T_SLOPE[0]}->"
          f"{T_SLOPE[1]} ticks; K9's device time {k9['ms'] * 1e3 / K_TICKS:.2f} us per tick of "
          f"it), {us_noisy_plain:.2f} us/tick through the plain version (slope "
          f"{T_SLOPE_PLAIN[0]}->{T_SLOPE_PLAIN[1]}); online tick without noise {us_kernel:.2f} "
          f"us; card: {card}")

    us_tight = slope_us(lambda T: tightened(T), T_SLOPE)
    us_tight_plain = slope_us(lambda T: tightened(T, True), T_SLOPE_TIGHT_PLAIN)
    print(f"tightened tick (frozen GP, kappa {TIGHTEN_KAPPA}, K={K5_PREVIEW_K}): {us_tight:.2f} "
          f"us/tick through the tightened K5 (slope {T_SLOPE[0]}->{T_SLOPE[1]} ticks; its "
          f"device time {kt['ms'] * 1e3 / K5_PREVIEW_K:.2f} us per tick), {us_tight_plain:.2f} "
          f"us/tick through the plain version (slope {T_SLOPE_TIGHT_PLAIN[0]}->"
          f"{T_SLOPE_TIGHT_PLAIN[1]}); card: {card}")

    def sweep_slope_us(**kw):
        """Microseconds per sweep tick, slope between the two lengths."""
        return slope_us(lambda T: sweep(T, **kw), T_SWEEP_SLOPE)

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
    # device time per tick by kernel name, from a torch.profiler trace of
    # 50 ticks; against the unprofiled tick above it gives the idle share
    from torch.profiler import ProfilerActivity, profile

    def device_busy(fly, ticks=50):
        """Device-busy microseconds per tick of ``fly(ticks)`` and the
        kernels by name (device-side events only: a CPU op's entry repeats
        its kernels' time)."""
        fly(ticks)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fly(ticks)
            torch.cuda.synchronize()
        by_name = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and e.self_device_time_total > 0), reverse=True)
        return sum(t for t, _ in by_name) / ticks, by_name

    idle_share = {}
    for label, fly, tick_us, ticks in (
        ("50 sweep ticks (gp_every=1)", lambda T: sweep(T, **gp_kw),
         us_sweep_tick["gp_posterior, gp_every=1"], 50),
        ("50 single-tick ticks", lambda T: single_tick(T), us_single, 50),
        ("100 online-noisy ticks", lambda T: online_noisy(T), us_noisy, 100),
        ("96 tightened ticks", lambda T: tightened(T), us_tight, 96),
    ):
        busy_us, by_name = device_busy(fly, ticks)
        idle_share[label] = 1.0 - busy_us / tick_us
        print(f"  profiler, {label}: device busy {busy_us:.2f} us per tick of {tick_us:.2f} us, "
              f"idle share {idle_share[label]:.3f}; by kernel (us per tick): "
              + "; ".join(f"{name[:60]} {t / ticks:.2f}" for t, name in by_name[:8]))
    # the 12-state family: microseconds per tick, slope between 200 and
    # 1000 ticks (T_SLOPE_12), the plain versions at shorter lengths
    us_12 = {
        "direct_rate12_fused": (slope_us(fam.direct_rate12_fused, T_SLOPE_12),
                                slope_us(lambda T: fam.direct_rate12_fused(T, True),
                                         T_SLOPE_12_PLAIN)),
        "mpc12_fused": (slope_us(fam.mpc12_fused, T_SLOPE_12),
                        slope_us(lambda T: fam.mpc12_fused(T, True), T_SLOPE_12_PLAIN)),
        "mppi12": (slope_us(fam.mppi12, T_SLOPE_12),
                   slope_us(lambda T: fam.mppi12(T, True), T_SLOPE_MPPI_PLAIN, reps=1, warm_T=10)),
    }
    for key, (us, us_p) in us_12.items():
        plain_T = T_SLOPE_MPPI_PLAIN if key == "mppi12" else T_SLOPE_12_PLAIN
        print(f"{key} tick: {us:.2f} us/tick through the kernels (slope {T_SLOPE_12[0]}->"
              f"{T_SLOPE_12[1]} ticks), {us_p:.2f} us/tick through the plain versions (slope "
              f"{plain_T[0]}->{plain_T[1]}); card: {card}")
    k11 = kernels["direct_rate_multitick_kernel"]
    print(f"  K11's device time per tick: direct-rate {k11['ms'] * 1e3 / 8:.2f} us, rigid "
          f"{k11['rigid']['ms'] * 1e3 / 8:.2f} us; K12 "
          f"{kernels['mppi_rollout_costs_fused']['ms'] * 1e3:.2f} us and K10 "
          f"{kernels['rigid_body_rollout_fused']['ms'] * 1e3:.2f} us per mppi12 tick")
    for label, fly, tick_us, ticks in (
        ("80 direct-rate12 fused ticks", fam.direct_rate12_fused, us_12["direct_rate12_fused"][0], 80),
        ("100 mppi12 ticks", fam.mppi12, us_12["mppi12"][0], 100),
    ):
        busy_us, by_name = device_busy(fly, ticks)
        idle_share[label] = 1.0 - busy_us / tick_us
        print(f"  profiler, {label}: device busy {busy_us:.2f} us per tick of {tick_us:.2f} us, "
              f"idle share {idle_share[label]:.3f}; by kernel (us per tick): "
              + "; ".join(f"{name[:60]} {t / ticks:.2f}" for t, name in by_name[:8]))
    # the iLQR engine: microseconds per tick (kernel path), the staged
    # engine and the K=2 policy tier, and their device-busy shares
    us_ilqr = {"ilqr12_staged": slope_us(fam.ilqr12_staged, T_SLOPE_ILQR_STAGED, reps=1, warm_T=2),
               "ilqr12_k2": slope_us(fam.ilqr12_k2, T_SLOPE_ILQR_K2, reps=2, warm_T=10)}
    for key, label, ticks in (("ilqr12_k2", f"{ILQR_SHARE_T} ilqr12 K=2 ticks", ILQR_SHARE_T),
                              ("ilqr12_staged", "2 ilqr12 staged ticks", 2)):
        busy_us, by_name = device_busy(getattr(fam, key), ticks)
        idle_share[label] = 1.0 - busy_us / us_ilqr[key]
        print(f"{key} tick: {us_ilqr[key]:.2f} us/tick through K10 (slope "
              f"{(T_SLOPE_ILQR_STAGED if key == 'ilqr12_staged' else T_SLOPE_ILQR_K2)} ticks); "
              f"profiler, {label}: device busy {busy_us:.2f} us per tick, idle share "
              f"{idle_share[label]:.3f}; by kernel (us per tick): "
              + "; ".join(f"{name[:60]} {t / ticks:.2f}" for t, name in by_name[:8])
              + f"; card: {card}")
    ilqr_parts = ilqr_iteration_parts(dev)
    print("  one iLQR iteration's parts at N=15 (host ms, each call ended by a synchronize, "
          "best of 3): " + ", ".join(f"{k} {v:.3f}" for k, v in ilqr_parts.items())
          + f"; card: {card}")
    # the Monte Carlo study: microseconds per flight-tick of the MPC
    # population (K16 + K2), slope between 300 and 1500 ticks over 256
    us_mc_tick = slope_us(fly_population, T_MC_SLOPE)
    us_mc_flight_tick = us_mc_tick / MC_B
    busy_us, by_name = device_busy(fly_population, 50)
    idle_share["50 Monte Carlo ticks"] = 1.0 - busy_us / us_mc_tick
    k16 = kernels["gpmpc_controller_fused_batched"]
    print(f"Monte Carlo MPC population ({MC_B} flights, N={LONG_HORIZON}, "
          f"{ADMM_ITERS_DEFAULT} iterations, K16 + K2): {us_mc_flight_tick:.4f} us per "
          f"flight-tick, {us_mc_tick:.2f} us per tick (slope {T_MC_SLOPE[0]}->{T_MC_SLOPE[1]} "
          f"ticks); K16's device time {k16['ms'] * 1e3:.2f} us per tick; card: {card}")
    print(f"  profiler, 50 Monte Carlo ticks: device busy {busy_us:.2f} us per tick of "
          f"{us_mc_tick:.2f} us, idle share {idle_share['50 Monte Carlo ticks']:.3f}; by kernel "
          "(us per tick): " + "; ".join(f"{name[:60]} {t / 50:.2f}" for t, name in by_name[:8]))
    print(f"  K16 at N=20: {k16['n20']['ms'] * 1e3:.2f} us; K14 at N=20 "
          f"{kernels['admm_box_qp_fused']['n20']['ms'] * 1e3:.2f} us; K15 at the corpus "
          f"{kernels['rbf_kernel_matrix_pallas']['corpus']['ms'] * 1e3:.2f} us (bound "
          f"{kernels['rbf_kernel_matrix_pallas']['corpus']['bound'][0] * 1e3:.2f} us, torch.cdist "
          f"+ square/scale/exp {kernels['rbf_kernel_matrix_pallas']['corpus']['cdist_ms'] * 1e3:.2f}"
          f" us); plant block at B={MC_B}: K1 {plant_block_check['ms']['K1'] * 1e3:.2f} us, K2 "
          f"{plant_block_check['ms']['K2'] * 1e3:.2f} us")
    # two parts of the single-tick tick, each timed alone with the host's
    # overhead (not in the tick's window: the host's run-to-run spread is
    # larger than the rest of the loop, so no remainder is derived)
    Xg = torch.zeros(HORIZON + 1, 6, **f32)
    Ug = torch.zeros(HORIZON, 4, **f32)
    resid_us = 1e3 * cuda_ms(lambda: resid(Xg, Ug), 200)
    print(f"  single-tick tick parts, each alone with host overhead: residual_fn {resid_us:.2f} "
          f"us, K4 call {kernels['gpmpc_tick_fused']['host_ms'] * 1e3:.2f} us; card: {card}")
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

    population_timing = time_population_tiers(fly_tiers, us_mc_tick, card, device_busy)
    tuner_seconds = time_tuner_iterations(dev)
    multistart = time_multistart_tuner(dev, fail, card)

    phase_clock("phase 4")
    # ---- phase 5: result lines --------------------------------------------
    meta = {
        "px4_plant_step_fused": ("plant_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/plant_pallas.py:377"),
        "allocation_plant_tick_fused": ("plant_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/plant_pallas.py:312"),
        "gpmpc_multitick_fused": ("tick_kernel.cu", "unmanned_aerial_vehicles_tpu/ops/tick_pallas.py:686"),
        "gpmpc_multitick_fused_tightened": (
            "tick_kernel.cu", "unmanned_aerial_vehicles_tpu/ops/tick_pallas.py:686"),
        "gpmpc_controller_structured_batched": (
            "controller_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/controller_pallas.py:449"),
        "rbf_posterior_mean_pallas": ("rbf_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/rbf_pallas.py:221"),
        "gpmpc_tick_fused": ("single_tick_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/tick_pallas.py:276"),
        "gpmpc_noisy_multitick_fused": (
            "noisy_tick_kernel.cu", "unmanned_aerial_vehicles_tpu/ops/tick_pallas.py:1191"),
        "gpmpc_controller_fused": (
            "single_tick_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/controller_pallas.py:152"),
        "admm_box_qp_fused_composite": (
            "single_tick_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/admm_pallas.py:172"),
        "rigid_body_rollout_fused": (
            "rigid_plant_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/rigid_plant_pallas.py:140"),
        "direct_rate_multitick_kernel": (
            "rigid_tick_kernel.cu", "unmanned_aerial_vehicles_tpu/ops/rigid_tick_pallas.py:192"),
        "mppi_rollout_costs_fused": (
            "mppi_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/mppi_pallas.py:102"),
        "px4_plant_step_vjp": (
            "plant_vjp_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/tick_ad.py:402"),
        "allocation_plant_tick_vjp": (
            "plant_vjp_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/tick_ad.py:462"),
        "admm_box_qp_fused": (
            "single_tick_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/admm_pallas.py:87"),
        "rbf_kernel_matrix_pallas": (
            "rbf_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/rbf_pallas.py:427"),
        "gpmpc_controller_fused_batched": (
            "controller_kernels.cu", "unmanned_aerial_vehicles_tpu/ops/controller_pallas.py:252"),
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
            **({"launches_by_path": k["paths"]} if "paths" in k else {}),
        }
        for name, k in kernels.items()
    ], "us_per_online_tick": us_kernel, "us_per_online_tick_plain": us_plain,
        "fig8_rms_m_online_500": float(rms(outs)),
        "us_per_flight_tick_sweep_1024": us_flight_tick,
        "sweep_rms_mean_m": float(sweep_rms.mean()), "sweep_rms_max_m": float(sweep_rms.max()),
        "sweep_rms_mean_m_plain": float(sweep_rms_plain.mean()),
        "us_per_single_tick": us_single, "us_per_single_tick_plain": us_single_plain,
        "us_per_single_tick_no_gp": us_single_no_gp,
        "us_per_online_noisy_tick": us_noisy, "us_per_online_noisy_tick_plain": us_noisy_plain,
        "idle_share_online_noisy": idle_share["100 online-noisy ticks"],
        "fig8_rms_m_online_noisy_500": float(rms(noisy_outs)),
        "fig8_rms_m_observer_gust_500": float(rms(observer_outs)),
        "k9_max_abs_err_by_case": k9["errs"],
        "k9_cycles_per_tick_by_section": k9["sections"],
        "k4_cycles_by_section": {
            N: rec["sections"] for N, rec in ((HORIZON, kernels["gpmpc_tick_fused"]),
                                              (LONG_HORIZON, kernels["gpmpc_tick_fused"]["long"]))},
        "k3_cycles_by_section": {
            N: rec["sections"] for N, rec in (
                (HORIZON, kernels["gpmpc_controller_fused"]),
                (LONG_HORIZON, kernels["gpmpc_controller_fused"]["long"]))},
        "k6_cycles_by_section": {
            N: rec["sections"] for N, rec in (
                (HORIZON, kernels["admm_box_qp_fused_composite"]),
                (LONG_HORIZON, kernels["admm_box_qp_fused_composite"]["long"]))},
        "k3_bound_ms_p1_form": {
            N: rec["bound_p1_form"][0] for N, rec in (
                (HORIZON, kernels["gpmpc_controller_fused"]),
                (LONG_HORIZON, kernels["gpmpc_controller_fused"]["long"]))},
        "k6_bound_ms_p1_form": {
            N: rec["bound_p1_form"][0] for N, rec in (
                (HORIZON, kernels["admm_box_qp_fused_composite"]),
                (LONG_HORIZON, kernels["admm_box_qp_fused_composite"]["long"]))},
        "k6_on_p1": {N: {"us": rec["ms"] * 1e3, "max_abs_err": rec["err"],
                         "bound_ms": rec["bound"][0]}
                     for N, rec in kernels["admm_box_qp_fused_composite"]["p1"].items()},
        "us_per_launch_factors_l2": {
            L2_FACTOR_HORIZON: {name: kernels[name]["l2"]["ms"] * 1e3
                                for name in ("gpmpc_controller_fused",
                                             "admm_box_qp_fused_composite")}},
        "k8_cycles_per_block_by_section": k8["sections"],
        "k8_max_abs_err_n25_b257": k8["err_n25_b257"],
        "fig8_rms_m_single_tick_500": float(rms(single_outs)),
        "fig8_rms_m_single_tick_preview_500": float(rms(preview_outs)),
        "fig8_rms_m_frozen_preview_400": float(rms(frozen_preview_outs)),
        "us_per_tightened_tick": us_tight, "us_per_tightened_tick_plain": us_tight_plain,
        "idle_share_tightened": idle_share["96 tightened ticks"],
        "us_per_launch_k5_tightened_without_variance": kt["untightened_ms"] * 1e3,
        "fig8_rms_m_tightening": tight_rms,
        "us_per_launch_n25": {name: kernels[name]["long"]["ms"] * 1e3
                              for name in ("gpmpc_tick_fused", "gpmpc_controller_fused",
                                           "admm_box_qp_fused_composite")},
        "us_per_tick_12state": {key: v[0] for key, v in us_12.items()},
        "us_per_tick_12state_plain": {key: v[1] for key, v in us_12.items()},
        "circle_rms_m_12state": circle_rms, "ltv12_min_clearance_m": clearance,
        "idle_share_12state": {k: idle_share[k] for k in ("80 direct-rate12 fused ticks",
                                                          "100 mppi12 ticks")},
        "us_per_launch_k11_rigid": k11["rigid"]["ms"] * 1e3,
        "us_per_launch_k11_n25_l2": k11["long"]["ms"] * 1e3,
        "k11_max_abs_err_by_output": {"direct_rate": k11["errs"], "rigid": k11["rigid"]["errs"],
                                      "n25_l2": k11["long"]["errs"]},
        "k11_section_share": {"direct_rate": k11["section_shares"],
                              "rigid": k11["rigid"]["section_shares"]},
        "k11_bound_ms_p1_form": {"direct_rate": k11["bound_p1_form"][0],
                                 "rigid": k11["rigid"]["bound_p1_form"][0]},
        "us_per_launch_k10_n20": kernels["rigid_body_rollout_fused"]["n20_ms"] * 1e3,
        "k10_n15": {key: kernels["rigid_body_rollout_fused"][f"n15_{key}"] for key in
                    ("err", "ms", "plain_ms", "host_ms")}
                   | {"bound_ms": kernels["rigid_body_rollout_fused"]["n15_bound"][0],
                      "bound_by": kernels["rigid_body_rollout_fused"]["n15_bound"][1]},
        "k10_launches_by_new_path": k10_by_path,
        "us_per_tick_ilqr12": us_ilqr,
        "idle_share_ilqr12": {k: idle_share[k] for k in (f"{ILQR_SHARE_T} ilqr12 K=2 ticks",
                                                         "2 ilqr12 staged ticks")},
        "circle_rms_m_ilqr12_and_noisy12": ilqr_rms,
        "circle_rms_m_ilqr12_and_noisy12_plain": ilqr_rms_plain,
        "estimate_rms_m_noisy12": estimate_rms,
        "jax_circle_rms_m_ilqr12": JAX_ILQR_RMS_M,
        "ilqr_iteration_parts_ms": ilqr_parts,
        "k7_bound_ms_fp32_form": kernels["rbf_posterior_mean_pallas"]["bound_fp32_form"][0],
        "k7_bound_unit": kernels["rbf_posterior_mean_pallas"]["bound_unit"],
        "k7_cycles_per_block_by_section": kernels["rbf_posterior_mean_pallas"]["sections"],
        "k7_max_abs_err_other_layouts": kernels["rbf_posterior_mean_pallas"]["cases"],
        "k1_by_batch": {label: {"us": r["ms"] * 1e3, "max_abs_err": r["err"]}
                        for label, r in kernels["px4_plant_step_fused"]["by_batch"].items()},
        "k12_max_rel_err_by_shape": kernels["mppi_rollout_costs_fused"]["err_by_shape"],
        "k12_cycles": kernels["mppi_rollout_costs_fused"]["cycles"],
        "us_per_launch_k13a_lane_owned": {
            B: t["ms"] * 1e3 for B, t in kernels["px4_plant_step_vjp"]["lane_owned"].items()},
        "us_per_launch_k13_b1024": {name: kernels[name]["timing"][1024]["ms"] * 1e3
                                    for name in ("px4_plant_step_vjp", "allocation_plant_tick_vjp")},
        "k13b_cycles_per_state_b1": kernels["allocation_plant_tick_vjp"]["cycles"],
        "multitick_ad": multitick_ad, "tuners": tuners, "tuner_iteration_seconds": tuner_seconds,
        "us_per_flight_tick_monte_carlo_256": us_mc_flight_tick,
        "idle_share_monte_carlo": idle_share["50 Monte Carlo ticks"],
        "monte_carlo": populations,
        "plant_block_max_abs_err": plant_block_check["errs"],
        "us_per_launch_k14_n20": kernels["admm_box_qp_fused"]["n20"]["ms"] * 1e3,
        "k14_by_case": {
            label: {"us": r["ms"] * 1e3, "max_abs_err": r["err"], "variant": r["variant"]}
            for label, r in (("N=20", kernels["admm_box_qp_fused"]["n20"]),
                             ("N=25", kernels["admm_box_qp_fused"]["n25"]),
                             ("padded 128", kernels["admm_box_qp_fused"]["padded"]),
                             *((f"N={N}", r) for N, r in
                               kernels["admm_box_qp_fused"]["memory"].items()))},
        "us_per_launch_k16_n20": kernels["gpmpc_controller_fused_batched"]["n20"]["ms"] * 1e3,
        "k16_cluster": {N: {key: k16[key] for key in ("cluster", "flights", "active", "smem")}
                        for N, k16 in ((LONG_HORIZON, kernels["gpmpc_controller_fused_batched"]),
                                       (20, kernels["gpmpc_controller_fused_batched"]["n20"]))},
        "us_per_launch_k5_tightened_streamed":
            kernels["gpmpc_multitick_fused_tightened"]["streamed_ms"] * 1e3,
        "redesign_vs_older_checkout": redesign,
        "us_per_launch_k15_corpus": kernels["rbf_kernel_matrix_pallas"]["corpus"]["ms"] * 1e3,
        "us_per_launch_k15_corpus_cdist": kernels["rbf_kernel_matrix_pallas"]["corpus"]["cdist_ms"] * 1e3,
        "us_fill_k15_output": {
            n: kernels["rbf_kernel_matrix_pallas"][key]["fill_ms"] * 1e3
            for n, key in ((GRAM_SHAPES[0][0], "n800"), (GRAM_SHAPES[1][0], "corpus"))},
        "population_kernels": {
            name: {"flights": MC_B, "us": kernels[name]["population"]["ms"] * 1e3,
                   "us_by_batch": {B: v * 1e3 for B, v in
                                   kernels[name]["population"]["by_batch"].items()},
                   "launches": kernels[name]["population"]["launches"],
                   "max_abs_err": kernels[name]["population"]["err"],
                   "bound_us": kernels[name]["population"]["bound"][0] * 1e3,
                   "bound_us_by_batch": {B: v * 1e3 for B, v in
                                         kernels[name]["population"]["bound_by_batch"].items()},
                   "bound_by": kernels[name]["population"]["bound"][1],
                   "plain_us": kernels[name]["population"]["plain_ms"] * 1e3}
            for name in ("gpmpc_tick_fused", "gpmpc_multitick_fused",
                         "admm_box_qp_fused_composite", "rigid_body_rollout_fused")},
        "k10_population_n20": {
            "us_by_batch": {B: v * 1e3 for B, v in
                            kernels["rigid_body_rollout_fused"]["population"]["n20"]["by_batch"].items()},
            "max_rel_err": kernels["rigid_body_rollout_fused"]["population"]["n20"]["err"]},
        "population_tiers": population_tiers,
        "us_per_flight_tick_population_tiers": population_timing,
        "multistart_tuner": multistart,
        "k14_cycles_per_pass": {
            label: r["cycles_per_pass"]
            for label, r in (("N=20", kernels["admm_box_qp_fused"]["n20"]),
                             ("N=25", kernels["admm_box_qp_fused"]["n25"]),
                             ("padded 128", kernels["admm_box_qp_fused"]["padded"]))},
        "orchestration": orchestration, "distributed": distributed, "campaign": campaign,
        "surface": {k: v for k, v in surface.items() if k != "commands"}
        | {"commands": {label: {k: v for k, v in c.items() if k != "json"}
                        for label, c in surface["commands"].items()}}}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["--time-redesigned"]:
        sys.exit(time_redesigned_main(argv[1]))
    if argv[:1] == ["--run-examples"]:
        sys.exit(run_examples_main(argv[1], argv[2]))
    if argv[:1] == ["--write-corpus"]:
        sys.exit(write_corpus_main(argv[1]))
    sys.exit(main(parent=argv[1] if argv[:1] == ["--parent"] else None))
