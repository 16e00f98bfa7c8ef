"""Profiling and timing helpers (port of ``utils/profiling.py``).

* ``trace`` — a context manager around ``torch.profiler`` that writes a
  Chrome trace (CPU and, where there is a card, CUDA activity) into
  ``log_dir``;
* ``device_timeit`` — best-of-``reps`` wall time of a call, ended by a
  synchronise of the card its output lives on (a no-op on the CPU);
* ``scan_slope_timeit`` — per-iteration cost by timing one program at two
  lengths, which cancels its fixed cost.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str = "uav_torch_trace"):
    """``with trace(dir): ...`` profiles the block and writes
    ``<dir>/trace.json`` (Chrome trace format; open it in Perfetto or
    ``chrome://tracing``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _sync(x) -> None:
    """Wait for the card that ``x``'s first tensor lives on; nothing for
    CPU tensors, whose results are ready on return."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def device_timeit(
    fn: Callable,
    *args,
    reps: int = 3,
    perturb: Callable | None = None,
    **kwargs,
) -> float:
    """Best-of-``reps`` wall time (seconds) of ``fn(*args)``, each ended by
    a synchronise, after one warm-up call (kernel builds, allocator).

    ``perturb(rep, args) -> args`` varies the inputs per rep."""
    out = fn(*args, **kwargs)
    _sync(out)

    best = float("inf")
    for rep in range(reps):
        call_args = perturb(rep, args) if perturb is not None else args
        t0 = time.perf_counter()
        out = fn(*call_args, **kwargs)
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return best


def scan_slope_timeit(
    make_fn: Callable,
    short: int,
    long: int,
    *args,
    reps: int = 3,
    perturb: Callable | None = None,
) -> dict:
    """Per-iteration cost of a loop by length differencing: the same
    program timed at two lengths, ``(t_long - t_short) / (long - short)``,
    which cancels the fixed cost (the launch round trip, the final
    synchronise).

    ``make_fn(T) -> fn(*args)`` builds the T-iteration program. Returns
    ``{"per_iter_s", "fixed_overhead_s", "t_short_s", "t_long_s"}``."""
    t_short = device_timeit(make_fn(short), *args, reps=reps, perturb=perturb)
    t_long = device_timeit(make_fn(long), *args, reps=reps, perturb=perturb)
    per_iter = (t_long - t_short) / (long - short)
    return {
        "per_iter_s": per_iter,
        "fixed_overhead_s": t_short - per_iter * short,
        "t_short_s": t_short,
        "t_long_s": t_long,
    }
