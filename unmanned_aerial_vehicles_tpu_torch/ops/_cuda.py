"""Build, load and count the hand-written CUDA kernels.

Each library in ``LIBRARIES`` is one ``csrc/*.cu`` source compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with ``ctypes``. The build runs at first use into
``_build/<hash of the sources and flags>/``; every library's ``nvcc``
starts at once, so the build takes as long as the slowest source.

No ``--use_fast_math``: the approximate ``__sinf``/``__cosf`` would break
parity with the plain versions.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises if that is not 0. Launch counts live in ``launch_counts``:
a wrapper adds one where it launches its kernel and nowhere else.

A kernel launched on ``data_ptr()`` is invisible to autograd, so ``require``
refuses an operand that asks for a gradient while grad mode is on: the
differentiable routes are the ``ops.tick_ad`` functions
(``FlightLoopConfig(fused_tick_ad=True)``), whose ``torch.autograd.Function``
forward runs with grad mode off.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

# library name -> its .cu source, or (source, extra nvcc flags) (all share
# the headers in csrc/)
LIBRARIES = {
    "plant": "plant_kernels.cu",
    "tick": "tick_kernel.cu",
    # K5 with its per-section clock counters (chip_smoke.py's breakdown)
    "tick_clocks": ("tick_kernel.cu", ["-DUAV_SECTION_CLOCKS"]),
    "controller": "controller_kernels.cu",
    # K8 with its per-section clock counters (chip_smoke.py's breakdown)
    "controller_clocks": ("controller_kernels.cu", ["-DUAV_SECTION_CLOCKS"]),
    "rbf": "rbf_kernels.cu",
    # K7 with its per-section clock counters (chip_smoke.py's breakdown)
    "rbf_clocks": ("rbf_kernels.cu", ["-DUAV_SECTION_CLOCKS"]),
    "single_tick": "single_tick_kernels.cu",
    # K4 with its per-section clock counters (chip_smoke.py's breakdown)
    "single_tick_clocks": ("single_tick_kernels.cu", ["-DUAV_SECTION_CLOCKS"]),
    "noisy_tick": "noisy_tick_kernel.cu",
    # K9 with its per-section clock counters (chip_smoke.py's breakdown)
    "noisy_tick_clocks": ("noisy_tick_kernel.cu", ["-DUAV_SECTION_CLOCKS"]),
    "rigid_plant": "rigid_plant_kernels.cu",
    "rigid_tick": "rigid_tick_kernel.cu",
    # K11 with its per-section clock counters (chip_smoke.py's breakdown)
    "rigid_tick_clocks": ("rigid_tick_kernel.cu", ["-DUAV_SECTION_CLOCKS"]),
    "mppi": "mppi_kernels.cu",
    # K12 with its per-section clock counters (chip_smoke.py's breakdown)
    "mppi_clocks": ("mppi_kernels.cu", ["-DUAV_SECTION_CLOCKS"]),
    "plant_vjp": "plant_vjp_kernels.cu",
    # K13b with its per-section clock counters (chip_smoke.py's breakdown)
    "plant_vjp_clocks": ("plant_vjp_kernels.cu", ["-DUAV_SECTION_CLOCKS"]),
    # K13a with lanes 0-11 owning a state component each (chip_smoke.py's
    # ablation of its design)
    "plant_vjp_lane_owned": ("plant_vjp_kernels.cu", ["-DUAV_K13A_LANE_OWNED"]),
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

launch_counts: dict[str, int] = {
    "px4_plant_step_fused": 0,
    "allocation_plant_tick_fused": 0,
    "gpmpc_multitick_fused": 0,
    "gpmpc_multitick_fused_tightened": 0,   # K5 with the variance section
    "gpmpc_controller_structured_batched": 0,
    "rbf_posterior_mean_pallas": 0,
    "gpmpc_tick_fused": 0,
    "gpmpc_controller_fused": 0,
    "admm_box_qp_fused_composite": 0,
    "gpmpc_noisy_multitick_fused": 0,
    "rigid_body_rollout_fused": 0,
    "direct_rate_multitick_kernel": 0,
    "mppi_rollout_costs_fused": 0,
    "px4_plant_step_vjp": 0,
    "allocation_plant_tick_vjp": 0,
    "admm_box_qp_fused": 0,
    "rbf_kernel_matrix_pallas": 0,
    "gpmpc_controller_fused_batched": 0,
}

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # library -> nvcc's output (ptxas register report)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _build_dir() -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every library that is not built yet, all ``nvcc`` processes
    at once; raise with the compiler's output if one fails."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, spec in LIBRARIES.items():
        target = out_dir / f"lib{name}.so"
        if target.exists():
            continue
        src, extra = (spec, []) if isinstance(spec, str) else spec
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", tmp, str(CSRC / src)]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target,
        )
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building every library at first use."""
    lib = _loaded.get(name)
    if lib is None:
        out_dir = build_all()
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        _loaded[name] = lib
    return lib


@contextlib.contextmanager
def library_variant(name: str, variant: str):
    """Inside the block, ``library(name)`` returns the library ``variant``
    (the same kernels built with other flags), so the wrappers launch it."""
    saved = _loaded.get(name)
    _loaded[name] = library(variant)
    try:
        yield
    finally:
        if saved is None:
            _loaded.pop(name)
        else:
            _loaded[name] = saved


def section_cycles(name: str, entry: str, sections: tuple) -> dict[str, int]:
    """The per-section clock cycles that library ``name`` (a build with
    ``-DUAV_SECTION_CLOCKS``, csrc/section_clocks.cuh) counted since the
    last call, by section name, read through its C entry point ``entry``,
    which resets them. Synchronise before calling."""
    out = (ctypes.c_ulonglong * len(sections))()
    fn = getattr(library(name), entry)
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(ctypes.cast(out, ctypes.c_void_p)), entry)
    return dict(zip(sections, (int(v) for v in out)))


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def shared_memory_optin(device) -> int:
    """Bytes of dynamic shared memory one block on ``device`` may opt into."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    limit = _optin.get(index)
    if limit is None:
        limit = torch.cuda.get_device_properties(index).shared_memory_per_block_optin
        _optin[index] = limit
    return limit


_optin: dict[int, int] = {}


def sm_count(device) -> int:
    """The streaming multiprocessors of ``device`` (a kernel sized to one
    wave launches one block on each)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    count = _sms.get(index)
    if count is None:
        count = torch.cuda.get_device_properties(index).multi_processor_count
        _sms[index] = count
    return count


_sms: dict[int, int] = {}


def p1_variant(device, smem_shared: int, smem_global: int) -> tuple[int, int]:
    """``(p1_shared, bytes)`` for the single-tick kernels: the variant with
    P1 in shared memory where that layout fits one block of ``device``, the
    one reading P1 through L2 otherwise; raise if neither fits."""
    limit = shared_memory_optin(device)
    if smem_shared <= limit:
        return 1, smem_shared
    if smem_global <= limit:
        return 0, smem_global
    raise ValueError(f"the kernel's vectors need {smem_global} bytes of shared memory, more "
                     f"than one block's {limit}")


def require_aligned(what: str, *tensors) -> None:
    """Raise unless every tensor starts 16-byte aligned (the kernels copy
    them with 16-byte loads)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: operands copied with 16-byte loads must be 16-byte aligned")


def require(t, name: str, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device`` (the kernels take nothing else), and unless it is outside
    autograd: an operand that requires grad under grad mode would have its
    gradient cut silently, so it raises, on every device alike."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{name} requires grad, and a kernel launch would cut its gradient: "
            "differentiate through FlightLoopConfig(fused_tick_ad=True) or the "
            "ops.tick_ad *_ad functions (px4_plant_step_ad, allocation_plant_tick_ad, "
            "gpmpc_multitick_ad)"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
