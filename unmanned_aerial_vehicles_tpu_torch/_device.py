"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. Without a
GPU they raise: nothing carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no GPU present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def full_f32_matmul() -> None:
    """Keep float32 matrix products in full float32 on the card (no TF32).

    The port's matrix products (the staged MPC path, the GP refit) are held
    against the JAX package's HIGHEST-precision products; TF32 keeps only
    about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
