"""Static operands of the condensed-QP controller (port of
``ops/controller_pallas.py``: ``FusedControllerData`` and
``build_fused_controller_data``).

The kernels consume these matrices in "row form": a per-tick vector ``v``
is contracted as ``v @ A``. Shapes are semantic (no 128-lane padding):
``Nnx = N nx`` stacked states, ``Nnu = N nu`` stacked controls,
``m = Nnu + Nnx`` constraint rows. A constraint-space vector has the layout
``[U-block (Nnu) | X-block (Nnx)]``.

The single-tick controller kernel itself (``gpmpc_controller_fused``, K3)
is queued in ROADMAP.md; the multi-tick kernel (``ops.tick_pallas``)
consumes these operands today.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FusedControllerData(NamedTuple):
    """Host float32 operands, semantic shapes."""

    SxT: np.ndarray       # (nx, Nnx):   offset = x0 @ SxT (+ w @ SwT)
    SwT: np.ndarray       # (Nnx, Nnx)
    SuTqT: np.ndarray     # (Nnx, Nnu):  f = (offset - ref) @ SuTqT
    SuT: np.ndarray       # (Nnu, Nnx):  X_tail = offset + U @ SuT
    P1: np.ndarray        # (m, m)     = G M^-1 G'
    P0mat: np.ndarray     # (Nnu, m)   = (G M^-1)'   -> p0 = -(f @ P0mat)
    P0matT: np.ndarray    # (m, Nnu)   = G M^-1      -> U recovery
    MinvT: np.ndarray     # (Nnu, Nnu) = M^-1        -> minv_f = f @ MinvT
    u_lo_row: np.ndarray  # (m,) u bounds in the U-block, zeros elsewhere
    u_hi_row: np.ndarray
    x_lo_row: np.ndarray  # (m,) x bounds in the X-block, zeros elsewhere
    x_hi_row: np.ndarray


def build_fused_controller_data(
    Sx, Su, Sw, SuT_q, M_inv, G,
    u_lo, u_hi, x_lo, x_hi,
) -> FusedControllerData:
    """Row-form float32 operands from the (float64) condensed-QP data.

    ``Sx (Nnx, nx)``, ``Su (Nnx, Nnu)``, ``Sw (Nnx, Nnx)``,
    ``SuT_q (Nnu, Nnx)``, ``M_inv (Nnu, Nnu)``, ``G (m, Nnu)``."""
    Nnu = Su.shape[1]
    m = G.shape[0]
    f32 = lambda a: np.ascontiguousarray(np.asarray(a, np.float32))
    GMinv = G @ M_inv

    def row(v, off):
        out = np.zeros(m, np.float32)
        out[off : off + len(v)] = np.asarray(v, np.float32)
        return out

    return FusedControllerData(
        SxT=f32(np.asarray(Sx, np.float32).T),
        SwT=f32(np.asarray(Sw, np.float32).T),
        SuTqT=f32(np.asarray(SuT_q, np.float32).T),
        SuT=f32(np.asarray(Su, np.float32).T),
        P1=f32(GMinv @ G.T),
        P0mat=f32(np.asarray(GMinv, np.float32).T),
        P0matT=f32(GMinv),
        MinvT=f32(M_inv),
        u_lo_row=row(u_lo, 0), u_hi_row=row(u_hi, 0),
        x_lo_row=row(x_lo, Nnu), x_hi_row=row(x_hi, Nnu),
    )
