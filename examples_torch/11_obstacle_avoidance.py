"""Obstacle-constrained flight on the 12-state LTV engine, three ways.

The PyTorch/CUDA counterpart of ``examples/11_obstacle_avoidance.py``. The
reference poses spherical keep-out constraints in its cvxpy LTV-MPC
(``quadrotor_gp_mpc/mpc_controller.py:223-316``); here the same constraint
class runs (1) per tick, the reference's cadence, (2) on the multi-tick
tier (relinearised once per K=2 ticks, the plant and the plan re-anchor
through the rigid plant kernel, the attitude-recovery fallback), and (3)
straight through, unconstrained, to show the penetration the rows prevent.

Run from the repo root: ``python examples_torch/11_obstacle_avoidance.py``
(``UAV_FAST_EXAMPLES=1`` flies 3 s from 1.5 s before the sphere instead of
four laps).
"""

import math

import numpy as np
import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control import LTVTrackingMPC
from unmanned_aerial_vehicles_tpu_torch.loop.rigid_loop import (
    make_attitude_recovery_fallback,
    sqp_multitick_rollout,
)
from unmanned_aerial_vehicles_tpu_torch.models import GZ_QUADROTOR_PARAMS
from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import (
    rigid_body_rk4_step_fast,
    rigid_body_rollout_fused,
)
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

dev = resolve_device(example_device())
f32 = dict(dtype=torch.float32, device=dev)
DT = 0.1                                       # the 10 Hz LTV cadence
T = scaled(400, 30)                            # laps of the circle, or its obstacle's arc
T0 = scaled(0.0, 3.5)                          # the short run starts 1.5 s before the sphere
OBSTACLE = torch.tensor([[0.0, 1.5, 1.0, 0.3]], **f32)   # ON the path


def ref12(t):
    """The 12-state reference at times ``t`` (any shape): a 1.5 m circle at
    1 m, period 20 s."""
    w = 2.0 * math.pi / 20.0
    zero = torch.zeros_like(t)
    return torch.stack([1.5 * torch.cos(w * t), 1.5 * torch.sin(w * t), zero + 1.0,
                        -1.5 * w * torch.sin(w * t), 1.5 * w * torch.cos(w * t)]
                       + [zero] * 7, dim=-1)


def plant(x, u):
    return rigid_body_rk4_step_fast(x, u, GZ_QUADROTOR_PARAMS, DT, substeps=2)


def report(name, st):
    st = st.cpu().numpy()
    refs = ref12(T0 + torch.arange(st.shape[0], dtype=torch.float32) * DT).numpy()
    rms = float(np.sqrt(np.mean(np.sum((st[:, 0:3] - refs[:, 0:3]) ** 2, -1))))
    d = np.linalg.norm(st[:, 0:3] - OBSTACLE[0, 0:3].cpu().numpy(), axis=1)
    print(f"{name:28s} rms {rms:.3f} m   min dist to obstacle {d.min():.3f} m (r = 0.30)")
    return d.min()


def fly_per_tick(mpc, obstacles=None):
    x0 = ref12(torch.full((), T0, **f32))
    st, mc, states = x0, mpc.init_carry(x0), []
    for i in range(T):
        window = ref12(T0 + (i + torch.arange(N + 1, device=dev)).to(torch.float32) * DT)
        u, _, mc = mpc.solve(mc, st, window, obstacles=obstacles)
        states.append(st)
        st = plant(st, u)
    return torch.stack(states)


# --- 1. per-tick LTV (the reference's cadence) with the obstacle rows -----
mpc_con = LTVTrackingMPC(num_obstacles=1, obstacle_margin=0.2, device=dev)
N = mpc_con.mpc.config.horizon
d_pt = report("per-tick LTV + rows", fly_per_tick(mpc_con, OBSTACLE))

# --- 2. the multi-tick tier ------------------------------------------------


def reference_fn(ticks):
    ts = (ticks[:, None] + 1 + torch.arange(N, device=dev)[None, :]).to(torch.float32) * DT
    return ref12(T0 + ts)


outs = sqp_multitick_rollout(
    mpc_con.mpc, mpc_con.cost, reference_fn, plant, ref12(torch.full((), T0, **f32)), T,
    ticks_per_dispatch=2, admm_iterations=100,
    u_init=mpc_con.u_hover, obstacles=OBSTACLE,
    plan_roll_fn=lambda xf, Uf, res: rigid_body_rollout_fused(xf, Uf, GZ_QUADROTOR_PARAMS, DT),
    fallback_fn=make_attitude_recovery_fallback(GZ_QUADROTOR_PARAMS),
)
d_mt = report("multitick K=2 + rows", outs["state"])

# --- 3. unconstrained: flies straight through the sphere ------------------
d_free = report("unconstrained (control)", fly_per_tick(LTVTrackingMPC(device=dev)))

assert d_free < 0.3, "the control flight should penetrate the sphere"
assert d_pt > 0.3 and d_mt > 0.3, "constrained flights must clear it"
print("both constrained tiers clear the sphere the reference path "
      "passes through; the unconstrained flight penetrates it.")
