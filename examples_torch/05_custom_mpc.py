"""Build a custom nonlinear MPC on the SQP engine: supply any discrete step
function; ``torch.func.jacfwd`` linearisation, equilibrated ADMM and warm
starts come with it.

The PyTorch/CUDA counterpart of ``examples/05_custom_mpc.py``.
Run from the repo root: ``python examples_torch/05_custom_mpc.py``.
"""

import torch

from unmanned_aerial_vehicles_tpu_torch._device import resolve_device
from unmanned_aerial_vehicles_tpu_torch.control import QuadCost, SQPConfig, SQPMPC
from unmanned_aerial_vehicles_tpu_torch.utils import example_device, scaled

dev = resolve_device(example_device())
f64 = dict(dtype=torch.float64, device=dev)

# a toy 2D unicycle: state [x, y, heading], control [speed, turn rate]
DT = 0.1


def unicycle_step(x, u, residual):
    dx = torch.stack([u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]), u[1]])
    return x + DT * (dx + residual)


mpc = SQPMPC(
    unicycle_step,
    state_dim=3,
    control_dim=2,
    config=SQPConfig(horizon=20, sqp_iterations=3, admm_iterations=60),
    state_lower=[-10, -10, -100], state_upper=[10, 10, 100],
    control_lower=[0.0, -2.0], control_upper=[2.0, 2.0],
    dtype=torch.float64, device=dev,
)
cost = QuadCost(
    q_stage=torch.tensor([5.0, 5.0, 0.1], **f64),
    q_terminal=torch.tensor([50.0, 50.0, 1.0], **f64),
    r_control=torch.tensor([0.1, 0.1], **f64),
    u_ref=torch.zeros(2, **f64),
)

state = torch.zeros(3, **f64)
target = torch.tensor([3.0, 2.0, 0.0], **f64)
x_ref = target[None, :].repeat(20, 1)

carry = mpc.init_carry(state, torch.tensor([1.0, 0.0], **f64))
for _ in range(scaled(80, 30)):
    u, _, carry = mpc.solve(carry, state, cost, x_ref)
    state = unicycle_step(state, u, torch.zeros(3, **f64))

print("final position:", [round(float(v), 3) for v in state[:2]],
      "(target", [float(v) for v in target[:2]], ")")
