"""12-state extended Kalman filter (port of ``estimation/ekf.py``).

The filter takes the place PX4-EKF2 holds in the reference's flights: a
noisy sensor sample of the true state goes in, the controller flies the
estimate that comes out.

Process model: one RK4 step of the rate-tracking surrogate
(``models.px4_surrogate``) at the control period, linearised by the
chain rule through the RK4 stages in closed form
(``px4_surrogate.px4_step_jacobian``: the Jacobian the JAX package's
``jacfwd`` forms, a few hundred small ops instead of a ``torch.func``
transform; a custom ``step_fn`` is linearised with ``torch.func.jacfwd``).
Measurement model: position, attitude and gyro body
rates (``MEASURED_IDX``), a linear selection with the yaw innovation
wrapped. The covariance update is the Joseph form, re-symmetrised.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple, Tuple

import torch

from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams, px4_rate_tracking_step, px4_step_jacobian
from ..utils.rotations import wrap_angle

STATE_DIM = 12
# measured components: position (0:3), attitude (6:9), body rates (9:12)
MEASURED_IDX = (0, 1, 2, 6, 7, 8, 9, 10, 11)
MEAS_DIM = len(MEASURED_IDX)
_YAW_ROW = 5  # index of yaw inside the measurement vector


@functools.lru_cache(maxsize=16)
def _measured_index(device: torch.device) -> torch.Tensor:
    """``MEASURED_IDX`` on ``device``, made once (a copy from the host at
    every tick would wait for the device's queue)."""
    return torch.tensor(MEASURED_IDX, device=device)


def _groups(*stds, device=None) -> torch.Tensor:
    """Each std repeated 3 times and squared, in float32 (as the JAX
    package builds its noise diagonals; a float64 filter casts them)."""
    return torch.cat([torch.full((3,), v, dtype=torch.float32, device=device) ** 2
                      for v in stds])


@dataclass(frozen=True)
class EKFConfig:
    """Noise model of the filter (standard deviations).

    ``relinearize_every`` sets how often the noisy multi-tick kernel K9
    rebuilds the transition Jacobian: ``"tick"`` (exact, the default) or
    ``"dispatch"`` (once per launch at the entry estimate; the state
    prediction stays per tick). ``cov_precision`` is accepted for the JAX
    signature (``"highest"`` or ``"bf16"``): on the card the covariance
    products are float32 either way. The staged filter ignores both."""

    q_pos: float = 1e-3
    q_vel: float = 2e-2
    q_att: float = 1e-3
    q_rate: float = 5e-2
    r_pos: float = 0.05
    r_att: float = 0.01
    r_rate: float = 0.02
    p0_pos: float = 0.1
    p0_vel: float = 0.1
    p0_att: float = 0.05
    p0_rate: float = 0.05
    relinearize_every: str = "tick"
    cov_precision: str = "highest"

    def q_diag(self, device=None) -> torch.Tensor:
        return _groups(self.q_pos, self.q_vel, self.q_att, self.q_rate, device=device)

    def r_diag(self, device=None) -> torch.Tensor:
        return _groups(self.r_pos, self.r_att, self.r_rate, device=device)

    def p0_diag(self, device=None) -> torch.Tensor:
        return _groups(self.p0_pos, self.p0_vel, self.p0_att, self.p0_rate, device=device)


class EKFState(NamedTuple):
    x: torch.Tensor   # (12,) estimate
    P: torch.Tensor   # (12, 12) covariance


def ekf_init(x0: torch.Tensor, config: EKFConfig = EKFConfig(), dtype=torch.float32) -> EKFState:
    return EKFState(x=x0.to(dtype), P=torch.diag(config.p0_diag(x0.device)).to(dtype))


def measure(state: torch.Tensor, normals: torch.Tensor,
            config: EKFConfig = EKFConfig()) -> torch.Tensor:
    """One sensor sample: the measured components of ``state`` plus
    ``sqrt(r) * normals`` (``normals``: 9 standard-normal draws)."""
    clean = state[_measured_index(state.device)]
    return clean + torch.sqrt(config.r_diag(state.device)).to(state.dtype) * normals.to(state.dtype)


def joseph_update(
    x_pred: torch.Tensor,
    F: torch.Tensor,
    P: torch.Tensor,
    q_diag: torch.Tensor,
    measurement: torch.Tensor,
    r_diag: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Covariance propagation and Joseph-form fusion of the 9 measured
    components, for any state size (the 12-state filter and the 15-state
    observer). Returns ``(x_new, P_new)``."""
    dtype, dev = x_pred.dtype, x_pred.device
    n = x_pred.shape[0]
    P_pred = F @ P @ F.T + torch.diag(q_diag).to(dtype)

    idx = _measured_index(dev)
    H = torch.zeros(MEAS_DIM, n, dtype=dtype, device=dev)
    H[torch.arange(MEAS_DIM, device=dev), idx] = 1.0

    innov = measurement - x_pred[idx]
    innov = torch.cat([innov[:_YAW_ROW], wrap_angle(innov[_YAW_ROW:_YAW_ROW + 1]),
                       innov[_YAW_ROW + 1:]])
    r = r_diag.to(dtype)
    S = H @ P_pred @ H.T + torch.diag(r)
    # gain by a solve, no explicit inverse: K = P H' S^-1
    K = torch.linalg.solve(S.T, H @ P_pred.T).T
    x_new = x_pred + K @ innov
    x_new = torch.cat([x_new[:6], wrap_angle(x_new[6:9]), x_new[9:]])

    IKH = torch.eye(n, dtype=dtype, device=dev) - K @ H
    P_new = IKH @ P_pred @ IKH.T + (K * r[None, :]) @ K.T
    return x_new, 0.5 * (P_new + P_new.T)


def ekf_step(
    carry: EKFState,
    control: torch.Tensor,
    measurement: torch.Tensor,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    dt: float = 0.02,
    config: EKFConfig = EKFConfig(),
    step_fn: Callable | None = None,
) -> Tuple[EKFState, torch.Tensor]:
    """One predict + update; returns ``(new_carry, x_est)``. ``step_fn(x,
    u) -> x_next`` replaces the process model (default: one RK4 step of
    the surrogate at ``dt``)."""
    if step_fn is None:
        x_pred = px4_rate_tracking_step(carry.x, control, body, rate_loop, dt)
        F = px4_step_jacobian(carry.x, control, body, rate_loop, dt)
    else:
        step = lambda x: step_fn(x, control)
        x_pred = step(carry.x)
        F = torch.func.jacfwd(step)(carry.x)
    x_new, P_new = joseph_update(x_pred, F, carry.P, config.q_diag(x_pred.device), measurement,
                                 config.r_diag(x_pred.device))
    return EKFState(x=x_new, P=P_new), x_new
