"""Disturbance-observer EKF (port of ``estimation/disturbance.py``).

The 12-state filter's state is extended with a slowly varying acceleration
disturbance ``d`` (a random walk): the innovation that the nominal model
cannot explain lands in ``d``, and the MPC receives ``d`` as stage-wise
residual feedforward, the same affine term the GP fills. Steady wind,
payload-mass error and drag mismatch all end up in ``d`` within a few
filter time constants, with no data set and no refits.

State ``[x12, d3]``; the measurement model is the 12-state filter's.
Process model::

    x12' = step_fn(x12, u) + [0.5 d dt^2, d dt, 0, 0]
    d'   = d
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Tuple

import torch

from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams, px4_rate_tracking_step, px4_step_jacobian
from .ekf import EKFConfig, joseph_update

AUG_STATE_DIM = 15
DIST_DIM = 3


@dataclass(frozen=True)
class DisturbanceEKFConfig:
    """The observer's noise model on top of the base ``EKFConfig``:
    ``q_dist`` is the disturbance's random-walk std per step (fast gust
    tracking against noise rejection), ``p0_dist`` its initial std."""

    base: EKFConfig = field(default_factory=EKFConfig)
    q_dist: float = 0.05
    p0_dist: float = 0.5

    def q_diag(self, device=None) -> torch.Tensor:
        d = torch.full((DIST_DIM,), self.q_dist, dtype=torch.float32, device=device) ** 2
        return torch.cat([self.base.q_diag(device), d])

    def p0_diag(self, device=None) -> torch.Tensor:
        d = torch.full((DIST_DIM,), self.p0_dist, dtype=torch.float32, device=device) ** 2
        return torch.cat([self.base.p0_diag(device), d])


class DisturbanceEKFState(NamedTuple):
    x: torch.Tensor   # (15,) = [x12, d3]
    P: torch.Tensor   # (15, 15)


def dekf_init(x0: torch.Tensor, config: DisturbanceEKFConfig = DisturbanceEKFConfig(),
              dtype=torch.float32) -> DisturbanceEKFState:
    """Start at the 12-state estimate ``x0`` with zero disturbance."""
    xa = torch.cat([x0.to(dtype), torch.zeros(DIST_DIM, dtype=dtype, device=x0.device)])
    return DisturbanceEKFState(x=xa, P=torch.diag(config.p0_diag(x0.device)).to(dtype))


def _augmented_jacobian(F12: torch.Tensor, dt: float) -> torch.Tensor:
    """``d aug_step / d [x12, d]`` from the nominal step's ``F12``."""
    kw = dict(dtype=F12.dtype, device=F12.device)
    eye3 = torch.eye(DIST_DIM, **kw)
    inject = torch.cat([0.5 * dt * dt * eye3, dt * eye3, torch.zeros(6, DIST_DIM, **kw)])
    return torch.cat([torch.cat([F12, inject], dim=1),
                      torch.cat([torch.zeros(DIST_DIM, 12, **kw), eye3], dim=1)])


def dekf_step(
    carry: DisturbanceEKFState,
    control: torch.Tensor,
    measurement: torch.Tensor,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    dt: float = 0.02,
    config: DisturbanceEKFConfig = DisturbanceEKFConfig(),
    step_fn: Callable | None = None,
) -> Tuple[DisturbanceEKFState, torch.Tensor, torch.Tensor]:
    """One augmented predict + update; returns ``(carry, x12_est,
    d_est)``. ``body`` (or ``step_fn(x12, u)``) is the NOMINAL process
    model: pass the wind-free parameters, since the truth is meant to
    differ."""
    if step_fn is None:
        nominal = lambda x, u: px4_rate_tracking_step(x, u, body, rate_loop, dt)
    else:
        nominal = step_fn

    def aug_step(xa):
        x12, d = xa[:12], xa[12:]
        xn = nominal(x12, control)
        # the disturbance is an acceleration on the translational states:
        # exact double-integrator injection over one step
        return torch.cat([xn[0:3] + 0.5 * dt * dt * d, xn[3:6] + dt * d, xn[6:], d])

    x_pred = aug_step(carry.x)
    if step_fn is None:
        # the augmented Jacobian in closed form: the nominal step's beside
        # the disturbance's exact injection [0.5 dt^2 I; dt I; 0; I]
        F = _augmented_jacobian(px4_step_jacobian(carry.x[:12], control, body, rate_loop, dt),
                                dt)
    else:
        F = torch.func.jacfwd(aug_step)(carry.x)
    dev = x_pred.device
    x_new, P_new = joseph_update(x_pred, F, carry.P, config.q_diag(dev), measurement,
                                 config.base.r_diag(dev))
    return DisturbanceEKFState(x=x_new, P=P_new), x_new[:12], x_new[12:]


def disturbance_residual_rows12(d_est: torch.Tensor, horizon: int,
                                dtype=torch.float32) -> torch.Tensor:
    """The disturbance as the 12-state engines' ``(N, 12)`` derivative
    rows (velocity-derivative rows 3:6)."""
    row = torch.zeros(12, dtype=dtype, device=d_est.device)
    row[3:6] = d_est.to(dtype)
    return row.expand(horizon, 12)


def disturbance_residual_rows(d_est: torch.Tensor, horizon: int,
                              dtype=torch.float32) -> torch.Tensor:
    """The disturbance as the linear MPC's ``(N, 6)`` stage residuals (the
    GP rows' semantics: state-derivative rows, velocity components only)."""
    row = torch.cat([torch.zeros(3, dtype=dtype, device=d_est.device), d_est.to(dtype)])
    return row.expand(horizon, 6)
