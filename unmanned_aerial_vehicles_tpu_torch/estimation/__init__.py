"""State estimation (port of ``estimation/``): the 12-state EKF over the
surrogate dynamics, the 15-state disturbance observer, and the noisy-sensor
closed loops of the 6-state MPC and of the 12-state family."""

from .disturbance import (
    DisturbanceEKFConfig,
    DisturbanceEKFState,
    dekf_init,
    dekf_step,
    disturbance_residual_rows,
    disturbance_residual_rows12,
)
from .ekf import (
    MEASURED_IDX,
    EKFConfig,
    EKFState,
    ekf_init,
    ekf_step,
    joseph_update,
    measure,
)
from .noisy_loop import noisy_ltv_rollout, noisy_mpc_flight_rollout, noisy_rigid_mpc_rollout

__all__ = [
    "DisturbanceEKFConfig",
    "DisturbanceEKFState",
    "EKFConfig",
    "EKFState",
    "MEASURED_IDX",
    "dekf_init",
    "dekf_step",
    "disturbance_residual_rows",
    "disturbance_residual_rows12",
    "ekf_init",
    "ekf_step",
    "joseph_update",
    "measure",
    "noisy_ltv_rollout",
    "noisy_mpc_flight_rollout",
    "noisy_rigid_mpc_rollout",
]
