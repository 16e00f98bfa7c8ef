"""Numerical ops: box-QP ADMM and the hand-written CUDA kernels.

Kernels (CUDA C++ in ``csrc/``, each beside its plain PyTorch version):
K1 ``plant_pallas.px4_plant_step_fused``, K2
``plant_pallas.allocation_plant_tick_fused``, K3
``controller_pallas.gpmpc_controller_fused``, K4
``tick_pallas.gpmpc_tick_fused``, K5 ``tick_pallas.gpmpc_multitick_fused``,
K6 ``admm_pallas.admm_box_qp_fused_composite``, K7
``rbf_pallas.rbf_posterior_mean_pallas``, K8
``controller_pallas.gpmpc_controller_structured_batched``, K9
``tick_pallas.gpmpc_noisy_multitick_fused``, K10
``rigid_plant_pallas.rigid_body_rollout_fused``, K11
``rigid_tick_pallas.direct_rate_multitick_kernel``, K12
``mppi_pallas.mppi_rollout_costs_fused``; K13, the autodiff routes of K1,
K2 and K5 (``tick_ad``), with the VJP kernels K13a
``tick_ad.px4_plant_step_vjp`` and K13b ``tick_ad.allocation_plant_tick_vjp``;
K14 ``admm_pallas.admm_box_qp_fused``, K15
``rbf_pallas.rbf_kernel_matrix_pallas`` and K16
``controller_pallas.gpmpc_controller_fused_batched``. The Riccati solvers
(``riccati``, ``parallel_riccati``) carry the iLQR engine.
"""

from .qp import (
    admm_box_qp,
    admm_box_qp_chol,
    condense_dynamics,
    condense_ltv,
    condense_ltv_doubling,
    kkt_residuals,
)
from .parallel_riccati import lqr_tracking_solve_parallel
from .riccati import LQRSolution, lqr_tracking_solve

__all__ = [
    "admm_box_qp",
    "admm_box_qp_chol",
    "condense_dynamics",
    "condense_ltv",
    "condense_ltv_doubling",
    "kkt_residuals",
    "LQRSolution",
    "lqr_tracking_solve",
    "lqr_tracking_solve_parallel",
]
