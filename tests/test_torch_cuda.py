"""Tests of the port that need a CUDA card (marker ``cuda``); without one
they skip. The file imports neither JAX nor the JAX package, so it runs on
a machine without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

``--noconftest`` leaves out ``tests/conftest.py``, which imports JAX.
"""

import pytest
import torch

from unmanned_aerial_vehicles_tpu_torch.control import MPPIConfig, MPPIController
from unmanned_aerial_vehicles_tpu_torch.ops import _cuda

K_SAMPLES, N = 128, 9
# a float32 sampling stage against the controller's own dtype: the softmax
# at temperature 0.3 amplifies the costs' rounding (about 1e-4 N on the
# thrust at this size)
U0_ATOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mppi_tick_samples_through_k12(cuda_device, dtype):
    """Every MPPI tick on the card launches K12 once, whatever the
    controller's dtype, and agrees with the plain sampling stage."""
    x = torch.zeros(12, dtype=dtype, device=cuda_device)
    x[2] = 3.0
    target = torch.tensor([0.3, -0.2, 3.1])
    us = {}
    for fused in (True, False):
        ctrl = MPPIController(MPPIConfig(horizon=N, num_samples=K_SAMPLES, fused_rollouts=fused),
                              dtype=dtype, device=cuda_device)
        _cuda.reset_launch_counts()
        us[fused], _, carry = ctrl.solve(ctrl.init_carry(x, seed=3), x, target, 0.1)
        torch.cuda.synchronize()
        assert _cuda.launch_counts["mppi_rollout_costs_fused"] == (1 if fused else 0)
        assert us[fused].dtype == dtype and carry.U_nom.dtype == dtype
        assert bool(torch.isfinite(us[fused]).all())
    torch.testing.assert_close(us[True], us[False], rtol=0, atol=U0_ATOL)
