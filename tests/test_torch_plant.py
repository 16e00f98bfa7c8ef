"""Port parity: plants, allocation, references and the plant kernels' plain
versions (K1, K2) against the JAX package, on the CPU.

Tolerances: the float64 math is held to 1e-12, the bar of
``tests/test_dynamics.py`` (same formulas, so only summation order and
library transcendentals differ). The float32 kernel plain versions are held
to the JAX Pallas kernels in interpret mode at 2e-6 absolute on O(1)
states: float32 epsilon is 1.2e-7, the RK4 chain has ~100 rounded
operations, and the JAX kernel's asin is a series accurate to ~1.5e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.allocation import (
    AttitudeLoopState as JAttitude,
    geometric_control_allocation as j_alloc,
)
from unmanned_aerial_vehicles_tpu.models.double_integrator import double_integrator_step as j_di
from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams as JBody
from unmanned_aerial_vehicles_tpu.models.px4_surrogate import (
    RateLoopParams as JRates,
    px4_rate_tracking_step as j_px4,
)
from unmanned_aerial_vehicles_tpu.ops.plant_pallas import (
    allocation_plant_tick_fused as j_k2,
    px4_plant_step_fused as j_k1,
)
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference as j_fig8
from unmanned_aerial_vehicles_tpu.utils.rotations import wrap_angle as j_wrap
from unmanned_aerial_vehicles_tpu_torch.control.allocation import (
    AttitudeLoopState,
    geometric_control_allocation,
)
from unmanned_aerial_vehicles_tpu_torch.models.double_integrator import double_integrator_step
from unmanned_aerial_vehicles_tpu_torch.models.params import RigidBodyParams
from unmanned_aerial_vehicles_tpu_torch.models.px4_surrogate import (
    RateLoopParams,
    px4_rate_tracking_step,
)
from unmanned_aerial_vehicles_tpu_torch.ops import plant_pallas
from unmanned_aerial_vehicles_tpu_torch.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu_torch.utils.rotations import wrap_angle

torch.set_num_threads(1)

WIND = (0.8, 0.4, -0.2)
TAUS = (0.05, 0.05, 0.08)


def random_states(rng, n):
    s = rng.normal(size=(n, 12))
    s[:, 6:9] = rng.uniform(-0.6, 0.6, size=(n, 3))
    s[:, 9:12] *= 0.5
    return s


def test_wrap_angle_matches_jax_including_negative_angles():
    a = np.concatenate([np.linspace(-20.0, 20.0, 4001), [-np.pi, np.pi, -3 * np.pi, 0.0]])
    got = wrap_angle(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_wrap(jnp.asarray(a))), atol=1e-12)
    assert got.min() >= -np.pi and got.max() < np.pi


def test_px4_step_and_double_integrator_match_jax_f64():
    rng = np.random.default_rng(0)
    states = random_states(rng, 16)
    controls = np.column_stack([rng.uniform(0.6, 1.3, 16), rng.normal(size=(16, 3))])
    body, jbody = RigidBodyParams(wind=WIND), JBody(wind=WIND)
    rates, jrates = RateLoopParams(hover_thrust_norm=0.9), JRates(hover_thrust_norm=0.9)
    got = px4_rate_tracking_step(torch.from_numpy(states), torch.from_numpy(controls),
                                 body, rates, 0.01).numpy()
    want = np.asarray(j_px4(jnp.asarray(states), jnp.asarray(controls), jbody, jrates, 0.01))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

    got_di = double_integrator_step(torch.from_numpy(states[:, :6]),
                                    torch.from_numpy(controls), 0.02).numpy()
    want_di = np.asarray(j_di(jnp.asarray(states[:, :6]), jnp.asarray(controls), 0.02))
    np.testing.assert_allclose(got_di, want_di, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", range(6))
def test_geometric_allocation_matches_jax_f64(case):
    rng = np.random.default_rng(10 + case)
    accel = rng.normal(size=3) * 3.0
    if case == 5:
        accel = np.array([0.0, 0.0, -9.81])        # degenerate thrust vector
    attitude = rng.uniform(-3.5, 3.5, size=3)      # negative angles through the wrap
    omega = rng.normal(size=3)
    integral = rng.uniform(-0.3, 0.3, size=3)
    yaw, yawrate = rng.uniform(-4, 4), rng.normal()
    got = geometric_control_allocation(
        AttitudeLoopState(torch.from_numpy(integral)), torch.from_numpy(accel),
        torch.tensor(yaw, dtype=torch.float64), torch.tensor(yawrate, dtype=torch.float64),
        torch.from_numpy(attitude), torch.from_numpy(omega), dt_attitude=0.02,
    )
    want = j_alloc(
        JAttitude(jnp.asarray(integral)), jnp.asarray(accel), jnp.asarray(yaw),
        jnp.asarray(yawrate), jnp.asarray(attitude), jnp.asarray(omega), dt_attitude=0.02,
    )
    for g, w in zip(got[:3] + (got[3].integral,), want[:3] + (want[3].integral,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


def test_figure8_reference_matches_jax():
    t = np.linspace(-1.0, 60.0, 307)
    pos, yaw = ramped_figure8_reference(torch.from_numpy(t))
    jpos, jyaw = j_fig8(jnp.asarray(t))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=1e-12)
    np.testing.assert_allclose(yaw.numpy(), np.asarray(jyaw), atol=1e-12)


@pytest.mark.parametrize("substeps", [1, 2])
def test_k1_plain_matches_jax_kernel(substeps):
    rng = np.random.default_rng(substeps)
    states = random_states(rng, 4).astype(np.float32)
    controls = np.column_stack([rng.uniform(0.6, 1.3, 4), rng.normal(size=(4, 3))]).astype(np.float32)
    got = plant_pallas.px4_plant_step_fused(
        torch.from_numpy(states), torch.from_numpy(controls), 0.5, 9.81, 0.25, TAUS,
        0.02, substeps, thrust_gain=9.81 / 0.9, wind=WIND,
    ).numpy()
    for b in range(4):
        want = np.asarray(j_k1(
            jnp.asarray(states[b]), jnp.asarray(controls[b]), 0.5, 9.81, 0.25, TAUS, 0.02,
            substeps, interpret=True, thrust_gain=9.81 / 0.9, wind=WIND,
        ))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=2e-6)


def test_k2_plain_matches_jax_kernel():
    rng = np.random.default_rng(7)
    B = 4
    states = random_states(rng, B).astype(np.float32)
    states[:, 6:9] = rng.uniform(-3.5, 3.5, size=(B, 3))
    accel = (rng.normal(size=(B, 3)) * 2.0).astype(np.float32)
    yawrate = rng.normal(size=B).astype(np.float32)
    yaw = rng.uniform(-3, 3, size=B).astype(np.float32)
    integral = rng.uniform(-0.3, 0.3, size=(B, 3)).astype(np.float32)
    ceiling = np.array([1.2, 1.5, 1.2, 1.2], np.float32)
    got = plant_pallas.allocation_plant_tick_fused(
        torch.from_numpy(states), torch.from_numpy(accel), torch.from_numpy(yawrate),
        torch.from_numpy(yaw), torch.from_numpy(integral), 0.5, 9.81, 0.25, TAUS, 0.02, 2,
        wind=WIND, thrust_ceiling=torch.from_numpy(ceiling),
    )
    for b in range(B):
        want = j_k2(
            jnp.asarray(states[b]), jnp.asarray(accel[b]), jnp.asarray(yawrate[b]),
            jnp.asarray(yaw[b]), jnp.asarray(integral[b]), 0.5, 9.81, 0.25, TAUS, 0.02, 2,
            interpret=True, wind=WIND, thrust_ceiling=float(ceiling[b]),
        )
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=0, atol=2e-6)


def test_plant_wrappers_check_their_operands():
    s = torch.zeros(2, 12)
    prow = plant_pallas.build_plant_row(0.5, 9.81, 0.25, TAUS, 9.81, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        plant_pallas._px4_plant_rows(s.double(), torch.zeros(2, 4), prow, 0.02, 2)
    with pytest.raises(ValueError, match="shape"):
        plant_pallas._px4_plant_rows(s, torch.zeros(3, 4), prow, 0.02, 2)
    with pytest.raises(ValueError, match="contiguous"):
        plant_pallas._px4_plant_rows(torch.zeros(12, 2).T, torch.zeros(2, 4), prow, 0.02, 2)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        plant_pallas._px4_plant_rows(s.to("meta"), torch.zeros(2, 4, device="meta"),
                                     prow.to("meta"), 0.02, 2)
