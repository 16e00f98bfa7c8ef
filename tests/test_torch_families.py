"""Port parity for the analytic trajectory families
(``trajectories.families``) and the allocation tail
(``control.allocation.torque_to_px4_rates``, ``with_hover_fallback``)
against the JAX package on the CPU.

Tolerances: the families within 1e-12 in float64 (the same closed forms;
the piecewise families select the same branch); the allocation tail
within 1e-6 in float32 (the same clips of the same quotients).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu.control.allocation import (
    torque_to_px4_rates as j_torque_to_px4_rates,
    with_hover_fallback as j_with_hover_fallback,
)
from unmanned_aerial_vehicles_tpu.trajectories import families as jf
from unmanned_aerial_vehicles_tpu_torch.control import torque_to_px4_rates, with_hover_fallback
from unmanned_aerial_vehicles_tpu_torch.trajectories import (
    TRAJECTORY_CONFIGS,
    available_trajectories,
    get_trajectory_function,
)
from unmanned_aerial_vehicles_tpu_torch.trajectories import families as tf

TOL = 1e-12
# times over two periods of every family, both signs, the square's and the
# waypoints' edges exactly, and a (2, 3) batch
TIMES = np.concatenate([np.linspace(-7.0, 70.0, 391), [0.0, 6.0, 12.0, 18.0, 24.0, 8.0, 16.0]])


def assert_family_agrees(got, want):
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


FAMILY_KW = {
    "figure_8": dict(scale=2.0, period=11.0),
    "circle": dict(radius=1.5, center=(1.0, -1.0, -3.0)),
    "square": dict(side_length=3.0),
    "lemniscate": dict(),
    "spiral": dict(num_turns=3.0),
    "waypoint_path": dict(waypoints=[(0, 1), (2, 0), (-1, -2)], segment_time=5.0),
    "hover": dict(position=(1.0, 2.0, -2.5)),
    "sine_wave": dict(axis="xy"),
    "oval": dict(a=2.0, b=0.5),
    "cloverleaf": dict(),
}


def test_available_trajectories_and_configs_match_jax():
    assert available_trajectories() == jf.available_trajectories()
    assert TRAJECTORY_CONFIGS == jf.TRAJECTORY_CONFIGS


@pytest.mark.parametrize("name", sorted(FAMILY_KW))
def test_family_matches_jax(name):
    """Each family with its defaults and with other parameters, on a batch
    of times and on a (2, 3) batch."""
    jfn, tfn = jf._FAMILIES[name], tf._FAMILIES[name]
    t = torch.tensor(TIMES, dtype=torch.float64)
    for kw in ({}, FAMILY_KW[name]):
        assert_family_agrees(tfn(t, **kw), jfn(jnp.asarray(TIMES), **kw))
    grid = TIMES[:6].reshape(2, 3)
    got = tfn(torch.tensor(grid, dtype=torch.float64))
    assert all(tuple(g.shape) == (2, 3, 3) for g in got)
    assert_family_agrees(got, jfn(jnp.asarray(grid)))


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_sine_wave_axes_match_jax(axis):
    """``"x"``, ``"y"`` and any other axis (a third of pi between the waves)."""
    t = torch.tensor(TIMES, dtype=torch.float64)
    assert_family_agrees(tf.sine_wave_trajectory(t, axis=axis),
                         jf.sine_wave_trajectory(jnp.asarray(TIMES), axis=axis))


@pytest.mark.parametrize("config", sorted(jf.TRAJECTORY_CONFIGS))
def test_named_config_matches_jax(config):
    t = torch.tensor(TIMES, dtype=torch.float64)
    assert_family_agrees(get_trajectory_function(config)(t),
                         jf.get_trajectory_function(config)(jnp.asarray(TIMES)))


def test_scalar_time_and_dtype_follow_t():
    """A number gives ``(3,)`` rows in the default dtype; a float32 tensor
    float32 rows; an unknown name raises."""
    pos, vel, acc = get_trajectory_function("fast_circle")(2.5)
    assert tuple(pos.shape) == (3,) and pos.dtype == torch.get_default_dtype()
    jpos, _, _ = jf.get_trajectory_function("fast_circle")(2.5)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0, atol=1e-6)
    pos32, _, _ = tf.square_trajectory(torch.tensor([1.0, 7.0], dtype=torch.float32))
    assert pos32.dtype == torch.float32 and tuple(pos32.shape) == (2, 3)
    with pytest.raises(ValueError, match="Unknown trajectory config"):
        get_trajectory_function("no_such_config")


def test_torque_to_px4_rates_matches_jax():
    """Inside and beyond every clip (the thrust's 0.30 and 0.80, the roll
    and pitch rates' 3, the yaw rate's 2)."""
    rng = np.random.default_rng(3)
    for u in [np.array([19.62, 0.01, -0.02, 0.005]), np.array([2.0, 0.5, -0.5, 0.3]),
              np.array([30.0, -0.5, 0.5, -0.3]), *rng.normal(size=(8, 4)) * [10, 0.1, 0.1, 0.1]]:
        u = u.astype(np.float32)
        rates, thrust = torque_to_px4_rates(torch.from_numpy(u))
        j_rates, j_thrust = j_torque_to_px4_rates(jnp.asarray(u))
        np.testing.assert_allclose(rates.numpy(), np.asarray(j_rates), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(thrust), float(j_thrust), rtol=0, atol=1e-6)
    rates, thrust = torque_to_px4_rates(torch.tensor([9.0, 0.1, 0.1, 0.1]), mass=1.0, kp_att=2.0)
    j_rates, j_thrust = j_torque_to_px4_rates(jnp.asarray([9.0, 0.1, 0.1, 0.1]), mass=1.0,
                                              kp_att=2.0)
    np.testing.assert_allclose(rates.numpy(), np.asarray(j_rates), rtol=0, atol=1e-6)


@pytest.mark.parametrize("hover", [None, [9.81, 0.0, 0.0, 0.0]], ids=["zeros", "given"])
def test_with_hover_fallback_matches_jax(hover):
    """A finite command passes; a command with a NaN or an infinity becomes
    the hover command; the rest of a tuple output passes untouched."""

    def controller(u, extra):
        return u, extra * 2.0

    wrapped = with_hover_fallback(controller, hover_control=hover)
    j_wrapped = j_with_hover_fallback(controller, hover_control=hover)
    for u in ([1.0, 2.0, 3.0, 4.0], [1.0, float("nan"), 3.0, 4.0], [float("inf"), 0, 0, 0]):
        got, extra = wrapped(torch.tensor(u), torch.tensor(1.5))
        want, j_extra = j_wrapped(jnp.asarray(u, jnp.float32), jnp.asarray(1.5))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(extra) == float(j_extra) == 3.0
    single = with_hover_fallback(lambda u: u)
    assert torch.equal(single(torch.tensor([float("nan"), 1.0])), torch.zeros(2))
