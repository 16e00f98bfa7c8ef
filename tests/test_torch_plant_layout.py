"""The host-side layout of the lane-group kernels K12 (MPPI's sampling
stage) and K1/K2 (the PX4 plant), and the arithmetic of K12's
warp-cooperative rigid-body derivative, on the CPU (no card or ``nvcc``):

- ``mppi_launch_geometry`` launches whole warps, at most the kernel's
  launch bounds (64 threads), 8 lanes a sample, and blocks that cover
  the K samples with less than one block to spare (K12's tail groups read
  the last sample and write nothing);
- the lane table of ``csrc/rigid_math.cuh:rigid_derivative_warp``
  (``RIGID_SINCOS_LANES``, ``RIGID_QUOTIENT_LANES``, ``rigid_lane_roles``)
  gives each Euler angle and each quotient exactly one lane of the group,
  and a float32 model of the derivative built lane by lane from that table
  (each lane its sine and cosine and its quotient, the rest read from the
  owning lane as the shuffles read them) equals ``make_plant_math``'s
  float32 derivative to float32 rounding.

K1's and K2's shared launch shape is ``tests/test_torch_rbf_layout.py::
test_k2_launch_geometry``.
"""

import math

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu_torch.models.params import GZ_QUADROTOR_PARAMS, X500_PARAMS
from unmanned_aerial_vehicles_tpu_torch.ops import mppi_pallas
from unmanned_aerial_vehicles_tpu_torch.ops.rigid_plant_pallas import make_plant_math

torch.set_num_threads(1)

LANES = mppi_pallas.K12_LANES_PER_SAMPLE
ANGLES = ("phi", "theta", "psi")
QUOTIENTS = ("accel_x", "accel_y", "accel_z", "psi_dot", "p_dot", "q_dot", "r_dot")


@pytest.mark.parametrize("K", [1, 17, 512, 513, 2048])
def test_k12_launch_geometry(K):
    blocks, threads = mppi_pallas.mppi_launch_geometry(K)
    assert threads % 32 == 0 and 0 < threads <= 64
    per_block = threads // LANES
    assert LANES == 8 and per_block * LANES == threads
    assert (blocks - 1) * per_block < K <= blocks * per_block
    assert blocks == -(-K // per_block)


def test_k12_launch_geometry_refuses_no_samples():
    with pytest.raises(ValueError, match="at least one sample"):
        mppi_pallas.mppi_launch_geometry(0)


def test_rigid_lane_table_one_lane_each():
    """Every angle and every quotient has exactly one lane in the table,
    inside the group, and that lane's role is to form it."""
    assert sorted(mppi_pallas.RIGID_SINCOS_LANES) == sorted(ANGLES)
    assert sorted(mppi_pallas.RIGID_QUOTIENT_LANES) == sorted(QUOTIENTS)
    for table, slot in ((mppi_pallas.RIGID_SINCOS_LANES, 0),
                        (mppi_pallas.RIGID_QUOTIENT_LANES, 1)):
        assert len(set(table)) == len(table) <= LANES
        for lane, name in enumerate(table):
            assert mppi_pallas.rigid_lane_roles(lane)[slot] == name
    # every lane of a group has a role of each kind (no lane idles in the
    # uniform instruction stream)
    for lane in range(LANES):
        angle, quotient = mppi_pallas.rigid_lane_roles(lane)
        assert angle in ANGLES and quotient in QUOTIENTS


def lane_model_derivative(s, u, params):
    """rigid_derivative_warp built lane by lane in float32: each lane forms
    the sine and cosine of its angle and its quotient (numerator over
    denominator, as the kernel divides), every other piece is formed on
    every lane from the same operands, and the shared pieces are read from
    the lane the table names."""
    f = lambda v: torch.tensor(float(v), dtype=torch.float32)
    mass, g = f(params.mass), f(params.gravity)
    kl, ka = f(params.k_drag_linear), f(params.k_drag_angular)
    ix, iy, iz = (f(v) for v in params.inertia_diag)
    wx, wy, wz = (f(v) for v in params.wind)
    vx, vy, vz = s[3], s[4], s[5]
    p, q, r = s[9], s[10], s[11]
    T = u[0]
    # phase 1, on each lane: its angle's sine and cosine; the tangent, the
    # airspeed and its norm from the same operands on every lane
    angle_of = {"phi": s[6], "theta": s[7], "psi": s[8]}
    sincos = [(torch.sin(angle_of[a]), torch.cos(angle_of[a]))
              for a in (mppi_pallas.rigid_lane_roles(lane)[0] for lane in range(LANES))]
    tth = torch.tan(s[7])
    ax, ay, az = vx - wx, vy - wy, vz - wz
    sq = ax * ax + ay * ay + az * az
    speed = torch.sqrt(sq) if float(sq) > 0.0 else torch.zeros((), dtype=torch.float32)
    read = lambda table, name: table.index(name)
    sphi, cphi = sincos[read(mppi_pallas.RIGID_SINCOS_LANES, "phi")]
    sth, cth = sincos[read(mppi_pallas.RIGID_SINCOS_LANES, "theta")]
    spsi, cpsi = sincos[read(mppi_pallas.RIGID_SINCOS_LANES, "psi")]
    r02 = cphi * sth * cpsi + sphi * spsi
    r12 = cphi * sth * spsi - sphi * cpsi
    r22 = cphi * cth
    cth_safe = cth if abs(float(cth)) >= 1e-6 else f(-1e-6 if float(cth) < 0.0 else 1e-6)
    gyx = q * (iz * r) - r * (iy * q)
    gyy = r * (ix * p) - p * (iz * r)
    gyz = p * (iy * q) - q * (ix * p)
    # phase 2, on each lane: its quotient
    fraction = {
        "accel_x": (T * r02 - kl * speed * ax, mass),
        "accel_y": (T * r12 - kl * speed * ay, mass),
        "accel_z": (T * r22 - kl * speed * az, mass),
        "psi_dot": (q * sphi + r * cphi, cth_safe),
        "p_dot": (u[1] - gyx - ka * p, ix),
        "q_dot": (u[2] - gyy - ka * q, iy),
        "r_dot": (u[3] - gyz - ka * r, iz),
    }
    quo = []
    for lane in range(LANES):
        num, den = fraction[mppi_pallas.rigid_lane_roles(lane)[1]]
        quo.append(num / den)
    from_lane = lambda name: quo[read(mppi_pallas.RIGID_QUOTIENT_LANES, name)]
    return torch.stack([
        vx, vy, vz, from_lane("accel_x"), from_lane("accel_y"), from_lane("accel_z") - g,
        p + q * sphi * tth + r * cphi * tth, q * cphi - r * sphi, from_lane("psi_dot"),
        from_lane("p_dot"), from_lane("q_dot"), from_lane("r_dot")])


def random_case(seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=12) * np.array([2, 2, 1, 3, 3, 2, 0.6, 0.6, 2.0, 2, 2, 1.5])
    s[8] = rng.uniform(-3.5, 3.5)   # yaw across the wrap
    u = np.array([4.9, 0.0, 0.0, 0.0]) + rng.normal(size=4) * np.array([1.0, 0.05, 0.05, 0.02])
    return s, u


CASES = [("x500", X500_PARAMS, seed) for seed in range(4)] + \
        [("gz_wind", GZ_QUADROTOR_PARAMS, seed) for seed in range(4, 8)] + \
        [("pitch_near_singular", X500_PARAMS, 8), ("zero_airspeed", X500_PARAMS, 9)]


@pytest.mark.parametrize("label,params,seed", CASES, ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_rigid_derivative_lane_model_matches_plant_math(label, params, seed):
    import dataclasses

    s, u = random_case(seed)
    if label == "gz_wind":
        params = dataclasses.replace(params, wind=(0.6, -0.4, 0.2))
    if label == "pitch_near_singular":
        s[7] = math.pi / 2 - 1e-7
    if label == "zero_airspeed":
        s[3:6] = params.wind
    st = torch.tensor(s, dtype=torch.float32)
    ut = torch.tensor(u, dtype=torch.float32)
    got = lane_model_derivative(st, ut, params)
    deriv, _ = make_plant_math(0.02, params)
    want = torch.stack(deriv(tuple(st), tuple(ut)))
    assert got.dtype == want.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    # float32 rounding: a few units in the last place of each component
    tol = 4.0 * torch.finfo(torch.float32).eps * torch.maximum(want.abs(), torch.ones(12))
    assert bool(((got - want).abs() <= tol).all()), (got - want).abs().max()
