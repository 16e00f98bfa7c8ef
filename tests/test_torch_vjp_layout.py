"""The host-side layout of the warp-per-state VJP kernels K13a/K13b and of
the one-warp rigid-body rollout K10, and the arithmetic of K13b's
warp-cooperative allocation VJP, on the CPU (no card or ``nvcc``):

- ``tick_ad.vjp_geometry`` (K13a's and K13b's launch) gives whole warps, a
  warp per state, and blocks that cover the batch with less than one block
  to spare;
- the lane table of ``csrc/plant_math.cuh:allocation_vjp_warp``
  (``tick_ad.ALLOC_VJP_LANES``, ``alloc_vjp_lane_role``) gives each arcsine,
  wrap, rsqrtf and quotient of its rounds exactly one lane, and the one
  quotient alone in its round to every lane;
- a float32 model of ``allocation_vjp_warp`` built lane by lane from that
  table (each lane its pieces of each round, the rest read from the owning
  lane as the shuffles read them) equals the allocation cotangents of
  ``allocation_plant_tick_vjp_plain`` (a zero cotangent on the new state,
  so the plant's adjoint adds nothing) to float32 rounding, around hover,
  with the rate, integral and thrust-ceiling clamps binding, with the tilt
  clips binding, under the thrust floor, degenerate (``tmag <= 0.1``),
  across the wrap and at the thrust ceiling's tie;
- K10 (``csrc/rigid_plant_kernels.cu``, which owns its launch shape)
  launches one warp whose lane groups have K12's width
  (``mppi_pallas.K12_LANES_PER_SAMPLE``, ``csrc/mppi_kernels.cu`` kLanes).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from unmanned_aerial_vehicles_tpu_torch.ops import (
    mppi_pallas,
    plant_pallas,
    tick_ad,
)

torch.set_num_threads(1)

DT, SUBSTEPS = 0.02, 2
F32 = torch.float32


@pytest.mark.parametrize("B", [1, 3, 4, 1024, 1025])
def test_vjp_launch_geometry(B):
    blocks, threads = tick_ad.vjp_geometry(B)
    per_block = tick_ad.VJP_STATES_PER_BLOCK
    assert threads % 32 == 0 and threads == 32 * per_block == tick_ad.VJP_THREADS
    assert (blocks - 1) * per_block < B <= blocks * per_block
    if B == 1024:
        assert blocks == 256


def test_alloc_vjp_lane_table_one_lane_each():
    """Each arcsine, rsqrtf and wrap, and every quotient but the last, has
    exactly one lane that forms it; the last quotient, alone in its round,
    is every lane's."""
    table = tick_ad.ALLOC_VJP_LANES
    assert sorted(table["asinf"]) == sorted(table["rsqrtf"]) == ["pitch", "roll"]
    assert sorted(table["wrap"]) == ["pitch", "roll", "yaw"]
    quotients = table["quotient 1"] + table["quotient 2"] + tick_ad.ALLOC_VJP_EVERY_LANE
    assert sorted(quotients) == sorted([
        "tmag / gravity", "1 / max(tmag, 1e-9)", "g_x / gravity", "g_x tmag / gravity^2",
        "g_tmag / (2 tmag)"])
    for rnd, names in table.items():
        assert len(set(names)) == len(names) <= 32
        for lane in range(32):
            # the owning lane is the first that forms it; the rest repeat it
            role = tick_ad.alloc_vjp_lane_role(lane)[rnd]
            assert role == names[lane % len(names)]
        for lane, name in enumerate(names):
            assert tick_ad.alloc_vjp_lane_role(lane)[rnd] == name


def f(v):
    return torch.tensor(float(v), dtype=F32)


def lane_model_allocation_vjp(s, cmd, integral, gravity, ceiling, g_control, g_att, g_new_int):
    """allocation_vjp_warp built lane by lane in float32: in each round
    every lane forms its role's piece (``alloc_vjp_lane_role``), and the
    shared pieces are read from the lowest lane that forms them. Returns
    ``(gs (12,), gcmd (5,), gint (3,), g_gravity, g_ceiling)``."""
    lanes = range(32)
    role = [tick_ad.alloc_vjp_lane_role(lane) for lane in lanes]
    owner = lambda rnd, name: next(lane for lane in lanes if role[lane][rnd] == name)
    kp, ki, kd, imax, dt = f(3.2), f(0.6), f(0.6), f(0.3), f(DT)
    tvx, tvy, tvz = cmd[0], cmd[1], cmd[2] + gravity
    tmag = torch.sqrt(tvx * tvx + tvy * tvy + tvz * tvz)

    # round 1: a quotient per lane
    frac1 = {"tmag / gravity": (tmag, gravity),
             "1 / max(tmag, 1e-9)": (f(1.0), torch.clamp(tmag, min=f(1e-9)))}
    q1 = [frac1[r["quotient 1"]][0] / frac1[r["quotient 1"]][1] for r in role]
    x = q1[owner("quotient 1", "tmag / gravity")]
    inv = q1[owner("quotient 1", "1 / max(tmag, 1e-9)")]
    x_lo = torch.clamp(x, min=f(0.25))
    sin_pitch, sin_roll = tvx * inv, tvy * inv
    clipped = {"pitch": torch.clamp(sin_pitch, -0.4, 0.4),
               "roll": torch.clamp(sin_roll, -0.4, 0.4)}
    degenerate = float(tmag) <= 0.1
    g_ceiling = f(0.0)
    if float(x_lo) < float(ceiling):
        g_x_lo = g_control[0]
    elif float(x_lo) > float(ceiling):
        g_x_lo, g_ceiling = f(0.0), g_ceiling + g_control[0]
    else:
        g_x_lo, g_ceiling = f(0.5) * g_control[0], g_ceiling + f(0.5) * g_control[0]
    g_x = g_x_lo if float(x) >= 0.25 else f(0.0)

    # round 2: an arcsine and an rsqrtf per lane, and a quotient
    tilt = [torch.asin(clipped[r["asinf"]]) for r in role]
    rs = [torch.rsqrt(f(1.0) - clipped[r["rsqrtf"]] * clipped[r["rsqrtf"]]) for r in role]
    frac2 = {"g_x / gravity": (g_x, gravity),
             "g_x tmag / gravity^2": (g_x * tmag, gravity * gravity)}
    q2 = [frac2[r["quotient 2"]][0] / frac2[r["quotient 2"]][1] for r in role]
    pitch_cmd = f(0.0) if degenerate else -tilt[owner("asinf", "pitch")]
    roll_cmd = f(0.0) if degenerate else tilt[owner("asinf", "roll")]
    rs_pitch, rs_roll = rs[owner("rsqrtf", "pitch")], rs[owner("rsqrtf", "roll")]
    g_x_g = q2[owner("quotient 2", "g_x / gravity")]
    g_x_gg = q2[owner("quotient 2", "g_x tmag / gravity^2")]

    # round 3: a wrapped attitude error per lane (floor-mod, as torch.remainder)
    target = {"roll": (roll_cmd, s[6]), "pitch": (pitch_cmd, s[7]), "yaw": (cmd[4], s[8])}
    wrap = lambda a: torch.remainder(a + f(np.pi), f(2 * np.pi)) - f(np.pi)
    err = [wrap(target[r["wrap"]][0] - target[r["wrap"]][1]) for r in role]
    e = [err[owner("wrap", name)] for name in ("roll", "pitch", "yaw")]

    # the rest on every lane
    u = [integral[i] + e[i] * dt for i in range(3)]
    inn = [torch.clamp(u[i], -imax, imax) for i in range(3)]
    v = [kp * e[0] + ki * inn[0] - kd * s[9], kp * e[1] + ki * inn[1] - kd * s[10],
         cmd[3] + kp * e[2] + ki * inn[2] - kd * s[11]]
    inside = lambda a, lo, hi: lo <= float(a) <= hi
    g_v = [g_control[1] if inside(v[0], -1.2, 1.2) else f(0.0),
           g_control[2] if inside(v[1], -1.2, 1.2) else f(0.0),
           g_control[3] if inside(v[2], -0.8, 0.8) else f(0.0)]
    gs = [f(0.0)] * 12
    gcmd = [f(0.0)] * 5
    gint = [f(0.0)] * 3
    gcmd[3] = gcmd[3] + g_v[2]
    g_e = [None] * 3
    for i in range(3):
        gs[9 + i] = gs[9 + i] - kd * g_v[i]
        g_e[i] = kp * g_v[i]
        g_in = ki * g_v[i] + g_new_int[i]
        g_u = g_in if inside(u[i], -0.3, 0.3) else f(0.0)
        gint[i] = gint[i] + g_u
        g_e[i] = g_e[i] + dt * g_u
        gs[6 + i] = gs[6 + i] - g_e[i]
    g_roll, g_pitch = g_att[0] + g_e[0], g_att[1] + g_e[1]
    gcmd[4] = gcmd[4] + g_att[2] + g_e[2]
    g_tvx = g_tvy = g_tvz = g_inv = f(0.0)
    if not degenerate:
        if inside(sin_roll, -0.4, 0.4):
            g_arg = g_roll * rs_roll
            g_tvy, g_inv = g_tvy + g_arg * inv, g_inv + g_arg * tvy
        if inside(sin_pitch, -0.4, 0.4):
            g_arg = -g_pitch * rs_pitch
            g_tvx, g_inv = g_tvx + g_arg * inv, g_inv + g_arg * tvx
    g_tmag = -g_inv * inv * inv if float(tmag) >= 1e-9 else f(0.0)
    g_tmag = g_tmag + g_x_g
    g_gravity = -g_x_gg
    # round 4, on every lane
    g_sq = g_tmag / (f(2.0) * tmag)
    g_tvx = g_tvx + f(2.0) * tvx * g_sq
    g_tvy = g_tvy + f(2.0) * tvy * g_sq
    g_tvz = g_tvz + f(2.0) * tvz * g_sq
    gcmd[0], gcmd[1], gcmd[2] = gcmd[0] + g_tvx, gcmd[1] + g_tvy, gcmd[2] + g_tvz
    g_gravity = g_gravity + g_tvz
    return torch.stack(gs), torch.stack(gcmd), torch.stack(gint), g_gravity, g_ceiling


def alloc_case(label, seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=12) * 0.3
    s[2] += 3.0
    cmd = np.concatenate([rng.normal(size=3), 0.3 * rng.normal(size=2), [1.2]])
    integ = 0.05 * rng.normal(size=3)
    if label == "clamped":          # the integral, rate and thrust-ceiling clamps binding
        s[6:12] = [0.9, -0.9, 2.0, 2.0, -2.0, 1.5]
        cmd = np.array([5.0, -5.0, 9.0, 0.5, -1.0, 1.2])
        integ = np.array([0.299, -0.299, 0.299])
    elif label == "tilt_clamped":   # both tilt clips binding
        cmd[:3] = [6.0, -6.0, 0.0]
    elif label == "thrust_floor":   # tmag / g under 0.25, above the degenerate 0.1
        cmd[:3] = [0.2, 0.3, -8.5]
    elif label == "degenerate":     # |a + g| = 0.05: no tilt, thrust at its floor
        cmd[:3] = [0.03, -0.04, -9.81]
    elif label == "wrapped":        # attitude errors across the wrap
        s[6:9] = [3.0, -3.0, 3.1]
        cmd[4] = -3.1
    elif label == "ceiling_tie":    # tmag / gravity exactly the ceiling
        tvz = np.float32(np.float32(cmd[2]) + np.float32(9.81))
        tvx, tvy = np.float32(cmd[0]), np.float32(cmd[1])
        tmag = np.sqrt(np.float32(tvx * tvx + tvy * tvy + tvz * tvz), dtype=np.float32)
        cmd[5] = np.float32(tmag / np.float32(9.81))
    cts = [rng.normal(size=n) for n in (7, 3)]
    return s, cmd, integ, cts


ALLOC_CASES = [("hover", seed) for seed in range(4)] + [
    ("clamped", 4), ("tilt_clamped", 8), ("thrust_floor", 9), ("degenerate", 5), ("wrapped", 6),
    ("ceiling_tie", 7)]


@pytest.mark.parametrize("label,seed", ALLOC_CASES, ids=[f"{c[0]}-{c[1]}" for c in ALLOC_CASES])
def test_allocation_vjp_lane_model_matches_plain(label, seed):
    s, cmd, integ, (ct_ctrl, ct_int) = alloc_case(label, seed)
    t = lambda a: torch.tensor(np.asarray(a, dtype=np.float32))[None]
    prow = plant_pallas.build_plant_row(0.5, 9.81, 0.25, (0.05, 0.05, 0.08), 9.81, (0.8, 0.4, 0.0),
                                        device="cpu")
    want = tick_ad.allocation_plant_tick_vjp_plain(
        t(s), t(cmd), t(integ), prow, torch.zeros(1, 12), t(ct_ctrl), t(ct_int), DT, SUBSTEPS)
    want_s, want_cmd, want_int, want_p = (w.reshape(-1) for w in want)
    st, ct = t(s)[0], t(cmd)[0]
    cc, ci = t(ct_ctrl)[0], t(ct_int)[0]
    got_s, got_cmd, got_int, g_gravity, g_ceiling = lane_model_allocation_vjp(
        st, ct[:5], t(integ)[0], prow[1], ct[5], cc[:4], cc[4:7], ci)
    got_cmd = torch.cat([got_cmd, g_ceiling[None]])
    got_p = torch.zeros(10).index_put_((torch.tensor([1]),), g_gravity[None])
    for name, got, w in (("state", got_s, want_s), ("cmd", got_cmd, want_cmd),
                         ("integral", got_int, want_int), ("plant", got_p, want_p)):
        assert got.dtype == w.dtype == F32
        assert bool(torch.isfinite(got).all()), name
        # float32 rounding: a few units in the last place of the cotangent's scale
        tol = 8.0 * torch.finfo(F32).eps * max(1.0, float(w.abs().max()))
        assert float((got - w).abs().max()) <= tol, (name, got, w)
    if label == "ceiling_tie":        # the tie splits the thrust's cotangent
        assert float(want_cmd[5]) == pytest.approx(0.5 * float(cc[0]), rel=1e-6)


def csrc_constant(source: str, name: str) -> int:
    """The value of ``constexpr int name`` in ``csrc/source``."""
    text = (Path(mppi_pallas.__file__).parent.parent / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_k10_launch_is_one_warp_of_k12_groups():
    threads = csrc_constant("rigid_plant_kernels.cu", "kThreads")
    lanes = csrc_constant("rigid_plant_kernels.cu", "kLanes")
    assert threads == 32
    assert lanes == mppi_pallas.K12_LANES_PER_SAMPLE == csrc_constant("mppi_kernels.cu", "kLanes")
    assert threads % lanes == 0
