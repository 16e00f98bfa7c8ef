"""Analytic reference-trajectory families, pure functions of time (port of
``trajectories/families.py``).

The ten families, their default parameters and the fifteen named
configurations of the reference's ``trajectory_definitions.py``, with its
quirks kept: the circle's and the sine wave's ``z = -center[2]`` flip and
the simplified accelerations of the square, spiral, waypoint and
cloverleaf families.

Every family takes a scalar or a batched ``t`` (a tensor of any shape, or
a number) and returns ``(pos, vel, acc)``, each ``(..., 3)`` on ``t``'s
device and in ``t``'s dtype (a number or an integer tensor takes PyTorch's
default float dtype). The piecewise families (square, spiral, waypoint) are
branch-free, so a whole horizon or a batch of times evaluates at once.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence, Tuple

import torch

Traj = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_DEF_CENTER = (0.0, 0.0, -2.0)


def _time(t) -> torch.Tensor:
    t = torch.as_tensor(t)
    return t if t.is_floating_point() else t.to(torch.get_default_dtype())


def _pack(t: torch.Tensor, x, y, z, vx, vy, vz, ax, ay, az) -> Traj:
    """Each component (a number or a tensor) broadcast to ``t``'s shape,
    stacked into ``(pos, vel, acc)``."""
    comps = [torch.as_tensor(c, dtype=t.dtype, device=t.device).expand(t.shape)
             for c in (x, y, z, vx, vy, vz, ax, ay, az)]
    arr = lambda a, b, c: torch.stack([a, b, c], dim=-1)
    return arr(*comps[0:3]), arr(*comps[3:6]), arr(*comps[6:9])


def figure_8_trajectory(t, scale=3.0, period=20.0, center=_DEF_CENTER) -> Traj:
    """Gerono figure-8."""
    t = _time(t)
    w = 2.0 * math.pi / period
    x = center[0] + scale * torch.sin(w * t)
    y = center[1] + scale * torch.sin(2.0 * w * t) / 2.0
    vx = scale * w * torch.cos(w * t)
    vy = scale * w * torch.cos(2.0 * w * t)
    ax = -scale * w**2 * torch.sin(w * t)
    ay = -2.0 * scale * w**2 * torch.sin(2.0 * w * t)
    return _pack(t, x, y, center[2], vx, vy, 0.0, ax, ay, 0.0)


def circular_trajectory(t, radius=2.5, period=15.0, center=_DEF_CENTER) -> Traj:
    """XY circle; note the reference's ``z = -center[2]``."""
    t = _time(t)
    w = 2.0 * math.pi / period
    x = center[0] + radius * torch.cos(w * t)
    y = center[1] + radius * torch.sin(w * t)
    vx = -radius * w * torch.sin(w * t)
    vy = radius * w * torch.cos(w * t)
    ax = -radius * w**2 * torch.cos(w * t)
    ay = -radius * w**2 * torch.sin(w * t)
    return _pack(t, x, y, -center[2], vx, vy, 0.0, ax, ay, 0.0)


def square_trajectory(t, side_length=4.0, period=24.0, center=_DEF_CENTER) -> Traj:
    """Axis-aligned square, one edge per quarter period."""
    t = _time(t)
    cycle = torch.remainder(t, period) / period
    half = side_length / 2.0
    edge_speed = 2.0 * half / (period / 4.0)
    p0, p1, p2, p3 = (4.0 * (cycle - q) for q in (0.0, 0.25, 0.5, 0.75))

    def select(first, second, third, last):
        out = torch.where(cycle < 0.75, third, last)
        out = torch.where(cycle < 0.5, second, out)
        return torch.where(cycle < 0.25, first, out)

    zero = torch.zeros_like(t)
    x = select(center[0] + half * (2 * p0 - 1), zero + (center[0] + half),
               center[0] + half * (1 - 2 * p2), zero + (center[0] - half))
    y = select(zero + (center[1] - half), center[1] + half * (2 * p1 - 1),
               zero + (center[1] + half), center[1] + half * (1 - 2 * p3))
    vx = select(zero + edge_speed, zero, zero - edge_speed, zero)
    vy = select(zero, zero + edge_speed, zero, zero - edge_speed)
    return _pack(t, x, y, center[2], vx, vy, 0.0, 0.0, 0.0, 0.0)


def lemniscate_trajectory(t, scale=3.0, period=25.0, center=_DEF_CENTER) -> Traj:
    """Gerono lemniscate."""
    t = _time(t)
    w = 2.0 * math.pi / period
    c, s = torch.cos(w * t), torch.sin(w * t)
    x = center[0] + scale * c
    y = center[1] + scale * s * c
    vx = -scale * w * s
    vy = scale * w * (c**2 - s**2)
    ax = -scale * w**2 * c
    ay = -4.0 * scale * w**2 * s * c
    return _pack(t, x, y, center[2], vx, vy, 0.0, ax, ay, 0.0)


def spiral_trajectory(t, max_radius=3.0, period=20.0, num_turns=2.0,
                      center=_DEF_CENTER) -> Traj:
    """Spiral that expands over the first half period and contracts over
    the second."""
    t = _time(t)
    cycle = torch.remainder(t, period) / period
    angle = 2.0 * math.pi * num_turns * cycle
    radius = torch.where(cycle < 0.5, max_radius * 2.0 * cycle, max_radius * (2.0 - 2.0 * cycle))
    w = 2.0 * math.pi * num_turns / period
    x = center[0] + radius * torch.cos(angle)
    y = center[1] + radius * torch.sin(angle)
    vx = -radius * w * torch.sin(angle)
    vy = radius * w * torch.cos(angle)
    ax = -radius * w**2 * torch.cos(angle)
    ay = -radius * w**2 * torch.sin(angle)
    return _pack(t, x, y, center[2], vx, vy, 0.0, ax, ay, 0.0)


def waypoint_trajectory(t, waypoints: Sequence[Tuple[float, float]] | None = None,
                        segment_time: float = 8.0, center=_DEF_CENTER) -> Traj:
    """Piecewise-linear path through the waypoints, closed into a loop."""
    if waypoints is None:
        waypoints = [(2, 2), (-2, 2), (-2, -2), (2, -2)]
    t = _time(t)
    wps = torch.as_tensor(waypoints, dtype=t.dtype, device=t.device)
    n = wps.shape[0]
    cycle = torch.remainder(t, n * segment_time)
    seg = torch.floor(cycle / segment_time).to(torch.int64)
    prog = torch.remainder(cycle, segment_time) / segment_time
    cur = wps[seg % n]
    nxt = wps[(seg + 1) % n]
    xy = cur + (nxt - cur) * prog[..., None]
    vxy = (nxt - cur) / segment_time
    return _pack(t, center[0] + xy[..., 0], center[1] + xy[..., 1], center[2],
                 vxy[..., 0], vxy[..., 1], 0.0, 0.0, 0.0, 0.0)


def hover_trajectory(t, position=_DEF_CENTER) -> Traj:
    """Static hover."""
    t = _time(t)
    return _pack(t, position[0], position[1], position[2], 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def sine_wave_trajectory(t, amplitude=2.0, frequency=0.1, axis="xy",
                         center=_DEF_CENTER) -> Traj:
    """Sine wave along ``"x"``, ``"y"`` or both (``"xy"``: the y wave a
    quarter of pi ahead; any other value: a third of pi); the reference's
    ``z = -center[2]``."""
    t = _time(t)
    w = 2.0 * math.pi * frequency
    zero = torch.zeros_like(t)
    if axis == "x":
        x, y = center[0] + amplitude * torch.sin(w * t), zero + center[1]
        vx, vy = amplitude * w * torch.cos(w * t), zero
        ax, ay = -amplitude * w**2 * torch.sin(w * t), zero
    elif axis == "y":
        x, y = zero + center[0], center[1] + amplitude * torch.sin(w * t)
        vx, vy = zero, amplitude * w * torch.cos(w * t)
        ax, ay = zero, -amplitude * w**2 * torch.sin(w * t)
    else:
        phase = math.pi / 4 if axis == "xy" else math.pi / 3
        x = center[0] + amplitude * torch.sin(w * t)
        y = center[1] + amplitude * torch.sin(w * t + phase)
        vx = amplitude * w * torch.cos(w * t)
        vy = amplitude * w * torch.cos(w * t + phase)
        ax = -amplitude * w**2 * torch.sin(w * t)
        ay = -amplitude * w**2 * torch.sin(w * t + phase)
    return _pack(t, x, y, -center[2], vx, vy, 0.0, ax, ay, 0.0)


def oval_trajectory(t, a=3.0, b=1.5, period=18.0, center=_DEF_CENTER) -> Traj:
    """Ellipse with semi-axes ``a`` (x) and ``b`` (y)."""
    t = _time(t)
    w = 2.0 * math.pi / period
    x = center[0] + a * torch.cos(w * t)
    y = center[1] + b * torch.sin(w * t)
    vx = -a * w * torch.sin(w * t)
    vy = b * w * torch.cos(w * t)
    ax = -a * w**2 * torch.cos(w * t)
    ay = -b * w**2 * torch.sin(w * t)
    return _pack(t, x, y, center[2], vx, vy, 0.0, ax, ay, 0.0)


def cloverleaf_trajectory(t, scale=2.5, period=30.0, center=_DEF_CENTER) -> Traj:
    """Four-leaf clover with the reference's simplified derivatives."""
    t = _time(t)
    w = 2.0 * math.pi / period
    c, s = torch.cos(w * t), torch.sin(w * t)
    lobe = torch.abs(torch.cos(2.0 * w * t))
    x = center[0] + scale * lobe * c
    y = center[1] + scale * lobe * s
    vx = -scale * w * s * lobe
    vy = scale * w * c * lobe
    ax = -scale * w**2 * c * lobe
    ay = -scale * w**2 * s * lobe
    return _pack(t, x, y, center[2], vx, vy, 0.0, ax, ay, 0.0)


_FAMILIES: dict[str, Callable[..., Traj]] = {
    "figure_8": figure_8_trajectory,
    "circle": circular_trajectory,
    "square": square_trajectory,
    "lemniscate": lemniscate_trajectory,
    "spiral": spiral_trajectory,
    "waypoint_path": waypoint_trajectory,
    "hover": hover_trajectory,
    "sine_wave": sine_wave_trajectory,
    "oval": oval_trajectory,
    "cloverleaf": cloverleaf_trajectory,
}


def available_trajectories() -> list[str]:
    return list(_FAMILIES)


# The reference's named configurations, verbatim.
TRAJECTORY_CONFIGS = {
    "easy_circle": {"name": "circle", "params": {"radius": 6.0, "period": 60.0}},
    "fast_circle": {"name": "circle", "params": {"radius": 6.5, "period": 12.0}},
    "large_circle": {"name": "circle", "params": {"radius": 10.0, "period": 25.0}},
    "slow_figure8": {"name": "figure_8", "params": {"scale": 5.5, "period": 30.0}},
    "fast_figure8": {"name": "figure_8", "params": {"scale": 3.0, "period": 15.0}},
    "tight_figure8": {"name": "figure_8", "params": {"scale": 1.5, "period": 20.0}},
    "gentle_spiral": {
        "name": "spiral",
        "params": {"max_radius": 2.5, "period": 25.0, "num_turns": 1.5},
    },
    "aggressive_spiral": {
        "name": "spiral",
        "params": {"max_radius": 3.5, "period": 18.0, "num_turns": 3.0},
    },
    "square_path": {"name": "square", "params": {"side_length": 10.0, "period": 20.0}},
    "waypoint_square": {
        "name": "waypoint_path",
        "params": {"waypoints": [(3, 3), (-3, 3), (-3, -3), (3, -3)], "segment_time": 6.0},
    },
    "diamond_waypoints": {
        "name": "waypoint_path",
        "params": {"waypoints": [(0, 3), (3, 0), (0, -3), (-3, 0)], "segment_time": 7.0},
    },
    "hover_test": {"name": "hover", "params": {"position": (0.0, 0.0, -2.0)}},
    "sine_wave_x": {
        "name": "sine_wave",
        "params": {"amplitude": 2.5, "frequency": 0.08, "axis": "x"},
    },
    "oval_race": {"name": "oval", "params": {"a": 3.5, "b": 2.0, "period": 22.0}},
    "clover_pattern": {"name": "cloverleaf", "params": {"scale": 2.8, "period": 35.0}},
}


def get_trajectory_function(config_name: str = "slow_figure8") -> Callable[..., Traj]:
    """The named configuration's family with its parameters bound: ``t ->
    (pos, vel, acc)``. Raises ``ValueError`` for an unknown name."""
    if config_name not in TRAJECTORY_CONFIGS:
        raise ValueError(
            f"Unknown trajectory config: {config_name}. "
            f"Available: {list(TRAJECTORY_CONFIGS)}"
        )
    cfg = TRAJECTORY_CONFIGS[config_name]
    return functools.partial(_FAMILIES[cfg["name"]], **cfg["params"])
