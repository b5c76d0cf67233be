"""Functional Robotarium-equivalent unicycle step (counterpart:
cbf_tpu/sim/robotarium.py).

``unicycle_step(poses, dxu) -> poses`` over (3, N) poses and (2, N)
(v, omega) commands, with the actuator saturation in wheel space. The
arithmetic keeps the reference's order of operations (``peak /
max_wheel_speed``, ``R / 2.0 * (wr + wl)``, ``R / L * (wr - wl)``), so
float32 results round where the JAX package's do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SimParams(NamedTuple):
    """Simulator constants (the JAX package's defaults)."""
    dt: float = 0.033                 # step period
    projection_distance: float = 0.05 # si<->uni near-identity point offset
    wheel_radius: float = 0.016       # m
    base_length: float = 0.105        # m (wheel separation)
    max_wheel_speed: float = 12.5     # rad/s -> 0.2 m/s max linear speed


# Arena bounds (x_min, x_max, y_min, y_max) — the Robotarium testbed extent.
ARENA = (-1.6, 1.6, -1.0, 1.0)


def saturate_unicycle(dxu, params: SimParams = SimParams()):
    """Actuator saturation in wheel space, proportional scaling: both
    wheels scale down together when either exceeds the limit (the
    commanded arc is kept). dxu (2, N) -> (2, N)."""
    v, w = dxu[0], dxu[1]
    R, L = params.wheel_radius, params.base_length
    wr = (2.0 * v + w * L) / (2.0 * R)
    wl = (2.0 * v - w * L) / (2.0 * R)
    peak = torch.maximum(torch.abs(wr), torch.abs(wl))
    scale = torch.clamp(peak / params.max_wheel_speed, min=1.0)
    wr, wl = wr / scale, wl / scale
    v = R / 2.0 * (wr + wl)
    w = R / L * (wr - wl)
    return torch.stack([v, w])


def unicycle_step(poses, dxu, params: SimParams = SimParams()):
    """One unicycle Euler step with actuator saturation. poses (3, N) =
    (x, y, theta), dxu (2, N) = (v, omega). Returns new poses (3, N)."""
    dxu = saturate_unicycle(dxu, params)
    v, w = dxu[0], dxu[1]
    theta = poses[2]
    return torch.stack([poses[0] + params.dt * v * torch.cos(theta),
                        poses[1] + params.dt * v * torch.sin(theta),
                        poses[2] + params.dt * w])
