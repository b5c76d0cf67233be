"""Single-integrator <-> unicycle mappings (counterpart:
cbf_tpu/sim/transformations.py).

A near-identity diffeomorphism through a point ``projection_distance`` l
ahead of the wheel axis. Forward: p = x[:2] + l*[cos th, sin th].
Velocity map: dxu = [[cos, sin], [-sin/l, cos/l]] @ dxi. Column layout,
as in the JAX package: poses (3, N), velocities (2, N).
"""

from __future__ import annotations

import torch


def uni_to_si_states(poses, projection_distance: float = 0.05):
    """(3, N) unicycle poses -> (2, N) single-integrator point positions."""
    th = poses[2]
    return torch.stack([poses[0] + projection_distance * torch.cos(th),
                        poses[1] + projection_distance * torch.sin(th)])


def si_to_uni_dyn(dxi, poses, projection_distance: float = 0.05):
    """(2, N) single-integrator velocities -> (2, N) unicycle (v, omega)."""
    th = poses[2]
    c, s = torch.cos(th), torch.sin(th)
    v = c * dxi[0] + s * dxi[1]
    w = (-s * dxi[0] + c * dxi[1]) / projection_distance
    return torch.stack([v, w])
