"""Position controllers — the ``rps.utilities.controllers`` surface
(counterpart: cbf_tpu/sim/controllers.py).

- :func:`si_position_controller` — proportional single-integrator
  go-to-goal with a velocity-magnitude cap.
- :func:`unicycle_position_controller` — CLF-style unicycle go-to-goal:
  drive speed by the projected distance, steer by the bearing error.

Both map (state (., N), goals (2, N)) -> commands (2, N) in plain torch
ops, so they run inside a captured step.
"""

from __future__ import annotations

import torch

from cbf_tpu_torch.utils.math import safe_norm


def si_position_controller(x, goals, gain: float = 1.0,
                           magnitude_limit: float = 0.15):
    """Single-integrator P controller toward per-agent goals.

    x (2, N) positions; goals (2, N). Returns dxi (2, N), capped at
    ``magnitude_limit`` per agent (direction kept)."""
    dxi = gain * (goals - x)
    norms = safe_norm(dxi, dim=0)
    scale = torch.clamp(norms / magnitude_limit, min=1.0)
    return dxi / scale[None, :]


def unicycle_position_controller(poses, goals, linear_gain: float = 0.8,
                                 angular_gain: float = 3.0):
    """Unicycle go-to-goal: (3, N) poses, (2, N) goals -> (2, N) (v, omega).

    v tracks the goal distance projected on the heading (reverses when
    the goal is behind); omega steers down the wrapped bearing error."""
    dx = goals[0] - poses[0]
    dy = goals[1] - poses[1]
    theta = poses[2]
    dist = safe_norm(torch.stack([dx, dy]), dim=0)
    bearing = torch.atan2(dy, dx)
    err = torch.atan2(torch.sin(bearing - theta), torch.cos(bearing - theta))
    v = linear_gain * dist * torch.cos(err)
    # At the goal the bearing (atan2(0, 0)) is meaningless: command rest.
    w = torch.where(dist > 1e-6, angular_gain * err, torch.zeros_like(err))
    return torch.stack([v, w])


def at_position(x, goals, position_error: float = 0.02):
    """(N,) bool: which agents have reached their goals (rps
    ``at_position`` equivalent)."""
    return safe_norm(goals - x, dim=0) < position_error
