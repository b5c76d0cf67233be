"""RTA ladder fault injectors (counterpart: the ``poison_agent_at_step``
and ``teleport_clump_at_step`` step wrappers of cbf_tpu/utils/faults.py;
the rest of that module arrives with Queue A9).

Each wraps a swarm step and corrupts the real carried state at
``t == step_index``, so the step's health word sees a genuine fault. The
corruption is a select on ``t``: with a Python int ``t`` (the eager loop)
the wrapper picks on the host; with the compiled rollout's 0-dim device
``t`` it is a ``torch.where``, which the captured body replays. The
wrapper forwards the step's ``inputs``, ``relax_rounds`` and
``host_inputs``, so the compiled rollout drives it like the step itself.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch


def _forward(wrapped: Callable, step_fn: Callable) -> Callable:
    """Give ``wrapped`` the step's compiled-rollout attributes."""
    for name in ("relax_rounds", "host_inputs"):
        if hasattr(step_fn, name):
            setattr(wrapped, name, getattr(step_fn, name))
    return wrapped


def _select(hit, a, b):
    """``a`` where ``hit`` (a Python bool or a 0-dim bool tensor), else
    ``b``."""
    if isinstance(hit, bool):
        return a if hit else b
    return torch.where(hit, a, b)


def poison_agent_at_step(step_fn: Callable, step_index: int,
                         agent: int = 0) -> Callable:
    """NaN-poison one agent's position row at ``t == step_index`` — the
    rung-3 (lane scrub) fault: with ``Config.rta`` the entry scrub
    replaces the row with its last-known-good carry plus a stop command;
    without RTA the consensus centroid takes the whole swarm non-finite.
    ``step_index < 0`` never fires."""
    def wrapped(state, t, inputs=None):
        x = state.x
        row = torch.arange(x.shape[0], device=x.device) == agent
        poisoned = torch.where(row[:, None], torch.nan, x)
        x = _select(t == step_index, poisoned, x)
        return step_fn(state._replace(x=x), t, inputs=inputs)

    return _forward(wrapped, step_fn)


def teleport_clump_at_step(step_fn: Callable, step_index: int,
                           agents, spacing: float = 0.01,
                           center=(0.0, 0.0)) -> Callable:
    """Teleport ``agents`` into a sub-floor line clump (``spacing`` apart
    around ``center``) at ``t == step_index`` — the rung-1 (boosted
    re-solve) fault: the deep mutual violation drives the clumped agents'
    QPs past the relax cap or budget, and the boosted re-solve must
    restore feasibility and unpack the clump."""
    agents = list(agents)
    half = 0.5 * spacing * (len(agents) - 1)
    rows = [[center[0] - half + i * spacing, center[1]]
            for i in range(len(agents))]

    @functools.lru_cache(maxsize=None)
    def target(dtype, device):
        # Built once per (dtype, device), on the first (uncaptured) call:
        # a host-to-device copy would not survive graph capture.
        return (torch.tensor(agents, dtype=torch.int64, device=device),
                torch.tensor(rows, dtype=dtype, device=device))

    def wrapped(state, t, inputs=None):
        x = state.x
        idx, pos = target(x.dtype, x.device)
        x = _select(t == step_index, x.index_copy(0, idx, pos), x)
        return step_fn(state._replace(x=x), t, inputs=inputs)

    return _forward(wrapped, step_fn)
