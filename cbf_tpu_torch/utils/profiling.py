"""Named phase spans (counterpart: cbf_tpu/utils/profiling.py:33-36).

The swarm step wraps its phases — consensus, gating, filter, integrate —
in :func:`annotate`, so a ``torch.profiler`` trace attributes host and
device time to the same vocabulary the JAX package's ``--xla-trace``
uses."""

from __future__ import annotations

import torch


def annotate(name: str):
    """Named span context; shows up as a ``record_function`` range in a
    ``torch.profiler`` trace and costs a few microseconds when no profiler
    is running."""
    return torch.profiler.record_function(name)
