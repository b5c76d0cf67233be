"""Rollout summaries and numerical-health checks (counterpart:
cbf_tpu/utils/debug.py).

:func:`summarize` turns a rollout's StepOutputs into the structured
record the CLI prints, read on the host. :func:`checked_rollout` (the JAX
package's checkify NaN/inf wrapper) is not ported yet: it raises
:class:`~cbf_tpu_torch.errors.OutOfSliceError`; the durability and
observability slice turns it into explicit ``torch.isfinite`` checks.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from cbf_tpu_torch.errors import SLICE_DURABLE, OutOfSliceError
from cbf_tpu_torch.rollout.engine import StepOutputs


def _host(v) -> np.ndarray:
    """A StepOutputs leaf (tensor on any device, or numpy) as numpy."""
    return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)


def checked_rollout(step_fn: Callable, state0, steps: int, *, errors=None):
    raise OutOfSliceError("checked_rollout (NaN/inf validation)",
                          SLICE_DURABLE)


def summarize(outs: StepOutputs) -> dict:
    """Host-side structured summary of a rollout's per-step metrics."""
    md = _host(outs.min_pairwise_distance)
    out = {
        "steps": int(md.shape[0]),
        "min_pairwise_distance": float(md.min()),
        "final_pairwise_distance": float(md[-1]),
        "filter_active_agent_steps": int(
            _host(outs.filter_active_count).sum()),
        "infeasible_agent_steps": int(_host(outs.infeasible_count).sum()),
        "max_relax_rounds": float(_host(outs.max_relax_rounds).max()),
    }
    # Optional diagnostics: () on scenarios that don't track them.
    if not isinstance(outs.gating_dropped_count, tuple):
        out["knn_dropped_neighbor_steps"] = int(
            _host(outs.gating_dropped_count).sum())
    if not isinstance(outs.saturation_deficit, tuple):
        out["max_saturation_deficit"] = float(
            _host(outs.saturation_deficit).max())
    if not isinstance(outs.gating_overflow_count, tuple):
        out["gating_overflow_agent_steps"] = int(
            _host(outs.gating_overflow_count).sum())
    if not isinstance(outs.certificate_residual, tuple):
        out["max_certificate_residual"] = float(
            _host(outs.certificate_residual).max())
    return out
