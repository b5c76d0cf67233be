"""Rollout summaries and numerical-health checks (counterpart:
cbf_tpu/utils/debug.py).

:func:`checked_rollout` is the counterpart of the JAX package's checkify
NaN/inf wrapper: explicit ``torch.isfinite`` checks, inside the compiled
rollout's captured body, on every float leaf of each step's post-step
state and outputs; the first step with a non-finite value raises
:class:`NonFiniteError` naming the step and the field. :func:`summarize`
turns a rollout's StepOutputs into the structured record the CLI prints,
read on the host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cbf_tpu_torch.durable.integrity import tree_items
from cbf_tpu_torch.rollout import engine
from cbf_tpu_torch.rollout.engine import Extra, StepOutputs


def _host(v) -> np.ndarray:
    """A StepOutputs leaf (tensor on any device, or numpy) as numpy."""
    return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)


class NonFiniteError(FloatingPointError):
    """A checked rollout met a NaN or an infinity: ``step`` (the step whose
    post-step state or outputs hold it; 0 for the initial state),
    ``field`` (``state.<leaf key>`` or ``outputs.<field>``) and ``kind``
    ("nan" or "inf")."""

    def __init__(self, step: int, field: str, kind: str, where: str):
        super().__init__(f"checked_rollout: {kind} in {field} {where}")
        self.step, self.field, self.kind = step, field, kind


def _float_items(prefix: str, tree) -> list[tuple[str, torch.Tensor]]:
    return [(f"{prefix}.{key}", v) for key, v in tree_items(tree)
            if isinstance(v, torch.Tensor) and v.is_floating_point()]


def _flags(items) -> torch.Tensor:
    """(fields, 2) bool: any non-finite, any NaN — per field."""
    return torch.stack([torch.stack([~torch.isfinite(v).all(),
                                     torch.isnan(v).any()])
                        for _, v in items])


def _checking(step_fn: Callable):
    """Wrap ``step_fn`` so each step's outputs carry the flags of its
    post-step state's and its outputs' float fields; the names ride on
    the wrapper."""
    def wrapped(state, t, inputs=None):
        state, out = (step_fn(state, t) if inputs is None
                      else step_fn(state, t, inputs=inputs))
        items = (_float_items("state", state)
                 + _float_items("outputs", engine.strip_extra(out)))
        wrapped.fields = [name for name, _ in items]
        return state, Extra(out, _flags(items))

    return engine.forward_attributes(wrapped, step_fn)


def checked_rollout(step_fn: Callable, state0, steps: int, *, errors=None,
                    telemetry=None, telemetry_every: int = 50):
    """Run the compiled ``rollout`` with a finiteness check of every float
    leaf of each step's state and outputs; raise :class:`NonFiniteError`
    at the first step and field holding a NaN (or an infinity), naming
    them. ``errors``: the kinds that raise — ``{"nan", "inf"}`` (None, the
    default) or ``{"nan"}``. ``telemetry``/``telemetry_every`` stream
    heartbeats as :func:`~cbf_tpu_torch.rollout.engine.rollout` does
    (``run --checked --telemetry-dir``). Returns (final_state,
    StepOutputs)."""
    kinds = {"nan", "inf"} if errors is None else set(errors)
    if not kinds or kinds - {"nan", "inf"}:
        raise ValueError(f"errors must be a subset of {{'nan', 'inf'}}, "
                         f"got {errors!r}")
    init = _float_items("state", state0)
    if init:
        bad = _flags(init).cpu().numpy()
        for (name, _), (nonfinite, nan) in zip(init, bad):
            kind = "nan" if nan else "inf"
            if nonfinite and kind in kinds:
                raise NonFiniteError(0, name, kind,
                                     "of the initial state (entering "
                                     "step 0)")
    checked = _checking(step_fn)
    final, outs = engine.rollout_extra(checked, state0, steps,
                                       telemetry=telemetry,
                                       telemetry_every=telemetry_every)
    if outs is None:
        return final, None
    flags = outs.extra.cpu().numpy()               # (steps, fields, 2)
    nan, inf = flags[..., 1], flags[..., 0] & ~flags[..., 1]
    hit = (nan & ("nan" in kinds)) | (inf & ("inf" in kinds))
    if hit.any():
        t, i = np.argwhere(hit)[0]
        raise NonFiniteError(int(t), checked.fields[i],
                             "nan" if nan[t, i] else "inf",
                             f"after step {int(t)}")
    return final, engine.strip_extra(outs.outputs)


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
