"""Counterexample shrinking (counterpart: cbf_tpu/verify/shrink.py): from
"the search found a violation" to a minimal, trusted reproduction.

1. Horizon — the earliest violating step from the property's per-step
   margin series, plus a grace window; the shorter rollout is re-run to
   confirm.
2. Norm — bisection on the perturbation's scale toward the smallest
   multiple that still violates with real depth.
3. Precision — the minimized counterexample replayed in float64 (the
   adapter rebuilt with ``dtype=torch.float64``, the JAX package's x64
   context): a violation that vanishes there is a float32 artifact of the
   simulation, marked unconfirmed.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cbf_tpu_torch.rollout.engine import eager_rollout
from cbf_tpu_torch.verify import properties as props
from cbf_tpu_torch.verify.properties import PROPERTY_NAMES
from cbf_tpu_torch.verify.search import (Adapter, SearchSettings, json_scalar,
                                         make_adapter, make_eval_one,
                                         project_delta)


class ShrinkResult(NamedTuple):
    scenario: str
    delta: np.ndarray          # minimized perturbation (scale applied)
    scale: float               # final multiple of the input delta
    steps: int                 # shrunk horizon
    earliest_step: int | None  # first violating step (None: no series)
    property: str
    margin: float              # margin at (delta, steps), config dtype
    margin_x64: float          # float64 replay margin at (delta, steps)
    confirmed_x64: bool        # violation survives double precision
    evaluated: int             # rollouts spent shrinking


def enable_x64_ctx():
    """The JAX package's x64 switch has no counterpart: torch computes in
    float64 wherever the tensors are float64, and the replays rebuild the
    adapter with ``dtype=torch.float64``. A no-op context, kept for the
    shared surface."""
    return contextlib.nullcontext()


def _margins_at(adapter: Adapter, settings: SearchSettings, delta):
    """(P,) float64 margins of one candidate (one eager rollout)."""
    delta = torch.as_tensor(np.asarray(delta)).to(
        adapter.positions(adapter.state0).dtype)
    with torch.no_grad():
        m = make_eval_one(adapter, settings)(delta)
    return m.cpu().numpy().astype(np.float64)


def _record(adapter: Adapter, settings: SearchSettings, delta):
    """(final, outs) of one perturbed rollout, on the host."""
    dt_ = adapter.positions(adapter.state0).dtype
    d = project_delta(torch.as_tensor(np.asarray(delta), dtype=dt_).to(
        adapter.device), settings.perturb_norm)
    with torch.no_grad():
        final, outs = eager_rollout(adapter.step,
                                    adapter.perturb(adapter.state0, d),
                                    adapter.steps)
    return final, outs


def _rebuild(scenario, cfg, cbf, thresholds, steps, dtype=None,
             device=None) -> Adapter:
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return make_adapter(scenario, cfg, cbf=cbf, thresholds=thresholds,
                        steps=steps, device=device)


def measure_margin_x64(scenario: str, cfg, delta, *, cbf=None,
                       thresholds=None,
                       settings: SearchSettings = SearchSettings(),
                       property: str | None = None, steps=None,
                       device=None):
    """(property, margin, margin_x64) of one candidate: the near-miss twin
    of :func:`shrink` (a survivor has nothing to minimize, but its archived
    margin should not be a float32 artifact)."""
    adapter = make_adapter(scenario, cfg, cbf=cbf, thresholds=thresholds,
                           steps=steps, device=device)
    delta = np.asarray(delta)
    margins = _margins_at(adapter, settings, delta)
    pi = (int(np.argmin(margins)) if property is None
          else PROPERTY_NAMES.index(property))
    a64 = _rebuild(scenario, adapter.cfg, cbf, adapter.thresholds,
                   adapter.steps, dtype=torch.float64, device=device)
    m64 = _margins_at(a64, settings, delta.astype(np.float64))
    return PROPERTY_NAMES[pi], float(margins[pi]), float(m64[pi])


def shrink(scenario: str, cfg, delta, *, cbf=None, thresholds=None,
           settings: SearchSettings = SearchSettings(),
           property: str | None = None, bisect_iters: int = 12,
           telemetry=None, device=None) -> ShrinkResult:
    """Minimize one found counterexample (module docstring). ``property``
    pins which margin to shrink against (default: the most violated)."""
    adapter = make_adapter(scenario, cfg, cbf=cbf, thresholds=thresholds,
                           device=device)
    cfg = adapter.cfg
    th = adapter.thresholds
    delta = np.asarray(delta)
    evaluated = 0

    margins = _margins_at(adapter, settings, delta)
    evaluated += 1
    pi = (int(np.argmin(margins)) if property is None
          else PROPERTY_NAMES.index(property))
    prop = PROPERTY_NAMES[pi]
    if margins[pi] >= 0:
        raise ValueError(
            f"shrink needs a violating counterexample: property {prop!r} "
            f"has margin {margins[pi]:.6f} >= 0 at the full horizon")

    # 1. Horizon: earliest violating step from the margin series.
    earliest = None
    full_steps = steps = adapter.steps
    _final, outs = _record(adapter, settings, delta)
    evaluated += 1
    traj = adapter.traj_extract(outs)
    series = props.margin_series_np(th, outs, trajectory=traj,
                                    obstacle_fn_np=adapter.obstacle_fn_np,
                                    prop=prop)
    if series is not None and (series < 0).any():
        earliest = int(np.argmax(series < 0))
        steps = min(full_steps, earliest + 1 + max(2, earliest // 20))
        adapter = _rebuild(scenario, cfg, cbf, th, steps, device=device)
        m = _margins_at(adapter, settings, delta)
        evaluated += 1
        if m[pi] >= 0:
            # A series that disagrees with its rollout margin would be a
            # bug: fall back loudly to the full horizon.
            steps, earliest = full_steps, None
            adapter = _rebuild(scenario, cfg, cbf, th, full_steps,
                               device=device)

    # 2. Norm: bisect toward the violation boundary, then keep the
    # smallest tested scale with real violation depth.
    margin_full = float(_margins_at(adapter, settings, delta)[pi])
    evaluated += 1
    tol = max(1e-5, 0.25 * abs(min(margin_full, 0.0)))
    tested = [(1.0, margin_full)]
    m0 = _margins_at(adapter, settings, np.zeros_like(delta))
    evaluated += 1
    if m0[pi] <= -tol:
        tested.append((0.0, float(m0[pi])))
    else:
        lo, hi = 0.0, 1.0
        for _ in range(bisect_iters):
            mid = 0.5 * (lo + hi)
            m = _margins_at(adapter, settings, mid * delta)
            evaluated += 1
            tested.append((mid, float(m[pi])))
            if m[pi] < 0:
                hi = mid
            else:
                lo = mid
    deep = [s for s, m in tested if m <= -tol]
    scale = min(deep) if deep else 1.0
    delta_min = scale * delta
    margin = float(_margins_at(adapter, settings, delta_min)[pi])
    evaluated += 1

    # 3. Precision: replay the minimized counterexample in float64.
    a64 = _rebuild(scenario, cfg, cbf, th, steps, dtype=torch.float64,
                   device=device)
    m64 = _margins_at(a64, settings, delta_min.astype(np.float64))
    evaluated += 1
    margin_x64 = float(m64[pi])

    if telemetry is not None:
        telemetry.event("verify.round", {
            "engine": "shrink", "round": 0, "candidates": evaluated,
            "best_margin": json_scalar(margin_x64),
            "violations": int(margin_x64 < 0), "evaluated": evaluated})

    return ShrinkResult(
        scenario=scenario, delta=delta_min, scale=float(scale),
        steps=int(steps), earliest_step=earliest, property=prop,
        margin=margin, margin_x64=margin_x64,
        confirmed_x64=bool(margin_x64 < 0), evaluated=evaluated)
