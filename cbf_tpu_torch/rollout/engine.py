"""Rollout engine (counterpart: cbf_tpu/rollout/engine.py).

A scenario is a pair ``(state0, step_fn)`` with
``step_fn(state, t) -> (state, StepOutputs)``. The JAX package runs time
as one compiled ``lax.scan``; PyTorch runs eagerly, so time is a Python
loop and the per-step outputs are stacked field by field afterwards.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from cbf_tpu_torch.errors import SLICE_DURABLE, OutOfSliceError


class StepOutputs(NamedTuple):
    """Per-step observability record emitted by every scenario step.
    Fields a scenario does not track are ``()``."""
    min_pairwise_distance: Any    # scalar — collision margin time series
    filter_active_count: Any      # scalar — agents whose CBF filter engaged
    infeasible_count: Any         # scalar — agents whose QP hit the relax cap
    max_relax_rounds: Any         # scalar — worst relaxation this step
    trajectory: Any               # optional (N, 2) position snapshot
    gating_overflow_count: Any = ()      # banded gating only
    gating_dropped_count: Any = ()       # in-radius neighbours beyond k
    certificate_residual: Any = ()
    certificate_dropped_count: Any = ()
    saturation_deficit: Any = ()
    certificate_iterations: Any = ()
    certificate_carry_resets: Any = ()
    rta_mode: Any = ()


def _stack_steps(outs: list) -> StepOutputs:
    """Per-field stack of a list of StepOutputs; ``()`` fields stay ``()``."""
    return StepOutputs(*(
        () if isinstance(first, tuple) else torch.stack(
            [getattr(o, name) for o in outs])
        for name, first in zip(StepOutputs._fields, outs[0])))


def rollout(step_fn: Callable, state0, steps: int):
    """Run ``steps`` iterations of ``step_fn`` from ``state0``. Returns
    (final_state, StepOutputs stacked over time, on the state's device)."""
    state, outs = state0, []
    for t in range(steps):
        state, out = step_fn(state, t)
        outs.append(out)
    return state, (_stack_steps(outs) if outs else None)


def rollout_chunked(step_fn: Callable, state0, steps: int, *,
                    chunk: int = 1000, checkpoint_dir: str | None = None,
                    telemetry=None, cost_model=None, durable_hook=None):
    """Run a long rollout in ``chunk``-step segments, moving each chunk's
    outputs to the host (numpy) as it completes, so a long record never
    has to fit device memory.

    Checkpointing, telemetry, the cost model and the durable hook are not
    ported yet and raise. Returns (final_state, StepOutputs stacked over
    the executed steps as numpy arrays, start_step)."""
    for name, value in (("checkpoint_dir", checkpoint_dir),
                        ("telemetry", telemetry), ("cost_model", cost_model),
                        ("durable_hook", durable_hook)):
        if value is not None:
            raise OutOfSliceError(f"rollout_chunked({name}=...)",
                                  SLICE_DURABLE)
    state, parts = state0, []
    for t0, n in plan_chunks(0, steps, chunk):
        outs = []
        for t in range(t0, t0 + n):
            state, out = step_fn(state, t)
            outs.append(out)
        parts.append(_to_host(_stack_steps(outs)))
    if not parts:
        return state, None, 0
    return state, stack_host_chunks(parts), 0


def _to_host(outs: StepOutputs) -> StepOutputs:
    return StepOutputs(*(() if isinstance(v, tuple) else v.cpu().numpy()
                         for v in outs))


def plan_chunks(start: int, steps: int, chunk: int) -> list[tuple[int, int]]:
    """``(t0, n)`` spans covering ``[start, steps)`` in ``chunk``-step
    segments, the last one trimmed to the remaining steps."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return [(t0, min(chunk, steps - t0))
            for t0 in range(start, steps, chunk)]


def stack_host_chunks(parts):
    """Concatenate per-chunk host (numpy) StepOutputs along time; ``()``
    fields stay ``()``."""
    return type(parts[0])(*(
        () if isinstance(first, tuple)
        else np.concatenate([getattr(p, name) for p in parts], axis=0)
        for name, first in zip(parts[0]._fields, parts[0])))


def min_pairwise_distance(positions):
    """Min inter-point distance of a (2, N) position set (column layout,
    as in the JAX package's sim layer)."""
    P = positions.T                                  # (N, 2)
    diff = P[:, None, :] - P[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    n = P.shape[0]
    d2 = d2 + torch.eye(n, dtype=d2.dtype, device=d2.device) * 1e9
    return torch.sqrt(torch.amin(d2))
