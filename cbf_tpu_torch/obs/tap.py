"""Telemetry tap: sampled heartbeats from the compiled rollout
(counterpart: cbf_tpu/obs/tap.py).

The JAX tap ships each sampled step's scalars to the host from inside the
running scan (``io_callback`` under ``lax.cond``). A captured CUDA graph
cannot call the host, so here the tap is a step wrapper that adds one
value per step to the step's outputs — ``nonfinite_state_count``, the
non-finite elements across the float leaves of the post-step state,
computed inside the captured body — and the engine emits the heartbeats
of every global step ``t % every == 0`` from each chunk's outputs
(:func:`chunk_heartbeats`). The sampled rows start
their copy to the host when the chunk ends and are emitted while the next
chunk runs (after the last chunk, at the end), so a heartbeat arrives one
chunk after its step without holding the card idle; its values are the
very values the rollout returns as ``StepOutputs[t]``.
``rollout(telemetry=)`` runs ``every``-step chunks; ``rollout_chunked``
emits per ``chunk``. The ensemble path emits from its per-chunk host
offload (:func:`emit_ensemble_chunk`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cbf_tpu_torch.obs import schema
from cbf_tpu_torch.obs.sink import TelemetrySink
from cbf_tpu_torch.rollout.engine import (Extra, _leaves,
                                          forward_attributes, strip_extra)


def instrument_step(step_fn: Callable, sink: TelemetrySink, *,
                    every: int = 50) -> Callable:
    """Wrap ``step_fn`` so the engine emits a heartbeat into ``sink`` for
    every global step ``t % every == 0`` (module docstring). Its outputs
    are ``Extra(outputs, nonfinite_state_count)``; the engine returns
    ``outputs`` alone. Wrappers are cached on the sink per (step_fn,
    every), so a repeat rollout replays the programs cached on the
    wrapper."""
    if every < 1:
        raise ValueError(f"telemetry every must be >= 1, got {every}")
    key = (step_fn, every)
    cached = sink._tap_cache.get(key)
    if cached is not None:
        return cached

    def wrapped(state, t, inputs=None):
        state, out = (step_fn(state, t) if inputs is None
                      else step_fn(state, t, inputs=inputs))
        leaves = [v for v in _leaves(state) if v.is_floating_point()]
        if len({v.shape[1:] for v in leaves}) > 1:
            leaves = [v.reshape(-1) for v in leaves]
        # Leaves of one row shape are joined as they lie (a strided one
        # is not copied first). x * 0 is 0 for a finite x and NaN
        # otherwise, and the 0-norm counts the nonzero elements in one
        # reduction (exact while fewer than 2**24 are non-finite): three
        # kernels per step with the join, where isfinite alone issues
        # four.
        flat = torch.cat(leaves) if len(leaves) > 1 else leaves[0]
        count = torch.linalg.vector_norm(flat.mul(0), ord=0)
        return state, Extra(out, count)

    forward_attributes(wrapped, step_fn)
    wrapped.tap_sink, wrapped.tap_every = sink, every
    sink._tap_cache[key] = wrapped
    return wrapped


def chunk_heartbeats(tap: Callable, t0: int, outs) -> Callable[[], int]:
    """Start reading the sampled rows of one chunk (starting at global
    step ``t0``; ``outs`` the tap's chunk outputs, device tensors or
    numpy) and return the call that emits their heartbeats, returning how
    many. On the card the rows are copied into pinned host memory on the
    stream, so the call waits only for those copies."""
    every = tap.tap_every
    first = (-t0) % every
    fields = []
    for f in schema.HEARTBEAT_FIELDS:
        v = outs.extra if f.step_output is None else getattr(
            strip_extra(outs.outputs), f.step_output)
        if not isinstance(v, tuple) and len(v.shape) == 1:
            fields.append((f.name, v[first::every]))
    event = None
    if isinstance(outs.extra, torch.Tensor):
        if outs.extra.device.type == "cuda":
            rows = [(name, torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=True).copy_(
                v, non_blocking=True)) for name, v in fields]
            event = torch.cuda.Event()
            event.record()
        else:
            rows = [(name, v.clone()) for name, v in fields]
    else:
        rows = [(name, np.array(v)) for name, v in fields]
    sink = tap.tap_sink

    def emit() -> int:
        if event is not None:
            event.synchronize()
        table = [(name, np.asarray(v).astype(np.float64)) for name, v in rows]
        count = len(table[0][1]) if table else 0
        for j in range(count):
            sink.heartbeat(t0 + first + j * every,
                           {name: float(v[j]) for name, v in table})
        return count

    return emit


def emit_ensemble_chunk(sink: TelemetrySink, metrics, t_start: int, *,
                        every: int = 50) -> int:
    """Host-side heartbeats for the ensemble path: fold one offloaded
    metrics chunk (member-major (E, steps) EnsembleMetrics leaves, numpy)
    into the ``t % every == 0`` heartbeats, each channel reduced across
    members by its declared reduction. Returns the number emitted."""
    if every < 1:
        raise ValueError(f"telemetry every must be >= 1, got {every}")
    fields = []
    for f in schema.HEARTBEAT_FIELDS:
        if f.ensemble is None:
            continue
        leaf = getattr(metrics, f.ensemble, ())
        if isinstance(leaf, tuple):
            continue
        fields.append((f, np.asarray(leaf)))
    if not fields:
        return 0
    members, n_steps = fields[0][1].shape[:2]
    emitted = 0
    for j in range((-t_start) % every, n_steps, every):
        values = {f.name: schema.reduce_members(f, arr[:, j].tolist())
                  for f, arr in fields}
        sink.heartbeat(t_start + j, values, ensemble_members=members)
        emitted += 1
    return emitted
