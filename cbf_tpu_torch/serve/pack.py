"""Request packing: padded initial states, batch stacking, result trims
(counterpart: cbf_tpu/serve/pack.py).

Padding contract: a request of n agents in an n_bucket-sized bucket gets
its REAL agents from the scenario's own spawn (the seed law of the
unpadded run) and its ``n_bucket - n`` PAD agents parked on a far-away
grid. The traced step's ``n_active`` mask takes the pads out of the
consensus and the nominal (:func:`swarm.make_step_traced`); every other
exclusion follows from distance — a pad a megameter away is never inside
the gating radius or the certificate's binding radius, never the swarm's
nearest pair (the parking spacing is ~1 km), and its zero command keeps it
parked, so no StepOutputs metric sees it.

The stacked tensors go to the card unless the caller asks for the CPU
(``device="cpu"``), as every entry point of the port does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.serve.buckets import BucketKey

# Parking grid: exactly representable float32 values, spacing far above
# any real inter-agent scale, offset far outside any real arena. One row
# of pads along +x at y = PARK_OFFSET.
PARK_OFFSET = float(2 ** 20)     # ~1.05e6 m
PARK_SPACING = float(2 ** 10)    # 1024 m between pads


def _np_dtype(dtype):
    """A numpy dtype from a torch or numpy one."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _tree(fn, *trees):
    """``fn`` over the leaves of matching (named) tuples; ``()`` stays
    ``()``."""
    first = trees[0]
    if isinstance(first, tuple):
        vals = [_tree(fn, *parts) for parts in zip(*trees)]
        return type(first)(*vals) if hasattr(first, "_fields") \
            else tuple(vals)
    return fn(*trees)


def parking_rows(count: int, dtype) -> np.ndarray:
    """(count, 2) pad positions on the parking grid (``dtype``: torch or
    numpy)."""
    i = np.arange(count, dtype=np.float64)
    return np.stack([PARK_OFFSET + PARK_SPACING * i,
                     np.full(count, PARK_OFFSET)],
                    axis=1).astype(_np_dtype(dtype))


def padded_initial_state(cfg: swarm.Config, key: BucketKey, *,
                         device=None) -> swarm.State:
    """One request's initial State at BUCKET shapes on ``device``: real
    agents from the scenario's spawn (:func:`swarm.spawn_positions`,
    :func:`swarm.clear_obstacle_spawn`, :func:`swarm.heading_spawn` — the
    unpadded run's laws), pads parked, the structural carries (Verlet
    caches, ADMM warm carry, RTA) seeded at bucket size from the seeds
    :func:`swarm.initial_state` uses."""
    from cbf_tpu_torch.rta.core import rta_seed
    from cbf_tpu_torch.sim.certificates import (certificate_cache_seed,
                                                certificate_solver_seed)

    dev = swarm.resolve_device(device)
    bcfg = key.static_cfg
    if cfg.n > bcfg.n:
        raise ValueError(f"request n={cfg.n} exceeds bucket n={bcfg.n}")
    n_pad = bcfg.n - cfg.n
    x_real = swarm.clear_obstacle_spawn(
        cfg, swarm.spawn_positions(cfg, cfg.seed, device=dev))
    x0 = torch.cat([x_real, torch.as_tensor(
        parking_rows(n_pad, cfg.dtype), device=dev)], dim=0)
    theta0 = ()
    if cfg.dynamics == "unicycle":
        theta0 = torch.cat([swarm.heading_spawn(cfg, cfg.seed, device=dev),
                            torch.zeros((n_pad,), dtype=cfg.dtype,
                                        device=dev)])
    cache = (swarm.verlet_cache_seed(bcfg, device=dev)
             if cfg.gating_rebuild_skin else ())
    ccache = (certificate_cache_seed(bcfg.n, cfg.certificate_k, cfg.dtype,
                                     device=dev)
              if cfg.certificate_rebuild_skin else ())
    sstate = (certificate_solver_seed(bcfg.n, cfg.certificate_k, cfg.dtype,
                                      device=dev)
              if cfg.certificate_warm_start else ())
    rta = rta_seed(x0, torch.zeros_like(x0), theta0) if cfg.rta else ()
    return swarm.State(x=x0, v=torch.zeros_like(x0), theta=theta0,
                       gating_cache=cache, certificate_cache=ccache,
                       certificate_solver_state=sstate, rta=rta)


def _stack_states(states) -> swarm.State:
    return _tree(lambda *xs: torch.stack(xs), *states)


def stack_batch(key: BucketKey, requests, traced_list, max_batch: int, *,
                device=None):
    """(states, traced, steps) for one micro-batch, on ``device``.

    ``requests``: the real request configs (1..max_batch of them);
    ``traced_list``: their traced dicts from :func:`buckets.bucket_key`.
    The batch axis is PADDED to ``max_batch`` so every flush of a bucket
    — full or deadline-forced — reuses ONE captured program: pad slots
    clone the first request's state with ``steps = 0``, so the horizon
    mask freezes them at t=0 and their outputs are discarded. The traced
    values are (B,) tensors in the bucket's dtype (``n_active`` int32),
    ``steps`` (B,) int32."""
    if not 1 <= len(requests) <= max_batch:
        raise ValueError(f"batch of {len(requests)} requests does not fit "
                         f"max_batch={max_batch}")
    dev = swarm.resolve_device(device)
    states = [padded_initial_state(cfg, key, device=dev) for cfg in requests]
    traced = list(traced_list)
    steps = [cfg.steps for cfg in requests]
    while len(states) < max_batch:
        states.append(states[0])
        traced.append(traced[0])
        steps.append(0)
    dtype = key.static_cfg.dtype
    stacked_traced = {
        k: torch.tensor([t[k] for t in traced],
                        dtype=torch.int32 if k == "n_active" else dtype,
                        device=dev)
        for k in traced[0]}
    return (_stack_states(states), stacked_traced,
            torch.tensor(steps, dtype=torch.int32, device=dev))


def dummy_batch(key: BucketKey, max_batch: int, *, device=None):
    """Prewarm inputs: a full batch of the bucket's own static config
    (whose defaults are a valid request) — the shapes of any real
    batch."""
    cfg = dataclasses.replace(key.static_cfg, steps=key.horizon)
    _, traced = swarm.split_static_traced(cfg)
    return stack_batch(key, [cfg] * max_batch, [traced] * max_batch,
                       max_batch, device=device)


def seed_lane_table(key: BucketKey, cfg: swarm.Config, max_batch: int, *,
                    device=None):
    """Stacked states of a fresh continuous-batching lane table: the first
    joining request's padded initial state cloned into all ``max_batch``
    lanes. The clones beyond the joiner's slot are VACANT — the chunk
    program gets them with ``steps = 0``, so the horizon mask freezes them
    at their local t=0; a later join overwrites a vacant slot
    (:func:`join_lane`)."""
    state = padded_initial_state(cfg, key, device=device)
    return _tree(lambda a: torch.stack([a] * max_batch), state)


def join_lane(states, slot: int, state):
    """One request's padded initial state scattered into lane ``slot`` of
    the table's stacked states (a chunk-boundary JOIN). Functional: new
    tensors, the previous table left as it was (the chunk program does
    not donate, so a failed chunk can retry from the same carry)."""
    def put(table, s):
        out = table.clone()
        out[slot] = s
        return out

    return _tree(put, states, state)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def slice_lane_chunk(outs_host, slot: int, done: int):
    """One lane's live rows of a chunk's outputs on the host: time axes cut
    to ``done`` (the steps the lane ran this chunk — later rows are frozen
    repeats), the batch axis indexed away, as numpy arrays. The serve
    engine passes the chunk's outputs already on the host (one copy per
    chunk); given device tensors, only the lane's rows are copied."""
    return _tree(lambda a: _host(a[slot][:done]), outs_host)


def _trimmed_final(final_states, slot: int, n_active: int) -> swarm.State:
    # The slot is indexed before the copy: from device tensors, one
    # lane's rows cross to the host, not the whole table's.
    final_b = _tree(lambda a: _host(a[slot]), final_states)
    theta = (final_b.theta[:n_active]
             if not isinstance(final_b.theta, tuple) else ())
    return swarm.State(x=final_b.x[:n_active], v=final_b.v[:n_active],
                       theta=theta)


def assemble_lane_result(final_states, parts, slot: int, n_active: int):
    """One lane's (final_state, outputs) at request shapes: the per-chunk
    host slices concatenated along time
    (:func:`cbf_tpu_torch.rollout.engine.stack_host_chunks`), the
    trajectory's agent axis and the final state's rows trimmed to
    ``n_active`` (structural carries are internal and dropped). The
    chunked twin of :func:`trim_result`."""
    from cbf_tpu_torch.rollout.engine import stack_host_chunks

    outs_b = stack_host_chunks(parts, axis=0)
    if not isinstance(outs_b.trajectory, tuple):
        outs_b = outs_b._replace(
            trajectory=outs_b.trajectory[:, :n_active])
    return _trimmed_final(final_states, slot, n_active), outs_b


def trim_result(final_states, outs, slot: int, n_active: int, steps: int):
    """One request's (final_state, outputs) from the batch, on the host,
    trimmed to its true agent count and horizon: StepOutputs time axes cut
    to ``steps`` (later rows are frozen repeats), the trajectory's agent
    axis and the final state's rows cut to ``n_active`` (structural
    carries are internal and dropped)."""
    outs_b = _tree(lambda a: _host(a)[slot][:steps], outs)
    if not isinstance(outs_b.trajectory, tuple):
        outs_b = outs_b._replace(
            trajectory=outs_b.trajectory[:, :n_active])
    return _trimmed_final(final_states, slot, n_active), outs_b
