"""Shape-bucketed request signatures for the serving layer (counterpart:
cbf_tpu/serve/buckets.py).

A rollout request's compiled program is fixed by its STATIC signature:
agent count (padded up to a bucket size), horizon (padded up to a
quantum), dynamics family, certificate backend and budgets, gating kernel,
dtype — everything :func:`swarm.split_static_traced` leaves in the static
config. Two requests with equal signatures differ only in data (seed),
traced scalars (radius, gains, dt, ...) and their horizon mask, so they
share one captured program
(:func:`cbf_tpu_torch.parallel.ensemble.lockstep_traced_rollout`). This
module computes the signature; :mod:`cbf_tpu_torch.serve.pack` makes the
padded member tensors that ride it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

from cbf_tpu_torch.scenarios import swarm

# Power-of-two agent-count ladder: few buckets (few programs to capture)
# at a bounded <= 2x padding overhead per request.
DEFAULT_BUCKET_SIZES: tuple[int, ...] = (
    16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)

# Horizons round up to this quantum: per-request step counts ride as a
# horizon MASK inside the bucket program, so the quantum bounds both the
# number of distinct horizons and the frozen-tail overhead.
DEFAULT_HORIZON_QUANTUM = 64

# Certificate buckets: the arena half-width enlarged to contain the
# packer's far-away parking lot (serve.pack) — a pad outside the arena box
# would carry a permanently violated boundary row into the joint QP. Real
# agents never bind the boundary rows either way, so enlarging only
# slackens already-slack rows. 2^24 m: exactly representable, beyond the
# largest bucket's parking extent.
PARKING_ARENA_HALF = float(2 ** 24)


class BucketKey(NamedTuple):
    """Hashable bucket identity: the bucket-static config (n = bucket
    size, traced fields at their defaults) and the padded horizon."""
    static_cfg: swarm.Config
    horizon: int

    @property
    def n(self) -> int:
        return self.static_cfg.n

    def label(self) -> str:
        """Short stable tag for counters and docs (the JAX package's):
        the scenario-platform axes append suffixes only when not at their
        defaults."""
        c = self.static_cfg
        cert = swarm.certificate_backend(c) if c.certificate else "off"
        lab = (f"n{c.n}-t{self.horizon}-{c.dynamics}"
               f"-cert_{cert}-g{c.gating}")
        if c.dynamics == "mixed":
            lab += f"-nd{c.n_double}"
        if c.spawn != "grid":
            lab += f"-sp_{c.spawn}"
        if c.goal != "rendezvous":
            lab += f"-gl_{c.goal}"
        if c.obstacle_layout != "orbit":
            lab += f"-ob_{c.obstacle_layout}"
        return lab


def chunk_label(static_cfg: swarm.Config, chunk: int) -> str:
    """Label of a CHUNK program (continuous batching): one per (static
    config, chunk length) for every horizon of that config; ``-k{chunk}-``
    in place of the drain labels' ``-t{horizon}-``."""
    return BucketKey(static_cfg, chunk).label().replace(
        f"-t{chunk}-", f"-k{chunk}-", 1)


def bucket_n(n: int, sizes: tuple[int, ...] = DEFAULT_BUCKET_SIZES) -> int:
    """Smallest registered bucket size >= n."""
    for s in sorted(sizes):
        if s >= n:
            return s
    raise ValueError(
        f"n={n} exceeds the largest bucket size {sizes[-1]} — extend "
        "bucket_sizes (every size costs one program per horizon)")


def bucket_horizon(steps: int,
                   quantum: int = DEFAULT_HORIZON_QUANTUM) -> int:
    """``steps`` rounded up to the horizon quantum (>= one quantum)."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    return max(quantum, quantum * math.ceil(steps / quantum))


def bucket_key(cfg: swarm.Config, *,
               sizes: tuple[int, ...] = DEFAULT_BUCKET_SIZES,
               horizon_quantum: int = DEFAULT_HORIZON_QUANTUM):
    """(BucketKey, traced) for one request config.

    Validates the request (:func:`swarm.split_static_traced`), splits off
    the traced scalars, pads n up to the bucket and steps up to the
    horizon quantum. Two compensations keep the padded program the
    unpadded physics:

    - ``pack_spacing`` is rescaled by sqrt(n_true / n_bucket): the step
      derives the packing radius as ``pack_spacing * sqrt(cfg.n)`` with the
      BUCKET n, so the traced spacing absorbs the ratio and the request's
      own packing radius is kept;
    - certificate buckets force ``arena_half_override`` to
      :data:`PARKING_ARENA_HALF`; a request with its own override is
      rejected — it could not contain the parking lot.
    """
    static_cfg, traced = swarm.split_static_traced(cfg)
    nb = bucket_n(cfg.n, sizes)
    traced = dict(traced)
    traced["pack_spacing"] = (
        traced["pack_spacing"] * math.sqrt(cfg.n / nb))
    updates: dict = {"n": nb}
    if cfg.certificate:
        if cfg.arena_half_override is not None:
            raise ValueError(
                "serve: certificate requests cannot carry their own "
                "arena_half_override — the bucket forces the parking-"
                "containing arena (buckets.PARKING_ARENA_HALF)")
        updates["arena_half_override"] = PARKING_ARENA_HALF
    static_cfg = dataclasses.replace(static_cfg, **updates)
    return (BucketKey(static_cfg, bucket_horizon(cfg.steps,
                                                 horizon_quantum)),
            traced)
