"""Ring pairwise exchange: agent-sharded neighbour search by point-to-point
hops (counterpart: cbf_tpu/parallel/ring.py).

When one swarm's agents are sharded over the mesh axis ``sp``, no rank
holds all positions without an all-gather; instead — the ring-attention
pattern — each rank keeps its block of agents and the candidate blocks
rotate around the ring (``Axis.ppermute``, ``batch_isend_irecv`` to rank
(j + 1) % n). After ``n`` hops every agent has seen every candidate,
keeping a running top-k of its nearest in-radius neighbours in
O(N / n) memory per rank.

Rank i sees block (i - h) % n at hop h, the JAX ring's order, and the
merge is the stable ascending sort of ``rollout.gating`` (the lower index
first on ties, as ``lax.top_k``), so the kept sets match JAX's.
"""

from __future__ import annotations

import torch

from cbf_tpu_torch.parallel.mesh import resolve_axis
from cbf_tpu_torch.utils.math import safe_norm


def ring_knn(states4_local, k: int, radius, axis_name,
             return_distances: bool = False, with_dropped: bool = False):
    """Top-k in-radius neighbours of each local agent over ALL shards.

    Args:
      states4_local: (n_local, 4) this rank's agent states (x, y, vx, vy).
      k: neighbour slots per agent.
      radius: gating radius; coincident points (distance exactly 0 — self)
        are excluded, the reference's ``distance > 0`` rule.
      axis_name: the mesh :class:`~cbf_tpu_torch.parallel.mesh.Axis` to
        ring over (or its name on the last mesh built).
      return_distances: also return the sorted (n_local, k) neighbour
        distances (inf where masked).
      with_dropped: also return the (n_local,) int32 count of in-radius
        candidates beyond the k slots.

    Returns (obs (n_local, k, 4), mask (n_local, k) bool)[, distances]
    [, dropped], the :func:`cbf_tpu_torch.rollout.gating.knn_gating`
    contract.
    """
    axis = resolve_axis(axis_name)
    n_shards = axis.size
    n_local = states4_local.shape[0]
    dtype, dev = states4_local.dtype, states4_local.device
    perm = [(j, (j + 1) % n_shards) for j in range(n_shards)]

    best_d = torch.full((n_local, k), torch.inf, dtype=dtype, device=dev)
    best_s = torch.zeros((n_local, k, 4), dtype=dtype, device=dev)
    count = torch.zeros((n_local,), dtype=torch.int32, device=dev)
    block = states4_local
    for _ in range(n_shards):
        diff = states4_local[:, None, :2] - block[None, :, :2]
        dist = safe_norm(diff)                                 # (n_local, m)
        eligible = (dist < radius) & (dist > 0)
        count = count + torch.sum(eligible, dim=1, dtype=torch.int32)
        keyed = torch.where(eligible, dist, torch.inf)
        cat_d = torch.cat([best_d, keyed], dim=1)              # (n_local, k+m)
        cat_s = torch.cat(
            [best_s, block[None].expand((n_local,) + tuple(block.shape))],
            dim=1)                                             # (n_local, k+m, 4)
        key, idx = torch.sort(cat_d, dim=1, stable=True)
        best_d, idx = key[:, :k], idx[:, :k]
        best_s = torch.take_along_dim(cat_s, idx[:, :, None], dim=1)
        block = axis.ppermute(block, perm)
    mask = torch.isfinite(best_d)
    out = (best_s, mask)
    if return_distances:
        out = out + (best_d,)
    if with_dropped:
        out = out + (torch.clamp(count - k, min=0),)
    return out
