"""Neighbor/danger gating (counterpart: cbf_tpu/rollout/gating.py).

- :func:`danger_slab` — every agent carries all M candidates plus a mask
  (exact reference semantics; masked QP rows are null).
- :func:`knn_gating` — the k nearest in-radius candidates. ``lax.top_k``
  puts the lower index first on ties and ``torch.topk`` promises no
  order, so the selection is a stable ascending sort of the keyed
  distances, which keeps the lower index first.
"""

from __future__ import annotations

import torch


def _distances(agent_states, candidate_states):
    diff = agent_states[:, None, :2] - candidate_states[None, :, :2]
    return torch.sqrt(torch.sum(diff * diff, dim=-1))          # (N, M)


def danger_slab(agent_states, candidate_states, radius,
                exclude_self_row=None):
    """All-candidate gating. agent_states (N, 4), candidate_states (M, 4),
    exclude_self_row (M,) bool marks rows subject to the ``distance > 0``
    self-exclusion. Returns (obs (N, M, 4), mask (N, M) bool)."""
    dist = _distances(agent_states, candidate_states)
    mask = dist < radius
    if exclude_self_row is not None:
        mask = mask & (~exclude_self_row[None, :] | (dist > 0))
    obs = candidate_states[None].expand(
        (agent_states.shape[0],) + tuple(candidate_states.shape))
    return obs, mask


def knn_gating(agent_states, candidate_states, radius, k: int,
               exclude_self_row=None, dist=None, with_dropped: bool = False):
    """Top-k nearest in-radius gating: (obs (N, k, 4), mask (N, k)) and,
    with ``with_dropped``, the (N,) int32 count of in-radius candidates
    that did not fit the k slots. ``k`` is clamped to the candidate count;
    ``dist`` may pass a precomputed (N, M) distance matrix."""
    if dist is None:
        dist = _distances(agent_states, candidate_states)
    k = min(k, candidate_states.shape[0])
    eligible = dist < radius
    if exclude_self_row is not None:
        eligible = eligible & (~exclude_self_row[None, :] | (dist > 0))
    keyed = torch.where(eligible, dist, torch.inf)
    near_d, idx = torch.sort(keyed, dim=1, stable=True)
    near_d, idx = near_d[:, :k], idx[:, :k]
    mask = torch.isfinite(near_d)
    obs = candidate_states[idx]                                 # (N, k, 4)
    if with_dropped:
        dropped = torch.clamp(
            torch.sum(eligible, dim=1, dtype=torch.int32) - k, min=0)
        return obs, mask, dropped
    return obs, mask
