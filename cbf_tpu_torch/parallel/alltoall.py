"""All-gather pairwise exchange: the Ulysses-style alternative to the ring
(counterpart: cbf_tpu/parallel/alltoall.py).

- **ring** (:mod:`cbf_tpu_torch.parallel.ring`): candidate blocks rotate
  rank to rank; O(N / n_sp) memory per rank, n_sp dependent hops.
- **all-gather** (this module): one ``all_gather`` of the compact
  (x, y, vx, vy) states, then each rank gates its local rows against the
  full candidate set — one collective instead of n_sp hops, while the
  (n_local, N) distance slab fits.

Both give the :func:`cbf_tpu_torch.rollout.gating.knn_gating` contract;
:func:`exchange_knn` picks between them by the slab's size, with the JAX
package's threshold, so both packages take the same branch at every
(N, sp).
"""

from __future__ import annotations

import torch

from cbf_tpu_torch.parallel.mesh import resolve_axis
from cbf_tpu_torch.parallel.ring import ring_knn
from cbf_tpu_torch.utils.math import safe_norm

# Above this per-rank DISTANCE-SLAB byte size — the (n_local, N) matrix
# all_gather_knn materialises — prefer the ring; below it, one all-gather
# beats n_sp dependent hops.
ALL_GATHER_MAX_SLAB_BYTES = 32 * 1024 * 1024


def all_gather_knn(states4_local, k: int, radius, axis_name,
                   return_distances: bool = False,
                   with_dropped: bool = False):
    """Top-k in-radius neighbours via one all-gather over ``axis_name``.

    Args/returns match :func:`cbf_tpu_torch.parallel.ring.ring_knn`
    exactly. Memory: every rank materialises the full (N, 4) candidate
    array and an (n_local, N) distance slab.
    """
    axis = resolve_axis(axis_name)
    n_local = states4_local.shape[0]
    all_states = axis.all_gather(states4_local)          # (N, 4), shard-major
    n_total = all_states.shape[0]

    diff = states4_local[:, None, :2] - all_states[None, :, :2]
    dist = safe_norm(diff)                               # (n_local, N)
    eligible = (dist < radius) & (dist > 0)
    keyed = torch.where(eligible, dist, torch.inf)
    k_eff = min(k, n_total)
    key, idx = torch.sort(keyed, dim=1, stable=True)
    best_d, idx = key[:, :k_eff], idx[:, :k_eff]
    obs = all_states[idx]                                # (n_local, k_eff, 4)
    if k_eff < k:                                        # pad to the k slots
        pad = k - k_eff
        best_d = torch.cat([best_d, torch.full(
            (n_local, pad), torch.inf, dtype=best_d.dtype,
            device=best_d.device)], dim=1)
        obs = torch.cat([obs, torch.zeros((n_local, pad, 4), dtype=obs.dtype,
                                          device=obs.device)], dim=1)
    mask = torch.isfinite(best_d)
    out = (obs, mask)
    if return_distances:
        out = out + (best_d,)
    if with_dropped:
        out = out + (torch.clamp(
            torch.sum(eligible, dim=1, dtype=torch.int32) - k, min=0),)
    return out


def exchange_knn(states4_local, k: int, radius, axis_name,
                 return_distances: bool = False, *,
                 with_dropped: bool = False, n_total: int | None = None):
    """Sharded k-NN gating, picking all-gather or ring by the slab's size.
    ``n_total``: global agent count (n_local * n_sp when None)."""
    axis = resolve_axis(axis_name)
    if n_total is None:
        n_total = states4_local.shape[0] * axis.size
    slab_bytes = (states4_local.shape[0] * n_total
                  * states4_local.element_size())
    if slab_bytes <= ALL_GATHER_MAX_SLAB_BYTES:
        return all_gather_knn(states4_local, k, radius, axis,
                              return_distances, with_dropped)
    return ring_knn(states4_local, k, radius, axis, return_distances,
                    with_dropped)
