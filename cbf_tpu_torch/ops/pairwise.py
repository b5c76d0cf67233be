"""Pairwise-distance ops (counterpart: cbf_tpu/ops/pairwise.py).

- :func:`pairwise_distances` — exact difference form, the one gating
  uses: the 0.4 m gating threshold needs ~1e-5 relative accuracy on d^2
  at swarm coordinates of ~13 m, which the expansion below cannot give.
- :func:`pairwise_sq_distances` — expansion |a|^2 + |b|^2 - 2 a.b through
  one matrix product; for coarse queries only (cancellation near zero).
  The product runs in full float32 on the card only while
  ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default,
  which ``chip_smoke.py`` also sets explicitly).
"""

from __future__ import annotations

import torch

from cbf_tpu_torch.utils.math import safe_sqrt


def pairwise_sq_distances(a, b=None):
    """Squared Euclidean distances. a (N, d), b (M, d) (default a) ->
    (N, M)."""
    if b is None:
        b = a
    aa = torch.sum(a * a, dim=1)
    bb = torch.sum(b * b, dim=1)
    d2 = aa[:, None] + bb[None, :] - 2.0 * (a @ b.T)
    return torch.clamp(d2, min=0.0)   # the cancellation tail


def pairwise_distances(a, b=None):
    """Exact Euclidean distances (difference form) with a NaN-free
    gradient at zero. a (N, d), b (M, d) -> (N, M)."""
    if b is None:
        b = a
    diff = a[:, None, :] - b[None, :, :]
    return safe_sqrt(torch.sum(diff * diff, dim=-1))
