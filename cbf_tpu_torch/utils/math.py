"""Numerics helpers (counterpart: cbf_tpu/utils/math.py:8-30).

``match_vma`` and ``axis_size`` are JAX sharding helpers with no meaning
here and are not ported."""

from __future__ import annotations

import torch


def safe_sqrt(x):
    """sqrt with a NaN-free gradient at x == 0: evaluate at a guarded
    argument and re-select, so a masked-out zero entry never forms
    0 * inf in the backward pass."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, 1.0)),
                       0.0)


def safe_norm(x, dim=-1, keepdim=False):
    """L2 norm along ``dim`` with a NaN-free gradient at 0."""
    return safe_sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def l2_cap(x, limit, dim=-1):
    """Rescale ``x`` so its L2 norm along ``dim`` is at most ``limit``
    (identity below the limit). The epsilon guard keeps the zero vector a
    fixed point instead of 0/0."""
    mag = safe_norm(x, dim=dim, keepdim=True)
    return x * torch.clamp(limit / torch.clamp(mag, min=1e-9), max=1.0)
