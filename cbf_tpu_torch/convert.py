"""Carry state and parameters across from the JAX package.

The system has no weights; what crosses is the swarm state, the filter
parameters and the configuration, as numpy arrays and plain values (this
module imports neither jax nor ``cbf_tpu``). With them both packages run
from the identical initial swarm — the two packages draw their spawn
jitter from different random streams.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cbf_tpu_torch.core.filter import CBFParams
from cbf_tpu_torch.scenarios.swarm import Config, State


def _leaf(a, *, device, dtype):
    """One state leaf across: float arrays in ``dtype``, integer arrays
    (cache indices and counts, RTA mode and streak) as int32, nested
    tuples leaf by leaf, ``()`` as ``()``."""
    if isinstance(a, tuple):
        return tuple(_leaf(b, device=device, dtype=dtype) for b in a)
    a = np.array(a)
    kind = torch.int32 if a.dtype.kind in "iu" else dtype
    return torch.as_tensor(a, dtype=kind, device=device)


def state_from_numpy(x, v, *, device, dtype) -> State:
    """State from (N, 2) positions and velocities (numpy or array-like)."""
    return State(x=_leaf(x, device=device, dtype=dtype),
                 v=_leaf(v, device=device, dtype=dtype))


def state_from_reference(state, *, device, dtype) -> State:
    """Every leaf of a JAX ``State`` (or any object with its fields):
    positions and velocities, the unicycle headings, the Verlet cache, the
    certificate's Verlet cache and warm ADMM carry, and the RTA carry,
    ``()`` where the configuration has none."""
    return State(*(_leaf(getattr(state, name, ()), device=device,
                         dtype=dtype) for name in State._fields))


def cbf_params_from_numpy(params, *, device=None, dtype=None) -> CBFParams:
    """CBFParams from any object with max_speed/dmin/k/gamma fields (a JAX
    ``CBFParams`` or a mapping). Scalar leaves become Python floats;
    array leaves become tensors on ``device`` in ``dtype``."""
    get = (params.__getitem__ if isinstance(params, dict)
           else lambda name: getattr(params, name))
    leaves = {}
    for name in CBFParams._fields:
        a = np.array(get(name))
        leaves[name] = (float(a) if a.ndim == 0
                        else torch.as_tensor(a, dtype=dtype, device=device))
    return CBFParams(**leaves)


def config_from_fields(fields: dict) -> Config:
    """Config from a field dict (e.g. ``dataclasses.asdict`` of a JAX
    Config) whose ``dtype`` is a name such as ``"float32"`` or a torch
    dtype. Unknown fields raise TypeError."""
    fields = dict(fields)
    dtype = fields.get("dtype", torch.float32)
    if isinstance(dtype, str):
        resolved = getattr(torch, dtype, None)
        if not isinstance(resolved, torch.dtype):
            raise ValueError(f"unknown dtype name {dtype!r}")
        fields["dtype"] = resolved
    names = {f.name for f in dataclasses.fields(Config)}
    unknown = sorted(set(fields) - names)
    if unknown:
        raise TypeError(f"fields unknown to Config: {unknown}")
    return Config(**fields)
