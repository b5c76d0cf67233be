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


def scenario_state_from_reference(state, state_cls, *, device, dtype):
    """A reference scenario's State (meet_at_center, cross_and_rescue,
    antipodal: any object with ``state_cls``'s fields) as the port's
    ``state_cls``, every field a ``dtype`` tensor on ``device``. Their
    "weights", the consensus and adjacency matrices, are rebuilt from the
    same Config by each package's ``make``."""
    return state_cls(*(_leaf(getattr(state, name), device=device,
                             dtype=dtype) for name in state_cls._fields))


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


def config_from_fields(fields: dict, cls=Config):
    """A ``cls`` config (default: the swarm's; or a scenario module's
    ``Config``) from a field dict (e.g. ``dataclasses.asdict`` of a JAX
    Config) whose ``dtype`` is a name such as ``"float32"`` or a torch
    dtype. Unknown fields raise TypeError."""
    fields = dict(fields)
    dtype = fields.get("dtype", torch.float32)
    if isinstance(dtype, str):
        resolved = getattr(torch, dtype, None)
        if not isinstance(resolved, torch.dtype):
            raise ValueError(f"unknown dtype name {dtype!r}")
        fields["dtype"] = resolved
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(fields) - names)
    if unknown:
        raise TypeError(f"fields unknown to {cls.__name__}: {unknown}")
    return cls(**fields)


def tunable_params_from_numpy(params, *, device=None, dtype=None):
    """The trainer's TunableParams from any object with gamma_raw/dmin_raw/
    k_raw fields (a JAX ``TunableParams``), each a 0-dim tensor (float32
    by default, as JAX's ``init_params`` makes them)."""
    from cbf_tpu_torch.learn.tuning import TunableParams

    return TunableParams(*(
        torch.as_tensor(np.array(getattr(params, name)),
                        dtype=dtype or torch.float32, device=device)
        for name in TunableParams._fields))


def prng_key_from_numpy(key) -> torch.Tensor:
    """A legacy JAX key ((2,) uint32 array) as the port's (2,) int64 key
    (:mod:`cbf_tpu_torch.utils.prng`)."""
    a = np.asarray(key, dtype=np.uint32)
    if a.shape != (2,):
        raise ValueError(f"a key is a (2,) uint32 array, got {a.shape}")
    return torch.as_tensor(a.astype(np.int64))



def solver_state_from_reference(carry, *, device, dtype) -> tuple:
    """An ensemble's sparse-certificate warm carry — the 5-tuple (x, z_p,
    z_b, y_p, y_b) of (E, ...) arrays that the JAX package's
    ``sharded_swarm_rollout(..., with_solver_state=True)`` returns — as
    ``dtype`` tensors on ``device``, ready for the port's
    ``initial_state``."""
    carry = tuple(carry)
    if len(carry) != 5:
        raise ValueError(f"a solver carry is a 5-tuple (x, z_p, z_b, y_p, "
                         f"y_b), got {len(carry)} leaves")
    return tuple(torch.as_tensor(np.array(a), dtype=dtype, device=device)
                 for a in carry)


def ensemble_state_from_reference(state, *, device, dtype) -> tuple:
    """A JAX ensemble state — (x, v[, theta]) of (E, N, 2) / (E, N)
    arrays, with the solver carry as a trailing 5-tuple where it has one
    — as the port's ``sharded_swarm_rollout`` takes it."""
    return tuple(solver_state_from_reference(a, device=device, dtype=dtype)
                 if isinstance(a, tuple) else
                 torch.as_tensor(np.array(a), dtype=dtype, device=device)
                 for a in state)


def ensemble_metrics_from_reference(mets):
    """A JAX ``EnsembleMetrics`` (or any object with its fields, the
    port's too) as the port's, every field a numpy array of (E, steps) —
    the form a chunked ensemble run returns."""
    from cbf_tpu_torch.parallel.ensemble import EnsembleMetrics

    return EnsembleMetrics(*(
        np.array(v.cpu() if isinstance(v, torch.Tensor) else v)
        for v in (getattr(mets, name) for name in EnsembleMetrics._fields)))


def traced_from_reference(traced, *, device, dtype) -> dict:
    """A JAX traced dict (``swarm.split_static_traced``'s or
    ``serve.pack.stack_batch``'s: floats or (B,) arrays) as the port's:
    each field a ``dtype`` tensor on ``device``, ``n_active`` int32."""
    return {k: torch.as_tensor(np.array(v),
                               dtype=torch.int32 if k == "n_active"
                               else dtype, device=device)
            for k, v in traced.items()}


def batch_from_reference(states, traced, steps, *, device, dtype):
    """A JAX serving batch — ``serve.pack.stack_batch``'s member-stacked
    ``State`` ((B, ...) leaves), traced dict and (B,) horizons — as the
    port's (states, traced, steps), ready for
    ``parallel.ensemble.lockstep_traced_rollout``'s program."""
    return (state_from_reference(states, device=device, dtype=dtype),
            traced_from_reference(traced, device=device, dtype=dtype),
            torch.as_tensor(np.array(steps), dtype=torch.int32,
                            device=device))


def rank_block(a, mesh, *, device=None, dtype=None) -> torch.Tensor:
    """This rank's block of a global (E, N, ...) ensemble array (the JAX
    package's ``P("dp", "sp", ...)`` layout): members [dp_index * E / dp,
    ...) and agents [sp_index * N / sp, ...), as a tensor on ``device``
    (default the mesh's)."""
    a = torch.as_tensor(np.asarray(a), dtype=dtype)
    E, N = a.shape[0], a.shape[1]
    e, n = E // mesh.dp, N // mesh.sp
    lo = mesh.axis("dp").index * e
    i0 = mesh.axis("sp").index * n
    return a[lo:lo + e, i0:i0 + n].to(mesh.device if device is None
                                      else device)


def global_from_blocks(block, mesh) -> np.ndarray:
    """The global (E, N, ...) array back from every rank's
    :func:`rank_block` (gathered over sp, then dp), as numpy on every
    rank."""
    sp, dp = mesh.axis("sp"), mesh.axis("dp")
    whole = sp.all_gather(block.movedim(1, 0).contiguous()).movedim(0, 1)
    return dp.all_gather(whole.contiguous()).cpu().numpy()


def slab_to_agents(slab, slot_of_agent) -> np.ndarray:
    """A spatial rollout's slab array (T * C, ...) in agent order (N, ...):
    row a is the slot ``slot_of_agent[a]`` holds."""
    return np.asarray(slab)[np.asarray(slot_of_agent)]


def agents_to_slab(a, slot_of_agent, n_slots: int, fill=0.0) -> np.ndarray:
    """Agent-order rows (N, ...) into a (n_slots, ...) slab at
    ``slot_of_agent``, every other slot ``fill`` (``spatial.PARK`` for
    positions, 0 for velocities)."""
    a = np.asarray(a)
    out = np.full((n_slots,) + a.shape[1:], fill, a.dtype)
    out[np.asarray(slot_of_agent)] = a
    return out
