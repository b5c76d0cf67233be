"""The serving layer's compute path (counterpart: cbf_tpu/serve/).

Ported: shape-bucketed request signatures (:mod:`.buckets`) and request
packing (:mod:`.pack`), which turn requests into the padded member tensors
of one bucket batch for the lockstep traced-config programs
(:func:`cbf_tpu_torch.parallel.ensemble.lockstep_traced_rollout` and
``lockstep_traced_chunk``). The scheduler — ``ServeEngine`` with its
queue, prewarm, continuous lanes and fault policy — and the load
generator come with the next serving slice (ROADMAP.md Queue A11): those
names raise :class:`~cbf_tpu_torch.errors.OutOfSliceError` here.
"""

from cbf_tpu_torch.errors import SLICE_SERVE, OutOfSliceError
from cbf_tpu_torch.serve.buckets import (DEFAULT_BUCKET_SIZES,
                                         DEFAULT_HORIZON_QUANTUM,
                                         PARKING_ARENA_HALF, BucketKey,
                                         bucket_horizon, bucket_key,
                                         bucket_n, chunk_label)

__all__ = [
    "BucketKey", "DEFAULT_BUCKET_SIZES", "DEFAULT_HORIZON_QUANTUM",
    "PARKING_ARENA_HALF", "bucket_horizon", "bucket_key", "bucket_n",
    "chunk_label",
]

# The JAX package's serve names of later slices.
_NOT_PORTED = (
    "ServeEngine", "PendingRequest", "RequestResult",
    "configure_compilation_cache", "LoadSpec", "build_schedule",
    "parse_sweep", "run_loadgen", "sweep_rps", "CircuitBreaker",
    "DeadlineExceeded", "FaultPolicy", "FencedError", "NonFiniteResult",
    "QuarantinedError", "RecoveryError", "RequestCancelled",
    "SchedulerCrashed", "ServeError", "ShedError", "is_retryable",
    "request_signature")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise OutOfSliceError(f"cbf_tpu_torch.serve.{name}", SLICE_SERVE)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
