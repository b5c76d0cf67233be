"""The serving layer (counterpart: cbf_tpu/serve/).

Shape-bucketed request signatures (:mod:`.buckets`) and request packing
(:mod:`.pack`) turn requests into the padded member tensors of one bucket
batch for the lockstep traced-config programs
(:func:`cbf_tpu_torch.parallel.ensemble.lockstep_traced_rollout`);
:mod:`.engine` is the scheduler's drain mode — ``ServeEngine`` with its
queue, micro-batch formation, prewarm (the bucket programs' CUDA graph
captures) and the fault policy of :mod:`.resilience` (typed error
taxonomy, retry/bisect/shed/quarantine/degrade). Continuous batching and
the load generator arrive with the rest of ROADMAP.md Queue A11: the load
generator's names raise :class:`~cbf_tpu_torch.errors.OutOfSliceError`
here.
"""

from cbf_tpu_torch.errors import SLICE_SERVE, OutOfSliceError
from cbf_tpu_torch.serve.buckets import (DEFAULT_BUCKET_SIZES,
                                         DEFAULT_HORIZON_QUANTUM,
                                         PARKING_ARENA_HALF, BucketKey,
                                         bucket_horizon, bucket_key,
                                         bucket_n, chunk_label)
from cbf_tpu_torch.serve.engine import (PendingRequest, RequestResult,
                                        ServeEngine,
                                        configure_compilation_cache)
from cbf_tpu_torch.serve.resilience import (CircuitBreaker,
                                            DeadlineExceeded, FaultPolicy,
                                            FencedError, NonFiniteResult,
                                            QuarantinedError, RecoveryError,
                                            RequestCancelled,
                                            SchedulerCrashed, ServeError,
                                            ShedError, is_retryable,
                                            request_signature)

__all__ = [
    "BucketKey", "CircuitBreaker", "DEFAULT_BUCKET_SIZES",
    "DEFAULT_HORIZON_QUANTUM", "DeadlineExceeded", "FaultPolicy",
    "FencedError", "NonFiniteResult", "PARKING_ARENA_HALF",
    "PendingRequest", "QuarantinedError", "RecoveryError",
    "RequestCancelled", "RequestResult", "SchedulerCrashed", "ServeEngine",
    "ServeError", "ShedError", "bucket_horizon", "bucket_key", "bucket_n",
    "chunk_label", "configure_compilation_cache", "is_retryable",
    "request_signature",
]

# The JAX package's serve names of a later slice (the load generator).
_NOT_PORTED = ("LoadSpec", "build_schedule", "parse_sweep", "run_loadgen",
               "sweep_rps")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise OutOfSliceError(f"cbf_tpu_torch.serve.{name}", SLICE_SERVE)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
