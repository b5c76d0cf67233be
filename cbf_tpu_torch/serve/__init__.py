"""The serving layer (counterpart: cbf_tpu/serve/).

Shape-bucketed request signatures (:mod:`.buckets`) and request packing
(:mod:`.pack`) turn requests into the padded member tensors of one bucket
batch for the lockstep traced-config programs
(:func:`cbf_tpu_torch.parallel.ensemble.lockstep_traced_rollout`);
:mod:`.engine` is the scheduler — ``ServeEngine`` with its queue,
micro-batch formation (drain mode), lane tables advanced one chunk
program at a time with joins and leaves at chunk boundaries
(``continuous=True``), prewarm (the programs' CUDA graph captures) and
the fault policy of :mod:`.resilience` (typed error taxonomy,
retry/bisect/shed/quarantine/degrade); :mod:`.loadgen` is the seeded
open-loop load generator.
"""

from cbf_tpu_torch.serve.buckets import (DEFAULT_BUCKET_SIZES,
                                         DEFAULT_HORIZON_QUANTUM,
                                         PARKING_ARENA_HALF, BucketKey,
                                         bucket_horizon, bucket_key,
                                         bucket_n, chunk_label)
from cbf_tpu_torch.serve.engine import (PendingRequest, RequestResult,
                                        ServeEngine,
                                        configure_compilation_cache)
from cbf_tpu_torch.serve.loadgen import (LoadSpec, build_schedule,
                                          parse_sweep, run_loadgen,
                                          sweep_rps)
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
    "FencedError", "LoadSpec", "NonFiniteResult", "PARKING_ARENA_HALF",
    "PendingRequest", "QuarantinedError", "RecoveryError",
    "RequestCancelled", "RequestResult", "SchedulerCrashed", "ServeEngine",
    "ServeError", "ShedError", "bucket_horizon", "bucket_key", "bucket_n",
    "build_schedule", "chunk_label", "configure_compilation_cache",
    "is_retryable", "parse_sweep", "request_signature", "run_loadgen",
    "sweep_rps",
]
