"""Fault-tolerance primitives for the serving engine (counterpart:
cbf_tpu/serve/resilience.py, ported whole).

At serving scale the failure modes that matter are not single-rollout
crashes but *coupled* ones: one poisoned request in a packed batch must
not fail its seven batch-mates, a transient executor hiccup must not
surface to callers at all, and sustained overload must shed or degrade
instead of letting queue-wait grow without bound (the Round 10 loadgen
showed queue-wait already dominates p99). This module holds the
engine-independent pieces of that story:

- the **typed error taxonomy** (:class:`ServeError` and subclasses) —
  every way a request can fail without a result is a distinct exception
  type carrying the request id and bucket, so callers and the load
  generator can classify outcomes instead of pattern-matching strings;
- :class:`FaultPolicy` — one frozen knob bundle for retries/backoff,
  admission control, deadlines, quarantine and graceful degradation,
  validated up front (a typo'd shed policy fails at construction, not
  mid-traffic);
- :class:`CircuitBreaker` — the closed/open/half-open state machine
  shared by the per-request-signature quarantine and the per-bucket
  compile breaker;
- :func:`request_signature` / :func:`is_retryable` — the two
  classification helpers: which config a repeat offender *is*, and which
  exceptions are worth a backoff retry.

Everything here is host-side numpy: the scheduler thread consults it
between batches, never inside a captured program. Backoff jitter is seeded
(`numpy.random.default_rng`) — the same policy replays the same backoff
schedule, bit for bit the JAX package's. :func:`request_signature` renders
the config's ``dtype`` as the JAX package's repr renders it, so a request
has one quarantine key in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

# ------------------------------------------------------------ taxonomy ----


class ServeError(Exception):
    """Base of the serving layer's typed failure taxonomy. Every request
    that cannot produce a result fails with a subclass of this, carrying
    ``request_id`` and ``bucket`` (either may be None when the failure
    precedes assignment — e.g. a shed at admission has no bucket queue
    slot yet)."""

    def __init__(self, message: str, *, request_id: str | None = None,
                 bucket: str | None = None):
        super().__init__(message)
        self.request_id = request_id
        self.bucket = bucket


class ShedError(ServeError):
    """Admission control rejected the request: the bounded queue was full
    and the policy shed it (``reject-newest`` raises this from
    ``submit``; ``reject-oldest`` resolves the evicted oldest request's
    handle with it)."""


class DeadlineExceeded(ServeError):
    """The request's deadline passed before its batch executed. Expired
    requests are dropped at flush time — they never occupy an executor
    slot — and fail fast with this."""


class QuarantinedError(ServeError):
    """Rejected by an open circuit breaker: either the request's
    signature accumulated too many failures (a repeat offender) or its
    bucket's executable keeps failing to compile. Clears after the
    breaker's cooldown admits a successful probe."""


class NonFiniteResult(ServeError):
    """The batch executed, but this request's slot unpacked non-finite
    state or outputs (NaN/inf). The batch-mates are unaffected — vmapped
    lanes are independent — so only this request fails, and its
    signature takes a quarantine strike."""


class SchedulerCrashed(ServeError):
    """The scheduler thread died on an unexpected exception. Every
    queued request is resolved with this instead of hanging forever
    (the pre-PR-8 behavior)."""


class RequestCancelled(ServeError):
    """The caller cancelled the request (``PendingRequest.cancel()``)
    while it was still queued."""


class RecoveryError(ServeError):
    """Crash recovery could not honor the write-ahead journal: the
    journal file is missing/garbled beyond the torn-final-line the
    append protocol permits, or its schema version is unknown. Raised by
    :func:`cbf_tpu_torch.durable.journal.replay_journal` — an unreadable
    journal must fail loudly, not silently drop acknowledged requests."""


class FencedError(ServeError):
    """A journal append was rejected because a NEWER epoch owns the log:
    the appender's epoch is below the fence (the lease file's epoch
    counter), which means a standby has taken over since this process
    last held the lease. Raised by
    :meth:`cbf_tpu_torch.durable.journal.RequestJournal._append` BEFORE any
    byte is written — a paused/zombie primary that wakes after takeover
    is fenced at the log, so the new epoch's records can never interleave
    with stale ones. Carries ``epoch`` (the appender's), ``fence_epoch``
    (the current owner's) and ``path`` (the fence file consulted)."""

    def __init__(self, message: str, *, epoch: int, fence_epoch: int,
                 path: str | None = None, request_id: str | None = None):
        super().__init__(message, request_id=request_id)
        self.epoch = epoch
        self.fence_epoch = fence_epoch
        self.path = path


#: Exception types retrying cannot fix: bad inputs and code bugs, the
#: same classification bench.py's ``_is_permanent_error`` uses. The
#: typed taxonomy above is also permanent — a shed or quarantine verdict
#: does not improve with backoff. Everything else (RuntimeError,
#: CUDA errors, OSError, injected executor faults) is presumed
#: transient and worth the bounded retry budget.
PERMANENT_ERROR_TYPES: tuple[type, ...] = (
    ValueError, TypeError, KeyError, AttributeError, AssertionError,
    ImportError, ServeError)


def is_retryable(error: BaseException) -> bool:
    """Whether a batch failure is worth a backoff retry (transient) as
    opposed to deterministic (permanent input/code error)."""
    return not isinstance(error, PERMANENT_ERROR_TYPES)


def request_signature(cfg) -> str:
    """Stable short signature identifying WHAT a request asks for —
    the quarantine's repeat-offender key. Hashes the config's repr with
    ``seed`` zeroed (spawn randomness is not part of the offense: the
    same poisoned knob set resubmitted under a fresh seed must match its
    quarantine record)."""
    canon = dataclasses.replace(cfg, seed=0)
    return hashlib.sha1(_canonical_repr(canon).encode()).hexdigest()[:12]


def _canonical_repr(cfg) -> str:
    """The dataclass repr of ``cfg`` with a torch ``dtype`` written as the
    JAX package's Config repr writes its dtype
    (``<class 'jax.numpy.float32'>``) — the one place the two packages'
    Config reprs differ. Plain strings: nothing of JAX is imported."""
    parts = []
    for f in dataclasses.fields(cfg):
        if not f.repr:
            continue
        v = getattr(cfg, f.name)
        text = repr(v)
        if text.startswith("torch."):
            text = f"<class 'jax.numpy.{text[len('torch.'):]}'>"
        parts.append(f"{f.name}={text}")
    return f"{type(cfg).__qualname__}({', '.join(parts)})"


# -------------------------------------------------------------- policy ----

SHED_POLICIES = ("reject-newest", "reject-oldest")

#: Two-class admission tier. ``foreground`` is the SLO class: it owns
#: the queue watermarks (degrade triggers count foreground depth only)
#: and the batch scheduler's attention. ``background`` is the soak
#: class (the falsification fleet): admitted only into its own queue,
#: shed FIRST under foreground queue pressure, dispatched at most one
#: batch per scheduler pass and only while no foreground work is
#: runnable — so a foreground arrival packs within one flush deadline
#: regardless of how saturated the background queue is.
PRIORITIES = ("foreground", "background")


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """One serving engine's fault-tolerance knobs (immutable; swap the
    whole policy to change behavior).

    Retries: a failed batch retries up to ``max_retries`` times when the
    error is transient (:func:`is_retryable`), sleeping
    ``backoff_base_s * backoff_factor**attempt`` plus up to
    ``backoff_jitter`` of itself (seeded rng). Exhausted or
    permanent multi-request batches bisect so only offenders fail.

    Admission control: ``queue_limit`` bounds the TOTAL queued request
    count across buckets; a submit beyond it sheds per ``shed_policy``
    (``reject-newest``: the new request is refused with
    :class:`ShedError`; ``reject-oldest``: the globally oldest queued
    request is evicted to make room). ``queue_bytes_budget`` is the
    cost-model upgrade of the same bound: the engine predicts each
    request's device peak bytes (``CostModel.predict_peak_bytes``) and
    sheds when admitting would push the queue's predicted total over
    the budget — FAIL-OPEN when the cost model has no priced ancestor
    for the request's shape (an unpriced request counts 0 bytes), so a
    cold ledger never blocks traffic. Both bounds may be active; either
    sheds. ``deadline_s`` is the default per-request deadline (None =
    none; ``submit(deadline_s=...)`` overrides per request).

    Quarantine: a request signature accumulating
    ``quarantine_threshold`` execution failures opens its breaker for
    ``quarantine_cooldown_s``; submits of that signature fail fast with
    :class:`QuarantinedError` until a post-cooldown probe succeeds.
    A bucket whose executable fails to build ``breaker_threshold``
    times opens a bucket-wide breaker under the same cooldown.

    Degradation: when total queue depth stays above
    ``degrade_high_watermark`` for ``degrade_sustain_s``, the engine
    enters degraded mode and caps every request's horizon at
    ``degrade_steps_frac`` of its bucket horizon (``steps`` rides as a
    traced mask, so the cap needs NO recompilation — it is the one
    solver-budget lever that cannot cause a bucket miss). Exits when
    depth falls to ``degrade_low_watermark``. None disables.

    ``check_finite`` gates the per-slot NaN/inf scan of unpacked
    results (:class:`NonFiniteResult`); disable only for overhead
    measurement legs.

    ``rta_fallback`` arms the runtime-assurance rescue: a request whose
    slot unpacked non-finite results is re-run ALONE under
    ``dataclasses.replace(cfg, rta=True)`` — the in-rollout fallback
    ladder (``cbf_tpu_torch.rta``) absorbs the fault and the caller receives a
    degraded completion (``RequestResult.rta_engaged=True``) instead of
    a :class:`NonFiniteResult`. Off by default: the rescue bucket is a
    distinct executable (the rta knobs are static), so first engagement
    costs a compile.
    """
    max_retries: int = 2
    backoff_base_s: float = 0.02
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.5
    seed: int = 0
    queue_limit: int | None = None
    queue_bytes_budget: int | None = None
    shed_policy: str = "reject-newest"
    deadline_s: float | None = None
    quarantine_threshold: int = 3
    quarantine_cooldown_s: float = 1.0
    breaker_threshold: int = 5
    check_finite: bool = True
    rta_fallback: bool = False
    degrade_high_watermark: int | None = None
    degrade_low_watermark: int = 0
    degrade_sustain_s: float = 0.25
    degrade_steps_frac: float = 0.5

    def __post_init__(self):
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {self.shed_policy!r}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.queue_limit is not None and self.queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1 (or None), "
                             f"got {self.queue_limit}")
        if self.queue_bytes_budget is not None \
                and self.queue_bytes_budget < 1:
            raise ValueError(f"queue_bytes_budget must be >= 1 (or None), "
                             f"got {self.queue_bytes_budget}")
        if self.quarantine_threshold < 1 or self.breaker_threshold < 1:
            raise ValueError("quarantine_threshold and breaker_threshold "
                             "must be >= 1")
        if not (0.0 < self.degrade_steps_frac <= 1.0):
            raise ValueError(f"degrade_steps_frac must be in (0, 1], "
                             f"got {self.degrade_steps_frac}")

    def backoff_s(self, attempt: int, rng: np.random.Generator) -> float:
        """The sleep before retry number ``attempt + 1`` (exponential in
        the attempt index, plus seeded jitter so lockstep clients
        de-synchronize)."""
        base = self.backoff_base_s * self.backoff_factor ** attempt
        return base * (1.0 + self.backoff_jitter * float(rng.random()))


# ------------------------------------------------------------- breaker ----


class CircuitBreaker:
    """Closed -> open -> half-open failure breaker (host-side, caller
    holds whatever lock serializes it — the engine uses its queue lock).

    ``record_failure`` counts consecutive failures; at ``threshold`` the
    breaker OPENS and ``allow`` refuses until ``cooldown_s`` elapses,
    after which exactly one probe is admitted (HALF-OPEN). The probe's
    ``record_success`` CLOSES the breaker (counts reset); its
    ``record_failure`` re-opens it for another cooldown. State-changing
    calls return True so the caller can emit quarantine telemetry only
    on transitions, not on every strike."""

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.state = "closed"
        self.failures = 0
        self._opened_at: float | None = None
        self._probing = False

    def allow(self, now: float) -> bool:
        """Whether a request may pass. In OPEN state, the first call
        after the cooldown flips to HALF-OPEN and admits one probe."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self._opened_at is not None and \
                    now - self._opened_at >= self.cooldown_s:
                self.state = "half_open"
                self._probing = True
                return True
            return False
        # half_open: one probe in flight, everyone else waits.
        if self._probing:
            return False
        self._probing = True
        return True

    def record_success(self) -> bool:
        """Returns True when this success CLOSED a non-closed breaker
        (quarantine recovery)."""
        recovered = self.state != "closed"
        self.state = "closed"
        self.failures = 0
        self._opened_at = None
        self._probing = False
        return recovered

    def record_failure(self, now: float) -> bool:
        """Returns True when this failure OPENED the breaker (threshold
        reached, or a half-open probe failed)."""
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            already_open = self.state == "open"
            self.state = "open"
            self._opened_at = now
            self._probing = False
            return not already_open
        return False

    def to_state(self, now: float) -> dict:
        """JSON-able snapshot for cross-restart persistence. Time is
        stored as REMAINING cooldown, not an absolute stamp: breaker
        clocks are per-process monotonic (`obs.trace.Tracer.now()`
        style) and rebase to ~0 in the next process, so an absolute
        ``_opened_at`` would be meaningless after a restart."""
        remaining = 0.0
        if self.state == "open" and self._opened_at is not None:
            remaining = max(0.0, self.cooldown_s - (now - self._opened_at))
        return {"state": self.state, "failures": self.failures,
                "threshold": self.threshold, "cooldown_s": self.cooldown_s,
                "remaining_s": round(remaining, 6)}

    @classmethod
    def from_state(cls, state: dict, now: float) -> "CircuitBreaker":
        """Rebuild a breaker on the NEW process's clock (inverse of
        :meth:`to_state`). A breaker persisted HALF-OPEN restores as
        OPEN with its cooldown already elapsed: the in-flight probe died
        with the old process, and this mapping makes the next ``allow``
        admit exactly one fresh probe — half-open semantics survive the
        restart instead of deadlocking on a probe that will never
        report."""
        br = cls(int(state["threshold"]), float(state["cooldown_s"]))
        br.failures = int(state["failures"])
        persisted = state["state"]
        if persisted == "closed":
            return br
        br.state = "open"
        remaining = 0.0 if persisted == "half_open" \
            else max(0.0, float(state["remaining_s"]))
        br._opened_at = now - (br.cooldown_s - remaining)
        return br
