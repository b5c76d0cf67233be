"""Request-serving engine: queue, micro-batch formation, prewarm, fault
tolerance, continuous batching (counterpart: cbf_tpu/serve/engine.py).

The throughput layer over the compiled rollout machinery: many
independent rollout requests (each a `scenarios.swarm.Config`) are
bucketed by static signature (`serve.buckets`), packed into
lockstep-batched programs (`parallel.ensemble.lockstep_traced_rollout`
— per-request traced scalars ride as per-lane tensors) and drained with
micro-batch formation: a bucket flushes when it fills (``max_batch``
requests) or when its oldest request's deadline (``flush_deadline_s``)
expires. `ServeEngine.prewarm` captures registered buckets up front.

"Compile" is the capture: a bucket's program is built by running
``lockstep_traced_rollout(key.static_cfg, key.horizon)``'s program once on
``pack.dummy_batch`` (`parallel.ensemble.prepare_traced_rollout`), which on
the card captures its CUDA graph and measures it for the cost model. A
CUDA graph does not outlive its process: each process captures its own
graphs, and only the nvcc objects in ``csrc/_build/`` persist across
processes (`configure_compilation_cache` records a directory for the
manifest, as the JAX package's does, and changes nothing else).

Queue mode has two scheduling disciplines. DRAIN (default): a bucket
flushes into a full-horizon program and every batch member waits for the
slowest mate. CONTINUOUS (``continuous=True``): the scheduler advances a
per-static-config LANE TABLE one CHUNK at a time
(`parallel.ensemble.lockstep_traced_chunk`, each lane at its own clock),
and at every chunk boundary newly-arrived same-config requests JOIN free
lanes while finished/deadline-expired requests LEAVE: per-lane remaining
horizon rides the horizon mask (one chunk program serves every horizon
of a static config — it is the drain program of horizon ``chunk_steps``,
so the two share one capture) and vacant lanes are inert pads (steps 0
freezes them — `serve.pack`). Completed lanes resolve immediately;
in-flight lanes stream `serve.partial` progress events (and host
StepOutputs chunk slices via the ``partial_hook`` seam), so clients
observe time-to-first-partial (`RequestResult.ttfp_s`). A lane table
owns its carry (the chunk program returns new tensors), so a failed
chunk retries from an intact carry. ``run()`` always drains.

The captured programs are shared, stateful objects (their carry and
output buffers are reused by every replay; the step programs are cached
process-wide), so every capture and replay of a serving program — and the
pack, lane joins and unpack around it — runs under one process-wide lock
(``_PROGRAM_LOCK``): two engines, or ``run()`` on a caller's thread beside
the scheduler, never interleave on one program's buffers, and no capture
sees another thread's device work. In queue mode all device work
happens on the scheduler thread; ``submit`` is host-only.

Failures are first-class (`serve.resilience`): a failed batch retries
with bounded exponential backoff when transient, then BISECTS so only
the offending request(s) fail (lanes are independent — a poisoned
batch-mate cannot fail the other seven); a failed chunk retries on its
carry, then DEMOTES each live lane to a solo drain run; non-finite
per-slot results fail alone with `NonFiniteResult` — or, with
``FaultPolicy.rta_fallback``, are re-run solo under the runtime-
assurance ladder (``rta=True``) for a degraded completion
(`RequestResult.rta_engaged`); repeat offenders are quarantined per
request signature and broken buckets per key (circuit breakers);
`submit` applies admission control (bounded queue with a
reject-newest/-oldest shed policy) and per-request deadlines; sustained
overload degrades gracefully by capping the per-lane horizon mask (no
new capture). Every recovery decision emits a schema-versioned telemetry
event (`serve.retry` / `serve.shed` / `serve.quarantine` /
`serve.degrade` / `serve.scheduler_crash`) and a registry counter.

A batch's (a chunk's) results reach the host in one copy per tree (the
"unpack" span), and the "execute" span synchronises the card, so
``execute_s`` is the card's time and not the launch's. A scheduler-thread
crash resolves every queued request — and every in-flight lane — with
`SchedulerCrashed` instead of hanging them.

A cooperative background tenant (``attach_background``; the
falsification fleet's serve-idle mode) gets one unit of work per
scheduler pass while the foreground tier is fully idle; a unit pulled
just before a foreground arrival is dropped un-run. The unit runs on the
scheduler thread outside the engine's own locks but under
``_PROGRAM_LOCK``: its captures, replays and any shrink of a found
violation never interleave with another engine's device work.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.obs import trace as obs_trace
from cbf_tpu_torch.parallel import ensemble
from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.serve import buckets as _buckets
from cbf_tpu_torch.serve import pack as _pack
from cbf_tpu_torch.serve import resilience
from cbf_tpu_torch.utils import profiling

#: Generic telemetry event types this module emits (together with
#: obs.trace's, they union to obs.schema.SERVE_EVENT_TYPES;
#: ``serve.partial`` is the continuous scheduler's).
EMITTED_EVENT_TYPES: tuple[str, ...] = (
    "request", "serve.partial", "serve.retry", "serve.shed",
    "serve.quarantine", "serve.degrade", "serve.scheduler_crash",
    "serve.cost")

#: Serialises every capture and replay of a serving program in the
#: process (module docstring).
_PROGRAM_LOCK = lockwitness.make_lock("serve.engine._PROGRAM_LOCK")


def configure_compilation_cache(cache_dir: str | None = None) -> str | None:
    """The ``CBF_TPU_CACHE_DIR`` knob: the explicit argument wins over the
    environment variable; returns the directory in effect, or None. The
    manifest records it, as the JAX package's does. A captured CUDA graph
    does not persist across processes, so every process captures its own
    bucket programs (prewarm pays it once per process); only the compiled
    kernel objects in ``csrc/_build/`` are reused by a later process."""
    return cache_dir or os.environ.get("CBF_TPU_CACHE_DIR") or None


def _all_finite(*trees) -> bool:
    """Every float leaf of every (host) tree is finite — the per-slot
    poison check scans every leaf, as the JAX package's does."""
    for tree in trees:
        for leaf in _leaves(tree):
            arr = np.asarray(leaf)
            if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
                return False
    return True


def _leaves(tree) -> list:
    """The array leaves of (named) tuples; ``()`` has none."""
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


def _to_host(tree):
    """One device-to-host copy per leaf of a batch's tree (numpy)."""
    return _pack._tree(
        lambda a: a.cpu().numpy() if torch.is_tensor(a) else a, tree)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class RequestResult:
    """One served request's outcome (host arrays, trimmed to the
    request's true n and steps — see `serve.pack.trim_result`)."""
    request_id: str
    bucket: str
    n: int
    steps: int              # effective horizon (capped when degraded)
    final_state: Any
    outputs: Any            # StepOutputs, time axes = steps
    latency_s: float        # submit -> result available
    queue_wait_s: float     # submit -> the batch's execute start
    execute_s: float        # the batch's device wall (shared by members)
    batch_fill: int         # real requests in the flushed batch
    degraded: bool = False  # served under the overload degradation cap
    # The runtime-assurance ladder engaged during this rollout (any step
    # with rta_mode > 0) — the request completed, but degraded: some
    # agents rode a fallback rung rather than the nominal filter.
    rta_engaged: bool = False
    # Time-to-first-partial: submit -> the first streamed serve.partial
    # chunk. None in drain mode, and for continuous requests that
    # completed within their first chunk advance (no partial streamed).
    ttfp_s: float | None = None


class _Lane:
    """One occupied lane's host-side bookkeeping (scheduler-thread
    state; the device half lives in the table's stacked tensors)."""

    __slots__ = ("pending", "cfg", "traced", "t_enq", "deadline_t",
                 "t_join", "eff_steps", "parts", "execute_s", "ttfp_s",
                 "degraded")

    def __init__(self, pending, cfg, traced, t_enq, deadline_t, t_join,
                 eff_steps, degraded):
        self.pending = pending
        self.cfg = cfg
        self.traced = traced
        self.t_enq = t_enq
        self.deadline_t = deadline_t
        self.t_join = t_join
        self.eff_steps = eff_steps
        self.parts: list = []       # per-chunk host StepOutputs slices
        self.execute_s = 0.0        # accumulated chunk device wall
        self.ttfp_s: float | None = None
        self.degraded = degraded


class _LaneTable:
    """One static config's continuous-batching lane table: ``max_batch``
    lanes on ``device`` advanced one chunk at a time by ONE shared
    program (`parallel.ensemble.lockstep_traced_chunk`). An occupied lane
    carries a request's state plus its per-lane local clock (``t_np``)
    and horizon-mask bound (``steps_np``); a vacant lane is an inert pad
    (steps 0 freezes it at its local t=0 — the `serve.pack` contract),
    overwritten by the next join. ``states`` are the table's own tensors
    (the chunk program returns new ones), never a program's buffers. All
    mutation happens on the scheduler thread (or stop()'s finish loop,
    which runs only after that thread has exited) — the table itself
    needs no lock; its device work runs under ``_PROGRAM_LOCK``."""

    def __init__(self, static_cfg: swarm.Config, chunk: int,
                 max_batch: int, device):
        self.static_cfg = static_cfg
        self.chunk = chunk
        self.max_batch = max_batch
        self.device = device
        self.label = _buckets.chunk_label(static_cfg, chunk)
        self.states = None          # stacked State, batch axis first
        self.traced: list = [None] * max_batch   # per-slot host dicts
        self.lanes: list = [None] * max_batch    # per-slot _Lane | None
        self.steps_np = np.zeros(max_batch, np.int32)
        self.t_np = np.zeros(max_batch, np.int32)

    def free_lanes(self) -> int:
        return sum(1 for lane in self.lanes if lane is None)

    def occupied(self) -> bool:
        return any(lane is not None for lane in self.lanes)

    def live_slots(self) -> list[int]:
        return [i for i, lane in enumerate(self.lanes)
                if lane is not None]

    def join(self, key, pending, cfg, traced, t_enq, deadline_t, t_join,
             eff_steps: int, degraded: bool) -> int:
        """Scatter one request into the first free lane (chunk-boundary
        JOIN; device work — call under ``_PROGRAM_LOCK``). The lane's
        local clock starts at 0 regardless of how far its batch-mates
        have advanced — lanes are data-independent, so a joined request's
        rows are bit-identical to the same config run solo."""
        slot = self.lanes.index(None)
        kb = _buckets.BucketKey(self.static_cfg, key.horizon)
        if self.states is None:
            self.states = _pack.seed_lane_table(kb, cfg, self.max_batch,
                                                device=self.device)
        else:
            self.states = _pack.join_lane(
                self.states, slot,
                _pack.padded_initial_state(cfg, kb, device=self.device))
        for i in range(self.max_batch):
            if self.traced[i] is None:
                self.traced[i] = dict(traced)
        self.traced[slot] = dict(traced)
        self.lanes[slot] = _Lane(pending, cfg, traced, t_enq, deadline_t,
                                 t_join, eff_steps, degraded)
        self.steps_np[slot] = eff_steps
        self.t_np[slot] = 0
        return slot

    def vacate(self, slot: int) -> None:
        """Free a lane (LEAVE): zeroing its mask bound makes the chunk
        program freeze it, so batch-mates' rows are untouched."""
        self.lanes[slot] = None
        self.steps_np[slot] = 0
        self.t_np[slot] = 0

    def stacked_traced(self) -> dict:
        """Batched traced-scalar tensors for the chunk call, in
        `serve.pack.stack_batch`'s dtypes (so the chunk program is the
        one its capture prepared); vacant slots keep their last dict —
        their lanes are masked off anyway."""
        dtype = self.static_cfg.dtype
        ref = next(t for t in self.traced if t is not None)
        return {k: torch.tensor([t[k] for t in self.traced],
                                dtype=torch.int32 if k == "n_active"
                                else dtype, device=self.device)
                for k in ref}


class PendingRequest:
    """Queue-mode handle: `result(timeout)` blocks until the scheduler
    flushes the request's bucket; `cancel()` withdraws a still-queued
    request so a caller that timed out does not leave a zombie occupying
    a queue slot."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._event = lockwitness.make_event("PendingRequest._event")
        self._result: RequestResult | None = None
        self._error: BaseException | None = None
        self._engine: "ServeEngine | None" = None
        self._key = None
        self._priority = "foreground"   # which queue dict holds the entry
        self._journal = None   # set at admission when the engine journals

    def _resolve(self, result=None, error=None):
        self._result, self._error = result, error
        # WAL ordering: the terminal record is durable BEFORE the
        # caller's handle unblocks — a crash after result() returned
        # cannot resurrect this request at recovery.
        if self._journal is not None:
            try:
                self._journal.resolved(self.request_id, error)
            except resilience.FencedError as fe:
                # A newer epoch owns the log (we are the zombie): the
                # terminal record did NOT land, the new owner will re-run
                # this request, and handing the caller a result it would
                # treat as acknowledged makes a duplicate delivery. The
                # handle resolves with the typed fencing error instead,
                # and the engine remembers it so the CLI can exit fenced.
                self._result, self._error = None, fe
                if self._engine is not None:
                    self._engine._note_fenced(fe)
            except (OSError, ValueError):
                pass   # journal gone/closed: resolving beats stranding
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> RequestResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not served in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def cancel(self) -> bool:
        """Withdraw the request from its bucket queue. Returns True when
        the request was removed (it then fails with `RequestCancelled`);
        False when it is too late — already packed into a batch, already
        resolved, or never queued — in which case nothing changes and
        `result()` behaves as usual. Safe against the scheduler's flush:
        removal and packing serialize on the engine's queue lock."""
        engine = self._engine
        if engine is None or self.done():
            return False
        with engine._cond:
            qmap = engine._bg_queue if self._priority == "background" \
                else engine._queue
            entries = qmap.get(self._key)
            if not entries:
                return False
            for i, entry in enumerate(entries):
                if entry[0] is self:
                    del entries[i]
                    break
            else:
                return False
            engine._count("cancelled")
        self._resolve(error=resilience.RequestCancelled(
            f"request {self.request_id} cancelled while queued",
            request_id=self.request_id))
        return True


class ServeEngine:
    """Shape-bucketed micro-batching server for swarm rollout requests.

    Two drive modes share the bucket/program machinery:

    - `run(configs)` — synchronous offline drain (the CLI's request-file
      mode): group, batch, execute, return every result.
    - `start()` + `submit(cfg)` + `stop()` — queue mode: a scheduler
      thread forms micro-batches, flushing a bucket on batch-full or on
      the oldest member's ``flush_deadline_s``.

    One program exists per (bucket, horizon) — the batch axis is always
    padded to ``max_batch`` (`serve.pack.stack_batch`), so a
    deadline-forced partial flush replays the full-batch program instead
    of capturing a second one. ``device`` is where the programs run: the
    card unless the caller asks for the CPU (``device="cpu"``).

    Fault tolerance is governed by ``fault_policy``
    (`serve.resilience.FaultPolicy`; the default is always-on: retries,
    bisection and finite-checking active, admission control and
    deadlines off). ``fault_hook`` is the chaos seam: a callable
    ``hook(key, entries, attempt, phase)`` invoked at ``phase`` in
    {"compile", "execute"} before that stage of every batch — the
    `utils.faults` serve injectors plug in here. ``degrade_hook``
    optionally replaces the built-in horizon cap: called as
    ``hook(key, steps_b) -> steps_b`` while degraded.

    ``continuous=True`` switches queue mode to the continuous-batching
    scheduler (see the module docstring): per-static-config lane tables
    advance ``chunk_steps`` steps per pass with join/leave at chunk
    boundaries, ONE chunk program per static config regardless of
    horizon, completions resolving immediately, `serve.partial` events
    (+ the ``partial_hook`` seam) streaming in-flight progress, and
    `RequestResult.ttfp_s` reporting time-to-first-partial. ``run()``
    and recovery replay keep the drain discipline either way.
    """

    def __init__(self, *, max_batch: int = 8, flush_deadline_s: float = 0.05,
                 bucket_sizes: tuple[int, ...] = _buckets.DEFAULT_BUCKET_SIZES,
                 horizon_quantum: int = _buckets.DEFAULT_HORIZON_QUANTUM,
                 cache_dir: str | None = None, telemetry=None, tracer=None,
                 fault_policy: resilience.FaultPolicy | None = None,
                 journal=None, cost_model=None, flight=None,
                 continuous: bool = False, chunk_steps: int = 16,
                 backlog_chunks: int = 4, lane_ledger=None, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        if backlog_chunks < 1:
            raise ValueError(
                f"backlog_chunks must be >= 1, got {backlog_chunks}")
        self.device = swarm.resolve_device(device)
        self.max_batch = max_batch
        self.flush_deadline_s = flush_deadline_s
        # Continuous batching (queue mode only): advance per-static-
        # config lane tables one chunk_steps-long chunk at a time with
        # join/leave at every chunk boundary, instead of draining full-
        # horizon batches. run() always drains (the caller IS the queue).
        self.continuous = continuous
        self.chunk_steps = chunk_steps
        # Deep-backlog burst: with the foreground queue past the degrade
        # high watermark, each occupied table advances up to this many
        # chunks per scheduler pass before joins are re-checked (every
        # joinable request is already behind a full table there, so the
        # re-scan buys nothing and per-chunk dispatch is pure loss). 1
        # disables bursting.
        self.backlog_chunks = backlog_chunks
        self.bucket_sizes = tuple(bucket_sizes)
        self.horizon_quantum = horizon_quantum
        self.cache_dir = configure_compilation_cache(cache_dir)
        self.telemetry = telemetry
        # Lifecycle span tracer (obs.trace): every request's enqueue ->
        # queue_wait -> pack -> compile|executable_hit -> execute ->
        # unpack -> resolve is spanned on the tracer's monotonic clock.
        # Default wires into the telemetry sink (serve.span events +
        # per-phase histograms); pass Tracer(enabled=False) to kill it.
        self.tracer = tracer if tracer is not None \
            else obs_trace.Tracer(sink=telemetry)
        self.fault_policy = fault_policy if fault_policy is not None \
            else resilience.FaultPolicy()
        self.fault_hook = None
        self.degrade_hook = None
        # Streaming seam (continuous mode): called as
        # ``partial_hook(request_id, steps_done, outs_slice)`` with each
        # in-flight lane's host StepOutputs chunk slice (numpy) — the
        # rows a streaming layer would forward. The serve.partial event
        # carries aggregates of the SAME slice, so the two views cannot
        # diverge. A raising hook is detached.
        self.partial_hook = None
        # Write-ahead request journal (durable execution): a path string
        # opens/appends a `durable.journal.RequestJournal` there; a
        # ready-made journal object is used as-is; None (default)
        # disables journaling entirely (no per-request fsync cost).
        if isinstance(journal, (str, os.PathLike)):
            from cbf_tpu_torch.durable.journal import RequestJournal

            journal = RequestJournal(os.fspath(journal), telemetry=telemetry)
        self.journal = journal
        # Resource accounting (obs.resource.CostModel): every bucket
        # capture is attributed (argument/output/peak bytes) and every
        # successful batch feeds predicted-vs-measured execute drift
        # (`serve.cost` events + serve.cost_model.drift gauge). None
        # (default) disables accounting entirely.
        self.cost_model = cost_model
        # Incident flight recorder (obs.flight.FlightRecorder): trips a
        # capsule on NonFiniteResult, quarantine/breaker opens, scheduler
        # crashes, and SIGTERM drains. None (default) disables.
        self.flight = flight
        # Scheduler observatory (obs.lanes.LaneLedger): chunk-boundary
        # occupancy/attribution ledger. None (default) arms it iff
        # continuous AND a telemetry sink is attached; True forces a
        # ledger (standalone, still readable via engine.lanes); False
        # disables; a ready-made LaneLedger is used as-is. Off, the
        # scheduler takes zero extra clock reads and stays bit-neutral.
        if lane_ledger is None:
            lane_ledger = bool(continuous and telemetry is not None)
        if lane_ledger is True:
            from cbf_tpu_torch.obs.lanes import LaneLedger

            self.lanes = LaneLedger(sink=telemetry)
        elif lane_ledger is False:
            self.lanes = None
        else:
            self.lanes = lane_ledger
        # Every incident capsule embeds "what was running": unless the
        # caller already installed a context seam, wire the recorder's
        # context_fn to this engine's in-flight snapshot.
        if flight is not None and getattr(flight, "context_fn", None) is None:
            flight.context_fn = self._flight_context
        self.prewarm_s: float | None = None
        self.stats = {"requests": 0, "batches": 0, "pad_slots": 0,
                      "compile_hit": 0, "compile_miss": 0, "retries": 0,
                      "bisects": 0, "shed": 0, "deadline_expired": 0,
                      "quarantined": 0, "failed": 0, "nonfinite": 0,
                      "cancelled": 0, "degraded_requests": 0,
                      "scheduler_crashes": 0, "rta_rescued": 0,
                      "background_requests": 0, "background_batches": 0,
                      "background_shed": 0, "background_yields": 0,
                      "chunks_executed": 0, "lanes_joined": 0,
                      "lanes_vacated": 0, "backlog_extra_chunks": 0}
        # bucket key -> the bucket's runner (the captured program is the
        # step program's, cached process-wide by parallel.ensemble).
        self._execs: dict[_buckets.BucketKey, Any] = {}
        # Continuous-mode state: chunk runners and lane tables are keyed
        # by STATIC CONFIG (one chunk program serves every horizon of
        # it); tables are scheduler-thread-only.
        self._chunk_execs: dict[swarm.Config, Any] = {}
        self._tables: dict[swarm.Config, _LaneTable] = {}
        self._bg_tables: dict[swarm.Config, _LaneTable] = {}
        # The cooperative background tenant (attach_background), or None.
        self._bg_tenant = None
        self._ids = itertools.count()
        self._batch_ids = itertools.count()
        self._lock = lockwitness.make_lock("ServeEngine._lock")
        self._cond = lockwitness.make_condition("ServeEngine._cond",
                                                self._lock)
        # Leaf lock for the stats dict: `_count` is reached both from
        # caller paths that already hold `_cond` (cancel, submit-shed)
        # and from the bare scheduler thread, so the stats guard must be
        # a SEPARATE lock — reusing `_lock` would deadlock the former.
        self._stats_lock = lockwitness.make_lock("ServeEngine._stats_lock")
        # bucket key -> list of (PendingRequest, cfg, traced, enqueue_t,
        # deadline_t); times are on the tracer's monotonic clock
        # (tracer.now()); deadline_t is None when the request has none.
        self._queue: dict[_buckets.BucketKey, list] = {}
        # The background tier's queue (same entry tuples), kept as a
        # SEPARATE dict so every foreground-depth consumer — degrade
        # watermarks, shed depth checks, queue_depth telemetry — excludes
        # background work by construction rather than by filtering.
        self._bg_queue: dict[_buckets.BucketKey, list] = {}
        self._thread: threading.Thread | None = None
        self._running = False
        # Preemption notice (SIGTERM): the signal handler ONLY sets this
        # event; the drain itself runs in normal control flow (the
        # scheduler thread, or stop()). _preempt_poll_s bounds the
        # scheduler's condition wait once a handler is installed, so the
        # notice is observed without the handler touching any lock.
        self._preempt = lockwitness.make_event("ServeEngine._preempt")
        self._preempt_poll_s: float | None = None
        # Jitter rng (seeded) + breaker state, all host-side.
        self._rng = np.random.default_rng(self.fault_policy.seed)
        self._sig_breakers: dict[str, resilience.CircuitBreaker] = {}
        self._bucket_breakers: dict[
            _buckets.BucketKey, resilience.CircuitBreaker] = {}
        self._degraded = False
        self._overload_since: float | None = None
        # First fencing rejection observed on this engine's journal (a
        # newer epoch took over — we are the zombie); the CLI exits
        # EXIT_FENCED on it instead of being restarted.
        self.fenced: resilience.FencedError | None = None
        # Persisted resilience state (quarantine table + circuit-breaker
        # state) lives beside the journal and survives restarts: a
        # poison signature must not re-burn its full quarantine
        # threshold after every crash. Saved atomically on every breaker
        # change; restored here when the journal has an on-disk path.
        # Bucket breakers persist keyed by LABEL (BucketKey is not
        # serializable) and are adopted lazily by `_bucket_breaker`.
        self._restored_bucket_breakers: dict[
            str, resilience.CircuitBreaker] = {}
        jpath = getattr(self.journal, "path", None)
        self._resilience_path = f"{jpath}.resilience" if jpath else None
        if self._resilience_path and os.path.exists(self._resilience_path):
            self._load_resilience()

    # -- telemetry helpers -------------------------------------------------

    def _bump(self, name: str, v: int = 1) -> None:
        """Bump a stats-dict entry under the stats leaf lock. The stats
        dict is written from the scheduler thread, caller threads and
        the cancel path concurrently."""
        with self._stats_lock:
            self.stats[name] = self.stats.get(name, 0) + v

    def _count(self, name: str, v: int = 1) -> None:
        """Bump a resilience stat and its registry counter (when the
        telemetry sink carries one). The registry counter is bumped
        OUTSIDE the stats lock: MetricsRegistry is caller-serialized and
        holding `_stats_lock` across it would put foreign code inside
        the leaf region."""
        self._bump(name, v)
        reg = getattr(self.telemetry, "registry", None)
        if reg is not None:
            reg.counter(f"serve.{name}").add(v)

    def _emit(self, event_type: str, payload: dict) -> None:
        if self.telemetry is not None:
            self.telemetry.event(event_type, payload)

    # -- buckets / programs ------------------------------------------------

    def bucket_of(self, cfg: swarm.Config):
        """(BucketKey, traced) under this engine's ladder/quantum."""
        return _buckets.bucket_key(cfg, sizes=self.bucket_sizes,
                                   horizon_quantum=self.horizon_quantum)

    def _dummy_batch(self, key: _buckets.BucketKey):
        return _pack.dummy_batch(key, self.max_batch, device=self.device)

    def _executable(self, key: _buckets.BucketKey):
        """Get-or-capture the bucket's batch program, counting hits and
        misses into the shared profiling event registry. Call under
        ``_PROGRAM_LOCK``. The capture ("compile") prepares the
        program on a dummy batch (`ensemble.prepare_traced_rollout`: on
        the card a warm-up step and the CUDA graph capture; a program an
        earlier engine of this process captured is reused) and keeps the
        runner; its wall is ``serve.compile_ms[...]``."""
        runner = self._execs.get(key)
        if runner is not None:
            self._bump("compile_hit")
            profiling.add_event_count(f"serve.executable_hit[{key.label()}]")
            return runner
        self._bump("compile_miss")
        profiling.add_event_count(f"serve.executable_miss[{key.label()}]")
        t0 = time.perf_counter()
        program = ensemble.prepare_traced_rollout(
            key.static_cfg, key.horizon, *self._dummy_batch(key))
        runner = ensemble.lockstep_traced_rollout(key.static_cfg,
                                                  key.horizon)
        runner.analysis = program.analysis
        _sync(self.device)
        wall = time.perf_counter() - t0
        profiling.add_event_count(f"serve.compile_ms[{key.label()}]",
                                  int(wall * 1000))
        self._execs[key] = runner
        label = key.label()
        if self.cost_model is not None:
            self.cost_model.record_compile(label, runner, wall)
        record_exec = getattr(self.telemetry, "record_executable", None)
        if record_exec is not None:
            from cbf_tpu_torch.obs import resource as _resource

            record_exec(label, _resource.analyze_compiled(runner))
        return runner

    def _chunk_executable(self, static_cfg: swarm.Config):
        """Get-or-capture the static config's CHUNK runner (continuous
        mode): `lockstep_traced_chunk` at this engine's ``chunk_steps``,
        shared across every horizon of the config (the per-lane horizon
        bound is a mask). Call under ``_PROGRAM_LOCK``. The capture
        prepares the program on a dummy batch of the chunk's bucket
        (`ensemble.prepare_traced_rollout` at horizon ``chunk_steps`` —
        the very program the chunk runner replays, so a drain bucket of
        that horizon shares it); its wall is ``serve.compile_ms[<chunk
        label>]``. The runner never donates: a failed chunk retries from
        the same carry."""
        runner = self._chunk_execs.get(static_cfg)
        label = _buckets.chunk_label(static_cfg, self.chunk_steps)
        if runner is not None:
            self._bump("compile_hit")
            profiling.add_event_count(f"serve.executable_hit[{label}]")
            return runner
        self._bump("compile_miss")
        profiling.add_event_count(f"serve.executable_miss[{label}]")
        t0 = time.perf_counter()
        ckey = _buckets.BucketKey(static_cfg, self.chunk_steps)
        program = ensemble.prepare_traced_rollout(
            static_cfg, self.chunk_steps, *self._dummy_batch(ckey))
        runner = ensemble.lockstep_traced_chunk(static_cfg,
                                                self.chunk_steps)
        runner.analysis = program.analysis
        _sync(self.device)
        wall = time.perf_counter() - t0
        profiling.add_event_count(f"serve.compile_ms[{label}]",
                                  int(wall * 1000))
        self._chunk_execs[static_cfg] = runner
        if self.cost_model is not None:
            self.cost_model.record_compile(label, runner, wall)
        record_exec = getattr(self.telemetry, "record_executable", None)
        if record_exec is not None:
            from cbf_tpu_torch.obs import resource as _resource

            record_exec(label, _resource.analyze_compiled(runner))
        return runner

    def prewarm(self, configs) -> float:
        """Capture every bucket the given request configs map to AND
        execute each distinct program once on a dummy batch (startup
        cost paid before traffic), after packing each config once (the
        per-request pack path's first run: a continuous engine seeds a
        lane table and joins one lane). A continuous engine prewarms
        CHUNK programs — one per distinct static config, not per
        horizon. Returns — and records — the total prewarm wall. Each
        process captures its own programs (module docstring)."""
        t0 = time.perf_counter()
        warmed: set = set()
        for cfg in configs:
            key, traced = self.bucket_of(cfg)
            with _PROGRAM_LOCK:
                if self.continuous:
                    scfg = key.static_cfg
                    runner = self._chunk_executable(scfg)
                    table = _pack.seed_lane_table(key, cfg, self.max_batch,
                                                  device=self.device)
                    _pack.join_lane(table, 0, _pack.padded_initial_state(
                        cfg, key, device=self.device))
                    if scfg not in warmed:
                        warmed.add(scfg)
                        ckey = _buckets.BucketKey(scfg, self.chunk_steps)
                        runner(*self._dummy_batch(ckey),
                               np.zeros(self.max_batch, np.int32))
                else:
                    runner = self._executable(key)
                    _pack.stack_batch(key, [cfg], [traced], self.max_batch,
                                      device=self.device)
                    if key not in warmed:
                        warmed.add(key)
                        runner(*self._dummy_batch(key))
                _sync(self.device)
        self.prewarm_s = round(time.perf_counter() - t0, 3)
        profiling.add_event_count("serve.prewarm_ms",
                                  int(self.prewarm_s * 1000))
        return self.prewarm_s

    def manifest_extra(self) -> dict:
        """Telemetry-manifest attribution block (cache dir, ladder,
        prewarmed buckets + their capture counters live in the manifest's
        compile_event_counts snapshot via utils.profiling). The fault
        policy and the resilience counters (retries/shed/quarantine/...)
        are snapshotted here so a run's recovery activity is auditable
        from its manifest alone."""
        return {"serve": {
            "cache_dir": self.cache_dir,
            "max_batch": self.max_batch,
            "flush_deadline_s": self.flush_deadline_s,
            "bucket_sizes": list(self.bucket_sizes),
            "horizon_quantum": self.horizon_quantum,
            "prewarm_s": self.prewarm_s,
            "continuous": self.continuous,
            "chunk_steps": self.chunk_steps,
            "buckets": sorted(k.label() for k in self._execs),
            "chunk_buckets": sorted(
                _buckets.chunk_label(c, self.chunk_steps)
                for c in self._chunk_execs),
            "fault_policy": dataclasses.asdict(self.fault_policy),
            "fault_stats": {k: self.stats[k] for k in (
                "retries", "bisects", "shed", "deadline_expired",
                "quarantined", "failed", "nonfinite", "cancelled",
                "degraded_requests", "scheduler_crashes",
                "rta_rescued", "background_requests",
                "background_batches", "background_shed",
                "background_yields", "chunks_executed",
                "lanes_joined", "lanes_vacated")},
            "cost_model_drift": (self.cost_model.drift_summary()
                                 if self.cost_model is not None else None),
        }}

    # -- breakers ----------------------------------------------------------

    def _note_fenced(self, err: resilience.FencedError) -> None:
        """Remember the first fencing rejection. First-wins under the
        stats leaf lock (callers arrive from the scheduler thread and
        from resolving foreground threads); any fence observation means
        the same thing — a newer epoch owns the journal and this
        process must stand down."""
        with self._stats_lock:
            if self.fenced is None:
                self.fenced = err

    def _bucket_breaker(self, key: _buckets.BucketKey, create: bool = False):
        """Bucket-breaker lookup with lazy adoption of restored state:
        persisted bucket breakers are keyed by label (a BucketKey does
        not serialize), so a key's first lookup adopts its label's
        restored breaker. Caller holds ``self._lock``."""
        br = self._bucket_breakers.get(key)
        if br is None and self._restored_bucket_breakers:
            br = self._restored_bucket_breakers.pop(key.label(), None)
            if br is not None:
                self._bucket_breakers[key] = br
        if br is None and create:
            br = resilience.CircuitBreaker(
                self.fault_policy.breaker_threshold,
                self.fault_policy.quarantine_cooldown_s)
            self._bucket_breakers[key] = br
        return br

    def _load_resilience(self) -> None:
        """Restore the quarantine table + breaker state persisted by a
        previous process (clock-rebased: `CircuitBreaker.from_state`
        maps remaining cooldowns onto THIS process's tracer clock, and a
        persisted half-open breaker restores ready to admit exactly one
        fresh probe). An unreadable state file starts cold — restoring
        fault memory is never worth refusing to serve."""
        import json

        try:
            with open(self._resilience_path) as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            return
        now = self.tracer.now()
        try:
            for sig, st in data.get("signatures", {}).items():
                self._sig_breakers[sig] = \
                    resilience.CircuitBreaker.from_state(st, now)
            for label, st in data.get("buckets", {}).items():
                self._restored_bucket_breakers[label] = \
                    resilience.CircuitBreaker.from_state(st, now)
        except (KeyError, TypeError, ValueError):
            self._sig_breakers.clear()
            self._restored_bucket_breakers.clear()

    def _save_resilience(self) -> None:
        """Persist quarantine + breaker state atomically (write-temp +
        rename) beside the journal. Called on every breaker CHANGE —
        strike, open, close — so the on-disk failure counts never lag a
        crash. Best-effort: a full disk must not take down serving."""
        path = self._resilience_path
        if path is None:
            return
        import json

        now = self.tracer.now()
        with self._lock:
            buckets = {k.label(): b.to_state(now)
                       for k, b in self._bucket_breakers.items()}
            for label, b in self._restored_bucket_breakers.items():
                buckets.setdefault(label, b.to_state(now))
            data = {"schema": 1,
                    "signatures": {s: b.to_state(now)
                                   for s, b in self._sig_breakers.items()},
                    "buckets": buckets}
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(data, fh, sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except OSError:
            pass

    def _record_offender(self, cfg: swarm.Config, bucket_label: str) -> None:
        """One execution failure attributed to THIS request's signature
        (poison/repeat-offender accounting); opens the signature's
        quarantine breaker at the policy threshold."""
        policy = self.fault_policy
        sig = resilience.request_signature(cfg)
        now = self.tracer.now()
        with self._lock:
            br = self._sig_breakers.setdefault(
                sig, resilience.CircuitBreaker(
                    policy.quarantine_threshold,
                    policy.quarantine_cooldown_s))
            opened = br.record_failure(now)
            failures = br.failures
        self._save_resilience()   # every strike counts across restarts
        if opened:
            self._emit("serve.quarantine", {
                "scope": "request", "signature": sig, "state": "open",
                "failures": failures, "bucket": bucket_label})
            self._flight_trip(
                "serve.quarantine",
                f"signature {sig} quarantined after {failures} failures "
                f"in bucket {bucket_label}", cfg=cfg)

    def _flight_trip(self, reason: str, detail: str,
                     cfg: swarm.Config | None = None,
                     expect: str = "violates") -> None:
        """Trip the attached flight recorder (no-op without one); the
        offending config, when known, rides along as a verify-corpus
        replay stanza."""
        if self.flight is None:
            return
        request = None
        if cfg is not None:
            from cbf_tpu_torch.obs import flight as obs_flight

            try:
                request = obs_flight.request_stanza(cfg, expect=expect)
            except Exception:
                request = None
        self.flight.trip(reason, detail, request=request)

    def _flight_context(self) -> dict:
        """The "what was running" snapshot every flight capsule embeds
        (`FlightRecorder.context_fn`): foreground queue depth plus the
        lane ledger's in-flight table view and last-W chunk records
        (None without a ledger). Lock-free by design — it runs inside a
        trip, possibly on a thread already deep in engine locks, so it
        must never block."""
        try:
            queue_depth = sum(len(v) for v in list(self._queue.values()))
        except RuntimeError:
            queue_depth = None
        led = self.lanes
        return {
            "continuous": self.continuous,
            "queue_depth": queue_depth,
            "lane_ledger": led.snapshot() if led is not None else None,
        }

    def _record_signature_success(self, cfg: swarm.Config,
                                  bucket_label: str) -> None:
        """Close a half-open signature breaker on a successful probe.
        No-op (one dict truthiness check) while no signature has ever
        failed — the fault-free path stays unmeasurable."""
        if not self._sig_breakers:
            return
        sig = resilience.request_signature(cfg)
        with self._lock:
            br = self._sig_breakers.get(sig)
            changed = br is not None and (br.failures != 0
                                          or br.state != "closed")
            recovered = br.record_success() if br is not None else False
        if changed:
            self._save_resilience()
        if recovered:
            self._emit("serve.quarantine", {
                "scope": "request", "signature": sig, "state": "closed",
                "failures": 0, "bucket": bucket_label})

    # -- execution ---------------------------------------------------------

    def _execute(self, key: _buckets.BucketKey, entries) -> None:
        """Run one micro-batch (1..max_batch queue entries) and resolve
        every member's PendingRequest — with a result, or with a typed
        error (`serve.resilience`); never silently. Deadline-expired
        members are dropped before the batch touches the executor. Every
        lifecycle phase is spanned on ``self.tracer``: per-request
        queue_wait (recorded retroactively from the enqueue stamp), then
        batch-level pack / compile|executable_hit / execute / unpack,
        then per-request resolve."""
        tracer = self.tracer
        label = key.label()
        now = tracer.now()
        alive = []
        for entry in entries:
            pending, _cfg, _tr, t_enq, deadline_t = entry
            if deadline_t is not None and now >= deadline_t:
                self._count("deadline_expired")
                self._emit("serve.shed", {
                    "request_id": pending.request_id, "bucket": label,
                    "reason": "deadline", "queue_depth": self._queue_depth(),
                    "predicted_bytes": None})
                pending._resolve(error=resilience.DeadlineExceeded(
                    f"request {pending.request_id} missed its deadline after "
                    f"{now - t_enq:.3f}s queued", request_id=pending.request_id,
                    bucket=label))
                continue
            alive.append(entry)
        if not alive:
            return
        if self.journal is not None:
            try:
                # Breadcrumb, not a commit point: batch formation is
                # re-derivable at recovery, so no fsync.
                self.journal.packed(label, [e[0].request_id for e in alive])
            except resilience.FencedError as fe:
                # A takeover fenced this epoch while the batch was in
                # flight. These entries already left the queue, so the
                # scheduler's crash guard would never resolve them —
                # resolve each with the typed fence error here (the new
                # owner replays them from its own journal epoch) instead
                # of executing a batch whose terminal records could
                # never land.
                self._note_fenced(fe)
                for pending, *_rest in alive:
                    pending._resolve(error=fe)
                return
        t_exec_start = tracer.now()
        for pending, _cfg, _tr, t_enq, _d in alive:
            tracer.record("queue_wait", t0_s=t_enq,
                          dur_s=t_exec_start - t_enq,
                          trace_id=pending.request_id, bucket=label)
        self._run_batch(key, alive, t_exec_start)

    def _run_batch(self, key: _buckets.BucketKey, entries,
                   t_exec_start: float, attempt: int = 0) -> None:
        """Pack/compile/execute one batch attempt; on failure, hand off
        to `_on_batch_failure` (retry with backoff, bisect, or resolve
        the offender with its error)."""
        policy = self.fault_policy
        tracer = self.tracer
        label = key.label()
        batch_id = f"b{next(self._batch_ids)}"
        hook = self.fault_hook
        degraded = self._degraded
        phase = "compile"
        failure = None
        # Capture, pack and replay under the process-wide program lock
        # (module docstring); the recovery ladder runs outside it.
        with _PROGRAM_LOCK:
            try:
                if hook is not None:
                    hook(key, entries, attempt, "compile")
                hit = key in self._execs
                with tracer.span("executable_hit" if hit else "compile",
                                 trace_id=batch_id, bucket=label):
                    runner = self._executable(key)
                phase = "pack"
                cfgs = [e[1] for e in entries]
                traced = [e[2] for e in entries]
                with tracer.span("pack", trace_id=batch_id, bucket=label):
                    states, traced_b, steps_b = _pack.stack_batch(
                        key, cfgs, traced, self.max_batch,
                        device=self.device)
                if degraded:
                    # The degradation lever: steps rides as a per-lane
                    # horizon mask, so capping it shrinks solver work
                    # WITHOUT a new capture (any static budget knob would
                    # change the bucket and force one).
                    if self.degrade_hook is not None:
                        steps_b = self.degrade_hook(key, steps_b)
                    else:
                        cap = max(1, int(round(
                            key.horizon * policy.degrade_steps_frac)))
                        steps_b = torch.clamp(
                            torch.as_tensor(steps_b), max=cap).to(
                                torch.int32)
                phase = "execute"
                if hook is not None:
                    hook(key, entries, attempt, "execute")
                t0 = time.perf_counter()
                with tracer.span("execute", trace_id=batch_id,
                                 bucket=label):
                    final_states, outs = runner(states, traced_b, steps_b)
                    _sync(self.device)
                execute_s = time.perf_counter() - t0
            except BaseException as e:
                failure = e
        if failure is not None:
            self._on_batch_failure(key, entries, t_exec_start, attempt,
                                   phase, failure)
            return
        recovered = False
        bchanged = False
        with self._lock:
            bbr = self._bucket_breaker(key)
            if bbr is not None:
                bchanged = bbr.failures != 0 or bbr.state != "closed"
                recovered = bbr.record_success()
        if bchanged:
            self._save_resilience()
        if recovered:
            self._emit("serve.quarantine", {
                "scope": "bucket", "signature": label, "state": "closed",
                "failures": 0, "bucket": label})
        # One copy per leaf for the whole batch; trim_result then slices
        # each request's rows on the host.
        with _PROGRAM_LOCK, tracer.span("unpack", trace_id=batch_id,
                                        bucket=label):
            final_states = _to_host(final_states)
            outs = _to_host(outs)
            steps_np = _to_host(steps_b) if degraded else None
        self._bump("batches")
        self._bump("pad_slots", self.max_batch - len(entries))
        if self.cost_model is not None:
            obs = self.cost_model.observe_execute(label, execute_s)
            cost = self.cost_model.cost_of(label)
            if obs["drift"] is not None:
                reg = getattr(self.telemetry, "registry", None)
                if reg is not None:
                    reg.gauge("serve.cost_model.drift").set(obs["drift"])
            self._emit("serve.cost", {
                "bucket": label, "batch_fill": len(entries),
                "execute_s": round(execute_s, 6),
                "predicted_s": obs["predicted_s"],
                "drift": (None if obs["drift"] is None
                          else round(obs["drift"], 6)),
                "flops": cost.get("flops", 0),
                "bytes_accessed": cost.get("bytes_accessed", 0),
                "peak_bytes": cost.get("peak_bytes", 0)})
        for slot, (pending, cfg, _tr, t_enq, _d) in enumerate(entries):
            with tracer.span("resolve", trace_id=pending.request_id,
                             bucket=label):
                eff_steps = int(steps_np[slot]) if degraded else cfg.steps
                final, outs_i = _pack.trim_result(final_states, outs, slot,
                                                  cfg.n, eff_steps)
                if policy.check_finite and not _all_finite(final, outs_i):
                    # Vmapped lanes are independent: this slot's poison
                    # cannot have infected its batch-mates, so only this
                    # request fails (blast-radius isolation), and its
                    # signature takes a quarantine strike.
                    self._count("nonfinite")
                    if policy.rta_fallback and not cfg.rta \
                            and self._rta_rescue(pending, cfg, label,
                                                 t_enq, t_exec_start):
                        continue
                    self._count("failed")
                    self._record_offender(cfg, label)
                    self._flight_trip(
                        "serve.nonfinite",
                        f"request {pending.request_id} unpacked non-finite "
                        f"state/outputs in bucket {label}", cfg=cfg)
                    pending._resolve(error=resilience.NonFiniteResult(
                        f"request {pending.request_id} unpacked non-finite "
                        f"state/outputs in bucket {label}",
                        request_id=pending.request_id, bucket=label))
                    continue
                self._record_signature_success(cfg, label)
                rta_ch = outs_i.rta_mode
                rta_engaged = not isinstance(rta_ch, tuple) \
                    and bool(np.max(np.asarray(rta_ch), initial=0) > 0)
                now = tracer.now()
                result = RequestResult(
                    request_id=pending.request_id, bucket=label,
                    n=cfg.n, steps=eff_steps, final_state=final,
                    outputs=outs_i, latency_s=round(now - t_enq, 6),
                    queue_wait_s=round(t_exec_start - t_enq, 6),
                    execute_s=round(execute_s, 6), batch_fill=len(entries),
                    degraded=degraded, rta_engaged=rta_engaged)
                self._bump("requests")
                if degraded:
                    self._count("degraded_requests")
                if self.telemetry is not None:
                    self.telemetry.event("request", {
                        "request_id": result.request_id,
                        "bucket": result.bucket, "n": cfg.n,
                        "steps": eff_steps,
                        "latency_s": result.latency_s,
                        "queue_wait_s": result.queue_wait_s,
                        "execute_s": result.execute_s,
                        "batch_fill": result.batch_fill,
                        "degraded": int(degraded),
                        "rta_engaged": int(rta_engaged),
                        "min_pairwise_distance": float(
                            np.min(outs_i.min_pairwise_distance)),
                        "infeasible_count": int(
                            np.sum(outs_i.infeasible_count)),
                        "ttfp_s": None,
                    })
                pending._resolve(result=result)

    def _rta_rescue(self, pending, cfg: swarm.Config, from_label: str,
                    t_enq: float, t_exec_start: float) -> bool:
        """Runtime-assurance rescue of one non-finite request: re-run
        it ALONE under ``replace(cfg, rta=True)`` so the in-rollout
        fallback ladder (`cbf_tpu_torch.rta`) absorbs the fault and the caller
        gets a degraded completion (``RequestResult.rta_engaged``)
        instead of a `NonFiniteResult`. The rescue bucket is distinct
        (rta knobs are static), so the first rescue per bucket costs a
        capture. Returns True once the rescue batch has resolved the
        request — with a result, or (if even the ladder cannot keep the
        lane finite) its own typed error. Terminates: the rescue cfg has
        ``rta=True``, which is never rescued again."""
        try:
            rescue_cfg = dataclasses.replace(cfg, rta=True)
            key, traced = self.bucket_of(rescue_cfg)
        except (ValueError, TypeError):
            return False   # cfg does not validate under rta: fail normally
        self._count("rta_rescued")
        self._emit("serve.retry", {
            "bucket": from_label, "action": "rta_rescue", "attempt": 0,
            "batch_size": 1, "backoff_s": 0.0,
            "error": "NonFiniteResult"})
        self._run_batch(key, [(pending, rescue_cfg, traced, t_enq, None)],
                        t_exec_start, attempt=self.fault_policy.max_retries)
        return True

    def _on_batch_failure(self, key: _buckets.BucketKey, entries,
                          t_exec_start: float, attempt: int, phase: str,
                          error: BaseException) -> None:
        """Recovery ladder for one failed batch attempt:

        1. transient error with retry budget left -> backoff (seeded
           jitter) and re-run the whole batch;
        2. multi-request batch failing in pack/execute -> bisect: run
           the halves separately (retry budget spent — halves bisect
           straight down to the offender instead of re-backing-off);
        3. single request -> resolve with the error and charge its
           signature's quarantine breaker;
        4. compile-phase failure -> the bucket itself is broken (no
           request is at fault): resolve ALL members and charge the
           bucket breaker.
        """
        policy = self.fault_policy
        label = key.label()
        if resilience.is_retryable(error) and attempt < policy.max_retries:
            backoff = policy.backoff_s(attempt, self._rng)
            self._count("retries")
            self._emit("serve.retry", {
                "bucket": label, "action": "retry", "attempt": attempt + 1,
                "batch_size": len(entries), "backoff_s": round(backoff, 4),
                "error": type(error).__name__})
            time.sleep(backoff)
            self._run_batch(key, entries, t_exec_start, attempt + 1)
            return
        if phase != "compile" and len(entries) > 1:
            self._count("bisects")
            self._emit("serve.retry", {
                "bucket": label, "action": "bisect", "attempt": attempt,
                "batch_size": len(entries), "backoff_s": 0.0,
                "error": type(error).__name__})
            mid = len(entries) // 2
            self._run_batch(key, entries[:mid], t_exec_start,
                            policy.max_retries)
            self._run_batch(key, entries[mid:], t_exec_start,
                            policy.max_retries)
            return
        if phase == "compile":
            now = self.tracer.now()
            with self._lock:
                bbr = self._bucket_breaker(key, create=True)
                opened = bbr.record_failure(now)
                failures = bbr.failures
            self._save_resilience()
            if opened:
                self._emit("serve.quarantine", {
                    "scope": "bucket", "signature": label, "state": "open",
                    "failures": failures, "bucket": label})
                self._flight_trip(
                    "serve.breaker",
                    f"bucket {label} breaker opened after {failures} "
                    f"compile failures ({type(error).__name__})")
            for pending, *_ in entries:
                self._count("failed")
                pending._resolve(error=error)
            return
        pending, cfg, *_ = entries[0]
        self._count("failed")
        self._record_offender(cfg, label)
        pending._resolve(error=error)

    # -- synchronous drain -------------------------------------------------

    def run(self, configs, request_ids=None) -> list[RequestResult]:
        """Serve a request list synchronously: bucket, batch (order-
        preserving within a bucket), execute, return results in request
        order. Offline mode has no deadlines or admission control (the
        caller IS the queue), but retries/bisection/finite-checking
        apply; a failed request raises its typed error here.

        With a journal attached, each request's ``submitted`` record is
        durable before its batch runs and its terminal record before
        ``result()`` returns — same WAL contract as queue mode.
        ``request_ids`` (parallel to ``configs``) preserves identities
        across a recovery replay (the CLI's ``serve --recover`` path);
        default: fresh ``r<i>`` ids."""
        if request_ids is not None and len(request_ids) != len(configs):
            raise ValueError(
                f"request_ids has {len(request_ids)} entries for "
                f"{len(configs)} configs")
        entries_by_key: dict[_buckets.BucketKey, list] = {}
        pendings = []
        for i, cfg in enumerate(configs):
            rid = request_ids[i] if request_ids is not None \
                else f"r{next(self._ids)}"
            pending = PendingRequest(rid)
            pending._engine = self
            with self.tracer.span("enqueue", trace_id=pending.request_id):
                key, traced = self.bucket_of(cfg)
                if self.journal is not None:
                    pending._journal = self.journal
                    self.journal.submitted(pending.request_id, cfg)
                pendings.append(pending)
                if self.flight is not None:
                    self.flight.note_request(cfg, pending.request_id)
                entries_by_key.setdefault(key, []).append(
                    (pending, cfg, traced, self.tracer.now(), None))
        for key, entries in entries_by_key.items():
            for i in range(0, len(entries), self.max_batch):
                self._execute(key, entries[i:i + self.max_batch])
        return [p.result(timeout=0) for p in pendings]

    # -- queue mode --------------------------------------------------------

    def start(self) -> None:
        t = threading.Thread(target=self._scheduler_loop,
                             name="serve-scheduler", daemon=True)
        with self._lock:
            if self._running:
                return
            self._running = True
            # Publish the handle under the lock: a concurrent stop()
            # must never observe _running=True with _thread still None.
            self._thread = t
        t.start()

    def _queue_depth(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._queue.values())

    def submit(self, cfg: swarm.Config, request_id: str | None = None,
               deadline_s: float | None = None,
               priority: str = "foreground") -> PendingRequest:
        """Enqueue one request (queue mode; call `start()` first). The
        bucket flushes when max_batch requests accumulate or after
        flush_deadline_s, whichever comes first.

        Admission control runs here: a quarantined signature or bucket
        fails fast with `QuarantinedError`; a full bounded queue
        (``fault_policy.queue_limit``) sheds per the policy —
        ``reject-newest`` raises `ShedError`, ``reject-oldest`` evicts
        the globally oldest queued request (ITS handle resolves with
        `ShedError`) to admit this one. With a cost model attached and
        ``fault_policy.queue_bytes_budget`` set, admission is sized in
        predicted device bytes instead of counts: the request sheds
        (always reject-newest) when `CostModel.fits` says its predicted
        peak bytes exceed the budget's remaining headroom — fail-open
        when the shape is unpriced. ``deadline_s`` (default: the
        policy's) stamps a deadline after which the request fails fast
        with `DeadlineExceeded` instead of occupying an executor slot.

        ``priority`` selects the admission tier (`resilience.PRIORITIES`).
        Background requests queue separately: they never count toward
        foreground depth (shed checks, degrade watermarks), are shed
        FIRST when a foreground submit hits the queue limit, always
        reject-newest when their own tier is full (they never evict
        foreground work), and dispatch only while no foreground work is
        runnable — at most one background batch per scheduler pass."""
        policy = self.fault_policy
        if priority not in resilience.PRIORITIES:
            raise ValueError(
                f"priority must be one of {resilience.PRIORITIES}, got "
                f"{priority!r}")
        background = priority == "background"
        pending = PendingRequest(request_id or f"r{next(self._ids)}")
        pending._priority = priority
        post_events: list[tuple[str, dict]] = []
        evicted = None
        with self.tracer.span("enqueue", trace_id=pending.request_id):
            key, traced = self.bucket_of(cfg)   # validates before enqueueing
            label = key.label()
            now = self.tracer.now()
            dl = deadline_s if deadline_s is not None else policy.deadline_s
            deadline_t = now + dl if dl is not None else None
            fail: BaseException | None = None
            with self._cond:
                if not self._running:
                    raise RuntimeError("engine not started — call start() "
                                       "(or use run() for a one-shot drain)")
                if self._sig_breakers:
                    sig = resilience.request_signature(cfg)
                    br = self._sig_breakers.get(sig)
                    if br is not None and not br.allow(now):
                        self._count("quarantined")
                        fail = resilience.QuarantinedError(
                            f"request signature {sig} is quarantined "
                            f"({br.failures} failures; state {br.state})",
                            request_id=pending.request_id, bucket=label)
                if fail is None:
                    bbr = self._bucket_breaker(key)
                    if bbr is not None and not bbr.allow(now):
                        self._count("quarantined")
                        fail = resilience.QuarantinedError(
                            f"bucket {label} is quarantined "
                            f"({bbr.failures} compile failures; state "
                            f"{bbr.state})",
                            request_id=pending.request_id, bucket=label)
                if fail is None and policy.queue_limit is not None:
                    # queue_limit bounds the engine's TOTAL occupancy
                    # (both tiers). Over the limit, background pays
                    # first: a background submit is refused outright (it
                    # never evicts anyone — soak work is re-offered from
                    # persistent fleet state, so a shed costs only
                    # time), and a foreground submit evicts the oldest
                    # background entry before the shed policy can touch
                    # any foreground request.
                    depth = sum(len(v) for v in self._queue.values()) \
                        + sum(len(v) for v in self._bg_queue.values())
                    if depth >= policy.queue_limit and background:
                        self._count("shed")
                        self._count("background_shed")
                        post_events.append(("serve.shed", {
                            "request_id": pending.request_id,
                            "bucket": label,
                            "reason": "background_queue_full",
                            "queue_depth": depth,
                            "predicted_bytes": None}))
                        fail = resilience.ShedError(
                            f"queue full ({depth}/{policy.queue_limit}) "
                            f"— background request {pending.request_id} "
                            "shed", request_id=pending.request_id,
                            bucket=label)
                    elif depth >= policy.queue_limit and self._bg_queue:
                        bg_key = min(
                            (k for k, es in self._bg_queue.items() if es),
                            key=lambda k: self._bg_queue[k][0][3],
                            default=None)
                        if bg_key is not None:
                            evicted = self._bg_queue[bg_key].pop(0)
                            if not self._bg_queue[bg_key]:
                                del self._bg_queue[bg_key]
                            self._count("shed")
                            self._count("background_shed")
                            post_events.append(("serve.shed", {
                                "request_id": evicted[0].request_id,
                                "bucket": bg_key.label(),
                                "reason": "background_evicted",
                                "queue_depth": depth,
                                "predicted_bytes": None}))
                    elif depth >= policy.queue_limit:
                        if policy.shed_policy == "reject-newest":
                            self._count("shed")
                            post_events.append(("serve.shed", {
                                "request_id": pending.request_id,
                                "bucket": label, "reason": "queue_full",
                                "queue_depth": depth,
                                "predicted_bytes": None}))
                            fail = resilience.ShedError(
                                f"queue full ({depth}/{policy.queue_limit}) "
                                f"— request {pending.request_id} shed",
                                request_id=pending.request_id, bucket=label)
                        else:   # reject-oldest: evict to admit the new one
                            oldest_key, oldest_idx = None, None
                            oldest_t = None
                            for k, es in self._queue.items():
                                if es and (oldest_t is None
                                           or es[0][3] < oldest_t):
                                    oldest_key, oldest_idx = k, 0
                                    oldest_t = es[0][3]
                            evicted = self._queue[oldest_key].pop(oldest_idx)
                            self._count("shed")
                            post_events.append(("serve.shed", {
                                "request_id": evicted[0].request_id,
                                "bucket": oldest_key.label(),
                                "reason": "oldest_evicted",
                                "queue_depth": depth,
                                "predicted_bytes": None}))
                if fail is None and policy.queue_bytes_budget is not None \
                        and self.cost_model is not None:
                    # Cost-model admission (the PR 11 sizing replacing a
                    # hand-tuned count bound): shed when the request's
                    # predicted device peak bytes would push the queued
                    # total over the budget. FAIL-OPEN on unpriced
                    # shapes — fits() admits anything the model cannot
                    # price, and unpriced queued entries count 0 bytes.
                    # Always reject-newest: eviction cannot free a
                    # knowable number of bytes when entries may be
                    # unpriced.
                    memo: dict[int, int] = {}

                    def _pred(nb: int) -> int:
                        if nb not in memo:
                            memo[nb] = self.cost_model.predict_peak_bytes(nb)
                        return memo[nb]

                    queued_bytes = sum(
                        _pred(k.n) * len(es)
                        for qm in (self._queue, self._bg_queue)
                        for k, es in qm.items() if es)
                    headroom = max(0, policy.queue_bytes_budget
                                   - queued_bytes)
                    if not self.cost_model.fits(key.n,
                                                budget_bytes=headroom):
                        depth = sum(len(v) for v in self._queue.values()) \
                            + sum(len(v) for v in self._bg_queue.values())
                        self._count("shed")
                        if background:
                            self._count("background_shed")
                        post_events.append(("serve.shed", {
                            "request_id": pending.request_id,
                            "bucket": label, "reason": "bytes_budget",
                            "queue_depth": depth,
                            "predicted_bytes": _pred(key.n) or None}))
                        fail = resilience.ShedError(
                            f"queue bytes budget exhausted "
                            f"({queued_bytes} + {_pred(key.n)} predicted "
                            f"> {policy.queue_bytes_budget}) — request "
                            f"{pending.request_id} shed",
                            request_id=pending.request_id, bucket=label)
                if fail is None:
                    pending._engine, pending._key = self, key
                    if self.journal is not None:
                        # Durable acknowledgment, written UNDER the queue
                        # lock: the scheduler cannot flush (and journal a
                        # `resolved`) before this `submitted` is on disk.
                        # A refused request (shed/quarantined above) is
                        # never journaled — it was never acknowledged.
                        pending._journal = self.journal
                        self.journal.submitted(pending.request_id, cfg)
                    qmap = self._bg_queue if background else self._queue
                    qmap.setdefault(key, []).append(
                        (pending, cfg, traced, now, deadline_t))
                    if background:
                        self._count("background_requests")
                    self._cond.notify()
        for etype, payload in post_events:
            self._emit(etype, payload)
        if evicted is not None:
            ev_pending = evicted[0]
            how = ("shed first as background"
                   if ev_pending._priority == "background"
                   else "evicted by reject-oldest")
            ev_pending._resolve(error=resilience.ShedError(
                f"request {ev_pending.request_id} {how} under queue "
                "pressure", request_id=ev_pending.request_id))
        if fail is not None:
            raise fail
        if self.flight is not None:
            self.flight.note_request(cfg, pending.request_id)
        return pending

    def stop(self, drain: bool = True) -> None:
        """Stop the scheduler; by default flush whatever is queued
        first (graceful SIGTERM drain: every acknowledged request still
        resolves — with a result or a typed error — and, when
        journaling, gets its terminal record before this returns)."""
        with self._cond:
            self._running = False
            self._cond.notify()
            t = self._thread
            self._thread = None
        if t is not None:
            # Join OUTSIDE the lock — the scheduler needs it to exit.
            t.join()
        if drain:
            if self.continuous:
                # Finish through the chunk machinery: a continuous stop
                # must not capture full-horizon drain programs just to
                # flush what the lane tables can already finish.
                self._finish_continuous()
            else:
                self._drain_leftovers()
        if self.cost_model is not None:
            # Flush measured execute EWMAs/drift (record_compile saves at
            # compile time, but observations accrue between saves).
            try:
                self.cost_model.save()
            except OSError:
                pass

    def _drain_leftovers(self) -> None:
        """The graceful-drain body: stop admissions, pop everything still
        queued, and execute it to resolution. Runs in NORMAL control
        flow only — the caller of stop(), or the scheduler thread after
        a SIGTERM notice — never inside a signal handler, which must not
        join threads, run batches, or re-enter a journal append it may
        have interrupted mid-write."""
        leftovers = []
        with self._lock:
            self._running = False
            # Foreground drains before background — same precedence as
            # live scheduling, so a drain cannot delay an acknowledged
            # foreground request behind soak work.
            for qmap in (self._queue, self._bg_queue):
                for key in sorted(qmap, key=lambda k: k.label()):
                    entries = qmap[key]
                    while entries:
                        leftovers.append((key, entries[:self.max_batch]))
                        del entries[:self.max_batch]
                qmap.clear()
        if self._preempt.is_set():
            self._flight_trip(
                "sigterm.drain",
                f"SIGTERM drain: {sum(len(b) for _, b in leftovers)} "
                "queued requests flushed to resolution")
        for key, batch in leftovers:
            self._execute(key, batch)

    # -- durable execution -------------------------------------------------

    def recover(self, journal_path: str) -> list:
        """Re-enqueue every acknowledged-but-unresolved request from a
        previous process's write-ahead journal (at-least-once recovery:
        see `cbf_tpu_torch.durable.journal`). Call after `start()`; the engine
        should itself be journaling — usually to the same path — so the
        recovered requests' outcomes are journaled too. Returns the
        re-enqueued `PendingRequest` handles."""
        from cbf_tpu_torch.durable.journal import recover_into

        return recover_into(self, journal_path)

    def install_sigterm_handler(self):
        """Register a SIGTERM handler that turns a preemption notice
        into a graceful drain, so every queued request resolves before
        the process dies; a SIGKILL (no notice) instead relies on the
        journal + `recover`. The handler itself only sets the preempt
        flag — draining means joining the scheduler, running batches,
        and fsyncing journal records, none of which belongs inside a
        signal handler (it can fire mid `_append`, between write and
        fsync). The drain runs from normal control flow: the scheduler
        thread observes the flag (queue mode — it drains and exits, so
        pending `result()` calls unblock), while a synchronous `run()`
        simply keeps executing to completion on the main thread instead
        of dying to the default SIGTERM action. Main-thread only
        (signal module constraint); returns the previous handler."""
        import signal

        # Bound the scheduler's idle wait so the flag is observed even
        # when it is parked in an open-ended cond.wait: the handler
        # cannot safely notify (the main thread may already hold the
        # non-reentrant queue lock when the signal fires).
        self._preempt_poll_s = 0.05
        with self._cond:
            self._cond.notify()   # re-park any open-ended wait, bounded

        def _notice(signum, frame):
            self._preempt.set()
            if self._cond.acquire(blocking=False):   # opportunistic wake
                try:
                    self._cond.notify()
                finally:
                    self._cond.release()

        return signal.signal(signal.SIGTERM, _notice)

    # -- background tenancy ------------------------------------------------

    def attach_background(self, tenant) -> None:
        """Attach a cooperative background tenant (the falsification
        fleet's serve-idle mode). Protocol:

        - ``tenant.next_unit() -> callable | None`` — one unit of
          background work (roughly one candidate batch), or None when
          the tenant is idle. Called only while the foreground tier is
          fully idle (no runnable batch, empty queue) and no queued
          background batch is ready.
        - ``tenant.on_preempt(queue_depth) -> None`` — a pulled unit
          was DROPPED un-run because foreground work arrived between
          the pull and the dispatch.

        Units must be idempotent offers: the scheduler may drop one
        without running it (the tenant re-derives the same work next
        pull). A tenant whose ``next_unit``/unit raises is detached —
        a broken tenant must not crash the scheduler and strand
        foreground requests. Pass None to detach explicitly."""
        with self._cond:
            self._bg_tenant = tenant
            self._cond.notify()

    def _scan_bg_queue(self, now: float):
        """Under ``self._lock``: pop at most ONE flush-ready background
        batch (full, or oldest member past ``flush_deadline_s``) —
        one-per-pass is the yield guarantee: between any two background
        dispatches the scheduler re-scans the foreground tier. Returns
        ``(batch_or_None, next_deadline)``."""
        next_deadline = None
        for key, entries in self._bg_queue.items():
            if len(entries) >= self.max_batch:
                batch = entries[:self.max_batch]
                del entries[:self.max_batch]
                return (key, batch), None
            if entries:
                deadline = entries[0][3] + self.flush_deadline_s
                if deadline <= now:
                    batch = entries[:]
                    entries.clear()
                    return (key, batch), None
                if next_deadline is None or deadline < next_deadline:
                    next_deadline = deadline
        return None, next_deadline

    # -- scheduler ---------------------------------------------------------

    def _scan_queue(self, now: float):
        """Under ``self._lock``: pop every flush-ready batch (full, or
        oldest member past ``flush_deadline_s``). Returns
        ``(to_run, next_deadline)``; factored out of the loop so the
        crash guard has a seam to test against."""
        to_run, next_deadline = [], None
        for key, entries in self._queue.items():
            while len(entries) >= self.max_batch:
                to_run.append((key, entries[:self.max_batch]))
                del entries[:self.max_batch]
            if entries:
                deadline = entries[0][3] + self.flush_deadline_s
                if deadline <= now:
                    to_run.append((key, entries[:]))
                    entries.clear()
                elif (next_deadline is None
                        or deadline < next_deadline):
                    next_deadline = deadline
        return to_run, next_deadline

    def _update_degrade(self, now: float):
        """Under ``self._lock``: track sustained overload and flip the
        degraded flag. Returns a ("enter"|"exit", depth) transition for
        the caller to emit outside the lock, or None."""
        policy = self.fault_policy
        hw = policy.degrade_high_watermark
        if hw is None:
            return None
        depth = sum(len(v) for v in self._queue.values())
        if not self._degraded:
            if depth > hw:
                if self._overload_since is None:
                    self._overload_since = now
                elif now - self._overload_since >= policy.degrade_sustain_s:
                    self._degraded = True
                    return ("enter", depth)
            else:
                self._overload_since = None
        elif depth <= policy.degrade_low_watermark:
            self._degraded = False
            self._overload_since = None
            return ("exit", depth)
        return None

    def _scheduler_loop(self) -> None:
        """Crash-guarded wrapper: any exception escaping the scheduler
        body resolves every queued request — and, in continuous mode,
        every in-flight lane — with `SchedulerCrashed` instead of
        stranding them forever on a silently dead thread."""
        try:
            if self.continuous:
                self._scheduler_body_continuous()
            else:
                self._scheduler_body()
        except BaseException as e:   # noqa: BLE001 — the guard IS the point
            self._on_scheduler_crash(e)

    def _scheduler_body(self) -> None:
        while True:
            transition = None
            preempted = False
            bg_batch = None
            want_tenant = False
            with self._cond:
                if not self._running:
                    return
                preempted = self._preempt.is_set()
                if not preempted:
                    now = self.tracer.now()  # same clock as enqueue
                    transition = self._update_degrade(now)
                    to_run, next_deadline = self._scan_queue(now)
                    # Background dispatches only from a fully idle
                    # foreground tier: no runnable batch AND an empty
                    # queue (a partial foreground batch waiting on its
                    # flush deadline still outranks soak work).
                    fg_idle = not to_run and not any(self._queue.values())
                    if fg_idle and transition is None:
                        bg_batch, bg_deadline = self._scan_bg_queue(now)
                        if bg_batch is None and bg_deadline is not None \
                                and (next_deadline is None
                                     or bg_deadline < next_deadline):
                            next_deadline = bg_deadline
                        want_tenant = bg_batch is None \
                            and self._bg_tenant is not None
                    if not to_run and transition is None \
                            and bg_batch is None and not want_tenant:
                        timeout = None if next_deadline is None \
                            else max(next_deadline - now, 1e-3)
                        poll = self._preempt_poll_s
                        if poll is not None:
                            timeout = poll if timeout is None \
                                else min(timeout, poll)
                        self._cond.wait(timeout)
                        continue
            if preempted:
                # SIGTERM notice: the handler only set the flag; the
                # drain happens HERE, in the scheduler's own (normal)
                # control flow, then the thread exits.
                self._drain_leftovers()
                return
            if transition is not None:
                state, depth = transition
                self._emit("serve.degrade", {
                    "state": state, "queue_depth": depth,
                    "steps_frac": self.fault_policy.degrade_steps_frac})
            for key, batch in to_run:
                self._execute(key, batch)
            if bg_batch is not None:
                key, batch = bg_batch
                self._count("background_batches")
                self._execute(key, batch)
            elif want_tenant:
                self._run_tenant_unit()

    # -- continuous batching -----------------------------------------------

    def _scheduler_body_continuous(self) -> None:
        """The continuous-batching loop. Each pass: (1) under the queue
        lock, pop joinable foreground entries (deadline-expired ones
        drop); (2) outside it, scatter the joins into lane tables and
        advance every occupied foreground table ONE chunk — completions
        resolve, in-flight lanes stream partials; (3) only when the
        foreground tier is fully idle, give the background tier one
        table-chunk or one tenant unit. Preemption granularity is thus
        one CHUNK: a
        foreground arrival waits at most one chunk's device wall, never
        a background rollout's full horizon."""
        while True:
            transition = None
            preempted = False
            joins, expired = [], []
            bg_joins, bg_expired = [], []
            want_tenant = False
            bg_active = False
            deep = False
            with self._cond:
                if not self._running:
                    return
                preempted = self._preempt.is_set()
                if not preempted:
                    now = self.tracer.now()  # same clock as enqueue
                    transition = self._update_degrade(now)
                    joins, expired = self._pop_joinable(
                        now, self._queue, self._tables)
                    # Deep backlog: requests STILL queued after the join
                    # scan (tables full) past the high watermark — the
                    # regime where multi-chunk bursts pay.
                    hw = self.fault_policy.degrade_high_watermark
                    fg_depth = sum(len(v) for v in self._queue.values())
                    deep = (hw is not None and self.backlog_chunks > 1
                            and fg_depth > hw)
                    fg_active = bool(joins) or any(
                        t.occupied() for t in self._tables.values())
                    fg_idle = not fg_active \
                        and not any(self._queue.values())
                    if fg_idle and transition is None:
                        bg_joins, bg_expired = self._pop_joinable(
                            now, self._bg_queue, self._bg_tables)
                        bg_active = bool(bg_joins) or any(
                            t.occupied() for t in self._bg_tables.values())
                        want_tenant = not bg_active \
                            and self._bg_tenant is not None
                    if not fg_active and not expired \
                            and transition is None and not bg_active \
                            and not bg_expired and not want_tenant:
                        self._cond.wait(self._preempt_poll_s)
                        continue
            if preempted:
                self._flight_trip(
                    "sigterm.drain",
                    "SIGTERM drain (continuous): joining and advancing "
                    "lanes to resolution")
                self._finish_continuous()
                return
            if transition is not None:
                state, depth = transition
                self._emit("serve.degrade", {
                    "state": state, "queue_depth": depth,
                    "steps_frac": self.fault_policy.degrade_steps_frac})
            self._apply_joins(joins, expired, self._tables)
            advanced = False
            for scfg, table in list(self._tables.items()):
                if table.occupied():
                    self._advance_table(
                        table,
                        chunks=self.backlog_chunks if deep else 1)
                    advanced = True
                if not table.occupied():
                    self._tables.pop(scfg, None)
                # Refill between table chunks: lanes this advance just
                # vacated — and arrivals that landed during its device
                # wall — join NOW, not a full pass of every other
                # table's chunk later.
                with self._cond:
                    if not self._running:
                        return
                    j2, e2 = self._pop_joinable(
                        self.tracer.now(), self._queue, self._tables)
                self._apply_joins(j2, e2, self._tables)
            if advanced:
                # Foreground ran, so any background table holding live
                # lanes was denied the device this pass — the ledger's
                # preempted-lane accounting (`B` in the live bitmaps).
                led = self.lanes
                if led is not None:
                    for btab in list(self._bg_tables.values()):
                        slots = btab.live_slots()
                        if slots:
                            led.note_preempted(btab.label,
                                               len(btab.lanes), slots)
                continue
            # Foreground fully idle this pass: the background tier gets
            # at most ONE table-chunk (or one tenant unit) before the
            # foreground queue is re-scanned.
            self._apply_joins(bg_joins, bg_expired, self._bg_tables)
            bg_ran = False
            for scfg, table in list(self._bg_tables.items()):
                if table.occupied() and not bg_ran:
                    self._count("background_batches")
                    self._advance_table(table, background=True)
                    bg_ran = True
                if not table.occupied():
                    self._bg_tables.pop(scfg, None)
            if not bg_ran and want_tenant:
                self._run_tenant_unit()

    def _pop_joinable(self, now: float, qmap, tables):
        """Under ``self._lock``: pop queue entries that can JOIN a free
        lane of their static config's table (capacity-bounded — an entry
        with no free lane stays queued for the next chunk boundary).
        Deadline-expired entries pop unconditionally. Returns
        ``(joins, expired)``, both lists of ``(key, entry)``."""
        joins, expired = [], []
        free: dict = {}
        for key in sorted(qmap, key=lambda k: k.label()):
            entries = qmap[key]
            scfg = key.static_cfg
            if scfg not in free:
                table = tables.get(scfg)
                free[scfg] = self.max_batch if table is None \
                    else table.free_lanes()
            while entries:
                entry = entries[0]
                if entry[4] is not None and now >= entry[4]:
                    expired.append((key, entries.pop(0)))
                    continue
                if free[scfg] <= 0:
                    break
                free[scfg] -= 1
                joins.append((key, entries.pop(0)))
            if not entries:
                del qmap[key]
        return joins, expired

    def _apply_joins(self, joins, expired, tables) -> None:
        """Resolve the deadline-expired pops and scatter the joinable
        ones into lane tables. Runs OUTSIDE the queue lock (tables are
        scheduler-thread state); each join's device work (the padded
        initial state, the lane scatter) runs under ``_PROGRAM_LOCK``,
        as a drain batch's pack does."""
        policy = self.fault_policy
        for key, (pending, _cfg, _tr, t_enq, _d) in expired:
            now = self.tracer.now()
            self._count("deadline_expired")
            self._emit("serve.shed", {
                "request_id": pending.request_id, "bucket": key.label(),
                "reason": "deadline", "queue_depth": self._queue_depth(),
                "predicted_bytes": None})
            pending._resolve(error=resilience.DeadlineExceeded(
                f"request {pending.request_id} missed its deadline after "
                f"{now - t_enq:.3f}s queued",
                request_id=pending.request_id, bucket=key.label()))
        if not joins:
            return
        by_scfg: dict = {}
        for key, entry in joins:
            by_scfg.setdefault(key.static_cfg, []).append((key, entry))
        for scfg, items in by_scfg.items():
            label = _buckets.chunk_label(scfg, self.chunk_steps)
            if self.journal is not None:
                try:
                    # Breadcrumb, not a commit point (same as drain's
                    # packed record): lane assignment is re-derivable.
                    self.journal.packed(
                        label, [it[1][0].request_id for it in items])
                except resilience.FencedError as fe:
                    # A takeover fenced this epoch mid-join: these
                    # entries already left the queue, so resolve them
                    # with the typed fence error (the new owner replays
                    # them from its own journal epoch).
                    self._note_fenced(fe)
                    for _k, (pending, *_rest) in items:
                        pending._resolve(error=fe)
                    continue
            table = tables.get(scfg)
            if table is None:
                table = _LaneTable(scfg, self.chunk_steps, self.max_batch,
                                   self.device)
                tables[scfg] = table
            now = self.tracer.now()
            for key, (pending, cfg, traced, t_enq, deadline_t) in items:
                eff = cfg.steps
                degraded = self._degraded
                if degraded:
                    # Same lever as drain: the horizon cap rides the
                    # mask, so degradation never captures anew.
                    cap = max(1, int(round(
                        key.horizon * policy.degrade_steps_frac)))
                    eff = min(eff, cap)
                with _PROGRAM_LOCK:
                    table.join(key, pending, cfg, traced, t_enq,
                               deadline_t, now, eff, degraded)
                self._count("lanes_joined")
                if self.lanes is not None:
                    self.lanes.note_join(label)
                self.tracer.record("queue_wait", t0_s=t_enq,
                                   dur_s=now - t_enq,
                                   trace_id=pending.request_id,
                                   bucket=label)

    def _vacate(self, table: _LaneTable, slot: int) -> None:
        led = self.lanes
        if led is not None:
            lane = table.lanes[slot]
            if lane is not None:
                led.note_vacate(table.label,
                                max(0.0, self.tracer.now() - lane.t_join))
        table.vacate(slot)
        self._count("lanes_vacated")

    def _advance_table(self, table: _LaneTable, *, background=False,
                       attempt: int = 0, chunks: int = 1) -> None:
        """Advance one lane table by up to ``chunks`` chunks.

        The scheduler passes ``chunks=1`` in the normal regime — join
        latency stays one chunk. Under deep backlog (foreground queue
        depth past the degrade high watermark) it passes
        ``backlog_chunks``: every joinable request is already queued
        behind a full table, so re-scanning joins between chunks buys
        nothing. The burst stops early the moment the table drains or a
        chunk fails, so no lane is ever held past resolution. Extra
        chunks run under ``stats["backlog_extra_chunks"]``."""
        for i in range(max(1, chunks)):
            ok = self._advance_table_once(
                table, background=background,
                attempt=attempt if i == 0 else 0)
            if i and ok:
                self._count("backlog_extra_chunks")
            if not ok or not table.occupied():
                return

    def _advance_table_once(self, table: _LaneTable, *, background=False,
                            attempt: int = 0) -> bool:
        """Advance one lane table by ONE chunk. Deadline-expired lanes
        LEAVE first (vacating only zeroes their mask bound — batch-
        mates' rows are untouched); the chunk program then runs over all
        lanes (vacant ones frozen); the chunk's outputs reach the host in
        one copy, and each completed lane's final state in one copy of
        its own slot; completed lanes resolve immediately and in-flight
        lanes stream ``serve.partial``. The capture, replay and copies
        run under ``_PROGRAM_LOCK``; the recovery ladder and the resolves
        outside it. Failure hands off to `_on_chunk_failure` and returns
        False (a retried-then-successful chunk also returns False: after
        any failure the caller's burst yields back to the scheduler)."""
        tracer = self.tracer
        label = table.label
        now0 = tracer.now()
        for slot in table.live_slots():
            lane = table.lanes[slot]
            if lane.deadline_t is not None and now0 >= lane.deadline_t:
                self._count("deadline_expired")
                self._emit("serve.shed", {
                    "request_id": lane.pending.request_id,
                    "bucket": label, "reason": "deadline",
                    "queue_depth": self._queue_depth(),
                    "predicted_bytes": None})
                lane.pending._resolve(error=resilience.DeadlineExceeded(
                    f"request {lane.pending.request_id} missed its "
                    f"deadline mid-flight after "
                    f"{now0 - lane.t_enq:.3f}s",
                    request_id=lane.pending.request_id, bucket=label))
                self._vacate(table, slot)
        live = table.live_slots()
        if not live:
            return False
        chunk_id = f"c{next(self._batch_ids)}"
        # Lane-ledger chunk window: integer nanoseconds, opened here
        # (first device-touching work) and closed after the per-slot
        # resolve loop so dispatch_ns captures ALL non-execute chunk
        # cost.
        led = self.lanes
        if led is not None:
            t_chunk0 = tracer.now()
            w0 = time.perf_counter_ns()
        hook = self.fault_hook
        hook_key = _buckets.BucketKey(table.static_cfg, table.chunk)
        hook_entries = [(table.lanes[i].pending, table.lanes[i].cfg,
                         table.lanes[i].traced, table.lanes[i].t_enq,
                         table.lanes[i].deadline_t) for i in live]
        # Each live lane's steps this chunk, from its clock before it.
        done_before = {slot: int(table.t_np[slot]) for slot in live}
        k_of = {slot: max(0, min(table.chunk, table.lanes[slot].eff_steps
                                 - done_before[slot])) for slot in live}
        failure = None
        with _PROGRAM_LOCK:
            try:
                if hook is not None:
                    hook(hook_key, hook_entries, attempt, "compile")
                hit = table.static_cfg in self._chunk_execs
                with tracer.span("executable_hit" if hit else "compile",
                                 trace_id=chunk_id, bucket=label):
                    runner = self._chunk_executable(table.static_cfg)
                if led is not None:
                    p0 = time.perf_counter_ns()
                with tracer.span("pack", trace_id=chunk_id, bucket=label):
                    traced_b = table.stacked_traced()
                    steps_b = np.array(table.steps_np)
                    t0_b = np.array(table.t_np)
                pack_ns = time.perf_counter_ns() - p0 \
                    if led is not None else 0
                if hook is not None:
                    hook(hook_key, hook_entries, attempt, "execute")
                t0 = time.perf_counter()
                with tracer.span("execute", trace_id=chunk_id,
                                 bucket=label):
                    final_states, outs = runner(table.states, traced_b,
                                                steps_b, t0_b)
                    _sync(self.device)
                execute_s = time.perf_counter() - t0
            except BaseException as e:   # noqa: BLE001 — ladder classifies
                failure = e
            if failure is None:
                if led is not None:
                    u0 = time.perf_counter_ns()
                # One copy of the chunk's outputs; each completed lane's
                # final state crosses as its own slot only.
                with tracer.span("unpack", trace_id=chunk_id,
                                 bucket=label):
                    outs_host = _to_host(outs)
                    parts = {slot: _pack.slice_lane_chunk(
                        outs_host, slot, k_of[slot]) for slot in live}
                    finished = {
                        slot: _pack.assemble_lane_result(
                            final_states,
                            table.lanes[slot].parts + [parts[slot]], slot,
                            table.lanes[slot].cfg.n)
                        for slot in live if done_before[slot] + k_of[slot]
                        >= table.lanes[slot].eff_steps}
                unpack_ns = time.perf_counter_ns() - u0 \
                    if led is not None else 0
        if failure is not None:
            # Outside the program lock: a demotion runs drain batches,
            # which take it themselves.
            self._on_chunk_failure(table, attempt, failure,
                                   background=background)
            return False
        # The carry crosses the chunk boundary on the device (solver warm
        # state included): the table keeps the chunk's new tensors.
        table.states = final_states
        self._count("chunks_executed")
        if self.cost_model is not None:
            obs = self.cost_model.observe_execute(label, execute_s)
            cost = self.cost_model.cost_of(label)
            if obs["drift"] is not None:
                reg = getattr(self.telemetry, "registry", None)
                if reg is not None:
                    reg.gauge("serve.cost_model.drift").set(obs["drift"])
            self._emit("serve.cost", {
                "bucket": label, "batch_fill": len(live),
                "execute_s": round(execute_s, 6),
                "predicted_s": obs["predicted_s"],
                "drift": (None if obs["drift"] is None
                          else round(obs["drift"], 6)),
                "flops": cost.get("flops", 0),
                "bytes_accessed": cost.get("bytes_accessed", 0),
                "peak_bytes": cost.get("peak_bytes", 0)})
        now = tracer.now()
        fill = len(live)
        lane_rows = []
        for slot in live:
            lane = table.lanes[slot]
            k_i = k_of[slot]
            if led is not None:
                # Row captured BEFORE resolve/vacate clears the lane.
                lane_rows.append((slot, lane.pending.request_id, k_i,
                                  max(0.0, now - lane.t_join)))
            part = parts[slot]
            lane.parts.append(part)
            lane.execute_s += execute_s
            table.t_np[slot] = done_before[slot] + table.chunk
            steps_done = done_before[slot] + k_i
            if self.partial_hook is not None:
                try:
                    self.partial_hook(lane.pending.request_id,
                                      steps_done, part)
                except Exception:
                    self.partial_hook = None
            if slot in finished:
                self._resolve_lane(table, slot, *finished[slot], fill, now)
                self._vacate(table, slot)
            else:
                if lane.ttfp_s is None:
                    lane.ttfp_s = round(now - lane.t_enq, 6)
                self._emit("serve.partial", {
                    "request_id": lane.pending.request_id,
                    "bucket": label, "steps_done": steps_done,
                    "steps_total": lane.eff_steps, "chunk": table.chunk,
                    "min_pairwise_distance": float(
                        np.min(part.min_pairwise_distance)),
                    "infeasible_count": int(
                        np.sum(part.infeasible_count))})
        if led is not None:
            # Close the chunk window and stamp the ledger. execute_ns is
            # clamped into the wall window so the dispatch complement
            # (total - vacancy - live*execute) can never go negative and
            # the integer accounting identity holds exactly.
            wall_ns = max(time.perf_counter_ns() - w0, 1)
            execute_ns = min(int(execute_s * 1e9), wall_ns)
            led.note_chunk(
                chunk_id, label, lanes=len(table.lanes),
                chunk_steps=table.chunk, lane_rows=lane_rows,
                wall_ns=wall_ns, execute_ns=execute_ns, pack_ns=pack_ns,
                unpack_ns=unpack_ns, background=background, t_s=t_chunk0)
            # Per-lane Perfetto tracks: one "chunk" span per live lane,
            # keyed to a stable "<bucket>/lane<slot>" track so a
            # request's JOIN -> chunks -> LEAVE renders as one timeline
            # row, flow-linked back to its enqueue span.
            dur_s = wall_ns / 1e9
            for slot, request_id, _k, _age in lane_rows:
                tracer.record("chunk", t0_s=t_chunk0, dur_s=dur_s,
                              trace_id=request_id, bucket=label,
                              track=f"{label}/lane{slot}")
        return True

    def _resolve_lane(self, table: _LaneTable, slot: int, final, outs_i,
                      fill: int, now: float) -> None:
        """Resolve one COMPLETED lane from its host result (``final``,
        ``outs_i``: `serve.pack.assemble_lane_result` at request shapes):
        finite-check and resolve the handle — the continuous twin of the
        drain path's per-slot resolve."""
        lane = table.lanes[slot]
        policy = self.fault_policy
        label = table.label
        cfg = lane.cfg
        pending = lane.pending
        with self.tracer.span("resolve", trace_id=pending.request_id,
                              bucket=label):
            if policy.check_finite and not _all_finite(final, outs_i):
                # Lanes are independent: only this lane fails.
                self._count("nonfinite")
                if policy.rta_fallback and not cfg.rta \
                        and self._rta_rescue(pending, cfg, label,
                                             lane.t_enq, lane.t_join):
                    return
                self._count("failed")
                self._record_offender(cfg, label)
                self._flight_trip(
                    "serve.nonfinite",
                    f"request {pending.request_id} unpacked non-finite "
                    f"state/outputs in lane table {label}", cfg=cfg)
                pending._resolve(error=resilience.NonFiniteResult(
                    f"request {pending.request_id} unpacked non-finite "
                    f"state/outputs in lane table {label}",
                    request_id=pending.request_id, bucket=label))
                return
            self._record_signature_success(cfg, label)
            rta_ch = outs_i.rta_mode
            rta_engaged = not isinstance(rta_ch, tuple) \
                and bool(np.max(np.asarray(rta_ch), initial=0) > 0)
            result = RequestResult(
                request_id=pending.request_id, bucket=label, n=cfg.n,
                steps=lane.eff_steps, final_state=final, outputs=outs_i,
                latency_s=round(now - lane.t_enq, 6),
                queue_wait_s=round(lane.t_join - lane.t_enq, 6),
                execute_s=round(lane.execute_s, 6), batch_fill=fill,
                degraded=lane.degraded, rta_engaged=rta_engaged,
                ttfp_s=lane.ttfp_s)
            self._bump("requests")
            if lane.degraded:
                self._count("degraded_requests")
            if self.telemetry is not None:
                self.telemetry.event("request", {
                    "request_id": result.request_id,
                    "bucket": result.bucket, "n": cfg.n,
                    "steps": lane.eff_steps,
                    "latency_s": result.latency_s,
                    "queue_wait_s": result.queue_wait_s,
                    "execute_s": result.execute_s,
                    "batch_fill": result.batch_fill,
                    "degraded": int(lane.degraded),
                    "rta_engaged": int(rta_engaged),
                    "min_pairwise_distance": float(
                        np.min(outs_i.min_pairwise_distance)),
                    "infeasible_count": int(
                        np.sum(outs_i.infeasible_count)),
                    "ttfp_s": lane.ttfp_s,
                })
            # TTFP through the registry surface (metrics.prom/json), not
            # just the per-request event stream / loadgen report.
            reg = getattr(self.telemetry, "registry", None)
            if reg is not None and lane.ttfp_s is not None:
                reg.histogram("serve.ttfp_s").observe(lane.ttfp_s)
                reg.histogram(f"serve.ttfp_s[{label}]").observe(lane.ttfp_s)
            pending._resolve(result=result)

    def _on_chunk_failure(self, table: _LaneTable, attempt: int,
                          error: BaseException, *,
                          background=False) -> None:
        """Per-chunk recovery ladder (called outside ``_PROGRAM_LOCK``).
        Transient with budget left -> backoff and re-run the SAME chunk
        (the table's carry is intact: the chunk program never writes it).
        Otherwise DEMOTE: every live lane re-runs SOLO from step 0
        through the drain path, which owns the bisect-to-offender /
        quarantine / bucket-breaker machinery — blast radius stays one
        request, and a poisoned lane cannot wedge the whole table."""
        policy = self.fault_policy
        label = table.label
        live = table.live_slots()
        if resilience.is_retryable(error) and attempt < policy.max_retries:
            backoff = policy.backoff_s(attempt, self._rng)
            self._count("retries")
            self._emit("serve.retry", {
                "bucket": label, "action": "retry",
                "attempt": attempt + 1, "batch_size": len(live),
                "backoff_s": round(backoff, 4),
                "error": type(error).__name__})
            time.sleep(backoff)
            self._advance_table(table, background=background,
                                attempt=attempt + 1)
            return
        self._emit("serve.retry", {
            "bucket": label, "action": "demote", "attempt": attempt,
            "batch_size": len(live), "backoff_s": 0.0,
            "error": type(error).__name__})
        now = self.tracer.now()
        for slot in live:
            lane = table.lanes[slot]
            self._vacate(table, slot)
            try:
                key, traced = self.bucket_of(lane.cfg)
            except (ValueError, TypeError) as e:
                self._count("failed")
                lane.pending._resolve(error=e)
                continue
            self._run_batch(
                key, [(lane.pending, lane.cfg, traced, lane.t_enq,
                       lane.deadline_t)],
                now, attempt=policy.max_retries)

    def _finish_continuous(self) -> None:
        """Run the continuous machinery to quiescence: keep joining
        queued requests into lanes and advancing tables until every
        queue and lane is empty. Normal control flow only — stop()'s
        caller, or the scheduler thread after a SIGTERM notice. Uses
        the same chunk programs as live traffic, so a graceful stop
        never captures a full-horizon drain program."""
        while True:
            with self._cond:
                self._running = False
                now = self.tracer.now()
                joins, expired = self._pop_joinable(
                    now, self._queue, self._tables)
                bg_joins, bg_expired = self._pop_joinable(
                    now, self._bg_queue, self._bg_tables)
            self._apply_joins(joins, expired, self._tables)
            self._apply_joins(bg_joins, bg_expired, self._bg_tables)
            work = False
            for tables in (self._tables, self._bg_tables):
                for scfg, table in list(tables.items()):
                    if table.occupied():
                        self._advance_table(table)
                        work = True
                    if not table.occupied():
                        tables.pop(scfg, None)
            with self._lock:
                queued = any(self._queue.values()) \
                    or any(self._bg_queue.values())
            if not work and not queued:
                return

    def _run_tenant_unit(self) -> None:
        """Pull and run ONE unit of tenant work on the scheduler thread,
        outside the engine's own locks (tenant code is foreign). The pull
        and the dispatch re-check the foreground queue in between: a unit
        pulled just before a foreground arrival is dropped un-run
        (``on_preempt``), which is the tenant-side half of the yield
        guarantee. The unit itself runs under ``_PROGRAM_LOCK``: its
        captures and replays (the fleet's compiled candidate rollouts,
        a found violation's shrink) are device work beside other engines'
        programs in this process, and a CUDA graph capture must not see
        another thread's launches. A raising tenant is detached, never
        re-raised — the crash guard above this loop resolves QUEUED
        requests, and a broken soak tenant is not worth that blast
        radius."""
        tenant = self._bg_tenant
        if tenant is None:
            return
        try:
            unit = tenant.next_unit()
        except Exception:
            self.attach_background(None)
            return
        if unit is None:
            # Tenant idle: park briefly instead of spinning the pull.
            with self._cond:
                if self._running:
                    self._cond.wait(self.flush_deadline_s)
            return
        with self._lock:
            fg_depth = sum(len(v) for v in self._queue.values())
        if fg_depth > 0:
            self._count("background_yields")
            try:
                tenant.on_preempt(fg_depth)
            except Exception:
                self.attach_background(None)
            return
        self._count("background_batches")
        try:
            with _PROGRAM_LOCK:
                unit()
        except Exception:
            self.attach_background(None)

    def _on_scheduler_crash(self, error: BaseException) -> None:
        with self._cond:
            self._running = False
            leftovers = [entry for entries in self._queue.values()
                         for entry in entries]
            leftovers += [entry for entries in self._bg_queue.values()
                          for entry in entries]
            self._queue.clear()
            self._bg_queue.clear()
            # Continuous mode: in-flight lanes are as stranded as queued
            # entries — resolve them too.
            for tables in (self._tables, self._bg_tables):
                for table in tables.values():
                    leftovers += [(lane.pending,)
                                  for lane in table.lanes
                                  if lane is not None]
                tables.clear()
        for pending, *_ in leftovers:
            pending._resolve(error=resilience.SchedulerCrashed(
                f"scheduler thread crashed: {type(error).__name__}: {error}",
                request_id=pending.request_id))
        self._count("scheduler_crashes")
        self._emit("serve.scheduler_crash", {
            "error": f"{type(error).__name__}: {error}",
            "resolved": len(leftovers)})
        self._flight_trip(
            "serve.scheduler_crash",
            f"scheduler thread crashed ({type(error).__name__}: {error}); "
            f"{len(leftovers)} queued requests resolved SchedulerCrashed")
