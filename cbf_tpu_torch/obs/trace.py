"""Request-lifecycle span tracing for the serving layer (counterpart:
cbf_tpu/obs/trace.py, ported whole).

A thread-safe :class:`Tracer` records nested, named spans on monotonic
host clocks (``time.perf_counter`` — wall-clock steps from NTP never
corrupt a duration), keyed by per-request trace ids, and exports them
three ways:

- **Chrome trace-event JSON** (:meth:`Tracer.chrome_trace` /
  :meth:`Tracer.export_chrome_trace`) — load the file in Perfetto or
  ``chrome://tracing`` and see the request lifecycle on a timeline,
  per-thread.
- **JSONL event stream** — one schema-stamped ``serve.span`` event per
  finished span through ``TelemetrySink.event`` (the fields are
  ``obs.schema.SERVE_EVENT_FIELDS["serve.span"]``).
- **Latency histograms** — every span feeds
  ``registry.histogram("serve.phase.<name>_s")`` (and its per-bucket
  twin), so p50/p95/p99 come out of ``Histogram.quantile`` in run
  summaries and ``cbf_tpu_torch obs summary``.

The serve engine's lifecycle phases (:data:`LIFECYCLE_PHASES`):
``enqueue -> queue_wait -> pack -> (compile | executable_hit) ->
execute -> unpack -> resolve``; in the port "compile" is the capture of
the bucket's CUDA graph. Tracing is host-side only — it never enters a
captured program, so rollout outputs are bit-identical with tracing on or
off (pinned by tests/test_torch_serve_engine.py).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

from cbf_tpu_torch.analysis import lockwitness

#: The event types this module emits (together with serve.engine's, they
#: union to obs.schema.SERVE_EVENT_TYPES).
EMITTED_EVENT_TYPES: tuple[str, ...] = ("serve.span",)

#: The serve request lifecycle, in order. Host span names, registry
#: histogram suffixes draw from this vocabulary.
LIFECYCLE_PHASES: tuple[str, ...] = (
    "enqueue", "queue_wait", "pack", "compile", "executable_hit",
    "execute", "unpack", "resolve")


class Span:
    """One finished (or in-flight) span: name + trace identity + start
    offset/duration on the tracer's monotonic clock."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "bucket",
                 "t0_s", "dur_s", "thread", "track")

    def __init__(self, name: str, trace_id: str | None, span_id: int,
                 parent_id: int | None, bucket: str | None,
                 t0_s: float, thread: int, track: str | None = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.bucket = bucket
        self.t0_s = t0_s
        self.dur_s: float | None = None
        self.thread = thread
        # Explicit timeline-row assignment ("<bucket>/lane<slot>" for
        # continuous-mode chunk spans): spans sharing a track render on
        # ONE named Perfetto row instead of their emitting thread's.
        self.track = track


class _SpanContext:
    """Context manager wrapping one live span (nesting via the tracer's
    thread-local stack)."""

    __slots__ = ("_tracer", "span", "_t0_perf")

    def __init__(self, tracer: "Tracer", span: Span, t0_perf: float):
        self._tracer = tracer
        self.span = span
        self._t0_perf = t0_perf

    def __enter__(self):
        self._tracer._push(self.span)
        return self.span

    def __exit__(self, *exc):
        self._tracer._pop(self.span)
        self.span.dur_s = time.perf_counter() - self._t0_perf
        self._tracer._finish(self.span)
        return False


class _NullContext:
    """No-op stand-in when the tracer is disabled or the trace is
    sampled out — same `with ... as span` shape, span is None."""

    span = None

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullContext()


class Tracer:
    """Thread-safe span recorder on one process-local monotonic clock.

    ``sink`` — optional TelemetrySink; every finished span becomes a
    ``serve.span`` JSONL event. ``registry`` — optional MetricsRegistry
    (defaults to the sink's); every span feeds the per-phase (and
    per-bucket) latency histograms. ``enabled=False`` turns every call
    into a no-op (the overhead-control kill switch).
    ``sample_every=k`` records every k-th request trace (batch-level
    spans, 1/B as numerous, are always recorded); the decision is
    deterministic per trace id — no RNG, replay-stable.
    ``max_spans`` bounds in-memory retention for the Chrome export;
    beyond it spans still export to sink/registry but are dropped from
    memory (counted in ``dropped``).
    """

    def __init__(self, *, sink=None, registry=None, enabled: bool = True,
                 sample_every: int = 1, max_spans: int = 100_000):
        self.sink = sink
        self.registry = registry if registry is not None else (
            sink.registry if sink is not None else None)
        self.enabled = enabled
        self.sample_every = max(1, int(sample_every))
        self.max_spans = max_spans
        self.spans: list[Span] = []
        self.dropped = 0
        self._epoch_perf = time.perf_counter()
        self._epoch_wall = time.time()
        self._lock = lockwitness.make_lock("Tracer._lock")
        self._span_ids = itertools.count(1)
        self._local = threading.local()
        self._trace_seq = 0
        self._trace_sampled: dict[str, bool] = {}

    # -- clocks ------------------------------------------------------------

    def now(self) -> float:
        """Seconds since tracer epoch, monotonic — the timestamp domain
        every span start/duration lives in (stamp enqueue times with
        this, hand them back to :meth:`record` later)."""
        return time.perf_counter() - self._epoch_perf

    def wall_of(self, t0_s: float) -> float:
        """Map a tracer-epoch offset back to approximate epoch wall time
        (for correlating spans with t_wall-stamped JSONL events)."""
        return self._epoch_wall + t0_s

    # -- sampling ----------------------------------------------------------

    def sampled(self, trace_id: str | None) -> bool:
        """Deterministic per-trace sampling decision (every k-th new
        trace id records; k = ``sample_every``). Batch-level spans pass
        ``trace_id=None`` and are always recorded."""
        if not self.enabled:
            return False
        if trace_id is None or self.sample_every == 1:
            return True
        with self._lock:
            hit = self._trace_sampled.get(trace_id)
            if hit is None:
                hit = (self._trace_seq % self.sample_every) == 0
                self._trace_seq += 1
                if len(self._trace_sampled) >= 8192:
                    self._trace_sampled.clear()   # bounded memory
                self._trace_sampled[trace_id] = hit
            return hit

    # -- span recording ----------------------------------------------------

    def span(self, name: str, *, trace_id: str | None = None,
             parent_id: int | None = None, bucket: str | None = None):
        """Context manager for one span; nests under the current
        thread's innermost open span unless ``parent_id`` is given."""
        if not self.sampled(trace_id):
            return _NULL
        t0_perf = time.perf_counter()
        if parent_id is None:
            stack = getattr(self._local, "stack", None)
            if stack:
                parent_id = stack[-1].span_id
        span = Span(name, trace_id, next(self._span_ids), parent_id,
                    bucket, t0_perf - self._epoch_perf,
                    threading.get_ident())
        return _SpanContext(self, span, t0_perf)

    def record(self, name: str, *, t0_s: float, dur_s: float,
               trace_id: str | None = None, parent_id: int | None = None,
               bucket: str | None = None,
               track: str | None = None) -> Span | None:
        """Record a span with explicit timestamps (``t0_s`` from
        :meth:`now`) — for phases measured retroactively across threads,
        like queue wait (stamped at enqueue on the caller's thread,
        closed at flush on the scheduler's). ``track`` pins the span to
        a named Perfetto timeline row (per-lane chunk spans)."""
        if not self.sampled(trace_id):
            return None
        span = Span(name, trace_id, next(self._span_ids), parent_id,
                    bucket, t0_s, threading.get_ident(), track)
        span.dur_s = dur_s
        self._finish(span)
        return span

    def _push(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()

    def _finish(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) < self.max_spans:
                self.spans.append(span)
            else:
                self.dropped += 1
        # Track spans (per-lane chunk rows) skip the phase histograms:
        # chunk-time attribution is the lane ledger's job (serve.lanes.*)
        # and lifecycle-phase latency percentiles must not be diluted by
        # per-lane duplicates of the same chunk wall.
        if self.registry is not None and span.track is None:
            self.registry.histogram(
                f"serve.phase.{span.name}_s").observe(span.dur_s)
            if span.bucket is not None:
                self.registry.histogram(
                    f"serve.phase.{span.name}_s[{span.bucket}]").observe(
                        span.dur_s)
        if self.sink is not None:
            self.sink.event("serve.span", {
                "trace_id": span.trace_id, "span_id": span.span_id,
                "parent_id": span.parent_id, "name": span.name,
                "bucket": span.bucket, "t0_s": round(span.t0_s, 6),
                "dur_s": round(span.dur_s, 6), "track": span.track})

    # -- exporters ---------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The recorded spans as a Chrome trace-event JSON object
        (``{"traceEvents": [...]}``, complete-event ``ph="X"``,
        microsecond timestamps) — loadable in Perfetto /
        ``chrome://tracing``. Thread ids are renumbered small so the
        viewer's track names stay readable; track-pinned spans get their
        own NAMED rows, flow-linked back to their request's enqueue (see
        :func:`build_chrome_trace`)."""
        with self._lock:
            spans = list(self.spans)
        records = [{"name": s.name, "trace_id": s.trace_id,
                    "span_id": s.span_id, "parent_id": s.parent_id,
                    "bucket": s.bucket, "t0_s": s.t0_s,
                    "dur_s": s.dur_s or 0.0, "thread": s.thread,
                    "track": s.track} for s in spans]
        return build_chrome_trace(records, epoch_wall=self._epoch_wall,
                                  dropped=self.dropped)

    def export_chrome_trace(self, path: str) -> str:
        """Write :meth:`chrome_trace` to ``path`` and return it."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        return path


def build_chrome_trace(records, *, epoch_wall: float | None = None,
                       dropped: int = 0) -> dict:
    """Chrome trace-event JSON from span RECORDS (dicts with the
    ``serve.span`` event fields, plus an optional ``thread`` key) —
    shared by :meth:`Tracer.chrome_trace` (live spans) and
    ``obs lanes --export-timeline`` (spans replayed from a run
    directory's events.jsonl), so the two timelines cannot diverge.

    Ordinary spans land on renumbered per-thread rows. Spans carrying a
    ``track`` land on one named row per track (``thread_name`` metadata,
    e.g. a continuous lane ``n8/s16/lane3``) so a request's
    JOIN -> chunks -> LEAVE reads as one lane row; for each trace id
    with track spans, a flow arrow (``ph="s"``/``ph="f"``) links its
    earliest enqueue/queue_wait span to its first track span."""
    pid = os.getpid()
    tids: dict = {}
    track_tids: dict[str, int] = {}
    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "tid": 0, "args": {"name": "cbf_tpu_torch serve"}}]

    def _tid(rec) -> int:
        track = rec.get("track")
        if track is not None:
            tid = track_tids.get(track)
            if tid is None:
                tid = track_tids[track] = 1000 + len(track_tids)
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tid,
                               "args": {"name": f"lane {track}"}})
            return tid
        return tids.setdefault(rec.get("thread", 0), len(tids) + 1)

    recs = sorted(records, key=lambda r: r.get("t0_s") or 0.0)
    flow_src: dict = {}    # trace_id -> (end ts us, tid) of enqueue span
    flow_dst: dict = {}    # trace_id -> (start ts us, tid) of 1st track
    for r in recs:
        tid = _tid(r)
        t0_us = round(float(r.get("t0_s") or 0.0) * 1e6, 3)
        dur_us = round(float(r.get("dur_s") or 0.0) * 1e6, 3)
        events.append({
            "name": r.get("name"), "cat": "serve", "ph": "X",
            "ts": t0_us, "dur": dur_us, "pid": pid, "tid": tid,
            "args": {"trace_id": r.get("trace_id"),
                     "span_id": r.get("span_id"),
                     "parent_id": r.get("parent_id"),
                     "bucket": r.get("bucket")},
        })
        trace_id = r.get("trace_id")
        if trace_id is None:
            continue
        if r.get("track") is not None:
            flow_dst.setdefault(trace_id, (t0_us, tid))
        elif r.get("name") in ("enqueue", "queue_wait") \
                and trace_id not in flow_src:
            flow_src[trace_id] = (t0_us + dur_us, tid)
    flow_id = 0
    for trace_id, (dst_ts, dst_tid) in flow_dst.items():
        src = flow_src.get(trace_id)
        if src is None:
            continue
        flow_id += 1
        src_ts, src_tid = src
        events.append({"name": "lane_join", "cat": "flow", "ph": "s",
                       "id": flow_id, "ts": min(src_ts, dst_ts),
                       "pid": pid, "tid": src_tid,
                       "args": {"trace_id": trace_id}})
        events.append({"name": "lane_join", "cat": "flow", "ph": "f",
                       "bp": "e", "id": flow_id, "ts": dst_ts,
                       "pid": pid, "tid": dst_tid,
                       "args": {"trace_id": trace_id}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"epoch_wall": epoch_wall,
                          "dropped_spans": dropped}}
