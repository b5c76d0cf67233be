"""Incident flight recorder: a bounded telemetry ring that dumps a
replayable *incident capsule* when safety machinery fires (counterpart:
cbf_tpu/obs/flight.py, ported whole).

The watchdog, serve resilience ladder, and RTA monitor each emit a
single event at the moment something goes wrong — but one event carries
no surrounding context, and by the time an operator reads it the JSONL
stream has moved on. This module captures *what the system was doing*
when a safety mechanism engaged.

A :class:`FlightRecorder` subscribes to a
:class:`~cbf_tpu_torch.obs.sink.TelemetrySink` (the sink fans out to
subscribers AFTER releasing its write lock, so the recorder may emit
its own event from the callback) and keeps a bounded in-memory ring of
everything on the stream — heartbeats (health word / ``rta_mode``
included), spans, serve/durable/rta lifecycle events — plus the last K
request stanzas noted by the serve engine. When a trigger fires it
writes one capsule directory:

- ``capsule.json`` — trigger reason/detail, environment (torch,
  CUDA, the card, git SHA), registry metrics snapshot, recent request stanzas,
  ring/trigger metadata, and — when a ``context_fn`` seam is installed
  (the serve engine wires its in-flight queue/lane-ledger snapshot) —
  a ``context`` stanza answering "what was running" at trip time, for
  EVERY trip reason.
- ``ring.jsonl`` — the ring contents, oldest first.
- ``costmodel.json`` — the :class:`~cbf_tpu_torch.obs.resource.CostModel`
  snapshot, when the recorder carries one.
- ``request.json`` — the offending request config as a verify-corpus
  compatible replay stanza (``scenario`` / ``overrides`` / ``expect`` /
  ``seed``), so ``cbf_tpu_torch obs incident <dir> --replay`` and the corpus
  loader both understand it.

Triggers (see :func:`FlightRecorder.trip` for the manual path): any
watchdog alert class (``watchdog.<kind>``), serve ``NonFiniteResult`` /
``SchedulerCrashed`` / quarantine or breaker trips (wired in
``serve.engine``), an RTA engagement at rung >= 2 (``rta.engage``
events), and SIGTERM drain. A per-reason cooldown makes each incident
exactly one capsule, not one per repeated alert; capsule-write failures
are counted (``write_failures``) and never propagate — the recorder
must not take down the system it is observing.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any

from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.obs import schema

#: Event types this module emits — equal to
#: ``obs.schema.FLIGHT_EVENT_TYPES``.
EMITTED_EVENT_TYPES: tuple[str, ...] = ("flight.capsule",)

#: Bump when the capsule.json layout changes incompatibly.
FLIGHT_SCHEMA_VERSION = 1

#: Capsule file names.
CAPSULE_FILENAME = "capsule.json"
RING_FILENAME = "ring.jsonl"
REQUEST_FILENAME = "request.json"

#: RTA rung at/above which an engagement trips a capsule (rung 1 is a
#: routine boosted re-solve; rung >= 2 means the nominal controller was
#: abandoned for a backup or scrub — incident-worthy).
RTA_TRIP_RUNG = 2


def request_stanza(cfg, *, request_id: str | None = None,
                   expect: str = "violates") -> dict[str, Any]:
    """A verify-corpus compatible replay stanza for one request config:
    ``scenario`` + non-default ``overrides`` (via
    ``verify.corpus.config_overrides``) + ``expect`` + ``seed``, so the
    captured offender can be rebuilt with ``corpus.rebuild_config`` and
    re-run by ``obs incident --replay`` or enrolled in a corpus."""
    from cbf_tpu_torch.verify import corpus

    return {"schema": corpus.CORPUS_SCHEMA_VERSION, "scenario": "swarm",
            "overrides": corpus.config_overrides(cfg),
            "expect": expect, "seed": int(getattr(cfg, "seed", 0)),
            "request_id": request_id}


class FlightRecorder:
    """Bounded event ring + incident capsule writer.

    ``out_dir`` — capsules are written as ``capsule-NNN-<reason>``
    subdirectories. ``ring_size`` bounds the in-memory event ring;
    ``recent_requests`` bounds the request-stanza ring. ``cooldown_s``
    suppresses repeat capsules for the same reason; ``max_capsules``
    hard-caps capsules per recorder lifetime (an incident storm must not
    fill the disk). ``cost_model`` / ``registry`` enrich capsules when
    given; ``armed=False`` turns every hook into a no-op.
    """

    def __init__(self, out_dir: str, *, ring_size: int = 512,
                 recent_requests: int = 16, cooldown_s: float = 5.0,
                 max_capsules: int = 32, cost_model=None, registry=None,
                 armed: bool = True):
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        self.out_dir = out_dir
        self.cooldown_s = float(cooldown_s)
        self.max_capsules = int(max_capsules)
        self.cost_model = cost_model
        self.registry = registry
        self.armed = armed
        self.ring: collections.deque = collections.deque(maxlen=ring_size)
        self.recent: collections.deque = collections.deque(
            maxlen=recent_requests)
        self.capsules: list[str] = []
        self.write_failures = 0
        self._last_trip: dict[str, float] = {}
        self._lock = lockwitness.make_lock("FlightRecorder._lock")
        self._sink = None
        self._seq = 0
        # "What was running" seam: a zero-arg callable returning a
        # JSON-safe dict, evaluated at EVERY trip (any reason) and
        # embedded as the capsule manifest's "context" key. The serve
        # engine installs its in-flight snapshot (queue depth + lane
        # ledger) here, so continuous-mode capsules are never stale.
        # Must be lock-free/non-blocking; a raising context_fn is
        # recorded as an error marker, never propagated.
        self.context_fn = None

    # -- wiring ------------------------------------------------------------

    def attach(self, sink) -> "FlightRecorder":
        """Subscribe to ``sink``'s event stream (and adopt its registry
        when none was given). Returns self for chaining."""
        with self._lock:
            self._sink = sink
            if self.registry is None:
                self.registry = getattr(sink, "registry", None)
        # Subscribe OUTSIDE the lock: the sink takes its own lock.
        sink.subscribe(self._on_event)
        return self

    def detach(self) -> None:
        with self._lock:
            sink, self._sink = self._sink, None
        if sink is not None:
            try:
                sink.unsubscribe(self._on_event)
            except Exception:
                pass

    def note_request(self, cfg, request_id: str | None = None) -> None:
        """Remember one admitted request (bounded ring) so a later trip
        can capture the most recent traffic even when the trigger has no
        single offender (stall, SIGTERM)."""
        if not self.armed:
            return
        try:
            stanza = request_stanza(cfg, request_id=request_id,
                                    expect="safe")
        except Exception:
            return
        with self._lock:
            self.recent.append(stanza)

    # -- event intake ------------------------------------------------------

    def _on_event(self, event: dict) -> None:
        if not self.armed:
            return
        with self._lock:
            self.ring.append(event)
        kind = event.get("event")
        if kind == "alert":
            self.trip(f"watchdog.{event.get('kind', 'unknown')}",
                      str(event.get("detail", "")), trigger_event=event)
        elif kind == "rta.engage" and int(
                event.get("rung", 0)) >= RTA_TRIP_RUNG:
            self.trip("rta.engage",
                      f"RTA rung {event.get('rung')} engaged at step "
                      f"{event.get('step')}", trigger_event=event)

    # -- capsule writing ---------------------------------------------------

    def trip(self, reason: str, detail: str = "", *,
             request: dict | None = None,
             trigger_event: dict | None = None) -> str | None:
        """Write one incident capsule (unless disarmed, cooling down on
        this reason, or capped). Returns the capsule directory, or None
        when suppressed. Never raises — failures bump
        ``write_failures``."""
        if not self.armed:
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last_trip.get(reason)
            if last is not None and now - last < self.cooldown_s:
                return None
            if len(self.capsules) >= self.max_capsules:
                return None
            self._last_trip[reason] = now
            self._seq += 1
            seq = self._seq
            ring = list(self.ring)
            recent = list(self.recent)
        slug = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in reason)
        capsule_dir = os.path.join(self.out_dir,
                                   f"capsule-{seq:03d}-{slug}")
        context = None
        if self.context_fn is not None:
            try:
                context = self.context_fn()
            except Exception as e:
                context = {"error": f"context_fn raised: {type(e).__name__}"}
        try:
            path = self._write(capsule_dir, reason, detail, ring, recent,
                               request, trigger_event, context)
        except Exception as e:
            with self._lock:
                self.write_failures += 1
            print(f"obs: flight capsule write failed for {reason}: {e!r}",
                  flush=True)
            return None
        with self._lock:
            self.capsules.append(path)
        if self.registry is not None:
            self.registry.counter("flight.capsules").add(1)
        if self._sink is not None:
            try:
                self._sink.event("flight.capsule", {
                    "reason": reason, "detail": detail, "capsule": path,
                    "events": len(ring),
                    "trigger_event": (trigger_event or {}).get("event")})
            except Exception:
                pass
        return path

    def _write(self, capsule_dir: str, reason: str, detail: str,
               ring: list, recent: list, request: dict | None,
               trigger_event: dict | None,
               context: dict | None = None) -> str:
        from cbf_tpu_torch.obs import resource

        os.makedirs(capsule_dir, exist_ok=True)
        with open(os.path.join(capsule_dir, RING_FILENAME), "w") as fh:
            for ev in ring:
                fh.write(json.dumps(ev) + "\n")
        if self.cost_model is not None:
            self.cost_model.save(os.path.join(
                capsule_dir, resource.COSTMODEL_FILENAME))
        if request is not None:
            with open(os.path.join(capsule_dir, REQUEST_FILENAME),
                      "w") as fh:
                json.dump(request, fh, indent=1)
        doc = {"flight_schema": FLIGHT_SCHEMA_VERSION,
               "schema": schema.SCHEMA_VERSION,
               "reason": reason, "detail": detail,
               "t_wall": round(time.time(), 6),
               "environment": resource.environment(),
               "ring_events": len(ring),
               "trigger_event": trigger_event,
               "recent_requests": recent,
               "context": context,
               "has_request": request is not None,
               "metrics": (self.registry.snapshot()
                           if self.registry is not None else {})}
        tmp = os.path.join(capsule_dir, f".{CAPSULE_FILENAME}.tmp")
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1)
        os.replace(tmp, os.path.join(capsule_dir, CAPSULE_FILENAME))
        return capsule_dir


def read_capsule(capsule_dir: str) -> dict[str, Any]:
    """Load one capsule directory back: the ``capsule.json`` manifest
    plus parsed ``ring`` events and the ``request`` stanza (None when
    the capsule has none). Raises ``FileNotFoundError`` on a directory
    without a manifest — the CLI turns that into exit 2."""
    with open(os.path.join(capsule_dir, CAPSULE_FILENAME)) as fh:
        doc = json.load(fh)
    ring: list[dict] = []
    ring_path = os.path.join(capsule_dir, RING_FILENAME)
    if os.path.exists(ring_path):
        with open(ring_path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    try:
                        ring.append(json.loads(line))
                    except ValueError:
                        pass               # torn tail tolerated
    doc["ring"] = ring
    req_path = os.path.join(capsule_dir, REQUEST_FILENAME)
    doc["request"] = None
    if os.path.exists(req_path):
        with open(req_path) as fh:
            doc["request"] = json.load(fh)
    return doc
