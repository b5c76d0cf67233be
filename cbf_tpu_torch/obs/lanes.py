"""Lane/chunk occupancy ledger for the continuous-batching scheduler
(counterpart: cbf_tpu/obs/lanes.py).

A :class:`LaneLedger` is stamped by the serve engine's continuous
scheduler at every chunk boundary (``ServeEngine._advance_table`` /
``_apply_joins`` / ``_vacate``) with one :meth:`~LaneLedger.note_chunk`
record per executed chunk: chunk index, bucket label, the lane bitmap
(active/pad/vacant/background-preempted — :data:`LANE_STATES`), per-lane
``request_id`` + useful steps advanced, and the
dispatch/execute/pack/unpack wall split measured in **integer
nanoseconds** (``time.perf_counter_ns``).

Integer nanoseconds are the load-bearing choice: every chunk's
lane-time decomposes as

    ``busy_ns + padding_ns + vacancy_ns + dispatch_ns == lanes * wall_ns``

and because the four components are Python ints derived by exact
integer arithmetic (``padding`` and ``dispatch`` are complements, never
independently rounded), the identity holds EXACTLY — per record, per
window, and cumulatively — not merely to float tolerance. The terms:

- ``busy_ns`` — lane-time spent advancing USEFUL steps:
  ``live * execute_ns * sum_k // (live * chunk_steps)``.
- ``padding_ns`` — lane-time live lanes spent executing PAD steps (a
  request that finishes mid-chunk still rides the full chunk):
  ``live * execute_ns - busy_ns``.
- ``vacancy_ns`` — lane-time of empty (frozen) lanes:
  ``vacant * wall_ns``.
- ``dispatch_ns`` — everything the chunk wall spent OUTSIDE the chunk
  program's execute on the card (pack/unpack/host bookkeeping),
  attributed to every non-vacant lane: ``live * (wall_ns -
  execute_ns)``. ``pack_ns``/``unpack_ns`` ride along as its measured
  sub-split.

The ledger feeds three surfaces:

- ``serve.lanes.*`` registry metrics (counters ``chunks`` / ``joins`` /
  ``vacates`` / ``preempted``, gauges ``occupancy_pct`` / ``bubble_pct``
  / ``dispatch_pct`` / ``join_rate`` / ``vacate_rate``, histograms
  ``fill`` / ``lane_age_s``) with per-bucket twins (``name[bucket]``),
  so `obs/export.py` carries them to ``metrics.prom``/``metrics.json``.
- one ``serve.lanes.window`` JSONL event every ``emit_every`` chunks
  (``obs.schema.LANES_EVENT_FIELDS``): the window's exact time
  accounting plus per-bucket split, the stream the watchdog's
  ``sustained_low_occupancy`` check consumes.
- :meth:`LaneLedger.snapshot` — the in-flight lane-table view + last W
  chunk records, embedded in every flight-recorder capsule (the
  ``context`` key) so ``obs incident`` can answer "what was running".

Arming is a scheduler-construction decision (``ServeEngine``'s
``lane_ledger`` parameter). Off, the scheduler path takes zero extra
clock reads and stays bit-neutral. The ledger is host code: it never
touches a tensor.
"""

from __future__ import annotations

import collections
import time
from typing import Any

from cbf_tpu_torch.analysis import lockwitness

#: Event types this module emits (equal to
#: ``obs.schema.LANES_EVENT_TYPES``).
EMITTED_EVENT_TYPES: tuple[str, ...] = ("serve.lanes.window",)

#: Lane bitmap vocabulary (one char per lane slot, slot order):
#: ``A`` active (advanced a full chunk of useful steps), ``P`` pad
#: (live, but part of its chunk was padding — the lane finishes
#: mid-chunk), ``V`` vacant (frozen empty slot), ``B``
#: background-preempted (a background-tier lane holding a request that
#: was denied the device this pass because foreground traffic ran).
LANE_STATES: dict[str, str] = {
    "A": "active", "P": "pad", "V": "vacant",
    "B": "background-preempted"}

#: Accounting keys every totals dict carries (all exact integers except
#: the event counters, which are exact integers too).
ACCOUNT_KEYS: tuple[str, ...] = (
    "chunks", "busy_ns", "padding_ns", "vacancy_ns", "dispatch_ns",
    "total_ns", "joins", "vacates", "preempted")


def _zero() -> dict[str, int]:
    return {k: 0 for k in ACCOUNT_KEYS}


def subtract(after: dict, before: dict) -> dict[str, int]:
    """Exact delta between two totals dicts (window accounting over a
    leg: totals are sum-linear integers, so deltas keep the identity)."""
    return {k: int(after.get(k, 0)) - int(before.get(k, 0))
            for k in ACCOUNT_KEYS}


def derive(totals: dict) -> dict[str, Any]:
    """Attach the derived percentages + the exact identity verdict to a
    totals dict. ``identity_ok`` is integer equality —
    ``busy + padding + vacancy + dispatch == total`` — not a float
    tolerance check."""
    out = dict(totals)
    total = int(totals.get("total_ns", 0))
    ident = (int(totals.get("busy_ns", 0))
             + int(totals.get("padding_ns", 0))
             + int(totals.get("vacancy_ns", 0))
             + int(totals.get("dispatch_ns", 0)))
    out["identity_ok"] = ident == total
    if total > 0:
        out["occupancy_pct"] = round(100.0 * totals["busy_ns"] / total, 4)
        out["bubble_pct"] = round(
            100.0 * (totals["vacancy_ns"] + totals["padding_ns"]) / total, 4)
        out["dispatch_pct"] = round(
            100.0 * totals["dispatch_ns"] / total, 4)
    else:
        out["occupancy_pct"] = 0.0
        out["bubble_pct"] = 0.0
        out["dispatch_pct"] = 0.0
    return out


class LaneLedger:
    """Chunk-boundary occupancy ledger (see the module docstring).

    ``sink`` — optional TelemetrySink; a ``serve.lanes.window`` event is
    emitted every ``emit_every`` chunks. ``registry`` — optional
    MetricsRegistry (defaults to the sink's); fed per chunk.
    ``window`` bounds the in-memory chunk-record ring (the W records a
    flight capsule embeds). All notes are scheduler-thread calls; reads
    (:meth:`snapshot`, :meth:`totals`) may come from any thread — every
    method takes the ledger's own leaf lock.
    """

    def __init__(self, *, sink=None, registry=None, window: int = 128,
                 emit_every: int = 32):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if emit_every < 1:
            raise ValueError(f"emit_every must be >= 1, got {emit_every}")
        self.sink = sink
        self.registry = registry if registry is not None else (
            getattr(sink, "registry", None) if sink is not None else None)
        self.window = int(window)
        self.emit_every = int(emit_every)
        self._lock = lockwitness.make_lock("LaneLedger._lock")
        self._records: collections.deque = collections.deque(maxlen=window)
        self._index = 0
        self._totals = _zero()
        self._by_bucket: dict[str, dict[str, int]] = {}
        # Live per-table lane view (bucket -> {"bitmap", "lanes": [...]}),
        # refreshed at every chunk stamp / preempt pass — the "what was
        # running" table a capsule or `obs lanes` shows.
        self._tables: dict[str, dict[str, Any]] = {}
        # Window-event bookkeeping: totals snapshot + wall stamp at the
        # last emit, so each serve.lanes.window event carries exact
        # deltas and join/vacate rates over its own span.
        self._emit_totals = _zero()
        self._emit_bucket: dict[str, dict[str, int]] = {}
        self._emit_t = time.perf_counter()

    # -- accounting helpers (call under self._lock) ------------------------

    def _bucket(self, bucket: str) -> dict[str, int]:
        acct = self._by_bucket.get(bucket)
        if acct is None:
            acct = self._by_bucket[bucket] = _zero()
        return acct

    def _add(self, bucket: str, key: str, v: int) -> None:
        self._totals[key] += v
        self._bucket(bucket)[key] += v

    # -- scheduler stamps --------------------------------------------------

    def note_join(self, bucket: str) -> None:
        """One request joined a lane of ``bucket``'s table."""
        with self._lock:
            self._add(bucket, "joins", 1)
        reg = self.registry
        if reg is not None:
            reg.counter("serve.lanes.joins").add(1)
            reg.counter(f"serve.lanes.joins[{bucket}]").add(1)

    def note_vacate(self, bucket: str, age_s: float) -> None:
        """One lane of ``bucket``'s table vacated (resolve, deadline,
        cancel mid-flight, or demote); ``age_s`` is join-to-vacate."""
        with self._lock:
            self._add(bucket, "vacates", 1)
        reg = self.registry
        if reg is not None:
            reg.counter("serve.lanes.vacates").add(1)
            reg.counter(f"serve.lanes.vacates[{bucket}]").add(1)
            reg.histogram("serve.lanes.lane_age_s").observe(age_s)
            reg.histogram(f"serve.lanes.lane_age_s[{bucket}]").observe(age_s)

    def note_preempted(self, bucket: str, lanes: int,
                       slots: list[int]) -> None:
        """A background-tier table held live lanes but was denied the
        device this scheduler pass (foreground traffic ran). Counted as
        preempted lane-passes; the live table view shows those lanes as
        ``B`` until their next chunk."""
        occupied = set(slots)
        bitmap = "".join("B" if i in occupied else "V"
                         for i in range(lanes))
        with self._lock:
            self._add(bucket, "preempted", len(slots))
            self._tables[bucket] = {"bitmap": bitmap, "background": True,
                                    "lanes": []}
        reg = self.registry
        if reg is not None:
            reg.counter("serve.lanes.preempted").add(len(slots))
            reg.counter(f"serve.lanes.preempted[{bucket}]").add(len(slots))

    def note_chunk(self, chunk_id: str, bucket: str, *, lanes: int,
                   chunk_steps: int, lane_rows: list, wall_ns: int,
                   execute_ns: int, pack_ns: int, unpack_ns: int,
                   background: bool = False, t_s: float = 0.0) -> dict:
        """Stamp one executed chunk. ``lane_rows`` is the live-lane list
        of ``(slot, request_id, useful_steps, age_s)`` tuples; time
        arguments are integer nanoseconds with the execute window nested
        inside the wall window (``execute_ns <= wall_ns``). Returns the
        appended record (a plain JSON-safe dict)."""
        live = len(lane_rows)
        vacant = lanes - live
        total_ns = lanes * wall_ns
        vacancy_ns = vacant * wall_ns
        exec_lane_ns = live * execute_ns
        sum_k = sum(int(r[2]) for r in lane_rows)
        denom = live * chunk_steps
        busy_ns = (exec_lane_ns * sum_k) // denom if denom else 0
        padding_ns = exec_lane_ns - busy_ns
        dispatch_ns = total_ns - vacancy_ns - exec_lane_ns
        states = {}
        lane_map = []
        for slot, request_id, k, age_s in lane_rows:
            k = int(k)
            states[slot] = "A" if k >= chunk_steps else "P"
            lane_map.append({
                "slot": int(slot), "request_id": request_id, "steps": k,
                "pad": max(0, chunk_steps - k),
                "age_s": round(float(age_s), 6)})
        bitmap = "".join(states.get(i, "V") for i in range(lanes))
        record = {
            "chunk_id": chunk_id, "bucket": bucket,
            "background": bool(background), "lanes": int(lanes),
            "chunk_steps": int(chunk_steps), "fill": live,
            "bitmap": bitmap, "lane_map": lane_map,
            "t_s": round(float(t_s), 6), "wall_ns": int(wall_ns),
            "execute_ns": int(execute_ns), "pack_ns": int(pack_ns),
            "unpack_ns": int(unpack_ns), "busy_ns": busy_ns,
            "padding_ns": padding_ns, "vacancy_ns": vacancy_ns,
            "dispatch_ns": dispatch_ns, "total_ns": total_ns,
        }
        reg = self.registry
        with self._lock:
            self._index += 1
            record["index"] = self._index
            self._records.append(record)
            self._add(bucket, "chunks", 1)
            for key in ("busy_ns", "padding_ns", "vacancy_ns",
                        "dispatch_ns", "total_ns"):
                self._add(bucket, key, record[key])
            self._tables[bucket] = {"bitmap": bitmap,
                                    "background": bool(background),
                                    "lanes": lane_map}
            if reg is not None:
                derived = derive(self._totals)
                bderived = derive(self._by_bucket[bucket])
            emit = self._index % self.emit_every == 0
            payload = self._window_payload_locked() if emit else None
        if reg is not None:
            reg.counter("serve.lanes.chunks").add(1)
            reg.counter(f"serve.lanes.chunks[{bucket}]").add(1)
            reg.histogram("serve.lanes.fill").observe(float(live))
            reg.histogram(f"serve.lanes.fill[{bucket}]").observe(float(live))
            for name, src in (("", derived), (f"[{bucket}]", bderived)):
                reg.gauge(f"serve.lanes.occupancy_pct{name}").set(
                    src["occupancy_pct"])
                reg.gauge(f"serve.lanes.bubble_pct{name}").set(
                    src["bubble_pct"])
                reg.gauge(f"serve.lanes.dispatch_pct{name}").set(
                    src["dispatch_pct"])
        if payload is not None:
            if reg is not None:
                reg.gauge("serve.lanes.join_rate").set(payload["join_rate"])
                reg.gauge("serve.lanes.vacate_rate").set(
                    payload["vacate_rate"])
            if self.sink is not None:
                # Outside the ledger lock: the sink serializes itself.
                self.sink.event("serve.lanes.window", payload)
        return record

    def _window_payload_locked(self) -> dict[str, Any]:
        """The serve.lanes.window event payload: EXACT deltas since the
        last emit + per-bucket split + join/vacate rates. Caller holds
        ``self._lock``."""
        now = time.perf_counter()
        elapsed = max(now - self._emit_t, 1e-9)
        delta = subtract(self._totals, self._emit_totals)
        by_bucket = {}
        for bucket, acct in self._by_bucket.items():
            bdelta = subtract(acct, self._emit_bucket.get(bucket, _zero()))
            if bdelta["chunks"] or bdelta["joins"] or bdelta["preempted"]:
                bd = derive(bdelta)
                by_bucket[bucket] = {
                    "chunks": bd["chunks"],
                    "occupancy_pct": bd["occupancy_pct"],
                    "dispatch_pct": bd["dispatch_pct"]}
        payload = derive(delta)
        payload["join_rate"] = round(delta["joins"] / elapsed, 4)
        payload["vacate_rate"] = round(delta["vacates"] / elapsed, 4)
        payload["by_bucket"] = by_bucket
        self._emit_totals = dict(self._totals)
        self._emit_bucket = {b: dict(a) for b, a in self._by_bucket.items()}
        self._emit_t = now
        return payload

    # -- reads (any thread) ------------------------------------------------

    def records(self, n: int | None = None) -> list[dict]:
        """The last ``n`` (default: all retained) chunk records, oldest
        first — the W-record evidence trail a capsule embeds."""
        with self._lock:
            recs = list(self._records)
        return recs if n is None else recs[-n:]

    def totals(self, bucket: str | None = None) -> dict[str, Any]:
        """Cumulative accounting (global, or one bucket's), with derived
        percentages and the exact-identity verdict attached."""
        with self._lock:
            src = self._totals if bucket is None \
                else self._by_bucket.get(bucket, _zero())
            return derive(dict(src))

    def bucket_totals(self) -> dict[str, dict[str, Any]]:
        """Per-bucket cumulative accounting (derived), a copy."""
        with self._lock:
            return {b: derive(dict(a)) for b, a in self._by_bucket.items()}

    def snapshot(self, recent: int | None = None) -> dict[str, Any]:
        """JSON-safe state dump for flight capsules and ``obs lanes``:
        cumulative totals, per-bucket split, the live lane-table view
        (bitmaps + per-lane request ids), and the last W chunk
        records."""
        with self._lock:
            return {
                "armed": True,
                "chunks": self._totals["chunks"],
                "totals": derive(dict(self._totals)),
                "by_bucket": {b: derive(dict(a))
                              for b, a in self._by_bucket.items()},
                "tables": {b: dict(t) for b, t in self._tables.items()},
                "recent": list(self._records)[-(recent or self.window):],
            }
