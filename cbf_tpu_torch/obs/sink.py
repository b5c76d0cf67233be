"""Structured telemetry sink: run manifest and schema-versioned JSONL
stream (counterpart: cbf_tpu/obs/sink.py).

One :class:`TelemetrySink` per run directory. The rollout engine's tap
(``obs.tap``) and the ensemble emitter push heartbeats into it between
chunks; the sink serializes them (one lock), appends to ``events.jsonl``
one flushed line at a time (tail-able mid-run), folds them into a
counters/gauges/histograms registry and fans them out to subscribers (the
watchdog). Alerts and the run-end summary ride the same stream.

The manifest (``manifest.json``) is written once at run start: config
snapshot, torch and CUDA versions, the card and the device count, git SHA,
caller facts, and the engine's capture/replay/redo counters
(``utils.profiling.compile_event_counts``), so the summary records the
counters' delta over the run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable

from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.obs import schema


# ----------------------------------------------------------- registry ----

class Counter:
    """Monotone accumulator (heartbeat counter channels sum into one)."""

    def __init__(self):
        self.total = 0.0
        self.samples = 0

    def add(self, v: float) -> None:
        self.total += float(v)
        self.samples += 1

    def snapshot(self) -> dict:
        return {"type": "counter", "total": self.total,
                "samples": self.samples}


class Gauge:
    """Instantaneous level: last value + running min/max."""

    def __init__(self):
        self.last = None
        self.min = None
        self.max = None
        self.samples = 0

    def set(self, v: float) -> None:
        v = float(v)
        self.last = v
        # NaN must not poison min/max silently — track it in last (the
        # watchdog alerts on it) but keep the extrema over finite samples.
        if v == v:
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
        self.samples += 1

    def snapshot(self) -> dict:
        return {"type": "gauge", "last": self.last, "min": self.min,
                "max": self.max, "samples": self.samples}


class Histogram:
    """Fixed-boundary histogram (log-spaced default): bounded memory for
    unbounded streams. ``bounds`` are the upper edges of all but the last
    (overflow) bucket. Observed finite min/max are tracked alongside the
    bucket counts so quantile ESTIMATES (:meth:`quantile`) stay bounded
    by what was actually seen."""

    DEFAULT_BOUNDS = tuple(10.0 ** e for e in range(-9, 7))
    #: The percentiles every snapshot reports (SLO convention).
    SNAPSHOT_QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, bounds: tuple[float, ...] | None = None):
        self.bounds = tuple(bounds) if bounds else self.DEFAULT_BOUNDS
        self.counts = [0] * (len(self.bounds) + 1)
        self.samples = 0
        self.nonfinite = 0
        self.vmin: float | None = None
        self.vmax: float | None = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.samples += 1
        if not (v == v and abs(v) != float("inf")):
            self.nonfinite += 1
            return
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> float | None:
        """Estimate the q-quantile (0 <= q <= 1) from the bucket counts:
        find the bucket holding the target rank, then interpolate
        linearly between its edges (observed min/max stand in for the
        open-ended first and overflow edges). The estimate is clamped to
        [observed min, observed max], so it is exact at the extremes,
        monotone in q, and never invents values outside the data. None
        when no finite sample has been observed."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        finite = sum(self.counts)
        if finite == 0 or self.vmin is None:
            return None
        target = q * finite
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                lo = self.vmin if i == 0 else self.bounds[i - 1]
                hi = (self.vmax if i == len(self.bounds)
                      else self.bounds[i])
                est = lo + (hi - lo) * ((target - cum) / c)
                return min(max(est, self.vmin), self.vmax)
            cum += c
        return self.vmax

    def snapshot(self) -> dict:
        snap = {"type": "histogram", "bounds": list(self.bounds),
                "counts": list(self.counts), "samples": self.samples,
                "nonfinite": self.nonfinite, "min": self.vmin,
                "max": self.vmax}
        for q in self.SNAPSHOT_QUANTILES:
            snap[f"p{round(q * 100)}"] = self.quantile(q)
        return snap


class MetricsRegistry:
    """Named counters/gauges/histograms + cross-snapshot merge.

    ``merge`` folds another registry's snapshot in (counters/histograms
    add, gauges min/max-merge) — the host-level reduction for multi-host
    runs, where each process aggregates locally and the primary merges."""

    def __init__(self):
        # Separate namespaces: a heartbeat gauge and its histogram share a
        # NAME but are different metrics (snapshot suffixes the histogram).
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str,
                  bounds: tuple[float, ...] | None = None) -> Histogram:
        return self._histograms.setdefault(name, Histogram(bounds))

    def snapshot(self) -> dict:
        out = {}
        for name, m in self._counters.items():
            out[name] = m.snapshot()
        for name, m in self._gauges.items():
            out[name] = m.snapshot()
        for name, m in self._histograms.items():
            out[name + ".hist"] = m.snapshot()
        return dict(sorted(out.items()))

    def merge(self, other: dict) -> None:
        for name, snap in other.items():
            t = snap.get("type")
            if t == "histogram" and name.endswith(".hist"):
                name = name[:-len(".hist")]
            if t == "counter":
                c = self.counter(name)
                c.total += snap.get("total", 0.0)
                c.samples += snap.get("samples", 0)
            elif t == "gauge":
                g = self.gauge(name)
                for v in (snap.get("min"),):
                    if v is not None:
                        g.min = v if g.min is None else min(g.min, v)
                for v in (snap.get("max"),):
                    if v is not None:
                        g.max = v if g.max is None else max(g.max, v)
                if snap.get("last") is not None:
                    g.last = snap["last"]
                g.samples += snap.get("samples", 0)
            elif t == "histogram":
                h = self.histogram(name, tuple(snap.get("bounds", ())) or None)
                if list(h.bounds) == snap.get("bounds"):
                    h.counts = [a + b for a, b in zip(h.counts, snap["counts"])]
                    h.samples += snap.get("samples", 0)
                    h.nonfinite += snap.get("nonfinite", 0)
                else:  # incompatible bins: keep totals honest, drop shape
                    h.samples += snap.get("samples", 0)
                    h.nonfinite += snap.get("nonfinite", 0)
                if snap.get("min") is not None:
                    h.vmin = (snap["min"] if h.vmin is None
                              else min(h.vmin, snap["min"]))
                if snap.get("max") is not None:
                    h.vmax = (snap["max"] if h.vmax is None
                              else max(h.vmax, snap["max"]))


# ----------------------------------------------------------- manifest ----

def _git_sha(repo_dir: str | None = None) -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=repo_dir or os.path.dirname(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


def build_manifest(config: Any = None, extra: dict | None = None) -> dict:
    """The run manifest: everything needed to interpret the stream later.

    ``config`` — a scenario Config dataclass (snapshotted field by field,
    repr-encoded like the CLI record) or a plain dict. ``extra`` — caller
    facts (CLI argv, the device). The torch and CUDA versions, the card
    and the device count, and the engine counters are read from the live
    process."""
    import dataclasses

    import torch

    from cbf_tpu_torch.utils import profiling

    if config is not None and dataclasses.is_dataclass(config):
        config = {f.name: repr(getattr(config, f.name))
                  for f in dataclasses.fields(config)}
    try:
        cuda = torch.cuda.is_available()
        topology = {
            "backend": "cuda" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 0,
            "device_kind": torch.cuda.get_device_name(0) if cuda else None,
        }
    except Exception as e:  # manifest must never fail the run
        topology = {"error": repr(e)}
    manifest = {
        "schema": schema.SCHEMA_VERSION,
        "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python_version": sys.version.split()[0],
        "argv": list(sys.argv),
        "git_sha": _git_sha(),
        "topology": topology,
        # The engine counters at run start: the summary event records the
        # delta, so in-run captures and redos are visible.
        "compile_event_counts": profiling.compile_event_counts(),
        "config": config,
    }
    if extra:
        manifest.update(extra)
    return manifest


# --------------------------------------------------------------- sink ----

class TelemetrySink:
    """Append-only JSONL event stream + registry for one run directory.

    Thread-safe (the watchdog's stall thread alerts beside the run). Events
    are flushed per line so ``tail -f``/``obs tail`` see them live.
    Subscribers are called synchronously with each event dict — keep them
    fast (the watchdog's checks are O(fields))."""

    def __init__(self, run_dir: str, *, manifest: dict | None = None):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.events_path = os.path.join(self.run_dir, schema.EVENTS_FILENAME)
        self.manifest_path = os.path.join(self.run_dir,
                                          schema.MANIFEST_FILENAME)
        self._fh = open(self.events_path, "a")
        self._lock = lockwitness.make_lock("TelemetrySink._lock")
        self._subscribers: list[Callable[[dict], None]] = []
        self.registry = MetricsRegistry()
        self.heartbeat_count = 0
        self.alert_count = 0
        self.last_heartbeat_wall: float | None = None
        self._last_step: int | None = None
        self._last_step_wall: float | None = None
        self._manifest_compile_counts: dict = {}
        self._manifest_doc: dict | None = None
        # label -> obs.resource.analyze_compiled dict for every program
        # captured during the run with a cost model attached;
        # snapshotted into the manifest's "executables" block.
        self._executables: dict[str, dict] = {}
        self._closed = False
        self._paused = False
        # Tap-wrapper cache: instrumented step functions keyed per
        # (step_fn, every) so repeat rollouts through one sink replay the
        # programs cached on the wrapper (see obs.tap.instrument_step).
        self._tap_cache: dict = {}
        if manifest is not None:
            self.write_manifest(manifest)

    # -- lifecycle ---------------------------------------------------------

    def write_manifest(self, manifest: dict) -> None:
        manifest = dict(manifest)
        manifest.setdefault("schema", schema.SCHEMA_VERSION)
        self._manifest_compile_counts = dict(
            manifest.get("compile_event_counts") or {})
        if self._executables:
            manifest.setdefault("executables", dict(self._executables))
        self._manifest_doc = manifest
        self._rewrite_manifest(manifest)

    def _rewrite_manifest(self, manifest: dict) -> None:
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=2, default=repr)
            fh.write("\n")
        os.replace(tmp, self.manifest_path)

    def record_executable(self, label: str, info: dict) -> None:
        """Snapshot one captured program's measurements
        (``obs.resource.analyze_compiled`` shape) under ``label``. The
        manifest on disk is atomically refreshed with the accumulated
        ``executables`` block — captures happen after run start, so the
        write-once manifest would otherwise never see them."""
        with self._lock:
            self._executables[label] = dict(info)
            doc = self._manifest_doc
            if doc is not None:
                doc["executables"] = dict(self._executables)
        if doc is not None:
            try:
                self._rewrite_manifest(doc)
            except OSError:
                pass   # accounting must never fail the run

    @property
    def executables(self) -> dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._executables.items()}

    def pause(self) -> None:
        """Drop heartbeats until :meth:`resume` — lets a warm-up run capture
        the instrumented programs the measured run will replay without its
        heartbeats entering the stream."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            # A paused stretch must not masquerade as a fast inter-
            # heartbeat interval (step_rate) or a stall.
            self._last_step = None
            self._last_step_wall = None

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- events ------------------------------------------------------------

    def subscribe(self, fn: Callable[[dict], None]) -> None:
        # Under _lock: _emit snapshots the subscriber list under the
        # same lock, and subscribe can race it from another thread.
        with self._lock:
            self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    def _emit(self, event: dict) -> None:
        """Serialize + append + fan out one event (caller holds no lock)."""
        line = json.dumps(event)
        subs = ()
        with self._lock:
            if not self._closed:
                self._fh.write(line + "\n")
                self._fh.flush()
            subs = tuple(self._subscribers)
        for fn in subs:
            try:
                fn(event)
            except Exception as e:  # a broken subscriber must not kill the run
                print(f"obs: subscriber failed on {event.get('event')}: "
                      f"{e!r}", file=sys.stderr)

    def heartbeat(self, step: int, values: dict,
                  ensemble_members: int | None = None) -> dict:
        """Record one in-flight snapshot. ``values``: heartbeat-field name
        -> scalar (NaN/inf welcome — they are exactly what the watchdog is
        for). Returns the event dict as written (None while paused)."""
        now = time.time()
        with self._lock:
            if self._paused:
                return None
            rate = None
            if (self._last_step is not None and step > self._last_step
                    and now > self._last_step_wall):
                rate = (step - self._last_step) / (now - self._last_step_wall)
            if self._last_step is None or step >= self._last_step:
                # Out-of-order steps (a resumed run) leave the rate; it only
                # advances on forward progress.
                self._last_step, self._last_step_wall = step, now
            self.last_heartbeat_wall = now
            self.heartbeat_count += 1
            for name, v in values.items():
                f = schema.field_by_name(name)
                if f.kind == "counter":
                    self.registry.counter(name).add(v)
                else:
                    self.registry.gauge(name).set(v)
                    self.registry.histogram(name).observe(v)
            if rate is not None:
                self.registry.gauge("step_rate").set(rate)
                self.registry.histogram("step_rate").observe(rate)
        event = {"event": "heartbeat", "schema": schema.SCHEMA_VERSION,
                 "step": int(step), "t_wall": round(now, 6),
                 "step_rate": None if rate is None else round(rate, 3)}
        if ensemble_members is not None:
            event["ensemble_members"] = int(ensemble_members)
        for name, v in values.items():
            event[name] = schema.json_scalar(v)
        self._emit(event)
        return event

    def alert(self, kind: str, step: int | None = None,
              detail: str = "", severity: str = "critical",
              rta_mode: float | None = None) -> dict:
        with self._lock:
            self.alert_count += 1
            self.registry.counter(f"alerts.{kind}").add(1)
        event = {"event": "alert", "schema": schema.SCHEMA_VERSION,
                 "kind": kind, "step": step, "detail": detail,
                 "severity": severity,
                 "t_wall": round(time.time(), 6)}
        if rta_mode is not None:
            event["rta_mode"] = schema.json_scalar(rta_mode)
        self._emit(event)
        return event

    def event(self, event_type: str, payload: dict | None = None) -> dict:
        """Append a generic schema-stamped event to the stream (e.g. the
        serving layer's per-request attribution records: one ``request``
        event per completed request with its bucket, latency and safety
        metrics). Readers ignore event types they don't know —
        ``summarize_run`` folds only heartbeats/alerts — so new types
        extend the stream without a schema bump. Reserved types
        (heartbeat/alert/summary) must go through their dedicated
        methods, which maintain counters and subscriber contracts."""
        if event_type in ("heartbeat", "alert", "summary"):
            raise ValueError(
                f"{event_type!r} events have dedicated methods — use "
                "heartbeat()/alert()/summary()")
        event = {"event": event_type, "schema": schema.SCHEMA_VERSION,
                 "t_wall": round(time.time(), 6)}
        if payload:
            event.update(payload)
        self._emit(event)
        return event

    def summary(self, extra: dict | None = None) -> dict:
        """Write the run-end summary event (registry snapshot + compile
        counter delta vs the manifest) and return it."""
        from cbf_tpu_torch.utils import profiling

        now_counts = profiling.compile_event_counts()
        delta = {k: now_counts[k] - self._manifest_compile_counts.get(k, 0)
                 for k in now_counts
                 if now_counts[k] != self._manifest_compile_counts.get(k, 0)}
        event = {"event": "summary", "schema": schema.SCHEMA_VERSION,
                 "t_wall": round(time.time(), 6),
                 "heartbeats": self.heartbeat_count,
                 "alerts": self.alert_count,
                 "compile_events_during_run": delta,
                 "metrics": self.registry.snapshot()}
        if extra:
            event.update(extra)
        self._emit(event)
        return event


# ------------------------------------------------------------- readers ----

def read_manifest(run_dir: str) -> dict | None:
    path = os.path.join(run_dir, schema.MANIFEST_FILENAME)
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def read_events(run_dir: str) -> list[dict]:
    """All events in a run directory (skips partial trailing lines — the
    writer may be mid-append)."""
    path = os.path.join(run_dir, schema.EVENTS_FILENAME)
    events = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return events


def tail_events(run_dir: str, *, follow: bool = False,
                poll_s: float = 0.25, stop: Callable[[], bool] | None = None,
                stall_timeout: float | None = None):
    """Yield events as they are appended. ``follow=False`` yields what
    exists and returns; ``follow=True`` keeps polling until ``stop()`` is
    true or a ``summary`` event arrives.

    ``stall_timeout`` (follow mode): when no heartbeat lands for that many
    seconds, yield ONE synthetic stall-alert event (``"synthetic": True``
    distinguishes it from a watchdog-written alert riding the stream) and
    return — the reader-side stall detector for watching a run whose
    writer process may itself be wedged (``obs tail``)."""
    path = os.path.join(run_dir, schema.EVENTS_FILENAME)
    pos = 0
    buf = ""
    last_heartbeat = time.time()
    while True:
        try:
            with open(path) as fh:
                fh.seek(pos)
                chunk = fh.read()
                pos = fh.tell()
        except OSError:
            chunk = ""
        buf += chunk
        done = False
        while "\n" in buf:
            line, buf = buf.split("\n", 1)
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError:
                continue
            if event.get("event") == "heartbeat":
                last_heartbeat = time.time()
            yield event
            if event.get("event") == "summary":
                done = True
        if done or not follow or (stop is not None and stop()):
            return
        if (stall_timeout is not None
                and time.time() - last_heartbeat > stall_timeout):
            yield {"event": "alert", "schema": schema.SCHEMA_VERSION,
                   "kind": "stall", "step": None, "synthetic": True,
                   "detail": f"no heartbeat for > {stall_timeout:.1f}s "
                             "(reader-side stall detection)",
                   "t_wall": round(time.time(), 6)}
            return
        time.sleep(poll_s)


def summarize_run(run_dir: str) -> dict:
    """Aggregate a run directory post-hoc: prefers the written summary
    event, else recomputes the registry from the heartbeat stream (a
    crashed run has no summary — exactly when you want one)."""
    events = read_events(run_dir)
    for ev in reversed(events):
        if ev.get("event") == "summary":
            out = dict(ev)
            out["from"] = "summary_event"
            return out
    reg = MetricsRegistry()
    heartbeats = alerts = 0
    last_step = None
    for ev in events:
        if ev.get("event") == "heartbeat":
            heartbeats += 1
            last_step = ev.get("step", last_step)
            for f in schema.HEARTBEAT_FIELDS:
                if f.name in ev:
                    v = schema.scalar_value(ev[f.name])
                    if f.kind == "counter":
                        reg.counter(f.name).add(v)
                    else:
                        reg.gauge(f.name).set(v)
                        reg.histogram(f.name).observe(v)
            if ev.get("step_rate") is not None:
                reg.gauge("step_rate").set(ev["step_rate"])
        elif ev.get("event") == "alert":
            alerts += 1
            reg.counter(f"alerts.{ev.get('kind', 'unknown')}").add(1)
    return {"event": "summary", "schema": schema.SCHEMA_VERSION,
            "from": "recomputed", "heartbeats": heartbeats, "alerts": alerts,
            "last_step": last_step, "metrics": reg.snapshot()}
