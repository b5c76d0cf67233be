"""Live metrics surface (counterpart: cbf_tpu/obs/export.py):
atomically-rewritten Prometheus text exposition (``metrics.prom``) plus
a JSON twin (``metrics.json``) at a fixed cadence, straight from the
:class:`~cbf_tpu_torch.obs.sink.MetricsRegistry`.

- ``metrics.prom`` — Prometheus text exposition format v0.0.4. Counter
  -> ``counter``, gauge -> ``gauge`` (last value), histogram ->
  ``summary`` (p50/p95/p99 quantile samples + ``_count``/``_min``/
  ``_max``). Metric names are sanitized to ``cbf_<name>`` with the
  registry's ``[bucket]`` suffix convention lifted into a
  ``bucket="..."`` label, so per-bucket latency series arrive in
  Prometheus already dimensioned.
- ``metrics.json`` — the raw snapshot plus ``t_wall`` and any
  engine-supplied ``extra`` dict, for consumers that want structure
  (``obs top`` and ``obs lanes`` read this twin, not the text format).

For one registry snapshot both files are byte-equal to the JAX
package's. Both are written tmp + ``os.replace`` (same atomic discipline
as the telemetry manifest): a scraper never reads a torn exposition.
:class:`MetricsExporter` runs the rewrite on a daemon thread at
``every_s`` cadence; ``write_once`` is the synchronous path for tests
and run-end flushes. The exporter emits no telemetry events — it is a
pure reader. Host code only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

from cbf_tpu_torch.analysis import lockwitness

PROM_FILENAME = "metrics.prom"
JSON_FILENAME = "metrics.json"

_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def _prom_name(name: str) -> str:
    safe = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    if not safe or not (safe[0].isalpha() or safe[0] in "_:"):
        safe = "_" + safe
    return f"cbf_{safe}"


def split_bucket(name: str) -> tuple[str, str | None]:
    """Lift the registry's ``metric[bucket-label]`` convention into
    (metric, bucket-label-or-None)."""
    if name.endswith("]") and "[" in name:
        base, bucket = name[:-1].split("[", 1)
        return base, bucket
    return name, None


def _series(name: str, bucket: str | None, value) -> str:
    label = "" if bucket is None else (
        '{bucket="%s"}' % bucket.replace("\\", "\\\\").replace('"', '\\"'))
    if value is None:
        value = "NaN"
    return f"{name}{label} {value}"


def _quantile_series(name: str, bucket: str | None, q: str, value) -> str:
    esc = "" if bucket is None else (
        ',bucket="%s"' % bucket.replace("\\", "\\\\").replace('"', '\\"'))
    if value is None:
        value = "NaN"
    return '%s{quantile="%s"%s} %s' % (name, q, esc, value)


def render_prom(snapshot: dict[str, Any]) -> str:
    """The registry snapshot as Prometheus text exposition v0.0.4.
    Series of one metric family (same name, different ``bucket`` label)
    are grouped under one ``# TYPE`` header, as the format requires.
    The heartbeat tap records a gauge and a histogram under one base
    name (``x`` + ``x.hist``); a name may only carry one type in the
    exposition, so a colliding histogram family renders as
    ``<name>_hist`` instead of emitting duplicate samples."""
    families: dict[tuple[str, str], list] = {}
    for raw_name, snap in sorted(snapshot.items()):
        kind = snap.get("type")
        base = raw_name
        if kind == "histogram" and base.endswith(".hist"):
            base = base[:-len(".hist")]       # registry suffixes the full key
        base, bucket = split_bucket(base)
        families.setdefault((_prom_name(base), kind), []).append(
            (bucket, snap))
    kinds_per_name: dict[str, int] = {}
    for pname, _ in families:
        kinds_per_name[pname] = kinds_per_name.get(pname, 0) + 1
    lines = []
    for (name, kind), series in sorted(families.items()):
        if kind == "histogram" and kinds_per_name[name] > 1:
            name = f"{name}_hist"
        if kind == "counter":
            lines.append(f"# TYPE {name} counter")
            for bucket, snap in series:
                lines.append(_series(name, bucket, snap.get("total")))
        elif kind == "gauge":
            lines.append(f"# TYPE {name} gauge")
            for bucket, snap in series:
                lines.append(_series(name, bucket, snap.get("last")))
        elif kind == "histogram":
            lines.append(f"# TYPE {name} summary")
            for bucket, snap in series:
                for q, key in _QUANTILES:
                    lines.append(_quantile_series(name, bucket, q,
                                                  snap.get(key)))
                lines.append(_series(f"{name}_count", bucket,
                                     snap.get("samples", 0)))
                lines.append(_series(f"{name}_min", bucket,
                                     snap.get("min")))
                lines.append(_series(f"{name}_max", bucket,
                                     snap.get("max")))
    return "\n".join(lines) + "\n"


def _atomic_write(path: str, text: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


#: Name of the liveness/role surface file inside an export directory.
HEALTH_FILENAME = "health.json"


def write_health(out_dir: str, payload: dict[str, Any]) -> str:
    """Atomically (re)write the ``health.json`` surface: a small JSON
    document describing the process's serving role right now — the HA
    layer (``serve.ha``) publishes ``role`` ("primary" |
    "standby"), ``epoch``, and lease/journal coordinates here on every
    role transition, so an external prober can tell WHO is serving
    without parsing the event stream. Stamped with ``t_wall``; returns
    the file path."""
    os.makedirs(out_dir, exist_ok=True)
    doc = dict(payload)
    doc.setdefault("t_wall", round(time.time(), 6))
    path = os.path.join(out_dir, HEALTH_FILENAME)
    _atomic_write(path, json.dumps(doc, indent=1, sort_keys=True))
    return path


def write_metrics(out_dir: str, registry, *,
                  extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """One synchronous rewrite of both surfaces; returns the JSON doc."""
    os.makedirs(out_dir, exist_ok=True)
    snapshot = registry.snapshot()
    doc = {"t_wall": round(time.time(), 6), "metrics": snapshot,
           "extra": extra or {}}
    _atomic_write(os.path.join(out_dir, PROM_FILENAME),
                  render_prom(snapshot))
    _atomic_write(os.path.join(out_dir, JSON_FILENAME),
                  json.dumps(doc, indent=1, sort_keys=True))
    return doc


class MetricsExporter:
    """Daemon-thread rewriter of ``metrics.prom`` + ``metrics.json``.

    ``extra_fn`` (optional, called per rewrite) supplies the JSON twin's
    ``extra`` dict — the serve engine passes queue depth / breaker /
    quarantine state this way so ``obs top`` sees live scheduler state
    the registry alone doesn't carry. A throwing ``extra_fn`` degrades
    to ``{}``; a failed rewrite is counted (``write_failures``) and the
    cadence continues — the exporter must never take down the run.
    """

    def __init__(self, registry, out_dir: str, *, every_s: float = 2.0,
                 extra_fn: Callable[[], dict] | None = None):
        if every_s <= 0:
            raise ValueError(f"every_s must be > 0, got {every_s}")
        self.registry = registry
        self.out_dir = out_dir
        self.every_s = float(every_s)
        self.extra_fn = extra_fn
        self.writes = 0
        self.write_failures = 0
        # Guards the write counters (bumped by the exporter thread AND
        # any caller invoking write_once directly) and the start/stop
        # thread-handle transition.
        self._lock = lockwitness.make_lock("MetricsExporter._lock")
        self._stop = lockwitness.make_event("MetricsExporter._stop")
        self._thread: threading.Thread | None = None

    def write_once(self) -> bool:
        extra: dict[str, Any] = {}
        if self.extra_fn is not None:
            try:
                extra = dict(self.extra_fn() or {})
            except Exception:
                extra = {}
        try:
            write_metrics(self.out_dir, self.registry, extra=extra)
        except OSError:
            with self._lock:
                self.write_failures += 1
            return False
        with self._lock:
            self.writes += 1
        return True

    def start(self) -> "MetricsExporter":
        t = threading.Thread(target=self._loop, daemon=True)
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            # Join OUTSIDE the lock: the loop thread must keep running.
            t.join(timeout=2.0)
        self.write_once()                  # final flush: surface run end

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _loop(self) -> None:
        self.write_once()
        while not self._stop.wait(self.every_s):
            self.write_once()
