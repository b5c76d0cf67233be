"""Per-program resource accounting and a predicted-vs-measured
execute-time cost model (counterpart: cbf_tpu/obs/resource.py).

The JAX package reads XLA's cost and memory analysis at the
``lower().compile()`` site. Here the counterpart of a compile is the
program's capture (:meth:`cbf_tpu_torch.rollout.engine._Program.prepare`),
and what it measures is what the port can measure there: the static
argument buffers' bytes, the per-step output buffers' bytes and, on the
card, the peak device bytes of the warm-up and capture
(``torch.cuda.max_memory_allocated``). XLA's ``flops``, ``bytes_accessed``,
``transcendentals``, temp, alias and generated-code bytes have no
counterpart and are written as ``None`` (null), never as a made-up 0;
``peak_bytes`` is null on the CPU. Entries persist to a schema-versioned
``costmodel.json`` keyed by label and environment (torch, CUDA, the card,
git SHA), so a model from another machine or commit is dropped on load.

- :func:`analyze_compiled` — one prepared program's measurements as a flat
  dict; never raises (an object without measurements gives nulls);
- :class:`CostModel` — the per-label store: ``record_compile`` folds in
  one capture (measurements and capture wall), ``observe_execute``
  returns the pre-update prediction, the measurement and the drift,
  ``fits`` scales the worst recorded per-agent peak bytes;
- :meth:`CostModel.compile_and_record` — prepares a program once per
  cache key and records it.

Everything here is host-side; the model never touches device values, so
accounting on or off leaves a rollout bit-identical.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from cbf_tpu_torch.analysis import lockwitness

#: Bump when the costmodel.json layout changes incompatibly.
RESOURCE_SCHEMA_VERSION = 1

#: File name of the persisted cost model inside a run/cache directory.
COSTMODEL_FILENAME = "costmodel.json"

#: EWMA smoothing for measured execute time (0 < alpha <= 1).
EWMA_ALPHA = 0.3

#: Bounded per-label history of recent drift observations.
DRIFT_WINDOW = 64

#: The measurement keys of :func:`analyze_compiled` (the JAX package's).
COST_KEYS = ("flops", "bytes_accessed", "transcendentals", "argument_bytes",
             "output_bytes", "temp_bytes", "alias_bytes",
             "generated_code_bytes", "peak_bytes")


def _git_sha() -> str:
    head = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), ".git", "HEAD")
    try:
        with open(head) as fh:
            ref = fh.read().strip()
        if ref.startswith("ref:"):
            with open(os.path.join(os.path.dirname(head),
                                   ref.split(None, 1)[1])) as fh:
                return fh.read().strip()[:12]
        return ref[:12]
    except OSError:
        return "unknown"


def environment() -> dict[str, str]:
    """The cache-key half that is not the label: torch and CUDA versions,
    the card (or "cpu") and the git SHA. A loaded model whose environment
    differs is discarded."""
    import torch

    try:
        device = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                  else "cpu")
    except Exception:  # pragma: no cover - a broken driver
        device = "unknown"
    return {"torch": torch.__version__, "cuda": str(torch.version.cuda),
            "device": device, "git_sha": _git_sha()}


def analyze_compiled(program) -> dict[str, int | None]:
    """One prepared program's measurements (module docstring) under the JAX
    package's keys, ``None`` where the port measures nothing. Never
    raises."""
    out = dict.fromkeys(COST_KEYS)
    measured = getattr(program, "analysis", None)
    if isinstance(measured, dict):
        for key in COST_KEYS:
            v = measured.get(key)
            out[key] = None if v is None else int(v)
    return out


class CostModel:
    """Thread-safe per-label cost store with optional JSON persistence.

    One entry per label (a rollout tag, a verify batch signature). Each
    entry carries the measurements of :func:`analyze_compiled`, the
    capture count and wall (``compiles``/``compile_s``), an EWMA of the
    measured execute wall, and a bounded window of recent prediction
    drift. ``path=None`` keeps the model in memory; with a path every
    capture is flushed via :meth:`save` (atomic tmp + ``os.replace``).
    """

    def __init__(self, path: str | None = None, *,
                 env: dict[str, str] | None = None):
        self.path = path
        self.env = dict(env) if env is not None else environment()
        self.entries: dict[str, dict[str, Any]] = {}
        self._lock = lockwitness.make_lock("CostModel._lock")
        self._execs: dict[Any, Any] = {}
        if path is not None and os.path.exists(path):
            self._load(path)

    # -- persistence -------------------------------------------------------

    def _load(self, path: str) -> None:
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return                         # corrupt/partial: start fresh
        if doc.get("resource_schema") != RESOURCE_SCHEMA_VERSION:
            return
        if doc.get("environment") != self.env:
            return                         # other machine/commit: stale
        entries = doc.get("entries")
        if isinstance(entries, dict):
            self.entries = {str(k): dict(v) for k, v in entries.items()
                            if isinstance(v, dict)}

    def to_doc(self) -> dict[str, Any]:
        with self._lock:
            entries = {k: dict(v) for k, v in self.entries.items()}
        return {"resource_schema": RESOURCE_SCHEMA_VERSION,
                "environment": dict(self.env), "entries": entries}

    def save(self, path: str | None = None) -> str | None:
        """Atomically rewrite the model file (no-op without a path)."""
        path = path or self.path
        if path is None:
            return None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.to_doc(), fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    # -- recording ---------------------------------------------------------

    def _entry(self, label: str) -> dict[str, Any]:
        e = self.entries.get(label)
        if e is None:
            e = self.entries[label] = {
                "compiles": 0, "compile_s": 0.0, "cost": {},
                "execute_ewma_s": None, "executes": 0, "drift_recent": []}
        return e

    def record_compile(self, label: str, compiled, compile_s: float,
                       *, save: bool = True) -> dict[str, int]:
        """Fold one prepared program (its capture wall ``compile_s``) into
        the model; returns its measurements."""
        cost = analyze_compiled(compiled)
        with self._lock:
            e = self._entry(label)
            e["compiles"] += 1
            e["compile_s"] = round(e["compile_s"] + float(compile_s), 6)
            e["cost"] = cost
        if save:
            try:
                self.save()
            except OSError:
                pass                       # accounting never kills a run
        return cost

    def observe_execute(self, label: str, execute_s: float
                        ) -> dict[str, Any]:
        """Record one measured execute wall; returns the PRE-update
        prediction (None on the label's first observation), the
        measurement, and the relative drift |pred - meas| / meas."""
        execute_s = float(execute_s)
        with self._lock:
            e = self._entry(label)
            predicted = e["execute_ewma_s"]
            drift = None
            if predicted is not None and execute_s > 0:
                drift = abs(predicted - execute_s) / execute_s
                recent = e["drift_recent"]
                recent.append(round(drift, 6))
                del recent[:-DRIFT_WINDOW]
            if predicted is None:
                e["execute_ewma_s"] = round(execute_s, 6)
            else:
                e["execute_ewma_s"] = round(
                    (1.0 - EWMA_ALPHA) * predicted
                    + EWMA_ALPHA * execute_s, 6)
            e["executes"] += 1
        return {"predicted_s": predicted, "measured_s": execute_s,
                "drift": drift}

    def predict_execute(self, label: str) -> float | None:
        with self._lock:
            e = self.entries.get(label)
            return None if e is None else e["execute_ewma_s"]

    def cost_of(self, label: str) -> dict[str, int]:
        with self._lock:
            e = self.entries.get(label)
            return dict(e["cost"]) if e else {}

    def drift_summary(self) -> dict[str, float]:
        """Per-label median of the recent drift window (the warm-path drift
        the card run reports)."""
        out: dict[str, float] = {}
        with self._lock:
            for label, e in self.entries.items():
                recent = sorted(e.get("drift_recent") or [])
                if recent:
                    mid = len(recent) // 2
                    med = (recent[mid] if len(recent) % 2
                           else 0.5 * (recent[mid - 1] + recent[mid]))
                    out[label] = round(med, 6)
        return out

    # -- capacity ----------------------------------------------------------

    def predict_peak_bytes(self, n: int) -> int:
        """Predicted device peak bytes for an ``n``-agent swarm: the worst
        recorded per-agent peak across entries whose label encodes a size
        (``n<k>-...``), scaled to ``n``. 0 when nothing is priced (callers
        treat 0 as unpriced and fail open)."""
        per_agent = 0.0
        with self._lock:
            for label, e in self.entries.items():
                peak = (e.get("cost") or {}).get("peak_bytes")
                if not (peak and label.startswith("n")):
                    continue
                digits = label[1:].split("-", 1)[0]
                if digits.isdigit() and int(digits) > 0:
                    per_agent = max(per_agent, peak / int(digits))
        return int(per_agent * int(n))

    def fits(self, n: int, mesh=None, *,
             budget_bytes: int | None = None) -> bool:
        """Would an ``n``-agent swarm fit one card's memory? Scales the
        worst recorded per-agent peak (:meth:`predict_peak_bytes`). The
        budget is, in order: ``budget_bytes``, the total memory of the
        mesh's card (``mesh.device``), or of card 0 when no mesh is given
        and a card is present; with none known (the CPU) it fails open
        (True), as does a model with nothing priced."""
        import torch

        predicted = self.predict_peak_bytes(n)
        if predicted <= 0:
            return True                    # nothing priced yet: fail open
        if budget_bytes is None:
            device = getattr(mesh, "device", None)
            if device is None and mesh is None and torch.cuda.is_available():
                device = torch.device("cuda", 0)
            if device is not None and torch.device(device).type == "cuda":
                budget_bytes = torch.cuda.get_device_properties(
                    device).total_memory
        if budget_bytes is None:
            return True
        return predicted <= budget_bytes

    # -- capture helper ----------------------------------------------------

    def compile_and_record(self, label: str, prepare, args: tuple = (),
                           *, cache_key=None):
        """Prepare a program with ``prepare(*args)`` (the engine's
        :meth:`~cbf_tpu_torch.rollout.engine._Program.prepare`) once per
        ``cache_key`` (default: the label), record it with its wall, and
        return it; a cached key returns the same program without
        preparing again."""
        key = cache_key if cache_key is not None else label
        with self._lock:
            hit = self._execs.get(key)
        if hit is not None:
            return hit
        t0 = time.perf_counter()
        program = prepare(*args)
        wall = time.perf_counter() - t0
        self.record_compile(label, program, wall)
        with self._lock:
            self._execs[key] = program
        return program
