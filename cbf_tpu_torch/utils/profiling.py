"""Tracing and profiling hooks (counterpart: cbf_tpu/utils/profiling.py).

- :func:`trace` — a ``torch.profiler`` trace of a code region, written as
  a Chrome trace (``trace.json`` in the log directory): host spans, the
  swarm step's :func:`annotate` phases and, on the card, the kernels
  (those of CUDA graph replays included);
- :func:`annotate` — the named phase spans (consensus, gating, filter,
  integrate) the swarm step wraps its phases in;
- :func:`compile_event_counts` — the engine's captures, replays and redos
  (``rollout.engine.COUNTS``, as ``engine.<name>``) and any framework
  counter added with :func:`add_event_count`, counted from the last
  :func:`reset_compile_event_counts` — the counterpart of the JAX
  package's compile and cache-hit counters;
- :class:`StepTimer` and the TensorBoard scalar export, which returns
  None where no writer backend is importable.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_NAME = "trace.json"

_event_counts: dict[str, int] = {}
_engine_base: dict[str, int] = {}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region into ``log_dir/trace.json`` (Chrome trace format;
    the card's activity too when one is present)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


def annotate(name: str):
    """Named span context; shows up as a ``record_function`` range in a
    :func:`trace` and costs a few microseconds when no profiler is
    running. Inside a captured body the span is recorded at capture: a
    graph replay shows the body's kernels, not its spans."""
    return torch.profiler.record_function(name)


def compile_event_counts() -> dict[str, int]:
    """The engine's capture/replay/redo counters and the framework
    counters since the last reset (nonzero entries). The telemetry
    manifest snapshots them at run start and the summary records the
    delta: an unstable program key capturing every chunk shows up here."""
    from cbf_tpu_torch.rollout.engine import COUNTS

    out = {f"engine.{k}": v - _engine_base.get(k, 0)
           for k, v in COUNTS.items() if v != _engine_base.get(k, 0)}
    out.update(_event_counts)
    return out


def reset_compile_event_counts() -> None:
    """Zero the counters (scoping a measurement to one run)."""
    from cbf_tpu_torch.rollout.engine import COUNTS

    _engine_base.clear()
    _engine_base.update(COUNTS)
    _event_counts.clear()


def add_event_count(name: str, value: int = 1) -> None:
    """Fold a framework-level event into the same counters."""
    _event_counts[name] = _event_counts.get(name, 0) + int(value)


class StepTimer:
    """Wall-clock phase timer for host-side loops (chunk boundaries,
    checkpoint writes) — complements the device trace."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def summary(self) -> str:
        return " ".join(f"{k}={v:.3f}s"
                        for k, v in sorted(self.totals.items()))


def tensorboard_available() -> bool:
    """True when a TensorBoard scalar writer backend is importable."""
    try:
        import tensorboardX  # noqa: F401

        return True
    except ImportError:
        return False


def export_scalars_to_tensorboard(run_dir: str,
                                  log_dir: str | None = None) -> str | None:
    """Export a telemetry run's heartbeats as TensorBoard scalars — one tag
    per heartbeat channel plus ``step_rate``, stepped by the global step.
    Returns None (no-op) when no writer backend is importable, else the
    log directory written (default ``<run_dir>/tensorboard``)."""
    if not tensorboard_available():
        return None
    from tensorboardX import SummaryWriter

    from cbf_tpu_torch.obs import schema as obs_schema
    from cbf_tpu_torch.obs.sink import read_events

    log_dir = log_dir or f"{run_dir.rstrip('/')}/tensorboard"
    writer = SummaryWriter(log_dir)
    try:
        for ev in read_events(run_dir):
            if ev.get("event") != "heartbeat":
                continue
            step = int(ev.get("step", 0))
            for f in obs_schema.HEARTBEAT_FIELDS:
                if f.name in ev:
                    writer.add_scalar(f"telemetry/{f.name}",
                                      obs_schema.scalar_value(ev[f.name]),
                                      global_step=step)
            if ev.get("step_rate") is not None:
                writer.add_scalar("telemetry/step_rate", ev["step_rate"],
                                  global_step=step)
    finally:
        writer.close()
    return log_dir
