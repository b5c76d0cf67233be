"""Telemetry event schema (counterpart: cbf_tpu/obs/schema.py): the one
mapping from the port's observability records
(:class:`cbf_tpu_torch.rollout.engine.StepOutputs`,
:class:`cbf_tpu_torch.parallel.ensemble.EnsembleMetrics`) to the streamed
heartbeat fields, with the JAX package's names, reductions and kinds.

Events are JSON objects, one per line (JSONL), each carrying ``schema`` =
:data:`SCHEMA_VERSION`:

- ``heartbeat`` — a sampled snapshot: ``step`` (global step index),
  ``t_wall`` (host receive time, s), ``step_rate`` (steps/s since the
  previous heartbeat; null on the first), one key per tracked
  :data:`HEARTBEAT_FIELDS` entry, and ``ensemble_members`` on the
  ensemble path;
- ``alert`` — a watchdog verdict: ``kind`` (``obs.watchdog.ALERT_KINDS``),
  ``step`` (null for host-side alerts such as stalls), ``detail``,
  ``severity`` and ``t_wall`` (plus ``rta_mode`` when the run streams it);
- ``summary`` — the run-end registry snapshot (``metrics``) with the
  ``heartbeats`` and ``alerts`` totals.

The run manifest is ``manifest.json`` in the run directory. The serve
engine's drain mode, its tracer, the request journal and the flight
recorder, the load generator and the lane ledger declare their events
here (:data:`SERVE_EVENT_TYPES`, :data:`DURABLE_EVENT_TYPES`,
:data:`FLIGHT_EVENT_TYPES`, :data:`LOADGEN_EVENT_TYPES`,
:data:`LANES_EVENT_TYPES`); the event tables of the HA, cluster and fleet
layers arrive with their emitters (Queue A11).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

SCHEMA_VERSION = 1

EVENT_TYPES = ("heartbeat", "alert", "summary")

#: Name of the per-run manifest file inside a run directory.
MANIFEST_FILENAME = "manifest.json"
#: Name of the event-stream file inside a run directory.
EVENTS_FILENAME = "events.jsonl"


class HeartbeatField(NamedTuple):
    """One streamed heartbeat channel: its StepOutputs / EnsembleMetrics
    twin (None where the struct has none), how member values fold into
    the streamed scalar ("min" | "max" | "sum") and its registry kind
    ("counter" sums across heartbeats, "gauge" keeps last/min/max and a
    histogram)."""
    name: str
    step_output: str | None
    ensemble: str | None
    reduce: str
    kind: str


HEARTBEAT_FIELDS: tuple[HeartbeatField, ...] = (
    HeartbeatField("min_pairwise_distance", "min_pairwise_distance",
                   "nearest_distance", "min", "gauge"),
    HeartbeatField("filter_active_count", "filter_active_count",
                   "engaged_count", "sum", "counter"),
    HeartbeatField("infeasible_count", "infeasible_count",
                   "infeasible_count", "sum", "counter"),
    HeartbeatField("max_relax_rounds", "max_relax_rounds",
                   None, "max", "gauge"),
    HeartbeatField("gating_overflow_count", "gating_overflow_count",
                   None, "sum", "counter"),
    HeartbeatField("gating_dropped_count", "gating_dropped_count",
                   "dropped_count", "sum", "counter"),
    HeartbeatField("certificate_residual", "certificate_residual",
                   "certificate_residual", "max", "gauge"),
    HeartbeatField("certificate_dropped_count", "certificate_dropped_count",
                   "certificate_dropped", "max", "counter"),
    HeartbeatField("saturation_deficit", "saturation_deficit",
                   "saturation_deficit", "max", "gauge"),
    HeartbeatField("certificate_iterations", "certificate_iterations",
                   "certificate_iterations", "max", "gauge"),
    # Tap-computed (no struct twin): the non-finite elements across the
    # float leaves of the post-step state. Min/max reductions may swallow
    # NaN, so no StepOutputs channel reliably goes non-finite; this one
    # counts the corruption and the watchdog's `nan` alert reads it.
    HeartbeatField("nonfinite_state_count", None, None, "sum", "gauge"),
    HeartbeatField("certificate_carry_resets", "certificate_carry_resets",
                   None, "sum", "counter"),
    HeartbeatField("rta_mode", "rta_mode", None, "max", "gauge"),
)

#: StepOutputs fields deliberately not streamed, with the reason.
EXCLUDED_STEP_OUTPUT_FIELDS: dict[str, str] = {
    "trajectory": "bulk (N, 2) per-agent positions — recorded via "
                  "record_trajectory/--traj and the native trajsink, not "
                  "telemetry (a heartbeat is scalars)",
}

#: EnsembleMetrics fields deliberately not streamed (none).
EXCLUDED_ENSEMBLE_FIELDS: dict[str, str] = {}

#: The falsifier's events (``verify.search.EMITTED_EVENT_TYPES``).
VERIFY_EVENT_TYPES: tuple[str, ...] = ("verify.round", "verify.margin")

VERIFY_EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    "verify.round": ("engine", "round", "candidates", "best_margin",
                     "violations", "evaluated"),
    "verify.margin": ("engine", "scenario", "property", "margin",
                      "found", "evaluated"),
}

#: The serving layer's events: the emitters' ``EMITTED_EVENT_TYPES``
#: (serve.engine + obs.trace) union to this tuple. ``request`` once per
#: served request, ``serve.span`` once per finished lifecycle span, and
#: the fault-tolerance family one event per recovery decision.
#: ``serve.partial`` is continuous mode's (Queue A11, item 11.2).
SERVE_EVENT_TYPES: tuple[str, ...] = (
    "request", "serve.span", "serve.partial", "serve.retry", "serve.shed",
    "serve.quarantine", "serve.degrade", "serve.scheduler_crash",
    "serve.cost")

SERVE_EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    "request": ("request_id", "bucket", "n", "steps", "latency_s",
                "queue_wait_s", "execute_s", "batch_fill", "degraded",
                "rta_engaged", "min_pairwise_distance", "infeasible_count",
                "ttfp_s"),
    "serve.span": ("trace_id", "span_id", "parent_id", "name", "bucket",
                   "t0_s", "dur_s", "track"),
    "serve.partial": ("request_id", "bucket", "steps_done", "steps_total",
                      "chunk", "min_pairwise_distance", "infeasible_count"),
    # action: "retry" | "bisect" | "demote" | "rta_rescue"; attempt is
    # 1-based for retries.
    "serve.retry": ("bucket", "action", "attempt", "batch_size",
                    "backoff_s", "error"),
    # reason: "queue_full" | "oldest_evicted" | "deadline" |
    # "bytes_budget" | "background_queue_full" | "background_evicted".
    "serve.shed": ("request_id", "bucket", "reason", "queue_depth",
                   "predicted_bytes"),
    # scope: "request" (signature breaker) | "bucket" (capture breaker).
    "serve.quarantine": ("scope", "signature", "state", "failures",
                         "bucket"),
    "serve.degrade": ("state", "queue_depth", "steps_frac"),
    "serve.scheduler_crash": ("error", "resolved"),
    # The cost model's execute prediction against the measured wall, and
    # the bucket program's measurements (flops and bytes accessed are
    # None in the port: a captured graph reports neither).
    "serve.cost": ("bucket", "batch_fill", "execute_s", "predicted_s",
                   "drift", "flops", "bytes_accessed", "peak_bytes"),
}

#: The durable-execution layer's events: ``durable.journal`` once when a
#: write-ahead request journal opens, ``durable.recover`` once per journal
#: replay onto an engine, ``durable.resume`` whenever a durable rollout
#: restarts from a checkpoint or skips a corrupt one. The emitters'
#: ``EMITTED_EVENT_TYPES`` (durable.journal + durable.rollout) union to
#: this tuple.
DURABLE_EVENT_TYPES: tuple[str, ...] = (
    "durable.journal", "durable.recover", "durable.resume")

DURABLE_EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    "durable.journal": ("path", "records", "unresolved", "repaired_bytes",
                        "epoch", "segments"),
    "durable.recover": ("path", "records", "reenqueued", "refused"),
    "durable.resume": ("directory", "resumed_from_step", "chunks_loaded",
                       "steps"),
}

#: The load generator's run-end record (``serve.loadgen``): offered vs
#: achieved rates and the end-to-end latency percentiles of one open-loop
#: traffic run. One event per loadgen run.
LOADGEN_EVENT_TYPES: tuple[str, ...] = ("loadgen.summary",)

LOADGEN_EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    # by_bucket: per-bucket SLO split — {bucket label: {completed, errors,
    # queue_wait_p50_s/p95_s/p99_s, execute_p50_s/p95_s/p99_s,
    # ttfp_p50_s/p95_s/p99_s}}; by_scenario: per-scenario split for mixed
    # feeds ({scenario: {completed, errors, latency_p50_s/p95_s/p99_s}});
    # ttfp_*: time-to-first-partial percentiles over completed requests
    # that streamed at least one serve.partial (null in drain mode).
    "loadgen.summary": ("seed", "offered_rps", "achieved_rps", "requests",
                        "completed", "errors", "duration_s",
                        "latency_p50_s", "latency_p95_s", "latency_p99_s",
                        "queue_wait_p99_s", "execute_p99_s",
                        "ttfp_p50_s", "ttfp_p95_s", "ttfp_p99_s",
                        "by_bucket", "by_scenario"),
}

#: The lane ledger's event (``obs.lanes``): ``serve.lanes.window`` once
#: every ``LaneLedger.emit_every`` executed chunks — the window's exact
#: integer-nanosecond accounting (``busy_ns + padding_ns + vacancy_ns +
#: dispatch_ns == total_ns`` == lanes x wall; ``identity_ok`` is that
#: integer equality), the derived occupancy/bubble/dispatch percentages,
#: the window's join/vacate/preempt counts and rates, and a per-bucket
#: ``by_bucket`` split ({bucket label: {chunks, occupancy_pct,
#: dispatch_pct}}).
LANES_EVENT_TYPES: tuple[str, ...] = ("serve.lanes.window",)

LANES_EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    "serve.lanes.window": ("chunks", "busy_ns", "padding_ns", "vacancy_ns",
                           "dispatch_ns", "total_ns", "occupancy_pct",
                           "bubble_pct", "dispatch_pct", "identity_ok",
                           "joins", "vacates", "preempted", "join_rate",
                           "vacate_rate", "by_bucket"),
}

#: The incident flight recorder's event (``obs.flight``): one
#: ``flight.capsule`` per capsule written.
FLIGHT_EVENT_TYPES: tuple[str, ...] = ("flight.capsule",)

FLIGHT_EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    "flight.capsule": ("reason", "detail", "capsule", "events",
                       "trigger_event"),
}

#: The runtime-assurance auditor's events (``rta.monitor``).
RTA_EVENT_TYPES: tuple[str, ...] = ("rta.engage", "rta.recover")

RTA_EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    "rta.engage": ("step", "rung", "prev_rung"),
    "rta.recover": ("step", "peak_rung", "engaged_steps"),
}


def step_output_channels() -> dict[str, HeartbeatField]:
    """StepOutputs field name -> HeartbeatField for every streamed field."""
    return {f.step_output: f for f in HEARTBEAT_FIELDS
            if f.step_output is not None}


def ensemble_channels() -> dict[str, HeartbeatField]:
    """EnsembleMetrics field name -> HeartbeatField for every streamed
    field."""
    return {f.ensemble: f for f in HEARTBEAT_FIELDS
            if f.ensemble is not None}


def field_by_name(name: str) -> HeartbeatField:
    for f in HEARTBEAT_FIELDS:
        if f.name == name:
            return f
    raise KeyError(name)


_REDUCERS = {"min": min, "max": max, "sum": sum}


def reduce_members(field: HeartbeatField, values) -> float:
    """Fold one channel's per-member values into the streamed scalar, per
    the field's declared reduction."""
    vals = list(values)
    if not vals:
        raise ValueError(f"no values to reduce for {field.name}")
    return _REDUCERS[field.reduce](vals)


def json_scalar(v: Any):
    """A JSON-encodable scalar: NaN and infinities as strings (strict JSON
    has no non-finite numbers), integral floats as ints."""
    f = float(v)
    if math.isnan(f):
        return "nan"
    if math.isinf(f):
        return "inf" if f > 0 else "-inf"
    if f == int(f) and abs(f) < 2**53:
        return int(f)
    return f


def scalar_value(v: Any) -> float:
    """Parse an event value back to float (inverse of :func:`json_scalar`)."""
    return float(v)
