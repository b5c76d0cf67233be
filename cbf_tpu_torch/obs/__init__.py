"""Streaming telemetry: in-flight visibility for compiled rollouts
(counterpart: cbf_tpu/obs/).

A tap wraps the step (``obs.tap``), the engine emits its sampled
heartbeats between chunks into a structured sink that writes a
schema-versioned JSONL event stream and run manifest (``obs.sink``), and
a watchdog raises structured alerts — NaN, certificate blow-up, sustained
infeasibility, stalls — while the run goes on (``obs.watchdog``).

    from cbf_tpu_torch import obs

    sink = obs.TelemetrySink("runs/demo", manifest=obs.build_manifest(cfg))
    with obs.Watchdog(sink, stall_timeout=60):
        final, outs = rollout(step, state0, steps,
                              telemetry=sink, telemetry_every=50)
    sink.summary()

    $ python -m cbf_tpu_torch obs tail runs/demo --follow
    $ python -m cbf_tpu_torch obs summary runs/demo

``obs.resource`` measures each program at its capture and keeps an EWMA
execute-time cost model (``costmodel.json``). The serve engine's request
lifecycle tracer (``obs.trace``) and the incident flight recorder
(``obs.flight``) come with its drain mode; the continuous scheduler's
lane ledger (``obs.lanes``: exact integer-nanosecond lane-time
attribution, ``serve.lanes.*`` metrics, ``serve.lanes.window`` events)
and the metrics exporter (``obs.export``: ``metrics.prom`` and
``metrics.json``, read by ``obs top`` and ``obs lanes``) with its
continuous mode.
"""

from cbf_tpu_torch.obs.export import (MetricsExporter, render_prom,
                                      split_bucket, write_metrics)
from cbf_tpu_torch.obs.lanes import LANE_STATES, LaneLedger
from cbf_tpu_torch.obs.resource import CostModel, analyze_compiled, \
    environment
from cbf_tpu_torch.obs.schema import HEARTBEAT_FIELDS, SCHEMA_VERSION
from cbf_tpu_torch.obs.sink import (Histogram, MetricsRegistry,
                                    TelemetrySink, build_manifest,
                                    read_events, read_manifest,
                                    summarize_run, tail_events)
from cbf_tpu_torch.obs.tap import emit_ensemble_chunk, instrument_step
from cbf_tpu_torch.obs.watchdog import (ALERT_CERT_BLOWUP, ALERT_INFEASIBLE,
                                        ALERT_KINDS, ALERT_LOW_OCCUPANCY,
                                        ALERT_NAN, ALERT_SLO_BURN,
                                        ALERT_STALL, Alert, SLOTargets,
                                        Watchdog)

__all__ = [
    "SCHEMA_VERSION", "HEARTBEAT_FIELDS", "Histogram", "MetricsRegistry",
    "TelemetrySink", "build_manifest", "read_events", "read_manifest",
    "summarize_run", "tail_events", "emit_ensemble_chunk", "instrument_step",
    "Alert", "Watchdog", "SLOTargets", "ALERT_KINDS", "ALERT_NAN",
    "ALERT_CERT_BLOWUP", "ALERT_INFEASIBLE", "ALERT_STALL",
    "ALERT_SLO_BURN", "ALERT_LOW_OCCUPANCY",
    "CostModel", "analyze_compiled", "environment",
    "LaneLedger", "LANE_STATES",
    "MetricsExporter", "render_prom", "split_bucket", "write_metrics",
]
