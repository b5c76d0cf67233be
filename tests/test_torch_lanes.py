"""The port's lane ledger (cbf_tpu_torch.obs.lanes), its engine wiring,
the burn-rate SLO alerts and the ``obs lanes`` surface, on the CPU.

- tests/test_lanes.py:83-590 on the port: the exact integer-nanosecond
  identity (busy + padding + vacancy + dispatch == lanes x wall) per
  record, per ``serve.lanes.window`` event and cumulatively;
  ``subtract``/``derive``; bitmap conservation and vocabulary; engine
  conservation across join, leave, cancel and deadline; the ledger off is
  bit-neutral and armed bit-identical; the default arming; ``slo_burn``
  and ``sustained_low_occupancy``; the capsule and flight contexts; the
  Chrome trace's lane tracks and flow links and the engine's track spans;
  the loadgen's lane deltas and TTFP split; the registry exports; ``obs
  lanes``'s table, exit codes and timeline export.
- Against the JAX package: the same ledger stamps give the same records
  and totals; ``obs lanes`` renders equal text from a ``metrics.json``
  written by either package's exporter, in either package's CLI.
- The watchdog's ``sustained_low_occupancy`` fed by a live engine's
  ledger; ``serve --continuous --metrics-dir`` through the CLI.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from cbf_tpu.__main__ import main as jcli_main
from cbf_tpu.obs import export as jexport
from cbf_tpu.obs import lanes as jlanes
from cbf_tpu.obs.sink import MetricsRegistry as JMetricsRegistry
from cbf_tpu_torch import obs
from cbf_tpu_torch.obs import lanes as obs_lanes
from cbf_tpu_torch.obs import schema as obs_schema
from cbf_tpu_torch.obs.lanes import LANE_STATES, LaneLedger
from cbf_tpu_torch.obs.trace import build_chrome_trace
from cbf_tpu_torch.obs.watchdog import (ALERT_LOW_OCCUPANCY,
                                        ALERT_SLO_BURN, SLOTargets, Watchdog)
from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.serve import (DeadlineExceeded, LoadSpec, ServeEngine,
                                 build_schedule, run_loadgen)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(steps=24, seed=0, n=8):
    return swarm.Config(n=n, steps=steps, seed=seed, gating="jnp")


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [np.asarray(tree)]


def _tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    return all(np.array_equal(x, y) for x, y in zip(la, lb))


def _identity(acct):
    return (acct["busy_ns"] + acct["padding_ns"] + acct["vacancy_ns"]
            + acct["dispatch_ns"]) == acct["total_ns"]


class _StubSink:
    """Captures (type, payload) pairs; no meta keys added — payloads
    compare EXACTLY against the schema field tuple."""

    registry = None

    def __init__(self):
        self.events = []

    def event(self, etype, payload):
        self.events.append((etype, dict(payload)))


# ------------------------------------------------ exact time identity --

def test_identity_exact_per_record_window_and_cumulative():
    sink = _StubSink()
    led = LaneLedger(sink=sink, window=16, emit_every=4)
    # Hostile primes: wall/execute/steps chosen so float math WOULD
    # round — integer accounting must not.
    cases = [
        (4, 16, [(0, "r0", 16, 0.1), (2, "r1", 7, 0.2)], 1_000_003, 999_983),
        (4, 16, [], 7919, 0),                      # all-vacant chunk
        (3, 8, [(0, "a", 8, 0.0), (1, "b", 8, 0.0), (2, "c", 8, 0.0)],
         104_729, 104_729),                        # full, zero dispatch
        (5, 32, [(4, "z", 1, 3.0)], 2_750_159, 13),
    ]
    for i, (lanes, steps, rows, wall, execute) in enumerate(cases * 2):
        rec = led.note_chunk(f"c{i}", f"bucket{i % 2}", lanes=lanes,
                             chunk_steps=steps, lane_rows=rows,
                             wall_ns=wall, execute_ns=execute,
                             pack_ns=3, unpack_ns=5)
        assert _identity(rec), rec
        assert rec["total_ns"] == lanes * wall
        assert rec["vacancy_ns"] == (lanes - len(rows)) * wall
        assert all(isinstance(rec[k], int) for k in
                   ("busy_ns", "padding_ns", "vacancy_ns", "dispatch_ns",
                    "total_ns"))
    # Cumulative: global, and per bucket.
    assert led.totals()["identity_ok"]
    assert _identity(led.totals())
    for acct in led.bucket_totals().values():
        assert acct["identity_ok"] and _identity(acct)
    # Window events: every emitted delta holds the identity exactly and
    # carries exactly the schema's field tuple.
    window_events = [p for t, p in sink.events
                     if t == "serve.lanes.window"]
    assert len(window_events) == 2          # 8 chunks / emit_every=4
    fields = obs_schema.LANES_EVENT_FIELDS["serve.lanes.window"]
    for ev in window_events:
        assert set(ev) == set(fields)
        assert ev["identity_ok"] and _identity(ev)
        assert ev["chunks"] == 4
    # The two window deltas + nothing else == the cumulative totals.
    tot = led.totals()
    for k in ("busy_ns", "vacancy_ns", "dispatch_ns", "total_ns"):
        assert sum(ev[k] for ev in window_events) == tot[k]


def test_subtract_derive_keep_identity_on_deltas():
    a = {"chunks": 7, "busy_ns": 101, "padding_ns": 13, "vacancy_ns": 17,
         "dispatch_ns": 19, "total_ns": 150, "joins": 3, "vacates": 2,
         "preempted": 0}
    b = {"chunks": 4, "busy_ns": 41, "padding_ns": 5, "vacancy_ns": 11,
         "dispatch_ns": 13, "total_ns": 70, "joins": 1, "vacates": 1,
         "preempted": 0}
    d = obs_lanes.derive(obs_lanes.subtract(a, b))
    assert d["identity_ok"] and d["chunks"] == 3
    assert d["total_ns"] == 80 and d["busy_ns"] == 60
    assert d["occupancy_pct"] == 75.0
    zero = obs_lanes.derive(obs_lanes.subtract(a, a))
    assert zero["identity_ok"] and zero["occupancy_pct"] == 0.0


# --------------------------------------------------- bitmap conservation --

def test_bitmap_conservation_and_vocabulary():
    led = LaneLedger()
    rec = led.note_chunk("c", "b", lanes=4, chunk_steps=8,
                         lane_rows=[(0, "r0", 8, 0.1), (2, "r1", 3, 0.2)],
                         wall_ns=100, execute_ns=60, pack_ns=1,
                         unpack_ns=1)
    assert rec["bitmap"] == "AVPV"
    assert len(rec["bitmap"]) == rec["lanes"]
    assert set(rec["bitmap"]) <= set(LANE_STATES)
    assert rec["fill"] == sum(c != "V" for c in rec["bitmap"]) == 2
    assert [m["slot"] for m in rec["lane_map"]] == [0, 2]
    assert rec["lane_map"][1]["pad"] == 5
    # Background preemption: denied lanes show as B, the rest V, and the
    # pass is counted without fabricating a chunk record.
    led.note_preempted("bg", 4, [1, 3])
    snap = led.snapshot()
    assert snap["tables"]["bg"]["bitmap"] == "VBVB"
    assert snap["tables"]["bg"]["background"] is True
    assert led.totals("bg")["preempted"] == 2
    assert led.totals("bg")["chunks"] == 0


def test_engine_conservation_across_join_leave_cancel_deadline():
    """Through the real scheduler: every lane joined is eventually
    vacated (resolve AND deadline-eviction paths), cancels never touch a
    lane, and every stamped record conserves the bitmap."""
    engine = ServeEngine(max_batch=4, bucket_sizes=(16,),
                         continuous=True, chunk_steps=8,
                         lane_ledger=LaneLedger(), device="cpu")
    engine.prewarm([_cfg()])
    engine.start()
    try:
        done = [engine.submit(_cfg(steps=24, seed=s)) for s in (1, 2)]
        doomed = engine.submit(_cfg(steps=4096, seed=9), deadline_s=0.4)
        for p in done:
            p.result(timeout=180)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=180)
        # A queued-then-cancelled request must not count as a lane join:
        # occupy the table first so the victim stays queued.
        blocker = engine.submit(_cfg(steps=256, seed=5))
        victim = engine.submit(_cfg(steps=8, seed=6))
        assert victim.cancel()
        blocker.result(timeout=300)
    finally:
        engine.stop()
    led = engine.lanes
    tot = led.totals()
    assert tot["joins"] == 4                  # 2 resolved + doomed + blocker
    assert tot["vacates"] == tot["joins"]     # conservation after drain
    assert tot["identity_ok"] and tot["chunks"] > 0
    for rec in led.records():
        assert len(rec["bitmap"]) == rec["lanes"]
        assert set(rec["bitmap"]) <= set(LANE_STATES)
        assert rec["fill"] == sum(c != "V" for c in rec["bitmap"])
        assert rec["fill"] == len(rec["lane_map"])
        assert _identity(rec)
        assert rec["execute_ns"] <= rec["wall_ns"]


# ------------------------------------------------------- bit-neutrality --

def test_ledger_off_bit_neutral_and_armed_bit_identical():
    """PR 16's join bit-identity, extended: ledger OFF (engine.lanes is
    None — the scheduler takes zero extra clock reads) and ledger ARMED
    both produce bit-identical request results."""
    results = {}
    for armed in (False, True):
        engine = ServeEngine(max_batch=4, bucket_sizes=(16,),
                             continuous=True, chunk_steps=8,
                             lane_ledger=LaneLedger() if armed else False,
                             device="cpu")
        assert (engine.lanes is not None) is armed
        engine.prewarm([_cfg()])
        engine.start()
        try:
            results[armed] = engine.submit(
                _cfg(steps=24, seed=3)).result(timeout=180)
        finally:
            engine.stop()
        if armed:
            tot = engine.lanes.totals()
            assert tot["chunks"] == 3 and tot["identity_ok"]
    off, on = results[False], results[True]
    assert _tree_equal(on.outputs, off.outputs)
    assert np.array_equal(np.asarray(on.final_state.x),
                          np.asarray(off.final_state.x))


def test_engine_arms_ledger_by_default_with_telemetry(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path / "run"))
    eng = ServeEngine(continuous=True, telemetry=sink, device="cpu")
    assert isinstance(eng.lanes, LaneLedger)
    assert eng.lanes.registry is sink.registry
    # Drain mode / no sink: observatory stays off unless asked for.
    assert ServeEngine(telemetry=sink, device="cpu").lanes is None
    assert ServeEngine(continuous=True, device="cpu").lanes is None
    sink.close()


# ------------------------------------------------- burn-rate SLO alerts --

def test_slo_burn_trips_and_rearms(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path / "run"))
    wd = Watchdog(sink, slo=SLOTargets(queue_wait_p99_s=0.1,
                                       error_budget=0.01,
                                       min_requests=10))
    t0 = 1000.0

    def req(t, wait):
        wd._on_event({"event": "request", "queue_wait_s": wait,
                      "t_wall": t})

    for i in range(9):                       # below the sample floor
        req(t0 + i, 1.0)
    assert wd.alerts == []
    req(t0 + 9, 1.0)                         # 10th bad request: trips
    burns = [a for a in wd.alerts if a.kind == ALERT_SLO_BURN]
    assert len(burns) == 1 and burns[0].severity == "critical"
    assert "burning" in burns[0].detail
    for i in range(10, 20):                  # still burning: no re-trip
        req(t0 + i, 1.0)
    assert len([a for a in wd.alerts if a.kind == ALERT_SLO_BURN]) == 1
    # 70s later every fast-window sample is healthy -> burn < 1 -> re-arm
    for i in range(12):
        req(t0 + 80 + i, 0.0)
    # ... and a fresh burst of bad requests trips a SECOND alert.
    for i in range(12):
        req(t0 + 95 + i, 1.0)
    assert len([a for a in wd.alerts if a.kind == ALERT_SLO_BURN]) == 2
    wd.stop()
    sink.close()
    alerts = [e for e in obs.read_events(str(tmp_path / "run"))
              if e["event"] == "alert" and e["kind"] == ALERT_SLO_BURN]
    assert len(alerts) == 2                  # on the JSONL stream too


def test_sustained_low_occupancy_trips_warning_and_rearms(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path / "run"))
    wd = Watchdog(sink, slo=SLOTargets(occupancy_pct=50.0))
    t0 = 5000.0

    def occ(t, pct):
        wd._on_event({"event": "serve.lanes.window",
                      "occupancy_pct": pct, "t_wall": t})

    occ(t0, 10.0)                            # one sample: not sustained
    assert wd.alerts == []
    occ(t0 + 10, 12.0)                       # two fast-window lows: trips
    lows = [a for a in wd.alerts if a.kind == ALERT_LOW_OCCUPANCY]
    assert len(lows) == 1 and lows[0].severity == "warning"
    occ(t0 + 20, 9.0)                        # edge-triggered: no re-trip
    assert len([a for a in wd.alerts
                if a.kind == ALERT_LOW_OCCUPANCY]) == 1
    occ(t0 + 30, 80.0)                       # healthy sample re-arms
    # The healthy sample must age out of the fast window before a new
    # low streak counts as "every fast-window sample low".
    occ(t0 + 100, 5.0)
    occ(t0 + 110, 5.0)
    assert len([a for a in wd.alerts
                if a.kind == ALERT_LOW_OCCUPANCY]) == 2
    wd.stop()
    sink.close()


def test_slo_off_by_default(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path / "run"))
    wd = Watchdog(sink)                      # no SLOTargets: checks off
    wd._on_event({"event": "request", "queue_wait_s": 99.0,
                  "t_wall": 1.0})
    wd._on_event({"event": "serve.lanes.window", "occupancy_pct": 0.0,
                  "t_wall": 2.0})
    assert wd.alerts == []
    wd.stop()
    sink.close()


# ------------------------------------------- capsule context, every trip --

def test_capsule_context_on_every_trip_reason(tmp_path):
    from cbf_tpu_torch.obs import flight as obs_flight

    rec = obs_flight.FlightRecorder(str(tmp_path / "caps"),
                                    cooldown_s=0.0)
    led = LaneLedger()
    led.note_chunk("c0", "b", lanes=2, chunk_steps=8,
                   lane_rows=[(0, "r0", 8, 0.1)], wall_ns=100,
                   execute_ns=50, pack_ns=1, unpack_ns=1)
    rec.context_fn = lambda: {"lane_ledger": led.snapshot(recent=4),
                              "queue_depth": 0}
    # ANY reason — not just the burn-rate kinds — embeds the context.
    for reason in ("watchdog.slo_burn", "manual.test", "serve.sigterm"):
        path = rec.trip(reason, "x")
        doc = obs_flight.read_capsule(path)
        ctx = doc["context"]
        assert ctx["queue_depth"] == 0
        assert ctx["lane_ledger"]["chunks"] == 1
        assert ctx["lane_ledger"]["recent"][0]["bitmap"] == "AV"
        json.dumps(doc)                      # capsule stays JSON-safe
    # A raising context_fn degrades to an error marker, never propagates.
    rec.context_fn = lambda: 1 / 0
    doc = obs_flight.read_capsule(rec.trip("raising", "x"))
    assert "ZeroDivisionError" in doc["context"]["error"]


def test_engine_installs_flight_context(tmp_path):
    from cbf_tpu_torch.obs import flight as obs_flight

    sink = obs.TelemetrySink(str(tmp_path / "run"))
    rec = obs_flight.FlightRecorder(str(tmp_path / "caps")).attach(sink)
    engine = ServeEngine(continuous=True, telemetry=sink, flight=rec,
                         device="cpu")
    assert rec.context_fn is not None
    ctx = rec.context_fn()
    assert ctx["continuous"] is True and ctx["queue_depth"] == 0
    assert ctx["lane_ledger"]["armed"] is True
    # An explicit context_fn is never overwritten by the engine.
    rec2 = obs_flight.FlightRecorder(str(tmp_path / "caps2"))
    marker = lambda: {"custom": True}                  # noqa: E731
    rec2.context_fn = marker
    ServeEngine(continuous=True, telemetry=sink, flight=rec2, device="cpu")
    assert rec2.context_fn is marker
    del engine
    sink.close()


# ------------------------------------------------- trace tracks & flows --

def test_chrome_trace_tracks_and_flow_links():
    records = [
        {"name": "enqueue", "trace_id": "r1", "span_id": 1,
         "parent_id": None, "bucket": "b", "t0_s": 0.0, "dur_s": 0.001,
         "thread": 42, "track": None},
        {"name": "chunk", "trace_id": "r1", "span_id": 2,
         "parent_id": None, "bucket": "b", "t0_s": 0.002, "dur_s": 0.01,
         "thread": 43, "track": "b/lane0"},
        {"name": "chunk", "trace_id": "r1", "span_id": 3,
         "parent_id": None, "bucket": "b", "t0_s": 0.012, "dur_s": 0.01,
         "thread": 43, "track": "b/lane0"},
        {"name": "chunk", "trace_id": "r2", "span_id": 4,
         "parent_id": None, "bucket": "b", "t0_s": 0.02, "dur_s": 0.01,
         "thread": 43, "track": "b/lane1"},   # no enqueue: no flow
    ]
    doc = build_chrome_trace(records, epoch_wall=123.0, dropped=0)
    ev = doc["traceEvents"]
    # One named row per track, tids in the dedicated >= 1000 range.
    names = [e for e in ev if e.get("name") == "thread_name"]
    assert {e["args"]["name"] for e in names} == \
        {"lane b/lane0", "lane b/lane1"}
    assert all(e["tid"] >= 1000 for e in names)
    track_tids = {e["args"]["name"]: e["tid"] for e in names}
    chunks = [e for e in ev if e.get("name") == "chunk"]
    assert {e["tid"] for e in chunks
            if e["args"]["trace_id"] == "r1"} == \
        {track_tids["lane b/lane0"]}
    # Exactly one flow pair (r1): enqueue end -> first track span start.
    flows = [e for e in ev if e.get("cat") == "flow"]
    assert [e["ph"] for e in flows] == ["s", "f"]
    assert all(e["args"]["trace_id"] == "r1" for e in flows)
    assert flows[1]["tid"] == track_tids["lane b/lane0"]
    assert flows[1]["ts"] == pytest.approx(2000.0)   # 0.002 s in us
    assert doc["otherData"]["epoch_wall"] == 123.0


def test_continuous_engine_emits_track_spans(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path / "run"))
    engine = ServeEngine(max_batch=4, bucket_sizes=(16,), telemetry=sink,
                         continuous=True, chunk_steps=8, device="cpu")
    engine.prewarm([_cfg()])
    engine.start()
    try:
        res = engine.submit(_cfg(steps=24, seed=3)).result(timeout=180)
    finally:
        engine.stop()
    sink.close()
    events = obs.read_events(str(tmp_path / "run"))
    spans = [e for e in events if e["event"] == "serve.span"]
    assert spans
    # Every serve.span payload carries the (possibly null) track field.
    fields = set(obs_schema.SERVE_EVENT_FIELDS["serve.span"])
    for ev in spans:
        assert set(ev) - {"event", "schema", "t_wall"} == fields
    tracked = [e for e in spans if e["track"] is not None]
    assert len(tracked) == 3                 # 24 steps / chunk 8
    assert all(e["name"] == "chunk" and
               e["track"].endswith("/lane" + e["track"][-1])
               for e in tracked)
    assert {e["trace_id"] for e in tracked} == {res.request_id}
    # Replayed through the shared builder: lanes render + flow-link.
    doc = build_chrome_trace(spans)
    assert any(e.get("name") == "thread_name" and
               e["args"]["name"].startswith("lane ")
               for e in doc["traceEvents"])
    assert [e["ph"] for e in doc["traceEvents"]
            if e.get("cat") == "flow"] == ["s", "f"]


# ------------------------------------------------ loadgen / registry --

def test_loadgen_reports_lane_deltas_and_ttfp_split(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path / "run"))
    spec = LoadSpec(rps=30.0, duration_s=0.4, seed=0, n_min=8, n_max=16,
                    steps_choices=(24,))
    engine = ServeEngine(max_batch=8, bucket_sizes=(16,), telemetry=sink,
                         continuous=True, chunk_steps=8, device="cpu")
    engine.prewarm([cfg for _, cfg in build_schedule(spec)])
    report = run_loadgen(engine, spec, telemetry=sink)
    assert report["errors"] == 0
    lanes = report["lanes"]
    assert lanes is not None and lanes["identity_ok"]
    assert lanes["chunks"] > 0 and lanes["joins"] == report["completed"]
    assert 0.0 < lanes["occupancy_pct"] <= 100.0
    for split in report["by_bucket"].values():
        assert split["ttfp_p99_s"] is not None
        assert split["occupancy_pct"] is not None
        assert split["lane_chunks"] > 0
    # Second leg on the same engine: per-leg deltas, not cumulative.
    report2 = run_loadgen(engine, spec, telemetry=sink)
    assert report2["lanes"]["identity_ok"]
    assert engine.lanes.totals()["chunks"] == \
        lanes["chunks"] + report2["lanes"]["chunks"]
    # The loadgen.summary event tuple is UNCHANGED (no lanes key).
    engine.stop()
    sink.close()
    summaries = [e for e in obs.read_events(str(tmp_path / "run"))
                 if e["event"] == "loadgen.summary"]
    for ev in summaries:
        assert set(ev) - {"event", "schema", "t_wall"} == set(
            obs_schema.LOADGEN_EVENT_FIELDS["loadgen.summary"])
        assert "lanes" not in ev


def test_registry_exports_lanes_and_stats_counters(tmp_path):
    """Satellite: PR 16's orphaned stats counters and TTFP percentiles
    reach metrics.json/metrics.prom through the registry, next to the
    serve.lanes.* family."""
    from cbf_tpu_torch.obs import export as obs_export

    sink = obs.TelemetrySink(str(tmp_path / "run"))
    engine = ServeEngine(max_batch=4, bucket_sizes=(16,), telemetry=sink,
                         continuous=True, chunk_steps=8, device="cpu")
    engine.prewarm([_cfg()])
    engine.start()
    try:
        engine.submit(_cfg(steps=24, seed=3)).result(timeout=180)
    finally:
        engine.stop()
    snap = sink.registry.snapshot()
    assert snap["serve.chunks_executed"]["total"] == 3
    assert snap["serve.lanes_joined"]["total"] == 1
    assert snap["serve.lanes_vacated"]["total"] == 1
    assert snap["serve.lanes.chunks"]["total"] == 3
    assert snap["serve.ttfp_s.hist"]["samples"] == 1
    assert any(k.startswith("serve.ttfp_s[") for k in snap)
    assert any(k.startswith("serve.lanes.occupancy_pct[") for k in snap)
    out = str(tmp_path / "m")
    obs_export.write_metrics(out, sink.registry)
    with open(os.path.join(out, "metrics.json")) as fh:
        doc = json.load(fh)
    assert "serve.lanes.chunks" in doc["metrics"]
    assert "serve.chunks_executed" in doc["metrics"]
    prom = open(os.path.join(out, "metrics.prom")).read()
    assert "serve_lanes_chunks" in prom.replace(".", "_") or \
        "serve" in prom
    sink.close()


# --------------------------------------------------------------- CLI --

def _lanes_metrics_dir(tmp_path, name="m"):
    from cbf_tpu_torch.obs import export as obs_export
    from cbf_tpu_torch.obs.sink import MetricsRegistry

    reg = MetricsRegistry()
    led = LaneLedger(registry=reg)
    led.note_join("n16-k8")
    led.note_chunk("c0", "n16-k8", lanes=4, chunk_steps=8,
                   lane_rows=[(0, "r0", 8, 0.1), (1, "r1", 4, 0.2)],
                   wall_ns=1000, execute_ns=800, pack_ns=10, unpack_ns=10)
    led.note_vacate("n16-k8", 0.3)
    reg.counter("serve.chunks_executed").add(1)
    out = str(tmp_path / name)
    obs_export.write_metrics(out, reg)
    return out


def test_obs_lanes_cli_renders_table(tmp_path, capsys):
    from cbf_tpu_torch.__main__ import main as cli_main

    out = _lanes_metrics_dir(tmp_path)
    assert cli_main(["obs", "lanes", out]) == 0
    text = capsys.readouterr().out
    assert "bucket" in text and "n16-k8" in text and "(all)" in text
    assert "occ%" in text and "disp%" in text
    assert "serve.chunks_executed: total=1" in text
    assert "identity" in text


def test_obs_lanes_cli_exit_codes(tmp_path, capsys):
    from cbf_tpu_torch.__main__ import main as cli_main

    missing = str(tmp_path / "nowhere")
    assert cli_main(["obs", "lanes", missing]) == 2
    assert "obs lanes" in capsys.readouterr().err
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert cli_main(["obs", "lanes", empty, "--follow", "--every", "0.05",
                     "--stall-timeout", "0.2"]) == 3
    assert json.loads(capsys.readouterr().out)["kind"] == "stall"
    out = _lanes_metrics_dir(tmp_path)
    stale = time.time() - 60
    os.utime(os.path.join(out, "metrics.json"), (stale, stale))
    assert cli_main(["obs", "lanes", out, "--follow",
                     "--stall-timeout", "5"]) == 3
    assert json.loads(capsys.readouterr().out)["kind"] == "stall"


def test_serve_cli_continuous_metrics_dir(tmp_path, capsys):
    """``serve --continuous`` serves the request file through the lane
    tables (queue mode) and ``--metrics-dir`` leaves the surfaces ``obs
    lanes`` reads."""
    from cbf_tpu_torch.__main__ import main as cli_main

    requests = tmp_path / "requests.json"
    requests.write_text(json.dumps([
        {"steps": 20, "seed": 1, "overrides": {"n": 10, "gating": "jnp"}},
        {"steps": 12, "seed": 2, "overrides": {"n": 14, "gating": "jnp"},
         "repeat": 2}]))
    out = str(tmp_path / "m")
    assert cli_main(["serve", str(requests), "--device", "cpu",
                     "--continuous", "--chunk", "8", "--max-batch", "4",
                     "--metrics-dir", out, "--metrics-every", "0.2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["requests"] == 3 and len(rec["results"]) == 3
    assert rec["stats"]["lanes_joined"] == rec["stats"]["lanes_vacated"] == 3
    assert rec["stats"]["batches"] == 0 and rec["stats"]["chunks_executed"]
    assert all("-k8-" in r["bucket"] for r in rec["results"])
    assert rec["metrics_dir"] == os.path.abspath(out)
    assert cli_main(["obs", "lanes", out]) == 0
    text = capsys.readouterr().out
    assert "identity" in text and rec["results"][0]["bucket"] in text


def test_obs_lanes_export_timeline(tmp_path, capsys):
    from cbf_tpu_torch.__main__ import main as cli_main

    run = str(tmp_path / "run")
    sink = obs.TelemetrySink(run)
    engine = ServeEngine(max_batch=4, bucket_sizes=(16,), telemetry=sink,
                         continuous=True, chunk_steps=8, device="cpu")
    engine.prewarm([_cfg()])
    engine.start()
    try:
        engine.submit(_cfg(steps=24, seed=3)).result(timeout=180)
    finally:
        engine.stop()
    sink.close()
    out = str(tmp_path / "timeline.json")
    assert cli_main(["obs", "lanes", run, "--export-timeline", out]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["spans"] > 0 and summary["tracks"] >= 1
    with open(out) as fh:
        doc = json.load(fh)
    assert any(e.get("name") == "thread_name" and
               e["args"]["name"].startswith("lane ")
               for e in doc["traceEvents"])
    assert any(e.get("cat") == "flow" for e in doc["traceEvents"])
    # A run dir without an event stream is an operator error: exit 2.
    assert cli_main(["obs", "lanes", str(tmp_path / "ghost"),
                     "--export-timeline", out]) == 2
    assert "obs lanes" in capsys.readouterr().err


# -------------------------------------------------- against the JAX package --

STAMPS = [
    ("join", "b16"), ("join", "b16"),
    ("chunk", "c0", "b16", 4, 8, [(0, "r0", 8, 0.1), (1, "r1", 3, 0.2)],
     1_000_003, 999_983, 17, 23),
    ("vacate", "b16", 0.25),
    ("preempt", "bg", 4, [1, 3]),
    ("chunk", "c1", "b32", 2, 16, [(1, "r2", 16, 0.0)], 7919, 13, 1, 1),
    ("chunk", "c2", "b16", 4, 8, [], 104_729, 0, 0, 0),
    ("vacate", "b16", 0.5),
]


def _stamp(ledger):
    for s in STAMPS:
        if s[0] == "join":
            ledger.note_join(s[1])
        elif s[0] == "vacate":
            ledger.note_vacate(s[1], s[2])
        elif s[0] == "preempt":
            ledger.note_preempted(s[1], s[2], s[3])
        else:
            _, cid, bucket, lanes, steps, rows, wall, execute, p, u = s
            ledger.note_chunk(cid, bucket, lanes=lanes, chunk_steps=steps,
                              lane_rows=rows, wall_ns=wall,
                              execute_ns=execute, pack_ns=p, unpack_ns=u)
    return ledger


def test_ledger_equals_jax():
    reg, jreg = obs.MetricsRegistry(), JMetricsRegistry()
    led = _stamp(LaneLedger(registry=reg, emit_every=2))
    jled = _stamp(jlanes.LaneLedger(registry=jreg, emit_every=2))
    assert led.records() == jled.records()
    assert led.totals() == jled.totals()
    assert led.bucket_totals() == jled.bucket_totals()
    snap, jsnap = led.snapshot(), jled.snapshot()
    assert snap == jsnap
    rates = {"serve.lanes.join_rate", "serve.lanes.vacate_rate"}
    got = {k: v for k, v in reg.snapshot().items() if k not in rates}
    want = {k: v for k, v in jreg.snapshot().items() if k not in rates}
    assert got == want
    assert obs_lanes.ACCOUNT_KEYS == jlanes.ACCOUNT_KEYS
    assert LANE_STATES == jlanes.LANE_STATES


def _strip_header(text: str) -> str:
    """The rendered table without its ``== ... age=`` header line (the
    age is the file's, not the table's)."""
    return "\n".join(line for line in text.splitlines()
                     if not line.startswith("== "))


def test_obs_lanes_renders_equal_text_across_packages(tmp_path, capsys):
    from cbf_tpu_torch.__main__ import main as cli_main
    from cbf_tpu_torch.obs import export as obs_export

    reg, jreg = obs.MetricsRegistry(), JMetricsRegistry()
    _stamp(LaneLedger(registry=reg))
    _stamp(jlanes.LaneLedger(registry=jreg))
    for r in (reg, jreg):
        r.counter("serve.chunks_executed").add(3)
        r.histogram("serve.ttfp_s").observe(0.031)
        r.histogram("serve.ttfp_s[b16]").observe(0.031)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    obs_export.write_metrics(port_dir, reg)
    jexport.write_metrics(jax_dir, jreg)
    texts = []
    for run in (cli_main, jcli_main):
        for d in (port_dir, jax_dir):
            assert run(["obs", "lanes", d]) == 0
            texts.append(_strip_header(capsys.readouterr().out))
    assert texts[0] and all(t == texts[0] for t in texts), texts
    assert "b16" in texts[0] and "b32" in texts[0] and "bg" in texts[0]


def test_sustained_low_occupancy_from_a_live_ledger(tmp_path):
    """The watchdog's occupancy check needs no change: a continuous
    engine's ledger feeds it ``serve.lanes.window`` events."""
    sink = obs.TelemetrySink(str(tmp_path / "run"))
    wd = Watchdog(sink, slo=SLOTargets(occupancy_pct=90.0))
    engine = ServeEngine(max_batch=4, bucket_sizes=(16,), telemetry=sink,
                         continuous=True, chunk_steps=8, device="cpu",
                         lane_ledger=LaneLedger(sink=sink, emit_every=1))
    engine.prewarm([_cfg()])
    engine.start()
    try:
        # One lane of four busy: each window's occupancy is under 25%.
        engine.submit(_cfg(steps=24, seed=3)).result(timeout=120)
    finally:
        engine.stop()
    wd.stop()
    sink.close()
    windows = [e for e in obs.read_events(str(tmp_path / "run"))
               if e["event"] == "serve.lanes.window"]
    assert len(windows) == 3 and all(w["identity_ok"] for w in windows)
    assert all(w["occupancy_pct"] < 25.0 for w in windows)
    lows = [a for a in wd.alerts if a.kind == ALERT_LOW_OCCUPANCY]
    assert len(lows) == 1 and lows[0].severity == "warning"
