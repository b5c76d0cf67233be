"""The port's serve engine in drain mode (cbf_tpu_torch.serve.engine) and
its lifecycle tracer (cbf_tpu_torch.obs.trace), on the CPU.

- Drain parity: ``ServeEngine(device="cpu").run`` against the JAX
  package's ``ServeEngine.run`` on the same 9 requests over two buckets
  (mixed n, steps, ``safety_distance``, gains and dt; one batch partial),
  float64 to 1e-9 and float32 to 2e-4 with every count exact, and one
  float32 list with ``gating="pallas"`` (JAX's kernel in interpret mode,
  the port's plain version of ``knn_fused``): each result's final state
  and outputs, ``bucket``/``n``/``steps``/``batch_fill``, the stats, and
  the ``request`` events field for field except the timings.
- One program per bucket: every result is bit-equal to the same packed
  batch run directly through ``lockstep_traced_rollout``; ``prewarm``
  then ``run`` prepares no program again.
- Queue mode (tests/test_serve.py:192-246): flush on batch-full and on
  the deadline, ``submit`` before ``start`` raises, ``stop`` drains, the
  program reuse and prewarm counters; two threads calling ``run()`` on
  one bucket at once get the serial run's results.
- The CLI: the request file (tests/test_serve.py:247) and the recover
  exit codes with an empty journal (tests/test_cli.py:181).
- The tracer (tests/test_trace.py:61-172 without the load generator):
  lifecycle spans and the execute-wall agreement, the queue-wait/execute
  breakdown, bit-neutral tracing, deterministic sampling, the Chrome trace
  schema, span and request events against the port's schema, and the
  engine's and tracer's event types against ``SERVE_EVENT_TYPES``.
- The lock witness, armed, records a queue-mode run's lock order with no
  inversion.
"""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.obs.trace import Tracer as JTracer
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.serve import ServeEngine as JServeEngine
from cbf_tpu_torch import convert, obs
from cbf_tpu_torch.__main__ import main as cli_main
from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.obs import schema as obs_schema
from cbf_tpu_torch.obs import trace as obs_trace
from cbf_tpu_torch.obs.trace import LIFECYCLE_PHASES, Tracer
from cbf_tpu_torch.parallel import ensemble
from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.serve import ServeEngine
from cbf_tpu_torch.serve import engine as serve_engine
from cbf_tpu_torch.serve import pack
from cbf_tpu_torch.utils import profiling

COUNTS = ("filter_active_count", "infeasible_count", "gating_dropped_count",
          "max_relax_rounds")
F64_ATOL, F32_ATOL = 1e-9, 2e-4
STAT_KEYS = ("requests", "batches", "pad_slots", "compile_miss",
             "compile_hit")
TIMINGS = ("latency_s", "queue_wait_s", "execute_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Sink:
    """Minimal telemetry stub: records (event_type, payload) pairs."""

    registry = None

    def __init__(self):
        self.events = []

    def event(self, event_type, payload):
        self.events.append((event_type, dict(payload)))

    def of(self, event_type):
        return [p for t, p in self.events if t == event_type]


# -- drain parity --------------------------------------------------------

# Two buckets (16 and 32 agents) under one horizon (16): 5 requests in the
# first (a full batch of 4 and a partial one), 4 in the second; the list
# interleaves them. Packed spawns, so every filter engages.
REQUESTS = [
    dict(n=10, steps=12, seed=1, safety_distance=0.42, consensus_gain=1.2),
    dict(n=20, steps=16, seed=6, safety_distance=0.41),
    dict(n=16, steps=16, seed=2, dt=0.028),
    dict(n=32, steps=14, seed=7, consensus_gain=1.3),
    dict(n=12, steps=9, seed=3, consensus_gain=0.8, sep_gain=0.5),
    dict(n=25, steps=10, seed=8, dt=0.03),
    dict(n=14, steps=16, seed=4, safety_distance=0.38),
    dict(n=28, steps=16, seed=9, sep_gain=0.7),
    dict(n=11, steps=13, seed=5),
]
ENGINE = dict(max_batch=4, bucket_sizes=(16, 32), horizon_quantum=16)
COMMON = dict(record_trajectory=True, spawn_half_width_override=0.9)


def _requests(gating, dtype_name, fields=REQUESTS):
    jdt = getattr(jnp, dtype_name)
    jcfgs = [jsw.Config(gating=gating, dtype=jdt, **COMMON, **f)
             for f in fields]
    tcfgs = [convert.config_from_fields(
        {**f, **COMMON, "gating": gating, "dtype": dtype_name})
        for f in fields]
    return jcfgs, tcfgs


def _drain(gating, dtype_name, fields=REQUESTS):
    jcfgs, tcfgs = _requests(gating, dtype_name, fields)
    with jax.enable_x64(dtype_name == "float64"):
        jsink = _Sink()
        jeng = JServeEngine(telemetry=jsink, **ENGINE)
        jres = jeng.run(jcfgs)
    tsink = _Sink()
    teng = ServeEngine(telemetry=tsink, device="cpu", **ENGINE)
    tres = teng.run(tcfgs)
    return dict(jax=(jeng, jres, jsink), port=(teng, tres, tsink),
                cfgs=tcfgs)


@pytest.fixture(scope="module")
def drains():
    return {"float64": _drain("jnp", "float64"),
            "float32": _drain("jnp", "float32"),
            "pallas": _drain("pallas", "float32", REQUESTS[:5])}


@pytest.mark.parametrize("case", ["float64", "float32", "pallas"])
def test_drain_matches_jax(drains, case):
    atol = F64_ATOL if case == "float64" else F32_ATOL
    run = drains[case]
    jeng, jres, jsink = run["jax"]
    teng, tres, tsink = run["port"]
    assert len(tres) == len(jres) == len(run["cfgs"])
    for t, j in zip(tres, jres):
        assert (t.request_id, t.bucket, t.n, t.steps, t.batch_fill) == \
            (j.request_id, j.bucket, j.n, j.steps, j.batch_fill)
        for name in ("x", "v"):
            np.testing.assert_allclose(
                getattr(t.final_state, name),
                np.asarray(getattr(j.final_state, name)), atol=atol,
                rtol=0, err_msg=name)
        for name in COUNTS:
            np.testing.assert_array_equal(
                getattr(t.outputs, name),
                np.asarray(getattr(j.outputs, name)), err_msg=name)
        for name in ("min_pairwise_distance", "trajectory"):
            np.testing.assert_allclose(
                getattr(t.outputs, name),
                np.asarray(getattr(j.outputs, name)), atol=atol, rtol=0,
                err_msg=name)
        assert t.outputs.min_pairwise_distance.shape == (t.steps,)
        assert t.outputs.trajectory.shape == (t.steps, t.n, 2)
        assert int(np.sum(t.outputs.filter_active_count)) > 0
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    if case != "pallas":
        assert teng.stats["pad_slots"] == 3       # the partial batch
        assert sorted({r.batch_fill for r in tres}) == [1, 4]
    treq, jreq = tsink.of("request"), jsink.of("request")
    assert len(treq) == len(jreq) == len(tres)
    for t, j in zip(treq, jreq):
        assert set(t) == set(j)
        for key in set(t) - set(TIMINGS) - {"min_pairwise_distance"}:
            assert t[key] == j[key], key
        assert t["min_pairwise_distance"] == pytest.approx(
            j["min_pairwise_distance"], abs=atol)


def test_each_result_is_its_packed_batch_run_directly(drains):
    """The engine adds no arithmetic: each result is bit-equal to the same
    requests packed into the same slots and run through
    ``lockstep_traced_rollout``."""
    teng, tres, _ = drains["float32"]["port"]
    cfgs = drains["float32"]["cfgs"]
    by_bucket: dict = {}
    for i, cfg in enumerate(cfgs):
        key, traced = teng.bucket_of(cfg)
        by_bucket.setdefault(key, []).append((i, cfg, traced))
    checked = 0
    for key, members in by_bucket.items():
        for b in range(0, len(members), teng.max_batch):
            batch = members[b:b + teng.max_batch]
            states, traced_b, steps_b = pack.stack_batch(
                key, [c for _, c, _ in batch], [t for _, _, t in batch],
                teng.max_batch, device="cpu")
            final, outs = ensemble.lockstep_traced_rollout(
                key.static_cfg, key.horizon)(states, traced_b, steps_b)
            for slot, (i, cfg, _) in enumerate(batch):
                f, o = pack.trim_result(final, outs, slot, cfg.n, cfg.steps)
                np.testing.assert_array_equal(tres[i].final_state.x, f.x)
                np.testing.assert_array_equal(tres[i].final_state.v, f.v)
                for name in COUNTS + ("min_pairwise_distance",
                                      "trajectory"):
                    np.testing.assert_array_equal(
                        getattr(tres[i].outputs, name), getattr(o, name))
                checked += 1
    assert checked == len(cfgs)


def test_prewarm_then_run_prepares_nothing_again(monkeypatch):
    prepared = []
    real = ensemble.prepare_traced_rollout

    def counting(*args, **kw):
        prepared.append(args[:2])
        return real(*args, **kw)

    monkeypatch.setattr(ensemble, "prepare_traced_rollout", counting)
    _, cfgs = _requests("jnp", "float32")
    eng = ServeEngine(device="cpu", tracer=Tracer(enabled=False), **ENGINE)
    eng.prewarm(cfgs)
    assert len(prepared) == 2                     # one per bucket
    base = dict(eng.stats)
    eng.run(cfgs)
    assert len(prepared) == 2
    assert eng.stats["compile_miss"] == base["compile_miss"] == 2
    assert eng.stats["compile_hit"] == base["compile_hit"] + 3


# -- queue mode ----------------------------------------------------------

def _qcfg(**kw):
    return swarm.Config(**{"n": 12, "steps": 10, "gating": "jnp", **kw})


def test_queue_flushes_on_batch_full_and_deadline():
    engine = ServeEngine(max_batch=2, flush_deadline_s=0.15,
                         bucket_sizes=(16,), device="cpu")
    engine.start()
    try:
        t0 = time.time()
        pending = [engine.submit(_qcfg(seed=i)) for i in range(3)]
        results = [p.result(timeout=120) for p in pending]
    finally:
        engine.stop()
    fills = sorted(r.batch_fill for r in results)
    assert fills == [1, 2, 2]
    assert engine.stats["batches"] == 2
    assert engine.stats["requests"] == 3
    assert results[2].latency_s >= 0.14 or time.time() - t0 > 10


def test_submit_requires_started_engine():
    engine = ServeEngine(max_batch=2, device="cpu")
    with pytest.raises(RuntimeError, match="start"):
        engine.submit(_qcfg(steps=5))


def test_stop_drains_queued_requests():
    engine = ServeEngine(max_batch=8, flush_deadline_s=60.0,
                         bucket_sizes=(16,), device="cpu")
    engine.start()
    pending = engine.submit(_qcfg(steps=5))
    engine.stop(drain=True)
    assert pending.done()
    assert pending.result(timeout=0).steps == 5


def test_executable_reuse_and_prewarm_counters():
    cfg = _qcfg()
    engine = ServeEngine(max_batch=2, bucket_sizes=(16,), device="cpu")
    engine.prewarm([cfg])
    assert engine.prewarm_s is not None
    base = dict(engine.stats)
    engine.run([cfg, dataclasses.replace(cfg, seed=7)])
    assert engine.stats["compile_miss"] == base["compile_miss"]
    assert engine.stats["compile_hit"] > base["compile_hit"]
    counts = profiling.compile_event_counts()
    key, _ = engine.bucket_of(cfg)
    assert counts.get(f"serve.executable_miss[{key.label()}]", 0) >= 1
    assert counts.get(f"serve.executable_hit[{key.label()}]", 0) >= 1
    assert any(k.startswith("serve.compile_ms[") for k in counts)
    assert engine.manifest_extra()["serve"]["buckets"] == [key.label()]


def test_queue_mode_equals_run():
    cfgs = [_qcfg(seed=i, n=10 + i) for i in range(5)]
    ref = ServeEngine(max_batch=4, bucket_sizes=(16,),
                      device="cpu").run(cfgs)
    engine = ServeEngine(max_batch=4, flush_deadline_s=0.05,
                         bucket_sizes=(16,), device="cpu")
    engine.start()
    try:
        got = [p.result(timeout=120)
               for p in [engine.submit(c) for c in cfgs]]
    finally:
        engine.stop()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.final_state.x, b.final_state.x)
        np.testing.assert_array_equal(a.outputs.min_pairwise_distance,
                                      b.outputs.min_pairwise_distance)


def test_two_threads_run_one_bucket_at_once():
    """The programs are shared state; the process-wide program lock keeps
    two concurrent ``run()`` calls on one bucket from mixing buffers."""
    lists = [[_qcfg(seed=10 * k + i, n=9 + i) for i in range(6)]
             for k in range(2)]
    serial = [ServeEngine(max_batch=4, bucket_sizes=(16,),
                          device="cpu").run(cfgs) for cfgs in lists]
    got = [None, None]
    errors = []

    def work(k):
        try:
            got[k] = ServeEngine(max_batch=4, bucket_sizes=(16,),
                                 device="cpu").run(lists[k])
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for k in range(2):
        for a, b in zip(got[k], serial[k]):
            np.testing.assert_array_equal(a.final_state.x, b.final_state.x)
            np.testing.assert_array_equal(a.outputs.min_pairwise_distance,
                                          b.outputs.min_pairwise_distance)


# -- the CLI ---------------------------------------------------------------

@pytest.mark.parametrize("mode", [[], ["--pace-s", "0"]],
                         ids=["drain", "queue"])
def test_serve_cli_request_file(mode, tmp_path, capsys):
    path = tmp_path / "reqs.json"
    path.write_text(json.dumps({"requests": [
        {"steps": 8, "seed": 1, "overrides": {"n": 12, "gating": "jnp"}},
        {"steps": 6, "seed": 2, "overrides": {"n": 10, "gating": "jnp"},
         "repeat": 2},
    ]}))
    rc = cli_main(["serve", str(path), "--max-batch", "4", "--device",
                   "cpu", "--prewarm", "--telemetry-dir",
                   str(tmp_path / "t"), *mode])
    assert rc == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["requests"] == 3
    assert len(record["results"]) == 3
    assert record["agent_qp_steps_per_sec"] > 0
    assert record["latency_p99_s"] >= record["latency_p50_s"]
    assert all(r["min_pairwise_distance"] > 0.1 for r in record["results"])
    assert record["buckets"] and record["prewarm_s"] is not None
    events = obs.read_events(record["telemetry"])
    assert len([e for e in events if e["event"] == "request"]) == 3


def test_serve_recover_exit_codes_and_empty_journal(tmp_path, capsys):
    from cbf_tpu_torch.durable.journal import RequestJournal

    missing = str(tmp_path / "nowhere.jsonl")
    assert cli_main(["serve", "--recover", "--device", "cpu"]) == 2
    assert "--journal" in capsys.readouterr().err
    assert cli_main(["serve", "--device", "cpu"]) == 2
    assert "requests file" in capsys.readouterr().err
    assert cli_main(["serve", "--journal", missing, "--recover",
                     "--device", "cpu"]) == 2
    assert "no request journal" in capsys.readouterr().err

    path = str(tmp_path / "j.jsonl")
    j = RequestJournal(path)
    j.submitted("r0", swarm.Config(n=8, steps=4, gating="jnp"))
    j.resolved("r0")
    j.close()
    assert cli_main(["serve", "--journal", path, "--recover", "--device",
                     "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec == {"requests": 0, "recovered": 0, "journal": path}


# -- the tracer ------------------------------------------------------------

def _tcfgs(k=3, steps=10):
    return [swarm.Config(n=12, steps=steps, seed=i, gating="jnp")
            for i in range(k)]


@pytest.fixture(scope="module")
def run_engine():
    engine = ServeEngine(max_batch=4, bucket_sizes=(16,), device="cpu")
    results = engine.run(_tcfgs())
    return engine, results


def test_lifecycle_spans_and_execute_wall_agreement(run_engine):
    engine, results = run_engine
    names = {s.name for s in engine.tracer.spans}
    assert {"enqueue", "queue_wait", "pack", "compile", "execute",
            "unpack", "resolve"} <= names
    assert names <= set(LIFECYCLE_PHASES)
    engine.run(_tcfgs())
    assert "executable_hit" in {s.name for s in engine.tracer.spans}
    exec_spans = [s for s in engine.tracer.spans if s.name == "execute"]
    assert exec_spans and all(s.dur_s > 0 for s in exec_spans)
    assert abs(exec_spans[0].dur_s - results[0].execute_s) < 0.05
    assert all(s.bucket for s in exec_spans)
    assert any(s.trace_id == results[0].request_id
               for s in engine.tracer.spans)


def test_queue_wait_execute_breakdown(run_engine):
    _, results = run_engine
    for r in results:
        assert r.queue_wait_s >= 0
        assert r.execute_s > 0
        assert r.latency_s >= r.queue_wait_s + r.execute_s - 1e-3
        assert r.queue_wait_s <= r.latency_s


def test_span_tracing_is_bit_neutral():
    cfgs = _tcfgs(2)
    on = ServeEngine(max_batch=4, bucket_sizes=(16,), device="cpu").run(cfgs)
    engine_off = ServeEngine(max_batch=4, bucket_sizes=(16,), device="cpu",
                             tracer=Tracer(enabled=False))
    off = engine_off.run(cfgs)
    assert not engine_off.tracer.spans
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.final_state.x, b.final_state.x)
        np.testing.assert_array_equal(a.outputs.min_pairwise_distance,
                                      b.outputs.min_pairwise_distance)


def test_sampling_is_deterministic_and_keeps_batch_spans():
    t = Tracer(sample_every=2)
    assert t.sampled("a") and not t.sampled("b")
    assert t.sampled("c") and not t.sampled("d")
    assert t.sampled("a") and not t.sampled("b")
    assert t.sampled(None)
    assert not Tracer(enabled=False).sampled("a")
    j, t = JTracer(sample_every=3), Tracer(sample_every=3)
    ids = ["a", "b", "c", "d", "a", "e", None, "f", "g"]
    assert [t.sampled(x) for x in ids] == [j.sampled(x) for x in ids]


def test_chrome_trace_export_schema(run_engine, tmp_path):
    engine, _ = run_engine
    path = engine.tracer.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"]
    assert isinstance(events, list) and events
    xs = [e for e in events if e["ph"] == "X"]
    assert xs
    for e in events:
        assert e["ph"] in ("X", "M")
        assert isinstance(e["name"], str) and e["name"]
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "X":
            assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
            assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
            assert "span_id" in e["args"]
    assert {e["name"] for e in xs} <= set(LIFECYCLE_PHASES)
    assert any(e["name"] == "execute" for e in xs)
    t0 = min(e["ts"] for e in xs) / 1e6
    assert abs(engine.tracer.wall_of(t0) - time.time()) < 600


def test_span_and_request_events_match_schema(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path / "run"))
    engine = ServeEngine(max_batch=4, bucket_sizes=(16,), telemetry=sink,
                         device="cpu")
    engine.run(_tcfgs(2))
    sink.close()
    events = obs.read_events(str(tmp_path / "run"))
    spans = [e for e in events if e["event"] == "serve.span"]
    reqs = [e for e in events if e["event"] == "request"]
    assert spans and reqs
    meta = {"event", "schema", "t_wall"}
    for ev in spans:
        assert set(ev) - meta == set(
            obs_schema.SERVE_EVENT_FIELDS["serve.span"])
    for ev in reqs:
        assert set(ev) - meta == set(
            obs_schema.SERVE_EVENT_FIELDS["request"])
        assert ev["queue_wait_s"] >= 0 and ev["execute_s"] > 0
    snap = sink.registry.snapshot()
    h = snap["serve.phase.execute_s.hist"]
    assert h["samples"] > 0 and h["p50"] is not None
    assert h["min"] <= h["p50"] <= h["p99"] <= h["max"]


def test_event_types_union_to_the_schema():
    from cbf_tpu.obs import schema as jschema
    from cbf_tpu_torch.durable import journal, rollout
    from cbf_tpu_torch.obs import flight

    assert set(serve_engine.EMITTED_EVENT_TYPES) | set(
        obs_trace.EMITTED_EVENT_TYPES) == set(obs_schema.SERVE_EVENT_TYPES)
    assert set(journal.EMITTED_EVENT_TYPES) | set(
        rollout.EMITTED_EVENT_TYPES) == set(obs_schema.DURABLE_EVENT_TYPES)
    assert flight.EMITTED_EVENT_TYPES == obs_schema.FLIGHT_EVENT_TYPES
    for table in ("SERVE_EVENT_FIELDS", "DURABLE_EVENT_FIELDS",
                  "FLIGHT_EVENT_FIELDS"):
        assert getattr(obs_schema, table) == getattr(jschema, table), table


# -- the lock witness ------------------------------------------------------

def test_lock_witness_records_the_engine_lock_order(tmp_path):
    """Queue mode with a journal and a cancel: the queue lock is held
    around the journal's append and the stats bump, never the reverse."""
    lockwitness.arm()
    lockwitness.reset()
    try:
        engine = ServeEngine(max_batch=2, flush_deadline_s=60.0,
                             bucket_sizes=(16,), device="cpu",
                             journal=str(tmp_path / "j.jsonl"))
        assert isinstance(engine._cond, lockwitness.WitnessCondition)
        engine.start()
        try:
            pendings = [engine.submit(_qcfg(seed=i, steps=4))
                        for i in range(3)]
            assert pendings[2].cancel() is True   # the third waits alone
            for p in pendings[:2]:
                p.result(timeout=120)
        finally:
            engine.stop()
            engine.journal.close()
        assert lockwitness.snapshot()["acquisitions"] > 0
        edges = lockwitness.observed_edges()
        assert ("ServeEngine._lock", "RequestJournal._lock") in edges
        assert ("ServeEngine._lock", "ServeEngine._stats_lock") in edges
        assert lockwitness.inversions() == []
    finally:
        lockwitness.disarm()
        lockwitness.reset()
