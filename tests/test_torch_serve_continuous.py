"""The port's continuous scheduler (cbf_tpu_torch.serve.engine,
``continuous=True``) and the load generator's SLO surfaces, on the CPU.

- tests/test_serve_continuous.py:70-383 on the port: a join mid-flight
  ``np.array_equal`` to the solo run with its stitched partials equal to
  the resolved outputs, a deadline leave that leaves its batch-mates
  untouched, ``serve.partial`` events and TTFP through ``run_loadgen``
  and ``sweep_rps``, drain mode without TTFP, ``parse_sweep``, the
  bytes-budget shedding, the deep-backlog bursts (``backlog_chunks=1``
  never bursts) and the ``loadgen`` CLI sweep.
- Parity: a continuous engine in each package takes the same 9 requests
  (mixed n, horizons 8-40, mixed ``safety_distance`` and gains, two
  static configs): final states and outputs float64 to 1e-9, float32 to
  2e-4, counts exact; ``steps``, ``bucket`` (the ``-k8-`` chunk label),
  the ``partial_hook`` steps-done sequence per request, ``lanes_joined``
  and ``lanes_vacated`` equal; one float32 list with ``gating="pallas"``
  (JAX's kernel in interpret mode, the port's plain ``knn_fused``). A
  lane's result does not depend on when it joined, so thread timing
  cannot change the comparison.
- Each continuous result equals the port's own drain result for the same
  request; the chunk program is the drain program of horizon
  ``chunk_steps`` (one cache entry).
- The chunk-failure ladder: a transient fault retried on the same carry,
  a permanent one demoting each lane to a solo drain run; the ordered
  ``serve.retry`` payloads equal JAX's, ``backoff_s`` included. The stop
  path finishes through the chunk program and prepares no drain program.
- The lock witness, armed, records no inversion across a demotion.
"""

import dataclasses
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.serve import FaultPolicy as JFaultPolicy
from cbf_tpu.serve import ServeEngine as JServeEngine
from cbf_tpu.serve import parse_sweep as jparse_sweep
from cbf_tpu.utils import faults as jfaults
from cbf_tpu_torch import convert, obs
from cbf_tpu_torch.__main__ import main as cli_main
from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.obs import schema as obs_schema
from cbf_tpu_torch.obs.trace import Tracer
from cbf_tpu_torch.parallel import ensemble
from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.serve import (DeadlineExceeded, FaultPolicy, LoadSpec,
                                 ServeEngine, ShedError, build_schedule,
                                 parse_sweep, run_loadgen, sweep_rps)
from cbf_tpu_torch.utils import faults, profiling

COUNTS = ("filter_active_count", "infeasible_count", "gating_dropped_count",
          "max_relax_rounds")
F64_ATOL, F32_ATOL = 1e-9, 2e-4


def _static_lock_graph():
    """The port's static acquisition-order graph: the reference every
    edge the armed witness observes must lie in the closure of
    (``lockwitness.check_subgraph``)."""
    import cbf_tpu_torch
    from cbf_tpu_torch.analysis import concurrency

    return concurrency.static_edge_set(concurrency.analyze_paths(
        [os.path.dirname(cbf_tpu_torch.__file__)]))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(steps=24, seed=0, n=8):
    return swarm.Config(n=n, steps=steps, seed=seed, gating="jnp")


def _engine(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("bucket_sizes", (16,))
    kw.setdefault("chunk_steps", 8)
    return ServeEngine(continuous=True, device="cpu", **kw)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [np.asarray(tree)]


def _tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    return all(np.array_equal(x, y) for x, y in zip(la, lb))


def _wait(predicate, timeout_s=60.0):
    t0 = time.monotonic()
    while not predicate():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError("timed out waiting for condition")
        time.sleep(0.002)


class _Sink:
    """Minimal telemetry stub: records (event_type, payload) pairs."""

    registry = None

    def __init__(self):
        self.events = []

    def event(self, event_type, payload):
        self.events.append((event_type, dict(payload)))

    def of(self, event_type):
        return [p for t, p in self.events if t == event_type]


# -- join / partial pins ---------------------------------------------------

def test_join_midflight_bit_identical_and_partials_match():
    engine = _engine()
    partials = []   # (request_id, steps_done, outs_slice)
    plock = threading.Lock()

    def hook(rid, done, sl):
        with plock:
            partials.append((rid, done, sl))

    engine.partial_hook = hook
    engine.prewarm([_cfg()])
    engine.start()
    try:
        solo = engine.submit(_cfg(steps=24, seed=3)).result(timeout=180)
        assert solo.steps == 24 and solo.n == 8
        assert "-k8-" in solo.bucket
        # A long runner occupies a lane; once its first chunk has
        # streamed, the same request as `solo` joins a FREE lane of the
        # live table.
        p_long = engine.submit(_cfg(steps=512, seed=7))
        _wait(lambda: any(r == p_long.request_id for r, _, _ in partials))
        p_join = engine.submit(_cfg(steps=24, seed=3))
        joined = p_join.result(timeout=180)
        assert p_long._result is None     # still mid-flight
        long_res = p_long.result(timeout=300)
        assert long_res.steps == 512

        assert _tree_equal(joined.outputs, solo.outputs)
        assert np.array_equal(joined.final_state.x, solo.final_state.x)

        with plock:
            mine = [(d, sl) for r, d, sl in partials
                    if r == p_join.request_id]
        assert [d for d, _ in mine] == [8, 16, 24]
        stitched = [np.concatenate(leaves)
                    for leaves in zip(*[_leaves(sl) for _, sl in mine])]
        resolved = _leaves(joined.outputs)
        assert len(stitched) == len(resolved)
        for s, r in zip(stitched, resolved):
            assert np.array_equal(s, r)
        assert all(isinstance(leaf, np.ndarray)
                   for _, sl in mine for leaf in _leaves(sl))

        assert joined.ttfp_s is not None
        assert 0 < joined.ttfp_s <= joined.latency_s

        stats = engine.stats
        assert stats["lanes_joined"] == 3
        assert stats["lanes_vacated"] == 3
        assert stats["chunks_executed"] >= 64
        extra = engine.manifest_extra()["serve"]
        assert extra["continuous"] is True and extra["chunk_steps"] == 8
        assert any("-k8-" in lbl for lbl in extra["chunk_buckets"])
        for k in ("chunks_executed", "lanes_joined", "lanes_vacated"):
            assert extra["fault_stats"][k] == stats[k]
    finally:
        engine.stop()


def test_deadline_leave_does_not_perturb_batch_mates():
    engine = _engine()
    partials = []
    engine.partial_hook = lambda rid, done, sl: partials.append(rid)
    engine.prewarm([_cfg()])
    engine.start()
    try:
        solo = engine.submit(_cfg(steps=64, seed=5)).result(timeout=180)
        p_survivor = engine.submit(_cfg(steps=64, seed=5))
        p_doomed = engine.submit(_cfg(steps=4096, seed=9), deadline_s=0.5)
        _wait(lambda: p_doomed.request_id in partials)
        survivor = p_survivor.result(timeout=180)
        with pytest.raises(DeadlineExceeded) as ei:
            p_doomed.result(timeout=180)
        assert "mid-flight" in str(ei.value)
        assert _tree_equal(survivor.outputs, solo.outputs)
        assert np.array_equal(survivor.final_state.x, solo.final_state.x)
        assert engine.stats["deadline_expired"] >= 1
        assert engine.stats["lanes_vacated"] == 3
        again = engine.submit(_cfg(steps=64, seed=5)).result(timeout=180)
        assert _tree_equal(again.outputs, solo.outputs)
    finally:
        engine.stop()


def test_background_lanes_yield_and_count_preemption():
    """A background request runs in a background lane table while the
    foreground tier is idle; foreground traffic takes the device chunk by
    chunk, the ledger counting the background lanes it held back, and
    both results equal their drain runs."""
    from cbf_tpu_torch.obs.lanes import LaneLedger

    engine = _engine(lane_ledger=LaneLedger())
    partials = []
    engine.partial_hook = lambda rid, done, sl: partials.append(rid)
    bg_cfg, fg_cfg = _cfg(steps=128, seed=11), _cfg(steps=24, seed=12)
    engine.prewarm([bg_cfg])
    engine.start()
    try:
        p_bg = engine.submit(bg_cfg, priority="background")
        _wait(lambda: p_bg.request_id in partials)
        fg = engine.submit(fg_cfg).result(timeout=120)
        assert not p_bg.done()
        bg = p_bg.result(timeout=300)
    finally:
        engine.stop()
    assert engine.stats["background_requests"] == 1
    assert engine.stats["background_batches"] >= 1
    assert engine.lanes.totals()["preempted"] >= 1
    ref = ServeEngine(max_batch=4, bucket_sizes=(16,), device="cpu")
    for got, want in zip((bg, fg), ref.run([bg_cfg, fg_cfg])):
        assert _tree_equal(got.outputs, want.outputs)
        np.testing.assert_array_equal(got.final_state.x, want.final_state.x)


# -- events / TTFP / sweep -------------------------------------------------

def test_partial_events_ttfp_report_and_sweep(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path / "run"))
    spec = LoadSpec(rps=30.0, duration_s=0.4, seed=0, n_min=8, n_max=16,
                    steps_choices=(24,))
    engine = _engine(max_batch=8, telemetry=sink)
    engine.prewarm([cfg for _, cfg in build_schedule(spec)])
    report = run_loadgen(engine, spec, telemetry=sink)
    assert report["completed"] == report["requests"] > 0
    assert report["errors"] == 0
    for k in ("ttfp_p50_s", "ttfp_p95_s", "ttfp_p99_s"):
        assert report[k] is not None and report[k] > 0
    assert report["ttfp_p50_s"] <= report["ttfp_p99_s"]
    assert report["ttfp_p99_s"] <= report["latency_p99_s"]

    sweep = sweep_rps(engine, spec, [20.0, 30.0], slo_p99_s=1e9,
                      telemetry=sink)
    assert sweep["knee_rps"] == 30.0 and sweep["knee_censored"]
    assert [leg["rps"] for leg in sweep["legs"]] == [20.0, 30.0]
    assert all(leg["within_slo"] for leg in sweep["legs"])
    assert all(leg["ttfp_p99_s"] is not None for leg in sweep["legs"])
    tight = sweep_rps(engine, spec, [20.0], slo_p99_s=0.0)
    assert tight["knee_rps"] == 0.0 and not tight["knee_censored"]
    engine.stop()
    sink.close()

    events = obs.read_events(str(tmp_path / "run"))
    meta = {"event", "schema", "t_wall"}
    parts = [e for e in events if e["event"] == "serve.partial"]
    assert parts
    for ev in parts:
        assert set(ev) - meta == set(
            obs_schema.SERVE_EVENT_FIELDS["serve.partial"])
        assert 0 < ev["steps_done"] < ev["steps_total"]
        assert ev["chunk"] == 8 and "-k8-" in ev["bucket"]
    reqs = [e for e in events if e["event"] == "request"]
    assert reqs and all("ttfp_s" in e for e in reqs)
    assert any(e["ttfp_s"] is not None for e in reqs)
    summaries = [e for e in events if e["event"] == "loadgen.summary"]
    assert len(summaries) == 3
    for ev in summaries:
        assert set(ev) - meta == set(
            obs_schema.LOADGEN_EVENT_FIELDS["loadgen.summary"])
    assert summaries[0]["ttfp_p99_s"] == report["ttfp_p99_s"]


def test_drain_mode_has_no_ttfp():
    engine = ServeEngine(max_batch=4, bucket_sizes=(16,), device="cpu")
    results = engine.run([_cfg(steps=8, seed=1), _cfg(steps=8, seed=2)])
    assert all(r.ttfp_s is None for r in results)


@pytest.mark.parametrize("arg,want", [
    ("2:8:2", [2.0, 4.0, 6.0, 8.0]), ("5:5:1", [5.0]),
    ("1:2:0.5", [1.0, 1.5, 2.0]), ("0.1:0.3:0.1", [0.1, 0.2, 0.3])])
def test_parse_sweep(arg, want):
    assert parse_sweep(arg) == jparse_sweep(arg) == want


@pytest.mark.parametrize("bad", ["2:8", "0:8:2", "8:2:2", "2:8:0", "a:b:c"])
def test_parse_sweep_rejects(bad):
    with pytest.raises(ValueError):
        parse_sweep(bad)


# -- bytes-budget admission ------------------------------------------------

class _StubCost:
    """Deterministic cost model double: prices every shape at
    ``per_agent * n`` bytes (0 = unpriced, the fail-open path)."""

    def __init__(self, per_agent):
        self.per_agent = per_agent

    def predict_peak_bytes(self, n):
        return self.per_agent * n

    def fits(self, n, mesh=None, *, budget_bytes=None):
        predicted = self.predict_peak_bytes(n)
        if predicted == 0 or budget_bytes is None:
            return True
        return predicted <= budget_bytes

    def save(self):
        pass

    def record_compile(self, label, compiled, wall):
        pass

    def observe_execute(self, label, execute_s):
        return {"drift": None, "predicted_s": None}

    def cost_of(self, label):
        return {}


def test_bytes_budget_sheds_with_prediction_and_fails_open(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path / "run"))
    engine = _engine(max_batch=1, telemetry=sink,
                     fault_policy=FaultPolicy(queue_bytes_budget=1000),
                     cost_model=_StubCost(50))   # n16 -> 800 bytes
    engine.prewarm([_cfg()])
    engine.start()
    try:
        # The long runner takes the table's only lane, so later submits
        # stay QUEUED — that queue is what the bytes budget sizes.
        p_long = engine.submit(_cfg(steps=256, seed=1))
        _wait(lambda: engine.stats["lanes_joined"] >= 1)
        p_queued = engine.submit(_cfg(steps=8, seed=2))   # 800 committed
        with pytest.raises(ShedError) as ei:
            engine.submit(_cfg(steps=8, seed=3))   # headroom 200 < 800
        assert "bytes" in str(ei.value)
        assert engine.stats["shed"] == 1
        engine.cost_model = _StubCost(0)           # unpriced: fail-open
        p_open = engine.submit(_cfg(steps=8, seed=4))
        assert engine.stats["shed"] == 1
        assert p_queued.cancel() and p_open.cancel()
    finally:
        engine.stop()
    assert p_long.result(timeout=0).steps == 256
    sink.close()
    sheds = [e for e in obs.read_events(str(tmp_path / "run"))
             if e["event"] == "serve.shed"]
    assert [e["reason"] for e in sheds] == ["bytes_budget"]
    assert sheds[0]["predicted_bytes"] == 800
    assert set(sheds[0]) - {"event", "schema", "t_wall"} == set(
        obs_schema.SERVE_EVENT_FIELDS["serve.shed"])


def test_fault_policy_validates_bytes_budget():
    with pytest.raises(ValueError):
        FaultPolicy(queue_bytes_budget=0)
    with pytest.raises(ValueError):
        FaultPolicy(queue_bytes_budget=-5)
    assert FaultPolicy(queue_bytes_budget=None).queue_bytes_budget is None


# -- deep-backlog bursting -------------------------------------------------

def _backlog_engine(backlog_chunks):
    # The watermark classifies the queue as deep (depth > 2) but the huge
    # sustain keeps `_degraded` from ever flipping: horizons are never
    # cut and every result is full-length.
    return _engine(max_batch=2, chunk_steps=4, backlog_chunks=backlog_chunks,
                   fault_policy=FaultPolicy(degrade_high_watermark=2,
                                            degrade_sustain_s=1e9))


def test_deep_backlog_bursts_extra_chunks():
    engine = _backlog_engine(backlog_chunks=4)
    engine.prewarm([_cfg(steps=16)])
    engine.start()
    try:
        pending = [engine.submit(_cfg(steps=16, seed=s)) for s in range(10)]
        for p in pending:
            assert p.result(timeout=300).steps == 16
        assert engine.stats["backlog_extra_chunks"] > 0
    finally:
        engine.stop()


def test_backlog_chunks_one_never_bursts():
    engine = _backlog_engine(backlog_chunks=1)
    engine.prewarm([_cfg(steps=16)])
    engine.start()
    try:
        pending = [engine.submit(_cfg(steps=16, seed=s)) for s in range(6)]
        for p in pending:
            assert p.result(timeout=300).steps == 16
        assert engine.stats["backlog_extra_chunks"] == 0
    finally:
        engine.stop()


@pytest.mark.parametrize("kw", [{"backlog_chunks": 0}, {"chunk_steps": 0},
                                {"max_batch": 0}])
def test_continuous_knobs_validated(kw):
    with pytest.raises(ValueError):
        ServeEngine(continuous=True, device="cpu", **kw)


def test_loadgen_cli_sweep(capsys):
    rc = cli_main(["loadgen", "--device", "cpu", "--rps", "20",
                   "--duration", "0.3", "--n-min", "8", "--n-max", "16",
                   "--steps", "8", "--continuous", "--chunk", "8",
                   "--sweep-rps", "10:20:10", "--slo-p99", "1e9"])
    assert rc == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    sweep = record["sweep"]
    assert sweep["knee_rps"] == 20.0 and sweep["knee_censored"]
    assert [leg["rps"] for leg in sweep["legs"]] == [10.0, 20.0]
    assert record["stats"]["chunks_executed"] > 0
    assert record["stats"]["lanes_joined"] > 0


# -- parity against the JAX package ----------------------------------------

# Two static configs (buckets 16 and 32) and horizons 8-40 through 8-step
# chunks (1-5 chunks each, some ending mid-chunk); packed spawns, so every
# filter engages.
REQUESTS = [
    dict(n=10, steps=12, seed=1, safety_distance=0.42, consensus_gain=1.2),
    dict(n=20, steps=40, seed=6, safety_distance=0.41),
    dict(n=16, steps=16, seed=2, sep_gain=0.7),
    dict(n=32, steps=8, seed=7, consensus_gain=1.3),
    dict(n=12, steps=33, seed=3, consensus_gain=0.8, sep_gain=0.5),
    dict(n=25, steps=21, seed=8, safety_distance=0.38),
    dict(n=14, steps=40, seed=4, safety_distance=0.38),
    dict(n=28, steps=27, seed=9, sep_gain=0.7),
    dict(n=11, steps=9, seed=5),
]
ENGINE = dict(max_batch=4, bucket_sizes=(16, 32), chunk_steps=8)
COMMON = dict(record_trajectory=True, spawn_half_width_override=0.9)


def _requests(gating, dtype_name, fields=REQUESTS):
    jdt = getattr(jnp, dtype_name)
    jcfgs = [jsw.Config(gating=gating, dtype=jdt, **COMMON, **f)
             for f in fields]
    tcfgs = [convert.config_from_fields(
        {**f, **COMMON, "gating": gating, "dtype": dtype_name})
        for f in fields]
    return jcfgs, tcfgs


def _serve_continuous(engine, cfgs):
    """Submit every request to a started continuous engine, collect the
    results and each request's partial steps-done sequence."""
    seqs: dict = {}
    lock = threading.Lock()

    def hook(rid, done, _part):
        with lock:
            seqs.setdefault(rid, []).append(done)

    engine.partial_hook = hook
    engine.prewarm(cfgs)
    engine.start()
    try:
        pend = [engine.submit(c) for c in cfgs]
        res = [p.result(timeout=300) for p in pend]
    finally:
        engine.stop()
    return res, {r.request_id: seqs.get(r.request_id, []) for r in res}


def _continuous(gating, dtype_name, fields=REQUESTS):
    jcfgs, tcfgs = _requests(gating, dtype_name, fields)
    x64 = dtype_name == "float64"
    # The JAX engine's lane tables are built on its scheduler thread,
    # which a thread-local enable_x64 would not reach.
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        jeng = JServeEngine(continuous=True, **ENGINE)
        jres, jseq = _serve_continuous(jeng, jcfgs)
    finally:
        jax.config.update("jax_enable_x64", prev)
    teng = ServeEngine(continuous=True, device="cpu", **ENGINE)
    tres, tseq = _serve_continuous(teng, tcfgs)
    return dict(jax=(jeng, jres, jseq), port=(teng, tres, tseq),
                cfgs=tcfgs)


@pytest.fixture(scope="module")
def continuous_runs():
    return {"float64": _continuous("jnp", "float64"),
            "float32": _continuous("jnp", "float32"),
            # One static config (bucket 16): JAX's interpret-mode kernel
            # compiles once.
            "pallas": _continuous("pallas", "float32",
                                  [REQUESTS[i] for i in (0, 2, 4)])}


@pytest.mark.parametrize("case", ["float64", "float32", "pallas"])
def test_continuous_matches_jax(continuous_runs, case):
    atol = F64_ATOL if case == "float64" else F32_ATOL
    run = continuous_runs[case]
    jeng, jres, jseq = run["jax"]
    teng, tres, tseq = run["port"]
    assert len(tres) == len(jres) == len(run["cfgs"])
    for t, j in zip(tres, jres):
        assert (t.request_id, t.bucket, t.n, t.steps) == \
            (j.request_id, j.bucket, j.n, j.steps)
        assert "-k8-" in t.bucket
        assert tseq[t.request_id] == jseq[j.request_id]
        assert tseq[t.request_id][-1] == t.steps
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
        assert t.outputs.trajectory.shape == (t.steps, t.n, 2)
        assert int(np.sum(t.outputs.filter_active_count)) > 0
        assert (t.ttfp_s is None) == (len(tseq[t.request_id]) == 1)
    for k in ("lanes_joined", "lanes_vacated", "requests"):
        assert teng.stats[k] == jeng.stats[k] == len(tres), k
    assert teng.manifest_extra()["serve"]["chunk_buckets"] == \
        jeng.manifest_extra()["serve"]["chunk_buckets"]


def test_continuous_equals_drain(continuous_runs):
    """Each continuous result against the port's own drain result for the
    same request: the chunk program is the drain step program run in
    pieces, each lane at its own clock. On the CPU the two are bit-equal
    (so that is what is held here); the card holds them within 2e-4 with
    every count equal (chip_smoke.py phase 19a)."""
    teng, tres, _ = continuous_runs["float32"]["port"]
    cfgs = continuous_runs["float32"]["cfgs"]
    drain = ServeEngine(max_batch=4, bucket_sizes=(16, 32),
                        device="cpu").run(cfgs)
    for c, d in zip(tres, drain):
        assert c.steps == d.steps and c.n == d.n
        np.testing.assert_array_equal(c.final_state.x, d.final_state.x)
        np.testing.assert_array_equal(c.final_state.v, d.final_state.v)
        assert _tree_equal(c.outputs, d.outputs)


def test_chunk_program_is_the_drain_program_of_its_horizon():
    """The chunk capture prepares the program `lockstep_traced_chunk`
    replays: after prewarm, neither traffic nor a drain bucket of horizon
    ``chunk_steps`` adds a program to the step program's cache (which is
    process-wide: other tests may have filled it before)."""
    cfg = _cfg(steps=24, seed=1)
    engine = _engine(max_batch=3)
    key, _ = engine.bucket_of(cfg)
    program = ensemble._traced_program(key.static_cfg, None,
                                       torch.device("cpu"))
    before = set(getattr(program, "_rollout_programs", {}))
    engine.prewarm([cfg])
    after_prewarm = set(program._rollout_programs)
    assert len(after_prewarm - before) == 1
    engine.start()
    try:
        engine.submit(cfg).result(timeout=120)
    finally:
        engine.stop()
    drain = ServeEngine(max_batch=3, bucket_sizes=(16,), horizon_quantum=8,
                        device="cpu")
    drain.run([dataclasses.replace(cfg, steps=8)])
    assert set(program._rollout_programs) == after_prewarm


def _queued_then_finished(engine, cfgs):
    """Queue every request with no scheduler thread, then ``stop()``: the
    finish loop joins them and advances the tables on this thread, so the
    chunk sequence (and every ladder decision) is deterministic."""
    with engine._cond:
        engine._running = True
    pend = [engine.submit(c) for c in cfgs]
    engine.stop()
    out = []
    for p in pend:
        try:
            out.append(p.result(timeout=0))
        except Exception as e:    # noqa: BLE001 — the outcome is compared
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("case", ["retry", "demote"])
def test_chunk_failure_ladder_payloads_equal_jax(case):
    def hook(mod):
        if case == "retry":
            return mod.serve_executor_fault(times=1)
        return mod.serve_executor_fault(times=1, exc=ValueError("boom"))

    fields = [dict(n=10, steps=12, seed=i, gating="jnp") for i in range(3)]
    runs = {}
    for pkg in ("jax", "port"):
        sink = _Sink()
        if pkg == "jax":
            eng = JServeEngine(continuous=True, telemetry=sink,
                               fault_policy=JFaultPolicy(seed=11),
                               **{**ENGINE, "bucket_sizes": (16,)})
            cfgs = [jsw.Config(**f) for f in fields]
            eng.fault_hook = hook(jfaults)
        else:
            eng = ServeEngine(continuous=True, telemetry=sink, device="cpu",
                              tracer=Tracer(enabled=False),
                              fault_policy=FaultPolicy(seed=11),
                              **{**ENGINE, "bucket_sizes": (16,)})
            cfgs = [swarm.Config(**f) for f in fields]
            eng.fault_hook = hook(faults)
        res = _queued_then_finished(eng, cfgs)
        runs[pkg] = (eng, res, sink.of("serve.retry"))
    teng, tres, tretry = runs["port"]
    jeng, jres, jretry = runs["jax"]
    assert tretry == jretry
    assert [p["action"] for p in tretry] == [case]
    if case == "retry":
        assert tretry[0]["backoff_s"] > 0 and teng.stats["retries"] == 1
        assert teng.stats["batches"] == 0       # retried on its carry
    else:
        assert teng.stats["batches"] == len(fields)   # one solo run each
    assert teng.stats["lanes_vacated"] == jeng.stats["lanes_vacated"]
    clean = ServeEngine(max_batch=4, bucket_sizes=(16,), device="cpu").run(
        [swarm.Config(**f) for f in fields])
    for t, j, c in zip(tres, jres, clean):
        assert t.steps == j.steps == c.steps
        np.testing.assert_array_equal(t.final_state.x, c.final_state.x)
        assert _tree_equal(t.outputs, c.outputs)
        np.testing.assert_allclose(t.final_state.x,
                                   np.asarray(j.final_state.x),
                                   atol=F32_ATOL, rtol=0)


def test_stop_finishes_lanes_through_the_chunk_program():
    engine = _engine()
    partials = []
    engine.partial_hook = lambda rid, done, sl: partials.append(rid)
    engine.prewarm([_cfg()])
    before = dict(profiling.compile_event_counts())
    engine.start()
    pend = [engine.submit(_cfg(steps=64, seed=s)) for s in range(3)]
    _wait(lambda: len(partials) > 0)
    engine.stop()
    assert all(p.done() for p in pend)
    assert [p.result(timeout=0).steps for p in pend] == [64, 64, 64]
    assert engine._execs == {} and engine.stats["batches"] == 0
    assert engine.stats["compile_miss"] == 1
    after = profiling.compile_event_counts()
    grew = [k for k in after if k.startswith("serve.executable_miss[")
            and after[k] != before.get(k, 0)]
    assert grew == []


def test_lock_witness_across_a_demotion(tmp_path):
    lockwitness.arm()
    lockwitness.reset()
    try:
        engine = _engine(journal=str(tmp_path / "j.jsonl"),
                         telemetry=_Sink(), lane_ledger=True)
        engine.fault_hook = faults.serve_executor_fault(
            times=1, exc=ValueError("permanent"))
        engine.start()
        try:
            pend = [engine.submit(_cfg(steps=16, seed=s)) for s in range(2)]
            res = [p.result(timeout=120) for p in pend]
        finally:
            engine.stop()
            engine.journal.close()
        assert [r.steps for r in res] == [16, 16]
        assert engine.stats["lanes_vacated"] == engine.stats["lanes_joined"]
        assert lockwitness.snapshot()["acquisitions"] > 0
        assert lockwitness.inversions() == []
        assert lockwitness.check_subgraph(_static_lock_graph()) == []
    finally:
        lockwitness.disarm()
        lockwitness.reset()
