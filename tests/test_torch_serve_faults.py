"""Fault tolerance in the port's serving engine (cbf_tpu_torch.serve:
resilience, the engine's recovery ladder, the utils.faults serve
injectors and the flight recorder's serve capsules), on the CPU.

The ports of tests/test_serve_faults.py:100-400 and :507-614 with the JAX
package's sizes (n=10 in bucket 16, horizon 8, ``max_batch`` 8, gating
"jnp"): the taxonomy, ``FaultPolicy`` validation, the poisoned request
failing alone in a full batch, the transient retry, the bisect down to a
permanent offender, the capture ("compile") failure that charges the
bucket breaker without bisecting, admission (reject-newest,
reject-oldest's eviction), deadlines, the quarantine trip and recovery,
the scheduler crash, cancel, degrade under overload, bit-neutral idle
machinery, the manifest, and one capsule per serve fault class plus the
SIGTERM drain's.

Held to the JAX package itself: ``request_signature`` for seven configs
(float64 among them), and — on the same hook sequence — the ordered
``serve.retry`` / ``serve.quarantine`` payloads of the transient retry,
the bisect and the quarantine, ``backoff_s`` included (both engines draw
it from the same seeded numpy generator).
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.obs.trace import Tracer as JTracer
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.serve import FaultPolicy as JFaultPolicy
from cbf_tpu.serve import ServeEngine as JServeEngine
from cbf_tpu.serve import request_signature as jrequest_signature
from cbf_tpu.utils import faults as jfaults
from cbf_tpu_torch import convert
from cbf_tpu_torch.obs import flight as obs_flight
from cbf_tpu_torch.obs.trace import Tracer
from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.serve import (DeadlineExceeded, FaultPolicy,
                                 NonFiniteResult, QuarantinedError,
                                 RequestCancelled, SchedulerCrashed,
                                 ServeEngine, ShedError, is_retryable,
                                 request_signature)
from cbf_tpu_torch.utils import faults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(seed=0, **kw):
    kw.setdefault("n", 10)
    kw.setdefault("steps", 8)
    kw.setdefault("gating", "jnp")
    return swarm.Config(seed=seed, **kw)


def _jcfg(seed=0, **kw):
    kw.setdefault("n", 10)
    kw.setdefault("steps", 8)
    kw.setdefault("gating", "jnp")
    return jsw.Config(seed=seed, **kw)


class _Sink:
    """Minimal telemetry stub: records (event_type, payload) pairs."""

    def __init__(self):
        self.events = []

    def event(self, event_type, payload):
        self.events.append((event_type, dict(payload)))

    def of(self, event_type):
        return [p for t, p in self.events if t == event_type]


def _engine(sink=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("bucket_sizes", (16,))
    kw.setdefault("horizon_quantum", 8)
    kw.setdefault("flush_deadline_s", 0.15)
    return ServeEngine(telemetry=sink, tracer=Tracer(enabled=False),
                       device="cpu", **kw)


def _jengine(sink=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("bucket_sizes", (16,))
    kw.setdefault("horizon_quantum", 8)
    kw.setdefault("flush_deadline_s", 0.15)
    return JServeEngine(telemetry=sink, tracer=JTracer(enabled=False), **kw)


@pytest.fixture(scope="module")
def warm_execs():
    """Capture the one (n16, t8) bucket program once; every engine in
    this module reuses it (sharing ``_execs`` is the program-cache
    contract)."""
    eng = _engine()
    eng.prewarm([_cfg()])
    return eng._execs


@pytest.fixture(scope="module")
def jwarm_execs():
    eng = _jengine()
    eng.prewarm([_jcfg()])
    return eng._execs


@pytest.fixture()
def sink():
    return _Sink()


@pytest.fixture()
def engine(warm_execs, sink):
    eng = _engine(sink=sink)
    eng._execs = warm_execs
    return eng


# ----------------------------------------------------------- taxonomy --

def test_error_taxonomy_and_classification():
    for exc in (ShedError, DeadlineExceeded, QuarantinedError,
                NonFiniteResult, SchedulerCrashed, RequestCancelled):
        e = exc("boom", request_id="r1", bucket="b")
        assert e.request_id == "r1"
        assert not is_retryable(e)
    assert is_retryable(RuntimeError("transient"))
    assert is_retryable(faults.InjectedExecutorFault("flaky"))
    assert not is_retryable(ValueError("code bug"))


def test_request_signature_ignores_seed_and_tracks_knobs():
    a, b = _cfg(seed=1), _cfg(seed=99)
    assert request_signature(a) == request_signature(b)
    assert request_signature(a) != request_signature(
        faults.poison_config(a))


SIGNATURE_CASES = [
    ({}, "float32"),
    ({"n": 10, "steps": 8, "gating": "jnp"}, "float32"),
    ({"n": 10, "steps": 8, "dt": 1e30}, "float32"),
    ({"n": 64, "safety_distance": 0.3, "consensus_gain": 1.5}, "float64"),
    ({"dynamics": "unicycle", "n": 32, "rta": True}, "float32"),
    ({"certificate": True, "certificate_k": 8, "n": 48}, "float64"),
    ({"gating": "streaming", "n_obstacles": 4, "seed": 7}, "float32"),
]


@pytest.mark.parametrize("fields,dtype", SIGNATURE_CASES)
def test_request_signature_equals_jax(fields, dtype):
    """One quarantine key per request in both packages: the port renders
    its torch dtype as JAX's Config repr renders jnp's."""
    jcfg = jsw.Config(dtype=getattr(jnp, dtype), **fields)
    tcfg = convert.config_from_fields({**fields, "dtype": dtype})
    assert request_signature(tcfg) == jrequest_signature(jcfg)


def test_fault_policy_validates():
    with pytest.raises(ValueError, match="shed_policy"):
        FaultPolicy(shed_policy="drop-random")
    with pytest.raises(ValueError, match="max_retries"):
        FaultPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="queue_limit"):
        FaultPolicy(queue_limit=0)
    with pytest.raises(ValueError, match="degrade_steps_frac"):
        FaultPolicy(degrade_steps_frac=0.0)
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    assert [FaultPolicy().backoff_s(a, rng_t) for a in range(4)] == \
        [JFaultPolicy().backoff_s(a, rng_j) for a in range(4)]


# ------------------------------------------- blast-radius isolation --

def test_poisoned_request_fails_alone_in_full_batch(engine, sink):
    cfgs = [_cfg(seed=i) for i in range(8)]
    cfgs[3] = faults.poison_config(cfgs[3])
    engine.start()
    try:
        pendings = [engine.submit(c) for c in cfgs]   # fills the batch
        for i, p in enumerate(pendings):
            if i == 3:
                with pytest.raises(NonFiniteResult):
                    p.result(timeout=120)
            else:
                res = p.result(timeout=120)
                assert res.batch_fill == 8
                assert np.all(np.isfinite(res.final_state.x))
    finally:
        engine.stop()
    assert engine.stats["batches"] == 1
    assert engine.stats["nonfinite"] == 1
    assert engine.stats["requests"] == 7
    assert engine.stats["bisects"] == 0


def _bad_seed_hook(bad):
    def hook(key, entries, attempt, phase):
        if phase == "execute" and any(e[1].seed == bad for e in entries):
            raise ValueError(f"request with seed={bad} breaks the batch")
    return hook


def test_transient_executor_fault_is_retried(engine, sink):
    engine.fault_hook = faults.serve_executor_fault(times=1)
    results = engine.run([_cfg(seed=i) for i in range(4)])
    assert len(results) == 4
    assert engine.stats["retries"] == 1
    (retry,) = sink.of("serve.retry")
    assert retry["action"] == "retry" and retry["attempt"] == 1
    assert retry["error"] == "InjectedExecutorFault"
    assert retry["backoff_s"] > 0


def test_permanent_fault_bisects_to_offender(engine, sink):
    bad = 5
    engine.fault_hook = _bad_seed_hook(bad)
    engine.start()
    try:
        pendings = [engine.submit(_cfg(seed=i)) for i in range(8)]
        for i, p in enumerate(pendings):
            if i == bad:
                with pytest.raises(ValueError):
                    p.result(timeout=120)
            else:
                p.result(timeout=120)
    finally:
        engine.stop()
    assert engine.stats["retries"] == 0
    assert engine.stats["bisects"] == 3               # 8 -> 4 -> 2 -> 1
    assert engine.stats["failed"] == 1
    assert engine.stats["requests"] == 7
    assert all(e["action"] == "bisect" for e in sink.of("serve.retry"))


def _ladder(make, warm, cfg_of, hooks, policy):
    """Run ``len(hooks)`` drains of 8 requests on one engine, one hook
    each; return the ordered serve.retry / serve.quarantine payloads.
    Request 5 has a signature of its own (its mates' successes would
    otherwise close its breaker)."""
    s = _Sink()
    eng = make(sink=s)
    eng._execs = warm
    eng.fault_policy = policy
    cfgs = [cfg_of(seed=i, **({"consensus_gain": 1.5} if i == 5 else {}))
            for i in range(8)]
    for hook in hooks:
        eng.fault_hook = hook
        try:
            eng.run(cfgs)
        except (ValueError, RuntimeError):
            pass
    return [(t, p) for t, p in s.events
            if t in ("serve.retry", "serve.quarantine")]


@pytest.mark.parametrize("case", ["retry", "bisect", "quarantine"])
def test_fault_ladder_payloads_equal_jax(case, warm_execs, jwarm_execs):
    """The recovery ladder's decisions, event for event, equal the JAX
    engine's on the same hook sequence — backoff draws included."""
    def hooks(mod):
        if case == "retry":
            return [mod.serve_executor_fault(times=2)]
        if case == "bisect":
            return [_bad_seed_hook(5)]
        # Two failing drains strike the offender's signature twice
        # (threshold 2: the breaker opens), a clean one closes it.
        return [_bad_seed_hook(5), _bad_seed_hook(5), None]

    def policy(cls):
        if case == "quarantine":
            return cls(max_retries=0, quarantine_threshold=2,
                       quarantine_cooldown_s=0.0)
        return cls(seed=11)

    got = _ladder(_engine, warm_execs, _cfg, hooks(faults), policy(
        FaultPolicy))
    want = _ladder(_jengine, jwarm_execs, _jcfg, hooks(jfaults), policy(
        JFaultPolicy))
    assert got == want
    assert got, "the ladder emitted nothing"
    if case == "retry":
        assert [p["backoff_s"] for _, p in got if p["action"] == "retry"]
    if case == "quarantine":
        assert [p["state"] for t, p in got if t == "serve.quarantine"] == \
            ["open", "closed"]


def test_compile_failure_fails_batch_without_bisecting(engine, sink):
    """A capture-phase failure means the BUCKET is broken, not any
    request: no bisection, every member gets the error, the bucket
    breaker is charged, and no capture is made."""
    from cbf_tpu_torch.rollout import engine as rollout_engine

    engine.fault_policy = FaultPolicy(max_retries=0)
    engine.fault_hook = faults.serve_compile_failure(times=1)
    before = rollout_engine.COUNTS["captures"]
    engine.start()
    try:
        pendings = [engine.submit(_cfg(seed=i)) for i in range(8)]
        for p in pendings:
            with pytest.raises(faults.InjectedExecutorFault):
                p.result(timeout=120)
    finally:
        engine.stop()
    assert engine.stats["bisects"] == 0
    assert engine.stats["failed"] == 8
    assert engine._bucket_breakers
    assert rollout_engine.COUNTS["captures"] == before


# --------------------------------------------------- admission control --

def test_admission_reject_newest(warm_execs, sink):
    eng = _engine(sink=sink, flush_deadline_s=60.0)
    eng._execs = warm_execs
    eng.fault_policy = FaultPolicy(queue_limit=2)
    eng.start()
    try:
        a = eng.submit(_cfg(seed=0))
        b = eng.submit(_cfg(seed=1))
        with pytest.raises(ShedError):
            eng.submit(_cfg(seed=2))
    finally:
        eng.stop(drain=True)
    assert a.result(timeout=0).n == 10 and b.result(timeout=0).n == 10
    assert eng.stats["shed"] == 1
    (shed,) = sink.of("serve.shed")
    assert shed["reason"] == "queue_full" and shed["queue_depth"] == 2


def test_admission_reject_oldest_evicts(warm_execs, sink):
    eng = _engine(sink=sink, flush_deadline_s=60.0)
    eng._execs = warm_execs
    eng.fault_policy = FaultPolicy(queue_limit=2,
                                   shed_policy="reject-oldest")
    eng.start()
    try:
        a = eng.submit(_cfg(seed=0))
        b = eng.submit(_cfg(seed=1))
        c = eng.submit(_cfg(seed=2))                  # evicts a
        with pytest.raises(ShedError):
            a.result(timeout=1)
    finally:
        eng.stop(drain=True)
    assert b.result(timeout=0).n == 10 and c.result(timeout=0).n == 10
    (shed,) = sink.of("serve.shed")
    assert shed["reason"] == "oldest_evicted"
    assert shed["request_id"] == a.request_id


def test_background_tier_yields_to_foreground(warm_execs, sink):
    """A background submit queues apart (no foreground depth), and a
    foreground submit at the queue limit evicts it first."""
    eng = _engine(sink=sink, flush_deadline_s=60.0)
    eng._execs = warm_execs
    eng.fault_policy = FaultPolicy(queue_limit=2)
    eng.start()
    try:
        bg = eng.submit(_cfg(seed=0), priority="background")
        fg = eng.submit(_cfg(seed=1))
        assert eng._queue_depth() == 1
        fg2 = eng.submit(_cfg(seed=2))                # evicts bg
        with pytest.raises(ShedError):
            bg.result(timeout=1)
        with pytest.raises(ValueError, match="priority"):
            eng.submit(_cfg(seed=3), priority="urgent")
    finally:
        eng.stop(drain=True)
    assert fg.result(timeout=0).n == 10 and fg2.result(timeout=0).n == 10
    assert [s["reason"] for s in sink.of("serve.shed")] == \
        ["background_evicted"]
    assert eng.stats["background_shed"] == 1


def test_deadline_expired_request_dropped_before_execute(engine, sink):
    engine.start()
    try:
        pa = engine.submit(_cfg(seed=0), deadline_s=0.01)
        pb = engine.submit(_cfg(seed=1))
        with pytest.raises(DeadlineExceeded):
            pa.result(timeout=120)
        assert pb.result(timeout=120).batch_fill == 1
    finally:
        engine.stop()
    assert engine.stats["deadline_expired"] == 1
    (shed,) = sink.of("serve.shed")
    assert shed["reason"] == "deadline"


# -------------------------------------------------- quarantine breaker --

def test_quarantine_trips_and_recovers(warm_execs, sink):
    eng = _engine(sink=sink, flush_deadline_s=0.02)
    eng._execs = warm_execs
    eng.fault_policy = FaultPolicy(max_retries=0, quarantine_threshold=2,
                                   quarantine_cooldown_s=0.3)
    eng.fault_hook = faults.serve_executor_fault(times=2, exc=ValueError(
        "permanent model bug"))
    cfg = _cfg(seed=0)
    eng.start()
    try:
        for _ in range(2):
            with pytest.raises(ValueError):
                eng.submit(cfg).result(timeout=120)
        with pytest.raises(QuarantinedError):
            eng.submit(dataclasses.replace(cfg, seed=7))
        assert eng.stats["quarantined"] == 1
        time.sleep(0.35)
        probe = eng.submit(cfg)
        assert probe.result(timeout=120).n == 10
        eng.submit(cfg).result(timeout=120)
    finally:
        eng.stop()
    states = [e["state"] for e in sink.of("serve.quarantine")]
    assert states == ["open", "closed"]


def test_resilience_state_persists_beside_the_journal(warm_execs, tmp_path):
    """An open quarantine survives a restart: the next engine on the same
    journal reads ``<journal>.resilience`` and refuses the signature."""
    journal = str(tmp_path / "j.jsonl")
    eng = _engine(journal=journal, flush_deadline_s=0.02)
    eng._execs = warm_execs
    eng.fault_policy = FaultPolicy(max_retries=0, quarantine_threshold=1,
                                   quarantine_cooldown_s=60.0)
    eng.fault_hook = faults.serve_executor_fault(times=1, exc=ValueError(
        "permanent model bug"))
    with pytest.raises(ValueError):
        eng.run([_cfg(seed=0)])
    eng.journal.close()
    again = _engine(journal=journal)
    again._execs = warm_execs
    again.start()
    try:
        with pytest.raises(QuarantinedError):
            again.submit(_cfg(seed=3))
    finally:
        again.stop()
        again.journal.close()


# -------------------------------------------- scheduler crash + cancel --

def _crash_scheduler(eng, monkeypatch):
    p = eng.submit(_cfg(seed=0))
    time.sleep(0.05)

    def boom(now):
        raise RuntimeError("injected scheduler bug")

    monkeypatch.setattr(eng, "_scan_queue", boom)
    with eng._cond:
        eng._cond.notify()
    with pytest.raises(SchedulerCrashed):
        p.result(timeout=10)


def test_scheduler_crash_resolves_queued_requests(warm_execs, sink,
                                                  monkeypatch):
    eng = _engine(sink=sink, flush_deadline_s=60.0)
    eng._execs = warm_execs
    eng.start()
    try:
        _crash_scheduler(eng, monkeypatch)
    finally:
        eng.stop(drain=False)
    assert eng.stats["scheduler_crashes"] == 1
    (crash,) = sink.of("serve.scheduler_crash")
    assert crash["resolved"] == 1 and "RuntimeError" in crash["error"]


def test_cancel_queued_and_cancel_too_late(warm_execs, sink):
    eng = _engine(sink=sink, flush_deadline_s=60.0)
    eng._execs = warm_execs
    eng.start()
    try:
        p = eng.submit(_cfg(seed=0))
        assert p.cancel() is True
        with pytest.raises(RequestCancelled):
            p.result(timeout=1)
        assert p.cancel() is False
        eng.flush_deadline_s = 0.05
        q = eng.submit(_cfg(seed=1))
        res = q.result(timeout=120)
        assert q.cancel() is False
        assert q.result(timeout=0) is res
    finally:
        eng.stop()
    assert eng.stats["cancelled"] == 1
    assert eng.stats["requests"] == 1


# ------------------------------------------------ graceful degradation --

def test_sustained_overload_degrades_horizon(warm_execs, sink):
    eng = _engine(sink=sink, flush_deadline_s=0.3)
    eng._execs = warm_execs
    eng.fault_policy = FaultPolicy(degrade_high_watermark=2,
                                   degrade_sustain_s=0.05,
                                   degrade_steps_frac=0.5)
    eng.start()
    try:
        pendings = [eng.submit(_cfg(seed=i)) for i in range(6)]
        results = [p.result(timeout=120) for p in pendings]
    finally:
        eng.stop()
    assert all(r.degraded for r in results)
    assert all(r.steps == 4 for r in results)         # horizon 8 * 0.5
    assert results[0].outputs.min_pairwise_distance.shape == (4,)
    assert eng.stats["degraded_requests"] == 6
    enter = sink.of("serve.degrade")[0]
    assert enter["state"] == "enter" and enter["queue_depth"] >= 3
    assert eng.stats["batches"] == 1


# ----------------------------------------- idle neutrality + manifest --

def test_idle_fault_machinery_is_bit_neutral(engine):
    cfgs = [_cfg(seed=i) for i in range(3)]
    on = engine.run(cfgs)
    engine.fault_policy = FaultPolicy(check_finite=False, max_retries=0)
    off = engine.run(cfgs)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.final_state.x, b.final_state.x)
        np.testing.assert_array_equal(a.outputs.min_pairwise_distance,
                                      b.outputs.min_pairwise_distance)
    assert engine.stats["retries"] == 0
    assert engine.stats["nonfinite"] == 0


def test_manifest_snapshots_fault_policy_and_counters(engine):
    engine.run([_cfg(seed=0)])
    extra = engine.manifest_extra()["serve"]
    assert extra["fault_policy"]["max_retries"] == 2
    assert extra["fault_policy"]["check_finite"] is True
    for k in ("retries", "bisects", "shed", "deadline_expired",
              "quarantined", "failed", "nonfinite", "cancelled",
              "degraded_requests", "scheduler_crashes"):
        assert extra["fault_stats"][k] == 0, k
    assert extra["buckets"] == ["n16-t8-single-cert_off-gjnp"]


# ---------------------------------------------------- incident capsules --

def _flight(tmp_path, eng):
    eng.flight = obs_flight.FlightRecorder(str(tmp_path / "caps"))
    return eng.flight


def _one_capsule(rec, reason):
    assert rec.write_failures == 0
    (path,) = rec.capsules
    doc = obs_flight.read_capsule(path)
    assert doc["reason"] == reason
    assert doc["flight_schema"] == obs_flight.FLIGHT_SCHEMA_VERSION
    return doc


def test_nonfinite_capsule_replays_offending_config(engine, tmp_path,
                                                    capsys):
    """The poison capsule carries a verify-corpus replay stanza that
    rebuilds the EXACT offending config, and ``obs incident --replay``
    re-runs it through the port."""
    from cbf_tpu_torch.__main__ import main as cli_main
    from cbf_tpu_torch.verify import corpus

    rec = _flight(tmp_path, engine)
    cfgs = [_cfg(seed=i) for i in range(4)]
    cfgs[2] = faults.poison_config(cfgs[2])
    engine.start()
    try:
        pendings = [engine.submit(c) for c in cfgs]
        for i, p in enumerate(pendings):
            if i == 2:
                with pytest.raises(NonFiniteResult):
                    p.result(timeout=120)
            else:
                p.result(timeout=120)
    finally:
        engine.stop()
    doc = _one_capsule(rec, "serve.nonfinite")
    stanza = doc["request"]
    assert stanza["expect"] == "violates"
    rebuilt = corpus.rebuild_config(stanza["scenario"], stanza["overrides"])
    assert rebuilt == cfgs[2]
    seen = {r["request_id"] for r in doc["recent_requests"]}
    assert {p.request_id for p in pendings} <= seen
    capsys.readouterr()
    rc = cli_main(["obs", "incident", rec.capsules[0], "--replay",
                   "--device", "cpu", "--json"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert '"outcome": "violates"' in out


def test_quarantine_open_trips_one_capsule(warm_execs, tmp_path):
    eng = _engine(flush_deadline_s=0.02)
    eng._execs = warm_execs
    eng.fault_policy = FaultPolicy(max_retries=0, quarantine_threshold=2,
                                   quarantine_cooldown_s=30.0)
    eng.fault_hook = faults.serve_executor_fault(
        times=2, exc=ValueError("permanent model bug"))
    rec = _flight(tmp_path, eng)
    eng.start()
    try:
        for _ in range(2):
            with pytest.raises(ValueError):
                eng.submit(_cfg(seed=0)).result(timeout=120)
    finally:
        eng.stop()
    doc = _one_capsule(rec, "serve.quarantine")
    assert doc["request"] is not None


def test_bucket_breaker_open_trips_one_capsule(warm_execs, tmp_path):
    eng = _engine(flush_deadline_s=60.0)
    eng._execs = warm_execs
    eng.fault_policy = FaultPolicy(max_retries=0, breaker_threshold=2)
    eng.fault_hook = faults.serve_compile_failure(times=2)
    rec = _flight(tmp_path, eng)
    with pytest.raises(faults.InjectedExecutorFault):
        eng.run([_cfg(seed=0)])
    assert rec.capsules == []
    with pytest.raises(faults.InjectedExecutorFault):
        eng.run([_cfg(seed=1)])
    _one_capsule(rec, "serve.breaker")


def test_scheduler_crash_trips_one_capsule(warm_execs, tmp_path,
                                           monkeypatch):
    eng = _engine(flush_deadline_s=60.0)
    eng._execs = warm_execs
    rec = _flight(tmp_path, eng)
    eng.start()
    try:
        _crash_scheduler(eng, monkeypatch)
    finally:
        eng.stop(drain=False)
    doc = _one_capsule(rec, "serve.scheduler_crash")
    assert "RuntimeError" in doc["detail"]


def test_sigterm_drain_trips_one_capsule(warm_execs, tmp_path):
    eng = _engine(flush_deadline_s=60.0)
    eng._execs = warm_execs
    rec = _flight(tmp_path, eng)
    eng.start()
    p = eng.submit(_cfg(seed=0))
    eng._preempt.set()                                # as the handler does
    eng.stop(drain=True)
    assert p.result(timeout=0).n == 10
    doc = _one_capsule(rec, "sigterm.drain")
    assert doc["recent_requests"][0]["request_id"] == p.request_id


def test_rta_rescue_outcome_of_the_jax_package():
    """chip_smoke.py 18c prints the card's ``rta_fallback`` rescue of
    ``poison_config(Config(**RESCUE_FIELDS))`` beside RESCUE_JAX_CPU, the
    JAX package's outcome for that request on the CPU: held here."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    eng = JServeEngine(max_batch=8, bucket_sizes=(chip_smoke.FAULT_BUCKET,),
                       horizon_quantum=chip_smoke.RESCUE_QUANTUM,
                       tracer=JTracer(enabled=False),
                       fault_policy=JFaultPolicy(rta_fallback=True))
    res = eng.run([jfaults.poison_config(
        jsw.Config(**chip_smoke.RESCUE_FIELDS))])[0]
    outcome = {"resolved": "result", "rta_engaged": res.rta_engaged,
               "finite": bool(np.all(np.isfinite(res.final_state.x))),
               "bucket": res.bucket,
               "min_distance": round(float(np.min(
                   res.outputs.min_pairwise_distance)), 6)}
    assert eng.stats["rta_rescued"] == 1
    assert outcome == chip_smoke.RESCUE_JAX_CPU
