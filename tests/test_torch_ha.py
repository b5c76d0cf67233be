"""High availability in the port (cbf_tpu_torch.serve.ha), on the CPU.

The ports of tests/test_ha.py:97-509 (the 21 tests that are not slow)
and of its slow CLI round trip (:526-586, through ``python -m
cbf_tpu_torch`` with ``--device cpu``):

- lease epochs strictly monotonic, heartbeats that touch only the
  ``.beat`` sidecar, a renewal over a newer epoch fenced without a write,
  a stale-epoch sidecar that is no liveness, the garbled-file and
  before-acquire errors;
- the monitor's change-based expiry and its clock rebase;
- the journal fenced at append (before any byte) and at open, and a
  request acknowledged at the old epoch whose batch forms after the
  takeover resolving with the typed ``FencedError``;
- segment rotation, compaction and the torn tail of the active file;
- a resolved id never re-enqueued, a torn ``resolved`` record degrading
  to at-least-once, the breaker state restored across engine restarts;
- the takeover that dedupes under the armed lock witness (no inversion,
  and every observed edge explained by the static graph of the port's
  concurrency analyser, ``check_subgraph``);
- the supervisor's clean exit, its fenced pass-through and its crash-loop
  breaker; the README's port section documents the layer.

Against the JAX package (cbf_tpu.serve.ha): the event tables equal
JAX's; a lease written and beaten by either package reads equal through
the other's ``read_lease`` and ``LeaseMonitor``; the port's
``take_over`` of a journal a JAX primary wrote (6 acknowledged, 3
resolved) re-enqueues exactly the 3 under their ids, with results equal
to JAX's own takeover of the same journal (float64 to 1e-9, float32 to
2e-4, counts exact) and an equal ``ha.takeover`` payload. A continuous
engine fenced with lanes in flight resolves every lane, and the request
that joins after the fence, with ``FencedError``; no byte lands in the
journal after the fence and the armed witness sees no inversion and no
resolve under ``_PROGRAM_LOCK``.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.durable import journal as jdj
from cbf_tpu.obs import schema as jschema
from cbf_tpu.obs.trace import Tracer as JTracer
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.serve import ServeEngine as JServeEngine
from cbf_tpu.serve import ha as jha
from cbf_tpu_torch import convert
from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.durable import journal as dj
from cbf_tpu_torch.obs import schema as obs_schema
from cbf_tpu_torch.obs.trace import Tracer
from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.serve import (FaultPolicy, FencedError, QuarantinedError,
                                 ServeEngine)
from cbf_tpu_torch.serve import engine as serve_engine
from cbf_tpu_torch.serve import ha
from cbf_tpu_torch.utils import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = ("filter_active_count", "infeasible_count", "gating_dropped_count",
          "max_relax_rounds")


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


def _cfg(seed=0, **kw):
    kw.setdefault("n", 10)
    kw.setdefault("steps", 8)
    kw.setdefault("gating", "jnp")
    return swarm.Config(seed=seed, **kw)


class _Sink:
    """Minimal telemetry stub: records (event_type, payload) pairs."""

    registry = None

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


@pytest.fixture(scope="module")
def warm_programs():
    """Capture the one (n16, t8) bucket program once: the programs are
    cached process-wide, so every engine in this module reuses it."""
    _engine().prewarm([_cfg()])


# ------------------------------------------------------- event tables ----

def test_event_tables_equal_jax():
    assert obs_schema.HA_EVENT_TYPES == jschema.HA_EVENT_TYPES
    assert obs_schema.HA_EVENT_FIELDS == jschema.HA_EVENT_FIELDS
    assert obs_schema.CLUSTER_EVENT_TYPES == jschema.CLUSTER_EVENT_TYPES
    assert obs_schema.CLUSTER_EVENT_FIELDS == jschema.CLUSTER_EVENT_FIELDS
    assert ha.EMITTED_EVENT_TYPES == obs_schema.HA_EVENT_TYPES
    assert (ha.EXIT_FENCED, ha.EXIT_CRASH_LOOP) == \
        (jha.EXIT_FENCED, jha.EXIT_CRASH_LOOP) == (4, 3)
    assert ha.LEASE_SCHEMA_VERSION == jha.LEASE_SCHEMA_VERSION


# ------------------------------------------------------ lease epochs ----

def test_acquire_epochs_strictly_monotonic(tmp_path):
    path = str(tmp_path / "lease.json")
    assert ha.read_lease(path) is None
    a = ha.Lease(path, owner="a")
    b = ha.Lease(path, owner="b")
    assert a.acquire() == 1
    assert b.acquire() == 2
    assert a.acquire() == 3          # re-acquire keeps climbing
    state = ha.read_lease(path)
    assert state.epoch == 3 and state.owner == "a" and state.beat == 0


def test_heartbeat_bumps_sidecar_only(tmp_path):
    """Renewals never rewrite the epoch-authority file: the journal
    fence cannot be rolled back by a heartbeat, by construction."""
    path = str(tmp_path / "lease.json")
    lease = ha.Lease(path, owner="a")
    lease.acquire()
    with open(path) as fh:
        authority_before = fh.read()
    for _ in range(3):
        lease.heartbeat()
    assert ha.read_lease(path).beat == 3
    with open(path) as fh:
        assert fh.read() == authority_before   # byte-identical
    assert "beat" not in json.loads(authority_before)
    assert dj.read_fence_epoch(path) == 1


def test_heartbeat_over_newer_epoch_fenced_without_write(tmp_path):
    path = str(tmp_path / "lease.json")
    a = ha.Lease(path, owner="a")
    a.acquire()
    a.heartbeat()
    b = ha.Lease(path, owner="b")
    assert b.acquire() == 2
    with pytest.raises(FencedError) as exc:
        a.heartbeat()
    assert exc.value.epoch == 1
    assert exc.value.fence_epoch == 2
    assert exc.value.path == os.path.abspath(path)
    state = ha.read_lease(path)
    assert state.epoch == 2 and state.owner == "b" and state.beat == 0


def test_stale_beat_sidecar_is_not_liveness(tmp_path):
    """The SIGSTOP-zombie race distilled: a renewal whose fence check
    passed BEFORE a takeover may still land its write after — stamped
    with the old epoch. Readers must discard it."""
    path = str(tmp_path / "lease.json")
    a = ha.Lease(path, owner="a")
    a.acquire()
    b = ha.Lease(path, owner="b")
    b.acquire()
    b.heartbeat()
    # The zombie's late sidecar write (epoch 1), stomping b's (epoch 2).
    with open(ha.beat_path(path), "w") as fh:
        json.dump({"epoch": 1, "beat": 99, "t_wall": 0.0}, fh)
    state = ha.read_lease(path)
    assert state.epoch == 2
    assert state.beat == 0                     # stale beat discarded
    assert dj.read_fence_epoch(path) == 2      # fence untouched


def test_lease_edge_cases(tmp_path):
    path = str(tmp_path / "lease.json")
    with pytest.raises(RuntimeError, match="before acquire"):
        ha.Lease(path).heartbeat()
    with open(path, "w") as fh:
        fh.write("{not json")
    with pytest.raises(ValueError, match="unreadable lease"):
        ha.read_lease(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lease_files_read_across_packages(tmp_path, writer):
    """One lease format: a lease acquired and beaten by either package
    reads with equal fields through both packages' ``read_lease``, and
    both packages' monitors expire it at the same clock readings."""
    path = str(tmp_path / "lease.json")
    mod = jha if writer == "jax" else ha
    first = mod.Lease(path, owner="first")
    first.acquire()
    lease = mod.Lease(path, owner=f"{writer}-primary")
    assert lease.acquire() == 2
    for _ in range(3):
        lease.heartbeat()
    port_state, jax_state = ha.read_lease(path), jha.read_lease(path)
    assert tuple(port_state) == tuple(jax_state)
    assert (port_state.epoch, port_state.owner, port_state.beat) == \
        (2, f"{writer}-primary", 3)
    assert dj.read_fence_epoch(path) == jdj.read_fence_epoch(path) == 2
    now = {"t": 0.0}
    mons = [ha.LeaseMonitor(path, ttl_s=1.0, clock=lambda: now["t"]),
            jha.LeaseMonitor(path, ttl_s=1.0, clock=lambda: now["t"])]
    expired = []
    for t, beat in ((0.0, False), (0.6, True), (1.5, False), (1.6, False)):
        now["t"] = t
        if beat:
            lease.heartbeat()
        states = [m.poll() for m in mons]
        assert tuple(states[0]) == tuple(states[1])
        expired.append([m.expired() for m in mons])
    assert expired == [[False, False], [False, False], [False, False],
                       [True, True]]
    # The other package's writer takes over: both readers see it.
    other = (ha if writer == "jax" else jha).Lease(path, owner="other")
    assert other.acquire() == 3
    with pytest.raises((FencedError, jha.FencedError)):
        lease.heartbeat()
    assert tuple(ha.read_lease(path)) == tuple(jha.read_lease(path))
    assert ha.read_lease(path)[:3] == (3, "other", 0)


# -------------------------------------------------- expiry arithmetic ----

def test_monitor_expiry_is_change_based(tmp_path):
    path = str(tmp_path / "lease.json")
    lease = ha.Lease(path, owner="a")
    lease.acquire()
    now = {"t": 0.0}
    mon = ha.LeaseMonitor(path, ttl_s=1.0, clock=lambda: now["t"])
    assert not mon.expired()          # never observed -> cannot expire
    mon.poll()
    now["t"] = 0.9
    mon.poll()
    assert not mon.expired()
    now["t"] = 1.0                    # ttl with no change -> expired
    assert mon.expired()
    lease.heartbeat()                 # beat change re-stamps
    mon.poll()
    assert not mon.expired()
    now["t"] = 1.9
    assert not mon.expired()
    now["t"] = 2.0
    assert mon.expired()


def test_monitor_clock_rebase_restamps_instead_of_misfiring(tmp_path):
    path = str(tmp_path / "lease.json")
    ha.Lease(path, owner="a").acquire()
    now = {"t": 100.0}
    mon = ha.LeaseMonitor(path, ttl_s=1.0, clock=lambda: now["t"])
    mon.poll()
    now["t"] = 0.5                    # observer clock rebased to ~0
    assert not mon.expired()          # negative elapsed: re-stamp
    now["t"] = 1.4
    assert not mon.expired()          # measured from the re-stamp
    now["t"] = 1.5
    assert mon.expired()


# -------------------------------------------------------- journal fence --

def test_journal_append_fenced_before_any_byte(tmp_path):
    lease_path = str(tmp_path / "lease.json")
    jpath = str(tmp_path / "wal.jsonl")
    a = ha.Lease(lease_path, owner="a")
    j = dj.RequestJournal(jpath, epoch=a.acquire(), fence_path=lease_path)
    j.submitted("r0", _cfg())
    ha.Lease(lease_path, owner="b").acquire()        # the fence moves
    size = os.path.getsize(jpath)
    with pytest.raises(FencedError) as exc:
        j.submitted("r1", _cfg())
    assert exc.value.epoch == 1 and exc.value.fence_epoch == 2
    assert os.path.getsize(jpath) == size            # not a single byte
    with pytest.raises(FencedError):
        j.resolved("r0")
    j.close()
    # The new epoch's appender is unaffected.
    j2 = dj.RequestJournal(jpath, epoch=2, fence_path=lease_path)
    j2.resolved("r0")
    j2.close()
    replay = dj.replay_journal(jpath)
    assert replay.unresolved == []


def test_journal_open_is_fenced_too(tmp_path):
    lease_path = str(tmp_path / "lease.json")
    ha.Lease(lease_path, owner="b").acquire()
    ha.Lease(lease_path, owner="b").acquire()        # epoch 2 on disk
    with pytest.raises(FencedError):
        dj.RequestJournal(str(tmp_path / "wal.jsonl"), epoch=1,
                          fence_path=lease_path)


def test_fenced_midflight_request_resolves_typed(tmp_path, warm_programs):
    """A request acknowledged at the old epoch whose batch forms AFTER a
    takeover resolves with the typed FencedError (the new owner replays
    it) instead of hanging — and the engine remembers the fencing for
    the CLI's exit-4 path."""
    lease_path = str(tmp_path / "lease.json")
    jpath = str(tmp_path / "wal.jsonl")
    a = ha.Lease(lease_path, owner="a")
    j = dj.RequestJournal(jpath, epoch=a.acquire(), fence_path=lease_path)
    eng = _engine(flush_deadline_s=0.4, journal=j)
    eng.start()
    try:
        p = eng.submit(_cfg())                  # acknowledged at epoch 1
        ha.Lease(lease_path, owner="b").acquire()   # fence moves, queued
        with pytest.raises(FencedError):
            p.result(timeout=30)
        assert isinstance(eng.fenced, FencedError)
    finally:
        eng.stop(drain=True)
    # The fenced primary wrote nothing after the takeover: the epoch-1
    # ack is the log's only record — never executed, never resolved.
    replay = dj.replay_journal(jpath)
    assert replay.max_epoch == 1 and replay.records == 1
    assert len(replay.unresolved) == 1


def test_continuous_engine_fenced_with_lanes_in_flight(tmp_path,
                                                       monkeypatch):
    """The continuous scheduler fenced mid-flight: 3 long lanes and one
    short one in flight, a fifth request queued behind the full table.
    A second ``Lease.acquire`` fences the journal: every in-flight lane
    resolves with ``FencedError`` as it completes, the queued request
    takes the mid-join path (its ``packed`` record is refused) and
    resolves the same way, ``engine.fenced`` is set, and the journal
    does not grow by a byte after the fence. Armed, the witness records
    no inversion and no journal append under ``_PROGRAM_LOCK`` (the
    resolves run outside it)."""
    lockwitness.arm()
    lockwitness.reset()
    eng = None
    try:
        monkeypatch.setattr(serve_engine, "_PROGRAM_LOCK",
                            lockwitness.make_lock(
                                "serve.engine._PROGRAM_LOCK"))
        lease_path = str(tmp_path / "lease.json")
        jpath = str(tmp_path / "wal.jsonl")
        primary = ha.Lease(lease_path, owner="primary")
        j = dj.RequestJournal(jpath, epoch=primary.acquire(),
                              fence_path=lease_path)
        seen: dict = {}
        eng = _engine(continuous=True, chunk_steps=8, max_batch=4,
                      journal=j, flush_deadline_s=0.01)
        eng.partial_hook = lambda rid, done, part: seen.setdefault(
            rid, done)
        eng.start()
        long = [eng.submit(_cfg(seed=s, steps=400)) for s in range(3)]
        short = eng.submit(_cfg(seed=3, steps=40))
        deadline = time.monotonic() + 60
        while len(seen) < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(seen) == 4, seen
        queued = eng.submit(_cfg(seed=4, steps=16))    # table full
        assert eng.stats["lanes_joined"] == 4
        size = os.path.getsize(jpath)
        assert ha.Lease(lease_path, owner="standby").acquire() == 2
        for p in long + [short, queued]:
            with pytest.raises(FencedError) as exc:
                p.result(timeout=120)
            assert (exc.value.epoch, exc.value.fence_epoch) == (1, 2)
        assert isinstance(eng.fenced, FencedError)
        assert os.path.getsize(jpath) == size
        eng.stop(drain=True)
        assert lockwitness.inversions() == []
        assert ("serve.engine._PROGRAM_LOCK", "RequestJournal._lock") \
            not in lockwitness.observed_edges()
        assert lockwitness.check_subgraph(_static_lock_graph()) == []
    finally:
        if eng is not None and eng._running:
            eng.stop(drain=True)
        lockwitness.disarm()
        lockwitness.reset()
    replay = dj.replay_journal(jpath)
    assert replay.max_epoch == 1
    assert sorted(rid for rid, _ in replay.unresolved) == sorted(
        p.request_id for p in long + [short, queued])


# ------------------------------------------- rotation and compaction ----

def test_rotation_spills_segments_and_replays_whole(tmp_path):
    jpath = str(tmp_path / "wal.jsonl")
    j = dj.RequestJournal(jpath, rotate_bytes=400)
    for i in range(6):
        j.submitted(f"r{i}", _cfg(seed=i))
    j.close()
    segs = dj.journal_segments(jpath)
    assert segs, "rotate_bytes=400 must have rotated at least once"
    replay = dj.replay_journal(jpath)
    assert sorted(replay.submitted) == [f"r{i}" for i in range(6)]
    assert len(replay.unresolved) == 6
    # Reopen mid-rotation: the appender continues the segment sequence.
    j2 = dj.RequestJournal(jpath, rotate_bytes=400)
    for i in range(6):
        j2.resolved(f"r{i}")
    j2.close()
    replay = dj.replay_journal(jpath)
    assert replay.unresolved == []
    assert max(replay.resolved_counts.values()) == 1


def test_compaction_drops_only_fully_redundant_segments(tmp_path):
    """A segment may vanish ONLY when the unresolved fold without it is
    identical — an id resolved in a later file lets its segment go; an
    open id pins its segment forever."""
    jpath = str(tmp_path / "wal.jsonl")
    j = dj.RequestJournal(jpath, rotate_bytes=250)
    j.submitted("open", _cfg(seed=0))      # never resolved: pins its seg
    for i in range(5):
        j.submitted(f"r{i}", _cfg(seed=i))
        j.resolved(f"r{i}")
    before = dj.replay_journal(jpath)
    removed = dj.compact_segments(jpath)
    after = dj.replay_journal(jpath)
    assert [rid for rid, _ in after.unresolved] == ["open"]
    assert [rid for rid, _ in before.unresolved] == ["open"]
    assert "open" in after.submitted
    j.close()
    assert removed, "fully-redundant segments should have been dropped"
    assert not set(removed) & set(dj.journal_segments(jpath))


def test_torn_tail_forgiven_in_active_file_only(tmp_path):
    jpath = str(tmp_path / "wal.jsonl")
    j = dj.RequestJournal(jpath, rotate_bytes=250)
    for i in range(4):
        j.submitted(f"r{i}", _cfg(seed=i))
    j.close()
    segs = dj.journal_segments(jpath)
    assert segs
    # Tear the ACTIVE file's tail: forgiven, then repaired on reopen.
    with open(jpath, "a") as fh:
        fh.write('{"type": "resolved", "request_id": "r3", "ou')
    replay = dj.replay_journal(jpath)
    assert len(replay.unresolved) == 4       # torn record doesn't count
    j2 = dj.RequestJournal(jpath)            # reopen repairs the tear
    j2.resolved("r0")
    j2.close()
    assert len(dj.replay_journal(jpath).unresolved) == 3
    # A tear inside a rotated segment is real damage, not a crash scar.
    with open(segs[0], "a") as fh:
        fh.write('{"type": "submitted"')
    with pytest.raises(dj.RecoveryError):
        dj.replay_journal(jpath)


# ----------------------------------------------- replay dedupe (pin) ----

def test_resolved_id_never_reenqueued_at_recovery(tmp_path, warm_programs):
    """A durable ``resolved`` record excludes its id from recovery even
    when the client never saw the result; only the genuinely unresolved
    id re-runs."""
    jpath = str(tmp_path / "wal.jsonl")
    j = dj.RequestJournal(jpath)
    j.submitted("r1", _cfg(seed=1))
    j.resolved("r1")                  # fsync'd; client may never know
    j.submitted("r2", _cfg(seed=2))
    j.close()
    eng = _engine(journal=dj.RequestJournal(jpath))
    eng.start()
    try:
        pendings = eng.recover(jpath)
        assert [p.request_id for p in pendings] == ["r2"]
        pendings[0].result(timeout=120)
    finally:
        eng.stop(drain=True)
    counts = dj.replay_journal(jpath).resolved_counts
    assert counts["r1"] == 1          # never re-executed
    assert counts["r2"] == 1
    assert dj.replay_journal(jpath).unresolved == []


def test_torn_resolved_record_degrades_to_at_least_once(tmp_path):
    jpath = str(tmp_path / "wal.jsonl")
    j = dj.RequestJournal(jpath)
    j.submitted("r1", _cfg(seed=1))
    j.close()
    with open(jpath, "a") as fh:      # the fsync never completed
        fh.write('{"type": "resolved", "request_id": "r1", "outco')
    replay = dj.replay_journal(jpath)
    assert [rid for rid, _ in replay.unresolved] == ["r1"]


# ------------------------------------- resilience state across restart --

def test_breaker_state_survives_engine_restart(tmp_path, warm_programs):
    """Two strikes open the signature breaker in engine 1; engine 2 on
    the same journal restores it — the same signature fails fast at once
    and the half-open probe is still admitted after the REMAINING
    cooldown."""
    jpath = str(tmp_path / "wal.jsonl")
    e1 = _engine(journal=dj.RequestJournal(jpath), flush_deadline_s=0.02)
    e1.fault_policy = FaultPolicy(max_retries=0, quarantine_threshold=2,
                                  quarantine_cooldown_s=1.0)
    e1.fault_hook = faults.serve_executor_fault(times=2, exc=ValueError(
        "permanent model bug"))
    cfg = _cfg(seed=0)
    e1.start()
    try:
        for _ in range(2):
            with pytest.raises(ValueError):
                e1.submit(cfg).result(timeout=120)
    finally:
        e1.stop(drain=True)
    assert os.path.exists(f"{jpath}.resilience")

    e2 = _engine(journal=dj.RequestJournal(jpath), flush_deadline_s=0.02)
    e2.fault_policy = FaultPolicy(max_retries=0, quarantine_threshold=2,
                                  quarantine_cooldown_s=1.0)
    e2.start()
    try:
        with pytest.raises(QuarantinedError):    # restored: fail-fast
            e2.submit(dataclasses.replace(cfg, seed=7))
        time.sleep(1.05)                         # past remaining cooldown
        probe = e2.submit(cfg)                   # half-open: admitted
        assert probe.result(timeout=120).n == 10
    finally:
        e2.stop(drain=True)


# ------------------------------------------- takeover, witness-armed ----

def test_takeover_dedupes_and_books_no_lock_inversions(tmp_path,
                                                       warm_programs):
    """A full in-process takeover — lease bump, fenced journal reopen,
    replay with request-id dedupe, re-enqueue, drain — under the ARMED
    lock witness: no observed inversion, and every observed edge held to
    the static concurrency analyser's graph (``check_subgraph``), as
    JAX's test holds it."""
    lease_path = str(tmp_path / "lease.json")
    jpath = str(tmp_path / "wal.jsonl")
    primary = ha.Lease(lease_path, owner="primary")
    j = dj.RequestJournal(jpath, epoch=primary.acquire(),
                          fence_path=lease_path)
    j.submitted("r0", _cfg(seed=0))
    j.resolved("r0")                      # done: must be deduped
    j.submitted("r1", _cfg(seed=1))       # acknowledged, unresolved
    j.close()

    lockwitness.arm()
    lockwitness.reset()
    try:
        sink = _Sink()
        eng = _engine(sink=sink)
        standby = ha.Lease(lease_path, owner="standby", telemetry=sink)
        report = ha.take_over(lease=standby, journal_path=jpath,
                              engine=eng, telemetry=sink)
        try:
            assert report.epoch == 2 and report.prev_epoch == 1
            assert report.deduped == 1 and report.reenqueued == 1
            assert [p.request_id for p in report.pendings] == ["r1"]
            report.pendings[0].result(timeout=120)
        finally:
            eng.stop(drain=True)
        assert lockwitness.inversions() == []
        assert lockwitness.check_subgraph(_static_lock_graph()) == []
    finally:
        lockwitness.disarm()
        lockwitness.reset()

    counts = dj.replay_journal(jpath).resolved_counts
    assert counts == {"r0": 1, "r1": 1}   # exactly-once census
    assert [e["action"] for e in sink.of("ha.lease")] == ["acquire"]
    (takeover,) = sink.of("ha.takeover")
    assert takeover["epoch"] == 2 and takeover["deduped"] == 1


# Six requests in one bucket (n16, t8): the JAX primary resolves the
# first three through run() and acknowledges the last three, then dies.
TAKEOVER_FIELDS = [
    dict(n=10, steps=8, seed=1, safety_distance=0.42),
    dict(n=12, steps=6, seed=2, consensus_gain=1.2),
    dict(n=9, steps=8, seed=3, dt=0.028),
    dict(n=14, steps=8, seed=4, safety_distance=0.38, sep_gain=0.6),
    dict(n=11, steps=7, seed=5, consensus_gain=0.8),
    dict(n=16, steps=8, seed=6, dt=0.03),
]
TAKEOVER_COMMON = dict(gating="jnp", record_trajectory=True,
                       spawn_half_width_override=0.9)


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_port_takes_over_a_jax_primary(tmp_path, dtype_name):
    """A JAX primary journals 6 requests under a lease (3 resolved, 3
    acknowledged and still queued) when the port's standby takes over:
    ``take_over`` re-enqueues exactly the 3 under their original ids,
    their results equal JAX's own takeover of a copy of the same
    journal (float64 to 1e-9, float32 to 2e-4, counts exact), and the
    ``ha.takeover`` payloads are equal field for field (the MTTR a
    timing). The JAX zombie, fenced by the port's lease, lands nothing
    in the journal."""
    atol = 1e-9 if dtype_name == "float64" else 2e-4
    jdt = getattr(jnp, dtype_name)
    jcfgs = [jsw.Config(dtype=jdt, **TAKEOVER_COMMON, **f)
             for f in TAKEOVER_FIELDS]
    tcfgs = [convert.config_from_fields(
        {**f, **TAKEOVER_COMMON, "dtype": dtype_name})
        for f in TAKEOVER_FIELDS]
    rids = [f"r{i}" for i in range(6)]
    lease_path, jpath = str(tmp_path / "lease.json"), str(tmp_path / "wal")
    copy = tmp_path / "copy"
    copy.mkdir()
    engine_kw = dict(max_batch=8, bucket_sizes=(16,), horizon_quantum=8)
    # The scheduler thread runs JAX's batches: x64 must be global.
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype_name == "float64")
    jeng = jrec = teng = None
    try:
        jlease = jha.Lease(lease_path, owner="jax-primary")
        jeng = JServeEngine(
            journal=jdj.RequestJournal(jpath, epoch=jlease.acquire(),
                                       fence_path=lease_path),
            flush_deadline_s=600.0, tracer=JTracer(enabled=False),
            **engine_kw)
        jeng.run(jcfgs[:3], request_ids=rids[:3])
        jeng.start()
        zombies = [jeng.submit(c, request_id=r)
                   for c, r in zip(jcfgs[3:], rids[3:])]
        for name in ("lease.json", "lease.json.beat", "wal"):
            shutil.copy(tmp_path / name, copy / name)
        size = os.path.getsize(jpath)

        jsink, tsink = _Sink(), _Sink()
        jrec = JServeEngine(tracer=JTracer(enabled=False), **engine_kw)
        jrec._execs = jeng._execs
        jreport = jha.take_over(
            lease=jha.Lease(str(copy / "lease.json"), owner="standby",
                            telemetry=jsink),
            journal_path=str(copy / "wal"), engine=jrec, telemetry=jsink)
        jres = [p.result(timeout=300) for p in jreport.pendings]
        jrec.stop(drain=True)

        teng = ServeEngine(tracer=Tracer(enabled=False), device="cpu",
                           **engine_kw)
        treport = ha.take_over(
            lease=ha.Lease(lease_path, owner="standby", telemetry=tsink),
            journal_path=jpath, engine=teng, telemetry=tsink)
        tres = [p.result(timeout=300) for p in treport.pendings]
        teng.stop(drain=True)
        # The fenced JAX zombie drains its queue: every handle fails
        # typed and nothing lands in the log after the port's records.
        tail = os.path.getsize(jpath)
        jeng.stop(drain=True)
        for z in zombies:
            with pytest.raises(jha.FencedError):
                z.result(timeout=60)
        assert os.path.getsize(jpath) == tail > size
    finally:
        for eng in (jeng, jrec, teng):
            if eng is not None and eng._running:
                eng.stop(drain=False)
        jax.config.update("jax_enable_x64", prev)

    assert [r.request_id for r in tres] == [r.request_id for r in jres] \
        == rids[3:]
    assert (treport.epoch, treport.prev_epoch, treport.reenqueued,
            treport.deduped) == (2, 1, 3, 3)
    for t, j in zip(tres, jres):
        assert (t.bucket, t.n, t.steps, t.batch_fill) == \
            (j.bucket, j.n, j.steps, j.batch_fill)
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
    (tpay,), (jpay,) = tsink.of("ha.takeover"), jsink.of("ha.takeover")
    assert set(tpay) == set(jpay)
    assert {k: v for k, v in tpay.items() if k != "mttr_s"} == \
        {k: v for k, v in jpay.items() if k != "mttr_s"}
    replay = dj.replay_journal(jpath)
    assert replay.unresolved == [] and replay.max_epoch == 2
    assert replay.resolved_counts == {r: 1 for r in rids}
    assert tuple(ha.read_lease(lease_path))[:3] == (2, "standby", 0)


# ------------------------------------------------- supervisor contract --

def _child_argv(code):
    return [sys.executable, "-c", code]


def test_supervisor_clean_exit_ends_supervision():
    sup = ha.Supervisor(_child_argv("raise SystemExit(0)"),
                        backoff_base_s=0.01)
    assert sup.run() == 0
    assert sup.restarts == 0


def test_supervisor_never_restarts_a_fenced_child():
    sink = _Sink()
    sup = ha.Supervisor(_child_argv(f"raise SystemExit({ha.EXIT_FENCED})"),
                        backoff_base_s=0.01, telemetry=sink)
    assert sup.run() == ha.EXIT_FENCED
    assert sup.restarts == 0
    assert sink.of("ha.restart") == []


def test_supervisor_crash_loop_breaker_trips():
    sink = _Sink()
    sup = ha.Supervisor(_child_argv("raise SystemExit(1)"),
                        backoff_base_s=0.01, backoff_max_s=0.05,
                        max_restarts=2, crash_window_s=30.0,
                        telemetry=sink)
    assert sup.run() == ha.EXIT_CRASH_LOOP
    assert sup.restarts == 2
    restarts = sink.of("ha.restart")
    assert [e["exit_code"] for e in restarts] == [1, 1]
    assert [e["attempt"] for e in restarts] == [1, 2]
    # Exponential backoff is visible in the emitted schedule.
    assert restarts[1]["backoff_s"] > restarts[0]["backoff_s"]
    (loop,) = sink.of("ha.crash_loop")
    assert loop["restarts"] == 2 and loop["window_s"] == 30.0


# ------------------------------------------------------ docs lockstep ----

def test_docs_cover_high_availability():
    """The README's port section documents the HA layer (the JAX test
    reads docs/API.md, which documents the JAX package)."""
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as fh:
        readme = fh.read()
    port = readme[readme.index("## PyTorch/CUDA port"):]
    port = port[:port.index("\n## ", 1)]
    assert "serve/ha" in port
    for needle in ("`ha.lease`", "`ha.takeover`", "`ha.fenced`",
                   "`ha.restart`", "`ha.crash_loop`", "--supervised",
                   "--ha-standby", "--lease", "--heartbeat-s",
                   "--rotate-bytes", "`.beat`", "exit code 4",
                   "`<journal>.resilience`"):
        assert needle in port, f"README port section missing {needle!r}"


# ------------------------------------------------ full CLI round-trip ----

@pytest.mark.slow
def test_cli_failover_sigkill_roundtrip(tmp_path):
    """Through the port's CLI: a hot standby takes over from a SIGKILLed
    paced primary with zero lost acknowledged requests and zero
    duplicate executions (exact request-id census)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    lease = str(tmp_path / "lease.json")
    jpath = str(tmp_path / "wal.jsonl")
    ready = str(tmp_path / "ready")
    reqs = str(tmp_path / "reqs.json")
    with open(reqs, "w") as fh:
        json.dump([{"steps": 6, "seed": 1,
                    "overrides": {"n": 8, "gating": "jnp"},
                    "repeat": 8}], fh)
    standby = subprocess.Popen(
        [sys.executable, "-m", "cbf_tpu_torch", "serve", "--ha-standby",
         "--lease", lease, "--journal", jpath, "--lease-ttl-s", "1.0",
         "--ready-file", ready, "--standby-max-wait-s", "120",
         "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        assert faults.wait_for_file(ready, 120), "standby never ready"

        def should_kill(elapsed, armed=[None]):
            if armed[0] is None:
                try:
                    with open(jpath) as fh:
                        if any('"submitted"' in ln for ln in fh):
                            armed[0] = elapsed
                except OSError:
                    pass
                return False
            return elapsed - armed[0] >= 0.8
        rc, killed, _ = faults.run_process_until(
            [sys.executable, "-m", "cbf_tpu_torch", "serve", reqs,
             "--lease", lease, "--journal", jpath, "--pace-s", "0.3",
             "--heartbeat-s", "0.1", "--device", "cpu"],
            should_kill, poll_s=0.02, timeout_s=180, env=env)
        assert killed, f"primary finished (rc={rc}) before the kill"
        out, _ = standby.communicate(timeout=180)
    except BaseException:
        standby.kill()
        standby.communicate()
        raise
    assert standby.returncode == 0
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["takeover"] and rec["epoch"] == 2
    replay = dj.replay_journal(jpath)
    assert replay.unresolved == []                      # zero lost
    assert max(replay.resolved_counts.values()) == 1    # zero dups
