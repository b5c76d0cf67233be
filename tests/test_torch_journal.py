"""The serve engine's write-ahead request journal in the port
(cbf_tpu_torch.durable.journal), on the CPU.

The ports of tests/test_durable.py:148-359: the fold and the unresolved
order, a resubmit reopening a request, a torn final line tolerated (and
repaired on reopen), a garbled middle line and an unknown schema or a
missing file raising ``RecoveryError``, ``stop(drain=True)`` resolving and
journaling every queued request, SIGTERM draining from the scheduler
thread and not from the handler (the lock witness armed: no inversion),
``recover`` re-running only the unresolved requests under their original
ids, and the CLI's SIGTERM drain in a child process on ``--device cpu``.

One file format for both packages: a journal written by the port's engine
is folded by the JAX package's ``replay_journal`` to the same unresolved
ids and configs as the port's fold, and a journal written by the JAX
package's engine by the port's.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cbf_tpu.durable import journal as jj
from cbf_tpu.obs.trace import Tracer as JTracer
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.serve import ServeEngine as JServeEngine
from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.durable import journal as dj
from cbf_tpu_torch.obs.trace import Tracer
from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.serve import RecoveryError, ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mk_cfg(**kw):
    return swarm.Config(**{"n": 8, "steps": 6, "gating": "jnp", **kw})


def _engine(**kw):
    kw.setdefault("bucket_sizes", (16,))
    kw.setdefault("horizon_quantum", 8)
    return ServeEngine(device="cpu", tracer=Tracer(enabled=False), **kw)


# ------------------------------------------------------- WAL journal ----

def test_journal_fold_and_unresolved_order(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = dj.RequestJournal(path)
    j.submitted("r0", _mk_cfg(seed=3))
    j.submitted("r1", _mk_cfg(seed=4))
    j.packed("n8_t8", ["r0", "r1"])
    j.resolved("r0")
    j.close()

    replay = dj.replay_journal(path)
    assert [rid for rid, _ in replay.unresolved] == ["r1"]
    (rid, cfg), = replay.unresolved_configs()
    assert rid == "r1" and isinstance(cfg, swarm.Config) and cfg.seed == 4
    assert cfg == _mk_cfg(seed=4)


def test_journal_resubmit_reopens(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = dj.RequestJournal(path)
    j.submitted("r0", _mk_cfg())
    j.resolved("r0")
    j.submitted("r0", _mk_cfg())    # recovery re-acknowledged it
    j.close()
    assert [rid for rid, _ in dj.replay_journal(path).unresolved] == ["r0"]


def test_journal_torn_final_line_tolerated(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = dj.RequestJournal(path)
    j.submitted("r0", _mk_cfg())
    j.close()
    with open(path, "a") as fh:
        fh.write('{"type": "submitted", "requ')   # killed mid-append
    replay = dj.replay_journal(path)
    assert [rid for rid, _ in replay.unresolved] == ["r0"]


def test_journal_reopen_repairs_torn_tail(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = dj.RequestJournal(path)
    j.submitted("r0", _mk_cfg())
    j.close()
    with open(path, "a") as fh:
        fh.write('{"type": "submitted", "requ')
    j2 = dj.RequestJournal(path)                  # restart: repairs tail
    j2.submitted("r1", _mk_cfg())
    j2.close()
    replay = dj.replay_journal(path)
    assert [rid for rid, _ in replay.unresolved] == ["r0", "r1"]
    dj.RequestJournal(path).close()


def test_journal_repair_drops_garbled_final_line_with_newline(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = dj.RequestJournal(path)
    j.submitted("r0", _mk_cfg())
    j.close()
    with open(path, "a") as fh:
        fh.write('{"type": "submitted", "requ\n')
    assert dj.repair_torn_tail(path) > 0
    j2 = dj.RequestJournal(path)
    j2.submitted("r1", _mk_cfg())
    j2.close()
    assert [rid for rid, _ in dj.replay_journal(path).unresolved] \
        == ["r0", "r1"]


def test_journal_garbled_middle_raises(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = dj.RequestJournal(path)
    j.submitted("r0", _mk_cfg())
    j.submitted("r1", _mk_cfg())
    j.close()
    lines = open(path).read().splitlines()
    lines[0] = lines[0][: len(lines[0]) // 2]     # damage a NON-final line
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with pytest.raises(RecoveryError, match="garbled"):
        dj.replay_journal(path)


def test_journal_unknown_schema_and_missing_file_raise(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with pytest.raises(RecoveryError, match="no request journal"):
        dj.replay_journal(path)
    with open(path, "w") as fh:
        fh.write(json.dumps({"type": "submitted", "request_id": "r0",
                             "config": {}, "schema": 99}) + "\n")
    with pytest.raises(RecoveryError, match="schema"):
        dj.replay_journal(path)


def test_journal_rotation_and_compaction(tmp_path):
    """Segments rotate once the active file crosses ``rotate_bytes``; a
    fully resolved segment is compacted away; the fold is unchanged."""
    path = str(tmp_path / "j.jsonl")
    j = dj.RequestJournal(path, rotate_bytes=600)
    for i in range(6):
        j.submitted(f"r{i}", _mk_cfg(seed=i))
        if i != 4:
            j.resolved(f"r{i}")
    j.close()
    assert [rid for rid, _ in dj.replay_journal(path).unresolved] == ["r4"]
    assert [rid for rid, _ in jj.replay_journal(path).unresolved] == ["r4"]
    assert len(dj.journal_segments(path)) >= 1


# ------------------------------------------- drain + crash recovery ----

def test_stop_drain_resolves_every_queued_request(tmp_path):
    path = str(tmp_path / "j.jsonl")
    engine = _engine(max_batch=2, flush_deadline_s=60.0, journal=path)
    engine.start()
    handles = [engine.submit(_mk_cfg(seed=i)) for i in range(5)]
    engine.stop(drain=True)
    for h in handles:
        r = h.result(timeout=0)
        assert r.request_id == h.request_id
    assert dj.replay_journal(path).unresolved == []


def test_sigterm_drains_from_scheduler_not_the_handler(tmp_path):
    """The SIGTERM handler only sets the preempt flag; the scheduler
    thread drains from its own control flow, every acknowledged request
    resolves and journals its terminal record, and the armed lock witness
    sees a cycle-free acquisition order."""
    path = str(tmp_path / "j.jsonl")
    lockwitness.arm()
    lockwitness.reset()
    try:
        engine = _engine(max_batch=2, flush_deadline_s=60.0, journal=path)
        engine.start()
        prev = engine.install_sigterm_handler()
        try:
            handles = [engine.submit(_mk_cfg(seed=i)) for i in range(3)]
            os.kill(os.getpid(), signal.SIGTERM)
            for h in handles:
                r = h.result(timeout=120)
                assert r.request_id == h.request_id
        finally:
            signal.signal(signal.SIGTERM, prev)
            engine.stop(drain=True)
        assert dj.replay_journal(path).unresolved == []
        assert lockwitness.snapshot()["acquisitions"] > 0
        assert lockwitness.inversions() == []
    finally:
        lockwitness.disarm()
        lockwitness.reset()


def test_recover_reruns_only_unresolved_under_original_ids(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = dj.RequestJournal(path)                  # the "crashed" process
    j.submitted("r0", _mk_cfg(seed=0))
    j.submitted("r1", _mk_cfg(seed=1))
    j.submitted("r2", _mk_cfg(seed=2))
    j.resolved("r1")
    j.close()

    engine = _engine(max_batch=4, flush_deadline_s=0.05, journal=path)
    engine.start()
    handles = engine.recover(path)
    assert sorted(h.request_id for h in handles) == ["r0", "r2"]
    results = {h.request_id: h.result(timeout=60) for h in handles}
    engine.stop()
    assert dj.replay_journal(path).unresolved == []
    # Each recovered result is the request's own: equal to a fresh run.
    fresh = _engine(max_batch=4).run([_mk_cfg(seed=0), _mk_cfg(seed=2)])
    for rid, want in zip(("r0", "r2"), fresh):
        np.testing.assert_array_equal(results[rid].final_state.x,
                                      want.final_state.x)


def test_serve_cli_sigterm_graceful_drain(tmp_path):
    """SIGTERM the serve CLI mid-batch: it drains (exit 0, full JSON
    record, every request in ``results``) and leaves the journal with
    zero unresolved entries."""
    reqs = str(tmp_path / "reqs.json")
    with open(reqs, "w") as fh:
        json.dump([{"overrides": {"n": 8, "gating": "jnp"}, "steps": 12,
                    "repeat": 6}], fh)
    journal = str(tmp_path / "j.jsonl")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cbf_tpu_torch", "serve", reqs,
         "--journal", journal, "--device", "cpu", "--max-batch", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if os.path.exists(journal) and os.path.getsize(journal) > 0:
            break
        if proc.poll() is not None:
            break
        time.sleep(0.02)
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=180)
    assert proc.returncode == 0, f"serve died rc={proc.returncode}: {err}"
    record = json.loads(out.strip().splitlines()[-1])
    assert record["requests"] == 6
    assert len(record["results"]) == 6
    assert dj.replay_journal(journal).unresolved == []


# -------------------------------------------- one format, two packages --

def _fields(cfg) -> dict:
    """A Config of either package as a plain field dict (dtype by
    name)."""
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(out["dtype"]).rsplit(".", 1)[-1].strip("'>")
    return out


def _half_served(engine, cfgs):
    """Serve two requests, then acknowledge two more and stop without a
    drain: the journal holds two resolved and two unresolved requests."""
    engine.run(cfgs[:2])
    engine.start()
    for cfg in cfgs[2:]:
        engine.submit(cfg)
    engine.stop(drain=False)
    engine.journal.close()


CROSS_FIELDS = [dict(n=8, steps=6, seed=1),
                dict(n=10, steps=8, seed=2, safety_distance=0.35),
                dict(n=12, steps=5, seed=3, consensus_gain=1.4),
                dict(n=16, steps=8, seed=4, dt=0.028, record_trajectory=True)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_folds_the_same_in_both_packages(writer, tmp_path):
    path = str(tmp_path / "j.jsonl")
    kw = dict(max_batch=4, bucket_sizes=(16,), horizon_quantum=8,
              flush_deadline_s=60.0, journal=path)
    if writer == "port":
        _half_served(ServeEngine(device="cpu", tracer=Tracer(enabled=False),
                                 **kw),
                     [swarm.Config(gating="jnp", **f) for f in CROSS_FIELDS])
    else:
        _half_served(JServeEngine(tracer=JTracer(enabled=False), **kw),
                     [jsw.Config(gating="jnp", **f) for f in CROSS_FIELDS])
    ours = dj.replay_journal(path)
    theirs = jj.replay_journal(path)
    assert [rid for rid, _ in ours.unresolved] == ["r2", "r3"]
    assert [rid for rid, _ in theirs.unresolved] == ["r2", "r3"]
    assert ours.resolved == theirs.resolved == {"r0", "r1"}
    ours_cfgs = ours.unresolved_configs()
    theirs_cfgs = theirs.unresolved_configs()
    for (rid_a, a), (rid_b, b), f in zip(ours_cfgs, theirs_cfgs,
                                         CROSS_FIELDS[2:]):
        assert rid_a == rid_b
        assert isinstance(a, swarm.Config) and isinstance(b, jsw.Config)
        assert _fields(a) == _fields(b)
        assert a == swarm.Config(gating="jnp", **f)
