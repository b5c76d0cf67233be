"""The port's concurrency analyser and lock-order witness
(cbf_tpu_torch/analysis/concurrency.py, lockwitness.py), held to the JAX
package's on the CPU.

- Each CC rule fires on its known-bad fixture (tests/analysis_fixtures/
  bad_cc*.py, JAX's) and is silent on the clean one, and on all 16
  fixtures the port's analyser gives JAX's findings — equal
  (rule, line, col, symbol) sets — and JAX's acquisition-order edges.
- What the port changed: torch's device waits block (CC003), and a
  module-level lock held in a method (``_PROGRAM_LOCK``) is a lock of the
  graph; the repo's inventory and lock graph (ServeEngine, the journal,
  ``serve.engine._PROGRAM_LOCK``, the checkpoint writer's lock), and the
  two CC001 races the analyser found in the port, fixed.
- Baseline round trip, staleness judged only by the pass that ran, the
  JSON's ``lock_order_graph`` only with the concurrency pass.
- The runtime witness (tests/test_concurrency.py's, on the port's):
  factories plain when disarmed and witness wrappers when armed, edges,
  inversions, ``check_subgraph`` accepting the transitive closure and
  flagging an unexplained edge, conditions and events across threads.
"""

import json
import os
import threading
import time

import pytest
import torch

from cbf_tpu.analysis import concurrency as jconc
from cbf_tpu_torch.analysis import baseline, concurrency, lockwitness
from cbf_tpu_torch.analysis.report import render_json, render_text, run_lint

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURES = os.path.join(_ROOT, "tests", "analysis_fixtures")
_CC_RULES = ["CC001", "CC002", "CC003", "CC004",
             "CC005", "CC006", "CC007", "CC008"]
_CC_FIXTURES = sorted(n for n in os.listdir(_FIXTURES)
                      if n.endswith(".py") and "_cc" in n)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _analyze_fixture(name: str, module=concurrency):
    with open(os.path.join(_FIXTURES, name)) as fh:
        return module.analyze_source(fh.read(), name)


@pytest.fixture(scope="module")
def repo_result():
    return concurrency.analyze_paths(
        [os.path.join(_ROOT, "cbf_tpu_torch")], repo_root=_ROOT)


# -- CC rules: one bad + one clean fixture each, JAX's ----------------------

@pytest.mark.parametrize("rule", _CC_RULES)
def test_cc_rule_fires_on_bad_fixture(rule):
    res = _analyze_fixture(f"bad_{rule.lower()}.py")
    assert rule in {f.rule for f in res.findings}, res.findings


@pytest.mark.parametrize("rule", _CC_RULES)
def test_cc_rule_silent_on_clean_fixture(rule):
    assert _analyze_fixture(f"clean_{rule.lower()}.py").findings == []


def test_cc_fixture_corpus_is_sixteen():
    assert len(_CC_FIXTURES) == 16


@pytest.mark.parametrize("name", _CC_FIXTURES)
def test_cc_parity_with_jax(name):
    """The port's analyser and JAX's give equal (rule, line, col, symbol)
    sets and equal edges on the same fixture."""
    ours, theirs = _analyze_fixture(name), _analyze_fixture(name, jconc)

    def key(res):
        return {(f.rule, f.line, f.col, f.symbol) for f in res.findings}

    assert key(ours) == key(theirs)
    assert [f.message for f in ours.findings] == \
        [f.message for f in theirs.findings]
    assert concurrency.static_edge_set(ours) == \
        jconc.static_edge_set(theirs)


# -- graph + inventory ----------------------------------------------------------

def test_bad_cc002_books_both_edge_directions():
    res = _analyze_fixture("bad_cc002.py")
    got = {(e.src, e.dst) for e in res.edges}
    assert got == {("Pair._a", "Pair._b"), ("Pair._b", "Pair._a")}
    assert concurrency.static_edge_set(res) == got


def test_clean_cc002_books_one_edge_direction():
    res = _analyze_fixture("clean_cc002.py")
    assert {(e.src, e.dst) for e in res.edges} == {("Pair._a", "Pair._b")}


def test_torch_device_waits_block_under_a_lock():
    """CC003's device waits are torch's: torch.cuda.synchronize and
    Event/Stream.synchronize under a held lock."""
    src = '''
import threading

import torch


class Runner:
    def __init__(self):
        self._lock = threading.Lock()
        self._event = torch.cuda.Event()

    def drain(self):
        with self._lock:
            torch.cuda.synchronize()

    def wait(self):
        with self._lock:
            self._event.synchronize()

    def fine(self):
        torch.cuda.synchronize()
        with self._lock:
            return 1
'''
    found = concurrency.analyze_source(src, "runner.py").findings
    assert sorted((f.rule, f.symbol) for f in found) == [
        ("CC003", "Runner.drain"), ("CC003", "Runner.wait")], found
    assert "torch.cuda.synchronize" in found[0].message + found[1].message


def test_module_lock_in_methods_is_a_graph_node():
    """A module-level lock held in a method is a lock like self._lock,
    named as its witness names it: its nested acquisitions are edges and
    blocking calls under it are CC003."""
    src = '''
import os

from cbf_tpu_torch.analysis import lockwitness

_GLOBAL = lockwitness.make_lock("mod._GLOBAL")


class Engine:
    def __init__(self):
        self._lock = lockwitness.make_lock("Engine._lock")

    def run(self):
        with _GLOBAL:
            with self._lock:
                pass

    def save(self, fd):
        with _GLOBAL:
            os.fsync(fd)
'''
    res = concurrency.analyze_source(src, "mod.py")
    assert concurrency.static_edge_set(res) == {("mod._GLOBAL",
                                                 "Engine._lock")}
    assert [(f.rule, f.symbol) for f in res.findings] == [
        ("CC003", "Engine.save")]
    assert res.inventory["mod"]["locks"] == ["_GLOBAL"]


def test_repo_inventory_names_the_threaded_stack(repo_result):
    inv = repo_result.inventory
    eng = inv["ServeEngine"]
    assert "_lock" in eng["locks"]
    assert eng["conditions"].get("_cond") == "_lock"
    assert any(t["entry"] == "_scheduler_loop" for t in eng["threads"])
    assert "_lock" in inv["RequestJournal"]["locks"]
    assert "_lock" in inv["TelemetrySink"]["locks"]
    assert inv["serve.engine"]["locks"] == ["_PROGRAM_LOCK"]
    assert inv["CheckpointWriter"]["locks"] == ["_lock"]


def test_repo_lock_graph_is_acyclic_with_expected_edges(repo_result):
    edges = concurrency.static_edge_set(repo_result)
    assert ("ServeEngine._lock", "RequestJournal._lock") in edges
    assert ("serve.engine._PROGRAM_LOCK", "ServeEngine._stats_lock") in edges
    # Journal appends and resolves run outside the program lock.
    assert ("serve.engine._PROGRAM_LOCK", "RequestJournal._lock") \
        not in edges
    assert not any(f.rule == "CC002" for f in repo_result.findings)


def test_port_cc001_races_fixed(repo_result):
    """The analyser found two unlocked cross-thread writes in the port:
    CheckpointWriter._error (the writer thread's store against the
    caller's take) and Worker._fenced; both now write under the class
    lock."""
    bad = {f.symbol for f in repo_result.findings if f.rule == "CC001"}
    assert not bad & {"CheckpointWriter._error", "Worker._fenced"}


def test_checkpoint_writer_error_surfaces_once(tmp_path, monkeypatch):
    """The locked handover keeps the contract: a failed write raises at
    the next call, once."""
    from cbf_tpu_torch.utils import checkpoint

    def boom(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(checkpoint, "_write_step", boom)
    w = checkpoint.CheckpointWriter(str(tmp_path))
    w.save(1, (torch.zeros(2),))
    with pytest.raises(OSError, match="disk gone"):
        w.wait_until_finished()
    w.wait_until_finished()
    w.close()


# -- baseline round trip ----------------------------------------------------------

def test_cc_baseline_roundtrip(tmp_path):
    target = os.path.join(_FIXTURES, "bad_cc001.py")
    empty = str(tmp_path / "none.toml")
    res = run_lint([target], repo_root=_ROOT, concurrency=True,
                   baseline_path=empty)
    assert any(f.rule == "CC001" for f in res.active)
    sups = [baseline.Suppression(f.rule, f.path, f.symbol,
                                 "fixture: known-bad by construction")
            for f in res.active]
    bpath = str(tmp_path / "baseline.toml")
    baseline.write(bpath, sups)
    res = run_lint([target], repo_root=_ROOT, baseline_path=bpath,
                   concurrency=True)
    assert res.exit_code == 0 and res.active == []
    assert "CC001" in render_text(res, show_suppressed=True)


def test_cc_suppression_not_stale_when_pass_skipped(tmp_path):
    bpath = str(tmp_path / "baseline.toml")
    baseline.write(bpath, [baseline.Suppression(
        "CC003", "cbf_tpu_torch/durable/journal.py",
        "RequestJournal._append", "WAL contract")])
    target = os.path.join(_FIXTURES, "clean_cc001.py")
    res = run_lint([target], repo_root=_ROOT, baseline_path=bpath)
    assert res.exit_code == 0 and res.stale == []
    res = run_lint([target], repo_root=_ROOT, baseline_path=bpath,
                   concurrency=True)
    assert res.exit_code == 1 and len(res.stale) == 1


def test_lock_order_graph_in_json_only_with_concurrency(tmp_path):
    target = os.path.join(_FIXTURES, "clean_cc002.py")
    empty = str(tmp_path / "none.toml")
    plain = json.loads(render_json(run_lint([target], repo_root=_ROOT,
                                            baseline_path=empty)))
    assert "lock_order_graph" not in plain
    conc = json.loads(render_json(run_lint(
        [target], repo_root=_ROOT, concurrency=True, baseline_path=empty)))
    assert {(e["src"], e["dst"]) for e in conc["lock_order_graph"]} == {
        ("Pair._a", "Pair._b")}


# -- runtime witness ------------------------------------------------------------

@pytest.fixture
def armed():
    lockwitness.arm()
    lockwitness.reset()
    try:
        yield
    finally:
        lockwitness.disarm()
        lockwitness.reset()


def test_factories_return_plain_primitives_when_disarmed():
    assert not lockwitness.is_armed()
    assert type(lockwitness.make_lock("X._lock")) is type(threading.Lock())
    assert isinstance(lockwitness.make_event("X._ev"), threading.Event)
    assert isinstance(lockwitness.make_condition("X._cond"),
                      threading.Condition)


def test_factories_return_witness_wrappers_when_armed(armed):
    lk = lockwitness.make_lock("X._lock")
    assert isinstance(lk, lockwitness.WitnessLock)
    assert isinstance(lockwitness.make_event("X._ev"),
                      lockwitness.WitnessEvent)
    cond = lockwitness.make_condition("X._cond", lk)
    assert isinstance(cond, lockwitness.WitnessCondition)
    assert cond.name == "X._lock"


def test_nested_acquire_books_edge_and_reset_clears(armed):
    a = lockwitness.make_lock("A._lock")
    b = lockwitness.make_lock("B._lock")
    with a:
        with b:
            pass
    assert lockwitness.observed_edges() == {("A._lock", "B._lock")}
    snap = lockwitness.snapshot()
    assert snap["armed"] and snap["acquisitions"] == 2
    lockwitness.reset()
    assert lockwitness.observed_edges() == set()
    assert lockwitness.snapshot()["acquisitions"] == 0


def test_inversions_detects_opposite_orders(armed):
    a = lockwitness.make_lock("A._lock")
    b = lockwitness.make_lock("B._lock")
    with a:
        with b:
            pass
    assert lockwitness.inversions() == []
    with b:
        with a:
            pass
    assert lockwitness.inversions() == [("A._lock", "B._lock")]


def test_check_subgraph_accepts_transitive_closure(armed):
    a = lockwitness.make_lock("A._lock")
    c = lockwitness.make_lock("C._lock")
    with a:
        with c:             # observed A->C directly
            pass
    static = {("A._lock", "B._lock"), ("B._lock", "C._lock")}
    assert lockwitness.check_subgraph(static) == []


def test_check_subgraph_flags_unexplained_edge(armed):
    a = lockwitness.make_lock("A._lock")
    d = lockwitness.make_lock("D._lock")
    with a:
        with d:
            pass
    problems = lockwitness.check_subgraph({("A._lock", "B._lock")})
    assert len(problems) == 1
    assert "A._lock -> D._lock" in problems[0]


def test_witness_condition_wait_notify_across_threads(armed):
    lk = lockwitness.make_lock("Q._lock")
    cond = lockwitness.make_condition("Q._cond", lk)
    items = []

    def consumer():
        with cond:
            while not items:
                cond.wait(timeout=5.0)

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.02)
    with cond:
        items.append(1)
        cond.notify()
    t.join(timeout=5.0)
    assert not t.is_alive()


def test_witness_condition_wait_for(armed):
    lk = lockwitness.make_lock("Q._lock")
    cond = lockwitness.make_condition("Q._cond", lk)
    flag = []

    def setter():
        time.sleep(0.02)
        with cond:
            flag.append(1)
            cond.notify()

    t = threading.Thread(target=setter)
    t.start()
    with cond:
        assert cond.wait_for(lambda: bool(flag), timeout=5.0)
    t.join(timeout=5.0)
    with cond:
        assert not cond.wait_for(lambda: False, timeout=0.01)


def test_wait_with_other_lock_held_books_blocking_event(armed):
    outer = lockwitness.make_lock("Outer._lock")
    lk = lockwitness.make_lock("Inner._lock")
    cond = lockwitness.make_condition("Inner._cond", lk)
    with outer:
        with cond:
            cond.wait(timeout=0.01)
    snap = lockwitness.snapshot()
    assert any(b["kind"] == "cond_wait" and "Outer._lock" in b["held"]
               for b in snap["blocking"])
    assert ("Outer._lock", "Inner._lock") in lockwitness.observed_edges()


def test_witness_event_wait_books_blocking_when_lock_held(armed):
    lk = lockwitness.make_lock("E._lock")
    ev = lockwitness.make_event("E._ev")
    with lk:
        ev.wait(timeout=0.01)
    snap = lockwitness.snapshot()
    assert any(b["kind"] == "event_wait" and b["name"] == "E._ev"
               for b in snap["blocking"])
    ev.set()
    assert ev.is_set() and ev.wait(timeout=0.01)
