"""The routed multi-engine cluster in the port (cbf_tpu_torch.cluster), on
the CPU.

The ports of tests/test_cluster.py:53-453 (16 tests): the placement
ring (deterministic and covering, minimal disruption, empty), the
claim-vs-steal race (exactly one rename wins), inbox order, cost-model
admission (priced over budget sheds before a file is written; unpriced
fails open; a duplicate in-flight id raises), the steal sweep (only
unclaimed files move; an unpriced bucket stays while a model is armed),
two real engines behind the router with stealing (workers as threads:
they share the program cache and ``_PROGRAM_LOCK``), a rolling restart
with zero loss, the failover that replays a dead engine's journal
exactly once and the one that stands down for a restarted worker, ``obs
top --merge`` and the README's cluster documentation. Where the port
departs from the JAX package (``cluster.worker``'s docstring): a claimed
file no journal acknowledged is re-routed by the failover and returned
to the inbox by a restarting worker, and a fenced worker answers
nothing. The end-to-end
test runs under the armed lock witness and asserts no inversion; the
witness's static-graph check (``check_subgraph``) comes with the
concurrency analyser of Queue A12 and is not asserted here.

Against the JAX package (cbf_tpu.cluster): ``HashRing.place`` equals
JAX's for 200 seeded labels over 1-5 engines, with one engine added and
one removed; the JAX package's minima behind ``chip_smoke.py`` phase
20c's ``CLUSTER_REFERENCE_DIPS``; a request file the port's router writes reads through
JAX's transport and rebuilds JAX's config, and the reverse; a cluster of
two workers serves 6 requests with results ``np.array_equal`` to one
engine's ``run()`` of the same requests, and ``cluster_census`` of the
cluster's root equals JAX's census of it.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from cbf_tpu.cluster import ClusterRouter as JClusterRouter
from cbf_tpu.cluster import HashRing as JHashRing
from cbf_tpu.cluster import cluster_census as jcluster_census
from cbf_tpu.cluster import transport as jtransport
from cbf_tpu.durable.rollout import config_from_json as jconfig_from_json
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.serve.buckets import bucket_key as jbucket_key
from cbf_tpu_torch import convert
from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.cluster import (ClusterRouter, EngineDirs, HashRing,
                                   Membership, Worker, cluster_census)
from cbf_tpu_torch.cluster import membership as cmembership
from cbf_tpu_torch.cluster import router as crouter
from cbf_tpu_torch.cluster import transport
from cbf_tpu_torch.cluster.worker import recovery_flock
from cbf_tpu_torch.durable.journal import RequestJournal, replay_journal
from cbf_tpu_torch.durable.rollout import config_from_json, config_to_json
from cbf_tpu_torch.obs import schema as obs_schema
from cbf_tpu_torch.obs.resource import CostModel
from cbf_tpu_torch.obs.trace import Tracer
from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.serve import ServeEngine
from cbf_tpu_torch.serve import ha as serve_ha
from cbf_tpu_torch.serve import resilience
from cbf_tpu_torch.serve.buckets import bucket_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(seed=1, n=8, steps=6):
    return swarm.Config(n=n, steps=steps, seed=seed, gating="jnp")


def _worker(root, name):
    return Worker(root, name, heartbeat_s=0.05, flush_deadline_s=0.01,
                  device="cpu").start()


def test_event_types_union_to_the_schema():
    assert crouter.EMITTED_EVENT_TYPES + cmembership.EMITTED_EVENT_TYPES \
        == obs_schema.CLUSTER_EVENT_TYPES


# ------------------------------------------------------------------ ring --

def test_ring_deterministic_and_covering():
    ring = HashRing(["e0", "e1", "e2"])
    labels = [f"n{2 ** k}-t64-double_integrator" for k in range(3, 12)]
    first = {lb: ring.place(lb) for lb in labels}
    assert first == {lb: ring.place(lb) for lb in labels}  # stable
    assert set(first.values()) <= {"e0", "e1", "e2"}
    # 9 distinct labels over 3 engines with 64 vnodes: every engine
    # should own something (covering, not a hash pile-up).
    assert len(set(first.values())) == 3


def test_ring_minimal_disruption():
    ring = HashRing(["e0", "e1", "e2"])
    labels = [f"n{i}-t128-double_integrator" for i in range(64)]
    before = {lb: ring.place(lb) for lb in labels}
    ring.remove("e1")
    after = {lb: ring.place(lb) for lb in labels}
    for lb in labels:
        if before[lb] != "e1":
            # Consistent hashing: only the dead engine's labels move.
            assert after[lb] == before[lb]
        else:
            assert after[lb] in ("e0", "e2")
    ring.add("e1")
    assert {lb: ring.place(lb) for lb in labels} == before


def test_ring_empty_raises():
    ring = HashRing([])
    assert len(ring) == 0
    with pytest.raises(RuntimeError):
        ring.place("n8-t64-double_integrator")


@pytest.mark.parametrize("engines", [1, 2, 3, 4, 5])
def test_ring_places_as_jax(engines):
    """200 seeded bucket labels land on the same engine in both
    packages, on the initial ring, after one engine joins and after one
    leaves."""
    rng = np.random.default_rng(engines)
    ns = 2 ** rng.integers(3, 16, 200)
    ts = 64 * rng.integers(1, 33, 200)
    dyn = rng.choice(["single_integrator", "double_integrator",
                      "unicycle"], 200)
    labels = [f"n{n}-t{t}-{d}" for n, t, d in zip(ns, ts, dyn)]
    names = [f"e{i}" for i in range(engines)]
    port, ref = HashRing(names), JHashRing(names)
    assert port.engines() == ref.engines()
    assert [port.place(lb) for lb in labels] == \
        [ref.place(lb) for lb in labels]
    for ring in (port, ref):
        ring.add(f"e{engines}")
    assert [port.place(lb) for lb in labels] == \
        [ref.place(lb) for lb in labels]
    for ring in (port, ref):
        ring.remove("e0")
    assert [port.place(lb) for lb in labels] == \
        [ref.place(lb) for lb in labels]


# ------------------------------------------------------------- transport --

def test_claim_vs_steal_exactly_one_wins(tmp_path):
    """The never-steal-acked invariant is the rename protocol: a claim
    and a steal race on the same inbox file and exactly one wins, every
    round."""
    a, b = EngineDirs(str(tmp_path), "a"), EngineDirs(str(tmp_path), "b")
    for seq in range(20):
        rid = f"r{seq}"
        path = transport.write_request(a, seq, rid, {"request_id": rid})
        results = {}
        barrier = threading.Barrier(2)

        def _claim():
            barrier.wait()
            results["claim"] = transport.claim(a, path)

        def _steal():
            barrier.wait()
            results["steal"] = transport.steal(a, b, path)

        ts = [threading.Thread(target=_claim),
              threading.Thread(target=_steal)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        winners = [k for k, v in results.items() if v is not None]
        assert len(winners) == 1, results
        assert transport.inbox_depth(a) == 0
        if winners == ["claim"]:
            assert transport.claimed_depth(a) == 1
            os.remove(results["claim"])
        else:
            assert transport.inbox_depth(b) == 1
            os.remove(results["steal"])


def test_inbox_order_is_submission_order(tmp_path):
    dirs = EngineDirs(str(tmp_path), "a")
    for seq in (3, 1, 2):
        transport.write_request(dirs, seq, f"r{seq}", {"request_id": seq})
    names = [os.path.basename(p) for p in transport.list_inbox(dirs)]
    assert names == sorted(names)
    assert [transport.read_json(p)["request_id"]
            for p in transport.list_inbox(dirs)] == [1, 2, 3]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_request_files_read_across_packages(tmp_path, writer):
    """One transport format: a request file either package's router
    deposits reads through the other's transport (same inbox name, same
    JSON) and rebuilds that package's config field for field."""
    fields = dict(n=12, steps=40, seed=3, safety_distance=0.41,
                  gating="pallas")
    jcfg = jsw.Config(**fields)
    tcfg = convert.config_from_fields(fields)
    if writer == "port":
        router = ClusterRouter(str(tmp_path), ["e0"])
        router.submit(tcfg, request_id="x1")
        (path,) = jtransport.list_inbox(jtransport.EngineDirs(
            str(tmp_path), "e0"))
        payload = jtransport.read_json(path)
        assert payload == transport.read_json(path)
        assert jconfig_from_json(jsw.Config, payload["config"]) == jcfg
    else:
        router = JClusterRouter(str(tmp_path), ["e0"])
        router.submit(jcfg, request_id="x1")
        (path,) = transport.list_inbox(EngineDirs(str(tmp_path), "e0"))
        payload = transport.read_json(path)
        assert payload == jtransport.read_json(path)
        assert config_from_json(swarm.Config, payload["config"]) == tcfg
    assert os.path.basename(path) == "000000000001_x1.json"
    assert payload["request_id"] == "x1"
    assert payload["bucket"] == bucket_key(tcfg)[0].label() == \
        jbucket_key(jcfg)[0].label()


# ------------------------------------------------------------- admission --

def _priced_model(per_agent_bytes: int) -> CostModel:
    cm = CostModel()
    cm._entry("n16-t64-double_integrator")["cost"] = {
        "peak_bytes": 16 * per_agent_bytes}
    return cm


def test_admission_sheds_priced_over_budget(tmp_path):
    cm = _priced_model(per_agent_bytes=1000)
    router = ClusterRouter(str(tmp_path), ["e0"], cost_model=cm,
                           budget_bytes=7_000)
    with pytest.raises(resilience.ShedError):
        router.submit(_cfg(n=8))           # predicted 8_000 > 7_000
    # Shed BEFORE a request file is written: nothing to un-route.
    assert transport.inbox_depth(router.dirs["e0"]) == 0
    assert router.routed == 0


def test_admission_fails_open_for_unpriced(tmp_path):
    router = ClusterRouter(str(tmp_path), ["e0"], cost_model=CostModel(),
                           budget_bytes=1)   # absurd budget, no prices
    p = router.submit(_cfg(n=8), request_id="open")
    assert p.request_id == "open"
    assert transport.inbox_depth(router.dirs["e0"]) == 1


def test_router_rejects_duplicate_inflight_id(tmp_path):
    router = ClusterRouter(str(tmp_path), ["e0"])
    router.submit(_cfg(seed=1), request_id="dup")
    with pytest.raises(resilience.ServeError):
        router.submit(_cfg(seed=2), request_id="dup")


# --------------------------------------------------------- steal sweep --

def test_steal_sweep_moves_unclaimed_only(tmp_path):
    router = ClusterRouter(str(tmp_path), ["e0", "e1"], steal=True,
                           steal_threshold=2)
    hot = router.ring.place(bucket_key(_cfg())[0].label())
    cold = "e1" if hot == "e0" else "e0"
    pendings = [router.submit(_cfg(seed=s)) for s in range(4)]
    assert transport.inbox_depth(router.dirs[hot]) == 4
    # Claim the oldest file — from here it is acked territory and the
    # sweep must not be able to see it.
    claimed = transport.claim(router.dirs[hot],
                              transport.list_inbox(router.dirs[hot])[0])
    assert claimed is not None
    router.poll_once()
    # One idle engine -> exactly one file stolen; the claim untouched.
    assert router.stolen == 1
    assert transport.inbox_depth(router.dirs[cold]) == 1
    assert transport.claimed_depth(router.dirs[hot]) == 1
    assert transport.inbox_depth(router.dirs[hot]) == 2
    stolen_rid = transport.read_json(
        transport.list_inbox(router.dirs[cold])[0])["request_id"]
    assert stolen_rid in router.routes_on(cold)
    assert len(pendings) == 4


def test_steal_skips_unpriced_bucket_when_model_armed(tmp_path):
    cm = CostModel()                 # armed, but nothing priced yet
    router = ClusterRouter(str(tmp_path), ["e0", "e1"], steal=True,
                           steal_threshold=2, cost_model=cm,
                           budget_bytes=10 ** 12)
    for s in range(3):
        router.submit(_cfg(seed=s))
    hot = next(e for e in ("e0", "e1")
               if transport.inbox_depth(router.dirs[e]))
    assert transport.inbox_depth(router.dirs[hot]) == 3
    router.poll_once()
    # Unpriced bucket: stealing it onto a cold engine would recreate
    # the hotspot as a blind capture — the sweep leaves it.
    assert router.stolen == 0
    assert transport.inbox_depth(router.dirs[hot]) == 3
    # One measured peak prices every shape (worst per-agent scaling):
    # the same sweep now relocates.
    cm._entry("n16-t64-double_integrator")["cost"] = {"peak_bytes": 160}
    router.poll_once()
    assert router.stolen == 1


# ------------------------------------------------- end-to-end in-process --

def test_cluster_end_to_end_with_stealing(tmp_path):
    """M=2 real engines behind the router (workers as threads): one hot
    bucket fans out over both engines through the steal sweep, every
    handle resolves, and the census is exactly-once — all under the
    ARMED lock witness (no inversion; the static-graph check waits for
    Queue A12's analyser)."""
    root = str(tmp_path)
    lockwitness.arm()
    lockwitness.reset()
    workers = []
    router = ClusterRouter(root, ["e0", "e1"], steal=True,
                           steal_threshold=2, poll_s=0.005)
    try:
        for name in ("e0", "e1"):
            workers.append(_worker(root, name))
        router.start()
        pendings = [router.submit(_cfg(seed=s)) for s in range(6)]
        results = [p.result(timeout=180) for p in pendings]
        assert [r.request_id for r in results] == \
            [p.request_id for p in pendings]
        for r in results:
            assert r.bucket.startswith("n16-")   # n=8 pads to n16
            assert r.latency_s > 0 and r.engine in ("e0", "e1")
        # The hot bucket was spread: both engines served some of it.
        assert {r.engine for r in results} == {"e0", "e1"}
        assert router.stolen >= 1
        router.stop(drain=True)
        for w in workers:
            w.stop()
        census = cluster_census(root)
        assert census["ok"], census
        assert census["submitted"] == 6 and census["resolved"] == 6
        assert lockwitness.inversions() == []
    finally:
        lockwitness.disarm()
        lockwitness.reset()
        router.stop(drain=False)
        for w in workers:
            w.stop()


# Six requests over two buckets (n16 and n32): two engines and one
# engine must return the same results, bit for bit.
SINGLE_FIELDS = [dict(n=10, steps=12, seed=1, safety_distance=0.42),
                 dict(n=20, steps=16, seed=6),
                 dict(n=16, steps=16, seed=2, dt=0.028),
                 dict(n=32, steps=14, seed=7, consensus_gain=1.3),
                 dict(n=12, steps=9, seed=3, sep_gain=0.5),
                 dict(n=25, steps=10, seed=8, dt=0.03)]


def test_cluster_results_equal_one_engine(tmp_path):
    """Two workers behind the router return, for 6 requests over two
    buckets, exactly what one engine's ``run()`` returns for them; the
    cluster's census is exactly-once and equals JAX's census of the same
    root."""
    cfgs = [swarm.Config(spawn_half_width_override=0.9, **f)
            for f in SINGLE_FIELDS]
    single = ServeEngine(max_batch=4, bucket_sizes=(16, 32),
                         tracer=Tracer(enabled=False), device="cpu").run(
        cfgs)
    root = str(tmp_path)
    router = ClusterRouter(root, ["e0", "e1"], bucket_sizes=(16, 32),
                           poll_s=0.005)
    workers = []
    try:
        for name in ("e0", "e1"):
            workers.append(Worker(
                root, name, max_batch=4, heartbeat_s=0.05,
                flush_deadline_s=0.01, device="cpu",
                engine_kw={"bucket_sizes": (16, 32)}).start())
        router.start()
        results = [p.result(timeout=180)
                   for p in [router.submit(c) for c in cfgs]]
    finally:
        router.stop(drain=False)
        for w in workers:
            w.stop()
    assert [(r.bucket, r.n, r.steps) for r in results] == \
        [(s.bucket, s.n, s.steps) for s in single]
    assert np.array_equal(
        [r.outputs.min_pairwise_distance for r in results],
        [float(np.min(s.outputs.min_pairwise_distance)) for s in single])
    assert np.array_equal(
        [r.outputs.infeasible_count for r in results],
        [int(np.sum(s.outputs.infeasible_count)) for s in single])
    census = cluster_census(root)
    assert census["ok"] and census["submitted"] == 6
    assert census == jcluster_census(root)


def test_rolling_restart_zero_loss(tmp_path):
    """Drain-then-restart both engines one at a time while handles are
    outstanding: every pre-roll and post-roll request resolves, every
    engine comes back at a later epoch, census exactly-once."""
    root = str(tmp_path)
    workers = {}
    router = ClusterRouter(root, ["e0", "e1"], poll_s=0.005)

    def respawn(name):
        old = workers.pop(name, None)
        if old is not None:
            old.stop()
        workers[name] = _worker(root, name)

    membership = Membership(router, ttl_s=30.0, respawn=respawn,
                            ready_timeout_s=120.0)
    try:
        for name in ("e0", "e1"):
            respawn(name)
        router.start()
        before = [router.submit(_cfg(seed=s)) for s in range(2)]
        reports = membership.rolling_restart(["e0", "e1"],
                                             drain_timeout_s=180.0)
        assert [r["engine"] for r in reports] == ["e0", "e1"]
        assert all(r["restart_s"] > 0 for r in reports)
        for name in ("e0", "e1"):
            assert name in router.ring
            assert workers[name].epoch >= 2   # restarted at a new epoch
        after = [router.submit(_cfg(seed=10 + s)) for s in range(2)]
        for p in before + after:
            p.result(timeout=180)
        router.stop(drain=True)
        for w in workers.values():
            w.stop()
        census = cluster_census(root)
        assert census["ok"], census
        assert census["submitted"] == 4
    finally:
        router.stop(drain=False)
        for w in workers.values():
            w.stop()


# ---------------------------------------------------------- failover --

def test_failover_replays_journal_exactly_once(tmp_path):
    """Synthetic dead engine: its journal holds one acknowledged-but-
    unresolved request and one durably-resolved one. Failover re-homes
    the first onto the survivor (same id, same handle) and synthesizes
    the second (re-running it would be a duplicate execution)."""
    root = str(tmp_path)
    router = ClusterRouter(root, ["e0", "e1"])
    p1 = router.submit(_cfg(seed=1), request_id="r1")
    p2 = router.submit(_cfg(seed=2), request_id="r2")
    # Pretend e0's worker claimed both before dying: inbox empty, the
    # acks in its WAL.
    for e in ("e0", "e1"):
        for path in transport.list_inbox(router.dirs[e]):
            os.remove(path)
    dead = router.dirs["e0"]
    lease = serve_ha.Lease(dead.lease, owner="e0")
    epoch = lease.acquire()
    j = RequestJournal(dead.journal, epoch=epoch, fence_path=dead.lease)
    j.submitted("r1", _cfg(seed=1))
    j.submitted("r2", _cfg(seed=2))
    j.resolved("r2")
    j.close()

    membership = Membership(router, ttl_s=0.2, poll_s=0.01)
    assert membership.poll() == []         # first observation
    time.sleep(0.35)                       # no heartbeat -> expiry
    assert membership.poll() == ["e0"]
    assert membership.failovers == 1 and len(membership.mttr_s) == 1

    # r2: durably resolved -> synthesized, never re-run.
    assert p2.done()
    assert p2.result(timeout=0).outputs.min_pairwise_distance == \
        float("inf")
    # r1: acknowledged, unresolved -> re-deposited on the survivor
    # under the SAME id; the original handle is still the live one.
    assert not p1.done()
    assert "e0" not in router.ring
    (refile,) = transport.list_inbox(router.dirs["e1"])
    assert transport.read_json(refile)["request_id"] == "r1"
    assert router.routes_on("e1") == ["r1"]
    # The dead epoch's journal is archived (a later boot starts clean)
    # but the census still folds it: r1 is lost until a survivor
    # resolves it, then the cluster is exactly-once again.
    assert not os.path.exists(dead.journal)
    archived = os.path.join(dead.base, f"archived-e{epoch}.journal.wal")
    assert os.path.exists(archived)
    assert cluster_census(root)["lost"] == ["r1"]
    surv_lease = serve_ha.Lease(router.dirs["e1"].lease, owner="e1")
    sj = RequestJournal(router.dirs["e1"].journal,
                        epoch=surv_lease.acquire(),
                        fence_path=router.dirs["e1"].lease)
    sj.submitted("r1", _cfg(seed=1))
    sj.resolved("r1")
    sj.close()
    census = cluster_census(root)
    assert census["ok"], census
    assert census["submitted"] == 2 and census["resolved"] == 2
    assert census == jcluster_census(root)


def test_failover_stands_down_when_restarted_worker_wins(tmp_path):
    """While the membership plane waits on the recovery flock, a
    restarted worker bumps the lease epoch — the failover must stand
    down and re-enroll instead of stealing the journal from a live
    owner."""
    root = str(tmp_path)
    router = ClusterRouter(root, ["e0", "e1"])
    dead = router.dirs["e0"]
    serve_ha.Lease(dead.lease, owner="e0").acquire()     # epoch 1
    j = RequestJournal(dead.journal, epoch=1, fence_path=dead.lease)
    j.submitted("r1", _cfg(seed=1))
    j.close()
    membership = Membership(router, ttl_s=0.1, poll_s=0.01)

    flock_held = threading.Event()

    def _restarting_worker():
        with recovery_flock(dead):
            flock_held.set()
            time.sleep(0.4)      # let failover block on the flock
            serve_ha.Lease(dead.lease, owner="e0-restart").acquire()

    t = threading.Thread(target=_restarting_worker)
    t.start()
    flock_held.wait(5.0)
    report = membership.failover("e0")
    t.join()
    assert report["state"] == "up" and report["epoch"] == 2
    assert "e0" in router.ring              # re-enrolled, not evicted
    assert membership.failovers == 0        # no failover happened
    # The journal was NOT archived: the restarted worker owns it.
    assert os.path.exists(dead.journal)
    assert replay_journal(dead.journal).unresolved[0][0] == "r1"


def _claimed_request(dirs, seq, rid, cfg):
    """A request file as the router deposits it, claimed by ``dirs``'s
    worker (the claim rename happened; the acknowledgment may not)."""
    path = transport.write_request(dirs, seq, rid, {
        "request_id": rid, "config": config_to_json(cfg),
        "bucket": bucket_key(cfg)[0].label()})
    return transport.claim(dirs, path)


def test_failover_rehomes_claimed_but_unacknowledged(tmp_path):
    """The port's departure from the JAX package: a worker SIGKILLed
    between its claim rename and its ``submitted`` fsync leaves a claimed
    file no journal acknowledges. After the epoch bump the failover
    re-routes it onto the survivor under its id (the handle stays live),
    and removes the claimed file of the acknowledged request the replay
    re-homes — the dead engine's ``claimed/`` ends empty."""
    root = str(tmp_path)
    router = ClusterRouter(root, ["e0", "e1"])
    p1 = router.submit(_cfg(seed=1), request_id="r1")
    p2 = router.submit(_cfg(seed=2), request_id="r2")
    for e in ("e0", "e1"):
        for path in transport.list_inbox(router.dirs[e]):
            os.remove(path)
    dead = router.dirs["e0"]
    for seq, rid, seed in ((1, "r1", 1), (2, "r2", 2)):
        assert _claimed_request(dead, seq, rid, _cfg(seed=seed))
    epoch = serve_ha.Lease(dead.lease, owner="e0").acquire()
    j = RequestJournal(dead.journal, epoch=epoch, fence_path=dead.lease)
    j.submitted("r1", _cfg(seed=1))          # r2 was never acknowledged
    j.close()
    membership = Membership(router, ttl_s=0.2, poll_s=0.01)
    membership.poll()
    time.sleep(0.35)
    report = membership.failover("e0")
    assert report["state"] == "failover" and report["reclaimed"] == 1
    assert report["reenqueued"] == 1
    assert transport.claimed_depth(dead) == 0
    inbox = [transport.read_json(p)["request_id"]
             for p in transport.list_inbox(router.dirs["e1"])]
    assert sorted(inbox) == ["r1", "r2"]
    assert sorted(router.routes_on("e1")) == ["r1", "r2"]
    assert not p1.done() and not p2.done()


def test_worker_boot_settles_its_claims(tmp_path):
    """The same departure at a worker's own restart: under the recovery
    flock after its epoch bump, the booting worker returns the
    unacknowledged claim to its inbox (and serves it), re-runs the
    acknowledged unresolved one, removes the resolved one's claim, and
    ends with an empty ``claimed/`` and an exactly-once census."""
    root = str(tmp_path)
    dirs = EngineDirs(root, "e0")
    for seq, rid in enumerate(("r1", "r2", "r3"), start=1):
        assert _claimed_request(dirs, seq, rid, _cfg(seed=seq))
    epoch = serve_ha.Lease(dirs.lease, owner="e0").acquire()
    j = RequestJournal(dirs.journal, epoch=epoch, fence_path=dirs.lease)
    j.submitted("r1", _cfg(seed=1))
    j.submitted("r3", _cfg(seed=3))
    j.resolved("r3")
    j.close()
    w = _worker(root, "e0")
    try:
        deadline = time.monotonic() + 120
        while len(transport.list_outbox(dirs)) < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        w.stop()
    answered = sorted(transport.read_json(p)["request_id"]
                      for p in transport.list_outbox(dirs))
    assert answered == ["r1", "r2"] and w.recovered == 1
    assert transport.claimed_depth(dirs) == 0
    assert transport.inbox_depth(dirs) == 0
    census = cluster_census(root)
    assert census["ok"] and census["submitted"] == 3, census


def test_fenced_worker_answers_nothing(tmp_path):
    """A worker whose lease a newer epoch took refuses the next
    acknowledgment with ``FencedError`` and writes no response for it
    (the new owner settles the claimed file), then exits fenced (4)."""
    root = str(tmp_path)
    w = Worker(root, "e0", heartbeat_s=30.0, device="cpu")
    w.boot()
    try:
        dirs = w.dirs
        serve_ha.Lease(dirs.lease, owner="new-owner").acquire()
        transport.write_request(dirs, 1, "r1", {
            "request_id": "r1", "config": config_to_json(_cfg()),
            "bucket": bucket_key(_cfg())[0].label()})
        assert w._claim_one() is False
        assert isinstance(w.fenced(), resilience.FencedError)
        assert transport.list_outbox(dirs) == []
        assert transport.claimed_depth(dirs) == 1
    finally:
        rc = w.run_loop()      # exits at once: fenced; stops engine, beats
    assert rc == serve_ha.EXIT_FENCED


@pytest.mark.slow   # ~25 s: 24 requests through the JAX package's engine
def test_chip_smoke_cluster_dips_are_the_references():
    """``chip_smoke.py`` phase 20c holds two of its 24 requests to the
    reference's own minimum instead of the floor: the JAX package's drain
    engine on the CPU (gating "jnp") dips below the floor on exactly
    those, to ``CLUSTER_REFERENCE_DIPS``, and holds every other request
    above it with 0 infeasible."""
    import chip_smoke
    from cbf_tpu.serve import ServeEngine as JServeEngine

    cfgs = [jsw.Config(n=e["overrides"]["n"], steps=e["steps"],
                       seed=e["seed"], gating="jnp")
            for e in chip_smoke.cluster_requests()]
    assert len(cfgs) == chip_smoke.CLUSTER_REQUESTS
    res = JServeEngine(max_batch=8).run(cfgs)
    mins = [float(np.min(r.outputs.min_pairwise_distance)) for r in res]
    assert all(int(np.sum(r.outputs.infeasible_count)) == 0 for r in res)
    dips = {i: round(m, 8) for i, m in enumerate(mins)
            if m < chip_smoke.FLOOR}
    assert dips == chip_smoke.CLUSTER_REFERENCE_DIPS


# ------------------------------------------------------------ obs merge --

def test_obs_top_merge_sums_and_judges_stall_per_dir(tmp_path):
    from cbf_tpu_torch.__main__ import main as cli_main
    from cbf_tpu_torch.obs.sink import MetricsRegistry

    def write_dir(name, count):
        d = tmp_path / name
        d.mkdir()
        reg = MetricsRegistry()
        reg.counter("serve.requests").add(count)
        (d / "metrics.json").write_text(json.dumps(
            {"metrics": reg.snapshot()}))
        return str(d)

    d1, d2 = write_dir("m0", 3), write_dir("m1", 5)
    rc = cli_main(["obs", "top", "--merge", d1, d2])
    assert rc == 0
    merged = MetricsRegistry()
    for d in (d1, d2):
        with open(os.path.join(d, "metrics.json")) as fh:
            merged.merge(json.load(fh)["metrics"])
    assert merged.snapshot()["serve.requests"]["total"] == 8.0
    # Stall is judged per dir: age one file past the timeout -> exit 3.
    old = time.time() - 60
    os.utime(os.path.join(d1, "metrics.json"), (old, old))
    assert cli_main(["obs", "top", "--merge", d1, d2,
                     "--stall-timeout", "5"]) == 3
    assert cli_main(["obs", "top", "--glob",
                     str(tmp_path / "nothing-*")]) == 2


# ----------------------------------------------------------------- docs --

def test_cluster_documented():
    """The README's port section documents the cluster (the JAX test
    reads docs/API.md, which documents the JAX package)."""
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as fh:
        readme = fh.read()
    port = readme[readme.index("## PyTorch/CUDA port"):]
    port = port[:port.index("\n## ", 1)]
    for needle in ("HashRing", "ClusterRouter", "Membership",
                   "cluster_census", "never-steal-acked",
                   "python -m cbf_tpu_torch cluster serve",
                   "python -m cbf_tpu_torch cluster worker",
                   "cluster.route", "cluster.steal", "cluster.member",
                   "cluster.roll", "recovery.lock", "rolling restart",
                   "CBF_TPU_CACHE_DIR", "obs top --merge",
                   "--stall-timeout"):
        assert needle in port, f"README port section missing {needle!r}"
