"""The port's falsification fleet (cbf_tpu_torch/verify/fleet.py) and the
serve engine's background tenant, held to the JAX package's on the CPU.

- tests/test_fleet.py on the port at its sizes (one shared n=4, t=6,
  batch 2, ``gating="jnp"`` target): ``mutate_batch`` deterministic, its
  seedless bootstrap and its seed pool; ``allocate_budget``; settings
  validation (a dp mesh now rounds the batch up, as JAX's does;
  it raised before the dp mesh was ported); ``near_miss_entry``; resume
  bit-exact with the fingerprint
  naming the drifted field; dropped units cost nothing; the round events
  against the schema; background work shed first; the tenant yielding to
  a foreground arrival; the campaign as a background tenant ending equal
  to the standalone run; ``--set`` over the dedicated CLI flags; the
  README's port section covering the surface.
- Parity: ``mutate_batch`` against JAX's for the same key, with and
  without seeds — float64 (JAX under ``jax_enable_x64``) bit for bit;
  float32 with the operator ids, seed picks and masks exact and the
  values within FLOAT32_ULPS (float32 normals differ from JAX's by a few
  ulps, tests/test_torch_prng.py). A tiny campaign's ``FleetResult`` and
  ``fleet.round`` payloads equal JAX's in float64 and float32, with the
  fingerprint fields dict-equal to JAX's; the default target set's
  fingerprint fields equal JAX's too.
- ``serve.engine._PROGRAM_LOCK`` is held around every tenant unit, with
  the lock witness armed and no inversion.

The slow ends (the CLI SIGKILLed after its first round save and resumed,
the weakened-dmin detection) are ``slow``, as in the JAX package. Every
engine a test starts is stopped in ``finally``; every test that enrolls
generated scenarios runs under the ``registries`` fixture.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.verify import fleet as jfleet
from cbf_tpu.verify import search as jsearch
from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.core.filter import CBFParams
from cbf_tpu_torch.obs import schema
from cbf_tpu_torch.obs.trace import Tracer
from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.serve import FaultPolicy, ServeEngine, ShedError
from cbf_tpu_torch.serve import engine as serve_engine
from cbf_tpu_torch.utils import faults, prng
from cbf_tpu_torch.verify import corpus, search
from cbf_tpu_torch.verify import fleet as vfleet
from cbf_tpu_torch.verify.properties import PROPERTY_NAMES
from test_torch_platform import registries  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 candidates: the noise is prng.normal's, within 4 ulps of JAX's
# float32 normals (tests/test_torch_prng.py); a jitter adds a seed to it.
FLOAT32_ULPS = 4
# tests/test_fleet.py's deliberately weakened filter and marginal config.
WEAK_CBF = CBFParams(max_speed=15.0, k=0.0, dmin=0.16)
MARGINAL_CFG = swarm.Config(n=16, steps=140, k_neighbors=4, gating="jnp")


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


def _settings(mod=vfleet, **kw):
    kw.setdefault("seed", 0)
    kw.setdefault("batch", 2)
    kw.setdefault("batches_per_round", 2)
    kw.setdefault("max_steps", 6)
    kw.setdefault("generated_count", 0)
    kw.setdefault("include_rta", False)
    return mod.FleetSettings(**kw)


def _tiny(dtype=torch.float32):
    st = _settings()
    cfg = swarm.Config(n=4, steps=6, k_neighbors=3, gating="jnp",
                       dtype=dtype)
    a = search.make_adapter("swarm", cfg, device="cpu")
    eval_b = search.make_eval_batch(a, vfleet._search_settings(st))
    return vfleet.FleetTarget("tiny", "swarm", "swarm", a.cfg, None, a,
                              eval_b)


@pytest.fixture(scope="module")
def tiny_target():
    """One shared (n=4, t=6, batch=2) evaluator for the module."""
    return _tiny()


def _jax_tiny(dtype):
    st = _settings(jfleet)
    cfg = jsw.Config(n=4, steps=6, k_neighbors=3, gating="jnp",
                     dtype=dtype)
    a = jsearch.make_adapter("swarm", cfg)
    return jfleet.FleetTarget("tiny", "swarm", "swarm", a.cfg, None, a,
                              jsearch.make_eval_batch(
                                  a, jfleet._search_settings(st)))


class _Sink:
    def __init__(self):
        self.events = []

    def event(self, event_type, payload):
        self.events.append((event_type, dict(payload)))

    def of(self, event_type):
        return [p for t, p in self.events if t == event_type]


class _Flight:
    def __init__(self):
        self.trips = []

    def trip(self, kind, message):
        self.trips.append((kind, message))


# ------------------------------------------------------------- mutation

def test_mutate_batch_deterministic_and_seedless_bootstrap():
    key = prng.fold_in(prng.prng_key(0), 7)
    seeds = [np.full((4, 2), 0.01), np.full((4, 2), -0.02)]
    a = vfleet.mutate_batch(key, 8, (4, 2), np.float32, 0.02, seeds)
    b = vfleet.mutate_batch(key, 8, (4, 2), torch.float32, 0.02, seeds)
    assert a.shape == (8, 4, 2) and a.dtype == np.float32
    assert a.tobytes() == b.tobytes()
    c = vfleet.mutate_batch(prng.fold_in(key, 1), 8, (4, 2), np.float32,
                            0.02, seeds)
    assert a.tobytes() != c.tobytes()
    d = vfleet.mutate_batch(key, 8, (4, 2), np.float32, 0.02, [])
    noise = prng.normal(prng.fold_in(key, 0), (8, 4, 2)).numpy()
    np.testing.assert_array_equal(d, 0.02 * noise)


def test_mutate_batch_draws_from_seed_pool():
    out = vfleet.mutate_batch(prng.prng_key(3), 32, (4, 2), np.float32,
                              0.001, [np.full((4, 2), 0.5)])
    assert np.abs(out).max() > 0.1


@pytest.mark.parametrize("n_seeds", [0, 1, 3, 5])
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_mutate_batch_matches_jax_float64(seed, n_seeds, x64):
    """Under ``jax_enable_x64`` the JAX package draws int64 operator ids
    and float64 gains and masks; the port's float64 deltas draw the
    same, bit for bit."""
    rng = np.random.default_rng(seed)
    seeds = [rng.standard_normal((5, 2)) * 0.02 for _ in range(n_seeds)]
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    kt = prng.fold_in(prng.prng_key(seed), 7)
    want = jfleet.mutate_batch(kj, 16, (5, 2), np.float64, 0.02, seeds)
    got = vfleet.mutate_batch(kt, 16, (5, 2), torch.float64, 0.02, seeds)
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n_seeds", [0, 1, 3, 5])
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_mutate_batch_matches_jax_float32(seed, n_seeds):
    """float32: the discrete draws (operator ids over a span of 6, seed
    picks over spans 1, 3 and 5, row masks) equal JAX's; the candidates
    within FLOAT32_ULPS of JAX's."""
    rng = np.random.default_rng(seed)
    seeds = [rng.standard_normal((5, 2)) * 0.02 for _ in range(n_seeds)]
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    kt = prng.fold_in(prng.prng_key(seed), 7)
    want = jfleet.mutate_batch(kj, 16, (5, 2), np.float32, 0.02, seeds)
    got = vfleet.mutate_batch(kt, 16, (5, 2), torch.float32, 0.02, seeds)
    assert got.dtype == want.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= FLOAT32_ULPS
    if n_seeds:
        for i, span in ((1, len(vfleet.MUTATION_OPS)), (2, n_seeds),
                        (3, n_seeds)):
            np.testing.assert_array_equal(
                prng.randint(prng.fold_in(kt, i), (16,), 0, span).numpy(),
                np.asarray(jax.random.randint(jax.random.fold_in(kj, i),
                                              (16,), 0, span)))
        np.testing.assert_array_equal(
            prng.bernoulli(prng.fold_in(kt, 5), 0.5, (16, 5, 1)).numpy(),
            np.asarray(jax.random.bernoulli(jax.random.fold_in(kj, 5),
                                            0.5, (16, 5, 1))))


# ------------------------------------------------------------ allocation

def test_allocate_budget_unvisited_first_then_thinnest():
    alloc = vfleet.allocate_budget(8, [0, 1, 1], [np.inf, 0.5, 0.01])
    assert alloc.tolist() == [1, 0, 7]
    alloc = vfleet.allocate_budget(3, [0, 5, 0], [0.5, 0.001, np.inf])
    assert alloc.tolist() == [1, 1, 1]
    alloc = vfleet.allocate_budget(8, [1, 1], [1.0, 0.1])
    assert alloc.tolist() == [1, 7]


def test_allocate_budget_preserves_total_and_is_deterministic():
    visits = [0, 3, 1, 0, 7]
    worst = [np.inf, 0.2, -0.01, np.inf, 0.05]
    a = vfleet.allocate_budget(11, visits, worst)
    b = vfleet.allocate_budget(11, visits, worst)
    assert a.sum() == 11 and a.tolist() == b.tolist()
    assert a[0] >= 1 and a[3] >= 1
    assert a.tolist() == jfleet.allocate_budget(11, visits, worst).tolist()


# ------------------------------------------------------------ validation

def test_settings_and_fleet_validation(tiny_target):
    with pytest.raises(ValueError, match="batch"):
        vfleet.FleetSettings(batch=0)
    with pytest.raises(ValueError, match="near_miss_margin"):
        vfleet.FleetSettings(near_miss_margin=-0.1)
    with pytest.raises(ValueError, match="budget_rounds"):
        vfleet.FalsificationFleet(_settings(), budget_rounds=0,
                                  targets=[tiny_target])
    with pytest.raises(ValueError, match="target"):
        vfleet.FalsificationFleet(_settings(), targets=[])
    # A dp mesh rounds the batch up to its extent, as JAX's fleet does
    # (it raised until the dp mesh was ported; the dp-2 fleet itself:
    # tests/test_torch_verify.py).
    assert vfleet.FalsificationFleet(
        _settings(batch=3), targets=[tiny_target],
        mesh=(2, 1))._ss.batch == 4
    assert [(f.name, f.default) for f in dataclasses.fields(
        vfleet.FleetSettings)] == [
        (f.name, f.default) for f in dataclasses.fields(
            jfleet.FleetSettings)]
    assert vfleet.MUTATION_OPS == jfleet.MUTATION_OPS


def test_near_miss_entry_rejects_non_survivors():
    ss = search.SearchSettings(budget=2, batch=2)
    for bad in (-0.01, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="survivor"):
            corpus.near_miss_entry(
                "swarm", swarm.Config(n=4), np.zeros((4, 2)),
                engine="fleet", settings=ss, property="separation",
                margin=0.01, margin_x64=bad, steps=6)


def test_event_tables_equal_jax():
    from cbf_tpu.obs import schema as jschema

    assert vfleet.EMITTED_EVENT_TYPES == schema.FLEET_EVENT_TYPES \
        == jschema.FLEET_EVENT_TYPES
    assert schema.FLEET_EVENT_FIELDS == jschema.FLEET_EVENT_FIELDS


# --------------------------------------------------- campaign + resume

def test_campaign_resume_bit_exact_and_fingerprint_names_field(
        tiny_target, tmp_path):
    st = _settings()
    ref = vfleet.run_fleet(st, budget_rounds=4, targets=[tiny_target])
    assert ref.evaluated == 4 * st.batches_per_round * st.batch
    assert ref.cells_visited == len(PROPERTY_NAMES)

    sdir = str(tmp_path / "state")
    part = vfleet.run_fleet(st, budget_rounds=2, targets=[tiny_target],
                            state_dir=sdir)
    assert part.rounds == 2 and os.path.exists(part.state_path)
    full = vfleet.run_fleet(st, budget_rounds=4, targets=[tiny_target],
                            state_dir=sdir)
    assert full.rounds == ref.rounds
    assert full.evaluated == ref.evaluated
    assert full.best_margin == ref.best_margin

    with pytest.raises(ValueError, match=r"settings\.batch"):
        vfleet.FalsificationFleet(_settings(batch=4),
                                  targets=[tiny_target], state_dir=sdir)


def test_dropped_units_cost_nothing(tiny_target):
    """Pull units but run only every other offer (simulated preempts):
    the campaign ends bit-identical to the straight run."""
    st = _settings()
    ref = vfleet.run_fleet(st, budget_rounds=2, targets=[tiny_target])

    sink = _Sink()
    f = vfleet.FalsificationFleet(st, budget_rounds=2,
                                  targets=[tiny_target], telemetry=sink)
    drop = True
    while True:
        unit = f.next_unit()
        if unit is None:
            break
        drop = not drop
        if drop:
            f.on_preempt(queue_depth=3)
            continue
        unit()
    res = f.result()
    assert res.evaluated == ref.evaluated
    assert res.best_margin == ref.best_margin
    pre = sink.of("fleet.preempt")
    assert pre and all(p["queue_depth"] == 3 for p in pre)
    assert set(pre[0]) == set(schema.FLEET_EVENT_FIELDS["fleet.preempt"])


def test_offered_unit_builds_and_launches_nothing(monkeypatch):
    """``next_unit`` is host-only: no evaluator call (so no capture and no
    launch) until the offered closure runs."""
    calls = []
    target = _tiny()
    real = target.eval_b
    target = target._replace(
        eval_b=lambda d: calls.append(1) or real(d))
    f = vfleet.FalsificationFleet(_settings(), budget_rounds=1,
                                  targets=[target])
    for _ in range(3):
        unit = f.next_unit()
        f.on_preempt(queue_depth=1)
    assert calls == [] and f.result().evaluated == 0
    unit()
    assert calls == [1]


def test_fleet_round_events_match_schema(tiny_target):
    sink = _Sink()
    res = vfleet.run_fleet(_settings(), budget_rounds=2,
                           targets=[tiny_target], telemetry=sink)
    rounds = sink.of("fleet.round")
    assert len(rounds) == 2
    for p in rounds:
        assert set(p) == set(schema.FLEET_EVENT_FIELDS["fleet.round"])
        json.dumps(p)
    assert rounds[-1]["evaluated"] == res.evaluated
    assert rounds[-1]["cells_total"] == res.cells_total


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_campaign_equals_jax(dtype):
    """A two-round tiny campaign: ``FleetResult`` and every ``fleet.round``
    payload equal to the JAX package's, the fingerprint fields dict-equal
    (float64 under ``jax_enable_x64``)."""
    with jax.enable_x64(dtype == "float64"):
        jt = _jax_tiny(getattr(jnp, dtype))
        jsink = _Sink()
        want = jfleet.run_fleet(_settings(jfleet), budget_rounds=2,
                                targets=[jt], telemetry=jsink)
        jfields = jfleet.FalsificationFleet(
            _settings(jfleet), targets=[jt])._fields
    tt = _tiny(getattr(torch, dtype))
    tsink = _Sink()
    got = vfleet.run_fleet(_settings(), budget_rounds=2, targets=[tt],
                           telemetry=tsink)
    assert got._asdict() == want._asdict()
    assert tsink.events == jsink.events
    assert vfleet.FalsificationFleet(_settings(), targets=[tt])._fields \
        == jfields


def test_default_targets_and_fingerprint_equal_jax(registries):
    """The default settings stand up JAX's seven targets (the builtins,
    two generated specs, the RTA hybrid) with its delta shapes and
    horizons; the campaign fingerprint fields are dict-equal. The targets
    are built on the CPU and never dispatched here."""
    from cbf_tpu.scenarios.platform import registry as jregistry

    st = vfleet.FleetSettings()
    targets = vfleet.enroll_targets(st, device="cpu")
    assert len(targets) == 7
    jtargets = jfleet.enroll_targets(jfleet.FleetSettings())
    fields = vfleet.FalsificationFleet(st, targets=targets)._fields
    jfields = jfleet.FalsificationFleet(jfleet.FleetSettings(),
                                        targets=jtargets)._fields
    assert fields == jfields
    assert targets[-1].name == "rta_hybrid"
    assert all(jregistry.get(t.scenario) for t in jtargets)


# ------------------------------------------------------------- tenancy

def test_background_priority_is_shed_first():
    sink = _Sink()
    eng = ServeEngine(max_batch=4, bucket_sizes=(16,), horizon_quantum=8,
                      flush_deadline_s=60.0, telemetry=sink,
                      tracer=Tracer(enabled=False), device="cpu")
    eng.fault_policy = FaultPolicy(queue_limit=1)
    cfg = swarm.Config(n=4, steps=8, gating="jnp")
    eng.start()
    try:
        eng.submit(cfg)
        with pytest.raises(ShedError):
            eng.submit(cfg, priority="background")
    finally:
        eng.stop(drain=False)
    assert eng.stats["background_shed"] == 1
    (shed,) = sink.of("serve.shed")
    assert shed["reason"] == "background_queue_full"

    eng2 = ServeEngine(max_batch=4, bucket_sizes=(16,), horizon_quantum=8,
                       flush_deadline_s=60.0, telemetry=sink,
                       tracer=Tracer(enabled=False), device="cpu")
    eng2.fault_policy = FaultPolicy(queue_limit=1)
    eng2.start()
    try:
        bg = eng2.submit(cfg, priority="background")
        eng2.submit(cfg)
        with pytest.raises(ShedError):
            bg.result(timeout=1)
    finally:
        eng2.stop(drain=False)
    assert eng2.stats["background_shed"] == 1
    assert any(p["reason"] == "background_evicted"
               for p in sink.of("serve.shed"))


@pytest.mark.parametrize("continuous", [False, True])
def test_tenant_yields_to_foreground_arrival(continuous):
    """A unit pulled just before a foreground arrival is dropped un-run
    (``on_preempt`` with the queue depth), the foreground request
    completes, and the tenant resumes — degrade never trips. Both
    scheduler bodies."""
    sink = _Sink()
    eng = ServeEngine(max_batch=4, bucket_sizes=(4,), horizon_quantum=8,
                      flush_deadline_s=0.02, telemetry=sink,
                      tracer=Tracer(enabled=False), device="cpu",
                      continuous=continuous, chunk_steps=8)
    cfg = swarm.Config(n=4, steps=8, gating="jnp")
    eng.prewarm([cfg])
    ran, preempts = [], []

    class Tenant:
        def __init__(self):
            self.pend = None

        def next_unit(self):
            if self.pend is None:
                self.pend = eng.submit(cfg)
            return lambda: ran.append(time.monotonic())

        def on_preempt(self, queue_depth):
            preempts.append(queue_depth)

    tenant = Tenant()
    eng.start()
    try:
        eng.attach_background(tenant)
        deadline = time.monotonic() + 10
        while len(ran) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        eng.stop()
    assert preempts == [1], "first pulled unit must be dropped un-run"
    assert len(ran) >= 3, "tenant work must resume once foreground drains"
    assert tenant.pend.result(timeout=0).n == 4
    assert eng.stats["background_yields"] == 1
    assert eng.stats["background_batches"] >= 3
    assert eng.stats["degraded_requests"] == 0
    assert not sink.of("serve.degrade")


def test_fleet_campaign_as_background_tenant(tiny_target):
    st = _settings()
    ref = vfleet.run_fleet(st, budget_rounds=2, targets=[tiny_target])
    eng = ServeEngine(max_batch=4, bucket_sizes=(16,), horizon_quantum=8,
                      flush_deadline_s=0.02, tracer=Tracer(enabled=False),
                      device="cpu")
    eng.start()
    try:
        res = vfleet.run_fleet(st, budget_rounds=2, targets=[tiny_target],
                               engine=eng)
    finally:
        eng.stop()
    assert res.evaluated == ref.evaluated
    assert res.best_margin == ref.best_margin
    assert eng.stats["background_batches"] >= 2
    assert eng._bg_tenant is None, "campaign end must detach the tenant"


def test_tenant_unit_runs_under_program_lock(tiny_target, monkeypatch):
    """Each tenant unit runs holding ``serve.engine._PROGRAM_LOCK`` (a
    witnessed lock here) and none of the engine's own locks; the witness
    records the unit's inner lock under the program lock and no
    inversion, and every edge it observes but that test-owned one lies in
    the static graph."""
    lockwitness.arm()
    lockwitness.reset()
    try:
        monkeypatch.setattr(serve_engine, "_PROGRAM_LOCK",
                            lockwitness.make_lock(
                                "serve.engine._PROGRAM_LOCK"))
        inner = lockwitness.make_lock("tenant.inner")
        eng = ServeEngine(max_batch=4, bucket_sizes=(16,),
                          horizon_quantum=8, flush_deadline_s=0.02,
                          tracer=Tracer(enabled=False), device="cpu")
        fleet = vfleet.FalsificationFleet(_settings(), budget_rounds=1,
                                          targets=[tiny_target])
        held = []

        class Witnessed:
            def next_unit(self):
                unit = fleet.next_unit()
                if unit is None:
                    return None

                def run():
                    held.append((serve_engine._PROGRAM_LOCK.locked(),
                                 eng._lock.locked()))
                    with inner:
                        unit()
                return run

            def on_preempt(self, queue_depth):
                fleet.on_preempt(queue_depth)

        eng.start()
        try:
            eng.attach_background(Witnessed())
            deadline = time.monotonic() + 30
            while not fleet._finished and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            eng.stop()
        assert fleet._finished and fleet.result().evaluated == 4
        assert held and all(h == (True, False) for h in held)
        edges = lockwitness.observed_edges()
        assert ("serve.engine._PROGRAM_LOCK", "tenant.inner") in edges
        assert lockwitness.inversions() == []
        # tenant.inner is this test's own lock, taken by its unit.
        own = {("serve.engine._PROGRAM_LOCK", "tenant.inner")}
        assert lockwitness.check_subgraph(_static_lock_graph() | own) == []
    finally:
        lockwitness.disarm()
        lockwitness.reset()


# ------------------------------------------------------------- CLI + docs

def test_cli_fleet_settings_set_overrides_dedicated_flags():
    from cbf_tpu_torch.__main__ import _fleet_settings_from_args

    def ns(**kw):
        base = dict(weaken=[], set=[], perturb_scale=None,
                    perturb_norm=None, seed=0, batch=16)
        base.update(kw)
        return SimpleNamespace(**base)

    s = _fleet_settings_from_args(ns(set=["batch=8", "include_rta=false"],
                                     batch=4, weaken=["dmin=0.1"]))
    assert s.batch == 8 and s.include_rta is False
    assert s.cbf_overrides == (("dmin", 0.1),)
    assert _fleet_settings_from_args(ns(batch=4)).batch == 4
    with pytest.raises(SystemExit, match="unknown FleetSettings"):
        _fleet_settings_from_args(ns(set=["bogus=1"]))


def test_cli_fleet_record_equals_jax(capsys, registries):
    """``verify fleet --json`` at a tiny size over the four builtins: the
    record is the JAX package's, and exit 0."""
    from cbf_tpu.__main__ import main as jmain
    from cbf_tpu_torch.__main__ import main

    argv = ["verify", "fleet", "--budget-rounds", "2", "--batch", "2",
            "--set", "batches_per_round=2", "--set", "generated_count=0",
            "--set", "include_rta=false", "--set", "max_steps=6", "--json"]
    assert main([*argv, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jmain([*argv, "--platform", "cpu"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want


def test_docs_cover_fleet_surface():
    readme = open(os.path.join(ROOT, "README.md")).read()
    port = readme[readme.index("## PyTorch/CUDA port"):]
    for needle in ("Falsification fleet", "`fleet.round`",
                   "`fleet.violation`", "`fleet.preempt`", "verify fleet",
                   "--budget-rounds", "--serve-idle", "near-miss",
                   "scenario gen", "scenario run", "attach_background"):
        assert needle in port, f"README port section missing {needle!r}"


# ------------------------------------------------------------ slow end

def _cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.slow
def test_fleet_cli_sigkill_resume_bit_exact(tmp_path):
    """Kill the CLI campaign after its first round-state save, resume, and
    the final record equals an uninterrupted run's."""
    shrink_flags = ["--batch", "4", "--set", "batches_per_round=2",
                    "--set", "generated_count=0",
                    "--set", "include_rta=false", "--set", "max_steps=8"]

    def argv(state_dir):
        return [sys.executable, "-m", "cbf_tpu_torch", "verify", "fleet",
                "--device", "cpu", "--budget-rounds", "3", "--state-dir",
                state_dir, "--json", *shrink_flags]

    def record_of(out):
        return json.loads(out.strip().splitlines()[-1])

    ref_dir, kill_dir = str(tmp_path / "ref"), str(tmp_path / "kill")
    ref = subprocess.run(argv(ref_dir), capture_output=True, text=True,
                         env=_cli_env(), timeout=600)
    assert ref.returncode == 0, ref.stderr
    ref_rec = record_of(ref.stdout)
    assert ref_rec["rounds"] == 3

    state_npz = os.path.join(kill_dir, "fleet_state.npz")
    rc, killed, _ = faults.run_process_until(
        argv(kill_dir), lambda _t: os.path.exists(state_npz),
        poll_s=0.05, timeout_s=300.0, env=_cli_env())
    assert killed, f"campaign finished (rc={rc}) before the kill armed"

    res = subprocess.run(argv(kill_dir), capture_output=True, text=True,
                         env=_cli_env(), timeout=600)
    assert res.returncode == 0, res.stderr
    rec = record_of(res.stdout)
    for key in ("rounds", "evaluated", "best_margin", "cells_visited",
                "near_misses", "violations", "targets"):
        assert rec[key] == ref_rec[key], key


@pytest.mark.slow
def test_fleet_detects_weakened_dmin_end_to_end(tmp_path):
    """The weakened-dmin filter is found within 6 rounds, shrunk,
    float64-confirmed, archived, the capsule trips, and the archive
    replays clean."""
    st = vfleet.FleetSettings(seed=0, batch=8, batches_per_round=2,
                              perturb_scale=0.04, perturb_norm=0.1,
                              max_steps=MARGINAL_CFG.steps,
                              generated_count=0, include_rta=False)
    a = search.make_adapter("swarm", MARGINAL_CFG, cbf=WEAK_CBF,
                            device="cpu")
    target = vfleet.FleetTarget(
        "swarm-weak", "swarm", "swarm", a.cfg, WEAK_CBF, a,
        search.make_eval_batch(a, vfleet._search_settings(st)))
    sink, flight = _Sink(), _Flight()
    res = vfleet.run_fleet(st, budget_rounds=6, targets=[target],
                           corpus_dir=str(tmp_path), telemetry=sink,
                           flight=flight)
    assert res.done and res.violations, "weakened dmin must be found"
    v = res.violations[0]
    assert v["confirmed_x64"] and v["margin_x64"] < 0
    assert v["property"] == "separation"
    assert v["corpus"] and os.path.exists(v["corpus"])
    assert flight.trips and flight.trips[0][0] == "fleet.violation"
    events = sink.of("fleet.violation")
    assert len(events) == len(res.violations)
    assert set(events[0]) == set(
        schema.FLEET_EVENT_FIELDS["fleet.violation"])
    for entry, _, problems in corpus.replay_corpus(str(tmp_path),
                                                   device="cpu"):
        assert problems == [], problems
    assert re.match(r"fleet found a confirmed violation: swarm-weak/",
                    flight.trips[0][1])
