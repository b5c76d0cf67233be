"""The port's streaming telemetry (cbf_tpu_torch.obs), checked rollout,
step fault injectors and profiling hooks on the CPU, against
tests/test_telemetry.py and tests/test_observability.py and the JAX
package's own streams.

Held here: heartbeats carry exactly ``StepOutputs[t]``'s scalars (and the
post-step non-finite count) on the scenario, chunked (resumed too) and
ensemble paths, and equal JAX's heartbeats from the same float32 spawn
within the rollout parity tolerances (min distance rtol 1e-6, the
certificate's residual atol 1e-6, counts exact); the manifest and
summary; the registry's merge and histogram snapshots equal to JAX's;
each watchdog alert from an injected fault (NaN state, certificate
blow-up of the warm carry and of the record, sustained infeasibility,
a host stall); an untracked field refused; the tap cached per sink;
reader-side stall detection; strict JSON for non-finite values; the
heartbeat schema equal to JAX's and mapped onto the port's structs;
``checked_rollout`` clean and dirty, locating a NaN or an infinity at
JAX's step and field; ``StepTimer`` and ``trace``; ``run
--telemetry-dir`` then ``obs summary``/``obs tail``; and the compiled
rollout with telemetry and a cost model equal to the eager loop, its
tapped body making no host traffic.
"""

import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch
from jax.experimental import checkify

from cbf_tpu import obs as jobs
from cbf_tpu.obs import schema as jschema
from cbf_tpu.rollout import engine as jeng
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.utils import debug as jdebug
from cbf_tpu.utils import faults as jfaults
from cbf_tpu_torch import convert, obs
from cbf_tpu_torch.__main__ import main as cli
from cbf_tpu_torch.obs import schema
from cbf_tpu_torch.parallel import ensemble as tens
from cbf_tpu_torch.parallel.mesh import make_mesh
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.utils import debug, faults, profiling

MD_RTOL, RES_ATOL = 1e-6, 1e-6
SCENARIO = dict(n=24, steps=30, certificate=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _heartbeats(run_dir):
    return {e["step"]: e for e in obs.read_events(run_dir)
            if e.get("event") == "heartbeat"}


def _assert_bitmatch(run_dir, outs, every, steps, start=0):
    """Every heartbeat value equals its StepOutputs row exactly."""
    hbs = _heartbeats(run_dir)
    assert sorted(hbs) == [t for t in range(start, start + steps)
                           if t % every == 0]
    for f in schema.HEARTBEAT_FIELDS:
        if f.step_output is None:
            assert all(e[f.name] == 0 for e in hbs.values())
            continue
        leaf = getattr(outs, f.step_output)
        if isinstance(leaf, tuple):
            assert all(f.name not in e for e in hbs.values())
            continue
        series = np.asarray(leaf.cpu() if isinstance(leaf, torch.Tensor)
                            else leaf)
        for t, e in hbs.items():
            assert schema.scalar_value(e[f.name]) == float(series[t - start])


@pytest.fixture(scope="module")
def jax_scenario(tmp_path_factory):
    """JAX's heartbeats of SCENARIO every 5 steps, and its spawn."""
    jcfg = jsw.Config(**SCENARIO)
    jstate0, jstep = jsw.make(jcfg)
    run_dir = str(tmp_path_factory.mktemp("jax"))
    sink = jobs.TelemetrySink(run_dir)
    final, _ = jeng.rollout(jstep, jstate0, jcfg.steps, telemetry=sink,
                            telemetry_every=5)
    np.asarray(final.x)
    deadline = time.time() + 10
    while sink.heartbeat_count < 6 and time.time() < deadline:
        time.sleep(0.01)
    sink.close()
    return jstate0, {e["step"]: e for e in jobs.read_events(run_dir)
                     if e.get("event") == "heartbeat"}


def test_heartbeats_bitmatch_scenario_path(tmp_path, jax_scenario):
    jstate0, jhbs = jax_scenario
    cfg = tsw.Config(**SCENARIO)
    _, step = tsw.make(cfg, device="cpu")
    state0 = convert.state_from_reference(jstate0, device="cpu",
                                          dtype=torch.float32)
    sink = obs.TelemetrySink(str(tmp_path))
    final, outs = teng.rollout(step, state0, cfg.steps, telemetry=sink,
                               telemetry_every=5)
    sink.close()
    _assert_bitmatch(str(tmp_path), outs, every=5, steps=30)
    hbs = _heartbeats(str(tmp_path))
    assert sorted(hbs) == sorted(jhbs)
    for t, e in hbs.items():
        want = jhbs[t]
        assert {f.name for f in schema.HEARTBEAT_FIELDS if f.name in e} \
            == {f.name for f in jschema.HEARTBEAT_FIELDS if f.name in want}
        for f in schema.HEARTBEAT_FIELDS:
            if f.name not in e:
                continue
            got, ref = (schema.scalar_value(e[f.name]),
                        jschema.scalar_value(want[f.name]))
            if f.name == "min_pairwise_distance":
                np.testing.assert_allclose(got, ref, rtol=MD_RTOL)
            elif f.name == "certificate_residual":
                np.testing.assert_allclose(got, ref, rtol=0, atol=RES_ATOL)
            else:
                assert got == ref, (f.name, t)


def test_heartbeats_bitmatch_chunked_path(tmp_path):
    """Chunked rollouts sample the global step across chunk boundaries
    (a trailing partial chunk too), and a resumed run samples the steps
    the uninterrupted one does."""
    cfg = tsw.Config(n=16, steps=23)
    state0, step = tsw.make(cfg, device="cpu")
    sink = obs.TelemetrySink(str(tmp_path / "a"))
    _, outs, start = teng.rollout_chunked(step, state0, cfg.steps, chunk=7,
                                          telemetry=sink, telemetry_every=3)
    sink.close()
    assert start == 0
    _assert_bitmatch(str(tmp_path / "a"), outs, every=3, steps=23)
    d = str(tmp_path / "ckpt")
    teng.rollout_chunked(step, state0, 14, chunk=7, checkpoint_dir=d)
    sink = obs.TelemetrySink(str(tmp_path / "b"))
    _, tail, start = teng.rollout_chunked(
        step, state0, cfg.steps, chunk=7, checkpoint_dir=d, telemetry=sink,
        telemetry_every=3)
    sink.close()
    assert start == 14
    _assert_bitmatch(str(tmp_path / "b"), tail, every=3, steps=9, start=14)


def test_heartbeats_bitmatch_ensemble_path(tmp_path):
    """Ensemble heartbeats reduce the members' metrics as the schema
    declares, equal to applying the reduction to the returned metrics
    and, from the same seeds, to JAX's ensemble stream."""
    from cbf_tpu.parallel import make_mesh as jax_mesh
    from cbf_tpu.parallel.ensemble import sharded_swarm_rollout as jrun

    cfg = tsw.Config(n=16, steps=12)
    sink = obs.TelemetrySink(str(tmp_path / "port"))
    _, mets = tens.sharded_swarm_rollout(cfg, make_mesh(devices="cpu"),
                                         seeds=[0, 1], chunk=5,
                                         telemetry=sink, telemetry_every=3)
    sink.close()
    hbs = _heartbeats(str(tmp_path / "port"))
    assert sorted(hbs) == [0, 3, 6, 9]
    assert all(e["ensemble_members"] == 2 for e in hbs.values())
    jsink = jobs.TelemetrySink(str(tmp_path / "jax"))
    jrun(jsw.Config(n=16, steps=12), jax_mesh(n_dp=1, n_sp=1), seeds=[0, 1],
         chunk=5, telemetry=jsink, telemetry_every=3)
    jsink.close()
    jhbs = {e["step"]: e for e in jobs.read_events(str(tmp_path / "jax"))
            if e.get("event") == "heartbeat"}
    for f in schema.HEARTBEAT_FIELDS:
        if f.ensemble is None:
            continue
        arr = np.asarray(getattr(mets, f.ensemble))
        for t, e in hbs.items():
            got = schema.scalar_value(e[f.name])
            assert got == float(schema.reduce_members(f, arr[:, t].tolist()))
            ref = jschema.scalar_value(jhbs[t][f.name])
            if f.name == "min_pairwise_distance":
                np.testing.assert_allclose(got, ref, rtol=MD_RTOL)
            else:
                np.testing.assert_allclose(got, ref, rtol=0, atol=RES_ATOL)


def test_manifest_and_summary(tmp_path):
    cfg = tsw.Config(n=9, steps=10)
    state0, step = tsw.make(cfg, device="cpu")
    profiling.add_event_count("test.marker")
    sink = obs.TelemetrySink(
        str(tmp_path), manifest=obs.build_manifest(cfg, extra={"knob": 1}))
    teng.rollout(step, state0, cfg.steps, telemetry=sink, telemetry_every=2)
    profiling.add_event_count("test.marker", 2)
    summary = sink.summary()
    sink.close()
    manifest = obs.read_manifest(str(tmp_path))
    assert manifest["schema"] == schema.SCHEMA_VERSION
    assert manifest["torch_version"] == torch.__version__
    assert "cuda_version" in manifest and "git_sha" in manifest
    assert manifest["topology"]["backend"] == "cpu"
    assert manifest["knob"] == 1 and manifest["config"]["n"] == "9"
    assert summary["heartbeats"] == 5
    assert summary["compile_events_during_run"]["test.marker"] == 2
    assert summary["metrics"]["infeasible_count"]["samples"] == 5
    assert obs.summarize_run(str(tmp_path))["from"] == "summary_event"


def test_compile_event_counts_count_the_engine():
    """The counters count the engine's redone chunks (captures and
    replays on the card) from the last reset, and framework counts."""
    cfg = tsw.Config(n=16, steps=4, dynamics="mixed", n_double=8,
                     spawn_half_width_override=0.25)
    state0, step = tsw.make(cfg, device="cpu")
    step.relax_rounds = 0
    profiling.reset_compile_event_counts()
    assert profiling.compile_event_counts() == {}
    teng.rollout(step, state0, cfg.steps)
    counts = profiling.compile_event_counts()
    assert counts["engine.redos"] == 1 and counts["engine.redo_steps"] == 4
    profiling.add_event_count("x", 3)
    assert profiling.compile_event_counts()["x"] == 3
    profiling.reset_compile_event_counts()
    assert profiling.compile_event_counts() == {}


@pytest.mark.parametrize("steps", [6, 7])
def test_tapped_rollout_redoes_queued_chunks(steps, tmp_path):
    """The tapped rollout queues each chunk before settling the one
    before it: where every chunk's relax flag is set (no guarded rounds),
    each is redone and the chunk queued after it runs again from the
    redone state — a trailing shorter chunk (7 steps) on a program of its
    own — so the result equals the eager loop and every heartbeat its
    StepOutputs row."""
    cfg = tsw.Config(n=16, steps=steps, dynamics="mixed", n_double=8,
                     spawn_half_width_override=0.25)
    state0, step = tsw.make(cfg, device="cpu")
    step.relax_rounds = 0
    want_final, want = teng.eager_rollout(step, state0, steps)
    before = dict(teng.COUNTS)
    sink = obs.TelemetrySink(str(tmp_path))
    final, outs = teng.rollout(step, state0, steps, telemetry=sink,
                               telemetry_every=2)
    sink.close()
    assert teng.COUNTS["redos"] - before["redos"] == (steps + 1) // 2
    assert teng.COUNTS["redo_steps"] - before["redo_steps"] == steps
    assert teng.COUNTS["rerun_steps"] - before["rerun_steps"] == steps - 2
    for a, b in zip(teng._leaves((final, outs)),
                    teng._leaves((want_final, want))):
        assert torch.equal(a, b)
    _assert_bitmatch(str(tmp_path), outs, every=2, steps=steps)


def _registry_ops(mod):
    a, b = mod.MetricsRegistry(), mod.MetricsRegistry()
    a.counter("c").add(2)
    b.counter("c").add(3)
    a.gauge("g").set(1.0)
    b.gauge("g").set(5.0)
    a.gauge("g").set(float("nan"))
    for v in (1e-3, 0.2, 7.0, 3e5):
        a.histogram("h").observe(v)
    b.histogram("h").observe(float("nan"))
    b.histogram("h").observe(0.05)
    a.merge(b.snapshot())
    return a.snapshot()


def test_registry_merge_and_histogram():
    from cbf_tpu.obs import sink as jsink

    from cbf_tpu_torch.obs import sink as tsink

    snap = _registry_ops(tsink)
    assert json.dumps(snap, sort_keys=True) == json.dumps(
        _registry_ops(jsink), sort_keys=True)
    assert snap["c"]["total"] == 5 and snap["c"]["samples"] == 2
    assert snap["g"]["min"] == 1.0 and snap["g"]["max"] == 5.0
    assert snap["h.hist"]["samples"] == 6 and snap["h.hist"]["nonfinite"] == 1


# -- the watchdog's alerts, each from an injected fault ----------------------

def _watch(step, state0, steps, tmp_path, **kw):
    sink = obs.TelemetrySink(str(tmp_path))
    with obs.Watchdog(sink, **kw) as wd:
        teng.rollout(step, state0, steps, telemetry=sink, telemetry_every=1)
    sink.close()
    return wd, obs.read_events(str(tmp_path))


def test_watchdog_nan_alert_from_injected_state_fault(tmp_path):
    cfg = tsw.Config(n=12, steps=20)
    state0, step = tsw.make(cfg, device="cpu")
    wd, events = _watch(faults.nan_at_step(step, 7), state0, cfg.steps,
                        tmp_path)
    first = next(a for a in wd.alerts if a.kind == obs.ALERT_NAN)
    assert first.step == 7 and "nonfinite_state_count" in first.detail
    assert any(e.get("kind") == obs.ALERT_NAN for e in events
               if e.get("event") == "alert")


def test_watchdog_certificate_blowup(tmp_path):
    """The record forged at step 5 (one edge-triggered alert), and a real
    blow-up: the warm ADMM carry scaled at step 3 fails the budget."""
    cfg = tsw.Config(n=24, steps=12, certificate=True)
    state0, step = tsw.make(cfg, device="cpu")
    bad = faults.corrupt_output_at_step(step, 5, "certificate_residual", 1.0)
    wd, _ = _watch(bad, state0, cfg.steps, tmp_path / "forged",
                   residual_threshold=1e-2)
    hits = [a for a in wd.alerts if a.kind == obs.ALERT_CERT_BLOWUP]
    assert len(hits) == 1 and hits[0].step == 5
    cfg = tsw.Config(n=32, steps=6, certificate=True,
                     certificate_backend="sparse",
                     certificate_warm_start=True,
                     spawn_half_width_override=0.8)
    state0, step = tsw.make(cfg, device="cpu")
    wd, _ = _watch(faults.residual_blowup_at_step(step, 3), state0,
                   cfg.steps, tmp_path / "warm", residual_threshold=1e-2)
    hits = [a for a in wd.alerts if a.kind == obs.ALERT_CERT_BLOWUP]
    assert hits and hits[0].step == 3


def test_watchdog_sustained_infeasibility_from_forged_output(tmp_path):
    cfg = tsw.Config(n=12, steps=20)
    state0, step = tsw.make(cfg, device="cpu")
    bad = faults.corrupt_output_at_step(step, 6, "infeasible_count", 2,
                                        until=16)
    wd, _ = _watch(bad, state0, cfg.steps, tmp_path, infeasible_patience=3)
    hits = [a for a in wd.alerts if a.kind == obs.ALERT_INFEASIBLE]
    assert len(hits) == 1 and hits[0].step == 8


def test_watchdog_stall_from_injected_stall(tmp_path):
    """The host stalls before step 15 (the chunk that holds it): the
    heartbeats stop for 1.5 s, and the stall thread alerts while the run
    is still going."""
    cfg = tsw.Config(n=9, steps=30)
    state0, step = tsw.make(cfg, device="cpu")
    bad = faults.stall_at_step(step, 15, seconds=1.5)
    sink = obs.TelemetrySink(str(tmp_path))
    with obs.Watchdog(sink, stall_timeout=0.4) as wd:
        teng.rollout(bad, state0, cfg.steps, telemetry=sink,
                     telemetry_every=1)
        end = time.time()
    sink.close()
    stalls = [a for a in wd.alerts if a.kind == obs.ALERT_STALL]
    assert stalls and stalls[0].t_wall <= end
    walls = [e["t_wall"] for _, e in sorted(_heartbeats(
        str(tmp_path)).items())]
    assert len(walls) == 30 and max(np.diff(walls)) >= 1.5


def test_corrupt_output_rejects_untracked_field():
    cfg = tsw.Config(n=9, steps=4)
    state0, step = tsw.make(cfg, device="cpu")
    bad = faults.corrupt_output_at_step(step, 1, "certificate_residual", 1.0)
    with pytest.raises(ValueError, match="untracked"):
        teng.rollout(bad, state0, cfg.steps)


def test_tap_wrapper_cached_per_sink(tmp_path):
    _, step = tsw.make(tsw.Config(n=9, steps=4), device="cpu")
    sink = obs.TelemetrySink(str(tmp_path))
    w1 = obs.instrument_step(step, sink, every=2)
    assert w1 is obs.instrument_step(step, sink, every=2)
    assert w1 is not obs.instrument_step(step, sink, every=3)
    with pytest.raises(ValueError):
        obs.instrument_step(step, sink, every=0)
    sink.close()


def test_lock_witness_sees_the_sink_and_watchdog(tmp_path):
    """Armed, the witness books the sink's and the watchdog's locks (the
    watchdog's alert takes its own lock, then the sink's) with no
    inversion; disarmed, the factories give plain threading locks."""
    from cbf_tpu_torch.analysis import lockwitness

    lockwitness.reset()
    lockwitness.arm()
    try:
        sink = obs.TelemetrySink(str(tmp_path))
        with obs.Watchdog(sink) as wd:
            sink.heartbeat(0, {"min_pairwise_distance": float("nan")})
        sink.close()
    finally:
        lockwitness.disarm()
    assert [a.kind for a in wd.alerts] == [obs.ALERT_NAN]
    snap = lockwitness.snapshot()
    assert snap["acquisitions"] > 0 and lockwitness.inversions() == []
    assert isinstance(sink._lock, lockwitness.WitnessLock)
    assert not isinstance(lockwitness.make_lock("x"),
                          lockwitness.WitnessLock)
    lockwitness.reset()


def test_reader_side_stall_detection(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path))
    sink.heartbeat(0, {"min_pairwise_distance": 1.0})
    events = list(obs.tail_events(str(tmp_path), follow=True, poll_s=0.05,
                                  stall_timeout=0.3))
    sink.close()
    assert events[-1]["kind"] == "stall" and events[-1]["synthetic"]


def test_nonfinite_values_stay_strict_json(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path))
    sink.heartbeat(0, {"min_pairwise_distance": float("nan"),
                       "certificate_residual": float("inf")})
    sink.close()
    with open(sink.events_path) as fh:
        for line in fh:
            ev = json.loads(line, parse_constant=lambda c: pytest.fail(
                f"non-strict JSON constant {c} in stream"))
    assert ev["min_pairwise_distance"] == "nan"
    assert ev["certificate_residual"] == "inf"


def test_schema_equals_jax_and_maps_onto_the_port():
    """The heartbeat fields are JAX's, each maps onto a field of the
    port's StepOutputs / EnsembleMetrics, and every field of those is
    streamed or excluded with a reason (the schema audit's rule)."""
    assert tuple(map(tuple, schema.HEARTBEAT_FIELDS)) == tuple(
        map(tuple, jschema.HEARTBEAT_FIELDS))
    assert schema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    assert schema.EXCLUDED_STEP_OUTPUT_FIELDS == \
        jschema.EXCLUDED_STEP_OUTPUT_FIELDS
    steps = set(schema.step_output_channels())
    ens = set(schema.ensemble_channels())
    assert steps <= set(teng.StepOutputs._fields)
    assert ens <= set(tens.EnsembleMetrics._fields)
    assert set(teng.StepOutputs._fields) == steps | set(
        schema.EXCLUDED_STEP_OUTPUT_FIELDS)
    assert set(tens.EnsembleMetrics._fields) == ens
    for name in ("VERIFY", "DURABLE", "RTA"):
        for v in getattr(schema, f"{name}_EVENT_TYPES"):
            assert v in getattr(jschema, f"{name}_EVENT_TYPES")
            assert getattr(schema, f"{name}_EVENT_FIELDS")[v] == \
                getattr(jschema, f"{name}_EVENT_FIELDS")[v]
    for v in (1.0, 2.5, float("nan"), float("inf"), -float("inf"), 3):
        assert schema.json_scalar(v) == jschema.json_scalar(v)


# -- the checked rollout ------------------------------------------------------

def _jax_raises(jstep, jstate0, steps) -> bool:
    try:
        jdebug.checked_rollout(jstep, jstate0, steps)
    except checkify.JaxRuntimeError:
        return True
    return False


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_checked_rollout_locates_jax_step_and_field(kind):
    jcfg = jsw.Config(n=12, steps=8)
    jstate0, jstep = jsw.make(jcfg)
    inject = {"nan": (jfaults.nan_at_step, faults.nan_at_step),
              "inf": (jfaults.inf_at_step, faults.inf_at_step)}[kind]
    # JAX's location: its checkify rollout is clean through step 4 and
    # raises on step 5; the first non-finite state leaf after it is x.
    jbad = inject[0](jstep, 5)
    assert not _jax_raises(jbad, jstate0, 5) and _jax_raises(jbad, jstate0,
                                                             6)
    jfinal, _ = jeng.rollout(jbad, jstate0, 6)
    assert not np.isfinite(np.asarray(jfinal.x)).all()
    cfg = tsw.Config(n=12, steps=8)
    _, step = tsw.make(cfg, device="cpu")
    state0 = convert.state_from_reference(jstate0, device="cpu",
                                          dtype=torch.float32)
    with pytest.raises(FloatingPointError) as ei:
        debug.checked_rollout(inject[1](step, 5), state0, 8)
    assert (ei.value.step, ei.value.field) == (5, "state.x")
    assert ei.value.kind == kind or (kind, ei.value.kind) == ("inf", "nan")
    assert ei.value.kind in str(ei.value)
    # The same faulty program runs silently without the check.
    final, _ = teng.rollout(inject[1](step, 5), state0, 8)
    assert not bool(torch.isfinite(final.x).all())


def test_checked_rollout_clean_and_dirty():
    cfg = tsw.Config(n=9, steps=3, k_neighbors=4)
    state0, step = tsw.make(cfg, device="cpu")
    final, outs = debug.checked_rollout(step, state0, cfg.steps)
    s = debug.summarize(outs)
    assert s["steps"] == 3 and np.isfinite(s["min_pairwise_distance"])
    ref_final, ref_outs = teng.rollout(step, state0, cfg.steps)
    assert torch.equal(final.x, ref_final.x)
    bad = state0._replace(x=state0.x.clone().index_fill_(
        0, torch.tensor([0]), float("nan")))
    with pytest.raises(FloatingPointError, match="initial state") as ei:
        debug.checked_rollout(step, bad, cfg.steps)
    assert ei.value.step == 0 and ei.value.field == "state.x"
    with pytest.raises(FloatingPointError, match="inf in outputs"):
        debug.checked_rollout(
            faults.corrupt_output_at_step(step, 1, "max_relax_rounds",
                                          float("inf")), state0, cfg.steps)
    debug.checked_rollout(
        faults.corrupt_output_at_step(step, 1, "max_relax_rounds",
                                      float("inf")), state0, cfg.steps,
        errors={"nan"})


def test_teleport_and_poison_config_show_in_the_metrics():
    """A finite corruption (agent 0 teleported onto agent 1) collapses the
    min distance at its step and the filter reacts; the poisoned config's
    1e30 timestep overflows the state."""
    cfg = tsw.Config(n=12, steps=30)
    state0, step = tsw.make(cfg, device="cpu")
    x0 = state0.x.numpy()
    off = (x0[1] - x0[0]) + np.array([0.03, 0.0], np.float32)
    _, outs = teng.rollout(faults.teleport_at_step(step, 10, agent=0,
                                                   offset=tuple(off)),
                           state0, cfg.steps)
    assert float(outs.min_pairwise_distance[10]) < 0.1
    assert int(outs.filter_active_count[10:].sum()) > 0
    pcfg = faults.poison_config(tsw.Config(n=12, steps=2))
    assert dataclasses.replace(pcfg, dt=0.033) == tsw.Config(n=12, steps=2)
    pstate, pstep = tsw.make(pcfg, device="cpu")
    final, _ = teng.rollout(pstep, pstate, 2)
    assert not bool(torch.isfinite(final.x).all())


def test_step_timer_trace_and_tensorboard(tmp_path):
    t = profiling.StepTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    assert "a=" in t.summary() and t.totals["a"] >= 0.0
    d = str(tmp_path / "prof")
    with profiling.trace(d):
        with profiling.annotate("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(d, profiling.TRACE_NAME)) as fh:
        assert "matmul" in fh.read()
    if not profiling.tensorboard_available():
        assert profiling.export_scalars_to_tensorboard(str(tmp_path)) is None


def test_cli_run_telemetry_and_obs_summary(tmp_path, capsys):
    run_dir = str(tmp_path / "r")
    assert cli(["run", "swarm", "--device", "cpu", "--steps", "12", "--set",
                "n=9", "--telemetry-dir", run_dir,
                "--telemetry-every", "4"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["telemetry_heartbeats"] == 3
    assert record["telemetry_alerts"] == []
    assert cli(["obs", "summary", run_dir]) == 0
    parsed = json.loads(capsys.readouterr().out)
    assert parsed["heartbeats"] == 3 and parsed["from"] == "summary_event"
    assert parsed["manifest"]["topology"]["backend"] == "cpu"
    assert cli(["obs", "tail", run_dir]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["event"] for line in lines] == [
        "heartbeat"] * 3 + ["summary"]
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert cli(["obs", "tail", empty, "--follow", "--stall-timeout",
                "0.1"]) == 3
    assert cli(["obs", "summary", empty]) == 1


@contextlib.contextmanager
def _no_host_traffic():
    """Host copies to the device and host reads of device values patched
    to raise (tests/test_torch_rollout.py's capture probe)."""
    def _raise(name):
        def f(*a, **k):
            raise AssertionError(f"{name} inside the captured body")
        return f

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "tensor", _raise("torch.tensor"))
        mp.setattr(torch, "as_tensor", _raise("torch.as_tensor"))
        for name in ("item", "__bool__", "cpu", "__float__", "__int__",
                     "__index__", "tolist", "numpy"):
            mp.setattr(torch.Tensor, name, _raise(f"Tensor.{name}"))
        yield


@pytest.mark.parametrize("fields", [
    dict(n=64, steps=12),
    dict(n=64, steps=6, certificate=True, certificate_backend="sparse",
         certificate_warm_start=True, spawn_half_width_override=0.8)])
def test_compiled_with_telemetry_and_cost_model_equals_eager(fields,
                                                             tmp_path):
    cfg = tsw.Config(**fields)
    state0, step = tsw.make(cfg, device="cpu")
    want_final, want = teng.eager_rollout(step, state0, cfg.steps)
    sink = obs.TelemetrySink(str(tmp_path))
    model = obs.CostModel()
    final, outs = teng.rollout(step, state0, cfg.steps, telemetry=sink,
                               telemetry_every=2, cost_model=model)
    sink.close()
    for a, b in zip(teng._leaves((final, outs)),
                    teng._leaves((want_final, want))):
        assert torch.equal(a, b)
    (entry,) = model.entries.values()
    assert entry["cost"]["argument_bytes"] > 0
    assert entry["cost"]["output_bytes"] > 0
    assert entry["cost"]["flops"] is None and entry["cost"]["peak_bytes"] \
        is None
    tap = obs.instrument_step(faults.stall_at_step(step, 99, 0.0), sink,
                              every=2)
    prog = teng._program(tap, state0, 3, unroll=2)
    prog.load(state0)
    prog.start(0)
    prog.body(tap, 1)
    with _no_host_traffic():
        prog.body(tap, 2)
    assert torch.equal(prog.carry.x, teng.eager_rollout(step, state0, 3)[0].x)
