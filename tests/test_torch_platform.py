"""The port's scenario platform (cbf_tpu_torch/scenarios/platform/) held
to the JAX package's on the CPU.

- tests/test_platform.py on the port, where this package can run it:
  registry round-trip determinism, no silent shadowing, spec validation,
  RTA soundness of a generated scenario at delta 0, the bucket-label
  scenario axes, a generated mixed scenario served through
  ``ServeEngine``, the three load-generator tests with generated names in
  the mix, the scenario event table, the ``scenario`` CLI and ``verify``
  listing registered scenarios. The spawn/goal layout twins, the mixed
  dynamics tests and the antipodal margins live in other
  ``test_torch_*`` files already.
- Parity: ``generate`` equal to JAX's (``dataclasses.asdict``) for several
  seeds, count 20 included, ``to_config`` field for field, ``run_spec``
  against JAX's ``run_spec`` in float64 on three generated specs (the
  pinned mixed spec 3, one with obstacles, one with RTA) with their
  ``scenario.run`` payloads, and ``scenario gen`` printing the same JSON
  in both CLIs.

The scenario registry is process-wide: every test that enrolls restores
both packages' ``_REGISTRY`` afterwards (the ``registries`` fixture), so
later tests on the same worker see the builtins only.
"""

import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.__main__ import main as jmain
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.scenarios.platform import dsl as jdsl
from cbf_tpu.scenarios.platform import registry as jregistry
from cbf_tpu_torch.__main__ import main
from cbf_tpu_torch.obs import schema
from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.scenarios.platform import dsl, registry
from cbf_tpu_torch.serve import buckets as serve_buckets
from cbf_tpu_torch.serve import loadgen
from cbf_tpu_torch.verify import (PROPERTY_NAMES, SearchSettings,
                                  properties, search)

shrink_mod = importlib.import_module("cbf_tpu_torch.verify.shrink")

SMALL = SearchSettings(budget=16, batch=8, seed=0)
# float64 rollouts of the two packages: the same operations in other
# summation orders (the falsifier's corpus bound, tests/test_torch_verify.py).
RUN_ATOL = 1e-9
# The recorded minimum distance: the port's "auto" gating reads it from
# the k-NN kernel's float32 squared distances (its plain version on the
# CPU), the JAX package's CPU path from its float64 distance matrix;
# measured 1.0e-7 at most over the three specs below.
MD_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def registries(monkeypatch):
    """Both packages' scenario registries for one test: each package's
    ``_REGISTRY`` dict is swapped for a copy of its builtin entries (a
    JAX-package test on this worker may have enrolled generated ones and
    left them), and the original dicts come back afterwards, so whatever
    the test enrolls leaves with it."""
    for reg in (registry, jregistry):
        monkeypatch.setattr(reg, "_REGISTRY", {
            e.name: e for e in reg._REGISTRY.values() if not e.generated})
    yield registry


def _enrolled(seed, count):
    specs = dsl.generate(seed, count=count)
    dsl.enroll(specs, replace=True)
    return specs


def _record(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ------------------------------------------------------------- parity

@pytest.mark.parametrize("seed,count", [(0, 20), (1, 5), (7, 20),
                                        (123, 3), (2 ** 31 - 1, 20)])
def test_generate_equals_jax(seed, count):
    got = dsl.generate(seed, count=count)
    want = jdsl.generate(seed, count=count)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    for t, j in zip(got, want):
        tc, jc = t.to_config(), j.to_config()
        for f in dataclasses.fields(tc):
            tv, jv = getattr(tc, f.name), getattr(jc, f.name)
            if f.name == "dtype":
                assert str(tv).rsplit(".", 1)[-1] == jnp.dtype(jv).name
            else:
                assert tv == jv, (t.name, f.name)
        assert {f.name for f in dataclasses.fields(tc)} == \
            {f.name for f in dataclasses.fields(jc)}


class _Sink:
    def __init__(self):
        self.events = []

    def event(self, kind, payload):
        self.events.append((kind, dict(payload)))


def _pick(what):
    """The pinned mixed spec 3 and the first RTA spec of generate(0, 20);
    that batch draws no obstacle field, generate(9, 20) is the first seed
    whose batch does (an orbiting ring of 3 beside 16 agents)."""
    if what == "obstacles":
        return next(s for s in dsl.generate(9, count=20) if s.n_obstacles)
    specs = dsl.generate(0, count=20)
    if what == "mixed":
        return specs[3]
    return next(s for s in specs if s.rta and s.dynamics != "mixed")


@pytest.mark.parametrize("what", ["mixed", "obstacles", "rta"])
def test_run_spec_matches_jax_float64(what, x64):
    """``run_spec`` on the port against the JAX package's on the same
    generated spec (horizon cut to 60), both in float64: the final
    positions within RUN_ATOL, the recorded minimum distances within
    MD_ATOL, the counts exact, and the ``scenario.run`` payloads equal
    but for the minimum distance (MD_ATOL)."""
    spec = _pick(what)
    assert (what != "obstacles" or spec.n_obstacles) and \
        (what != "rta" or spec.rta)
    jsink, tsink = _Sink(), _Sink()
    jfinal, jouts = jdsl.run_spec(spec, telemetry=jsink, steps=60,
                                  dtype=jnp.float64)
    tfinal, touts = dsl.run_spec(spec, telemetry=tsink, device="cpu",
                                 steps=60, dtype=torch.float64)
    np.testing.assert_allclose(touts.min_pairwise_distance.numpy(),
                               np.asarray(jouts.min_pairwise_distance),
                               rtol=0, atol=MD_ATOL)
    np.testing.assert_allclose(tfinal.x.numpy(), np.asarray(jfinal.x),
                               rtol=0, atol=RUN_ATOL)
    np.testing.assert_array_equal(touts.infeasible_count.numpy(),
                                  np.asarray(jouts.infeasible_count))
    (jk, jp), = jsink.events
    (tk, tp), = tsink.events
    assert tk == jk == "scenario.run"
    md_t, md_j = tp.pop("min_pairwise_distance"), \
        jp.pop("min_pairwise_distance")
    assert tp == jp and abs(md_t - md_j) <= MD_ATOL
    assert set(tp) | {"min_pairwise_distance"} == set(
        schema.SCENARIO_EVENT_FIELDS["scenario.run"])


def test_cli_scenario_gen_prints_the_same_json(capsys, registries):
    assert main(["scenario", "gen", "--seed", "0", "--count", "4",
                 "--device", "cpu"]) == 0
    got = _record(capsys)
    assert jmain(["scenario", "gen", "--seed", "0", "--count", "4",
                  "--platform", "cpu"]) == 0
    assert got == _record(capsys)


def test_scenario_events_match_schema():
    from cbf_tpu.obs import schema as jschema

    assert tuple(dsl.EMITTED_EVENT_TYPES) == \
        tuple(schema.SCENARIO_EVENT_TYPES) == jschema.SCENARIO_EVENT_TYPES
    assert schema.SCENARIO_EVENT_FIELDS == jschema.SCENARIO_EVENT_FIELDS
    sink = _Sink()
    specs = dsl.generate(4, count=3, telemetry=sink)
    (kind, payload), = sink.events
    assert kind == "scenario.generated"
    assert set(payload) == set(schema.SCENARIO_EVENT_FIELDS[kind])
    assert payload["names"] == [s.name for s in specs]


# ------------------------------------------------------------- registry

def test_registry_roundtrip_determinism(registries):
    a = dsl.generate(7, count=20)
    b = dsl.generate(7, count=20)
    assert a == b
    assert len({s.name for s in a}) == 20
    assert any(s.dynamics == "mixed" for s in a)
    for sa, sb in zip(a, b):
        assert sa.to_config() == sb.to_config()
    dsl.enroll(a, replace=True)
    for s in a:
        e = registry.get(s.name)
        assert e.generated and e.servable and e.adapter == "swarm"
        assert e.module == "cbf_tpu_torch.scenarios.swarm"
        assert e.make_config() == s.to_config()


def test_register_rejects_silent_shadowing(registries):
    spec = dsl.generate(11, count=1)[0]
    dsl.enroll([spec], replace=True)
    with pytest.raises(ValueError, match="already registered"):
        dsl.enroll([spec])
    with pytest.raises(KeyError, match="unknown scenario"):
        registry.get("no-such-scenario")


def test_registries_fixture_restores_both_packages(registries):
    before = (registry.names(), jregistry.names())
    dsl.enroll(dsl.generate(5, count=2), replace=True)
    jdsl.enroll(jdsl.generate(5, count=2), replace=True)
    assert len(registry.names()) == len(before[0]) + 2
    assert len(jregistry.names()) == len(before[1]) + 2


def test_registry_holds_the_builtins_only():
    """Runs after the enrolling tests above: nothing leaked into the
    port's registry."""
    assert registry.names() == ("swarm", "meet_at_center",
                                "cross_and_rescue", "antipodal")


def test_generator_validates_every_spec():
    with pytest.raises(ValueError):
        dsl.generate(0, count=0)
    with pytest.raises(ValueError):
        dsl.ScenarioSpec(name="bad", n=8, dynamics="mixed",
                         n_double=0).to_config()


# ----------------------------------------------------- RTA + serve legs

def test_generated_scenario_rta_soundness(registries):
    specs = _enrolled(0, 20)
    spec = next(s for s in specs if s.rta)
    cfg = dataclasses.replace(spec.to_config(), n=10, n_double=min(
        4, spec.n_double) or 0, steps=50)
    swarm.validate_config(cfg)
    a = search.make_adapter(spec.name, cfg, device="cpu")
    margins = search.make_eval_one(a, SMALL)(
        torch.zeros(a.delta_shape, dtype=cfg.dtype)).numpy()
    i = PROPERTY_NAMES.index("rta_soundness")
    assert margins[i] >= 0 or np.isinf(margins[i])
    assert margins.min() >= 0


def test_bucket_label_scenario_axes():
    from cbf_tpu.serve import buckets as jbuckets

    key, _tr = serve_buckets.bucket_key(
        swarm.Config(n=12, steps=20, gating="jnp"))
    assert key.label() == "n16-t64-single-cert_off-gjnp"
    gcfg = swarm.Config(n=12, steps=20, spawn="ring", goal="coverage",
                        dynamics="mixed", n_double=5)
    key2, _tr2 = serve_buckets.bucket_key(gcfg)
    lab = key2.label()
    assert "-nd5" in lab and "-sp_ring" in lab and "-gl_coverage" in lab
    assert "-ob_" not in lab
    assert key2 != key
    jkey2, _ = jbuckets.bucket_key(jsw.Config(
        n=12, steps=20, spawn="ring", goal="coverage", dynamics="mixed",
        n_double=5))
    assert jkey2.label() == lab


def test_serve_roundtrip_generated_scenario(registries):
    from cbf_tpu_torch.serve import ServeEngine

    spec = dsl.ScenarioSpec(name="serve-mixed", n=9, steps=20,
                            spawn="ring", dynamics="mixed", n_double=3)
    dsl.enroll([spec], replace=True)
    cfg = registry.get("serve-mixed").make_config()
    res = ServeEngine(max_batch=2, bucket_sizes=(16,),
                      device="cpu").run([cfg])[0]
    assert "-nd3" in res.bucket and "-sp_ring" in res.bucket
    assert float(np.min(np.asarray(
        res.outputs.min_pairwise_distance))) > 0.08
    assert int(np.sum(np.asarray(res.outputs.infeasible_count))) == 0


# -------------------------------------------------------------- loadgen

def test_loadgen_default_mix_is_bit_stable():
    """The default single-swarm mix consumes no scenario rng draw: the
    schedule replays the plain rng flow exactly."""
    spec = loadgen.LoadSpec(rps=40.0, duration_s=1.0, seed=7)
    sch = loadgen.schedule_with_scenarios(spec)
    assert all(name == "swarm" for _t, name, _c in sch)
    rng = np.random.default_rng(7)
    t = float(rng.exponential(1.0 / 40.0))
    expect = []
    while t < 1.0:
        n = int(np.clip(round(float(loadgen.bounded_pareto(
            rng, spec.pareto_alpha, spec.n_min, spec.n_max))),
            spec.n_min, spec.n_max))
        steps = int(spec.steps_choices[int(rng.integers(
            len(spec.steps_choices)))])
        sd = 0.4 + 0.003 * int(rng.integers(5))
        cg = 1.0 + 0.01 * int(rng.integers(16))
        expect.append((t, n, steps, sd, cg))
        t += float(rng.exponential(1.0 / 40.0))
    assert len(expect) == len(sch)
    for (t0, n, steps, sd, cg), (t1, _nm, cfg) in zip(expect, sch):
        assert t0 == t1 and cfg.n == n and cfg.steps == steps
        assert cfg.safety_distance == sd and cfg.consensus_gain == cg
    assert loadgen.build_schedule(spec) == [(t, c) for t, _n, c in sch]


def test_loadgen_scenario_mix_validation_and_determinism(registries):
    from cbf_tpu.serve import loadgen as jloadgen

    specs = _enrolled(3, 2)
    jdsl.enroll(jdsl.generate(3, count=2), replace=True)
    mix = (("swarm", 0.6), (specs[0].name, 0.4))
    spec = loadgen.LoadSpec(rps=60.0, duration_s=1.0, seed=1,
                            scenario_mix=mix)
    sch = loadgen.schedule_with_scenarios(spec)
    assert sch == loadgen.schedule_with_scenarios(spec)
    names = {nm for _t, nm, _c in sch}
    assert names == {"swarm", specs[0].name}
    jsch = jloadgen.schedule_with_scenarios(jloadgen.LoadSpec(
        rps=60.0, duration_s=1.0, seed=1, scenario_mix=mix))
    assert [(t, nm, c.n, c.steps, c.spawn, c.goal, c.dynamics, c.n_double)
            for t, nm, c in sch] == \
        [(t, nm, c.n, c.steps, c.spawn, c.goal, c.dynamics, c.n_double)
         for t, nm, c in jsch]
    gcfg = next(c for _t, nm, c in sch if nm == specs[0].name)
    base = specs[0].to_config()
    assert (gcfg.n, gcfg.spawn, gcfg.goal, gcfg.dynamics,
            gcfg.n_double) == (base.n, base.spawn, base.goal,
                               base.dynamics, base.n_double)
    assert gcfg.steps in spec.steps_choices
    with pytest.raises(KeyError):
        loadgen.schedule_with_scenarios(loadgen.LoadSpec(
            rps=1, duration_s=1, scenario_mix=(("nope", 1.0),)))
    with pytest.raises(ValueError, match="not servable"):
        loadgen.schedule_with_scenarios(loadgen.LoadSpec(
            rps=1, duration_s=1, scenario_mix=(("meet_at_center", 1.0),)))
    with pytest.raises(ValueError, match="must be > 0"):
        loadgen.schedule_with_scenarios(loadgen.LoadSpec(
            rps=1, duration_s=1, scenario_mix=(("swarm", 0.0),)))


def test_loadgen_by_scenario_report(registries):
    """A mixed feed's SLO report splits per scenario name: every request
    accounted once, each mix member with its own latency percentiles."""
    from cbf_tpu_torch.serve import ServeEngine

    spec_g = dsl.ScenarioSpec(name="lg-tiny", n=8, steps=20, spawn="ring")
    dsl.enroll([spec_g], replace=True)
    lspec = loadgen.LoadSpec(
        rps=30.0, duration_s=1.0, seed=2, n_min=8, n_max=12,
        steps_choices=(20,), scenario_mix=(("swarm", 0.5),
                                           ("lg-tiny", 0.5)))
    engine = ServeEngine(max_batch=4, bucket_sizes=(16,), device="cpu")
    engine.prewarm([c for _t, c in loadgen.build_schedule(lspec)])
    report = loadgen.run_loadgen(engine, lspec)
    sch = loadgen.schedule_with_scenarios(lspec)
    assert report["completed"] + report["errors"] == len(sch)
    by = report["by_scenario"]
    assert set(by) == {nm for _t, nm, _c in sch}
    for nm, row in by.items():
        want = sum(1 for _t, n2, _c in sch if n2 == nm)
        assert row["completed"] + row["errors"] == want
        if row["completed"]:
            assert row["latency_p99_s"] >= row["latency_p50_s"]
    assert sum(r["completed"] for r in by.values()) == report["completed"]


# ------------------------------------------------------------------ CLI

def test_cli_scenario_list(capsys, registries):
    assert main(["scenario", "list"]) == 0
    rec = _record(capsys)
    names = [r["name"] for r in rec["scenarios"]]
    for nm in ("swarm", "meet_at_center", "cross_and_rescue",
               "antipodal"):
        assert nm in names
    assert jmain(["scenario", "list"]) == 0
    assert _record(capsys) == rec


def test_cli_scenario_gen_deterministic(capsys, registries):
    argv = ["scenario", "gen", "--seed", "9", "--count", "4", "--device",
            "cpu"]
    assert main(argv) == 0
    rec1 = _record(capsys)
    assert main(argv) == 0
    assert rec1 == _record(capsys)
    assert rec1["count"] == 4
    assert rec1["scenarios"][3]["dynamics"] == "mixed"
    assert registry.get(rec1["scenarios"][0]["name"]).generated


def test_cli_scenario_run(capsys, tmp_path, registries):
    from cbf_tpu_torch import obs

    tdir = str(tmp_path / "t")
    assert main(["scenario", "run", "swarm", "--steps", "10", "--set",
                 "n=8", "--telemetry-dir", tdir, "--device", "cpu"]) == 0
    rec = _record(capsys)
    assert rec["scenario"] == "swarm" and rec["steps"] == 10
    assert rec["infeasible_count"] == 0
    events = obs.read_events(rec["telemetry"])
    assert any(e.get("event") == "scenario.run" for e in events)
    # A generated name resolves through --gen-seed; the record is JAX's.
    argv = ["scenario", "run", "gen0-03-clusters-rendezvous-mixed",
            "--gen-seed", "0", "--gen-count", "4", "--steps", "12"]
    assert main([*argv, "--device", "cpu"]) == 0
    got = _record(capsys)
    assert jmain([*argv, "--platform", "cpu"]) == 0
    want = _record(capsys)
    assert got == want


def test_cli_scenario_run_rejects(capsys, registries):
    from cbf_tpu_torch.errors import OutOfSliceError

    assert main(["scenario", "run", "meet_at_center", "--device",
                 "cpu"]) == 2
    assert main(["scenario", "run", "nowhere", "--device", "cpu"]) == 2
    assert main(["scenario", "run", "swarm", "--tiles", "2", "--device",
                 "cpu"]) == 2
    with pytest.raises(OutOfSliceError, match="Queue A10"):
        main(["scenario", "run", "swarm", "--partition", "spatial",
              "--device", "cpu"])


def test_cli_verify_lists_registered_scenarios(registries):
    """The verify parser's scenario choices follow the registry: a
    generated name enrolled in this process is a valid choice."""
    import argparse

    from cbf_tpu_torch import __main__ as cli

    spec = dsl.generate(2, count=1)[0]
    dsl.enroll([spec], replace=True)
    p = argparse.ArgumentParser()
    cli._add_verify_parser(p.add_subparsers(dest="command"))
    assert p.parse_args(["verify", spec.name]).scenario == spec.name
    for nm in ("swarm", "meet_at_center", "cross_and_rescue", "antipodal",
               "fleet"):
        assert p.parse_args(["verify", nm]).scenario == nm
    with pytest.raises(SystemExit):
        p.parse_args(["verify", "gen2-99-not-enrolled"])


# ------------------------------------------------- slow

# slow: ~9 s in the JAX package (tests/test_platform.py marks its own
# slow); the cross-ingredient margin sweep over three generated specs.
@pytest.mark.slow
def test_generated_ingredient_parity(registries):
    """The compiled margins of three generated specs (non-default
    spawn x goal, one mixed) equal the post-hoc NumPy recomputation, and
    each spec is safe at delta = 0."""
    specs = [
        dsl.ScenarioSpec(name="par-ring-coverage", n=10, steps=40,
                         spawn="ring", goal="coverage"),
        dsl.ScenarioSpec(name="par-corridor", n=9, steps=40,
                         spawn="corridor", goal="corridor"),
        dsl.ScenarioSpec(name="par-clusters-mixed", n=10, steps=40,
                         spawn="clusters", goal="formation",
                         dynamics="mixed", n_double=4),
    ]
    dsl.enroll(specs, replace=True)
    for spec in specs:
        cfg = dataclasses.replace(spec.to_config(), record_trajectory=True)
        a = search.make_adapter(spec.name, cfg, device="cpu")
        zero = torch.zeros(a.delta_shape, dtype=cfg.dtype)
        margins = search.make_eval_batch(a, SMALL)(zero[None])[0].numpy()
        final, outs = shrink_mod._record(a, SMALL, zero)
        m_np = properties.rollout_margins_np(
            a.thresholds, outs, final.x.numpy(),
            trajectory=outs.trajectory.numpy(),
            obstacle_fn_np=a.obstacle_fn_np)
        for i, name in enumerate(PROPERTY_NAMES):
            if np.isinf(margins[i]):
                assert np.isinf(m_np[name]), (spec.name, name)
                continue
            np.testing.assert_allclose(margins[i], m_np[name], atol=1e-5,
                                       err_msg=f"{spec.name}:{name}")
        assert margins.min() >= 0, (spec.name, margins)


# -------------------------------------------- chip_smoke.py's constants

def test_chip_smoke_dsl_specs_are_the_jax_packages():
    """``chip_smoke.py`` phase 21a holds the card's generator batch to
    ``DSL_SPECS_SHA256``: the digest of the JAX package's specs."""
    import hashlib

    import chip_smoke

    specs = jdsl.generate(chip_smoke.DSL_SEED, count=chip_smoke.DSL_COUNT)
    blob = json.dumps([dataclasses.asdict(s) for s in specs],
                      sort_keys=True)
    assert hashlib.sha256(blob.encode()).hexdigest() == \
        chip_smoke.DSL_SPECS_SHA256
    assert sorted(chip_smoke.DSL_REFERENCE) == list(range(len(specs)))


# slow: ~50 s, twenty JAX compiles; the same runs as phase 21a's card runs.
@pytest.mark.slow
def test_chip_smoke_dsl_minima_are_the_references():
    """``chip_smoke.DSL_REFERENCE`` is the JAX package's run of each spec
    on the CPU (float32, its own gating): minimum distance and
    infeasible count."""
    import chip_smoke

    specs = jdsl.generate(chip_smoke.DSL_SEED, count=chip_smoke.DSL_COUNT)
    for i, spec in enumerate(specs):
        _final, outs = jdsl.run_spec(spec)
        got = (float(np.min(np.asarray(outs.min_pairwise_distance))),
               int(np.sum(np.asarray(outs.infeasible_count))))
        assert got == chip_smoke.DSL_REFERENCE[i], (spec.name, got)
