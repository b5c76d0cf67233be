"""The port's load generator (cbf_tpu_torch.serve.loadgen), metrics
exporter (cbf_tpu_torch.obs.export) and ``obs top``, on the CPU.

- ``build_schedule``/``schedule_with_scenarios`` equal to the JAX
  package's for three specs (one with three horizons): every arrival time
  exactly, every config field for field.
- tests/test_trace.py:218-277 on the port: the schedule is seeded and
  bounded, ``run_loadgen`` reports the SLO split and emits one
  ``loadgen.summary``, the ``loadgen`` CLI writes the Chrome trace.
- tests/test_obs_resource.py:188 and :348-400 on the port: a loadgen run
  prices every bucket it served, the Prometheus text parses, the exporter
  flushes atomically and survives a throwing ``extra_fn``.
- ``render_prom`` and ``write_metrics`` byte-equal to JAX's for one
  registry filled with the same observations; the event tables equal
  JAX's.
- tests/test_cli.py:220-264 and :302-318 on the port: ``obs top``
  renders and resolves ``--latest``, exits 2 on a missing surface and 3
  on a stall; ``loadgen --metrics-dir`` writes both surfaces. ``obs top``
  (and ``--merge``) renders equal text from a ``metrics.json`` written by
  either package, in either package's CLI.
"""

import dataclasses
import json
import os
import re
import time

import jax.numpy as jnp
import pytest
import torch

from cbf_tpu.__main__ import main as jcli_main
from cbf_tpu.obs import export as jexport
from cbf_tpu.obs import schema as jschema
from cbf_tpu.obs.sink import MetricsRegistry as JMetricsRegistry
from cbf_tpu.serve import loadgen as jloadgen
from cbf_tpu_torch import obs
from cbf_tpu_torch.__main__ import main as cli_main
from cbf_tpu_torch.obs import export as obs_export
from cbf_tpu_torch.obs import lanes as obs_lanes
from cbf_tpu_torch.obs import resource as obs_resource
from cbf_tpu_torch.obs import schema as obs_schema
from cbf_tpu_torch.obs.sink import MetricsRegistry
from cbf_tpu_torch.obs.trace import Tracer
from cbf_tpu_torch.serve import (LoadSpec, ServeEngine, build_schedule,
                                 run_loadgen)
from cbf_tpu_torch.serve import loadgen
from cbf_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the schedule against the JAX package -----------------------------------

SPECS = [
    dict(),
    dict(rps=40.0, duration_s=2.0, seed=3, n_min=8, n_max=32),
    dict(rps=24.0, duration_s=3.0, seed=0, n_min=64, n_max=128,
         steps_choices=(128, 256, 512), gating="pallas"),
]


def _same_config(t, j) -> None:
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if f.name == "dtype":
            assert str(tv).rsplit(".", 1)[-1] == jnp.dtype(jv).name
        else:
            assert tv == jv, f.name
    assert {f.name for f in dataclasses.fields(t)} == \
        {f.name for f in dataclasses.fields(j)}


@pytest.mark.parametrize("fields", SPECS)
def test_schedule_equals_jax(fields):
    got = loadgen.schedule_with_scenarios(LoadSpec(**fields))
    want = jloadgen.schedule_with_scenarios(jloadgen.LoadSpec(**fields))
    assert len(got) == len(want) > 0
    for (t, name, cfg), (jt, jname, jcfg) in zip(got, want):
        assert t == jt and name == jname
        _same_config(cfg, jcfg)
    assert [t for t, _ in build_schedule(LoadSpec(**fields))] == \
        [t for t, _, _ in want]


def test_bounded_pareto_equals_jax():
    import numpy as np

    a = loadgen.bounded_pareto(np.random.default_rng(5), 1.3, 8, 96, 64)
    b = jloadgen.bounded_pareto(np.random.default_rng(5), 1.3, 8, 96, 64)
    assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        loadgen.bounded_pareto(np.random.default_rng(5), 1.3, 9, 8)


def test_scenario_mix_validated():
    with pytest.raises(ValueError, match="not servable"):
        build_schedule(LoadSpec(scenario_mix=(("antipodal", 1.0),)))
    with pytest.raises(ValueError, match="> 0"):
        build_schedule(LoadSpec(scenario_mix=(("swarm", 0.0),)))
    with pytest.raises(KeyError):
        build_schedule(LoadSpec(scenario_mix=(("nowhere", 1.0),)))


def test_event_tables_equal_jax():
    assert obs_schema.LOADGEN_EVENT_TYPES == jschema.LOADGEN_EVENT_TYPES
    assert obs_schema.LOADGEN_EVENT_FIELDS == jschema.LOADGEN_EVENT_FIELDS
    assert obs_schema.LANES_EVENT_TYPES == jschema.LANES_EVENT_TYPES
    assert obs_schema.LANES_EVENT_FIELDS == jschema.LANES_EVENT_FIELDS
    assert loadgen.EMITTED_EVENT_TYPES == obs_schema.LOADGEN_EVENT_TYPES
    assert obs_lanes.EMITTED_EVENT_TYPES == obs_schema.LANES_EVENT_TYPES


# -- tests/test_trace.py:218-277 ---------------------------------------------

def test_loadgen_schedule_seeded_and_bounded():
    spec = LoadSpec(rps=40.0, duration_s=2.0, seed=3, n_min=8, n_max=32)
    sched = build_schedule(spec)
    assert sched == build_schedule(spec)
    assert sched != build_schedule(dataclasses.replace(spec, seed=4))
    arrivals = [t for t, _ in sched]
    assert arrivals == sorted(arrivals)
    assert all(0 <= t < spec.duration_s for t in arrivals)
    sizes = [cfg.n for _, cfg in sched]
    assert all(spec.n_min <= n <= spec.n_max for n in sizes)
    assert sum(n <= 16 for n in sizes) > sum(n > 16 for n in sizes)
    assert all(cfg.steps in spec.steps_choices for _, cfg in sched)
    with pytest.raises(ValueError):
        build_schedule(dataclasses.replace(spec, rps=0.0))


def test_loadgen_run_reports_slo_and_emits_summary(tmp_path):
    sink = obs.TelemetrySink(str(tmp_path / "run"))
    spec = LoadSpec(rps=30.0, duration_s=0.4, seed=0, n_min=8, n_max=16,
                    steps_choices=(8,))
    engine = ServeEngine(max_batch=8, bucket_sizes=(16,), device="cpu")
    engine.prewarm([cfg for _, cfg in build_schedule(spec)])
    report = run_loadgen(engine, spec, telemetry=sink)
    sink.close()
    assert report["completed"] == report["requests"] > 0
    assert report["errors"] == 0
    assert report["achieved_rps"] > 0
    assert (report["latency_p50_s"] <= report["latency_p95_s"]
            <= report["latency_p99_s"] <= report["latency_max_s"])
    assert report["queue_wait_p50_s"] >= 0
    assert report["execute_p50_s"] > 0
    assert report["min_pairwise_distance"] > 0.1
    assert report["lanes"] is None            # drain mode: no ledger
    assert not engine._running                # started here, stopped here
    summaries = [e for e in obs.read_events(str(tmp_path / "run"))
                 if e["event"] == "loadgen.summary"]
    assert len(summaries) == 1
    assert set(summaries[0]) - {"event", "schema", "t_wall"} == set(
        obs_schema.LOADGEN_EVENT_FIELDS["loadgen.summary"])


def test_loadgen_cli(tmp_path, capsys):
    rc = cli_main(["loadgen", "--device", "cpu", "--rps", "30",
                   "--duration", "0.3", "--n-min", "8", "--n-max", "16",
                   "--steps", "8", "--seed", "1",
                   "--chrome-trace", str(tmp_path / "spans.json"),
                   "--xla-trace", str(tmp_path / "prof")])
    assert rc == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["completed"] == record["requests"] > 0
    assert record["latency_p99_s"] >= record["latency_p50_s"]
    assert record["buckets"]
    with open(tmp_path / "spans.json") as fh:
        assert json.load(fh)["traceEvents"]
    # --xla-trace: the torch.profiler trace of the run.
    assert record["xla_trace"] == str(tmp_path / "prof")
    with open(tmp_path / "prof" / profiling.TRACE_NAME) as fh:
        assert json.load(fh)["traceEvents"]


# -- tests/test_obs_resource.py:188, :348-400 --------------------------------

def test_loadgen_prices_every_bucket_and_reports_slo_split():
    """A loadgen run leaves a cost-model entry for every bucket its
    report saw, with the per-bucket SLO split populated. On the CPU the
    port measures the argument bytes and no peak (``peak_bytes`` is the
    card's), and the drift is held finite rather than to JAX's median
    bound: CPU walls under parallel test workers are not the card's."""
    spec = LoadSpec(rps=24.0, duration_s=0.8, seed=3, n_min=8, n_max=24,
                    steps_choices=(8,))
    model = obs_resource.CostModel()
    engine = ServeEngine(max_batch=8, bucket_sizes=(16, 32),
                         horizon_quantum=8, flush_deadline_s=0.05,
                         tracer=Tracer(enabled=False), cost_model=model,
                         device="cpu")
    engine.prewarm([cfg for _, cfg in build_schedule(spec)])
    report = run_loadgen(engine, spec)
    assert report["errors"] == 0 and report["completed"] >= 2
    assert report["by_bucket"]
    for label, row in report["by_bucket"].items():
        assert row["completed"] + row["errors"] >= 1
        if row["completed"]:
            assert row["execute_p50_s"] > 0
            assert row["queue_wait_p99_s"] >= row["queue_wait_p50_s"]
        entry = model.entries[label]
        assert entry["cost"]["argument_bytes"] > 0
        assert entry["cost"]["peak_bytes"] is None
        assert entry["executes"] >= 1
    for label, med in model.drift_summary().items():
        assert med >= 0.0 and med == med, label


_PROM_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*='
    r'"[^"]*")*\})?'
    r" (NaN|[-+]?[0-9.eE+-]+)$")
_PROM_TYPE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (counter|gauge|summary)$")


def _parse_prom(text: str) -> tuple[dict[str, str], dict[str, float]]:
    """Minimal Prometheus text-format parser: {family: type} and
    {sample key: value}. Raises on any malformed line or duplicate."""
    families: dict[str, str] = {}
    samples: dict[str, float] = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        mt = _PROM_TYPE.match(line)
        if mt:
            assert mt.group(1) not in families, f"re-TYPE'd {line!r}"
            families[mt.group(1)] = mt.group(2)
            continue
        ms = _PROM_SAMPLE.match(line)
        assert ms, f"malformed sample line {line!r}"
        key = line.rsplit(" ", 1)[0]
        assert key not in samples, f"duplicate sample {key!r}"
        samples[key] = (float("nan") if ms.group(4) == "NaN"
                        else float(ms.group(4)))
    return families, samples


def _loaded_registry(cls=MetricsRegistry):
    reg = cls()
    reg.counter("requests").add(5)
    reg.gauge("queue_depth").set(3)
    for v in (0.01, 0.02, 0.04, 0.08):
        reg.histogram("latency[n16-t8]").observe(v)
        reg.histogram("latency[n32-t8]").observe(v * 2)
    # The heartbeat-tap shape: a gauge and a histogram on one base name.
    reg.gauge("min_dist").set(0.14)
    reg.histogram("min_dist").observe(0.14)
    reg.counter('weird "name"[bucket\\x]').add(1)
    reg.histogram("empty")
    return reg


def test_render_prom_parses_under_minimal_parser():
    out = obs_export.render_prom(_loaded_registry().snapshot())
    families, samples = _parse_prom(out)
    assert families["cbf_requests"] == "counter"
    assert families["cbf_queue_depth"] == "gauge"
    assert families["cbf_latency"] == "summary"
    assert samples["cbf_requests"] == 5.0
    assert 'cbf_latency{quantile="0.5",bucket="n16-t8"}' in samples
    assert 'cbf_latency_count{bucket="n32-t8"}' in samples
    assert families["cbf_min_dist"] == "gauge"
    assert families["cbf_min_dist_hist"] == "summary"


@pytest.mark.parametrize("name,want", [
    ("lat[n16-t8]", ("lat", "n16-t8")), ("plain", ("plain", None)),
    ("a[b[c]", ("a", "b[c"))])
def test_split_bucket(name, want):
    assert obs_export.split_bucket(name) == want == jexport.split_bucket(name)


def test_write_metrics_and_exporter_flush(tmp_path):
    reg = _loaded_registry()
    out = str(tmp_path / "m")
    doc = obs_export.write_metrics(out, reg, extra={"queue": 3})
    assert doc["extra"]["queue"] == 3
    ondisk = json.load(open(os.path.join(out, obs_export.JSON_FILENAME)))
    assert ondisk["metrics"]["requests"]["total"] == 5.0
    _parse_prom(open(os.path.join(out, obs_export.PROM_FILENAME)).read())
    assert not [p for p in os.listdir(out) if ".tmp" in p]   # atomic

    exporter = obs_export.MetricsExporter(reg, out, every_s=60.0,
                                          extra_fn=lambda: {"live": 1})
    exporter.start()
    exporter.stop()                          # start-write + final flush
    assert exporter.writes >= 2 and exporter.write_failures == 0
    ondisk = json.load(open(os.path.join(out, obs_export.JSON_FILENAME)))
    assert ondisk["extra"]["live"] == 1
    with pytest.raises(ValueError):
        obs_export.MetricsExporter(reg, out, every_s=0)


def test_exporter_survives_throwing_extra_fn(tmp_path):
    def boom():
        raise RuntimeError("extra_fn bug")

    exporter = obs_export.MetricsExporter(
        MetricsRegistry(), str(tmp_path), every_s=60.0, extra_fn=boom)
    assert exporter.write_once()
    doc = json.load(open(os.path.join(str(tmp_path),
                                      obs_export.JSON_FILENAME)))
    assert doc["extra"] == {}


def test_render_and_write_metrics_byte_equal_to_jax(tmp_path, monkeypatch):
    reg, jreg = _loaded_registry(), _loaded_registry(JMetricsRegistry)
    assert reg.snapshot() == jreg.snapshot()
    assert obs_export.render_prom(reg.snapshot()) == \
        jexport.render_prom(jreg.snapshot())
    monkeypatch.setattr(time, "time", lambda: 1234.5678901)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    extra = {"stats": {"requests": 3}, "queue_depth": 1}
    obs_export.write_metrics(port_dir, reg, extra=extra)
    jexport.write_metrics(jax_dir, jreg, extra=extra)
    for name in (obs_export.PROM_FILENAME, obs_export.JSON_FILENAME):
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    obs_export.write_health(port_dir, {"role": "primary", "epoch": 2})
    jexport.write_health(jax_dir, {"role": "primary", "epoch": 2})
    with open(os.path.join(port_dir, obs_export.HEALTH_FILENAME)) as a, \
            open(os.path.join(jax_dir, jexport.HEALTH_FILENAME)) as b:
        assert a.read() == b.read()


# -- tests/test_cli.py:220-264, :302-318 -------------------------------------

def _metrics_dir(tmp_path, name="m", write=obs_export.write_metrics,
                 cls=MetricsRegistry):
    """A populated metrics surface, as the exporter writes it."""
    reg = cls()
    reg.counter("requests").add(3)
    reg.histogram("execute_s[n16-t8]").observe(0.02)
    reg.gauge("queue_depth").set(2)
    out = str(tmp_path / name)
    write(out, reg, extra={"queue_depth": 1})
    return out


def test_obs_top_renders_surface_and_resolves_latest(tmp_path, capsys):
    out = _metrics_dir(tmp_path)
    assert cli_main(["obs", "top", out]) == 0
    text = capsys.readouterr().out
    assert "requests" in text and "queue_depth" in text
    assert "n16-t8" in text
    assert cli_main(["obs", "top", str(tmp_path), "--latest"]) == 0
    assert "requests" in capsys.readouterr().out


def test_obs_top_exit_codes(tmp_path, capsys):
    missing = str(tmp_path / "nowhere")
    assert cli_main(["obs", "top", missing]) == 2
    assert "obs top" in capsys.readouterr().err
    assert cli_main(["obs", "top", str(tmp_path), "--latest"]) == 2
    capsys.readouterr()
    assert cli_main(["obs", "top"]) == 2
    capsys.readouterr()
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert cli_main(["obs", "top", empty, "--follow", "--every", "0.05",
                     "--stall-timeout", "0.2"]) == 3
    assert json.loads(capsys.readouterr().out)["kind"] == "stall"
    out = _metrics_dir(tmp_path)
    stale = time.time() - 60
    os.utime(os.path.join(out, "metrics.json"), (stale, stale))
    assert cli_main(["obs", "top", out, "--follow",
                     "--stall-timeout", "5"]) == 3
    assert json.loads(capsys.readouterr().out)["kind"] == "stall"


def test_loadgen_metrics_dir_writes_both_surfaces(tmp_path, capsys):
    out = str(tmp_path / "metrics")
    assert cli_main(["loadgen", "--device", "cpu", "--rps", "20",
                     "--duration", "0.5", "--n-min", "8", "--n-max", "16",
                     "--steps", "8", "--flush-deadline", "0.05",
                     "--metrics-dir", out, "--metrics-every", "0.2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metrics_dir"] == out
    assert rec["errors"] == 0 and rec["by_bucket"]
    for fname in ("metrics.prom", "metrics.json"):
        assert os.path.isfile(os.path.join(out, fname)), fname
    doc = json.load(open(os.path.join(out, "metrics.json")))
    assert doc["metrics"]
    assert doc["extra"]["stats"]["requests"] == rec["completed"]


def _strip_header(text: str) -> str:
    """The rendered table without its ``== ... age=`` header line (the
    age is the file's, not the table's)."""
    return "\n".join(line for line in text.splitlines()
                     if not line.startswith("== "))


@pytest.mark.parametrize("merge", [False, True])
def test_obs_top_renders_equal_text_across_packages(tmp_path, capsys,
                                                    merge):
    port_dir = _metrics_dir(tmp_path, "port")
    jax_dir = _metrics_dir(tmp_path, "jax", jexport.write_metrics,
                           JMetricsRegistry)
    texts = []
    for run in (cli_main, jcli_main):
        if merge:
            assert run(["obs", "top", "--merge", port_dir, jax_dir]) == 0
            texts.append(_strip_header(capsys.readouterr().out))
            continue
        for d in (port_dir, jax_dir):
            assert run(["obs", "top", d]) == 0
            texts.append(_strip_header(capsys.readouterr().out))
    assert texts[0] and all(t == texts[0] for t in texts), texts
    if merge:
        assert "total=6.0" in texts[0]
