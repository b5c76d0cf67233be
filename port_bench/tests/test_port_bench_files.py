"""The benchmark's files: every cell resolves its configuration, traffic
runner and metric readers by name, and BENCHMARK.json keeps to the
benchmark format's shapes, names and units."""

import ast
import importlib
import json
import os

import pytest

from port_bench import common

BENCH = common.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads",
               "layer", "moves"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = common.workload(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    for key in ("name", "config", "traffic", "chips", "why"):
        assert cell[key] == entry[key]
    config = common.config(cell["config"])
    assert config["name"] == cell["config"]
    module = importlib.import_module(f"port_bench.traffic.{cell['kind']}")
    assert hasattr(module, "Traffic")
    layer = common.cell_metrics(BENCH, name, trace=True)
    e2e = common.cell_metrics(BENCH, name, trace=False)
    assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2
    assert layer
    for m in layer:
        reader = importlib.import_module(f"port_bench.metrics.{m['name']}")
        assert callable(reader.read)
    assert set(cell["limits"]) and all(
        isinstance(v, (int, float)) for v in cell["limits"].values())


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert common.NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(common.ROOT, c["file"]))
        assert c["file"].startswith("port_bench/")
        assert 1 <= len(c["source"]) <= 200 and c["reduced"] == []
        assert common.config(c["name"])["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert common.NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS
        assert common.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    folder = os.path.join(common.BENCH_DIR, "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            tops = {m.split(".")[0]
                    for m in _imports(os.path.join(folder, name))}
            assert not tops & {"cbf_tpu_torch", "cbf_tpu", "jax", "jaxlib",
                               "flax"}, (name, tops)


def test_no_benchmark_file_imports_jax():
    for base, _, files in os.walk(common.BENCH_DIR):
        for name in files:
            if name.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(base, name))}
                assert not tops & set(common.FORBIDDEN_MODULES), name


def test_forbidden_modules_compare_whole_names():
    found = common.forbidden_modules(
        ["cbf_tpu_torch", "cbf_tpu_torch.ops", "cbf_tpu.core", "jax",
         "jaxlib.xla", "jaxtyping", "flax.linen", "torch"])
    assert found == ["cbf_tpu.core", "flax.linen", "jax", "jaxlib.xla"]
