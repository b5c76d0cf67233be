"""Whole runs of the harness on the CPU at a test's size: a sound run is
correct, and each fault planted under the timed path makes ``correct``
false; the harness refuses to run without a card, and without the port;
a rehearsal run leaves no module of JAX or of the JAX package loaded."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench import common, run
from port_bench.tests.small import small

CELLS = [w["name"] for w in common.benchmark()["workloads"]]
SHIFT = 5e-3          # metres: one agent's answer altered where produced


def _run(cell_name, hook=None, seconds=0.5):
    cell, config = small(cell_name)
    return run.run_cell(cell_name, 20231, seconds, False, device="cpu",
                        cell=cell, config=config, traffic_hook=hook)


def _episodes_fault(kind):
    def hook(runner):
        from cbf_tpu_torch.rollout import engine

        step = runner.step

        def broken(state, t, inputs=None):
            new, out = step(state, t)
            n = new.x.shape[0]
            if kind == "unchanged":
                return state, out
            if kind == "nan":
                x = new.x.clone()
                x[0, 0] = float("nan")
                return new._replace(x=x), out
            if kind == "half":
                x = torch.cat([new.x[: n // 2], state.x[n // 2:]])
            else:
                x = new.x.clone()
                x[0, 0] += SHIFT
            return new._replace(x=x), out

        runner.step = engine.forward_attributes(broken, step)
    return hook


def _sweep_fault(kind):
    def hook(runner):
        segment = runner._segment

        def broken(state, steps, t0):
            (x, v), mets = segment(state, steps, t0)
            E = x.shape[0]
            if kind == "unchanged":
                x = state[0]
            elif kind == "half":
                x = torch.cat([x[: E // 2], state[0][E // 2:]])
            elif kind == "nan":
                x = x.clone()
                x[0, 0, 0] = float("nan")
            else:
                # A member's answer altered: no agent reported engaged.
                mets.engaged_count[0, -1] = 0
            return (x, v), mets

        runner._segment = broken
    return hook


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct(cell_name):
    result = _run(cell_name)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"agent_steps_per_s", "setup_s"}
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "nan"])
@pytest.mark.parametrize("cell_name", CELLS)
def test_planted_fault_is_caught(cell_name, fault):
    kind = common.workload(cell_name)["kind"]
    hook = (_episodes_fault if kind == "episodes" else _sweep_fault)(fault)
    result = _run(cell_name, hook)
    assert not result["correct"], result["compared"]
    assert result["failed"] >= 1


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "port_bench", "--workload",
         "swarm4096.filter", "--seed", "2147483711", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env, check=False)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _cli(common.ROOT, env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_refuses_without_the_port(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder runs nothing."""
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _cli(tmp_path, env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_rehearsal_loads_no_jax():
    """A whole rehearsal run in a fresh interpreter, then its modules."""
    code = (
        "import sys, json\n"
        "from port_bench import run, common\n"
        "from port_bench.tests.small import small\n"
        "cell, config = small('swarm4096.certified')\n"
        "r = run.run_cell(cell['name'], 5, 0.3, True, device='cpu',\n"
        "                 cell=cell, config=config)\n"
        "print(json.dumps([r['correct'],\n"
        "                  common.forbidden_modules(sys.modules),\n"
        "                  'cbf_tpu_torch' in sys.modules]))\n")
    env = dict(os.environ, PYTHONPATH=common.ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=env, check=False)
    assert proc.returncode == 0, proc.stderr[-2000:]
    correct, found, port = json.loads(proc.stdout.strip().splitlines()[-1])
    assert correct and port and found == []


@pytest.mark.card
def test_cell_on_the_card(card):
    """A short run of each cell on the card is correct (run with
    ``python -m pytest port_bench/tests -q -m card`` there)."""
    for name in CELLS:
        result = run.run_cell(name, 7, 2.0, False, device="cuda")
        assert result["correct"], (name, result["compared"])
