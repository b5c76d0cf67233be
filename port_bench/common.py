"""What every part of the benchmark shares: where its files are, how a
cell, a configuration and a metric are found by name, and the spawns the
traffic runners draw from the run's seed."""

from __future__ import annotations

import importlib
import json
import math
import os
import re

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# Top-level module names the process may not hold once a run is over: the
# JAX stack and the JAX package the port was made from (compared whole,
# so the port's own name passes).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cbf_tpu")
# Segments every runner runs in set-up: the first captures the program,
# the second replays it, so the window starts on a warm program.
WARM_SEGMENTS = 2


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(*parts) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return load_json(root, "BENCHMARK.json")


def workload(name: str) -> dict:
    """A cell's file, ``workloads/<name>.json``."""
    return load_json(BENCH_DIR, "workloads", check_name(name) + ".json")


def config(name: str) -> dict:
    """A configuration's file, ``configs/<name>.json``."""
    return load_json(BENCH_DIR, "configs", check_name(name) + ".json")


def make_traffic(cell: dict, config: dict, seed: int, device):
    """The cell's traffic runner, ``traffic/<kind>.py``'s ``Traffic``, for
    the cell file's ``kind``. The cell's ``traffic`` names its mix: the
    kind with the cell's ``params``."""
    kind = check_name(cell["kind"])
    module = importlib.import_module(f"port_bench.traffic.{kind}")
    return module.Traffic(cell, config, seed, device)


def forbidden_modules(modules) -> list[str]:
    """The module names among ``modules`` whose top-level name is one of
    :data:`FORBIDDEN_MODULES`."""
    return sorted(m for m in modules
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    metrics that list the cell (or, without a list, move an end-to-end
    metric the cell reports), else its end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def grid_layout(n: int) -> tuple[np.ndarray, float]:
    """The swarm's grid spawn before jitter: (N, 2) points on a square
    grid of half-width max(1.5, 0.2 sqrt(N)), and its spacing."""
    half = max(1.5, 0.2 * math.sqrt(n))
    side = int(math.ceil(math.sqrt(n)))
    lin = np.linspace(-half, half, side)
    gx, gy = np.meshgrid(lin, lin)
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)[:n]
    return grid, 2 * half / max(side - 1, 1)


class Spawner:
    """Grid spawns with a uniform jitter of up to a quarter of the grid
    spacing, drawn on the device from the run's seed: member batches of
    (E, N, 2) or single swarms of (N, 2), float32."""

    def __init__(self, n: int, seed: int, device):
        import torch

        grid, spacing = grid_layout(n)
        self.grid = torch.as_tensor(grid, dtype=torch.float32,
                                    device=device)
        self.jitter = 0.25 * spacing
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))

    def draw(self, members: int | None = None):
        import torch

        shape = ((members,) if members else ()) + tuple(self.grid.shape)
        u = torch.rand(shape, generator=self.gen, dtype=torch.float32,
                       device=self.grid.device)
        return self.grid + (2.0 * u - 1.0) * self.jitter


def program_fields(config: dict, cell: dict) -> dict:
    """The program's ``swarm.Config`` fields of a cell: the configuration
    file's, then the cell's overrides."""
    fields = dict(config["swarm"])
    fields.update(cell.get("params", {}).get("swarm", {}))
    return fields
