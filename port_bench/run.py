"""Run one cell of the benchmark once and print its result line.

``python3 -m port_bench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout that holds ``BENCHMARK.json``.
A run:

1. finds the cell's file (``workloads/<cell>.json``), its configuration
   (``configs/<config>.json``) and its traffic runner
   (``traffic/<kind>.py``) by name; it refuses to run without a CUDA card
   (or with fewer cards than the cell asks for);
2. set-up: imports the port, builds the program, warms up and captures
   the shapes the cell's traffic uses (``setup_s`` runs from the start of
   the process to here);
3. the window: the runner's traffic for ``--seconds``, timed by the host
   clock around work that ends in a synchronise; the device's memory peak
   is read when it closes;
4. with ``--trace 1``, a short fixed stretch of steady steps under
   ``torch.profiler``, read by each per-layer metric's reader
   (``metrics/<name>.py``);
5. the check: the program's answers in the window against the plain
   reference (``reference/``), each compared number beside its limit (the
   cell's ``limits``); ``correct`` is true when every number is within
   its limit;
6. the result line: ``correct``, ``attempted`` (segments run in the
   window), ``failed`` (compared numbers over their limits), the cell's
   end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace
   1``), the device, and last the compared numbers with their limits,
   which also end standard error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

from port_bench import common

# Build and kernel caches of the program stay inside the checkout, at
# fixed paths, so only a checkout's first run builds.
CACHE_DIR = os.path.join(common.ROOT, ".port_bench_cache")
CACHE_ENV = {"TRITON_CACHE_DIR": "triton",
             "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(torch, device, chips: int, peak: int | None) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": peak or 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": peak}


def power_limit() -> str:
    """The card's name and power limit, from nvidia-smi (or why not)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip() or out.stderr.strip()


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", bench: dict | None = None,
             t_start: float | None = None, traffic_hook=None,
             cell: dict | None = None, config: dict | None = None) -> dict:
    """One run of ``cell_name``; returns the result (the JSON line's
    object). Tests may hand the cell's and the configuration's contents
    (``cell``, ``config``) instead of the files', and ``traffic_hook(
    runner)``, called after set-up, may plant a fault under the timed
    path."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = common.benchmark() if bench is None else bench
    cell = common.workload(cell_name) if cell is None else cell
    config = common.config(cell["config"]) if config is None else config
    dev = torch.device(device)
    runner = common.make_traffic(cell, config, seed, dev)
    runner.setup(trace=trace)
    if traffic_hook is not None:
        traffic_hook(runner)
    setup_s = time.perf_counter() - t_start
    from cbf_tpu_torch.rollout.engine import COUNTS

    before = dict(COUNTS)
    e2e, segments = runner.window(seconds)
    counts = {k: COUNTS[k] - before[k] for k in before}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    wanted = common.cell_metrics(bench, cell_name, trace)
    metrics, extra = {}, {}
    if trace:
        metrics, extra = traced(runner, wanted, dev)
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in wanted:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    runner.release()
    gaps = runner.check()
    limits = cell["limits"]
    compared = {name: {"value": gaps[name], "limit": limits[name]}
                for name in limits}
    failed = sum(1 for c in compared.values()
                 if not c["value"] <= c["limit"])
    result = {"correct": failed == 0, "attempted": segments,
              "failed": failed, "metrics": metrics,
              "device": device_info(torch, dev, cell["chips"], peak)}
    result["device"].update(extra.pop("device", {}))
    result.update(extra)
    # The engine's counts over the window: graph replays and captures,
    # and the segments (and steps) redone eagerly.
    result["program_counts"] = counts
    result["compared"] = compared
    return result


def traced(runner, wanted: list[dict], dev) -> tuple[dict, dict]:
    """The traced stretch and the per-layer readings."""
    from port_bench import trace as tr

    holder = {}

    def profiler_run(fn):
        with tr.profile(dev.type) as prof:
            with tr.stretch_range():
                fn()
        holder["prof"] = prof

    steps, launches, work, context = runner.stretch(profiler_run)
    t = tr.collect(holder["prof"], steps, launches, work, context)
    metrics = {}
    for m in wanted:
        reader = importlib.import_module(
            f"port_bench.metrics.{common.check_name(m['name'])}")
        value = reader.read(t)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    extra = {"device": {"busy_s": t.busy_s, "window_s": t.window_s},
             "breakdown": {"device_ops": t.device_ops(),
                           "idle_gaps": t.idle_gaps()}}
    return metrics, extra


def report(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in result["compared"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"compared {name} {c['value']!r} limit {c['limit']!r} "
              f"{verdict}", file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=True), flush=True)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    cell = common.workload(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"port_bench: the cell asks for {cell['chips']} CUDA "
              f"card(s) and this machine has {have}; it does not run on "
              "the CPU", file=sys.stderr)
        return 3
    print(f"port_bench: {args.workload} seed {args.seed} on "
          f"{power_limit()}", file=sys.stderr, flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    found = common.forbidden_modules(sys.modules)
    if found:
        print(f"port_bench: the process holds {found}: nothing the "
              "benchmark runs may load JAX or the JAX package",
              file=sys.stderr)
        return 4
    report(result)
    return 0
