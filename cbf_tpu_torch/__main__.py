"""CLI frontend: ``python -m cbf_tpu_torch <command>`` (counterpart:
cbf_tpu/__main__.py, its ``run``, ``list``, ``verify``, ``serve``,
``cluster``, ``loadgen``, ``scenario``, ``obs`` and ``lint`` subcommands).

    python -m cbf_tpu_torch list
    python -m cbf_tpu_torch run meet_at_center --steps 200 --video out.gif
    python -m cbf_tpu_torch run swarm --set n=4096 --steps 200 --traj run.cbt
    python -m cbf_tpu_torch run antipodal --device cpu
    python -m cbf_tpu_torch run swarm --durable-dir runs/d --chunk 500
    python -m cbf_tpu_torch run --resume runs/d
    python -m cbf_tpu_torch run swarm --telemetry-dir runs/t
    python -m cbf_tpu_torch obs summary runs/t
    python -m cbf_tpu_torch verify swarm --set n=16 --weaken dmin=0.16

Scenarios are dataclass configs; ``--set field=value`` overrides any field
(typed by the field's default), ``--steps`` sets whichever field the
scenario calls its horizon (steps/iterations). A run is one compiled
``rollout`` on ``--device`` (default ``cuda``, the card; without one the
run raises — pass ``--device cpu`` for the CPU) and prints one JSON
summary line, as the JAX package's ``run`` does.

``run`` takes the JAX package's durability and observability options:
``--checkpoint-dir`` (chunked, resumable, ``--chunk``/``--no-resume``),
``--durable-dir``/``--resume DIR`` (the crash-recoverable runner,
:mod:`cbf_tpu_torch.durable.rollout`; exit 2 on a missing or corrupt spec
or a config that differs from the directory's), ``--checked`` (the
finiteness-checked rollout), ``--telemetry-dir``/``--telemetry-every``
(heartbeats, alerts and a summary into a run directory, with a watchdog;
``--stall-timeout`` arms its stall alert) and ``--profile-dir`` (a
``torch.profiler`` Chrome trace). ``obs tail`` prints a run directory's
events (``--follow``; ``--stall-timeout`` exits 3 on a silent stream) and
``obs summary`` aggregates one.

``verify`` is the falsification sweep (:mod:`cbf_tpu_torch.verify`): the
engines search for initial-state perturbations that violate a safety
property, a found one is shrunk and confirmed in float64 and, with
``--corpus-dir``, archived. Exit 0: the filter survived the budget; 3: a
violation was found; 2: a persisted campaign does not match the
settings; ``--telemetry-dir`` streams its round and verdict events.
``verify fleet`` runs the falsification fleet (:mod:`cbf_tpu_torch.verify.fleet`)
over every registered scenario, inline or with ``--serve-idle`` as the
background tenant of a local serve engine (exit 3 on a new confirmed
violation, 2 on a ``--state-dir`` campaign run under other settings).
``--mesh-dp D`` above 1 shards the candidates over D ranks: outside a
``torch.distributed`` world the CLI starts D ranks of itself (gloo over a
file store, :mod:`cbf_tpu_torch.parallel.launch`) and prints rank 0's
output; inside one (``torchrun``) it runs in place. Only rank 0 writes.

``scenario`` is the scenario platform (:mod:`cbf_tpu_torch.scenarios.platform`):
``list`` prints the registry, ``gen`` runs the seeded generator (``--run``
also runs every spec) and ``run`` runs one registered scenario end to end
(``--gen-seed`` enrolls a generated batch first; ``--partition spatial
--tiles T`` tiles one swarm over T ranks, started as ``--mesh-dp``'s
are).

``serve`` batch-serves a request file through the serve engine
(:mod:`cbf_tpu_torch.serve.engine`) on ``--device``, with the JAX
package's JSON record and exit codes: ``--prewarm``/``--prewarm-only``
capture every bucket first, ``--journal`` writes the write-ahead request
journal and ``--recover`` re-runs what a killed process left unresolved
(exit 2 on a missing or unreadable journal), ``--telemetry-dir`` writes
the run directory with the cost model and the flight recorder's capsules,
``--pace-s`` submits in queue mode, ``--continuous``/``--chunk`` serve
through the continuous scheduler's lane tables (queue mode),
``--metrics-dir``/``--metrics-every`` rewrite ``metrics.prom`` and
``metrics.json`` while serving, and the fault-policy flags set the
``FaultPolicy``. High availability (:mod:`cbf_tpu_torch.serve.ha`):
``--lease`` serves as the primary (lease, heartbeat, a journal fenced by
the lease; exit 4 once a newer epoch fences it), ``--ha-standby`` watches
the lease and takes over on expiry, ``--supervised`` restarts a crashed
primary (exit 3 on a crash loop). ``cluster serve`` spawns M ``cluster
worker`` processes behind the routed cluster (:mod:`cbf_tpu_torch.cluster`)
and exits 0 iff its exactly-once census is clean. ``loadgen`` drives the
engine with seeded
open-loop traffic (:mod:`cbf_tpu_torch.serve.loadgen`; ``--sweep-rps``
finds the latency knee). ``obs top`` renders a metrics directory
(``--merge``/``--glob`` fold several; exit 2 on a missing surface, 3 on
a stalled one), ``obs lanes`` the lane ledger's occupancy table
(``--export-timeline`` rebuilds the per-lane Perfetto timeline from a
run directory), ``obs incident`` summarises a capsule and ``--replay``
re-runs its request through the port. ``lint`` is the static analysis
gate (:mod:`cbf_tpu_torch.analysis`): the capture-safety and program-cache
rules, ``--all`` adds the program checks on the captured step (on
``--device``), the repo audits and the concurrency analyser; exit 0 clean,
1 findings, 2 an analyser failure or ``--spmd``/``--write-spmd-budget``,
which come with Queue A12b. ``bench`` is not ported yet.

    python -m cbf_tpu_torch serve requests.json --prewarm --journal J
    python -m cbf_tpu_torch serve --journal J --recover
    python -m cbf_tpu_torch obs incident runs/t/capsules --latest --replay
    python -m cbf_tpu_torch serve requests.json --continuous --metrics-dir M
    python -m cbf_tpu_torch obs lanes M
    python -m cbf_tpu_torch loadgen --continuous --gating pallas --rps 16
    python -m cbf_tpu_torch serve --ha-standby --lease L --journal J
    python -m cbf_tpu_torch serve requests.json --lease L --journal J
    python -m cbf_tpu_torch cluster serve requests.json --engines 2
    python -m cbf_tpu_torch scenario run swarm --partition spatial --tiles 4
    python -m cbf_tpu_torch verify fleet --mesh-dp 2 --budget-rounds 1
    python -m cbf_tpu_torch scenario gen --seed 0 --count 20 --run
    python -m cbf_tpu_torch scenario run gen0-03-clusters-rendezvous-mixed --gen-seed 0
    python -m cbf_tpu_torch verify fleet --budget-rounds 2 --serve-idle
    python -m cbf_tpu_torch lint --all --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import torch


# Frames per append when streaming a trajectory to the native sink: keeps
# the sink's copy and queue memory flat while disk writes overlap.
_TRAJ_CHUNK = 1024


def _np(v):
    """A recorded output (a tensor, or numpy from a chunked run) as numpy."""
    import numpy as np

    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _scenarios():
    from cbf_tpu_torch.render import (render_cross_and_rescue,
                                      render_meet_at_center, render_swarm)
    from cbf_tpu_torch.scenarios import (antipodal, cross_and_rescue,
                                         meet_at_center, swarm)

    def _render_swarm(outs, cfg, path, start=0):
        import numpy as np

        obstacles = None
        if getattr(cfg, "n_obstacles", 0):
            # The obstacle field carries no state: rebuild it in phase
            # with the recorded steps.
            T = outs.trajectory.shape[0]
            obstacles = np.stack(
                [swarm.obstacle_positions_at(cfg, start + t)
                 for t in range(T)])
        return render_swarm(_np(outs.trajectory), path,
                            obstacles=obstacles)

    # Last field: the recorded trajectory layout — "dims_major" = (T, 2, N)
    # columns-of-agents (the sim-layer convention), "agent_major" = (T, N, 2).
    return {
        "meet_at_center": (meet_at_center, "iterations",
                           lambda outs, cfg, path, start=0: render_meet_at_center(
                               _np(outs.trajectory), path,
                               n_obstacles=cfg.n_obstacles),
                           "dims_major"),
        "cross_and_rescue": (cross_and_rescue, "iterations",
                             lambda outs, cfg, path, start=0: render_cross_and_rescue(
                                 tuple(_np(v) for v in outs.trajectory),
                                 path, goal=cfg.goal),
                             "dims_major"),
        "swarm": (swarm, "steps", _render_swarm, "agent_major"),
        "antipodal": (antipodal, "steps",
                      lambda outs, cfg, path, start=0: render_swarm(
                          _np(outs.trajectory), path),
                      "agent_major"),
    }


def _apply_overrides(cfg, pairs: list[str], steps: int | None,
                     steps_field: str, need_trajectory: bool):
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    updates = {}
    if steps is not None:
        updates[steps_field] = steps
    for pair in pairs:
        key, _, raw = pair.partition("=")
        if key not in fields:
            raise SystemExit(
                f"unknown config field {key!r}; have {sorted(fields)}")
        current = getattr(cfg, key)
        if isinstance(current, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            val = int(raw)
        elif isinstance(current, float):
            val = float(raw)
        elif isinstance(current, tuple):
            val = tuple(float(x) for x in raw.split(","))
        elif isinstance(current, torch.dtype):
            val = getattr(torch, raw, None)
            if not isinstance(val, torch.dtype):
                raise SystemExit(f"unknown dtype {raw!r} for {key}")
        elif current is None:
            # Optional fields carry no type to infer from: parse literals,
            # so a numeric override does not arrive as a string.
            low = raw.lower()
            if low in ("none", "null"):
                val = None
            elif low in ("true", "false"):
                val = low == "true"
            else:
                try:
                    val = int(raw)
                except ValueError:
                    try:
                        val = float(raw)
                    except ValueError:
                        val = raw
        else:
            val = raw
        updates[key] = val
    # Applied last: --video/--traj need the trajectory regardless of any
    # --set record_trajectory=false (the explicit output request wins).
    if need_trajectory:
        updates["record_trajectory"] = True
    return dataclasses.replace(cfg, **updates)


def _run_durable(args) -> int:
    """``run --durable-dir D`` / ``run --resume D``: the crash-recoverable
    runner. Exit 2 on a missing or corrupt run spec or a scenario/config
    that differs from the directory's."""
    from cbf_tpu_torch.durable import rollout as durable
    from cbf_tpu_torch.utils.debug import summarize

    directory = args.resume or args.durable_dir
    if args.resume and args.durable_dir and \
            os.path.abspath(args.resume) != os.path.abspath(args.durable_dir):
        print("run: --resume and --durable-dir name different directories",
              file=sys.stderr)
        return 2
    scenario = cfg = None
    if args.resume:
        try:
            scenario = durable.load_spec(directory)["scenario"]
        except (FileNotFoundError, ValueError) as e:
            print(f"run: {e}", file=sys.stderr)
            return 2
    else:
        if args.scenario is None:
            print("run: a scenario is required with --durable-dir "
                  "(or use --resume DIR)", file=sys.stderr)
            return 2
        scenario = args.scenario
        module, steps_field, _, _ = _scenarios()[scenario]
        cfg = _apply_overrides(module.Config(), args.set, args.steps,
                               steps_field, need_trajectory=False)

    sink = None
    if args.telemetry_dir:
        from cbf_tpu_torch import obs

        sink = obs.TelemetrySink(
            args.telemetry_dir,
            manifest=obs.build_manifest(cfg, extra={
                "scenario": scenario, "device": args.device,
                "durable_dir": os.path.abspath(directory)}))
    try:
        out = durable.run_durable(
            directory, scenario=None if args.resume else scenario, cfg=cfg,
            chunk=args.chunk, telemetry=sink,
            telemetry_every=args.telemetry_every, device=args.device)
    except (FileNotFoundError, ValueError) as e:
        print(f"run: {e}", file=sys.stderr)
        return 2

    record = {"scenario": scenario,
              "durable_dir": os.path.abspath(directory),
              "steps": out["steps"],
              "resumed_from_step": out["resumed_from_step"],
              "recovery_s": round(out["recovery_s"], 4),
              "corrupt_skipped": out["corrupt_skipped"]}
    if out["outputs"] is not None:
        record.update(summarize(out["outputs"]))
    if sink is not None:
        sink.summary()
        sink.close()
        record["telemetry"] = sink.run_dir
    print(json.dumps(record))
    return 0


def cmd_run(args) -> int:
    if args.resume or args.durable_dir:
        return _run_durable(args)
    if args.scenario is None:
        print("run: a scenario is required (or --resume DIR)",
              file=sys.stderr)
        return 2

    from cbf_tpu_torch.rollout.engine import rollout, rollout_chunked
    from cbf_tpu_torch.utils import profiling
    from cbf_tpu_torch.utils.debug import checked_rollout, summarize

    module, steps_field, renderer, traj_layout = _scenarios()[args.scenario]
    need_traj = args.video is not None or args.traj is not None
    overrides = list(args.set)
    if args.rta:
        # Shorthand; a non-swarm scenario rejects the unknown field with
        # the same message any bad --set gets.
        overrides.append("rta=true")
    cfg = _apply_overrides(module.Config(), overrides, args.steps,
                           steps_field, need_trajectory=need_traj)
    state0, step = module.make(cfg, device=args.device)
    steps = getattr(cfg, steps_field)

    sink = watchdog = None
    if args.telemetry_dir:
        from cbf_tpu_torch import obs

        sink = obs.TelemetrySink(
            args.telemetry_dir,
            manifest=obs.build_manifest(cfg, extra={
                "scenario": args.scenario, "steps": steps,
                "device": args.device}))
        # The event-driven alerts always; the stall thread with a timeout
        # (the first chunk's capture counts toward the first heartbeat).
        watchdog = obs.Watchdog(sink, stall_timeout=args.stall_timeout)

    prof = (profiling.trace(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    try:
        with prof:
            start = 0
            if args.checked:
                final, outs = checked_rollout(
                    step, state0, steps, telemetry=sink,
                    telemetry_every=args.telemetry_every)
            elif args.checkpoint_dir:
                final, outs, start = rollout_chunked(
                    step, state0, steps, chunk=args.chunk,
                    checkpoint_dir=args.checkpoint_dir,
                    resume=not args.no_resume, telemetry=sink,
                    telemetry_every=args.telemetry_every)
            else:
                final, outs = rollout(step, state0, steps, telemetry=sink,
                                      telemetry_every=args.telemetry_every)
    finally:
        if watchdog is not None:
            watchdog.stop()

    record = {"scenario": args.scenario, "config": {
        f.name: repr(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}}
    if outs is not None:
        record.update(summarize(outs))
    if start:
        record["resumed_from_step"] = start
    if sink is not None:
        if outs is not None and not isinstance(
                getattr(outs, "rta_mode", ()), tuple):
            from cbf_tpu_torch.rta.monitor import emit_rta_events

            record["rta"] = emit_rta_events(sink, outs.rta_mode,
                                            step_offset=start)
        sink.summary()
        sink.close()
        record["telemetry"] = sink.run_dir
        record["telemetry_heartbeats"] = sink.heartbeat_count
        record["telemetry_alerts"] = [a.kind for a in watchdog.alerts]
    if args.video and outs is not None:
        record["video"] = renderer(outs, cfg, args.video, start)
    if args.traj and outs is not None:
        record["traj"] = _write_traj(args.traj, outs, traj_layout)
    print(json.dumps(record))
    return 0


def _write_traj(path: str, outs, layout: str) -> str:
    """Stream recorded positions to disk through the native async sink
    (:mod:`cbf_tpu_torch.native.trajsink`) in bounded chunks; a ``.npy``
    without a toolchain. ``layout`` comes from the scenario table."""
    import numpy as np

    from cbf_tpu_torch.native import trajsink

    traj = outs.trajectory
    if isinstance(traj, tuple):          # scenarios recording several layers
        traj = traj[0]
    traj = _np(traj).astype(np.float32)
    if layout == "dims_major":           # (T, dims, N) -> (T, N, dims)
        traj = traj.transpose(0, 2, 1)
    if trajsink.available():
        with trajsink.TrajectorySink(path, n_agents=traj.shape[1],
                                     dims=traj.shape[2]) as sink:
            for t0 in range(0, traj.shape[0], _TRAJ_CHUNK):
                sink.append(traj[t0:t0 + _TRAJ_CHUNK])
        return path
    np.save(path + ".npy", traj)
    return path + ".npy"


def _resolve_run_dir(path: str, latest: bool, *, wait: bool = False) -> str:
    """``--latest``: ``path`` is a root of run directories; pick the one
    with the newest events.jsonl (waiting up to an hour for one with
    ``wait``)."""
    import time

    from cbf_tpu_torch.obs import schema as obs_schema

    if not latest:
        return path
    deadline = time.time() + (3600.0 if wait else 0.0)
    while True:
        candidates = []
        if os.path.isdir(path):
            for d in [os.path.join(path, n) for n in os.listdir(path)
                      ] + [path]:
                ev = os.path.join(d, obs_schema.EVENTS_FILENAME)
                if os.path.isfile(ev):
                    candidates.append((os.path.getmtime(ev), d))
        if candidates:
            return max(candidates)[1]
        if time.time() >= deadline:
            raise SystemExit(
                f"no run directory with {obs_schema.EVENTS_FILENAME} "
                f"under {path}")
        time.sleep(1.0)


def cmd_obs_tail(args) -> int:
    """Print a run's JSONL events, one JSON line each; ``--follow`` tails
    until the summary event; ``--stall-timeout`` turns a silent stream
    into one synthetic stall alert and exit 3."""
    from cbf_tpu_torch.obs.sink import tail_events

    run_dir = _resolve_run_dir(args.run_dir, args.latest, wait=args.follow)
    stalled = False
    for event in tail_events(run_dir, follow=args.follow,
                             stall_timeout=args.stall_timeout):
        print(json.dumps(event), flush=True)
        if event.get("event") == "alert" and event.get("kind") == "stall":
            stalled = True
    return 3 if stalled else 0


def cmd_obs_summary(args) -> int:
    """One aggregate JSON object for a run directory: its summary event,
    else a recomputation from the heartbeats, with the manifest's run
    identity. Exit 1 when the run holds no heartbeat."""
    from cbf_tpu_torch.obs.sink import read_manifest, summarize_run

    run_dir = _resolve_run_dir(args.run_dir, args.latest)
    summary = summarize_run(run_dir)
    manifest = read_manifest(run_dir)
    if manifest is not None:
        summary["manifest"] = {
            k: manifest.get(k) for k in ("created", "git_sha",
                                         "torch_version", "cuda_version",
                                         "topology", "scenario", "steps")
            if k in manifest}
    summary["run_dir"] = os.path.abspath(run_dir)
    print(json.dumps(summary, indent=2))
    return 0 if summary.get("heartbeats") else 1


def _resolve_metrics_dir(path: str, latest: bool) -> str:
    """``--latest``: treat ``path`` as a root holding metrics directories
    and pick the one with the newest metrics.json (the directory itself
    also counts — a root that IS a metrics dir resolves to itself)."""
    from cbf_tpu_torch.obs import export as obs_export

    if not latest:
        return path
    candidates = []
    if os.path.isdir(path):
        for d in [os.path.join(path, n) for n in sorted(os.listdir(path))
                  ] + [path]:
            m = os.path.join(d, obs_export.JSON_FILENAME)
            if os.path.isfile(m):
                candidates.append((os.path.getmtime(m), d))
    if not candidates:
        raise FileNotFoundError(
            f"no {obs_export.JSON_FILENAME} under {path}")
    return max(candidates)[1]


def _render_top(doc: dict) -> str:
    """One metrics.json snapshot as an aligned terminal table."""
    from cbf_tpu_torch.obs.export import split_bucket

    lines = []
    extra = doc.get("extra") or {}
    for k in sorted(extra):
        lines.append(f"{k}: {json.dumps(extra[k], sort_keys=True)}")
    rows = []
    for name, snap in sorted((doc.get("metrics") or {}).items()):
        base, bucket = split_bucket(name)
        kind = snap.get("type", "?")
        if kind == "counter":
            val = f"total={snap.get('total')}"
        elif kind == "gauge":
            val = (f"last={snap.get('last')} min={snap.get('min')} "
                   f"max={snap.get('max')}")
        else:
            val = (f"p50={snap.get('p50')} p95={snap.get('p95')} "
                   f"p99={snap.get('p99')} n={snap.get('samples')}")
        rows.append((base, bucket or "-", kind, val))
    w = max((len(r[0]) for r in rows), default=1)
    wb = max((len(r[1]) for r in rows), default=1)
    for base, bucket, kind, val in rows:
        lines.append(f"{base:<{w}}  {bucket:<{wb}}  {kind:<9}  {val}")
    return "\n".join(lines)


def _obs_top_merge(args) -> int:
    """``obs top --merge DIR... / --glob PATTERN``: fold several
    engines' metrics.json surfaces into ONE table through
    `MetricsRegistry.merge` (counters and histograms add, gauges
    min/max-merge — the same reduction multi-host runs use). The stall
    contract stays per-dir: each dir's metrics.json age is judged
    against --stall-timeout independently, and any stalled dir emits
    its own alert and exits 3 — a merged table must never average away
    one dead engine."""
    import glob as _glob
    import time as _time

    from cbf_tpu_torch.obs import export as obs_export
    from cbf_tpu_torch.obs.sink import MetricsRegistry

    dirs = list(args.merge or [])
    if args.glob:
        dirs.extend(sorted(d for d in _glob.glob(args.glob)
                           if os.path.isdir(d)))
    dirs = list(dict.fromkeys(dirs))      # dedupe, keep order
    if not dirs:
        print("obs top: --merge/--glob matched no directories",
              file=sys.stderr)
        return 2
    t_start = _time.time()
    while True:
        reg = MetricsRegistry()
        ages, missing, stalled = {}, [], []
        for d in dirs:
            path = os.path.join(d, obs_export.JSON_FILENAME)
            if not os.path.isfile(path):
                missing.append(d)
                if args.stall_timeout is not None and \
                        _time.time() - t_start > args.stall_timeout:
                    stalled.append((d, f"{path} never appeared in "
                                       f"{args.stall_timeout}s"))
                continue
            age = _time.time() - os.path.getmtime(path)
            ages[d] = age
            if args.stall_timeout is not None \
                    and age > args.stall_timeout:
                stalled.append((d, f"{path} not rewritten for "
                                   f"{age:.1f}s "
                                   f"(> {args.stall_timeout}s)"))
            try:
                with open(path) as fh:
                    doc = json.load(fh)
            except ValueError:
                continue               # replaced mid-read: next tick
            reg.merge(doc.get("metrics") or {})
        for d, detail in stalled:
            print(json.dumps({"event": "alert", "kind": "stall",
                              "dir": d, "detail": detail}), flush=True)
        if stalled:
            return 3
        if not ages and not args.follow:
            print(f"obs top: no {obs_export.JSON_FILENAME} under any "
                  f"of {dirs}", file=sys.stderr)
            return 2
        if ages:
            head = "  ".join(f"{d} age={ages[d]:.1f}s" for d in ages)
            print(f"== merged {len(ages)}/{len(dirs)} dirs  {head} ==",
                  flush=True)
            print(_render_top({"metrics": reg.snapshot()}), flush=True)
        if not args.follow:
            return 0
        _time.sleep(args.every)


def cmd_obs_top(args) -> int:
    """Live terminal view over the metrics surface: renders the
    metrics.json twin that ``MetricsExporter`` (serve/loadgen
    ``--metrics-dir``) rewrites atomically. --follow re-renders at
    --every cadence; --stall-timeout turns a metrics file that stops
    being rewritten into a synthetic stall alert and exit 3 (mirroring
    ``obs tail``). With --merge/--glob
    the table aggregates MULTIPLE metrics dirs (see
    :func:`_obs_top_merge`)."""
    import time as _time

    from cbf_tpu_torch.obs import export as obs_export

    if getattr(args, "merge", None) or getattr(args, "glob", None):
        return _obs_top_merge(args)
    if args.run_dir is None:
        print("obs top: a run_dir (or --merge/--glob) is required",
              file=sys.stderr)
        return 2
    try:
        mdir = _resolve_metrics_dir(args.run_dir, args.latest)
    except FileNotFoundError as e:
        print(f"obs top: {e}", file=sys.stderr)
        return 2
    path = os.path.join(mdir, obs_export.JSON_FILENAME)
    t_start = _time.time()
    while True:
        if not os.path.isfile(path):
            if not args.follow:
                print(f"obs top: no {obs_export.JSON_FILENAME} in {mdir}",
                      file=sys.stderr)
                return 2
            # --follow waits for the exporter's first write; a bounded
            # wait (--stall-timeout) that expires is the same stall.
            if args.stall_timeout is not None and \
                    _time.time() - t_start > args.stall_timeout:
                print(json.dumps({
                    "event": "alert", "kind": "stall",
                    "detail": f"{path} never appeared in "
                              f"{args.stall_timeout}s"}), flush=True)
                return 3
            _time.sleep(min(args.every, 1.0))
            continue
        age = _time.time() - os.path.getmtime(path)
        if args.stall_timeout is not None and age > args.stall_timeout:
            print(json.dumps({
                "event": "alert", "kind": "stall",
                "detail": f"{path} not rewritten for {age:.1f}s "
                          f"(> {args.stall_timeout}s)"}), flush=True)
            return 3
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except ValueError:
            doc = None                     # replaced mid-read: next tick
        if doc is not None:
            print(f"== {path}  age={age:.1f}s ==", flush=True)
            print(_render_top(doc), flush=True)
        if not args.follow:
            return 0
        _time.sleep(args.every)


def _render_lanes(doc: dict) -> str:
    """One metrics.json snapshot as the lane-occupancy table: a global
    row plus one row per bucket, fed by the ledger's ``serve.lanes.*``
    registry twins."""
    from cbf_tpu_torch.obs.export import split_bucket

    metrics = doc.get("metrics") or {}
    per: dict = {}

    def row(bucket):
        key = bucket if bucket is not None else "(all)"
        return per.setdefault(key, {})

    for name, snap in metrics.items():
        hist = name.endswith(".hist")
        base, bucket = split_bucket(name[:-5] if hist else name)
        if base == "serve.lanes.chunks":
            row(bucket)["chunks"] = int(snap.get("total") or 0)
        elif base == "serve.lanes.occupancy_pct":
            row(bucket)["occ%"] = snap.get("last")
        elif base == "serve.lanes.bubble_pct":
            row(bucket)["bubble%"] = snap.get("last")
        elif base == "serve.lanes.dispatch_pct":
            row(bucket)["disp%"] = snap.get("last")
        elif base == "serve.lanes.joins":
            row(bucket)["joins"] = int(snap.get("total") or 0)
        elif base == "serve.lanes.vacates":
            row(bucket)["vacates"] = int(snap.get("total") or 0)
        elif base == "serve.lanes.preempted":
            row(bucket)["preempted"] = int(snap.get("total") or 0)
        elif base == "serve.lanes.fill":
            row(bucket)["fill_p50"] = snap.get("p50")
        elif base == "serve.lanes.lane_age_s":
            row(bucket)["age_p95_s"] = snap.get("p95")
        elif base == "serve.ttfp_s":
            row(bucket)["ttfp_p99_s"] = snap.get("p99")
    if not per:
        return ("no serve.lanes.* metrics in this snapshot — ledger "
                "disarmed? (ServeEngine arms it when continuous=True "
                "with a telemetry sink, or pass lane_ledger=True)")
    cols = ("chunks", "occ%", "bubble%", "disp%", "joins", "vacates",
            "preempted", "fill_p50", "age_p95_s", "ttfp_p99_s")
    names = sorted(per, key=lambda b: (b != "(all)", b))
    wb = max(len(b) for b in names + ["bucket"])
    lines = ["  ".join(["bucket".ljust(wb)] + [c.rjust(9) for c in cols])]
    for b in names:
        vals = []
        for c in cols:
            v = per[b].get(c)
            vals.append(("-" if v is None else str(v)).rjust(9))
        lines.append("  ".join([b.ljust(wb)] + vals))
    g = per.get("(all)", {})
    for k in ("serve.chunks_executed", "serve.lanes_joined",
              "serve.lanes_vacated"):
        snap = metrics.get(k)
        if snap is not None:
            lines.append(f"{k}: total={int(snap.get('total') or 0)}")
    if g.get("occ%") is not None and g.get("disp%") is not None:
        lines.append(
            f"identity: busy {g.get('occ%')}% + bubble {g.get('bubble%')}% "
            f"+ dispatch {g.get('disp%')}% of lane-time (exact in ns — "
            "see serve.lanes.window events)")
    return "\n".join(lines)


def _export_lane_timeline(run_dir: str, out_path: str) -> int:
    """Rebuild the Perfetto timeline (per-lane tracks + flow links) from
    a run directory's ``serve.span`` events and write it to
    ``out_path``. Exit 2 when the run dir has no event stream."""
    from cbf_tpu_torch.obs import schema as obs_schema
    from cbf_tpu_torch.obs import trace as obs_trace
    from cbf_tpu_torch.obs.sink import read_events

    # read_events tolerates a missing stream (live-tail semantics); a
    # one-shot export over nothing is an operator error instead.
    if not os.path.isfile(os.path.join(run_dir,
                                       obs_schema.EVENTS_FILENAME)):
        print(f"obs lanes: no {obs_schema.EVENTS_FILENAME} in {run_dir}",
              file=sys.stderr)
        return 2
    events = read_events(run_dir)
    spans = [e for e in events if e.get("event") == "serve.span"]
    doc = obs_trace.build_chrome_trace(spans)
    with open(out_path, "w") as fh:
        json.dump(doc, fh)
    print(json.dumps({"timeline": os.path.abspath(out_path),
                      "spans": len(spans),
                      "tracks": len({s.get('track') for s in spans
                                     if s.get('track') is not None})}))
    return 0


def cmd_obs_lanes(args) -> int:
    """Live lane-occupancy table over a ``--metrics-dir`` surface: the
    scheduler observatory's ``serve.lanes.*`` registry twins rendered
    per bucket (occupancy/bubble/dispatch %, join/vacate/preempt
    totals, fill and lane-age percentiles). Same follow/stall contract
    as ``obs top``: --follow re-renders at --every cadence, a
    metrics.json that stops being rewritten past --stall-timeout emits
    a synthetic stall alert and exits 3, a missing surface exits 2.
    ``--export-timeline PATH`` instead rebuilds the Perfetto per-lane
    timeline from the run directory's serve.span events."""
    import time as _time

    from cbf_tpu_torch.obs import export as obs_export

    if args.export_timeline is not None:
        try:
            run_dir = _resolve_run_dir(args.run_dir, args.latest)
        except SystemExit:
            run_dir = args.run_dir
        return _export_lane_timeline(run_dir, args.export_timeline)
    try:
        mdir = _resolve_metrics_dir(args.run_dir, args.latest)
    except FileNotFoundError as e:
        print(f"obs lanes: {e}", file=sys.stderr)
        return 2
    path = os.path.join(mdir, obs_export.JSON_FILENAME)
    t_start = _time.time()
    while True:
        if not os.path.isfile(path):
            if not args.follow:
                print(f"obs lanes: no {obs_export.JSON_FILENAME} in {mdir}",
                      file=sys.stderr)
                return 2
            if args.stall_timeout is not None and \
                    _time.time() - t_start > args.stall_timeout:
                print(json.dumps({
                    "event": "alert", "kind": "stall",
                    "detail": f"{path} never appeared in "
                              f"{args.stall_timeout}s"}), flush=True)
                return 3
            _time.sleep(min(args.every, 1.0))
            continue
        age = _time.time() - os.path.getmtime(path)
        if args.stall_timeout is not None and age > args.stall_timeout:
            print(json.dumps({
                "event": "alert", "kind": "stall",
                "detail": f"{path} not rewritten for {age:.1f}s "
                          f"(> {args.stall_timeout}s)"}), flush=True)
            return 3
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except ValueError:
            doc = None                     # replaced mid-read: next tick
        if doc is not None:
            print(f"== lanes {path}  age={age:.1f}s ==", flush=True)
            print(_render_lanes(doc), flush=True)
        if not args.follow:
            return 0
        _time.sleep(args.every)


def cmd_list(_args) -> int:
    for name, (module, steps_field, *_rest) in sorted(_scenarios().items()):
        cfg = module.Config()
        knobs = ", ".join(f"{f.name}={getattr(cfg, f.name)!r}"
                          for f in dataclasses.fields(cfg)
                          if f.name != "dtype")
        print(f"{name}  ({steps_field} is the horizon)\n    {knobs}")
    return 0


def _weakened_cbf(scenario: str, cfg, pairs: list[str], device):
    """--weaken field=value pairs as a CBFParams override of the
    scenario's default filter parameters (e.g. dmin=0.16)."""
    if not pairs:
        return None
    from cbf_tpu_torch.core.filter import CBFParams
    from cbf_tpu_torch.scenarios import swarm

    if scenario == "swarm" or getattr(cfg, "spawn", None) is not None:
        base = swarm.default_cbf(cfg, device=device)  # a generated swarm too
    elif scenario == "antipodal":
        base = CBFParams(max_speed=cfg.max_speed, k=0.0)
    else:
        base = CBFParams(max_speed=cfg.max_speed)
    updates = {}
    for pair in pairs:
        key, _, raw = pair.partition("=")
        if key not in CBFParams._fields:
            raise SystemExit(f"--weaken: unknown CBFParams field {key!r}; "
                             f"have {sorted(CBFParams._fields)}")
        updates[key] = float(raw)
    return base._replace(**updates)


# verify --properties: an unselected property is made vacuous (its margin
# still evaluates but cannot trigger "found").
_VACUOUS = {"separation": ("separation_floor", -float("inf")),
            "boundary": ("boundary_half", None),
            "obstacle_clearance": ("obstacle_floor", -float("inf")),
            "sustained_infeasibility": ("infeasible_streak_limit", 10 ** 9),
            "goal_reach": ("goal_radius", None),
            "rta_soundness": ("rta_floor", -float("inf"))}


def _resolve_capsule_dir(path: str, latest: bool) -> str:
    """``--latest``: treat ``path`` as a root (a flight recorder's
    out_dir) and pick the newest capsule-* directory by manifest
    mtime."""
    from cbf_tpu_torch.obs import flight as obs_flight

    if not latest:
        return path
    candidates = []
    if os.path.isdir(path):
        for d in [os.path.join(path, n) for n in sorted(os.listdir(path))
                  ] + [path]:
            m = os.path.join(d, obs_flight.CAPSULE_FILENAME)
            if os.path.isfile(m):
                candidates.append((os.path.getmtime(m), d))
    if not candidates:
        raise FileNotFoundError(
            f"no capsule ({obs_flight.CAPSULE_FILENAME}) under {path}")
    return max(candidates)[1]


def _replay_stanza(stanza: dict, device) -> dict:
    """Re-run one captured request stanza standalone through the port:
    rebuild the config via the verify-corpus loader, run its rollout once
    on ``device``, and judge the outcome — ``violates`` when the run goes
    non-finite or agents collide (min pairwise distance <= 0), ``safe``
    otherwise."""
    import importlib

    import numpy as np

    from cbf_tpu_torch.rollout.engine import _leaves, rollout
    from cbf_tpu_torch.verify import corpus

    scenario = stanza.get("scenario", "swarm")
    cfg = corpus.rebuild_config(scenario, stanza.get("overrides", {}))
    module = importlib.import_module(f"cbf_tpu_torch.scenarios.{scenario}")
    state0, step = module.make(cfg, device=device)
    steps = getattr(cfg, "steps", None) or getattr(cfg, "iterations")
    final, outs = rollout(step, state0, int(steps))
    finite = all(bool(torch.isfinite(leaf).all()) for leaf in _leaves(final)
                 if leaf.is_floating_point())
    mpd = float(np.min(_np(outs.min_pairwise_distance)))
    finite = finite and bool(np.isfinite(mpd))
    violates = (not finite) or mpd <= 0.0
    return {"scenario": scenario, "steps": int(steps),
            "finite": finite,
            "min_pairwise_distance": (round(mpd, 6)
                                      if np.isfinite(mpd) else None),
            "outcome": "violates" if violates else "safe"}


def cmd_obs_incident(args) -> int:
    """Summarize one incident capsule directory (``--latest``: the
    newest capsule under a recorder root). ``--replay`` re-runs the
    captured offending request through a standalone rollout on
    ``--device`` and exits 0 iff the observed outcome matches the
    stanza's ``expect`` (1 on mismatch, 2 when the capsule carries no
    request.json)."""
    from cbf_tpu_torch.obs import flight as obs_flight

    cap_dir = args.capsule_dir
    try:
        cap_dir = _resolve_capsule_dir(args.capsule_dir, args.latest)
        doc = obs_flight.read_capsule(cap_dir)
    except FileNotFoundError as e:
        print(f"obs incident: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"obs incident: {cap_dir}: corrupt capsule ({e})",
              file=sys.stderr)
        return 2
    summary = {
        "capsule": os.path.abspath(cap_dir),
        "flight_schema": doc.get("flight_schema"),
        "reason": doc.get("reason"),
        "detail": doc.get("detail"),
        "t_wall": doc.get("t_wall"),
        "environment": doc.get("environment"),
        "ring_events": doc.get("ring_events"),
        "ring_tail": [e.get("event") for e in doc.get("ring", [])[-8:]],
        "trigger_event": (doc.get("trigger_event") or {}).get("event"),
        "recent_requests": len(doc.get("recent_requests") or []),
        "has_request": doc.get("has_request"),
    }
    if args.replay:
        request = doc.get("request")
        if request is None:
            print(f"obs incident: {cap_dir} has no "
                  f"{obs_flight.REQUEST_FILENAME} to replay",
                  file=sys.stderr)
            return 2
        replay = _replay_stanza(request, args.device)
        replay["expect"] = request.get("expect", "violates")
        replay["matches_expect"] = replay["outcome"] == replay["expect"]
        summary["replay"] = replay
        print(json.dumps(summary, indent=None if args.json else 2))
        return 0 if replay["matches_expect"] else 1
    print(json.dumps(summary, indent=None if args.json else 2))
    return 0


def _load_requests(path: str):
    """Parse a serve request file into swarm Configs.

    Format: a JSON list (or ``{"requests": [...]}``) of objects, each
    with optional ``steps``/``seed`` shorthands and an ``overrides``
    object of typed swarm.Config field values (JSON carries the types —
    no string re-parsing like --set). An integer ``repeat`` clones the
    entry (mixed-workload files stay short)."""
    from cbf_tpu_torch.scenarios import swarm

    with open(path) as fh:
        spec = json.load(fh)
    if isinstance(spec, dict):
        spec = spec["requests"]
    fields = {f.name for f in dataclasses.fields(swarm.Config)}
    cfgs = []
    for i, entry in enumerate(spec):
        overrides = dict(entry.get("overrides", {}))
        for shorthand in ("steps", "seed"):
            if shorthand in entry:
                overrides[shorthand] = entry[shorthand]
        unknown = set(overrides) - fields
        if unknown:
            raise SystemExit(f"request {i}: unknown config fields "
                             f"{sorted(unknown)}")
        cfg = dataclasses.replace(swarm.Config(), **overrides)
        cfgs.extend([cfg] * int(entry.get("repeat", 1)))
    if not cfgs:
        raise SystemExit(f"{path}: no requests")
    return cfgs


def _add_fault_policy_args(parser) -> None:
    """The serving fault-tolerance knobs. Defaults mirror
    serve.resilience.FaultPolicy: retries/bisection/finite-checking on,
    admission control and deadlines off."""
    parser.add_argument("--max-retries", type=int, default=2,
                        help="bounded backoff retries per transient batch "
                             "failure (default 2)")
    parser.add_argument("--queue-limit", type=int, default=None,
                        help="bound the total queued request count; "
                             "beyond it, submits shed per --shed-policy "
                             "(default: unbounded)")
    parser.add_argument("--shed-policy", default="reject-newest",
                        choices=("reject-newest", "reject-oldest"),
                        help="what to shed when the bounded queue is "
                             "full (default reject-newest)")
    parser.add_argument("--queue-bytes-budget", type=int, default=None,
                        help="bound the predicted device bytes of queued "
                             "work via the measured cost model; beyond "
                             "it, submits shed with reason bytes_budget "
                             "(fail-open for unpriced shapes; default: "
                             "unbounded)")
    parser.add_argument("--deadline", type=float, default=None,
                        help="per-request deadline in seconds; expired "
                             "requests fail fast with DeadlineExceeded "
                             "(default: none)")
    parser.add_argument("--rta-fallback", action="store_true",
                        help="re-run a non-finite request alone under the "
                             "runtime-assurance ladder (rta=true) for a "
                             "degraded completion instead of a "
                             "NonFiniteResult")


def _add_continuous_args(parser) -> None:
    parser.add_argument("--continuous", action="store_true",
                        help="continuous batching: advance lane tables one "
                             "chunk at a time so arrivals JOIN free lanes "
                             "and finished requests LEAVE at chunk "
                             "boundaries")
    parser.add_argument("--chunk", type=int, default=16,
                        help="steps per scheduling chunk in continuous "
                             "mode (default 16)")


def _add_metrics_args(parser) -> None:
    parser.add_argument("--metrics-dir", default=None,
                        help="atomically rewrite metrics.prom (Prometheus "
                             "text exposition) + metrics.json here at a "
                             "fixed cadence while serving; watch with "
                             "`obs top <dir> --follow`")
    parser.add_argument("--metrics-every", type=float, default=2.0,
                        help="metrics rewrite cadence in seconds "
                             "(default 2)")


def _add_follow_args(parser) -> None:
    """``obs top``/``obs lanes``: the follow/stall contract."""
    parser.add_argument("--follow", "-f", action="store_true",
                        help="keep re-rendering at --every cadence")
    parser.add_argument("--every", type=float, default=2.0,
                        help="re-render cadence in seconds (default 2)")
    parser.add_argument("--stall-timeout", type=float, default=None,
                        help="emit a synthetic stall alert and exit 3 when "
                             "metrics.json stops being rewritten for this "
                             "many seconds")
    parser.add_argument("--latest", action="store_true",
                        help="run_dir is a root; watch the directory with "
                             "the newest metrics.json")


def _fault_policy_from(args):
    from cbf_tpu_torch.serve import FaultPolicy

    return FaultPolicy(max_retries=args.max_retries,
                       queue_limit=args.queue_limit,
                       queue_bytes_budget=args.queue_bytes_budget,
                       shed_policy=args.shed_policy,
                       deadline_s=args.deadline,
                       rta_fallback=args.rta_fallback)


def _serve_sink(args):
    """(sink, cost model, flight recorder) of a ``serve``/``loadgen``
    run: all None without ``--telemetry-dir`` or ``--metrics-dir`` (the
    latter alone still needs a populated registry: the sink doubles as
    the run directory then)."""
    if not (args.telemetry_dir or args.metrics_dir):
        return None, None, None
    from cbf_tpu_torch import obs
    from cbf_tpu_torch.obs import flight as obs_flight
    from cbf_tpu_torch.obs import resource as obs_resource

    sink = obs.TelemetrySink(args.telemetry_dir or args.metrics_dir)
    cost_model = obs_resource.CostModel(os.path.join(
        sink.run_dir, obs_resource.COSTMODEL_FILENAME))
    flight = obs_flight.FlightRecorder(
        os.path.join(sink.run_dir, "capsules"),
        cost_model=cost_model).attach(sink)
    return sink, cost_model, flight


def _metrics_exporter(args, sink, engine):
    """The ``--metrics-dir`` exporter, started (None without the flag):
    the registry plus the engine's stats as the JSON twin's extra."""
    if not args.metrics_dir:
        return None
    from cbf_tpu_torch.obs import export as obs_export

    return obs_export.MetricsExporter(
        sink.registry, args.metrics_dir, every_s=args.metrics_every,
        extra_fn=lambda: {"stats": dict(engine.stats)}).start()


def _serve_supervised(args) -> int:
    """Run the serve command under the HA supervisor: re-exec this
    process's own argv (minus ``--supervised``) as a child, restart it
    on crashes with exponential backoff, trip the crash-loop breaker on
    a restart storm (exit 3), and pass a FENCED child's exit 4 through
    WITHOUT restarting — a newer epoch owns the journal, and a restart
    would only fence again."""
    from cbf_tpu_torch.serve import ha as serve_ha

    sink = flight = None
    if args.telemetry_dir:
        from cbf_tpu_torch import obs
        from cbf_tpu_torch.obs import flight as obs_flight

        sink = obs.TelemetrySink(args.telemetry_dir)
        flight = obs_flight.FlightRecorder(
            os.path.join(sink.run_dir, "capsules")).attach(sink)
    child = [sys.executable, "-m", "cbf_tpu_torch"] + \
        [a for a in sys.argv[1:] if a != "--supervised"]
    sup = serve_ha.Supervisor(
        child, backoff_base_s=args.backoff_base_s,
        backoff_max_s=args.backoff_max_s, max_restarts=args.max_restarts,
        crash_window_s=args.crash_window_s, telemetry=sink, flight=flight)
    rc = sup.run()
    if sink is not None:
        sink.close()
    return rc


def _serve_standby(args) -> int:
    """Run the hot-standby side of an HA pair: initialise the device,
    capture the journal's acknowledged buckets, watch the lease, and on
    expiry take over — bump the epoch (fencing the old primary), replay
    acknowledged-but-unresolved requests with request-id dedupe, serve
    them to completion under the new epoch, and print one JSON takeover
    record."""
    from cbf_tpu_torch.serve import FencedError, ServeEngine
    from cbf_tpu_torch.serve import ha as serve_ha

    if not args.lease or not args.journal:
        print("serve: --ha-standby requires --lease and --journal",
              file=sys.stderr)
        return 2
    sink, _, flight = _serve_sink(args)
    health_dir = args.metrics_dir or (sink.run_dir if sink else None)

    def _health(role: str, epoch) -> None:
        if health_dir is None:
            return
        from cbf_tpu_torch.obs import export as obs_export

        obs_export.write_health(health_dir, {
            "role": role, "epoch": epoch,
            "lease": os.path.abspath(args.lease),
            "journal": os.path.abspath(args.journal)})

    def _engine_factory():
        return ServeEngine(max_batch=args.max_batch,
                           flush_deadline_s=args.flush_deadline,
                           cache_dir=args.cache_dir, telemetry=sink,
                           fault_policy=_fault_policy_from(args),
                           flight=flight, device=args.device)

    standby = serve_ha.Standby(
        lease_path=args.lease, journal_path=args.journal,
        engine_factory=_engine_factory, ttl_s=args.lease_ttl_s,
        rotate_bytes=args.rotate_bytes, telemetry=sink, flight=flight)

    def _on_ready() -> None:
        _health("standby", None)
        if args.ready_file:
            with open(args.ready_file, "w") as fh:
                fh.write("ready\n")

    report = standby.run(max_wait_s=args.standby_max_wait_s,
                         on_ready=_on_ready)
    if report is None:
        print(json.dumps({"takeover": False,
                          "waited_s": args.standby_max_wait_s}))
        if sink is not None:
            sink.close()
        return 0
    _health("primary", report.epoch)
    heartbeater = serve_ha.Heartbeater(
        standby.lease, interval_s=args.heartbeat_s).start()
    served, errors = [], {}
    fenced_err = None
    for p in report.pendings:
        try:
            r = p.result(timeout=300.0)
            served.append({"request_id": r.request_id, "bucket": r.bucket,
                           "latency_s": r.latency_s})
        except FencedError as fe:
            fenced_err = fenced_err or fe
        except Exception as e:
            errors[p.request_id] = type(e).__name__
    standby.engine.stop(drain=True)
    heartbeater.stop()
    if fenced_err is None:
        fenced_err = heartbeater.fenced or standby.engine.fenced
    if sink is not None:
        sink.summary({"takeover_epoch": report.epoch,
                      "reenqueued": report.reenqueued})
        sink.close()
    if fenced_err is not None:
        serve_ha.note_fenced(fenced_err, telemetry=sink, flight=flight)
        print(json.dumps({"fenced": True, "epoch": fenced_err.epoch,
                          "fence_epoch": fenced_err.fence_epoch}))
        return serve_ha.EXIT_FENCED
    print(json.dumps({
        "takeover": True, "epoch": report.epoch,
        "prev_epoch": report.prev_epoch, "records": report.records,
        "reenqueued": report.reenqueued, "deduped": report.deduped,
        "mttr_s": report.mttr_s, "served": served, "errors": errors,
        "journal": os.path.abspath(args.journal)}))
    return 0


def cmd_serve(args) -> int:
    """Batch-serve a request file through the serving engine's drain mode:
    bucket by static signature, pack same-bucket requests into one
    lockstep program, optionally capture every bucket first
    (``--prewarm``). Prints one JSON record (per-request summaries +
    aggregate throughput/latency + capture counters), as the JAX
    package's ``serve`` does, with its exit codes. ``--continuous``
    serves through the lane tables in queue mode; ``--metrics-dir`` keeps
    ``metrics.prom`` and ``metrics.json`` current while serving. With
    ``--lease`` the process serves as an HA PRIMARY: it acquires the
    lease (bumping the epoch), heartbeats it on a daemon thread, and
    opens the journal fenced by the lease — a takeover by a standby
    turns every further append into a typed rejection and this process
    exits 4. ``--supervised`` and ``--ha-standby`` run the supervisor and
    the standby."""
    import statistics
    import time as _time

    if args.supervised:
        return _serve_supervised(args)
    if args.ha_standby:
        return _serve_standby(args)

    import numpy as np

    from cbf_tpu_torch.serve import ServeEngine
    from cbf_tpu_torch.utils import profiling

    if args.recover and not args.journal:
        print("serve: --recover requires --journal", file=sys.stderr)
        return 2
    if args.lease and not args.journal:
        print("serve: --lease requires --journal (the lease fences the "
              "journal)", file=sys.stderr)
        return 2
    if args.pace_s is not None and args.pace_s < 0:
        print(f"serve: --pace-s must be >= 0, got {args.pace_s}",
              file=sys.stderr)
        return 2
    if args.requests is None and not args.recover:
        print("serve: a requests file is required (or --journal PATH "
              "--recover)", file=sys.stderr)
        return 2

    request_ids = None
    recovered = []
    if args.recover:
        # Fold the previous process's journal FIRST (fail fast, exit 2)
        # — the engine below then journals the re-run outcomes to the
        # same file, closing the at-least-once loop.
        from cbf_tpu_torch.durable.journal import replay_journal
        from cbf_tpu_torch.serve import RecoveryError

        try:
            replay = replay_journal(args.journal)
        except (OSError, RecoveryError) as e:
            print(f"serve: {e}", file=sys.stderr)
            return 2
        recovered = replay.unresolved_configs()
        cfgs = [cfg for _, cfg in recovered]
        request_ids = [rid for rid, _ in recovered]
        if args.requests:
            # Fresh requests ride along under a distinct id prefix so
            # they can never collide with (and silently reopen) ids the
            # previous process already journaled.
            extra = _load_requests(args.requests)
            cfgs.extend(extra)
            request_ids.extend(f"n{i}" for i in range(len(extra)))
        if not cfgs:
            print(json.dumps({"requests": 0, "recovered": 0,
                              "journal": os.path.abspath(args.journal)}))
            return 0
    else:
        cfgs = _load_requests(args.requests)

    sink, cost_model, flight = _serve_sink(args)
    # HA primary: acquire the lease FIRST (bumping the epoch), then open
    # the journal stamped with that epoch and fenced by the lease file —
    # from here, a standby's takeover turns every append this process
    # attempts into a typed FencedError.
    lease = heartbeater = None
    journal_obj = args.journal
    if args.lease or (args.journal and args.rotate_bytes):
        from cbf_tpu_torch.durable.journal import RequestJournal
        from cbf_tpu_torch.serve import ha as serve_ha

        epoch, fence = 0, None
        if args.lease:
            from cbf_tpu_torch.scenarios import swarm

            lease = serve_ha.Lease(args.lease, telemetry=sink)
            # The device first (a departure from the JAX order): CUDA's
            # initialisation can hold the interpreter long enough that a
            # heartbeat it starves after the acquire reads as a dead
            # primary to a standby's short TTL.
            serve_ha.warm_device(swarm.resolve_device(args.device))
            epoch, fence = lease.acquire(), lease.path
        journal_obj = RequestJournal(args.journal, telemetry=sink,
                                     epoch=epoch, fence_path=fence,
                                     rotate_bytes=args.rotate_bytes)
        if lease is not None:
            heartbeater = serve_ha.Heartbeater(
                lease, interval_s=args.heartbeat_s).start()
            health_dir = args.metrics_dir or (sink.run_dir if sink
                                              else None)
            if health_dir:
                from cbf_tpu_torch.obs import export as obs_export

                obs_export.write_health(health_dir, {
                    "role": "primary", "epoch": epoch,
                    "lease": lease.path,
                    "journal": os.path.abspath(args.journal)})
    engine = ServeEngine(max_batch=args.max_batch,
                         flush_deadline_s=args.flush_deadline,
                         cache_dir=args.cache_dir, telemetry=sink,
                         fault_policy=_fault_policy_from(args),
                         journal=journal_obj, cost_model=cost_model,
                         flight=flight, continuous=args.continuous,
                         chunk_steps=args.chunk, device=args.device)
    exporter = _metrics_exporter(args, sink, engine)
    prewarm_s = None
    if args.prewarm or args.prewarm_only:
        prewarm_s = engine.prewarm(cfgs)
    if sink is not None:
        from cbf_tpu_torch import obs

        # Manifest AFTER prewarm: its compile_event_counts snapshot then
        # carries the per-bucket program hit/miss + prewarm counters.
        sink.write_manifest(obs.build_manifest(
            None, extra=engine.manifest_extra()))
    record = {"requests": len(cfgs), "cache_dir": engine.cache_dir,
              "max_batch": args.max_batch}
    if args.journal:
        record["journal"] = os.path.abspath(args.journal)
    if args.recover:
        record["recovered"] = len(recovered)
        record["recovered_request_ids"] = [rid for rid, _ in recovered]
    if prewarm_s is not None:
        record["prewarm_s"] = prewarm_s
        record["buckets"] = engine.manifest_extra()["serve"]["buckets"]
    if args.prewarm_only:
        record["stats"] = engine.stats
        if heartbeater is not None:
            heartbeater.stop()
        if exporter is not None:
            exporter.stop()
            record["metrics_dir"] = os.path.abspath(args.metrics_dir)
        print(json.dumps(record))
        if sink is not None:
            sink.close()
        return 0

    # Preemption notice (SIGTERM) becomes a graceful drain: every
    # acknowledged request resolves (and journals its terminal record)
    # before the process dies. ValueError = embedded off the main
    # thread, where the signal module refuses handlers — skip quietly.
    prev_term = None
    try:
        prev_term = engine.install_sigterm_handler()
    except ValueError:
        pass
    from cbf_tpu_torch.serve import FencedError
    fenced_err = None
    req_errors: dict[str, str] = {}
    t0 = _time.perf_counter()
    try:
        if args.pace_s is not None or args.continuous:
            # Queue-mode submits: paced (one request at a time with a
            # fixed inter-arrival gap, so a kill can land BETWEEN
            # acknowledged requests) or continuous (the lane tables
            # exist only on the scheduler thread; the offline run() path
            # would drain instead).
            engine.start()
            pendings = []
            try:
                for i, cfg in enumerate(cfgs):
                    rid = (request_ids[i] if request_ids is not None
                           else None)
                    pendings.append(engine.submit(cfg, request_id=rid))
                    if args.pace_s:
                        _time.sleep(args.pace_s)
            except FencedError as fe:
                fenced_err = fe
            results = []
            for p in pendings:
                try:
                    results.append(p.result(timeout=300.0))
                except FencedError as fe:
                    fenced_err = fenced_err if fenced_err is not None \
                        else fe
                except Exception as e:
                    req_errors[p.request_id] = type(e).__name__
            engine.stop(drain=True)
        else:
            results = engine.run(cfgs, request_ids=request_ids)
    except FencedError as fe:
        fenced_err = fe
        results = []
    finally:
        if prev_term is not None:
            import signal as _signal

            _signal.signal(_signal.SIGTERM, prev_term)
    wall = _time.perf_counter() - t0
    if heartbeater is not None:
        heartbeater.stop()
        if fenced_err is None:
            fenced_err = heartbeater.fenced
    if fenced_err is None:
        fenced_err = engine.fenced
    if fenced_err is not None:
        from cbf_tpu_torch.serve import ha as serve_ha

        serve_ha.note_fenced(fenced_err, telemetry=sink, flight=flight)
        if exporter is not None:
            exporter.stop()
        if sink is not None:
            sink.close()
        print(json.dumps({"fenced": True, "epoch": fenced_err.epoch,
                          "fence_epoch": fenced_err.fence_epoch,
                          "served": len(results)}))
        return serve_ha.EXIT_FENCED
    if cost_model is not None:
        try:                     # offline run() never stop()s the engine
            cost_model.save()
        except OSError:
            pass
    lat = sorted(r.latency_s for r in results)
    qwait = sorted(r.queue_wait_s for r in results)
    qp_steps = sum(r.n * r.steps for r in results)
    if req_errors:
        record["request_errors"] = req_errors
    if lat:
        record.update({
            "agent_qp_steps_per_sec": round(qp_steps / wall, 1),
            "latency_p50_s": round(statistics.median(lat), 4),
            "latency_p99_s": round(lat[min(len(lat) - 1,
                                           int(0.99 * len(lat)))], 4),
            "queue_wait_p50_s": round(statistics.median(qwait), 4),
            "queue_wait_p99_s": round(qwait[min(len(qwait) - 1,
                                                int(0.99 * len(qwait)))],
                                      4),
        })
    record.update({
        "wall_s": round(wall, 3),
        "stats": engine.stats,
        "compile_counters": {k: v for k, v in
                             profiling.compile_event_counts().items()
                             if k.startswith("serve.")},
        "results": [{
            "request_id": r.request_id, "bucket": r.bucket, "n": r.n,
            "steps": r.steps, "latency_s": r.latency_s,
            "queue_wait_s": r.queue_wait_s, "execute_s": r.execute_s,
            "min_pairwise_distance": round(float(
                np.min(r.outputs.min_pairwise_distance)), 4),
            "infeasible_count": int(np.sum(r.outputs.infeasible_count)),
        } for r in results],
    })
    if exporter is not None:
        exporter.stop()
        record["metrics_dir"] = os.path.abspath(args.metrics_dir)
    if flight is not None and flight.capsules:
        record["capsules"] = list(flight.capsules)
    if sink is not None:
        sink.summary({"requests_served": len(results)})
        sink.close()
        record["telemetry"] = sink.run_dir
    print(json.dumps(record))
    return 0


def cmd_cluster_worker(args) -> int:
    """One cluster engine process (spawned by ``cluster serve``, or by
    hand): claim routed requests from this engine's inbox, acknowledge
    them through a fenced WAL, respond through the outbox. SIGTERM
    drains (exit 0); a newer lease epoch fences this process (exit 4).
    With --metrics, a `MetricsExporter` rewrites this engine's
    ``metrics/`` surface — aggregate M of them with ``obs top
    --merge``."""
    import signal

    from cbf_tpu_torch.cluster import transport as ctransport
    from cbf_tpu_torch.cluster.worker import Worker

    dirs = ctransport.EngineDirs(args.root, args.name)
    sink = None
    if args.metrics or args.telemetry:
        from cbf_tpu_torch import obs

        sink = obs.TelemetrySink(os.path.join(dirs.base, "telemetry"))
    w = Worker(args.root, args.name, max_batch=args.max_batch,
               flush_deadline_s=args.flush_deadline,
               heartbeat_s=args.heartbeat_s, cache_dir=args.cache_dir,
               telemetry=sink, poll_s=args.poll_s, device=args.device)
    w.boot()
    exporter = None
    if args.metrics:
        from cbf_tpu_torch.obs import export as obs_export

        exporter = obs_export.MetricsExporter(
            sink.registry, dirs.metrics, every_s=args.metrics_every,
            extra_fn=lambda: {"engine": args.name,
                              "stats": dict(w.engine.stats)}).start()

    def _term(signum, frame):
        w._stop.set()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass
    rc = w.run_loop()
    if exporter is not None:
        exporter.stop()
    if sink is not None:
        sink.write_manifest(obs.build_manifest())
        sink.close()
    return rc


def cmd_cluster_serve(args) -> int:
    """Serve a request file through a routed M-engine cluster: spawn M
    ``cluster worker`` processes, route every request by bucket
    signature over the consistent-hash ring (cost-model admission when
    a costmodel.json is present; work stealing with --steal), watch
    every worker's lease and fail dead ones over onto survivors, and
    with --roll run one full zero-loss rolling restart while the
    requests drain. Prints one JSON record ending in the cluster-wide
    exactly-once census; exit 0 iff the census is clean."""
    import subprocess
    import tempfile
    import time as _time

    from cbf_tpu_torch.cluster import (ClusterRouter, Membership,
                                       cluster_census)
    from cbf_tpu_torch.cluster import transport as ctransport
    from cbf_tpu_torch.serve.resilience import ServeError
    from cbf_tpu_torch.utils.faults import wait_for_file

    if args.engines < 1:
        print(f"cluster serve: --engines must be >= 1, "
              f"got {args.engines}", file=sys.stderr)
        return 2
    cfgs = _load_requests(args.requests)
    root = args.root or tempfile.mkdtemp(prefix="cbf_cluster_")
    names = [f"e{i}" for i in range(args.engines)]
    sink = cost_model = None
    if args.telemetry_dir:
        from cbf_tpu_torch import obs
        from cbf_tpu_torch.obs import resource as obs_resource

        sink = obs.TelemetrySink(args.telemetry_dir)
        cost_model = obs_resource.CostModel(os.path.join(
            sink.run_dir, obs_resource.COSTMODEL_FILENAME))
    router = ClusterRouter(root, names, telemetry=sink,
                           cost_model=cost_model,
                           budget_bytes=args.budget_bytes,
                           steal=args.steal,
                           steal_threshold=args.steal_threshold)
    if args.prewarm:
        # Written BEFORE the workers spawn: each engine captures the
        # request file's buckets at boot, so first traffic is warm.
        router.prewarm(cfgs)
    procs: dict = {}

    def spawn(name: str) -> None:
        argv = [sys.executable, "-m", "cbf_tpu_torch", "cluster", "worker",
                "--root", root, "--name", name,
                "--max-batch", str(args.max_batch),
                "--flush-deadline", str(args.flush_deadline),
                "--heartbeat-s", str(args.heartbeat_s),
                "--device", args.device]
        if args.cache_dir:
            argv += ["--cache-dir", args.cache_dir]
        if args.worker_metrics:
            argv += ["--metrics"]
        procs[name] = subprocess.Popen(argv)

    t0 = _time.monotonic()
    for name in names:
        spawn(name)
    for name in names:
        dirs = ctransport.EngineDirs(root, name)
        if not wait_for_file(dirs.ready, args.ready_timeout):
            for pr in procs.values():
                pr.terminate()
            print(f"cluster serve: engine {name} not ready within "
                  f"{args.ready_timeout}s", file=sys.stderr)
            return 2
    router.start()
    membership = Membership(router, ttl_s=args.lease_ttl_s,
                            telemetry=sink, respawn=spawn).start()
    pendings, errors = [], {}
    for cfg in cfgs:
        try:
            pendings.append(router.submit(cfg))
        except ServeError as e:
            errors[type(e).__name__] = errors.get(type(e).__name__,
                                                  0) + 1
    roll = None
    if args.roll:
        roll = membership.rolling_restart()
    completed = 0
    for pnd in pendings:
        try:
            pnd.result(timeout=args.result_timeout)
            completed += 1
        except Exception as e:
            errors[type(e).__name__] = errors.get(type(e).__name__,
                                                  0) + 1
    router.stop(drain=True)
    membership.stop()
    for name, pr in procs.items():
        pr.terminate()
    for name, pr in procs.items():
        try:
            pr.wait(timeout=60)
        except subprocess.TimeoutExpired:
            pr.kill()
    census = cluster_census(root)
    record = {"engines": args.engines, "root": root,
              "requests": len(cfgs), "completed": completed,
              "errors": errors, "stolen": router.stolen,
              "failovers": membership.failovers,
              "mttr_s": membership.mttr_s, "roll": roll,
              "census": census,
              "wall_s": round(_time.monotonic() - t0, 3)}
    if sink is not None:
        sink.write_manifest(obs.build_manifest())
        sink.close()
    print(json.dumps(record))
    return 0 if census["ok"] else 1


def cmd_loadgen(args) -> int:
    """Open-loop SLO load generation against the serving engine: a
    seeded Poisson-arrival, bounded-Pareto-size traffic run
    (serve.loadgen), reported as sustained RPS + p50/p95/p99 end-to-end
    latency with queue-wait vs execute breakdown. Optional exports: the
    request-lifecycle Chrome trace (--chrome-trace, Perfetto-loadable),
    a device profile with matching phase names (--xla-trace), and the
    serve.span/loadgen.summary JSONL stream (--telemetry-dir). The
    device profile is torch.profiler's (``utils.profiling.trace``);
    ``--device`` picks where the programs run (default: the card)."""
    from cbf_tpu_torch.serve import (LoadSpec, ServeEngine, build_schedule,
                                     parse_sweep, run_loadgen, sweep_rps)
    from cbf_tpu_torch.utils import profiling

    try:
        steps_choices = tuple(int(s) for s in args.steps.split(","))
    except ValueError:
        raise SystemExit(f"--steps must be comma-separated ints, "
                         f"got {args.steps!r}")
    spec = LoadSpec(rps=args.rps, duration_s=args.duration, seed=args.seed,
                    n_min=args.n_min, n_max=args.n_max,
                    pareto_alpha=args.pareto_alpha,
                    steps_choices=steps_choices, gating=args.gating)
    sink, cost_model, flight = _serve_sink(args)
    engine = ServeEngine(max_batch=args.max_batch,
                         flush_deadline_s=args.flush_deadline,
                         cache_dir=args.cache_dir, telemetry=sink,
                         fault_policy=_fault_policy_from(args),
                         cost_model=cost_model, flight=flight,
                         continuous=args.continuous,
                         chunk_steps=args.chunk, device=args.device)
    exporter = _metrics_exporter(args, sink, engine)
    schedule = build_schedule(spec)
    prewarm_s = engine.prewarm([cfg for _, cfg in schedule])
    if sink is not None:
        from cbf_tpu_torch import obs

        sink.write_manifest(obs.build_manifest(
            None, extra=engine.manifest_extra()))
    trace_ctx = (profiling.trace(args.xla_trace) if args.xla_trace
                 else contextlib.nullcontext())
    with trace_ctx:
        if args.sweep_rps:
            try:
                grid = parse_sweep(args.sweep_rps)
            except ValueError as exc:
                raise SystemExit(f"--sweep-rps: {exc}")
            sweep = sweep_rps(engine, spec, grid,
                              slo_p99_s=args.slo_p99, telemetry=sink)
            report = {"completed": sum(l["completed"]
                                       for l in sweep["legs"])}
            record = {"sweep": sweep}
        else:
            report = run_loadgen(engine, spec, telemetry=sink)
            record = dict(report)
    record.update({
        "rps_target": args.rps, "max_batch": args.max_batch,
        "flush_deadline_s": args.flush_deadline,
        "n_min": args.n_min, "n_max": args.n_max,
        "pareto_alpha": args.pareto_alpha,
        "prewarm_s": prewarm_s,
        "buckets": engine.manifest_extra()["serve"]["buckets"],
        "stats": engine.stats,
    })
    if args.chrome_trace:
        record["chrome_trace"] = engine.tracer.export_chrome_trace(
            args.chrome_trace)
    if args.xla_trace:
        record["xla_trace"] = args.xla_trace
    if exporter is not None:
        exporter.stop()
        record["metrics_dir"] = os.path.abspath(args.metrics_dir)
    if flight is not None and flight.capsules:
        record["capsules"] = list(flight.capsules)
    if sink is not None:
        sink.summary({"requests_served": report["completed"]})
        sink.close()
        record["telemetry"] = sink.run_dir
    print(json.dumps(record))
    return 0


def _fleet_settings_from_args(args):
    """FleetSettings from the `verify fleet` arguments: --weaken pairs
    become cbf_overrides, --set pairs target FleetSettings fields
    (typed by the field's default), and the dedicated flags
    (--seed/--batch/--perturb-*) are defaults that a --set of the same
    field overrides."""
    from cbf_tpu_torch import verify as V
    from cbf_tpu_torch.core.filter import CBFParams

    overrides = []
    for pair in args.weaken or []:
        key, _, raw = pair.partition("=")
        if key not in CBFParams._fields:
            raise SystemExit(f"--weaken: unknown CBFParams field {key!r}; "
                             f"have {sorted(CBFParams._fields)}")
        overrides.append((key, float(raw)))
    # --set targets FleetSettings fields here (there is no single
    # scenario config to override — the fleet enrolls them all).
    sfields = {f.name: f for f in dataclasses.fields(V.FleetSettings)}
    skw = {}
    for pair in args.set:
        key, _, raw = pair.partition("=")
        if key not in sfields or key == "cbf_overrides":
            raise SystemExit(
                f"--set: unknown FleetSettings field {key!r}; have "
                f"{sorted(k for k in sfields if k != 'cbf_overrides')}")
        proto = sfields[key].default
        if isinstance(proto, bool):
            skw[key] = raw.lower() in ("1", "true", "yes")
        elif isinstance(proto, int):
            skw[key] = int(raw)
        else:
            skw[key] = float(raw)
    if args.perturb_scale is not None:
        skw["perturb_scale"] = args.perturb_scale
    if args.perturb_norm is not None:
        skw["perturb_norm"] = args.perturb_norm
    skw.setdefault("seed", args.seed)
    skw.setdefault("batch", args.batch)
    return V.FleetSettings(cbf_overrides=tuple(overrides), **skw)


def _world_launch(args, ranks: int):
    """Where a command spans ``ranks`` ranks: None when this process runs
    it itself (one rank, or inside a world — joined here when torchrun
    started it); else the exit code of the command run on ``ranks``
    fresh ranks of this CLI (:func:`cbf_tpu_torch.parallel.launch.
    run_world`), whose rank 0 output is printed here."""
    from cbf_tpu_torch.parallel import launch, multihost

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        multihost.initialize()
        if not multihost.is_primary():
            # Every rank computes; only the primary writes.
            args.telemetry_dir = None
            if getattr(args, "scenario", None) != "fleet":
                args.corpus_dir = None
        return None
    if ranks <= 1:
        return None
    rc, out, err = launch.run_world(
        "cbf_tpu_torch.__main__:_cli_rank", ranks, (args.argv,),
        device=args.device, timeout_s=None)[0]
    sys.stdout.write(out)
    sys.stderr.write(err)
    return rc


def _cli_rank(argv) -> tuple:
    """One rank of :func:`_world_launch`: the command in this world, its
    exit code and output."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _reset_state(args, V) -> None:
    """``--reset-state``: the primary removes the campaign files, and every
    rank waits for it before reading them."""
    from cbf_tpu_torch.parallel import multihost

    if multihost.is_primary():
        removed = V.reset_campaign_state(args.state_dir)
        if removed and not args.json:
            print(f"reset: removed {len(removed)} persisted campaign "
                  f"state file(s) from {args.state_dir}")
    multihost.barrier()


def _cmd_verify_fleet(args) -> int:
    """The falsification fleet over every registered scenario on
    ``--device``. Exit 0 = every target survived the round budget, 2 = a
    ``--state-dir`` campaign run under other settings, 3 = a new confirmed
    violation archived."""
    from cbf_tpu_torch import verify as V
    from cbf_tpu_torch.obs.schema import json_scalar

    settings = _fleet_settings_from_args(args)
    mesh = None if not args.mesh_dp else (args.mesh_dp, 1)
    sink = flight = None
    if args.telemetry_dir:
        from cbf_tpu_torch import obs
        from cbf_tpu_torch.obs import flight as obs_flight

        sink = obs.TelemetrySink(args.telemetry_dir, manifest=obs.build_manifest(
            None, extra={"fleet": {"seed": settings.seed,
                                   "batch": settings.batch,
                                   "budget_rounds": args.budget_rounds},
                         "device": args.device}))
        flight = obs_flight.FlightRecorder(
            os.path.join(sink.run_dir, "capsules")).attach(sink)
    if args.state_dir and args.reset_state:
        _reset_state(args, V)
    engine = None
    if args.serve_idle:
        from cbf_tpu_torch.serve.engine import ServeEngine

        engine = ServeEngine(telemetry=sink, flight=flight,
                             device=args.device)
        engine.start()
    try:
        res = V.run_fleet(settings, budget_rounds=args.budget_rounds,
                          corpus_dir=args.corpus_dir,
                          state_dir=args.state_dir, resume=args.resume,
                          telemetry=sink, mesh=mesh, flight=flight,
                          engine=engine, device=args.device)
    except ValueError as e:
        # Fingerprint mismatch: --state-dir holds a campaign run under
        # different settings. Operator error, not a traceback.
        print(f"verify: {e}", file=sys.stderr)
        return 2
    finally:
        if engine is not None:
            engine.stop()
    record = {"targets": res.targets, "rounds": res.rounds,
              "evaluated": res.evaluated, "best_margin": res.best_margin,
              "violations": res.violations, "near_misses": res.near_misses,
              "cells_visited": res.cells_visited,
              "cells_total": res.cells_total, "done": res.done,
              "state_path": res.state_path}
    if sink is not None:
        sink.summary({"violations_found": len(res.violations)})
        sink.close()
        record["telemetry"] = sink.run_dir
    if args.json:
        record["best_margin"] = json_scalar(record["best_margin"])
        print(json.dumps(record))
    else:
        print(f"fleet: {res.rounds} rounds, {res.evaluated} candidates "
              f"over {len(res.targets)} targets, best margin "
              f"{res.best_margin:.6f}, coverage "
              f"{res.cells_visited}/{res.cells_total} cells, "
              f"{res.near_misses} near-miss cells")
        for v in res.violations:
            print(f"VIOLATION {v['target']}/{v['property']}: "
                  f"margin_x64 {v['margin_x64']:.6f} "
                  f"(round {v['round']}, archived: {v['corpus']})")
    return 3 if res.violations else 0


def cmd_verify(args) -> int:
    """Falsification sweep (module docstring); exit 0 = survived, 3 =
    violation found."""
    rc = _world_launch(args, args.mesh_dp or 1)
    if rc is not None:
        return rc
    if args.scenario == "fleet":
        return _cmd_verify_fleet(args)
    from cbf_tpu_torch import verify as V
    from cbf_tpu_torch.scenarios.platform import registry
    from cbf_tpu_torch.verify.search import json_scalar

    entry = registry.get(args.scenario)
    cfg = _apply_overrides(entry.make_config(), args.set, args.steps,
                           entry.steps_field, need_trajectory=False)
    cbf = _weakened_cbf(args.scenario, cfg, args.weaken, args.device)
    settings = V.SearchSettings(
        budget=args.budget, batch=args.batch, seed=args.seed,
        perturb_scale=(0.04 if args.perturb_scale is None
                       else args.perturb_scale),
        perturb_norm=(0.1 if args.perturb_norm is None
                      else args.perturb_norm))
    thresholds = V.thresholds_for(args.scenario, cfg)
    if args.properties:
        selected = args.properties.split(",")
        unknown = set(selected) - set(V.PROPERTY_NAMES)
        if unknown:
            raise SystemExit(f"unknown properties {sorted(unknown)}; have "
                             f"{list(V.PROPERTY_NAMES)}")
        thresholds = dataclasses.replace(thresholds, **{
            field: value for name, (field, value) in _VACUOUS.items()
            if name not in selected})
    mesh = None if not args.mesh_dp else (args.mesh_dp, 1)
    engines = tuple(args.engine) if args.engine else ("random", "cem")
    sink = None
    if args.telemetry_dir:
        from cbf_tpu_torch import obs

        sink = obs.TelemetrySink(
            args.telemetry_dir,
            manifest=obs.build_manifest(cfg, extra={
                "scenario": args.scenario, "device": args.device,
                "verify": {"budget": settings.budget,
                           "batch": settings.batch, "engines": args.engine,
                           "seed": settings.seed}}))
    if args.state_dir and args.reset_state:
        _reset_state(args, V)
    try:
        results = V.falsify(
            args.scenario, cfg, settings=settings, engines=engines, cbf=cbf,
            thresholds=thresholds, telemetry=sink, mesh=mesh,
            state_dir=args.state_dir, resume=args.resume, device=args.device)
    except ValueError as e:
        print(f"verify: {e}", file=sys.stderr)
        return 2

    record = {"scenario": args.scenario, "budget": settings.budget,
              "seed": settings.seed, "engines": list(engines),
              "results": [{
                  "engine": r.engine, "found": r.found,
                  "margin": r.margin, "property": r.property,
                  "evaluated": r.evaluated, "rounds": r.rounds,
                  "margins": {k: json_scalar(v)
                              for k, v in r.margins.items()},
              } for r in results]}
    found = next((r for r in results if r.found), None)
    if found is not None and not args.no_shrink:
        sr = V.shrink(args.scenario, cfg, found.delta, cbf=cbf,
                      thresholds=thresholds, settings=settings,
                      telemetry=sink, device=args.device)
        record["shrunk"] = {
            "property": sr.property, "steps": sr.steps,
            "earliest_step": sr.earliest_step, "scale": sr.scale,
            "margin": sr.margin, "margin_x64": sr.margin_x64,
            "confirmed_x64": sr.confirmed_x64, "evaluated": sr.evaluated}
        if args.corpus_dir:
            entry_ = V.entry_from(args.scenario, cfg, sr,
                                  engine=found.engine, settings=settings,
                                  cbf=cbf, thresholds=thresholds)
            record["corpus"] = V.append_entry(args.corpus_dir, entry_)
    if sink is not None:
        sink.summary({"violations_found": int(found is not None)})
        sink.close()
        record["telemetry"] = sink.run_dir
    if args.json:
        print(json.dumps(record))
    else:
        for r in record["results"]:
            print(f"{r['engine']}: margin {r['margin']:.6f} "
                  f"({r['property']}) after {r['evaluated']} candidates"
                  f"{' — VIOLATION' if r['found'] else ''}")
        if "shrunk" in record:
            sh = record["shrunk"]
            print(f"shrunk: steps={sh['steps']} scale={sh['scale']:.4f} "
                  f"margin_x64={sh['margin_x64']:.6f} "
                  f"confirmed_x64={sh['confirmed_x64']}")
        if "corpus" in record:
            print(f"archived: {record['corpus']}")
    return 3 if found is not None else 0


def _add_verify_parser(sub) -> None:
    from cbf_tpu_torch.scenarios.platform import registry

    verp = sub.add_parser(
        "verify", help="falsification sweep: search for initial-condition "
                       "perturbations violating a safety property; exit 3 "
                       "= violation found")
    verp.add_argument("scenario", nargs="?", default="swarm",
                      choices=sorted([*registry.names(), "fleet"]),
                      help="one scenario to falsify, or 'fleet' for the "
                           "continuous fuzzing campaign over every "
                           "registered scenario")
    verp.add_argument("--device", "--platform", dest="device",
                      default="cuda", choices=("cuda", "cpu"),
                      help="where the rollouts run (default: the card; "
                           "without one the sweep raises)")
    verp.add_argument("--steps", type=int, default=None,
                      help="rollout horizon (maps to steps/iterations)")
    verp.add_argument("--set", action="append", default=[],
                      metavar="FIELD=VALUE", help="override any config field")
    verp.add_argument("--weaken", action="append", default=[],
                      metavar="FIELD=VALUE",
                      help="override CBFParams fields of the scenario's "
                           "default filter (e.g. dmin=0.16)")
    verp.add_argument("--budget", type=int, default=256,
                      help="candidate rollouts per engine (default 256)")
    verp.add_argument("--batch", type=int, default=32,
                      help="candidates per batched rollout")
    verp.add_argument("--engine", action="append", default=[],
                      choices=("random", "grad", "cem"),
                      help="search engines, in order (repeatable; "
                           "default: random, cem)")
    verp.add_argument("--properties", default=None,
                      help="comma-separated property subset that may "
                           "trigger a violation (default: all)")
    verp.add_argument("--seed", type=int, default=0)
    verp.add_argument("--perturb-scale", type=float, default=None,
                      help="proposal std in metres (default 0.04; fleet "
                           "default 0.02)")
    verp.add_argument("--perturb-norm", type=float, default=None,
                      help="per-agent L2 cap on perturbations (default "
                           "0.1 m; fleet default 0.05)")
    verp.add_argument("--no-shrink", action="store_true",
                      help="skip minimizing a found counterexample")
    verp.add_argument("--corpus-dir", default=None,
                      help="append shrunk counterexamples to this corpus "
                           "(violations.jsonl)")
    verp.add_argument("--mesh-dp", type=int, default=None,
                      help="shard the candidates over a dp mesh of this "
                           "many ranks (started here outside a "
                           "torch.distributed world)")
    verp.add_argument("--state-dir", default=None, metavar="DIR",
                      help="persist per-round search state here; a killed "
                           "campaign continues on the next identical run")
    verp.add_argument("--resume", dest="resume", action="store_true",
                      default=True,
                      help="continue a persisted --state-dir campaign "
                           "(the default)")
    verp.add_argument("--no-resume", dest="resume", action="store_false",
                      help="ignore persisted --state-dir state")
    verp.add_argument("--reset-state", action="store_true",
                      help="delete persisted --state-dir campaign state "
                           "first")
    verp.add_argument("--telemetry-dir", default=None,
                      help="stream the round and verdict events (and a "
                           "manifest and summary) into this run "
                           "directory")
    verp.add_argument("--budget-rounds", type=int, default=8,
                      help="fleet only: fuzzing rounds before the "
                           "campaign rests (default 8; re-running with a "
                           "larger value extends a persisted campaign)")
    verp.add_argument("--serve-idle", action="store_true",
                      help="fleet only: run the campaign as the background "
                           "tenant of a local serve engine (preempted by "
                           "any foreground traffic) instead of inline")
    verp.add_argument("--json", action="store_true",
                      help="machine-readable output (one JSON object)")
    verp.set_defaults(fn=cmd_verify)


def cmd_scenario(args) -> int:
    """Scenario-platform commands. ``list`` prints the registry; ``gen``
    runs the seeded procedural generator (enrolling the batch for this
    process, optionally running every scenario on ``--device``); ``run``
    executes one registered scenario end to end (``--gen-seed``
    regenerates a batch in-process so generated names resolve)."""
    from cbf_tpu_torch.scenarios.platform import dsl, registry

    if args.scenario_command == "list":
        print(json.dumps({"scenarios": [
            {"name": e.name, "adapter": e.adapter,
             "steps_field": e.steps_field, "servable": e.servable,
             "generated": e.generated} for e in registry.entries()]}))
        return 0

    if args.scenario_command == "gen":
        sink = None
        if args.telemetry_dir:
            from cbf_tpu_torch import obs
            from cbf_tpu_torch.scenarios import swarm

            sink = obs.TelemetrySink(
                args.telemetry_dir,
                manifest=obs.build_manifest(swarm.Config(), extra={
                    "scenario": "platform.gen", "gen_seed": args.seed,
                    "gen_count": args.count, "device": args.device}))
        specs = dsl.generate(args.seed, count=args.count, telemetry=sink)
        dsl.enroll(specs, replace=True)
        record = {"seed": args.seed, "count": len(specs),
                  "scenarios": [dataclasses.asdict(s) for s in specs]}
        if args.run:
            runs = []
            for s in specs:
                _final, outs = dsl.run_spec(s, telemetry=sink,
                                            device=args.device)
                md, infeasible = dsl.run_summary(outs)
                runs.append({"scenario": s.name,
                             "min_pairwise_distance": round(md, 6),
                             "infeasible_count": infeasible})
            record["runs"] = runs
        if sink is not None:
            sink.summary()
            sink.close()
            record["telemetry"] = sink.run_dir
        print(json.dumps(record))
        return 0

    # scenario run NAME
    if args.gen_seed is not None:
        dsl.enroll(dsl.generate(args.gen_seed, count=args.gen_count),
                   replace=True)
    try:
        entry = registry.get(args.name)
    except KeyError as e:
        print(f"scenario run: {e.args[0]}", file=sys.stderr)
        return 2
    if not entry.servable:
        print(f"scenario run: {args.name!r} is not a platform "
              "(swarm.Config) scenario — use `python -m cbf_tpu_torch run "
              f"{args.name}`", file=sys.stderr)
        return 2
    if args.tiles is not None and args.partition != "spatial":
        print("scenario run: --tiles needs --partition spatial",
              file=sys.stderr)
        return 2
    if args.partition == "spatial":
        return _scenario_run_spatial(args, entry)
    cfg = _apply_overrides(entry.make_config(), args.set, args.steps,
                           entry.steps_field, need_trajectory=False)
    sink = None
    if args.telemetry_dir:
        from cbf_tpu_torch import obs

        sink = obs.TelemetrySink(
            args.telemetry_dir,
            manifest=obs.build_manifest(cfg, extra={
                "scenario": args.name, "steps": cfg.steps,
                "device": args.device}))
    _final, outs = dsl.run_config(args.name, cfg, telemetry=sink,
                                  device=args.device)
    md, infeasible = dsl.run_summary(outs)
    record = {"scenario": args.name, "n": cfg.n, "steps": cfg.steps,
              "dynamics": cfg.dynamics,
              "min_pairwise_distance": round(md, 6),
              "infeasible_count": infeasible}
    if sink is not None:
        sink.summary()
        sink.close()
        record["telemetry"] = sink.run_dir
    print(json.dumps(record))
    return 0


def _scenario_run_spatial(args, entry) -> int:
    """``scenario run --partition spatial``: the swarm tiled over
    ``--tiles`` ranks (default: the world's ranks inside a world, else
    every card, or 8 on the CPU — the JAX CLI's virtual devices), the
    JAX package's record with the tile ledger, exit 2 on a rejected
    configuration."""
    import numpy as np

    from cbf_tpu_torch.parallel import multihost
    from cbf_tpu_torch.parallel.mesh import make_mesh
    from cbf_tpu_torch.parallel.spatial import (plan_tiles,
                                                spatial_swarm_rollout)

    in_world = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    tiles = args.tiles or (int(os.environ["WORLD_SIZE"]) if in_world
                           else 8 if args.device == "cpu"
                           else max(1, torch.cuda.device_count()))
    rc = _world_launch(args, tiles)
    if rc is not None:
        return rc
    cfg = _apply_overrides(entry.make_config(), args.set, args.steps,
                           entry.steps_field, need_trajectory=False)
    sink = None
    if args.telemetry_dir:
        from cbf_tpu_torch import obs

        sink = obs.TelemetrySink(
            args.telemetry_dir,
            manifest=obs.build_manifest(cfg, extra={
                "scenario": args.name, "steps": cfg.steps,
                "device": args.device}))
    try:
        mesh = make_mesh(n_dp=1, n_sp=tiles,
                         devices="cpu" if args.device == "cpu" else None)
        if mesh is None:               # a rank beyond the tiles
            return 0
        spec = plan_tiles(cfg, tiles)
        _final, mets, rep = spatial_swarm_rollout(cfg, mesh, spec=spec,
                                                  telemetry=sink)
    except ValueError as e:
        print(f"scenario run --partition spatial: {e}", file=sys.stderr)
        return 2
    record = {"scenario": args.name, "n": cfg.n, "steps": cfg.steps,
              "dynamics": cfg.dynamics, "partition": "spatial",
              "tiles": tiles, "capacity": spec.capacity,
              "halo_capacity": spec.halo_capacity,
              "rebin_every": spec.rebin_every,
              "epochs": rep.epochs,
              "overflow_total": rep.overflow_total,
              "halo_dropped_total": rep.halo_dropped_total,
              "occupancy_max": rep.occupancy_max,
              "min_pairwise_distance": round(float(
                  np.min(mets.nearest_distance)), 6),
              "infeasible_count": int(np.sum(mets.infeasible_count))}
    if sink is not None:
        sink.summary()
        sink.close()
        record["telemetry"] = sink.run_dir
    if multihost.is_primary():
        print(json.dumps(record))
    return 0


def _add_scenario_parser(sub) -> None:
    def device_arg(parser):
        parser.add_argument("--device", "--platform", dest="device",
                            default="cuda", choices=("cuda", "cpu"),
                            help="where the rollouts run (default: the "
                                 "card; without one a run raises)")

    scenp = sub.add_parser(
        "scenario", help="scenario platform: list the registry, generate "
                         "a seeded procedural batch, or run one")
    scen_sub = scenp.add_subparsers(dest="scenario_command", required=True)
    slistp = scen_sub.add_parser(
        "list", help="print the scenario registry as JSON")
    slistp.set_defaults(fn=cmd_scenario)
    sgenp = scen_sub.add_parser(
        "gen", help="seeded procedural generation: same seed, same specs")
    device_arg(sgenp)
    sgenp.add_argument("--seed", type=int, default=0,
                       help="generator seed (default 0)")
    sgenp.add_argument("--count", type=int, default=20,
                       help="specs to generate (default 20; index 3 is "
                            "pinned mixed-dynamics)")
    sgenp.add_argument("--run", action="store_true",
                       help="also run every generated scenario and report "
                            "its safety aggregates")
    sgenp.add_argument("--telemetry-dir", default=None,
                       help="write scenario.generated (+ scenario.run "
                            "with --run) events into a run directory")
    sgenp.set_defaults(fn=cmd_scenario)
    srunp = scen_sub.add_parser(
        "run", help="run one registered scenario end to end")
    srunp.add_argument("name", help="registered scenario name (builtin, "
                                    "or generated via --gen-seed)")
    device_arg(srunp)
    srunp.add_argument("--gen-seed", type=int, default=None,
                       help="regenerate+enroll this generator batch "
                            "first, so generated names resolve")
    srunp.add_argument("--gen-count", type=int, default=20,
                       help="batch size for --gen-seed (default 20)")
    srunp.add_argument("--steps", type=int, default=None,
                       help="override the rollout horizon")
    srunp.add_argument("--set", action="append", default=[],
                       metavar="FIELD=VALUE",
                       help="override any config field")
    srunp.add_argument("--telemetry-dir", default=None,
                       help="write a run directory with a scenario.run "
                            "event")
    srunp.add_argument("--partition", default="flat",
                       choices=("flat", "spatial"),
                       help="rollout decomposition: flat (default) or "
                            "spatial (domain-decomposed tiles, one rank "
                            "each)")
    srunp.add_argument("--tiles", type=int, default=None,
                       help="spatial tile count; only with --partition "
                            "spatial")
    srunp.set_defaults(fn=cmd_scenario)


def cmd_lint(args) -> int:
    """Static analysis gate (counterpart: the JAX CLI's ``lint``): the AST
    capture-safety and program-cache rules over the given paths, plus
    (``--all``) the program checks on the captured step, the repo audits,
    the concurrency analyser and the SPMD analyser; ``--write-spmd-budget``
    rewrites the committed census. Exit 0 = clean (modulo the baseline),
    1 = unsuppressed findings or stale baseline entries, 2 = analyser
    failure (malformed baseline or budget, unreadable path, a census that
    cannot be written)."""
    from cbf_tpu_torch.analysis import report
    from cbf_tpu_torch.analysis.baseline import BaselineError
    from cbf_tpu_torch.analysis.mesh_budget import BudgetError

    if args.write_spmd_budget:
        from cbf_tpu_torch.analysis import mesh_budget, spmd_rules

        reports, findings = spmd_rules.entrypoint_reports(
            args.entrypoint or None, device=args.device)
        if findings:
            for f in findings:
                print(f"lint: {f.symbol}: {f.message}", file=sys.stderr)
            return 2
        try:
            mesh_budget.write(reports, reason=args.reason)
        except BudgetError as e:
            print(f"lint: {e}", file=sys.stderr)
            return 2
        print(f"wrote {mesh_budget.DEFAULT_PATH} "
              f"({len(reports)} entr{'ies' if len(reports) != 1 else 'y'})")
        return 0
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # Default to the path set the tier-1 gate lints, so "what the gate
    # enforces" and "what the terminal shows" cannot drift apart.
    paths = args.paths or [
        p for p in (os.path.join(repo_root, d)
                    for d in ("cbf_tpu_torch", "chip_smoke.py"))
        if os.path.exists(p)]
    try:
        result = report.run_lint(
            paths, repo_root=repo_root, baseline_path=args.baseline,
            jaxpr=args.all or args.jaxpr, audits=args.all,
            concurrency=args.all or args.concurrency,
            spmd=args.all or args.spmd,
            entrypoints=args.entrypoint or None, device=args.device)
    except (BaselineError, BudgetError, OSError) as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(report.render_json(result,
                                 show_suppressed=args.show_suppressed))
    else:
        print(report.render_text(result,
                                 show_suppressed=args.show_suppressed))
    return result.exit_code


def _add_lint_parser(sub) -> None:
    lintp = sub.add_parser(
        "lint", help="static analysis: capture-safety and program-cache "
                     "rules (README, PyTorch/CUDA port, 'Static "
                     "analysis')")
    lintp.add_argument("paths", nargs="*",
                       help="files/directories to lint (default: the "
                            "cbf_tpu_torch package and chip_smoke.py)")
    lintp.add_argument("--all", action="store_true",
                       help="also run the program checks on the captured "
                            "step (JX0xx), the repo audits (AUD0xx), the "
                            "concurrency analyser (CC0xx) and the SPMD "
                            "analyser (SP0xx)")
    lintp.add_argument("--jaxpr", action="store_true",
                       help="also run just the program checks on the "
                            "captured step (JX0xx; the JAX CLI's name)")
    lintp.add_argument("--concurrency", action="store_true",
                       help="also run just the concurrency analyser "
                            "(CC0xx: lock discipline, lock-order graph)")
    lintp.add_argument("--spmd", action="store_true",
                       help="also run just the SPMD analyser (SP0xx: one "
                            "call of each sharded entry point in a world "
                            "of 4 ranks, its collective census against "
                            "cbf_tpu_torch/analysis/spmd_budget.toml, "
                            "peak memory and replication on the card)")
    lintp.add_argument("--write-spmd-budget", action="store_true",
                       help="regenerate cbf_tpu_torch/analysis/"
                            "spmd_budget.toml from a fresh census "
                            "(changed/new rows need --reason; on the CPU "
                            "each row keeps its peak_bytes)")
    lintp.add_argument("--reason", default=None, metavar="TEXT",
                       help="with --write-spmd-budget: why the new "
                            "census is intended (stored per changed row)")
    lintp.add_argument("--entrypoint", action="append", default=[],
                       metavar="NAME",
                       help="restrict the program checks and the SPMD "
                            "census to these entry points (repeatable; "
                            "see analysis.program_rules.entrypoint_specs "
                            "and analysis.spmd_rules.spmd_entrypoints)")
    lintp.add_argument("--json", action="store_true",
                       help="machine-readable output (one JSON object)")
    lintp.add_argument("--baseline", default=None,
                       help="suppression file (default: "
                            "cbf_tpu_torch/analysis/baseline.toml)")
    lintp.add_argument("--show-suppressed", action="store_true",
                       help="also print baseline-suppressed findings "
                            "with their reasons")
    lintp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where the program checks, the chain-depth "
                            "audit and the SPMD census run (default: the "
                            "card; without one they fail)")
    lintp.set_defaults(fn=cmd_lint)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cbf_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    runp = sub.add_parser("run", help="run a scenario")
    runp.add_argument("scenario", nargs="?", default=None,
                      choices=sorted(_scenarios()))
    runp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                      help="where the rollout runs (default: the card; "
                           "without one the run raises)")
    runp.add_argument("--steps", type=int, default=None,
                      help="rollout horizon (maps to steps/iterations)")
    runp.add_argument("--set", action="append", default=[],
                      metavar="FIELD=VALUE", help="override any config field")
    runp.add_argument("--video", default=None,
                      help="write a replay video/gif here")
    runp.add_argument("--traj", default=None,
                      help="stream recorded positions to this .cbt file "
                           "(native async sink; read back with "
                           "cbf_tpu_torch.native.trajsink.read_trajectory)")
    runp.add_argument("--rta", action="store_true",
                      help="arm the runtime-assurance fallback ladder "
                           "(swarm scenario; shorthand for --set rta=true)")
    runp.add_argument("--checkpoint-dir", default=None,
                      help="checkpoint every chunk boundary here; a rerun "
                           "resumes from the newest intact step")
    runp.add_argument("--chunk", type=int, default=1000,
                      help="steps per compiled chunk when checkpointing")
    runp.add_argument("--no-resume", action="store_true")
    runp.add_argument("--durable-dir", default=None, metavar="DIR",
                      help="run through the crash-recoverable runner: run "
                           "spec, integrity-checked checkpoints and "
                           "per-chunk outputs land here; a killed run "
                           "continues bit-exactly via `run --resume DIR`")
    runp.add_argument("--resume", default=None, metavar="DIR",
                      help="continue a killed durable run from its "
                           "directory alone (exit 2 when the spec is "
                           "missing or corrupt)")
    runp.add_argument("--profile-dir", default=None,
                      help="write a torch.profiler Chrome trace here")
    runp.add_argument("--checked", action="store_true",
                      help="check every step's state and outputs for "
                           "NaN/inf and stop at the first")
    runp.add_argument("--telemetry-dir", default=None,
                      help="stream in-flight telemetry (manifest, JSONL "
                           "heartbeats, alerts) into this run directory; "
                           "tail it with `obs tail <dir> --follow`")
    runp.add_argument("--telemetry-every", type=int, default=50,
                      help="heartbeat sampling interval in steps "
                           "(default 50)")
    runp.add_argument("--stall-timeout", type=float, default=None,
                      help="watchdog missed-heartbeat alert after this "
                           "many silent seconds (default: off; the first "
                           "heartbeat waits on the first capture)")
    runp.set_defaults(fn=cmd_run)

    listp = sub.add_parser("list", help="list scenarios and their knobs")
    listp.set_defaults(fn=cmd_list)
    _add_verify_parser(sub)
    _add_scenario_parser(sub)

    obsp = sub.add_parser("obs", help="telemetry run-dir tools (tail, "
                                      "summary, top, lanes, incident)")
    obs_sub = obsp.add_subparsers(dest="obs_command", required=True)
    tailp = obs_sub.add_parser(
        "tail", help="print a run's JSONL events; -f follows live")
    tailp.add_argument("run_dir")
    tailp.add_argument("--follow", "-f", action="store_true",
                       help="keep tailing until the summary event")
    tailp.add_argument("--stall-timeout", type=float, default=None,
                       help="with --follow: emit a synthetic stall alert "
                            "and exit 3 after this many heartbeat-less "
                            "seconds")
    tailp.add_argument("--latest", action="store_true",
                       help="run_dir is a root; tail its newest run "
                            "(waits for one to appear with --follow)")
    tailp.set_defaults(fn=cmd_obs_tail)
    sump = obs_sub.add_parser(
        "summary", help="aggregate a run directory into one JSON object")
    sump.add_argument("run_dir")
    sump.add_argument("--latest", action="store_true",
                      help="run_dir is a root; summarize its newest run")
    sump.set_defaults(fn=cmd_obs_summary)

    topp = obs_sub.add_parser(
        "top", help="live terminal view over a --metrics-dir surface "
                    "(reads the metrics.json twin of metrics.prom)")
    topp.add_argument("run_dir", nargs="?", default=None)
    topp.add_argument("--merge", nargs="+", default=None, metavar="DIR",
                      help="aggregate MULTIPLE metrics dirs into one "
                           "merged table; counters/histograms add, "
                           "gauges min/max-merge; the stall contract is "
                           "judged PER dir (any stalled dir exits 3)")
    topp.add_argument("--glob", default=None, metavar="PATTERN",
                      help="like --merge with the dir list expanded "
                           "from a shell glob pattern (quote it)")
    _add_follow_args(topp)
    topp.set_defaults(fn=cmd_obs_top)
    lanesp = obs_sub.add_parser(
        "lanes", help="lane occupancy table over a --metrics-dir surface "
                      "(serve.lanes.* twins); --export-timeline rebuilds "
                      "the Perfetto per-lane timeline from a run "
                      "directory's serve.span events")
    lanesp.add_argument("run_dir")
    _add_follow_args(lanesp)
    lanesp.add_argument("--export-timeline", default=None, metavar="PATH",
                        help="write the Chrome/Perfetto trace JSON "
                             "(per-lane tracks + enqueue->lane flow "
                             "links) rebuilt from run_dir's events.jsonl, "
                             "then exit")
    lanesp.set_defaults(fn=cmd_obs_lanes)

    incp = obs_sub.add_parser(
        "incident", help="summarize an incident capsule written by the "
                         "flight recorder; --replay re-runs the captured "
                         "request")
    incp.add_argument("capsule_dir")
    incp.add_argument("--latest", action="store_true",
                      help="capsule_dir is a recorder root; pick its "
                           "newest capsule")
    incp.add_argument("--replay", action="store_true",
                      help="re-run the captured request.json standalone; "
                           "exit 0 iff the outcome matches its 'expect'")
    incp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                      help="where --replay runs (default: the card)")
    incp.add_argument("--json", action="store_true",
                      help="one-line machine-readable output")
    incp.set_defaults(fn=cmd_obs_incident)

    servep = sub.add_parser(
        "serve", help="batch-serve a rollout request file through the "
                      "shape-bucketed serving engine")
    servep.add_argument("requests", nargs="?", default=None,
                        help="JSON request file: a list (or {'requests': "
                             "[...]}) of {steps, seed, overrides{...}, "
                             "repeat} objects over swarm.Config fields "
                             "(optional with --recover)")
    servep.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the programs run (default: the card; "
                             "without one the engine raises)")
    servep.add_argument("--max-batch", type=int, default=8,
                        help="lockstep micro-batch size per bucket "
                             "(default 8; the batch axis is padded to it)")
    servep.add_argument("--flush-deadline", type=float, default=0.05,
                        help="queue-mode flush deadline in seconds "
                             "(recorded; offline drain batches eagerly)")
    servep.add_argument("--prewarm", action="store_true",
                        help="capture every bucket's program before "
                             "serving")
    servep.add_argument("--prewarm-only", action="store_true",
                        help="capture the request file's buckets and "
                             "exit")
    servep.add_argument("--cache-dir", default=None,
                        help="the CBF_TPU_CACHE_DIR knob, recorded in the "
                             "manifest (CUDA graphs do not persist across "
                             "processes; the kernels' objects in "
                             "csrc/_build/ do)")
    servep.add_argument("--telemetry-dir", default=None,
                        help="write a serve run directory: manifest with "
                             "bucket/capture attribution, one 'request' "
                             "event per served request, the cost model "
                             "and flight-recorder capsules")
    servep.add_argument("--journal", default=None, metavar="PATH",
                        help="write-ahead request journal: every accepted "
                             "request is fsynced to this JSONL file "
                             "before it is acknowledged, every outcome "
                             "before the caller unblocks")
    servep.add_argument("--recover", action="store_true",
                        help="with --journal: re-run every acknowledged-"
                             "but-unresolved request from a previous "
                             "process's journal instead of (or before) a "
                             "requests file; exit 2 when the journal is "
                             "missing or unreadable")
    servep.add_argument("--rotate-bytes", type=int, default=None,
                        metavar="N",
                        help="with --journal: rotate the active journal "
                             "file to an immutable .segNNNNNN segment "
                             "once it crosses N bytes (fully-resolved "
                             "segments are compacted away)")
    servep.add_argument("--pace-s", type=float, default=None,
                        metavar="S",
                        help="queue-mode paced submits: one request every "
                             "S seconds instead of an all-at-once offline "
                             "drain")
    _add_metrics_args(servep)
    _add_continuous_args(servep)
    _add_fault_policy_args(servep)
    servep.add_argument("--lease", default=None, metavar="PATH",
                        help="serve as an HA PRIMARY: acquire this lease "
                             "file (bumping its epoch), heartbeat it, and "
                             "fence the journal with it — a standby "
                             "takeover makes this process exit 4 "
                             "(requires --journal)")
    servep.add_argument("--heartbeat-s", type=float, default=0.2,
                        help="lease heartbeat interval in seconds "
                             "(default 0.2)")
    servep.add_argument("--supervised", action="store_true",
                        help="run this serve command under the HA "
                             "supervisor: restart on crash with "
                             "exponential backoff, exit 3 on a crash "
                             "loop, pass a fenced child's exit 4 through "
                             "without restarting")
    servep.add_argument("--max-restarts", type=int, default=5,
                        help="supervisor crash-loop breaker: more than "
                             "this many crashes inside --crash-window-s "
                             "exits 3 (default 5)")
    servep.add_argument("--crash-window-s", type=float, default=30.0,
                        help="supervisor crash-loop rolling window in "
                             "seconds (default 30)")
    servep.add_argument("--backoff-base-s", type=float, default=0.2,
                        help="supervisor restart backoff base in seconds "
                             "(doubles per consecutive crash; default "
                             "0.2)")
    servep.add_argument("--backoff-max-s", type=float, default=5.0,
                        help="supervisor restart backoff ceiling in "
                             "seconds (default 5)")
    servep.add_argument("--ha-standby", action="store_true",
                        help="serve as an HA HOT STANDBY: initialise the "
                             "device, capture the journal's buckets, "
                             "watch the lease, and on expiry take over "
                             "under a bumped epoch (requires --lease and "
                             "--journal)")
    servep.add_argument("--lease-ttl-s", type=float, default=2.0,
                        help="standby: declare the lease expired after "
                             "this many seconds without a heartbeat "
                             "change (default 2)")
    servep.add_argument("--ready-file", default=None, metavar="PATH",
                        help="standby: touch this file once hot (device "
                             "initialised, captured, watching) — the "
                             "harness handshake")
    servep.add_argument("--standby-max-wait-s", type=float, default=600.0,
                        help="standby: give up waiting for a takeover "
                             "after this many seconds (default 600)")
    servep.set_defaults(fn=cmd_serve)

    loadp = sub.add_parser(
        "loadgen", help="open-loop SLO load generation against the "
                        "serving engine: sustained RPS + latency "
                        "percentiles")
    loadp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where the programs run (default: the card; "
                            "without one the engine raises)")
    loadp.add_argument("--rps", type=float, default=8.0,
                       help="offered Poisson arrival rate, requests/s "
                            "(default 8)")
    loadp.add_argument("--duration", type=float, default=5.0,
                       help="arrival window in seconds (default 5)")
    loadp.add_argument("--seed", type=int, default=0,
                       help="schedule seed (same seed = same traffic)")
    loadp.add_argument("--n-min", type=int, default=8,
                       help="bounded-Pareto request-size lower bound")
    loadp.add_argument("--n-max", type=int, default=96,
                       help="bounded-Pareto request-size upper bound")
    loadp.add_argument("--pareto-alpha", type=float, default=1.3,
                       help="size-distribution tail index (smaller = "
                            "heavier tail; default 1.3)")
    loadp.add_argument("--steps", default="20,40,60",
                       help="comma-separated horizon mix (default "
                            "20,40,60)")
    loadp.add_argument("--gating", default="jnp",
                       help="gating backend for generated requests "
                            "(default jnp: the dense path, no kernel; "
                            "pallas runs knn_fused)")
    loadp.add_argument("--max-batch", type=int, default=8,
                       help="engine micro-batch size (default 8)")
    loadp.add_argument("--flush-deadline", type=float, default=0.05,
                       help="engine queue flush deadline in seconds "
                            "(default 0.05)")
    loadp.add_argument("--cache-dir", default=None,
                       help="the CBF_TPU_CACHE_DIR knob, recorded in the "
                            "manifest")
    loadp.add_argument("--telemetry-dir", default=None,
                       help="write a run directory with serve.span + "
                            "request + loadgen.summary JSONL events")
    _add_metrics_args(loadp)
    loadp.add_argument("--chrome-trace", default=None,
                       help="export the request-lifecycle spans as "
                            "Chrome trace-event JSON here (load in "
                            "Perfetto / chrome://tracing)")
    loadp.add_argument("--xla-trace", default=None,
                       help="also write a torch.profiler trace (the "
                            "card's activity too) into this directory")
    loadp.add_argument("--sweep-rps", default=None, metavar="LO:HI:STEP",
                       help="sweep offered rps over an inclusive grid "
                            "(one loadgen leg per point, same seed) and "
                            "report the knee: the highest swept rps whose "
                            "latency p99 stays within --slo-p99")
    loadp.add_argument("--slo-p99", type=float, default=1.0,
                       help="end-to-end latency p99 bound in seconds "
                            "used by --sweep-rps knee detection "
                            "(default 1.0)")
    _add_continuous_args(loadp)
    _add_fault_policy_args(loadp)
    loadp.set_defaults(fn=cmd_loadgen)

    clup = sub.add_parser(
        "cluster", help="routed multi-engine serve cluster: consistent-"
                        "hash placement, cost-model admission, work "
                        "stealing, zero-loss rolling restarts")
    clu_sub = clup.add_subparsers(dest="cluster_command", required=True)
    cwp = clu_sub.add_parser(
        "worker", help="one cluster engine process: claim/ack/respond "
                       "loop over this engine's transport directories")
    cwp.add_argument("--root", required=True,
                     help="cluster root directory (shared with the "
                          "router)")
    cwp.add_argument("--name", required=True,
                     help="engine name (its transport subtree is "
                          "<root>/engines/<name>)")
    cwp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="where the engine's programs run (default: the "
                          "card; without one the worker raises)")
    cwp.add_argument("--max-batch", type=int, default=8,
                     help="engine micro-batch size (default 8)")
    cwp.add_argument("--flush-deadline", type=float, default=0.05,
                     help="engine queue flush deadline in seconds "
                          "(default 0.05)")
    cwp.add_argument("--heartbeat-s", type=float, default=0.2,
                     help="lease heartbeat interval in seconds "
                          "(default 0.2)")
    cwp.add_argument("--cache-dir", default=None,
                     help="the CBF_TPU_CACHE_DIR knob, recorded in the "
                          "manifest (CUDA graphs do not persist across "
                          "processes)")
    cwp.add_argument("--poll-s", type=float, default=0.005,
                     help="inbox poll interval in seconds "
                          "(default 0.005)")
    cwp.add_argument("--telemetry", action="store_true",
                     help="write this engine's JSONL run directory "
                          "under <root>/engines/<name>/telemetry")
    cwp.add_argument("--metrics", action="store_true",
                     help="rewrite this engine's metrics surface under "
                          "<root>/engines/<name>/metrics at --metrics-"
                          "every cadence; aggregate M engines with "
                          "`obs top --merge`")
    cwp.add_argument("--metrics-every", type=float, default=2.0,
                     help="metrics rewrite cadence in seconds "
                          "(default 2)")
    cwp.set_defaults(fn=cmd_cluster_worker)
    csp = clu_sub.add_parser(
        "serve", help="serve a request file through a routed M-engine "
                      "cluster; exit 0 iff the cluster-wide exactly-"
                      "once census is clean")
    csp.add_argument("requests",
                     help="JSON request file (same format as `serve`)")
    csp.add_argument("--engines", type=int, default=2,
                     help="number of worker engines to spawn "
                          "(default 2)")
    csp.add_argument("--root", default=None,
                     help="cluster root directory (default: a fresh "
                          "temp dir)")
    csp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="device of the WORKER processes (default: the "
                          "card; the router itself never touches a "
                          "device)")
    csp.add_argument("--max-batch", type=int, default=8,
                     help="per-engine micro-batch size (default 8)")
    csp.add_argument("--flush-deadline", type=float, default=0.05,
                     help="per-engine flush deadline in seconds "
                          "(default 0.05)")
    csp.add_argument("--heartbeat-s", type=float, default=0.2,
                     help="worker lease heartbeat interval in seconds "
                          "(default 0.2)")
    csp.add_argument("--lease-ttl-s", type=float, default=2.0,
                     help="declare an engine dead after this many "
                          "seconds without a heartbeat change "
                          "(default 2)")
    csp.add_argument("--cache-dir", default=None,
                     help="the CBF_TPU_CACHE_DIR knob passed to every "
                          "engine, recorded in their manifests")
    csp.add_argument("--steal", action="store_true",
                     help="enable work stealing: re-route queued-but-"
                          "unacknowledged requests from a hotspotted "
                          "engine to an idle one")
    csp.add_argument("--steal-threshold", type=int, default=4,
                     help="unclaimed inbox depth that marks an engine "
                          "hotspotted (default 4)")
    csp.add_argument("--roll", action="store_true",
                     help="run one full rolling restart (drain-then-"
                          "restart each engine) while the requests "
                          "drain; gated on zero lost acks")
    csp.add_argument("--prewarm", action="store_true",
                     help="publish the request file's buckets as the "
                          "cluster prewarm set before the engines boot")
    csp.add_argument("--worker-metrics", action="store_true",
                     help="pass --metrics to every worker (per-engine "
                          "metrics/ surfaces for `obs top --merge`)")
    csp.add_argument("--telemetry-dir", default=None,
                     help="router-side run directory: cluster.route/"
                          "steal/member/roll events (+ costmodel.json "
                          "admission when present)")
    csp.add_argument("--budget-bytes", type=int, default=None,
                     help="per-request device-memory admission budget "
                          "(needs a costmodel.json in --telemetry-dir; "
                          "unpriced shapes fail open)")
    csp.add_argument("--ready-timeout", type=float, default=180.0,
                     help="seconds to wait for each engine's ready "
                          "file at boot (default 180)")
    csp.add_argument("--result-timeout", type=float, default=300.0,
                     help="seconds to wait for each routed result "
                          "(default 300)")
    csp.set_defaults(fn=cmd_cluster_serve)
    _add_lint_parser(sub)

    args = p.parse_args(argv)
    # The command line itself, for commands that start ranks of this CLI.
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
