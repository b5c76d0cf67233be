"""CLI frontend: ``python -m cbf_tpu_torch <command>`` (counterpart:
cbf_tpu/__main__.py, its ``run``, ``list`` and ``verify`` subcommands).

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
``verify fleet`` and ``serve`` (the serving slice's scheduler) raise
OutOfSliceError. The other subcommands (loadgen, scenario, lint, ``obs
top``/``incident``/``lanes``, cluster, bench) are not ported yet.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import torch

from cbf_tpu_torch.errors import SLICE_SERVE, OutOfSliceError

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

    if scenario == "swarm":
        base = swarm.default_cbf(cfg, device=device)
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


def cmd_serve(args) -> int:
    """``serve``: the ServeEngine's CLI, which comes with the scheduler
    (the bucket and packing layer and the lockstep programs are ported:
    :mod:`cbf_tpu_torch.serve`)."""
    raise OutOfSliceError("the serve CLI (ServeEngine)", SLICE_SERVE)


def cmd_verify(args) -> int:
    """Falsification sweep (module docstring); exit 0 = survived, 3 =
    violation found."""
    if args.scenario == "fleet":
        raise OutOfSliceError("verify fleet (the falsification fleet)",
                              SLICE_SERVE)
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
        removed = V.reset_campaign_state(args.state_dir)
        if removed and not args.json:
            print(f"reset: removed {len(removed)} persisted campaign "
                  f"state file(s) from {args.state_dir}")
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
                      help="one scenario to falsify ('fleet' is not "
                           "ported yet: raises)")
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
                      help="proposal std in metres (default 0.04)")
    verp.add_argument("--perturb-norm", type=float, default=None,
                      help="per-agent L2 cap on perturbations (default "
                           "0.1 m)")
    verp.add_argument("--no-shrink", action="store_true",
                      help="skip minimizing a found counterexample")
    verp.add_argument("--corpus-dir", default=None,
                      help="append shrunk counterexamples to this corpus "
                           "(violations.jsonl)")
    verp.add_argument("--mesh-dp", type=int, default=None,
                      help="shard the candidates over a dp mesh (1 on one "
                           "card; more raises)")
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
                      help="fleet only (not ported yet)")
    verp.add_argument("--serve-idle", action="store_true",
                      help="fleet only (not ported yet)")
    verp.add_argument("--json", action="store_true",
                      help="machine-readable output (one JSON object)")
    verp.set_defaults(fn=cmd_verify)


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

    obsp = sub.add_parser("obs", help="telemetry run-dir tools (tail, "
                                      "summary)")
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

    servep = sub.add_parser(
        "serve", help="the serving engine (not ported yet: Queue A11)")
    servep.set_defaults(fn=cmd_serve)

    args, extra = p.parse_known_args(argv)
    if extra and args.command != "serve":   # serve raises whatever it gets
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
