"""CLI frontend: ``python -m cbf_tpu_torch <command>`` (counterpart:
cbf_tpu/__main__.py, its ``run``, ``list`` and ``verify`` subcommands).

    python -m cbf_tpu_torch list
    python -m cbf_tpu_torch run meet_at_center --steps 200 --video out.gif
    python -m cbf_tpu_torch run swarm --set n=4096 --steps 200 --traj run.cbt
    python -m cbf_tpu_torch run antipodal --device cpu
    python -m cbf_tpu_torch verify swarm --set n=16 --weaken dmin=0.16

Scenarios are dataclass configs; ``--set field=value`` overrides any field
(typed by the field's default), ``--steps`` sets whichever field the
scenario calls its horizon (steps/iterations). A run is one compiled
``rollout`` on ``--device`` (default ``cuda``, the card; without one the
run raises — pass ``--device cpu`` for the CPU) and prints one JSON
summary line, as the JAX package's ``run`` does.

The durable, checked, telemetry and profiling options of the JAX
package's ``run`` raise :class:`~cbf_tpu_torch.errors.OutOfSliceError`
until the durability and observability slice ports them; the options
that only qualify those (``--chunk``, ``--no-resume``,
``--telemetry-every``) come with them.

``verify`` is the falsification sweep (:mod:`cbf_tpu_torch.verify`): the
engines search for initial-state perturbations that violate a safety
property, a found one is shrunk and confirmed in float64 and, with
``--corpus-dir``, archived. Exit 0: the filter survived the budget; 3: a
violation was found; 2: a persisted campaign does not match the
settings. ``verify fleet`` (the serving slice) and ``--telemetry-dir``
(the durability and observability slice) raise OutOfSliceError. The
other subcommands (serve, loadgen, scenario, lint, obs, cluster, bench)
are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from cbf_tpu_torch.errors import SLICE_DURABLE, SLICE_SERVE, OutOfSliceError

# run's options that arrive with the durability and observability slice.
_OUT_OF_SLICE = ("checkpoint_dir", "durable_dir", "resume", "checked",
                 "telemetry_dir", "profile_dir", "stall_timeout")
# Frames per append when streaming a trajectory to the native sink: keeps
# the sink's copy and queue memory flat while disk writes overlap.
_TRAJ_CHUNK = 1024


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
        return render_swarm(outs.trajectory.cpu().numpy(), path,
                            obstacles=obstacles)

    # Last field: the recorded trajectory layout — "dims_major" = (T, 2, N)
    # columns-of-agents (the sim-layer convention), "agent_major" = (T, N, 2).
    return {
        "meet_at_center": (meet_at_center, "iterations",
                           lambda outs, cfg, path, start=0: render_meet_at_center(
                               outs.trajectory.cpu().numpy(), path,
                               n_obstacles=cfg.n_obstacles),
                           "dims_major"),
        "cross_and_rescue": (cross_and_rescue, "iterations",
                             lambda outs, cfg, path, start=0: render_cross_and_rescue(
                                 tuple(v.cpu().numpy() for v in outs.trajectory),
                                 path, goal=cfg.goal),
                             "dims_major"),
        "swarm": (swarm, "steps", _render_swarm, "agent_major"),
        "antipodal": (antipodal, "steps",
                      lambda outs, cfg, path, start=0: render_swarm(
                          outs.trajectory.cpu().numpy(), path),
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


def _reject_out_of_slice(args) -> None:
    for name in _OUT_OF_SLICE:
        if getattr(args, name) not in (None, False):
            raise OutOfSliceError(f"run --{name.replace('_', '-')}",
                                  SLICE_DURABLE)


def cmd_run(args) -> int:
    _reject_out_of_slice(args)
    if args.scenario is None:
        print("run: a scenario is required", file=sys.stderr)
        return 2

    from cbf_tpu_torch.rollout.engine import rollout
    from cbf_tpu_torch.utils.debug import summarize

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
    final, outs = rollout(step, state0, getattr(cfg, steps_field))

    record = {"scenario": args.scenario, "config": {
        f.name: repr(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}}
    if outs is not None:
        record.update(summarize(outs))
    if args.video and outs is not None:
        record["video"] = renderer(outs, cfg, args.video)
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
    traj = traj.cpu().numpy().astype(np.float32)
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


def cmd_verify(args) -> int:
    """Falsification sweep (module docstring); exit 0 = survived, 3 =
    violation found."""
    if args.scenario == "fleet":
        raise OutOfSliceError("verify fleet (the falsification fleet)",
                              SLICE_SERVE)
    if args.telemetry_dir is not None:
        raise OutOfSliceError("verify --telemetry-dir", SLICE_DURABLE)
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
    if args.state_dir and args.reset_state:
        removed = V.reset_campaign_state(args.state_dir)
        if removed and not args.json:
            print(f"reset: removed {len(removed)} persisted campaign "
                  f"state file(s) from {args.state_dir}")
    try:
        results = V.falsify(
            args.scenario, cfg, settings=settings, engines=engines, cbf=cbf,
            thresholds=thresholds, mesh=mesh, state_dir=args.state_dir,
            resume=args.resume, device=args.device)
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
                      device=args.device)
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
                      help="not ported yet: raises (Queue A9)")
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
    for flag, kw in (("--checkpoint-dir", {}), ("--durable-dir", {}),
                     ("--resume", {}), ("--profile-dir", {}),
                     ("--telemetry-dir", {}),
                     ("--stall-timeout", {"type": float}),
                     ("--checked", {"action": "store_true"})):
        runp.add_argument(flag, default=None, **kw,
                          help="not ported yet: raises (Queue A9)")
    runp.set_defaults(fn=cmd_run)

    listp = sub.add_parser("list", help="list scenarios and their knobs")
    listp.set_defaults(fn=cmd_list)
    _add_verify_parser(sub)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
