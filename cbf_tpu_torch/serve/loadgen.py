"""Open-loop heavy-tailed load generation for the serving engine
(counterpart: cbf_tpu/serve/loadgen.py).

Sustained requests/s and p50/p99 latency under mixed traffic can only be
measured against a generator that does NOT wait for responses: a
closed-loop driver throttles itself when the server slows down and
hides queueing collapse. This one is open-loop: arrivals are scheduled
up front (Poisson process at ``rps``) and submitted on the wall clock
regardless of completion, so queue-wait genuinely accumulates when the
engine falls behind.

Traffic shape: request sizes are bounded-Pareto distributed
(heavy-tailed — many small swarms, occasional big ones) over the
engine's power-of-two bucket ladder; horizons and the traced float
knobs (safety_distance, consensus_gain) vary per request, so the mix
exercises exactly the traced-config split the serving layer exists for.
Everything is seeded (``numpy.random.default_rng(seed)``, host numpy):
the same spec gives the same schedule as the JAX package's, arrival for
arrival and field for field.

Entry points: :func:`build_schedule` (pure, inspectable),
:func:`run_loadgen` (drive an engine, return the SLO report),
:func:`sweep_rps` (the knee over an rps grid) and
``python -m cbf_tpu_torch loadgen`` (CLI). Host code only: the engine
does the device work.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from cbf_tpu_torch.scenarios import swarm
from cbf_tpu_torch.serve import resilience

#: Generic telemetry event types this module emits (equal to
#: obs.schema.LOADGEN_EVENT_TYPES).
EMITTED_EVENT_TYPES: tuple[str, ...] = ("loadgen.summary",)


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One loadgen run's knobs (all seeded/deterministic).

    ``rps`` — offered Poisson arrival rate (requests/s).
    ``duration_s`` — arrival window; requests submitted in [0, duration).
    ``n_min``/``n_max`` — bounded-Pareto request-size support.
    ``pareto_alpha`` — tail index (smaller = heavier tail; 1.3 gives a
    realistic many-small/few-large mix).
    ``steps_choices`` — horizon mix (uniform over these).
    ``scenario_mix`` — seeded weights over registered SERVABLE scenarios
    (``scenarios.platform.registry``): each arrival draws its scenario
    from this distribution. The default single-entry swarm mix keeps the
    pre-platform schedule BIT-IDENTICAL (no extra rng draw is consumed);
    named non-swarm scenarios take their registered config with the
    schedule's horizon/seed/traced-knob jitter applied on top.

    ``gating`` keeps the JAX package's default ``"jnp"``: in the port
    that is the dense sort path, with no kernel — traffic meant for the
    card's k-NN kernels passes ``gating="pallas"`` (``knn_fused``) or
    ``"streaming"`` (``knn_stream``).
    """
    rps: float = 8.0
    duration_s: float = 5.0
    seed: int = 0
    n_min: int = 8
    n_max: int = 96
    pareto_alpha: float = 1.3
    steps_choices: tuple[int, ...] = (20, 40, 60)
    gating: str = "jnp"
    scenario_mix: tuple[tuple[str, float], ...] = (("swarm", 1.0),)


def bounded_pareto(rng: np.random.Generator, alpha: float, lo: float,
                   hi: float, size=None):
    """Inverse-CDF samples of the bounded Pareto distribution on
    [lo, hi] with tail index ``alpha``."""
    if not (0 < lo <= hi):
        raise ValueError(f"need 0 < lo <= hi, got [{lo}, {hi}]")
    u = rng.random(size)
    la, ha = lo ** alpha, hi ** alpha
    return (-(u * ha - u * la - ha) / (ha * la)) ** (-1.0 / alpha)


def _validated_mix(spec: LoadSpec):
    """Resolve the spec's scenario mix against the registry: every name
    must be a registered SERVABLE scenario (the engine submits
    ``swarm.Config`` objects only) with a positive weight. Returns
    ``(names, cumulative_probabilities)``."""
    from cbf_tpu_torch.scenarios.platform import registry

    if not spec.scenario_mix:
        raise ValueError("scenario_mix must name at least one scenario")
    names, weights = [], []
    for name, w in spec.scenario_mix:
        entry = registry.get(name)      # raises on unknown
        if not entry.servable:
            raise ValueError(
                f"scenario {name!r} is not servable (the engine takes "
                "swarm.Config requests only) — it cannot join a loadgen "
                "scenario mix")
        if not w > 0:
            raise ValueError(
                f"scenario_mix weight for {name!r} must be > 0, got {w}")
        names.append(name)
        weights.append(float(w))
    cum = np.cumsum(weights) / float(np.sum(weights))
    return names, cum


def schedule_with_scenarios(
        spec: LoadSpec) -> list[tuple[float, str, swarm.Config]]:
    """The full arrival schedule for one run: sorted
    ``(arrival_offset_s, scenario_name, config)`` triples. Pure function
    of the spec — same seed, same schedule — so a run can be replayed or
    inspected without driving an engine.

    Determinism note: with the default single-scenario mix NO scenario
    draw is consumed, so pre-platform schedules replay bit-identically;
    a weighted mix consumes exactly one extra uniform per arrival."""
    if spec.rps <= 0 or spec.duration_s <= 0:
        raise ValueError(f"rps and duration_s must be > 0, got "
                         f"rps={spec.rps}, duration_s={spec.duration_s}")
    names, cum = _validated_mix(spec)
    rng = np.random.default_rng(spec.seed)
    out: list[tuple[float, str, swarm.Config]] = []
    t = float(rng.exponential(1.0 / spec.rps))
    i = 0
    while t < spec.duration_s:
        scenario = names[0] if len(names) == 1 else \
            names[int(np.searchsorted(cum, rng.random(), side="right"))]
        n = int(np.clip(round(float(bounded_pareto(
            rng, spec.pareto_alpha, spec.n_min, spec.n_max))),
            spec.n_min, spec.n_max))
        steps = int(spec.steps_choices[int(rng.integers(
            len(spec.steps_choices)))])
        # Small seeded jitter on the traced floats — fresh scalars per request, known-safe
        # ranges (the safety gates hold over them).
        safety = 0.4 + 0.003 * int(rng.integers(5))
        gain = 1.0 + 0.01 * int(rng.integers(16))
        if scenario == "swarm":
            cfg = swarm.Config(
                n=n, steps=steps, seed=i, gating=spec.gating,
                safety_distance=safety, consensus_gain=gain)
        else:
            # Registered (e.g. DSL-generated) scenario: its own config
            # defines the bucket identity (n, ingredients, dynamics);
            # the schedule varies horizon/seed/traced floats on top.
            from cbf_tpu_torch.scenarios.platform import registry
            cfg = dataclasses.replace(
                registry.get(scenario).make_config(),
                steps=steps, seed=i, gating=spec.gating,
                safety_distance=safety, consensus_gain=gain)
        out.append((t, scenario, cfg))
        t += float(rng.exponential(1.0 / spec.rps))
        i += 1
    return out


def build_schedule(spec: LoadSpec) -> list[tuple[float, swarm.Config]]:
    """Back-compat view of :func:`schedule_with_scenarios` — the sorted
    ``(arrival_offset_s, config)`` pairs without the scenario names."""
    return [(t, cfg) for t, _name, cfg in schedule_with_scenarios(spec)]


def _quantile(sorted_vals: list[float], q: float) -> float | None:
    """Exact linear-interpolated quantile of an already-sorted list."""
    if not sorted_vals:
        return None
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


def run_loadgen(engine, spec: LoadSpec, *, telemetry=None,
                result_timeout_s: float = 300.0, mutate=None,
                request_id_prefix: str | None = None) -> dict:
    """Drive ``engine`` with the spec's open-loop schedule and return
    the SLO report: sustained RPS + end-to-end latency percentiles +
    queue-wait/execute breakdown + a typed-error census.

    ``request_id_prefix`` (optional) stamps every submitted request id
    as ``<prefix><i>`` over the schedule index — the census seam for
    the HA failover harness, where ids must be attributable to the
    epoch/process that submitted them and collision-free across
    processes sharing one journal (engine-default ids restart at ``r0``
    in every process).

    Every scheduled request is accounted for exactly once: completed,
    or counted under ``errors`` with its exception type tallied in
    ``errors_by_type`` — submits refused by admission control
    (`serve.resilience.ShedError` / `QuarantinedError`) count the same
    way as post-submit failures, so ``completed + errors == requests``
    is the chaos harness's zero-hang invariant.

    ``mutate`` (optional, ``mutate(i, cfg) -> cfg``) rewrites the i-th
    scheduled request before submit — the chaos-injection seam (e.g.
    `utils.faults.poison_config` every k-th request) that keeps the
    schedule itself seeded/replayable.

    The engine should be prewarmed for the schedule's buckets (use
    ``engine.prewarm([cfg for _, cfg in build_schedule(spec)])``) —
    otherwise the first request of each bucket pays its compile inside
    the measured window, which is a cold-start measurement, not a
    sustained-rate one. Starts (and then stops) the engine's scheduler
    thread if the caller has not already."""
    schedule = schedule_with_scenarios(spec)
    started_here = not engine._running
    if started_here:
        engine.start()
    # Scheduler-observatory split: when the engine carries an armed
    # LaneLedger, snapshot its cumulative totals NOW and report this
    # run's occupancy/dispatch attribution as exact deltas — repeated
    # legs on one engine (sweep_rps) stay per-leg, not cumulative.
    led = getattr(engine, "lanes", None)
    led_before = (led.totals(), led.bucket_totals()) \
        if led is not None else None
    pendings = []
    errors_by_type: dict[str, int] = {}
    scen_errors: dict[str, int] = {}

    def _tally(exc: BaseException, scenario: str) -> None:
        name = type(exc).__name__
        errors_by_type[name] = errors_by_type.get(name, 0) + 1
        scen_errors[scenario] = scen_errors.get(scenario, 0) + 1

    t_start = time.perf_counter()
    try:
        for i, (arrival_s, scen_name, cfg) in enumerate(schedule):
            # Open-loop: sleep to the scheduled arrival, never await
            # results — lateness here (the generator falling behind)
            # is reported, not silently absorbed.
            delay = t_start + arrival_s - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if mutate is not None:
                cfg = mutate(i, cfg)
            try:
                rid = (f"{request_id_prefix}{i}"
                       if request_id_prefix is not None else None)
                pendings.append((scen_name,
                                 engine.submit(cfg, request_id=rid)))
            except resilience.ServeError as e:
                # shed/quarantined at admission: typed, counted
                _tally(e, scen_name)
        results = []
        scen_of: dict[int, str] = {}
        bucket_errors: dict[str, int] = {}
        for scen_name, p in pendings:
            try:
                r = p.result(timeout=result_timeout_s)
                scen_of[id(r)] = scen_name
                results.append(r)
            except Exception as e:
                _tally(e, scen_name)
                key = getattr(p, "_key", None)
                if key is not None:     # post-submit failure: bucketable
                    label = key.label()
                    bucket_errors[label] = bucket_errors.get(label, 0) + 1
        errors = sum(errors_by_type.values())
        drained_s = time.perf_counter() - t_start
    finally:
        if started_here:
            engine.stop(drain=True)

    lanes_report = None
    lane_bucket: dict[str, dict] = {}
    if led is not None:
        from cbf_tpu_torch.obs import lanes as obs_lanes
        g = obs_lanes.derive(obs_lanes.subtract(led.totals(),
                                                led_before[0]))
        if g["chunks"]:
            lanes_report = g
        for b, acct in led.bucket_totals().items():
            d = obs_lanes.derive(obs_lanes.subtract(
                acct, led_before[1].get(b, {})))
            if d["chunks"]:
                lane_bucket[b] = d

    # Per-bucket SLO split: aggregate percentiles hide which leg of the
    # ladder is slow — a p99 blowup in one big bucket looks like uniform
    # degradation in the roll-up. Group by the served bucket label.
    by_bucket: dict[str, dict] = {}
    groups: dict[str, list] = {}
    for r in results:
        groups.setdefault(r.bucket, []).append(r)
    for label in sorted(set(groups) | set(bucket_errors)):
        rs = groups.get(label, [])
        bq = sorted(r.queue_wait_s for r in rs)
        bx = sorted(r.execute_s for r in rs)
        bt = sorted(r.ttfp_s for r in rs
                    if getattr(r, "ttfp_s", None) is not None)
        by_bucket[label] = {
            "completed": len(rs),
            "errors": bucket_errors.get(label, 0),
            "queue_wait_p50_s": _quantile(bq, 0.50),
            "queue_wait_p95_s": _quantile(bq, 0.95),
            "queue_wait_p99_s": _quantile(bq, 0.99),
            "execute_p50_s": _quantile(bx, 0.50),
            "execute_p95_s": _quantile(bx, 0.95),
            "execute_p99_s": _quantile(bx, 0.99),
            "ttfp_p50_s": _quantile(bt, 0.50),
            "ttfp_p95_s": _quantile(bt, 0.95),
            "ttfp_p99_s": _quantile(bt, 0.99),
        }
        if label in lane_bucket:
            by_bucket[label]["occupancy_pct"] = \
                lane_bucket[label]["occupancy_pct"]
            by_bucket[label]["dispatch_pct"] = \
                lane_bucket[label]["dispatch_pct"]
            by_bucket[label]["lane_chunks"] = lane_bucket[label]["chunks"]
        for k, v in list(by_bucket[label].items()):
            if isinstance(v, float):
                by_bucket[label][k] = round(v, 6)

    # Per-scenario SLO split: with a mixed scenario feed the bucket axis
    # alone can't show which SCENARIO family is slow or being shed — a
    # generated mixed-dynamics scenario and plain swarm traffic can land
    # in different buckets but degrade together. Group on the schedule's
    # scenario names.
    by_scenario: dict[str, dict] = {}
    scen_groups: dict[str, list] = {}
    for r in results:
        scen_groups.setdefault(scen_of[id(r)], []).append(r)
    for scen_name in sorted(set(scen_groups) | set(scen_errors)):
        rs = scen_groups.get(scen_name, [])
        sl = sorted(r.latency_s for r in rs)
        by_scenario[scen_name] = {
            "completed": len(rs),
            "errors": scen_errors.get(scen_name, 0),
            "latency_p50_s": _quantile(sl, 0.50),
            "latency_p95_s": _quantile(sl, 0.95),
            "latency_p99_s": _quantile(sl, 0.99),
        }
        for k, v in list(by_scenario[scen_name].items()):
            if isinstance(v, float):
                by_scenario[scen_name][k] = round(v, 6)

    lat = sorted(r.latency_s for r in results)
    qwait = sorted(r.queue_wait_s for r in results)
    execu = sorted(r.execute_s for r in results)
    # Time-to-first-partial: only continuous-mode requests that streamed
    # at least one serve.partial carry it — percentiles are over that
    # subset, null in drain mode (no partials exist there).
    ttfp = sorted(r.ttfp_s for r in results
                  if getattr(r, "ttfp_s", None) is not None)
    completed = len(results)
    report = {
        "seed": spec.seed,
        "offered_rps": round(spec.rps, 3),
        "achieved_rps": round(completed / drained_s, 3) if drained_s else 0.0,
        "requests": len(schedule),
        "completed": completed,
        "errors": errors,
        "errors_by_type": errors_by_type,
        "timeouts": errors_by_type.get("TimeoutError", 0),
        "duration_s": round(drained_s, 3),
        "latency_p50_s": _quantile(lat, 0.50),
        "latency_p95_s": _quantile(lat, 0.95),
        "latency_p99_s": _quantile(lat, 0.99),
        "latency_max_s": lat[-1] if lat else None,
        "queue_wait_p50_s": _quantile(qwait, 0.50),
        "queue_wait_p99_s": _quantile(qwait, 0.99),
        "execute_p50_s": _quantile(execu, 0.50),
        "execute_p99_s": _quantile(execu, 0.99),
        "ttfp_p50_s": _quantile(ttfp, 0.50),
        "ttfp_p95_s": _quantile(ttfp, 0.95),
        "ttfp_p99_s": _quantile(ttfp, 0.99),
        "batch_fill_mean": (round(float(np.mean([r.batch_fill
                                                 for r in results])), 2)
                            if results else None),
        # Safety aggregates over every served request — the loadgen is
        # still a safety-filter workload, so the safety gates hold over it.
        "min_pairwise_distance": (min(float(np.min(
            r.outputs.min_pairwise_distance)) for r in results)
            if results else None),
        "infeasible_count": (sum(int(np.sum(r.outputs.infeasible_count))
                                 for r in results) if results else None),
        "by_bucket": by_bucket,
        "by_scenario": by_scenario,
        # Exact lane-time attribution for THIS run (lane-ledger deltas;
        # None when the engine has no armed ledger, e.g. drain mode).
        # Rides the report only — the loadgen.summary event keeps its
        # fixed field set, with the per-bucket occupancy split inside
        # by_bucket.
        "lanes": lanes_report,
    }
    for k, v in list(report.items()):
        if isinstance(v, float):
            report[k] = round(v, 6)
    if telemetry is not None:
        telemetry.event("loadgen.summary", {
            k: report[k] for k in (
                "seed", "offered_rps", "achieved_rps", "requests",
                "completed", "errors", "duration_s", "latency_p50_s",
                "latency_p95_s", "latency_p99_s", "queue_wait_p99_s",
                "execute_p99_s", "ttfp_p50_s", "ttfp_p95_s",
                "ttfp_p99_s", "by_bucket", "by_scenario")})
    return report


def parse_sweep(arg: str) -> list[float]:
    """Parse a ``lo:hi:step`` sweep directive into the inclusive rps
    grid it denotes (endpoint included when the step lands on it)."""
    parts = arg.split(":")
    if len(parts) != 3:
        raise ValueError(f"sweep must be lo:hi:step, got {arg!r}")
    lo, hi, step = (float(p) for p in parts)
    if lo <= 0 or hi < lo or step <= 0:
        raise ValueError(f"need 0 < lo <= hi and step > 0, got {arg!r}")
    grid = []
    r = lo
    while r <= hi + 1e-9:
        grid.append(round(r, 6))
        r += step
    return grid


def sweep_rps(engine, spec: LoadSpec, rps_grid, *, slo_p99_s: float,
              telemetry=None, result_timeout_s: float = 300.0) -> dict:
    """Sweep offered rps over ``rps_grid`` (one :func:`run_loadgen` leg
    per point, same seed/shape — only the rate varies) and find the
    KNEE: the first offered rps whose end-to-end latency p99 exceeds
    ``slo_p99_s``. ``knee_rps`` is the last rps BEFORE that point — the
    highest swept rate still inside the SLO (0.0 when even the first
    point violates; the top of the grid, censored, when none does —
    ``knee_censored`` says which). Emits one ``loadgen.summary`` per
    leg when ``telemetry`` is given; returns ``{legs, knee_rps,
    knee_censored, slo_p99_s}`` with per-leg rows for the table."""
    legs = []
    knee_rps: float = 0.0
    knee_censored = True
    violated = False
    for rps in rps_grid:
        leg_spec = dataclasses.replace(spec, rps=float(rps))
        report = run_loadgen(engine, leg_spec, telemetry=telemetry,
                             result_timeout_s=result_timeout_s)
        p99 = report["latency_p99_s"]
        ok = p99 is not None and p99 <= slo_p99_s
        legs.append({
            "rps": float(rps),
            "achieved_rps": report["achieved_rps"],
            "completed": report["completed"],
            "errors": report["errors"],
            "latency_p50_s": report["latency_p50_s"],
            "latency_p99_s": p99,
            "queue_wait_p99_s": report["queue_wait_p99_s"],
            "execute_p99_s": report["execute_p99_s"],
            "ttfp_p99_s": report["ttfp_p99_s"],
            "within_slo": ok,
        })
        if not violated:
            if ok:
                knee_rps = float(rps)
            else:
                violated = True
                knee_censored = False
    return {"slo_p99_s": slo_p99_s, "legs": legs,
            "knee_rps": knee_rps, "knee_censored": knee_censored}
