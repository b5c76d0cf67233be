"""Rule registry (counterpart: cbf_tpu/analysis/registry.py): the one table
of what the port's analyser checks.

Every check — the AST capture-safety rules, the program-cache hazards, the
program checks on the captured step, the repo audits and the concurrency
rules — is a :class:`Rule` registered here under the JAX package's stable
ID. The registry is the contract surface: the README's "Static analysis"
part of the port section documents exactly this table
(``tests/test_torch_analysis.py::test_rules_documented``), baseline entries
name rules by these IDs, and severities come from here.

The JAX package's trace-safety rules police a traced scope (``jit``,
``scan``, ``vmap``, ...). The port has no tracer: its compiled unit is the
CUDA-graph capture of the rollout engine's program body
(:meth:`cbf_tpu_torch.rollout.engine._Program.body`), cached per step
object and state signature. So "traced scope" reads **captured scope**
here — the code a capture records and every replay repeats — and each rule
keeps its JAX ID with the hazard written for that unit:

* ``TS0xx`` — capture safety: host reads, host branches, trace-time-only
  effects and host-to-device copies inside captured scope;
* ``RC0xx`` — program-cache hazards: what makes the engine capture a
  program it should replay;
* ``JX0xx`` — program checks, asserted on one eager run of a captured
  body under torch's function and dispatch modes
  (:mod:`cbf_tpu_torch.analysis.program_rules`);
* ``AUD0xx`` — repo audits (schema drift, tier-1 markers,
  reproducibility, scenario coverage, the concurrency map);
* ``CC0xx`` — lock discipline of the threaded serve/durable/obs/cluster
  stack;
* ``SP0xx`` — the SPMD analyser: the collective census of the sharded
  entry points run in a ``torch.distributed`` world, against the
  committed ``spmd_budget.toml``, and the hygiene of the port's axes and
  collectives (:mod:`cbf_tpu_torch.analysis.spmd_rules`).
"""

from __future__ import annotations

from typing import NamedTuple

ERROR = "error"
WARNING = "warning"


class Rule(NamedTuple):
    id: str
    severity: str      # ERROR | WARNING
    summary: str       # one line, shown in reports and docs


class Finding(NamedTuple):
    """One concrete violation: rule + location + human-readable detail.

    ``symbol`` is the enclosing function qualname (or ``<module>``) —
    baseline suppressions match on (rule, path, symbol), never on line
    numbers, so unrelated edits above a finding don't invalidate the
    baseline.
    """
    rule: str
    path: str          # repo-relative where possible
    line: int
    col: int
    symbol: str
    message: str

    @property
    def severity(self) -> str:
        return RULES[self.rule].severity

    def key(self) -> tuple:
        return (self.rule, self.path, self.symbol)

    def as_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line, "col": self.col,
                "symbol": self.symbol, "message": self.message}


_RULES = [
    # -- AST capture safety ---------------------------------------------
    Rule("TS001", ERROR,
         "host read in captured scope: .item()/.tolist()/.cpu()/.numpy() "
         "waits for the card and copies to the host, which a CUDA graph "
         "capture refuses"),
    Rule("TS002", ERROR,
         "Python cast float()/int()/bool() of a tensor in captured scope: "
         "a host read (the capture fails, or the value is frozen into "
         "every replay)"),
    Rule("TS003", ERROR,
         "np.asarray/np.array of a tensor in captured scope: a device to "
         "host copy inside the step"),
    Rule("TS004", ERROR,
         "Python `if` on a tensor in captured scope: a host read that "
         "picks one branch for every replay; use torch.where (the select "
         "form) or exact2d.request_redo (the redo form)"),
    Rule("TS005", ERROR,
         "Python `while` on a tensor in captured scope: a host read per "
         "iteration; use the select form (torch.where over fixed rounds) "
         "or the redo form (solvers/exact2d.py request_redo)"),
    Rule("TS006", WARNING,
         "bare print() in captured scope: runs at capture time, never on "
         "a replay"),
    Rule("TS007", WARNING,
         "host clock (time.time/perf_counter/sleep) in captured scope: a "
         "capture-time constant, not a per-step measurement"),
    Rule("TS008", WARNING,
         "host-to-device traffic in captured scope: torch.tensor/"
         "as_tensor/from_numpy of host data, or torch.cuda.synchronize — "
         "what a CUDA graph capture refuses"),
    # -- program-cache hazards --------------------------------------------
    Rule("RC001", ERROR,
         "program-cache key built from an unhashable value or naming a "
         "missing parameter (an lru_cache'd program builder with an "
         "unhashable default, or called with a keyword it lacks): every "
         "call raises TypeError"),
    Rule("RC002", ERROR,
         "step built inside a loop and rolled out there (swarm.make, "
         "_build_step, obs.tap.instrument_step, the utils/faults.py "
         "wrappers): the engine caches programs on the step object, so "
         "every iteration captures a fresh program"),
    Rule("RC003", WARNING,
         "step closes over a tensor made from host data in the enclosing "
         "function: baked into the captured program; a rebuilt closure "
         "captures anew — carry it through the step's inputs instead"),
    # -- program checks ---------------------------------------------------
    Rule("JX001", ERROR,
         "host read or host-to-device copy in a captured body (seen by "
         "torch's function and dispatch modes on one eager body): a CUDA "
         "graph capture fails or freezes the value"),
    Rule("JX002", ERROR,
         "float64 from float32 inputs on the float32 path: dtype drift "
         "(doubled bytes, and the card's float64 rate is a fraction of "
         "float32's)"),
    Rule("JX003", ERROR,
         "carried state drift: a captured body returns its carry at "
         "another shape, dtype or device than it took — the program's "
         "static buffers cannot hold it"),
    # -- audits -----------------------------------------------------------
    Rule("AUD001", ERROR,
         "telemetry schema drift: StepOutputs/EnsembleMetrics field or an "
         "emitter's event type missing from the heartbeat schema or "
         "docs/API.md"),
    Rule("AUD002", ERROR,
         "budget-shaped test without @pytest.mark.slow: erodes the "
         "tier-1 budget"),
    Rule("AUD003", ERROR,
         "certificate chain-depth regression: the fused ADMM iteration's "
         "serialized gather/segment-sum chain exceeded its pinned bound, "
         "or is no shallower than the default path's"),
    Rule("AUD004", ERROR,
         "reproducibility: seedless np.random (default_rng() without a "
         "seed, or a global-generator draw) or a draw from torch's global "
         "generator with no generator= in cbf_tpu_torch/ or "
         "chip_smoke.py"),
    Rule("AUD007", ERROR,
         "scenario-platform coverage: a registered scenario missing its "
         "verify adapter, calibrated thresholds, parity test or "
         "docs/API.md row — or a scenario module of the port that never "
         "registers"),
    # -- concurrency (lock discipline) ------------------------------------
    Rule("CC001", ERROR,
         "shared mutable attribute of a threaded class written from "
         "multiple thread scopes (or multiple methods) with no common "
         "lock held across the write sites"),
    Rule("CC002", ERROR,
         "lock-order inversion: cycle in the global acquisition-order "
         "graph — two threads taking the locks in opposite orders "
         "deadlock"),
    Rule("CC003", WARNING,
         "blocking call (fsync/sleep/join/device wait/file I/O) inside "
         "a held-lock region: every contending thread stalls behind "
         "the I/O"),
    Rule("CC004", ERROR,
         "signal handler does more than Event.set/flag writes: a "
         "handler interrupting the thread that holds the lock it "
         "touches deadlocks"),
    Rule("CC005", ERROR,
         "Condition.wait outside a predicate loop: spurious wakeups "
         "and missed rechecks proceed on a false predicate"),
    Rule("CC006", WARNING,
         "daemon thread doing file I/O with no join path: interpreter "
         "teardown kills daemons mid-write (torn file, lost record)"),
    Rule("CC007", ERROR,
         "lock acquired in a __del__/atexit finalizer path: finalizers "
         "run at arbitrary points, possibly while the lock is held"),
    Rule("CC008", WARNING,
         "thread start() without a matching join/stop contract: the "
         "thread outlives every owner"),
    Rule("AUD008", ERROR,
         "concurrency-map drift: a discovered lock/condition/event/"
         "thread/handler of the port has no row in the README's port "
         "concurrency map (or the map names a primitive that no longer "
         "exists)"),
    # -- SPMD (collective census + replication) ---------------------------
    Rule("SP001", ERROR,
         "collective-census regression: a sharded entry point issued a "
         "collective kind or count over its committed spmd_budget.toml "
         "row (or has no row / a row whose mesh no longer matches)"),
    Rule("SP002", ERROR,
         "per-rank peak-bytes regression: the largest rank's peak memory "
         "on the card exceeds the budget row past its tolerance"),
    Rule("SP003", ERROR,
         "replicated large intermediate: the per-rank peak under the mesh "
         "fails to shrink vs the one-rank run of the same global problem "
         "(the card) — sharding is not reducing the footprint"),
    Rule("SP004", ERROR,
         "a sharded entry point that fails to run in its torch.distributed "
         "world"),
    Rule("SP005", ERROR,
         "literal axis name outside the canonical axis table "
         "(analysis.spmd_rules.CANONICAL_AXES) given to Mesh.axis, "
         "resolve_axis or axis_name="),
    Rule("SP006", WARNING,
         "raw torch.distributed collective outside the collective owners "
         "(parallel/mesh.py, parallel/multihost.py): escapes the census "
         "and the gloo staging"),
    Rule("AUD009", ERROR,
         "spmd-budget liveness: a sharded entry point with no "
         "spmd_budget.toml row, a stale row naming no live entry "
         "point, or a malformed/reason-less budget file"),
]

RULES: dict[str, Rule] = {r.id: r for r in _RULES}


def rule_ids() -> list[str]:
    return [r.id for r in _RULES]
