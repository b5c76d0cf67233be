"""SPMD analyser (counterpart: cbf_tpu/analysis/spmd_rules.py): the
collective census of every sharded entry point, the replication check and
the hygiene of the port's axes and collectives.

The JAX package lowers each sharded entry point under a virtual 8-device
mesh and walks the optimized HLO module for its collectives. The port has
no lowered module: its mesh is one process per slot on
``torch.distributed`` (:mod:`cbf_tpu_torch.parallel.mesh`), and every
collective goes through :class:`~cbf_tpu_torch.parallel.mesh.Axis`, which
counts it by kind and operand bytes in ``mesh.COUNTS``. So the census
**runs** one call of each entry point in a world of
:data:`WORLD_SIZE` ranks started by
:func:`cbf_tpu_torch.parallel.launch.run_world` (one launch runs every
entry back to back) and reads the collectives each rank issued during the
call. On the card each rank also reads its peak memory
(``torch.cuda.max_memory_allocated`` above what was live when the call
began), and rank 0 runs the same global problem alone for the
replication baseline; the CPU measures no peak, so there ``peak_bytes``
and ``shrink`` are None and SP002/SP003 are skipped.

The census is pinned by ``spmd_budget.toml``
(:mod:`cbf_tpu_torch.analysis.mesh_budget`, the JAX package's schema): a
new collective kind, a count increase, or a peak past the row's
tolerance is a finding, and every intended change rewrites the row with a
reason.

Rules (the JAX package's IDs):

* **SP001 — collective-census regression.** An entry point issued a
  collective kind or count over its committed budget row (or has no row,
  or a row whose mesh no longer matches).
* **SP002 — per-rank peak-bytes regression** (the card only). The
  largest rank's peak exceeds the budget row past its tolerance.
* **SP003 — replicated large intermediate** (the card only). The
  per-rank peak under the mesh fails to shrink by :data:`MIN_SHRINK` from
  the one-rank run of the same global problem while it is above
  :data:`REPLICATION_FLOOR_BYTES`.
* **SP004 — an entry point that fails to run in its world.** JAX's AST
  half (``shard_map`` in_specs arity) has no counterpart: the port has
  no ``shard_map``.
* **SP005 — axis name outside the canonical table.** A literal axis name
  given to ``Mesh.axis``, ``resolve_axis`` or an ``axis_name=`` argument
  that is not in :data:`CANONICAL_AXES`.
* **SP006 — raw torch.distributed collective outside the owners.** Such
  a collective escapes both the census and the gloo staging of
  :class:`~cbf_tpu_torch.parallel.mesh.Axis`; :data:`COLLECTIVE_OWNERS`
  hold the only ones.

``python -m cbf_tpu_torch lint --spmd`` (in ``--all``) runs both layers.
"""

from __future__ import annotations

import ast
import functools
import importlib
import os
import re
from typing import Iterable, NamedTuple

from cbf_tpu_torch.analysis.registry import Finding

#: Ranks of the census world: every entry point's mesh (dp=2 x sp=2,
#: dp=4 x sp=1, dp=4, dp=1 x sp=4) fits exactly in 4.
WORLD_SIZE = 4

#: Census keys (the JAX package's stable JSON/budget names) -> the
#: torch.distributed call that issues them (``Axis.psum``/``pmax`` ->
#: all_reduce, ``Axis.all_gather`` -> all_gather, ``Axis.ppermute`` ->
#: batch_isend_irecv; the port issues no reduce_scatter or all_to_all).
COLLECTIVE_KINDS: dict[str, str] = {
    "all_reduce": "all_reduce",
    "all_gather": "all_gather",
    "reduce_scatter": "reduce_scatter",
    "ppermute": "batch_isend_irecv",
    "all_to_all": "all_to_all",
}

#: SP003 thresholds: the per-rank peak must shrink at least this factor
#: from the one-rank run of the same global problem...
MIN_SHRINK = 2.0
#: ...but only once the per-rank peak is big enough to matter — below
#: this, fixed per-program overheads dominate and shrink is meaningless.
REPLICATION_FLOOR_BYTES = 1 << 20

#: The axis-name table (SP005): the mesh's two axes.
CANONICAL_AXES: frozenset[str] = frozenset({"dp", "sp"})

#: The modules allowed to call torch.distributed's collectives (SP006):
#: the mesh's Axis, and multihost's world joins, barrier and host-side
#: ``gather_metrics``.
COLLECTIVE_OWNERS = ("cbf_tpu_torch/parallel/mesh.py",
                     "cbf_tpu_torch/parallel/multihost.py")

#: torch.distributed functions that communicate (SP006).
RAW_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "barrier",
    "batch_isend_irecv", "broadcast", "broadcast_object_list", "gather",
    "gather_object", "irecv", "isend", "monitored_barrier", "recv",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter",
    "scatter_object_list", "send",
})

_PATH = "cbf_tpu_torch/analysis/spmd_rules.py"


# -- the census world -------------------------------------------------------

class SpmdEntry(NamedTuple):
    """One sharded entry point the census runs: ``target``
    ("module:function") is called as ``fn(mesh)`` on every rank of the
    ``shape`` (dp, sp) mesh (``None``: one process, rank 0, and no
    replication baseline); ``mesh`` is the human/budget label."""
    name: str
    mesh: str                  # "dp=2,sp=2" | "unsharded"
    shape: tuple | None        # (dp, sp) | None
    target: str                # "module:function", fn(mesh) -> None

    @property
    def ranks(self) -> int:
        return 1 if self.shape is None else self.shape[0] * self.shape[1]


def _small(**kw):
    from cbf_tpu_torch.scenarios import swarm

    return swarm.Config(**kw)


def run_sharded_rollout(mesh) -> None:
    """The ensemble over the (dp, sp) mesh: E = 2 swarms of n = 8."""
    from cbf_tpu_torch.parallel.ensemble import sharded_swarm_rollout

    sharded_swarm_rollout(_small(n=8, steps=3, k_neighbors=4), mesh,
                          seeds=range(2))


def run_dp_certificate(mesh) -> None:
    """The dp ensemble with the sparse warm-started certificate: E = 16,
    so each rank's E_local > 1 takes the lockstep batched certificate."""
    from cbf_tpu_torch.parallel.ensemble import sharded_swarm_rollout

    cfg = _small(n=8, steps=3, k_neighbors=4, certificate=True,
                 certificate_backend="sparse", certificate_warm_start=True,
                 certificate_iters=4, certificate_cg_iters=2)
    sharded_swarm_rollout(cfg, mesh, seeds=range(16),
                          with_solver_state=True)


def run_verify_eval(mesh) -> None:
    """The falsifier's eval batch (B = 8) split over dp as ``verify
    --mesh-dp`` splits it."""
    import numpy as np
    import torch

    from cbf_tpu_torch.verify.search import (SearchSettings, make_adapter,
                                             make_eval_batch)

    adapter = make_adapter("swarm", cfg=_small(n=8, steps=3, k_neighbors=4),
                           device=mesh.device)
    deltas = 0.01 * np.random.default_rng(0).standard_normal(
        (8,) + tuple(adapter.delta_shape))
    eval_b = make_eval_batch(adapter, SearchSettings(),
                             mesh=None if mesh.dp == 1 else mesh)
    eval_b(torch.as_tensor(deltas, dtype=torch.float32, device=mesh.device))


def run_spatial_rollout(mesh) -> None:
    """One swarm of n = 2048 in x-strip tiles over sp, certificate on, so
    the census holds the whole spatial surface: the halo ppermute ring,
    the slab all-gathers feeding the row-partitioned certificate and the
    metric all-reduces. Unblocked rows (as the JAX package's entry)."""
    from cbf_tpu_torch.parallel import spatial

    cfg = _small(n=2048, steps=2, certificate=True,
                 certificate_backend="sparse", certificate_iters=2,
                 certificate_cg_iters=2)
    spec = spatial.plan_tiles(cfg, mesh.sp, block_rows=1 << 20)
    spatial.spatial_swarm_rollout(cfg, mesh, spec=spec)


def run_lockstep_chunk(mesh) -> None:
    """The serve hot path's chunk program, B = 4 lanes of n = 8, chunk 4,
    in one process: its standing census is zero collectives."""
    import torch

    from cbf_tpu_torch.analysis.program_rules import _stack_members
    from cbf_tpu_torch.parallel.ensemble import lockstep_traced_chunk
    from cbf_tpu_torch.scenarios import swarm

    cfg = _small(n=8, steps=4, k_neighbors=4)
    static_cfg, traced0 = swarm.split_static_traced(cfg)
    dev, B = mesh.device, 4
    states = _stack_members(swarm.initial_state(static_cfg, device=dev), B)
    traced = {k: torch.full((B,), float(v), dtype=cfg.dtype, device=dev)
              for k, v in traced0.items() if k != "n_active"}
    traced["n_active"] = torch.full((B,), cfg.n, dtype=torch.int32,
                                    device=dev)
    lanes = torch.full((B,), 4, dtype=torch.int32, device=dev)
    lockstep_traced_chunk(static_cfg, 4)(states, traced, lanes,
                                         torch.zeros_like(lanes))


def spmd_entrypoints() -> list[SpmdEntry]:
    """The analysed production surface, at the JAX package's problem
    sizes: the census counts are decided by the program and the mesh,
    not the array extents."""
    mod = __name__
    return [
        SpmdEntry("sharded_rollout", "dp=2,sp=2", (2, 2),
                  f"{mod}:run_sharded_rollout"),
        SpmdEntry("dp_certificate_ensemble", "dp=4,sp=1", (4, 1),
                  f"{mod}:run_dp_certificate"),
        SpmdEntry("verify_eval_batch", "dp=4", (4, 1),
                  f"{mod}:run_verify_eval"),
        SpmdEntry("spatial_rollout", "dp=1,sp=4", (1, 4),
                  f"{mod}:run_spatial_rollout"),
        # The serve hot path runs meshless: its standing census invariant
        # is ZERO collectives (any nonzero count is a new kind over the
        # committed all-zero row -> SP001).
        SpmdEntry("lockstep_chunk", "unsharded", None,
                  f"{mod}:run_lockstep_chunk"),
    ]


def spmd_entrypoint_names() -> list[str]:
    """Budget-liveness surface (AUD009) — names only, no world."""
    return [e.name for e in spmd_entrypoints()]


_FAILED = "spmd-entry-failed"


class EntryFailed(RuntimeError):
    """An entry point raised on a rank; the message names it."""


def _resolve(target: str):
    mod, _, fn = target.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _measured_call(fn, mesh) -> int | None:
    """Run ``fn(mesh)``; on the card, the peak memory above what was live
    when it began (None on the CPU)."""
    import torch

    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(mesh.device)
        live = torch.cuda.memory_allocated(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    fn(mesh)
    if not on_card:
        return None
    torch.cuda.synchronize(mesh.device)
    return int(torch.cuda.max_memory_allocated(mesh.device) - live)


def census_rank(entries, device) -> dict:
    """One rank of the census world: every entry back to back, each
    opened by a barrier; returns ``{name: {"census", "peak_bytes",
    "baseline_peak_bytes"}}`` for the entries this rank ran."""
    from cbf_tpu_torch.parallel import mesh as pmesh
    from cbf_tpu_torch.parallel import multihost

    rank = pmesh.world()[0]
    devices = "cpu" if device == "cpu" else None
    out = {}
    for entry in entries:
        entry = SpmdEntry(*entry)
        if entry.shape is None:
            mesh = (pmesh.Mesh(1, 1, pmesh._devices(devices)[0])
                    if rank == 0 else None)
        else:
            mesh = pmesh.make_mesh(*entry.shape, devices=devices)
        multihost.barrier()
        if mesh is not None:
            try:
                fn = _resolve(entry.target)
                pmesh.zero_counts()
                peak = _measured_call(fn, mesh)
                rec = {"census": pmesh.census(), "peak_bytes": peak,
                       "baseline_peak_bytes": None}
            except Exception as e:                      # noqa: BLE001
                raise EntryFailed(
                    f"<{_FAILED}:{entry.name}> {type(e).__name__}: "
                    f"{e}") from e
            out[entry.name] = rec
        multihost.barrier()
        if (entry.shape is not None and rank == 0 and mesh is not None
                and mesh.device.type == "cuda"):
            # The replication baseline: the same global problem alone.
            try:
                out[entry.name]["baseline_peak_bytes"] = _measured_call(
                    fn, pmesh.Mesh(1, 1, mesh.device))
            except Exception as e:                      # noqa: BLE001
                raise EntryFailed(
                    f"<{_FAILED}:{entry.name}> replication baseline (one "
                    f"rank): {type(e).__name__}: {e}") from e
        multihost.barrier()
    return out


def _report(entry: SpmdEntry, ranks: list[dict]) -> dict:
    """One entry's census report from its ranks' records: the largest
    count, operand bytes and peak of any rank per kind."""
    recs = [r[entry.name] for r in ranks if entry.name in r]
    counts = {k: max(r["census"][k]["count"] for r in recs)
              for k in COLLECTIVE_KINDS}
    nbytes = {k: max(r["census"][k]["bytes"] for r in recs)
              for k in COLLECTIVE_KINDS}
    peaks = [r["peak_bytes"] for r in recs]
    peak = None if any(p is None for p in peaks) else max(peaks)
    base = recs[0]["baseline_peak_bytes"]
    shrink = None
    if peak is not None and base is not None:
        shrink = round(base / peak, 3) if peak else float("inf")
    return {
        "mesh": entry.mesh,
        "devices": entry.ranks,
        "collectives": counts,
        "collective_bytes": nbytes,
        "peak_bytes": peak,
        "rank_peak_bytes": None if peak is None else peaks,
        "baseline_peak_bytes": base,
        "shrink": shrink,
    }


def replication_findings(name: str, report: dict) -> list[Finding]:
    """SP003 from one report: skipped where no peak was measured (the
    CPU) or for an unsharded entry."""
    peak, base = report.get("peak_bytes"), report.get("baseline_peak_bytes")
    if report["mesh"] == "unsharded" or peak is None or base is None:
        return []
    shrink = base / peak if peak else float("inf")
    if peak > REPLICATION_FLOOR_BYTES and shrink < MIN_SHRINK:
        return [Finding(
            "SP003", _PATH, 0, 0, name,
            f"replicated large intermediate: per-rank peak {peak} B under "
            f"the {report['mesh']} mesh shrinks only {shrink:.2f}x from "
            f"the one-rank run ({base} B) — sharding is not reducing the "
            f"footprint (threshold {MIN_SHRINK}x above "
            f"{REPLICATION_FLOOR_BYTES} B)")]
    return []


def _sp004(entry: SpmdEntry, why: str) -> Finding:
    return Finding("SP004", _PATH, 0, 0, entry.name,
                   f"entry point failed to run in its {entry.mesh} world: "
                   f"{why}")


def run_entries(entries: Iterable[SpmdEntry], device=None,
                timeout_s: float = 900.0
                ) -> tuple[dict[str, dict], list[Finding]]:
    """Run ``entries`` in one world (``device``: None for the card, or
    "cpu") and return their reports and SP003/SP004 findings. An entry
    that raises is SP004 and the world runs again without it; a world
    that fails as a whole makes every entry left SP004."""
    from cbf_tpu_torch.parallel import launch

    todo = list(entries)
    reports: dict[str, dict] = {}
    findings: list[Finding] = []
    while todo:
        try:
            ranks = launch.run_world(
                f"{__name__}:census_rank", max(e.ranks for e in todo),
                (tuple(tuple(e) for e in todo), device),
                device="cpu" if device == "cpu" else "cuda",
                timeout_s=timeout_s)
        except launch.RankError as e:
            text = str(e)
            m = re.search(rf"<{_FAILED}:([^>]+)> (.*)", text)
            bad = next((x for x in todo if m and x.name == m.group(1)),
                       None)
            if bad is None:
                findings += [_sp004(x, text.strip().splitlines()[-1])
                             for x in todo]
                break
            findings.append(_sp004(bad, m.group(2)))
            todo.remove(bad)
            continue
        for entry in todo:
            reports[entry.name] = _report(entry, ranks)
            findings += replication_findings(entry.name,
                                             reports[entry.name])
        break
    return reports, findings


def analyze_entry(entry: SpmdEntry, device=None
                  ) -> tuple[dict, list[Finding]]:
    """One entry alone in its own world: ``(report, findings)``, report
    ``{}`` when it failed (SP004)."""
    reports, findings = run_entries([entry], device=device)
    return reports.get(entry.name, {}), findings


@functools.lru_cache(maxsize=4)
def _cached_reports(names: tuple[str, ...] | None, device
                    ) -> tuple[dict, tuple[Finding, ...]]:
    """Reports are deterministic per process and the world launch is the
    whole cost of this pass — every caller (lint runs, budget writer,
    tests) shares one computation."""
    entries = [e for e in spmd_entrypoints()
               if names is None or e.name in names]
    reports, findings = run_entries(entries, device=device)
    return reports, tuple(findings)


def entrypoint_reports(only: Iterable[str] | None = None, device=None
                       ) -> tuple[dict[str, dict], list[Finding]]:
    reports, findings = _cached_reports(
        tuple(only) if only is not None else None, device)
    return {k: dict(v) for k, v in reports.items()}, list(findings)


# -- AST rules (SP005/SP006) ------------------------------------------------

def _str_const(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class _SpmdVisitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: list[Finding] = []
        self.dist_alias: set[str] = set()     # names bound to the module
        self.raw_names: set[str] = set()      # collectives imported bare
        self.torch_alias: set[str] = set()
        self.scope: list[str] = []

    def _symbol(self) -> str:
        return ".".join(self.scope) or "<module>"

    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            if alias.name == "torch.distributed" and alias.asname:
                self.dist_alias.add(alias.asname)
            elif alias.name in ("torch", "torch.distributed"):
                self.torch_alias.add(alias.asname or "torch")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        mod = node.module or ""
        for alias in node.names:
            if mod == "torch" and alias.name == "distributed":
                self.dist_alias.add(alias.asname or alias.name)
            elif mod == "torch.distributed" and \
                    alias.name in RAW_COLLECTIVES:
                self.raw_names.add(alias.asname or alias.name)
        self.generic_visit(node)

    def _visit_func(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func
    visit_ClassDef = _visit_func

    def _is_raw_collective(self, func) -> str | None:
        if isinstance(func, ast.Name) and func.id in self.raw_names:
            return func.id
        if not (isinstance(func, ast.Attribute)
                and func.attr in RAW_COLLECTIVES):
            return None
        base = func.value
        if isinstance(base, ast.Name) and base.id in self.dist_alias:
            return func.attr
        if (isinstance(base, ast.Attribute) and base.attr == "distributed"
                and isinstance(base.value, ast.Name)
                and base.value.id in self.torch_alias):
            return func.attr
        return None

    def visit_Call(self, node: ast.Call):
        func = node.func
        raw = self._is_raw_collective(func)
        if raw is not None and not self.path.replace(os.sep, "/").endswith(
                COLLECTIVE_OWNERS):
            self.findings.append(Finding(
                "SP006", self.path, node.lineno, node.col_offset,
                self._symbol(),
                f"raw torch.distributed.{raw} outside the collective "
                "owners (parallel/mesh.py's Axis, parallel/multihost.py) "
                "— it escapes the census and the gloo staging; go through "
                "an Axis or a multihost helper"))
        named = []
        if (isinstance(func, ast.Attribute) and func.attr == "axis"
                and len(node.args) == 1 and not node.keywords):
            named.append(("Mesh.axis", node.args[0]))
        if ((isinstance(func, ast.Name) and func.id == "resolve_axis")
                or (isinstance(func, ast.Attribute)
                    and func.attr == "resolve_axis")) and node.args:
            named.append(("resolve_axis", node.args[0]))
        named += [("axis_name=", kw.value) for kw in node.keywords
                  if kw.arg == "axis_name"]
        for where, arg in named:
            name = _str_const(arg)
            if name is not None and name not in CANONICAL_AXES:
                self.findings.append(Finding(
                    "SP005", self.path, node.lineno, node.col_offset,
                    self._symbol(),
                    f"axis name {name!r} ({where}) is not in the canonical "
                    "axis table (analysis.spmd_rules.CANONICAL_AXES: "
                    f"{', '.join(sorted(CANONICAL_AXES))}) — the mesh has "
                    "no such axis"))
        self.generic_visit(node)


def lint_spmd_source(source: str, path: str) -> list[Finding]:
    """SP005/SP006 over one module's source text."""
    v = _SpmdVisitor(path)
    v.visit(ast.parse(source))
    return v.findings


def lint_spmd_paths(paths: Iterable[str], repo_root: str | None = None
                    ) -> list[Finding]:
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git", "_build",
                                            "analysis_fixtures")]
                files.extend(os.path.join(dirpath, f)
                             for f in filenames if f.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    findings: list[Finding] = []
    for f in sorted(set(files)):
        rel = os.path.relpath(f, repo_root) if repo_root else f
        with open(f, encoding="utf-8") as fh:
            try:
                findings.extend(lint_spmd_source(fh.read(), rel))
            except SyntaxError:
                continue       # ast_rules already reports broken files
    return findings


# -- pass entry point -------------------------------------------------------

def run_spmd_checks(paths: Iterable[str], *,
                    repo_root: str | None = None,
                    entrypoints: Iterable[str] | None = None,
                    budget_path: str | None = None, device=None
                    ) -> tuple[list[Finding], dict]:
    """The full SPMD pass: AST hygiene over ``paths``, one run of every
    sharded entry point in the census world (``device``: None for the
    card, or "cpu"), and the census-vs-budget comparison.

    Returns ``(findings, census)`` — ``census`` is the JSON-able
    per-entrypoint report the CLI attaches to ``lint --json``:
    ``{"schema": 1, "devices": WORLD_SIZE, "device": ..., "entrypoints":
    {name: report}}``."""
    from cbf_tpu_torch.analysis import mesh_budget

    findings = lint_spmd_paths(paths, repo_root=repo_root)
    reports, run_findings = entrypoint_reports(entrypoints, device=device)
    findings.extend(run_findings)
    budget = mesh_budget.load(budget_path)
    for name, report in reports.items():
        findings.extend(mesh_budget.compare(name, report,
                                            budget.entries.get(name)))
    return findings, {"schema": 1, "devices": WORLD_SIZE,
                      "device": "cpu" if device == "cpu" else "cuda",
                      "entrypoints": reports}
