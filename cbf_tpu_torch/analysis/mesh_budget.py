"""The committed SPMD budget (counterpart: cbf_tpu/analysis/mesh_budget.py):
per-entrypoint collective counts and per-rank peak bytes, pinned in
``cbf_tpu_torch/analysis/spmd_budget.toml``.

The census (analysis.spmd_rules) measures the collectives each rank of
the census world issues and, on the card, its peak memory; this file is
what the repo has AGREED they should be. The gate
is asymmetric by design: a census that got *cheaper* (fewer collectives,
smaller peak) passes silently — tighten the row when convenient — while
anything that got *costlier* (a new collective kind, a count increase,
peak bytes past the row's tolerance) is a finding until a human rewrites
the row WITH a reason. Reasons are mandatory per row (the loader rejects
a reason-less file), so `git blame spmd_budget.toml` reads as the log of
every intentional communication-pattern change.

Schema (``schema = 1``)::

    schema = 1

    [[entry]]
    name = "sharded_rollout"       # analysis.spmd_rules entry point
    mesh = "dp=2,sp=2"             # census basis; mismatch -> SP001
    peak_bytes = 11200             # the largest rank's peak on the card
    tolerance = 0.5                # relative headroom on peak_bytes
    reason = "why this census is the intended one"

    [entry.collectives]            # count per kind; absent == 0
    all_reduce = 9
    all_gather = 1

The file format, the parser and every :class:`BudgetError` text are the
JAX package's, so either package reads the other's budget. The CPU
measures no peak: a report's ``peak_bytes`` is then None, :func:`compare`
skips SP002 and :func:`write` keeps each row's ``peak_bytes`` as it is.

Liveness (every sharded entry point has a row, every row names a live
entry point) is AUD009's job (analysis.audits) — it needs only names,
not a world. ``python -m cbf_tpu_torch lint --write-spmd-budget``
regenerates the file from a fresh census, preserving the reasons of
unchanged rows and requiring ``--reason`` for changed/new ones.
"""

from __future__ import annotations

import os
from typing import NamedTuple

from cbf_tpu_torch.analysis.registry import Finding

SCHEMA = 1

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "spmd_budget.toml")


class BudgetError(Exception):
    """Malformed/inconsistent budget file — analyzer exit 2, same as a
    malformed baseline."""


class BudgetRow(NamedTuple):
    name: str
    mesh: str
    collectives: dict[str, int]    # kind -> pinned count (absent == 0)
    peak_bytes: int
    tolerance: float               # relative headroom on peak_bytes
    reason: str


class Budget(NamedTuple):
    schema: int
    entries: dict[str, BudgetRow]


# -- parsing --------------------------------------------------------------

def _parse_scalar(text: str, where: str):
    text = text.strip()
    if text.startswith('"') and text.endswith('"') and len(text) >= 2:
        return text[1:-1]
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        raise BudgetError(
            f"{where}: unsupported value {text!r} (string/int/float "
            "only)") from None


def _parse_toml(text: str) -> dict:
    """Minimal TOML subset for the budget schema: top-level scalars,
    ``[[entry]]`` array-of-tables, ``[entry.<sub>]`` subtables of the
    most recent entry. Used when ``tomli`` is unavailable."""
    root: dict = {}
    target = root
    for i, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        where = f"line {i}"
        if line.startswith("[[") and line.endswith("]]"):
            name = line[2:-2].strip()
            target = {}
            root.setdefault(name, []).append(target)
        elif line.startswith("[") and line.endswith("]"):
            dotted = line[1:-1].strip().split(".")
            if len(dotted) != 2 or not isinstance(
                    root.get(dotted[0]), list):
                raise BudgetError(
                    f"{where}: unsupported table {line!r}")
            target = root[dotted[0]][-1].setdefault(dotted[1], {})
        elif "=" in line:
            key, val = line.split("=", 1)
            target[key.strip()] = _parse_scalar(val, where)
        else:
            raise BudgetError(f"{where}: unparseable line {raw!r}")
    return root


def _load_toml(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    except OSError as e:
        raise BudgetError(f"budget file unreadable: {e}") from e
    try:
        import tomli

        return tomli.loads(text)
    except ImportError:
        return _parse_toml(text)
    except Exception as e:                     # tomli parse error
        raise BudgetError(f"{path}: {e}") from e


def load(path: str | None = None) -> Budget:
    """Load + validate the budget. Raises :class:`BudgetError` on a
    missing/malformed file, unknown schema, duplicate or reason-less
    rows, or unknown collective kinds."""
    from cbf_tpu_torch.analysis.spmd_rules import COLLECTIVE_KINDS

    path = path or DEFAULT_PATH
    data = _load_toml(path)
    if data.get("schema") != SCHEMA:
        raise BudgetError(
            f"{path}: schema {data.get('schema')!r} != {SCHEMA} — this "
            "analyzer only reads schema 1 budgets")
    entries: dict[str, BudgetRow] = {}
    for tab in data.get("entry", []):
        name = tab.get("name")
        if not isinstance(name, str) or not name:
            raise BudgetError(f"{path}: entry without a name")
        if name in entries:
            raise BudgetError(f"{path}: duplicate entry {name!r}")
        reason = tab.get("reason")
        if not isinstance(reason, str) or not reason.strip():
            raise BudgetError(
                f"{path}: entry {name!r} has no reason — every budget "
                "row carries why its census is the intended one")
        mesh = tab.get("mesh")
        if not isinstance(mesh, str) or not mesh:
            raise BudgetError(f"{path}: entry {name!r} has no mesh")
        peak = tab.get("peak_bytes")
        if not isinstance(peak, int) or peak < 0:
            raise BudgetError(
                f"{path}: entry {name!r} peak_bytes must be an int >= 0")
        tol = tab.get("tolerance", 0.0)
        if not isinstance(tol, (int, float)) or tol < 0:
            raise BudgetError(
                f"{path}: entry {name!r} tolerance must be >= 0")
        colls = tab.get("collectives", {})
        for kind, count in colls.items():
            if kind not in COLLECTIVE_KINDS:
                raise BudgetError(
                    f"{path}: entry {name!r} pins unknown collective "
                    f"kind {kind!r} (have: "
                    f"{', '.join(COLLECTIVE_KINDS)})")
            if not isinstance(count, int) or count < 0:
                raise BudgetError(
                    f"{path}: entry {name!r} {kind} count must be an "
                    "int >= 0")
        entries[name] = BudgetRow(name, mesh, dict(colls), peak,
                                  float(tol), reason.strip())
    return Budget(SCHEMA, entries)


# -- comparison (the gate) ------------------------------------------------

_PATH = "cbf_tpu_torch/analysis/spmd_budget.toml"


def compare(name: str, report: dict, row: BudgetRow | None
            ) -> list[Finding]:
    """One entry point's census vs its budget row -> SP001/SP002
    findings. Cheaper-than-budget passes silently; costlier fails. A
    report without a measured peak (the CPU) skips SP002."""
    if row is None:
        return [Finding(
            "SP001", _PATH, 0, 0, name,
            f"sharded entry point {name!r} has no budget row — census "
            f"{report['collectives']} / peak {report['peak_bytes']} B "
            "is unpinned (lint --write-spmd-budget --reason '...' to "
            "commit it)")]
    findings: list[Finding] = []
    if row.mesh != report["mesh"]:
        findings.append(Finding(
            "SP001", _PATH, 0, 0, name,
            f"census basis changed: analyzed under mesh "
            f"{report['mesh']!r} but the budget row pins "
            f"{row.mesh!r} — rewrite the row (with a reason) for the "
            "new mesh"))
    for kind, count in report["collectives"].items():
        pinned = row.collectives.get(kind, 0)
        if count > pinned:
            what = ("new collective kind" if pinned == 0
                    else "collective count increase")
            findings.append(Finding(
                "SP001", _PATH, 0, 0, name,
                f"{what}: {kind} x{count} vs budgeted x{pinned} "
                f"(~{report['collective_bytes'].get(kind, 0)} B of "
                "operands) — an intended communication-pattern change "
                "rewrites the budget row with a reason"))
    limit = int(row.peak_bytes * (1.0 + row.tolerance))
    if report["peak_bytes"] is not None and report["peak_bytes"] > limit:
        findings.append(Finding(
            "SP002", _PATH, 0, 0, name,
            f"per-device peak {report['peak_bytes']} B exceeds the "
            f"budgeted {row.peak_bytes} B (+{row.tolerance:.0%} "
            f"tolerance = {limit} B) — an intended footprint change "
            "rewrites the budget row with a reason"))
    return findings


def liveness_problems(budget: Budget, live_names: list[str]
                      ) -> list[str]:
    """AUD009's both-direction check over names alone (no lowering)."""
    problems = []
    live = set(live_names)
    for name in sorted(live - set(budget.entries)):
        problems.append(
            f"sharded entry point {name!r} has no spmd_budget.toml row "
            "— its collective census is ungated (lint "
            "--write-spmd-budget to seed one)")
    for name in sorted(set(budget.entries) - live):
        problems.append(
            f"stale budget row {name!r}: names no live sharded entry "
            "point (analysis.spmd_rules.spmd_entrypoints) — delete the "
            "row or re-point it")
    return problems


# -- writer ---------------------------------------------------------------

def _peak(report: dict, old: BudgetRow | None) -> int:
    """The row's peak: the report's, or where it measured none (the CPU)
    the row's as it is (0 for a new row)."""
    if report["peak_bytes"] is not None:
        return int(report["peak_bytes"])
    return old.peak_bytes if old is not None else 0


def _row_from_report(name: str, report: dict, tolerance: float,
                     reason: str, old: BudgetRow | None = None) -> BudgetRow:
    colls = {k: c for k, c in report["collectives"].items() if c}
    return BudgetRow(name, report["mesh"], colls, _peak(report, old),
                     tolerance, reason)


def _changed(row: BudgetRow, report: dict) -> bool:
    colls = {k: c for k, c in report["collectives"].items() if c}
    return (row.mesh != report["mesh"] or row.collectives != colls
            or row.peak_bytes != _peak(report, row))


def render(rows: list[BudgetRow]) -> str:
    lines = [
        "# SPMD collective/memory budget — schema 1 "
        "(analysis.mesh_budget).",
        "# Regenerate: python -m cbf_tpu_torch lint --write-spmd-budget "
        "--reason '...'",
        "# Every row needs a reason; lint --spmd gates the census "
        "against it.",
        "",
        f"schema = {SCHEMA}",
    ]
    for row in sorted(rows):
        lines += ["", "[[entry]]",
                  f'name = "{row.name}"',
                  f'mesh = "{row.mesh}"',
                  f"peak_bytes = {row.peak_bytes}",
                  f"tolerance = {row.tolerance}",
                  f'reason = "{row.reason}"']
        if row.collectives:
            lines.append("")
            lines.append("[entry.collectives]")
            lines += [f"{k} = {c}"
                      for k, c in sorted(row.collectives.items())]
    return "\n".join(lines) + "\n"


def write(reports: dict[str, dict], path: str | None = None, *,
          reason: str | None = None, tolerance: float = 0.5) -> str:
    """Regenerate the budget from fresh census ``reports``. Unchanged
    rows keep their reason/tolerance; changed or new rows take
    ``reason`` (required: raises :class:`BudgetError` without one).
    Rows for entry points not in ``reports`` are dropped (they are the
    stale rows AUD009 flags). Returns the rendered text."""
    path = path or DEFAULT_PATH
    try:
        existing = load(path).entries
    except BudgetError:
        existing = {}
    rows = []
    for name, report in sorted(reports.items()):
        old = existing.get(name)
        if old is not None and not _changed(old, report):
            rows.append(old)
            continue
        if reason is None:
            raise BudgetError(
                f"entry {name!r} is new or changed — pass a reason "
                "(--reason) saying why the new census is intended")
        rows.append(_row_from_report(
            name, report,
            old.tolerance if old is not None else tolerance, reason, old))
    text = render(rows)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text)
    return text
