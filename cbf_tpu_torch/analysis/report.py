"""Reporting + the lint runner (counterpart: cbf_tpu/analysis/report.py):
one function the CLI and the tier-1 test both call, so "what the gate
enforces" and "what the terminal shows" cannot drift apart.

Text output is one finding per line in the compiler-style
``path:line:col [RULE/severity] symbol: message`` form; JSON output is a
single object with the findings, the suppressed set, stale baseline
entries and the exit code, with the JAX package's keys
(``lock_order_graph`` only when the concurrency pass ran, ``spmd_census``
only when the SPMD pass ran).

Exit-code contract (the CLI's and the tier-1 gate's):

* 0 — no unsuppressed findings (suppressed ones may exist);
* 1 — at least one unsuppressed finding, or a stale baseline entry
  (a fixed finding must retire its suppression in the same change);
* 2 — the analyser itself failed (malformed baseline, unreadable path).
"""

from __future__ import annotations

import json
from typing import Iterable

from cbf_tpu_torch.analysis import ast_rules, baseline as baseline_mod
from cbf_tpu_torch.analysis.registry import RULES, Finding


class LintResult:
    def __init__(self, active, suppressed, stale, lock_graph=None,
                 spmd_census=None):
        self.active: list[Finding] = active
        self.suppressed: list[tuple[Finding,
                                    baseline_mod.Suppression]] = suppressed
        self.stale: list[baseline_mod.Suppression] = stale
        # Acquisition-order edges from the concurrency analyser; None
        # when the concurrency pass did not run (the JSON then has no
        # lock_order_graph key).
        self.lock_graph: list[dict] | None = lock_graph
        # Per-entrypoint collective census from the SPMD pass; None when
        # the pass did not run (same key contract as lock_order_graph).
        self.spmd_census: dict | None = spmd_census

    @property
    def exit_code(self) -> int:
        return 1 if (self.active or self.stale) else 0

    def as_dict(self) -> dict:
        d = {
            "findings": [f.as_dict() for f in self.active],
            "suppressed": [
                dict(f.as_dict(), reason=s.reason)
                for f, s in self.suppressed],
            "stale_suppressions": [s._asdict() for s in self.stale],
            "rules": {rid: {"severity": r.severity, "summary": r.summary}
                      for rid, r in RULES.items()
                      if any(f.rule == rid for f in self.active)},
            "exit_code": self.exit_code,
        }
        if self.lock_graph is not None:
            d["lock_order_graph"] = self.lock_graph
        if self.spmd_census is not None:
            d["spmd_census"] = self.spmd_census
        return d


def run_lint(paths: Iterable[str], *, repo_root: str | None = None,
             baseline_path: str | None = None,
             jaxpr: bool = False, audits: bool = False,
             concurrency: bool = False, spmd: bool = False,
             entrypoints: Iterable[str] | None = None,
             device=None) -> LintResult:
    """Lint ``paths`` (AST rules), optionally adding the program checks on
    the captured step (``jaxpr``, the JAX package's name for its
    counterpart), the repo audits, the concurrency analyser and the SPMD
    analyser, and fold the result through the baseline. The program
    checks, the chain-depth audit and the SPMD census run on ``device``
    (None = the card)."""
    paths = list(paths)
    findings = ast_rules.lint_paths(paths, repo_root=repo_root)
    if jaxpr:
        from cbf_tpu_torch.analysis import program_rules

        findings.extend(program_rules.run_entrypoint_checks(
            entrypoints, device=device))
    if audits:
        from cbf_tpu_torch.analysis import audits as audits_mod

        findings.extend(audits_mod.run_audits(repo_root=repo_root,
                                              device=device))
    lock_graph = None
    if concurrency:
        from cbf_tpu_torch.analysis import concurrency as conc_mod

        conc = conc_mod.analyze_paths(paths, repo_root=repo_root)
        findings.extend(conc.findings)
        lock_graph = [e._asdict() for e in conc.edges]
    spmd_census = None
    if spmd:
        from cbf_tpu_torch.analysis import spmd_rules

        sp_findings, spmd_census = spmd_rules.run_spmd_checks(
            paths, repo_root=repo_root, entrypoints=entrypoints,
            device=device)
        findings.extend(sp_findings)
    sups = baseline_mod.load(baseline_path)
    active, suppressed, stale = baseline_mod.split(findings, sups)
    # A suppression is only judged stale by a run that could have
    # produced its finding: a plain lint run must not flag the CC/JX/AUD
    # entries of the optional passes it skipped.
    ran = ("TS", "RC")
    if jaxpr:
        ran += ("JX",)
    if audits:
        ran += ("AUD",)
    if concurrency:
        ran += ("CC",)
    if spmd:
        ran += ("SP",)
    stale = [s for s in stale if s.rule.startswith(ran)]
    return LintResult(active, suppressed, stale, lock_graph=lock_graph,
                      spmd_census=spmd_census)


def _fmt(f: Finding, suffix: str = "") -> str:
    loc = f"{f.path}:{f.line}:{f.col}" if f.line else f.path
    return (f"{loc} [{f.rule}/{RULES[f.rule].severity}] "
            f"{f.symbol}: {f.message}{suffix}")


def render_text(result: LintResult, *, show_suppressed: bool = False
                ) -> str:
    lines = []
    for f in result.active:
        lines.append(_fmt(f))
    if show_suppressed:
        for f, s in result.suppressed:
            lines.append(_fmt(f, f"  [suppressed: {s.reason}]"))
    for s in result.stale:
        lines.append(
            f"{s.path} [baseline/stale] {s.symbol}: suppression for "
            f"{s.rule} matches no finding — fixed? delete its entry "
            f"(reason was: {s.reason})")
    n_act, n_sup = len(result.active), len(result.suppressed)
    lines.append(
        f"lint: {n_act} finding{'s' if n_act != 1 else ''}, "
        f"{n_sup} suppressed, {len(result.stale)} stale baseline "
        f"entr{'ies' if len(result.stale) != 1 else 'y'}")
    return "\n".join(lines)


def render_json(result: LintResult, *, show_suppressed: bool = False
                ) -> str:
    d = result.as_dict()
    if not show_suppressed:
        d.pop("suppressed")
    return json.dumps(d, indent=2)
