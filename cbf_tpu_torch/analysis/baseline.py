"""Baseline suppressions (counterpart: cbf_tpu/analysis/baseline.py):
pre-existing findings stay visible, new ones fail.

The port's baseline file (``cbf_tpu_torch/analysis/baseline.toml``) is an
array of
``[[suppress]]`` tables. Every entry MUST carry a non-empty ``reason``
— a suppression without a why is just a deleted finding — and matches
on ``(rule, path, symbol)``, never on line numbers, so edits elsewhere
in a file don't invalidate it:

    [[suppress]]
    rule = "TS006"
    path = "cbf_tpu_torch/utils/debug.py"
    symbol = "summarize"
    reason = "host-side summary helper; flagged only because it shares
              a module with traced code"

Semantics:

* a finding whose ``(rule, path, symbol)`` matches an entry is
  *suppressed*: reported only under ``--show-suppressed``, never fatal;
* a *stale* entry (matches nothing) is itself a warning — baselines
  must shrink as findings are fixed, not accrete;
* loading rejects entries with missing fields or empty reasons, so the
  file cannot quietly decay into an unconditional mute list.

Parsing uses ``tomli`` when it is installed and falls back to a minimal
built-in reader for exactly the subset this file uses, as the JAX
package's loader does, so both read one file to the same entries.
"""

from __future__ import annotations

import os
from typing import NamedTuple

from cbf_tpu_torch.analysis.registry import RULES, Finding

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.toml")


class Suppression(NamedTuple):
    rule: str
    path: str
    symbol: str
    reason: str

    def matches(self, f: Finding) -> bool:
        return (self.rule == f.rule and self.path == f.path
                and self.symbol == f.symbol)


class BaselineError(ValueError):
    """Malformed baseline file (missing field, empty reason, bad rule)."""


def _parse_toml(text: str) -> list[dict]:
    """Minimal reader for the ``[[suppress]]`` + ``key = "value"`` subset
    (used only when tomli is unavailable)."""
    entries: list[dict] = []
    current: dict | None = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[suppress]]":
            current = {}
            entries.append(current)
            continue
        if "=" in line and current is not None:
            key, _, val = line.partition("=")
            val = val.strip()
            if val.startswith('"') and val.endswith('"') and len(val) >= 2:
                val = val[1:-1]
            current[key.strip()] = val
    return entries


def load(path: str | None = None) -> list[Suppression]:
    """Load and validate the baseline. A missing file is an empty
    baseline (the fresh-checkout case), a malformed one is an error."""
    path = DEFAULT_BASELINE if path is None else path
    if not os.path.isfile(path):
        return []
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        import tomli

        entries = tomli.loads(text).get("suppress", [])
    except ImportError:
        entries = _parse_toml(text)
    out = []
    for i, e in enumerate(entries):
        missing = [k for k in ("rule", "path", "symbol", "reason")
                   if not str(e.get(k, "")).strip()]
        if missing:
            raise BaselineError(
                f"{path}: suppress entry #{i + 1} is missing {missing} "
                "(every suppression needs rule/path/symbol and a reason)")
        if e["rule"] not in RULES:
            raise BaselineError(
                f"{path}: suppress entry #{i + 1} names unknown rule "
                f"{e['rule']!r} (known: {sorted(RULES)})")
        out.append(Suppression(str(e["rule"]), str(e["path"]),
                               str(e["symbol"]), str(e["reason"])))
    return out


def split(findings: list[Finding], suppressions: list[Suppression]
          ) -> tuple[list[Finding], list[tuple[Finding, Suppression]],
                     list[Suppression]]:
    """Partition into (active, suppressed-with-entry, stale-entries)."""
    active: list[Finding] = []
    suppressed: list[tuple[Finding, Suppression]] = []
    used: set[Suppression] = set()
    for f in findings:
        hit = next((s for s in suppressions if s.matches(f)), None)
        if hit is None:
            active.append(f)
        else:
            suppressed.append((f, hit))
            used.add(hit)
    stale = [s for s in suppressions if s not in used]
    return active, suppressed, stale


def render(suppressions: list[Suppression]) -> str:
    """Serialize a baseline back to TOML (the writer for `--write-baseline`
    round-trips through the same subset the fallback reader parses)."""
    lines = ["# cbf_tpu_torch lint baseline — pre-existing findings, each",
             "# with a one-line reason. New findings FAIL; fixing one means",
             "# deleting its entry (stale entries are reported).",
             ""]
    for s in suppressions:
        lines += ["[[suppress]]",
                  f'rule = "{s.rule}"',
                  f'path = "{s.path}"',
                  f'symbol = "{s.symbol}"',
                  f'reason = "{s.reason}"',
                  ""]
    return "\n".join(lines)


def write(path: str, suppressions: list[Suppression]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(render(suppressions))
