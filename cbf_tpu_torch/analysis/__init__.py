"""Static analysis of the port (counterpart: cbf_tpu/analysis/):
machine-checked capture-safety and program-cache invariants for the
compiled hot paths, the repo audits and the lock discipline of the
threaded stack.

The port's compiled unit is the CUDA-graph capture of the rollout
engine's program body; one host read, one host-to-device copy or one step
rebuilt per iteration silently brings back the host round trips and the
recaptures the compiled rollout removed. The package makes that a
standing gate:

* :mod:`cbf_tpu_torch.analysis.ast_rules` — AST capture-safety linter
  (host reads, tensor branches, host-to-device traffic, program-cache
  hazards) over source, no execution;
* :mod:`cbf_tpu_torch.analysis.program_rules` — invariants asserted on
  one eager body of each public entry point's captured program, under
  torch's function and dispatch modes (no host traffic, float32
  discipline, carry stability);
* :mod:`cbf_tpu_torch.analysis.audits` — the repo audits (obs schema,
  tier-1 markers, the certificate's chain depth, reproducibility,
  scenario coverage, concurrency map, spmd-budget liveness);
* :mod:`cbf_tpu_torch.analysis.spmd_rules` — the SPMD analyser: the
  collective census of every sharded entry point run in a
  ``torch.distributed`` world, the replication check, and the hygiene of
  the port's axes and collectives;
* :mod:`cbf_tpu_torch.analysis.mesh_budget` — the committed census
  (``spmd_budget.toml``, the JAX package's schema 1);
* :mod:`cbf_tpu_torch.analysis.concurrency` — lock-discipline linter for
  the threaded serve/durable/obs/cluster stack plus the global
  acquisition-order graph;
* :mod:`cbf_tpu_torch.analysis.lockwitness` — the lock factories and the
  opt-in runtime lock-order witness (``CBF_TPU_LOCK_WITNESS=1``),
  cross-validated against the static graph (``check_subgraph``);
* :mod:`cbf_tpu_torch.analysis.baseline` — suppression file with
  mandatory reasons (``baseline.toml``);
* :mod:`cbf_tpu_torch.analysis.registry` /
  :mod:`~cbf_tpu_torch.analysis.report` — the rule table and the
  text/JSON reporters.

CLI: ``python -m cbf_tpu_torch lint [paths] [--all | --jaxpr |
--concurrency | --spmd] [--json] [--show-suppressed] [--device cpu]``
and ``lint --write-spmd-budget --reason TEXT`` — the README's port
section documents the rule IDs, the port's concurrency map and the
suppression format; ``tests/test_torch_analysis.py`` and
``tests/test_torch_spmd.py`` enforce repo cleanliness as tier-1.
"""

from cbf_tpu_torch.analysis.registry import RULES, Finding, Rule, rule_ids
from cbf_tpu_torch.analysis.report import (LintResult, render_json,
                                           render_text, run_lint)

__all__ = [
    "Finding", "LintResult", "RULES", "Rule", "render_json",
    "render_text", "rule_ids", "run_lint",
]
