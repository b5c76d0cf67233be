"""Falsification (counterpart: cbf_tpu/verify/): adversarial search for
initial states that break the filter, shrinking, and the replayable
violation corpus.

- :mod:`.properties` — robustness margins (``margin < 0 <=> violation``)
  with a NumPy twin;
- :mod:`.search` — the random, gradient and CEM engines over
  member-batched compiled rollouts;
- :mod:`.shrink` — horizon and norm minimization, the float64 replay;
- :mod:`.corpus` — the JSONL archive and its replay gate.

CLI: ``python -m cbf_tpu_torch verify`` (exit 3 = violation found). The
falsification fleet (``verify/fleet.py``, a background tenant of the
serve engine) is the serving slice's (ROADMAP.md item 11).
"""

from cbf_tpu_torch.verify.corpus import (append_entry, check_replay,
                                         check_verdict, entry_from,
                                         load_entries, near_miss_entry,
                                         replay_corpus, replay_entry)
from cbf_tpu_torch.verify.properties import (DIFFERENTIABLE_PROPERTIES,
                                             PROPERTY_NAMES, Margins,
                                             PropertyThresholds,
                                             rollout_margins,
                                             rollout_margins_np,
                                             thresholds_for)
from cbf_tpu_torch.verify.search import (ENGINES, Adapter, SearchResult,
                                         SearchSettings, cem_search, falsify,
                                         gradient_search, make_adapter,
                                         make_eval_batch, make_eval_one,
                                         random_search, reset_campaign_state)
from cbf_tpu_torch.verify.shrink import (ShrinkResult, enable_x64_ctx,
                                         measure_margin_x64, shrink)

__all__ = [
    "Adapter", "DIFFERENTIABLE_PROPERTIES", "ENGINES", "Margins",
    "PROPERTY_NAMES", "PropertyThresholds", "SearchResult",
    "SearchSettings", "ShrinkResult", "append_entry", "cem_search",
    "check_replay", "check_verdict", "enable_x64_ctx", "entry_from",
    "falsify", "gradient_search", "load_entries", "make_adapter",
    "make_eval_batch", "make_eval_one", "measure_margin_x64",
    "near_miss_entry", "random_search", "replay_corpus", "replay_entry",
    "reset_campaign_state", "rollout_margins", "rollout_margins_np",
    "shrink", "thresholds_for",
]
