"""Durable execution: crash recovery across process boundaries
(counterpart: cbf_tpu/durable/).

- ``durable.integrity`` — per-leaf SHA-256 manifests over checkpoints,
  committed atomically and verified on restore, so a corrupt or truncated
  checkpoint is a typed :class:`CheckpointCorrupt` and is skipped to the
  last intact step;
- ``durable.rollout`` — resumable long rollouts: a run directory holds the
  run spec, per-chunk StepOutputs and integrity-checked checkpoints, and
  :func:`resume` continues a killed run bit-exactly;
- ``durable.journal`` — the serve engine's schema-versioned write-ahead
  request journal (the JAX package's file format):
  :func:`replay_journal` folds it into the acknowledged-but-unresolved
  requests and :func:`recover_into` re-enqueues them on a fresh engine.
"""

from cbf_tpu_torch.durable.integrity import (CheckpointCorrupt, MANIFEST_NAME,
                                             MANIFEST_SCHEMA_VERSION,
                                             read_manifest, verify_restored,
                                             write_manifest)

# journal/rollout resolve lazily: utils/checkpoint.py imports this
# package for the integrity layer, and durable.rollout imports the engine
# back.
_LAZY = {"load_spec": "rollout", "resume": "rollout",
         "run_durable": "rollout",
         "JOURNAL_SCHEMA_VERSION": "journal", "JournalReplay": "journal",
         "RequestJournal": "journal", "recover_into": "journal",
         "repair_torn_tail": "journal", "replay_journal": "journal",
         "compact_segments": "journal", "ship_segments": "journal"}

__all__ = [
    "CheckpointCorrupt", "MANIFEST_NAME", "MANIFEST_SCHEMA_VERSION",
    "read_manifest", "verify_restored", "write_manifest", *sorted(_LAZY),
]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f"cbf_tpu_torch.durable.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
