"""Routed multi-engine serve cluster (counterpart: cbf_tpu/cluster/,
ported whole; the transport's inbox, claimed, outbox, ``prewarm.json``
and ready files keep the JAX package's names and JSON, and the ring
places every bucket label on the same engine as the JAX package's).

A router process fronts M `~cbf_tpu_torch.serve.engine.ServeEngine`
workers over a file-IPC transport:

- `cluster.ring` — consistent-hash placement by bucket signature
  (cache/prewarm affinity; minimal disruption when the ring changes).
- `cluster.transport` — per-engine inbox/claimed/outbox directories;
  atomic renames arbitrate every claim-vs-steal race, making the
  never-steal-acked invariant structural.
- `cluster.router` — `ClusterRouter`: cost-model admission (fail-open),
  placement, work stealing, and the engine-shaped client
  surface `run_loadgen` drives unmodified.
- `cluster.worker` — `Worker` / `run_worker`: the claim/ack/respond
  loop around one engine, fenced lease + WAL, drain-on-SIGTERM.
- `cluster.membership` — `Membership`: lease monitoring, dead-engine
  failover with journal replay + request-id dedupe, rolling restarts,
  and `cluster_census` (the cluster-wide zero-lost-acks /
  zero-duplicates verdict).

CLI: ``python -m cbf_tpu_torch cluster serve --engines M [--steal]
[--roll]`` and ``python -m cbf_tpu_torch cluster worker --root R --name
E`` (``--device`` as ``serve``: the card unless ``--device cpu``).
"""

from cbf_tpu_torch.cluster.membership import Membership, cluster_census
from cbf_tpu_torch.cluster.ring import HashRing, ring_hash
from cbf_tpu_torch.cluster.router import ClusterRouter, RoutedPending
from cbf_tpu_torch.cluster.transport import EngineDirs
from cbf_tpu_torch.cluster.worker import Worker, run_worker

__all__ = [
    "ClusterRouter", "EngineDirs", "HashRing", "Membership",
    "RoutedPending", "Worker", "cluster_census", "ring_hash",
    "run_worker",
]
