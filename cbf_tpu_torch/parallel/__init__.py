"""Ensembles over a member axis (counterpart: cbf_tpu/parallel/).

Ported: the whole-swarm-per-member step of the ensemble path
(:mod:`cbf_tpu_torch.parallel.ensemble`), which the trainer drives. The
(dp, sp) mesh, the agent-sharded exchange and the sharded rollout are the
ensembles and partitioning slice's (ROADMAP.md item 10).
"""
