"""Ensembles over a member axis (counterpart: cbf_tpu/parallel/).

Ported: the (dp, sp) mesh on one device (:mod:`.mesh`, only (1, 1)
exists there) and the ensemble rollout (:mod:`.ensemble`): the member
step, ``sharded_swarm_rollout`` with dp folded into the member axis and
the lockstep batched certificate, and the serving layer's lockstep
traced-config programs (``lockstep_traced_rollout``,
``lockstep_traced_chunk``). Agent sharding (sp > 1), meshes across
devices and the spatial partition are ROADMAP.md item 10c.
"""
