"""cbf_tpu_torch — the PyTorch/CUDA port of :mod:`cbf_tpu`.

The JAX package stays the reference; this package mirrors its module
names so each counterpart is easy to find (``cbf_tpu/ops/pallas_knn.py`` ->
``cbf_tpu_torch/ops/knn.py``, everything else by the same path). It imports
torch and numpy only — never jax and nothing of ``cbf_tpu``.

It covers the swarm step: consensus nominal, k-NN danger gating
(hand-written CUDA kernels for Hopper in ``csrc/knn.cu``), the batched CBF
filter with the exact 2-D QP solver (direction-deduped, or per agent for a
mixed swarm), every dynamics family (``sim/`` holds the unicycle), the
obstacle field, the Verlet neighbour cache, runtime assurance (``rta/``)
and the joint barrier certificate (``sim/certificates.py`` on the ADMM
solvers of ``solvers/``), driven over time by ``rollout.engine``, whose
compiled rollout captures the step as a CUDA graph. It also holds the
reference's own scenarios (``scenarios/meet_at_center.py``,
``cross_and_rescue.py``, ``antipodal.py``), the rps-style object API
(``compat.py``, with ``examples/``), the replay renderer (``render/``),
the SLSQP oracle (``oracle/``), the native trajectory sink (``native/``)
and the ``run``/``list``/``verify`` CLI (``python -m cbf_tpu_torch``). The
step differentiates with ``unroll_relax > 0``: the trainer (``learn/``,
on ``parallel/ensemble.py``'s member step) fits the filter's parameters
through the closed loop, and the falsifier (``verify/``) searches for
initial states that break it over member-batched compiled rollouts, its
engines drawing JAX's random streams (``utils/prng.py``). Long runs
checkpoint and resume under integrity manifests (``utils/checkpoint.py``,
``durable/``), stream heartbeats to a telemetry sink with a watchdog
(``obs/``), and can be checked for NaN/inf, priced by a cost model and
profiled. The serving layer's compute path (``serve/`` buckets and
packing, ``parallel/ensemble.py``'s lockstep traced-config programs) runs
batches of heterogeneous requests as one captured program, the k-NN
kernels reading each member's radius. Across devices (``parallel/``)
ensembles, one swarm's agents, the trainer and the falsifier spread over
a (dp, sp) mesh of ``torch.distributed`` ranks, and one swarm can be
tiled over space with halo exchange (``parallel/spatial.py``). Static
analysis (``analysis/``) lints the port, checks its captured programs and
runs the collective census of its sharded entry points. A knob the port
has not reached raises :class:`~cbf_tpu_torch.errors.OutOfSliceError`.

Entry points run on the card unless the caller passes ``device="cpu"``
(:func:`cbf_tpu_torch.scenarios.swarm.make`; ``--device cpu`` on the
CLI).
"""

from cbf_tpu_torch.errors import OutOfSliceError

__all__ = ["OutOfSliceError"]
