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
compiled rollout captures the step as a CUDA graph. Knobs of later slices raise
:class:`~cbf_tpu_torch.errors.OutOfSliceError`.

Entry points run on the card unless the caller passes ``device="cpu"``
(:func:`cbf_tpu_torch.scenarios.swarm.make`).
"""

from cbf_tpu_torch.errors import OutOfSliceError

__all__ = ["OutOfSliceError"]
