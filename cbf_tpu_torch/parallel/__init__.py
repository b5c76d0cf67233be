"""Execution over a (dp, sp) mesh of ranks (counterpart: cbf_tpu/parallel/).

- :mod:`.mesh`: the mesh over a ``torch.distributed`` world and its
  collectives, one :class:`~.mesh.Axis` object per axis;
- :mod:`.multihost`: joining the world, the rank's feed and the gathered
  metrics; :mod:`.launch` starts a world of ranks on one machine;
- :mod:`.ring` and :mod:`.alltoall`: the agent-sharded neighbour search;
- :mod:`.ensemble`: the ensemble rollout (members over dp, agents over
  sp) and the serving layer's lockstep traced-config programs;
- :mod:`.spatial`: one swarm tiled over sp with halo exchange.
"""

from cbf_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from cbf_tpu_torch.parallel.ring import ring_knn  # noqa: F401
from cbf_tpu_torch.parallel.alltoall import (  # noqa: F401
    all_gather_knn, exchange_knn)
from cbf_tpu_torch.parallel.ensemble import sharded_swarm_rollout  # noqa: F401
from cbf_tpu_torch.parallel.spatial import (  # noqa: F401
    SpatialOverflowError, SpatialSpec, plan_tiles, spatial_swarm_rollout)
from cbf_tpu_torch.parallel import multihost  # noqa: F401
