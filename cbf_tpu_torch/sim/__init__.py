"""Simulator surface (counterpart: cbf_tpu/sim): the single-integrator
<-> unicycle maps, the Robotarium unicycle step, the graph Laplacians and
consensus laws, the position controllers and the joint barrier
certificates."""

from cbf_tpu_torch.sim.robotarium import (  # noqa: F401
    SimParams,
    saturate_unicycle,
    unicycle_step,
)
from cbf_tpu_torch.sim.transformations import (  # noqa: F401
    si_to_uni_dyn,
    uni_to_si_states,
)
from cbf_tpu_torch.sim.graph import (  # noqa: F401
    adjacency_from_laplacian,
    complete_gl,
    consensus_velocities,
    cycle_gl,
    cyclic_pursuit_velocities,
)
from cbf_tpu_torch.sim.certificates import (  # noqa: F401
    CertificateParams,
    si_barrier_certificate,
)
from cbf_tpu_torch.sim.controllers import (  # noqa: F401
    at_position,
    si_position_controller,
    unicycle_position_controller,
)
