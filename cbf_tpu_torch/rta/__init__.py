"""Runtime assurance (counterpart: cbf_tpu/rta): in-rollout recovery from
safety-filter failure.

- :mod:`cbf_tpu_torch.rta.core` — the health word, the rungs, the latch
  and the backup controller, as plain torch ops the captured step runs.
- :mod:`cbf_tpu_torch.rta.monitor` — the host-side auditor of the
  ``StepOutputs.rta_mode`` series.

The ladder itself is applied in ``scenarios.swarm._build_step`` behind
``Config.rta``; with it off every RTA channel is ``()``.
"""

from cbf_tpu_torch.rta.core import (                          # noqa: F401
    BIT_ACTUATION_DEFICIT, BIT_CARRY_RESET, BIT_CERT_RESIDUAL,
    BIT_CONTROL_NONFINITE, BIT_INFEASIBLE, BIT_STATE_NONFINITE,
    HEALTH_BIT_NAMES, RUNG_BACKUP, RUNG_NOMINAL, RUNG_RESOLVE, RUNG_SCRUB,
    backup_control, demanded_rung, finite_rows, health_word, latch_update,
    rta_seed,
)
from cbf_tpu_torch.rta.monitor import (                       # noqa: F401
    EMITTED_EVENT_TYPES, emit_rta_events, rta_transitions,
)
