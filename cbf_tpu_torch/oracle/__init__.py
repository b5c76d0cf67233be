"""The float64 numpy + scipy oracle of the reference filter
(counterpart: cbf_tpu/oracle)."""

from cbf_tpu_torch.oracle.reference_filter import (  # noqa: F401
    OracleCBF,
    solve_qp_slsqp,
)
