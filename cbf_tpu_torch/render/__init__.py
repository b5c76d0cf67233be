"""Trajectory replay to video (counterpart: cbf_tpu/render)."""

from cbf_tpu_torch.render.video import (  # noqa: F401
    Layer,
    determine_marker_size,
    render_cross_and_rescue,
    render_meet_at_center,
    render_swarm,
    replay,
)
