"""Simulator surface (counterpart: cbf_tpu/sim): the single-integrator
<-> unicycle maps and the Robotarium unicycle step. The certificates,
controllers and graph modules arrive with later slices."""
