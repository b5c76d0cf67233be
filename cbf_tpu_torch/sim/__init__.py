"""Simulator surface (counterpart: cbf_tpu/sim): the single-integrator
<-> unicycle maps, the Robotarium unicycle step and the joint barrier
certificates. The controllers and graph modules arrive with later
slices."""
