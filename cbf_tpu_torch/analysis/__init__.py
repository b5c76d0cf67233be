"""Runtime analysis helpers (counterpart: cbf_tpu/analysis/). Only the
lock-order witness the threaded ``obs`` modules create their locks
through is here; the static audits arrive with Queue A12."""
