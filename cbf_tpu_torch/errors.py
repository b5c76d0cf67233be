"""Typed errors of the port."""

from __future__ import annotations


class OutOfSliceError(NotImplementedError):
    """A knob or code path the port has not reached yet.

    The message names the slice (and its ROADMAP.md queue item) that will
    bring it, so a caller never gets a silently ignored option."""

    def __init__(self, what: str, slice_name: str):
        super().__init__(f"{what} is not ported yet: it arrives with "
                         f"{slice_name} of the PyTorch port (ROADMAP.md)")
        self.what = what
        self.slice_name = slice_name


SLICE_DIFF = "the differentiable-path slice (Queue A8)"
SLICE_DURABLE = "the durability and observability slice (Queue A9)"
SLICE_PARALLEL = "the ensembles and partitioning slice (Queue A10)"
SLICE_SERVE = "the serving slice (Queue A11)"
