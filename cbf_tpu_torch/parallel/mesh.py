"""The (dp, sp) device mesh (counterpart: cbf_tpu/parallel/mesh.py).

The JAX package lays ensemble members (``dp``) and one swarm's agents
(``sp``) over a ``jax.sharding.Mesh``. On one card dp folds into the
member axis that every op of the ensemble step carries, and sp is 1, so
the only mesh that exists here is (1, 1) over one device: the card, or
the CPU when the caller asks for it. A wider mesh needs several
processes (``torch.distributed``) and raises.
"""

from __future__ import annotations

import dataclasses

import torch

from cbf_tpu_torch.errors import SLICE_PARALLEL, OutOfSliceError


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) mesh over one device. Iterates as the ``(dp, sp)``
    pair the trainer and the falsifier take."""
    dp: int
    sp: int
    device: torch.device

    @property
    def shape(self) -> dict:
        """``{"dp": dp, "sp": sp}``, as ``jax.sharding.Mesh.shape``."""
        return {"dp": self.dp, "sp": self.sp}

    def __iter__(self):
        return iter((self.dp, self.sp))


def _devices(devices) -> list[torch.device]:
    """The mesh's candidate devices: the current card by default (none
    raises, as ``swarm.resolve_device`` does), else the given ones
    (``"cpu"`` or a list)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; the port runs on the card by "
                "default — pass devices='cpu' to run on the CPU")
        return [torch.device("cuda", torch.cuda.current_device())]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    return [torch.device(d) for d in devices]


def make_mesh(n_dp: int | None = None, n_sp: int = 1,
              devices=None) -> Mesh:
    """A (dp, sp) mesh over ``devices`` (None: the current card, however
    many are visible; or ``"cpu"``, or a list). ``n_dp`` None means every
    device left after sp, as in the JAX package — one on the default
    devices. Only (1, 1) exists: dp > 1 or sp > 1 raises
    :class:`OutOfSliceError`."""
    devs = _devices(devices)
    if n_dp is None:
        n_dp = max(1, len(devs) // n_sp)
    check_single_device(n_dp, n_sp)
    return Mesh(1, 1, devs[0])


def check_single_device(n_dp: int, n_sp: int) -> None:
    """Raise :class:`OutOfSliceError` for any mesh but (1, 1)."""
    if (n_dp, n_sp) != (1, 1):
        raise OutOfSliceError(f"a ({n_dp}, {n_sp}) (dp, sp) mesh across "
                              "devices", SLICE_PARALLEL)
