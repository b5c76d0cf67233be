"""Multi-process execution (counterpart: cbf_tpu/parallel/multihost.py).

Every process calls :func:`initialize`, after which the mesh code of
:mod:`cbf_tpu_torch.parallel` spans the world: one process per mesh slot,
each with its own device (:func:`cbf_tpu_torch.parallel.mesh.make_mesh`).

Typical use, one process per card under ``torchrun --nproc-per-node``::

    from cbf_tpu_torch.parallel import multihost
    multihost.initialize()                  # torchrun's environment
    mesh = multihost.global_mesh(n_sp=2)    # dp x sp over every rank
    (xf, vf), mets = sharded_swarm_rollout(cfg, mesh, seeds)

:mod:`cbf_tpu_torch.parallel.launch` starts such a world itself (gloo over
a file store), which is how the tests and the CLI run several ranks on
one machine. torch has no global array: :func:`shard_host_ensembles`
returns a rank's block with its offset, and :func:`gather_metrics` the
world's blocks concatenated.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from cbf_tpu_torch.parallel.mesh import Mesh, local_rank, make_mesh, world

#: Environment variable naming the file store of a world started by
#: :mod:`cbf_tpu_torch.parallel.launch` (``init_method="file://..."``).
STORE_ENV = "CBF_TPU_TORCH_STORE"
#: Environment variable forcing the backend ("gloo" or "nccl").
BACKEND_ENV = "CBF_TPU_TORCH_BACKEND"


def default_backend(device="cuda", local_world: int | None = None) -> str:
    """NCCL where every one of this host's ``local_world`` ranks (default:
    the environment's) has a card of its own, else gloo (the CPU, or ranks
    sharing a card: NCCL refuses two ranks on one GPU).
    :data:`BACKEND_ENV` forces one."""
    forced = os.environ.get(BACKEND_ENV)
    if forced:
        return forced
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ.get("WORLD_SIZE", "1")))
    if (str(device).startswith("cuda") and torch.cuda.is_available()
            and dist.is_nccl_available()
            and torch.cuda.device_count() >= local_world):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None,
               timeout_s: float = 1800.0) -> None:
    """Join the process world (idempotent).

    With no arguments the world comes from the environment: torchrun's
    ``RANK``/``WORLD_SIZE`` with ``MASTER_ADDR``/``MASTER_PORT``, or a
    launcher's file store (:data:`STORE_ENV`). With neither it is a plain
    single-process run and nothing is joined. ``coordinator_address`` is
    ``host:port`` (TCP) or a full ``init_method`` URL (``file://...``).
    Any other failure (an unreachable coordinator, a timeout) propagates:
    a rank must never run on alone as a world of one."""
    if dist.is_available() and dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and num_processes is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            return
        rank, size = int(env["RANK"]), int(env["WORLD_SIZE"])
        init_method = (f"file://{env[STORE_ENV]}" if env.get(STORE_ENV)
                       else "env://")
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "initialize needs coordinator_address, num_processes and "
                "process_id together (or none of them, to read the "
                "environment)")
        rank, size = int(process_id), int(num_processes)
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    backend = backend or default_backend()
    if backend == "nccl":
        # One card per rank: NCCL's collectives run on the current device.
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the world (no-op outside one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """(process_index, process_count) of this process."""
    return world()


def is_primary() -> bool:
    """True on exactly one process — gate logging and file writes with
    it."""
    return world()[0] == 0


def barrier() -> None:
    """Wait for every rank of the world (no-op outside one)."""
    if world()[1] > 1:
        dist.barrier()


def global_mesh(n_sp: int = 1, n_dp: int | None = None,
                devices=None) -> Mesh | None:
    """(dp, sp) mesh over every process (call after :func:`initialize`)."""
    return make_mesh(n_dp=n_dp, n_sp=n_sp, devices=devices)


def shard_host_ensembles(mesh: Mesh, local_data):
    """This rank's block of a dp-sharded ensemble feed: each rank passes
    its own ``(E_local, ...)`` block (its slice of Monte-Carlo seeds'
    initial states). Returns (the block as a tensor on the mesh's device,
    its global member offset ``dp_index * E_local``) — torch has no
    global array, so the offset is what places the block."""
    block = torch.as_tensor(np.asarray(local_data), device=mesh.device)
    return block, mesh.axis("dp").index * int(block.shape[0])


def gather_metrics(tree):
    """Every leaf of ``tree`` from every rank, concatenated on its leading
    axis in rank order, as numpy on every rank (a (E_local, ...) block
    comes back as (P * E_local, ...)). Outside a world, the leaves as
    numpy."""
    size = world()[1]

    def one(a):
        t = (a.detach().cpu() if torch.is_tensor(a)
             else torch.as_tensor(np.asarray(a))).contiguous()
        if size == 1:
            return t.numpy()
        if t.dim() == 0:
            t = t[None]
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        t = t.to(dev)
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t)
        return torch.cat(parts).cpu().numpy()

    if isinstance(tree, dict):
        return {k: gather_metrics(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather_metrics(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_metrics(v) for v in tree)
    return one(tree)
