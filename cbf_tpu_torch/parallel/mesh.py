"""The (dp, sp) mesh over a process world (counterpart:
cbf_tpu/parallel/mesh.py).

The JAX package lays ensemble members (``dp``) and one swarm's agents
(``sp``) over a ``jax.sharding.Mesh`` of devices and runs SPMD in one
process. The port runs one process per mesh slot on ``torch.distributed``
(:mod:`cbf_tpu_torch.parallel.multihost` joins the world): rank r is slot
(r // n_sp, r % n_sp), as JAX lays devices out, and each axis is a process
group with its collectives in one :class:`Axis` object — ``psum`` and
``pmax`` are ``all_reduce``, the tiled ``all_gather`` is ``all_gather``,
``ppermute`` is ``batch_isend_irecv`` over the JAX pair list, and the axis
index is the rank's place in its group.

Outside a world the mesh is (1, 1) over one device — the current card,
or the CPU when the caller asks for it — and every collective is the
identity, so the one-device programs stay captured and unchanged.

Backends: gloo on the CPU and where ranks share a card, NCCL where every
rank has a card of its own (:func:`multihost.initialize` picks). Under
gloo a CUDA tensor is copied to the host and back inside :class:`Axis`,
and nowhere else; :data:`COUNTS` counts the collectives, those copies and
their bytes.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

#: The collective census's kinds (the JAX package's census keys,
#: ``analysis.spmd_rules.COLLECTIVE_KINDS``): ``psum``/``pmax`` are
#: ``all_reduce``, ``all_gather`` is ``all_gather``, ``ppermute`` is
#: ``ppermute``; the port issues no reduce_scatter or all_to_all.
CENSUS_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "ppermute",
                "all_to_all")

#: Collectives issued by every :class:`Axis` of this process (an axis of
#: size 1 issues none), the host copies gloo staging made, and their
#: bytes; and per census kind its count (``"<kind>"``) and its operand
#: bytes (``"<kind>_bytes"``).
COUNTS = {"collectives": 0, "host_copies": 0, "host_bytes": 0,
          **{k: 0 for k in CENSUS_KINDS},
          **{f"{k}_bytes": 0 for k in CENSUS_KINDS}}


def zero_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def census() -> dict[str, dict[str, int]]:
    """``{kind: {"count": n, "bytes": b}}`` over every census kind (zeros
    included) from :data:`COUNTS`."""
    return {k: {"count": COUNTS[k], "bytes": COUNTS[f"{k}_bytes"]}
            for k in CENSUS_KINDS}


class Axis:
    """One mesh axis: its extent (``size``), this rank's index on it
    (``index``, ``lax.axis_index``), and its collectives (``lax.psum``/
    ``pmax``/``all_gather``/``ppermute``). A size-1 axis needs no group:
    every collective is the identity (``ppermute`` keeps what maps 0 to
    0)."""

    def __init__(self, name: str, size: int, index: int = 0,
                 ranks: tuple = (), group=None, staged: bool = False):
        self.name = name
        self.size = int(size)
        self.index = int(index)
        self.ranks = tuple(ranks)
        self.group = group
        self.staged = staged

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"

    # -- staging -----------------------------------------------------------

    def _host(self, x, kind: str):
        """``x`` where the backend can take it: a contiguous copy, on the
        host under gloo staging, bool as uint8. Counts one collective of
        ``kind`` on ``x``'s bytes."""
        COUNTS["collectives"] += 1
        COUNTS[kind] += 1
        COUNTS[f"{kind}_bytes"] += x.numel() * x.element_size()
        x = x.detach()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if self.staged and x.device.type == "cuda":
            COUNTS["host_copies"] += 1
            COUNTS["host_bytes"] += x.numel() * x.element_size()
            return x.to("cpu")
        return x.contiguous().clone()

    def _back(self, y, like):
        """The backend's result back on ``like``'s device and dtype."""
        if y.device != like.device:
            COUNTS["host_copies"] += 1
            COUNTS["host_bytes"] += y.numel() * y.element_size()
            y = y.to(like.device)
        return y.to(like.dtype) if y.dtype != like.dtype else y

    def _reduce(self, x, op):
        if self.size == 1:
            return x
        h = self._host(x, "all_reduce")
        dist.all_reduce(h, op=op, group=self.group)
        return self._back(h, x)

    # -- collectives ---------------------------------------------------------

    def psum(self, x):
        """Sum over the axis (``lax.psum``). With a gradient the backward
        sums the cotangents over the axis too (``torch.distributed.nn``'s
        rule: every rank's use of the sum reaches every summand)."""
        if self.size == 1:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _PSum.apply(x, self)
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x):
        """Every rank's ``x`` concatenated on dim 0 in axis order
        (``lax.all_gather(..., tiled=True)``); the backward sums each
        rank's slice of the cotangents over the axis."""
        if self.size == 1:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _AllGather.apply(x, self)
        return self._gather(x)

    def _gather(self, x):
        h = self._host(x, "all_gather")
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h, group=self.group)
        return self._back(torch.cat(parts, dim=0), x)

    def ppermute(self, x, perm):
        """``lax.ppermute``: for each (src, dst) pair of axis indices, dst
        receives src's ``x``; an index no pair sends to receives zeros.
        The backward permutes the cotangent back."""
        perm = [(int(s), int(d)) for s, d in perm]
        if self.size > 1 and torch.is_grad_enabled() and x.requires_grad:
            return _PPermute.apply(x, self, tuple(perm))
        return self._permute(x, perm)

    def _permute(self, x, perm):
        send = [d for s, d in perm if s == self.index]
        recv = [s for s, d in perm if d == self.index]
        if self.size == 1:
            return x.clone() if recv else torch.zeros_like(x)
        h = self._host(x, "ppermute")
        out = torch.zeros_like(h)
        ops = [dist.P2POp(dist.isend, h, self.ranks[d], self.group)
               for d in send if d != self.index]
        ops += [dist.P2POp(dist.irecv, out, self.ranks[s], self.group)
                for s in recv if s != self.index]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if (self.index, self.index) in perm:
            out = h.clone()
        return self._back(out, x)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis._reduce(x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, ct):
        return ctx.axis.psum(ct), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[0]
        return axis._gather(x)

    @staticmethod
    def backward(ctx, ct):
        i, n = ctx.axis.index, ctx.n
        return ctx.axis.psum(ct)[i * n:(i + 1) * n], None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return axis._permute(x, list(perm))

    @staticmethod
    def backward(ctx, ct):
        inverse = [(d, s) for s, d in ctx.perm]
        return ctx.axis.ppermute(ct, inverse), None, None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) mesh: this rank's device and its two :class:`Axis`
    objects. Iterates as the ``(dp, sp)`` pair the trainer and the
    falsifier take. Equal meshes have equal extents and device."""
    dp: int
    sp: int
    device: torch.device
    dp_axis: Axis = dataclasses.field(default=None, compare=False,
                                      repr=False)
    sp_axis: Axis = dataclasses.field(default=None, compare=False,
                                      repr=False)

    def __post_init__(self):
        if self.dp_axis is None and self.dp * self.sp == 1:
            object.__setattr__(self, "dp_axis", Axis("dp", 1))
            object.__setattr__(self, "sp_axis", Axis("sp", 1))

    @property
    def shape(self) -> dict:
        """``{"dp": dp, "sp": sp}``, as ``jax.sharding.Mesh.shape``."""
        return {"dp": self.dp, "sp": self.sp}

    def __iter__(self):
        return iter((self.dp, self.sp))

    def axis(self, name: str) -> Axis:
        """The :class:`Axis` named ``"dp"`` or ``"sp"``."""
        ax = {"dp": self.dp_axis, "sp": self.sp_axis}[name]
        if ax is None:
            raise ValueError(
                f"a ({self.dp}, {self.sp}) mesh spans several processes: "
                "build it with make_mesh inside a torch.distributed world "
                "(parallel.multihost.initialize)")
        return ax

    @property
    def local(self) -> "Mesh":
        """This rank's slot alone: the (1, 1) mesh on its device."""
        return Mesh(1, 1, self.device)


def resolve_axis(axis_name) -> Axis:
    """An :class:`Axis`, or the axis of that name of the last mesh
    :func:`make_mesh` built in this process (the JAX package's named
    axes, which ``shard_map`` binds)."""
    if isinstance(axis_name, Axis):
        return axis_name
    if _ACTIVE.get("mesh") is None:
        raise ValueError(f"no mesh binds axis {axis_name!r}: pass an Axis "
                         "(Mesh.axis) or build the mesh first")
    return _ACTIVE["mesh"].axis(axis_name)


_ACTIVE: dict = {}
_GROUPS: dict = {}


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> int:
    """The rank among this host's processes (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", world()[0]))


def _devices(devices) -> list[torch.device]:
    """The mesh's candidate devices: this rank's card by default
    (``cuda:{local_rank % device_count}``; none raises), else the given
    ones (``"cpu"`` or a list, one per rank)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; the port runs on the card by "
                "default — pass devices='cpu' to run on the CPU")
        if world()[1] > 1:
            return [torch.device("cuda",
                                 local_rank() % torch.cuda.device_count())]
        return [torch.device("cuda", torch.cuda.current_device())]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    return [torch.device(d) for d in devices]


def make_mesh(n_dp: int | None = None, n_sp: int = 1,
              devices=None) -> Mesh | None:
    """Build a (dp, sp) mesh over the world's ranks, one device each
    (``devices``: None for this rank's card, ``"cpu"``, or a list with
    rank r on entry r modulo its length). ``n_dp`` None means every rank
    left after sp. Outside a world there is one rank, so only (1, 1)
    exists. Every rank of the world must call it, in the same order (it
    builds the process groups); a rank beyond ``n_dp * n_sp`` gets None,
    as JAX keeps the first devices only."""
    rank, n = world()
    devs = _devices(devices)
    if n % n_sp != 0:
        raise ValueError(f"n_sp={n_sp} must divide device count {n}")
    if n_dp is None:
        n_dp = n // n_sp
    if n_dp * n_sp > n:
        raise ValueError(f"mesh {n_dp}x{n_sp} exceeds {n} devices")
    device = devs[rank % len(devs)]
    if n == 1:
        mesh = Mesh(1, 1, device)
        _ACTIVE["mesh"] = mesh
        return mesh
    key = (n_dp, n_sp, id(dist.group.WORLD))
    if key not in _GROUPS:
        # Every rank builds every group, in one order (a collective).
        dp_groups = [tuple(i * n_sp + j for i in range(n_dp))
                     for j in range(n_sp)]
        sp_groups = [tuple(i * n_sp + j for j in range(n_sp))
                     for i in range(n_dp)]
        _GROUPS[key] = {g: (dist.new_group(list(g)) if len(g) > 1 else None)
                        for g in dp_groups + sp_groups}
    if rank >= n_dp * n_sp:
        return None
    i, j = divmod(rank, n_sp)
    staged = dist.get_backend() == "gloo" and device.type == "cuda"
    dp_ranks = tuple(a * n_sp + j for a in range(n_dp))
    sp_ranks = tuple(i * n_sp + b for b in range(n_sp))
    groups = _GROUPS[key]
    mesh = Mesh(n_dp, n_sp, device,
                Axis("dp", n_dp, i, dp_ranks, groups[dp_ranks], staged),
                Axis("sp", n_sp, j, sp_ranks, groups[sp_ranks], staged))
    _ACTIVE["mesh"] = mesh
    return mesh


def as_mesh(mesh, device) -> Mesh:
    """``mesh`` as a :class:`Mesh` on ``device``: None is (1, 1), a
    (dp, sp) pair is built over the world (:func:`make_mesh`)."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is None:
        return Mesh(1, 1, torch.device(device))
    dp, sp = (int(v) for v in mesh)
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh must be a (dp, sp) pair of positive ints, "
                         f"got {mesh!r}")
    if dp * sp == 1:
        return Mesh(1, 1, torch.device(device))
    return make_mesh(dp, sp, devices=device)
