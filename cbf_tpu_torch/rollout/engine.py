"""Rollout engine (counterpart: cbf_tpu/rollout/engine.py).

A scenario is a pair ``(state0, step_fn)`` with
``step_fn(state, t) -> (state, StepOutputs)``. The JAX package runs a
chunk of time as one compiled ``lax.scan``; here a chunk is a *program*
(:class:`_Program`): static device buffers for the carried state, the
step clock, the per-step outputs and the step's host inputs, and a body
of ``unroll`` steps that reads and writes only those buffers. On the card
the body is captured once as a CUDA graph and replayed over the chunk (a
trailing partial body gets a graph of its own, as JAX compiles a second
program for it); programs are cached on the step, keyed by the state's
shapes and dtypes, the chunk length, ``unroll`` and the relax rounds, as
JAX's jit caches executables. On the CPU the same body runs, uncaptured.

The step inside the body gets ``t`` as a 0-dim int64 tensor on the
state's device and, where it has the ``host_inputs(t0, n)`` hook, its row
of the table the hook returns (copied to the device before the chunk) as
``inputs``. Its QP solves run a fixed number of relax rounds on the device
(``step_fn.relax_rounds``, default 0; :func:`cbf_tpu_torch.solvers.exact2d.
guarded_relax`) and raise a device flag where the eager relax loop would
have gone on; an adaptive sparse-ADMM budget runs ``step_fn.admm_blocks``
blocks (default None, the whole budget) and raises it where its loop would
have gone on. The step may raise the same flag for a data-dependent branch
it leaves out of the body (:func:`cbf_tpu_torch.solvers.exact2d.
request_redo`; RTA's boosted re-solve). The engine reads that flag once
per chunk; where it is set, it restores the chunk's start state and runs
the chunk again with the eager loop (:func:`eager_rollout`, the
host-guarded relax loop and host branches, the same kernels), counted in
``COUNTS``. So a compiled rollout is bit-identical to the eager loop.

The carried state is any tree of tensors and (named) tuples — the swarm's
headings, Verlet cache (int32 indices) and RTA carry (int32 mode and
streak, with ``()`` leaves nested inside) ride in the static buffers, the
chunk's saved start and the redo like positions do.

A capture or launch failure raises: no path runs the eager loop on the card
except that counted redo.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from cbf_tpu_torch.errors import SLICE_DURABLE, OutOfSliceError
from cbf_tpu_torch.ops import knn
from cbf_tpu_torch.solvers import exact2d

# Engine-level counts: CUDA graphs captured and replayed, and chunks (and
# their steps) redone with the eager loop because the guarded relax rounds
# did not settle every QP or the step asked for a branch the body leaves
# out.
COUNTS = {"captures": 0, "replays": 0, "redos": 0, "redo_steps": 0}


class StepOutputs(NamedTuple):
    """Per-step observability record emitted by every scenario step.
    Fields a scenario does not track are ``()``."""
    min_pairwise_distance: Any    # scalar — collision margin time series
    filter_active_count: Any      # scalar — agents whose CBF filter engaged
    infeasible_count: Any         # scalar — agents whose QP hit the relax cap
    max_relax_rounds: Any         # scalar — worst relaxation this step
    trajectory: Any               # optional (N, 2) position snapshot
    gating_overflow_count: Any = ()      # banded gating only
    gating_dropped_count: Any = ()       # in-radius neighbours beyond k
    certificate_residual: Any = ()
    certificate_dropped_count: Any = ()
    saturation_deficit: Any = ()
    certificate_iterations: Any = ()
    certificate_carry_resets: Any = ()
    rta_mode: Any = ()


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of matching (named) tuples; ``()``
    stays ``()``."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple):
        vals = [_tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*vals) if hasattr(first, "_fields") \
            else tuple(vals)
    raise TypeError(f"rollout state and outputs hold tensors and tuples, "
                    f"got {type(first).__name__}")


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _stack_steps(outs: list) -> StepOutputs:
    """Per-field stack of a list of StepOutputs; ``()`` fields stay ``()``."""
    return _tree_map(lambda *xs: torch.stack(xs), *outs)


def eager_rollout(step_fn: Callable, state0, steps: int, *, t0: int = 0):
    """The eager loop: ``step_fn(state, t)`` for t in [t0, t0 + steps),
    with Python int t, the host-guarded relax loop and each step's host
    inputs computed by the step itself. The reference the compiled rollout
    is held to, and its redo path. Returns (final_state, StepOutputs
    stacked over time, or None for no steps)."""
    state, outs = state0, []
    for t in range(t0, t0 + steps):
        state, out = step_fn(state, t)
        outs.append(out)
    return state, (_stack_steps(outs) if outs else None)


def _check_unroll(unroll, n: int) -> int:
    """Steps per body: ``unroll`` (a positive int; True means the whole
    chunk, False one step, as ``lax.scan`` reads it), at most ``n``."""
    if isinstance(unroll, bool):
        unroll = n if unroll else 1
    if not isinstance(unroll, int) or unroll < 1:
        raise ValueError(f"unroll must be a positive int or a bool, got "
                         f"{unroll!r}")
    return min(unroll, n)


class _Program:
    """One chunk length's static buffers and bodies for one step — the
    counterpart of one jit executable (see the module docstring)."""

    def __init__(self, step_fn, state, n: int, unroll: int, rounds: int,
                 blocks: int | None = None):
        leaf = _leaves(state)[0]
        self.device = leaf.device
        self.n, self.unroll, self.rounds = n, unroll, rounds
        self.blocks = blocks
        self.carry = _tree_map(torch.empty_like, state)
        # clock = [t, j]: the global step and the position in the chunk of
        # the body's first step; the body advances both.
        self.clock = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.flag = torch.zeros((), dtype=torch.bool, device=self.device)
        self.host_inputs = getattr(step_fn, "host_inputs", None)
        self.inputs = None
        self.outs = None          # StepOutputs of (n, ...) buffers
        self.graphs = {}          # body length -> (CUDAGraph, launches)
        self.pool = None

    def load(self, state) -> None:
        """Copy ``state`` into the static carry (``state`` is not kept)."""
        _tree_map(lambda dst, src: dst.copy_(src), self.carry, state)

    def start(self, t0: int) -> None:
        """Set the clock to chunk start ``t0``, clear the relax flag and
        copy the chunk's host inputs to the device."""
        self.clock[0].fill_(t0)
        self.clock[1].fill_(0)
        self.flag.zero_()
        if self.host_inputs is not None:
            table = self.host_inputs(t0, self.n)
            if self.inputs is None:
                self.inputs = torch.empty(table.shape, dtype=table.dtype,
                                          device=self.device)
            self.inputs.copy_(table)

    def body(self, step_fn, length: int) -> None:
        """``length`` steps on the static buffers — what a graph captures:
        no host read, no host-to-device copy, no allocation that outlives
        it."""
        state = self.carry
        with exact2d.guarded_relax(self.rounds, self.flag, self.blocks):
            for i in range(length):
                t = self.clock[0] if i == 0 else self.clock[0] + i
                j = self.clock[1:] if i == 0 else self.clock[1:] + i
                if self.inputs is None:
                    state, out = step_fn(state, t)
                else:
                    state, out = step_fn(
                        state, t, inputs=self.inputs.index_select(0, j)[0])
                if self.outs is None:     # first body: not under capture
                    self.outs = _tree_map(
                        lambda v: torch.empty((self.n,) + tuple(v.shape),
                                              dtype=v.dtype,
                                              device=v.device), out)
                _tree_map(lambda buf, v: buf.index_copy_(0, j, v[None]),
                          self.outs, out)
        _tree_map(lambda dst, src: dst.copy_(src), self.carry, state)
        self.clock.add_(length)

    def _advance(self, step_fn, length: int) -> None:
        """``length`` steps: a graph replay on the card once captured; the
        first time on the card the body runs for real (the warm-up: it
        builds the kernels' library, plans and constants) and is then
        captured; on the CPU the body runs."""
        if self.device.type != "cuda":
            self.body(step_fn, length)
            return
        if length in self.graphs:
            graph, launches = self.graphs[length]
            graph.replay()
            COUNTS["replays"] += 1
            for name, count in launches.items():
                knn.LAUNCHES[name] += count
            return
        self.body(step_fn, length)
        graph = torch.cuda.CUDAGraph()
        before = dict(knn.LAUNCHES)
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self.body(step_fn, length)
        finally:
            # Capture records the wrappers' launches without running them.
            recorded = {name: knn.LAUNCHES[name] - before[name]
                        for name in before}
            knn.LAUNCHES.update(before)
        self.pool = graph.pool()
        self.graphs[length] = (graph, recorded)
        COUNTS["captures"] += 1

    def run(self, step_fn, t0: int) -> None:
        """The chunk [t0, t0 + n) from the carry: bodies of ``unroll``
        steps, a trailing partial body, then the relax flag read once; the
        chunk is redone eagerly from its saved start where it is set."""
        self.start(t0)
        saved = _tree_map(torch.clone, self.carry)
        full, tail = divmod(self.n, self.unroll)
        for _ in range(full):
            self._advance(step_fn, self.unroll)
        if tail:
            self._advance(step_fn, tail)
        if bool(self.flag):
            COUNTS["redos"] += 1
            COUNTS["redo_steps"] += self.n
            state, outs = eager_rollout(step_fn, saved, self.n, t0=t0)
            self.load(state)
            _tree_map(lambda buf, v: buf.copy_(v), self.outs, outs)

    def outputs(self, to_host: bool):
        """The chunk's outputs: device copies, or numpy arrays (copies
        too: on the CPU a numpy view would alias the buffers)."""
        if to_host:
            return _tree_map(lambda v: v.to("cpu", copy=True).numpy(),
                             self.outs)
        return _tree_map(torch.clone, self.outs)


def _signature(tree) -> tuple:
    """Structure, shapes and dtypes of a state: the part of the program
    key that changes when the caller hands a different swarm."""
    return (repr(_tree_map(lambda v: None, tree)),
            tuple((tuple(v.shape), v.dtype, v.device)
                  for v in _leaves(tree)))


def _program(step_fn, state, n: int, unroll) -> _Program:
    """The cached program of (step, state signature, n, unroll, relax
    rounds, ADMM blocks); new programs are cached on the step where it
    takes an attribute."""
    unroll = _check_unroll(unroll, n)
    rounds = int(getattr(step_fn, "relax_rounds", 0))
    blocks = getattr(step_fn, "admm_blocks", None)
    key = (_signature(state), n, unroll, rounds, blocks)
    cache = getattr(step_fn, "_rollout_programs", None)
    if cache is None:
        cache = {}
        try:
            step_fn._rollout_programs = cache
        except (AttributeError, TypeError):
            pass
    if key not in cache:
        cache[key] = _Program(step_fn, state, n, unroll, rounds, blocks)
    return cache[key]


def _reject_later(fn: str, **later) -> None:
    for name, value in later.items():
        if value is not None:
            raise OutOfSliceError(f"{fn}({name}=...)", SLICE_DURABLE)


def rollout(step_fn: Callable, state0, steps: int, *, unroll: int = 1,
            telemetry=None, telemetry_every: int = 50,
            cost_model=None, cost_label: str | None = None):
    """Run ``steps`` iterations of ``step_fn`` as one compiled chunk
    (module docstring), ``unroll`` steps per captured body.

    ``telemetry`` and ``cost_model`` are not ported yet and raise;
    ``telemetry_every`` and ``cost_label`` only qualify them. ``state0`` is
    never written. Returns (final_state, StepOutputs stacked over time, on
    the state's device; None for no steps)."""
    _reject_later("rollout", telemetry=telemetry, cost_model=cost_model)
    if steps < 1:
        return state0, None
    prog = _program(step_fn, state0, steps, unroll)
    prog.load(state0)
    prog.run(step_fn, 0)
    return _tree_map(torch.clone, prog.carry), prog.outputs(to_host=False)


def rollout_chunked(step_fn: Callable, state0, steps: int, *,
                    chunk: int = 1000, checkpoint_dir: str | None = None,
                    resume: bool = True, unroll: int = 1,
                    telemetry=None, telemetry_every: int = 50,
                    donate_carry: bool | None = None,
                    durable_hook=None,
                    cost_model=None, cost_label: str | None = None):
    """Run a long rollout in ``chunk``-step compiled segments, moving each
    chunk's outputs to the host (numpy) as it completes, so a long record
    never has to fit device memory.

    ``donate_carry`` (None = auto = True, as no checkpoint writer runs):
    the program's static state buffers carry the state from chunk to chunk
    in place; False hands each chunk a fresh copy of the last one's state.
    The caller's ``state0`` is never written either way. Checkpointing,
    telemetry, the cost model and the durable hook are not ported yet and
    raise; ``resume``, ``telemetry_every`` and ``cost_label`` only qualify
    them. Returns (final_state, StepOutputs stacked over the executed
    steps as numpy arrays, start_step)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    _reject_later("rollout_chunked", checkpoint_dir=checkpoint_dir,
                  telemetry=telemetry, cost_model=cost_model,
                  durable_hook=durable_hook)
    donate = True if donate_carry is None else bool(donate_carry)
    state, prev, parts = state0, None, []
    for t0, n in plan_chunks(0, steps, chunk):
        prog = _program(step_fn, state, n, unroll)
        if not (donate and prog is prev):
            prog.load(state)
        prog.run(step_fn, t0)
        parts.append(prog.outputs(to_host=True))
        state = prog.carry if donate else _tree_map(torch.clone, prog.carry)
        prev = prog
    if not parts:
        return state, None, 0
    if donate:
        state = _tree_map(torch.clone, state)
    return state, stack_host_chunks(parts), 0


def plan_chunks(start: int, steps: int, chunk: int,
                *, pad: bool = False) -> list[tuple[int, int]]:
    """``(t0, n)`` spans covering ``[start, steps)`` in ``chunk``-step
    segments. ``pad=False`` trims the last span to the remaining steps;
    ``pad=True`` keeps every span a full ``chunk`` (the serving lane
    tables' convention)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return [(t0, chunk if pad else min(chunk, steps - t0))
            for t0 in range(start, steps, chunk)]


def stack_host_chunks(parts, axis: int = 0):
    """Concatenate per-chunk host (numpy) outputs along ``axis`` (time
    leading: 0; member-major ensemble metrics: 1), field by field through
    (named) tuples; ``()`` fields stay ``()``."""
    first = parts[0]
    if isinstance(first, tuple):
        vals = [stack_host_chunks(list(p), axis) for p in zip(*parts)]
        return type(first)(*vals) if hasattr(first, "_fields") \
            else tuple(vals)
    return np.concatenate(parts, axis=axis)


def min_pairwise_distance(positions):
    """Min inter-point distance of a (2, N) position set (column layout,
    as in the JAX package's sim layer)."""
    P = positions.T                                  # (N, 2)
    diff = P[:, None, :] - P[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    n = P.shape[0]
    d2 = d2 + torch.eye(n, dtype=d2.dtype, device=d2.device) * 1e9
    return torch.sqrt(torch.amin(d2))
