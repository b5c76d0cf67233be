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
chunk's saved start and the redo like positions do. So do per-call inputs
that a step reads and hands back unchanged (the serving programs' traced
values, horizons and clocks, :func:`cbf_tpu_torch.parallel.ensemble.
lockstep_traced_rollout`): ``load`` fills their buffers before each run,
so one captured program serves any values of them.

A capture or launch failure raises: no path runs the eager loop on the card
except that counted redo.

The durability and observability knobs are host-side and leave every
value the rollout computes as it is: ``rollout_chunked(checkpoint_dir=)``
snapshots the carry at each chunk boundary
(:class:`cbf_tpu_torch.utils.checkpoint.CheckpointWriter`), ``telemetry=``
wraps the step with the tap (:mod:`cbf_tpu_torch.obs.tap`), whose
heartbeats the engine emits while the next chunk runs (in ``rollout``
that chunk is queued before the one before it is settled, so the card
does not wait at a boundary: :func:`_run_tapped`), and
``cost_model=`` measures each program at its capture
(:meth:`_Program.prepare`) and times its runs
(:class:`cbf_tpu_torch.obs.resource.CostModel`).
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from cbf_tpu_torch.ops import knn
from cbf_tpu_torch.solvers import exact2d

# Engine-level counts: CUDA graphs captured and replayed, chunks (and
# their steps) redone with the eager loop because the guarded relax rounds
# did not settle every QP or the step asked for a branch the body leaves
# out, and the steps of a tapped rollout's queued chunks run again because
# the chunk before them was redone (:func:`_run_tapped`).
COUNTS = {"captures": 0, "replays": 0, "redos": 0, "redo_steps": 0,
          "rerun_steps": 0}


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


class Extra(NamedTuple):
    """A wrapped step's per-step outputs: the step's own ``outputs`` and
    what the wrapper adds (the telemetry tap's non-finite count, the
    checked rollout's flags). The rollout returns ``outputs`` alone."""
    outputs: Any
    extra: Any


def strip_extra(outs):
    """``outs`` without the wrappers' :class:`Extra` layers."""
    while isinstance(outs, Extra):
        outs = outs.outputs
    return outs


def forward_attributes(wrapped: Callable, step_fn: Callable) -> Callable:
    """Give a step wrapper the step's compiled-rollout attributes
    (``relax_rounds``, ``admm_blocks``, ``host_inputs``)."""
    for name in ("relax_rounds", "admm_blocks", "host_inputs"):
        if hasattr(step_fn, name):
            setattr(wrapped, name, getattr(step_fn, name))
    return wrapped


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
        self.analysis = None      # prepare()'s measurements

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
            if table is None:             # a hook with nothing to copy
                return
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
        # A leaf the step hands back unchanged (the carry's own tensor: the
        # serving programs' per-lane inputs) is not copied onto itself.
        _tree_map(lambda dst, src: None if dst is src else dst.copy_(src),
                  self.carry, state)
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

    def run(self, step_fn, t0: int, during=None) -> None:
        """The chunk [t0, t0 + n) from the carry: bodies of ``unroll``
        steps, a trailing partial body, then ``during()`` (host work that
        overlaps the chunk on the card), then the relax flag read once; the
        chunk is redone eagerly from its saved start where it is set."""
        ticket = self.launch(step_fn, t0)
        if during is not None:
            during()
        self.settle(step_fn, ticket)

    def launch(self, step_fn, t0: int, host_flag: bool = False) -> tuple:
        """Queue the chunk [t0, t0 + n) from the carry and return what
        :meth:`settle` needs: the start clock, the saved start state and
        the relax flag — with ``host_flag``, a host copy of it started on
        the stream, so reading it waits for this chunk alone and not for
        work queued after it."""
        self.start(t0)
        saved = _tree_map(torch.clone, self.carry)
        full, tail = divmod(self.n, self.unroll)
        for _ in range(full):
            self._advance(step_fn, self.unroll)
        if tail:
            self._advance(step_fn, tail)
        flag, event = self.flag, None
        if host_flag and self.device.type == "cuda":
            flag = torch.empty((), dtype=torch.bool, pin_memory=True)
            flag.copy_(self.flag, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        elif host_flag:
            flag = self.flag.clone()
        return t0, saved, flag, event

    def settle(self, step_fn, ticket) -> bool:
        """Read a launched chunk's relax flag; where it is set, redo the
        chunk eagerly from its saved start into the carry and the output
        buffers. Returns whether it was redone."""
        t0, saved, flag, event = ticket
        if event is not None:
            event.synchronize()
        if not bool(flag):
            return False
        COUNTS["redos"] += 1
        COUNTS["redo_steps"] += self.n
        state, outs = eager_rollout(step_fn, saved, self.n, t0=t0)
        self.load(state)
        _tree_map(lambda buf, v: buf.copy_(v), self.outs, outs)
        return True

    def prepare(self, step_fn, state, t0: int) -> "_Program":
        """Capture every body the chunk [t0, t0 + n) needs (on the CPU: run
        each once) from a copy of ``state``, put ``state`` back in the
        carry, and measure the program: ``argument_bytes`` (the static
        carry, clock, flag and input buffers), ``output_bytes`` (the
        per-step output buffers) and, on the card when a body was captured
        here, ``peak_bytes`` — the argument buffers plus the most device
        memory allocated above them during the warm-up runs and the
        captures (``torch.cuda.max_memory_allocated``). The cost model's
        "compile"; the warm-up runs are discarded."""
        start = _tree_map(torch.clone, state)   # state may be the carry
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.load(start)
        self.start(t0)
        tail = self.n % self.unroll
        captured = False
        for length in [self.unroll] + ([tail] if tail else []):
            if cuda and length not in self.graphs:
                captured = True
                self._advance(step_fn, length)
        if self.outs is None:          # the CPU: allocate the output buffers
            self.body(step_fn, self.unroll)
        self.load(start)

        def nbytes(tree):
            return sum(v.numel() * v.element_size() for v in _leaves(tree))

        args = nbytes((self.carry, self.clock, self.flag)) + (
            0 if self.inputs is None else nbytes(self.inputs))
        peak = None
        if captured:
            torch.cuda.synchronize(self.device)
            peak = args + torch.cuda.max_memory_allocated(self.device) - base
        self.analysis = {"argument_bytes": args,
                         "output_bytes": nbytes(self.outs),
                         "peak_bytes": peak}
        return self

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


def _run_chunks(step_fn, state, spans, *, unroll, donate: bool,
                to_host: bool, writer=None, wait_snapshot: bool = False,
                durable_hook=None, cost_model=None, label=None,
                observe_each: bool = True):
    """The chunk loop of :func:`rollout` and :func:`rollout_chunked`: each
    ``(t0, n)`` span runs as one program from the last one's state (in
    place when ``donate``; the first span's state is copied in, never
    written). After each chunk: ``durable_hook(t1, state, outputs)``, then
    the boundary save; a tap's heartbeats of each chunk are emitted while
    the next one runs, the last chunk's at the end. Returns (state — the
    program's carry when donating —, the chunks' outputs)."""
    read = None
    if getattr(step_fn, "tap_sink", None) is not None:
        from cbf_tpu_torch.obs.tap import chunk_heartbeats as read
    prev, parts, total, pending = None, [], 0.0, None
    for t0, n in spans:
        prog = _program(step_fn, state, n, unroll)
        if cost_model is not None:
            cost_model.compile_and_record(
                label, prog.prepare, (step_fn, state, t0),
                cache_key=(label, step_fn, n, unroll, donate,
                           _signature(state)))
        t_exec = time.perf_counter()
        if not (donate and prog is prev):
            prog.load(state)
        prog.run(step_fn, t0, during=pending)   # ends on the flag's read
        outs = prog.outputs(to_host)
        pending = None if read is None else read(step_fn, t0, outs)
        total += time.perf_counter() - t_exec
        if cost_model is not None and observe_each:
            cost_model.observe_execute(label, total)
            total = 0.0
        parts.append(outs)
        state = prog.carry if donate else _tree_map(torch.clone, prog.carry)
        prev = prog
        if durable_hook is not None:
            durable_hook(t0 + n, state, strip_extra(outs))
        if writer is not None:
            writer.save(t0 + n, state)
            if wait_snapshot:
                writer.wait_snapshot()
    if pending is not None:
        pending()
    if cost_model is not None and not observe_each and parts:
        cost_model.observe_execute(label, total)
    return state, parts


def _run_tapped(step_fn, state, spans, *, unroll, cost_model=None,
                label=None):
    """:func:`_run_chunks` for a tapped rollout on the programs' own
    carry, with no host wait at a chunk boundary: each chunk is queued
    before the one before it is settled, its relax flag and sampled rows
    copied to the host on the stream, so the card runs on while the host
    reads them. Heartbeats come from settled chunks only: where a chunk's
    flag is set it is redone eagerly, and the chunk queued after it runs
    again from the redone state. ``state`` is never written."""
    from cbf_tpu_torch.obs.tap import chunk_heartbeats as read

    def launch(prog, t0):
        ticket = prog.launch(step_fn, t0, host_flag=True)
        outs = prog.outputs(to_host=False)
        return ticket, outs, read(step_fn, t0, outs)

    t_exec = time.perf_counter()
    parts, prog, queued = [], None, None
    for t0, n in spans:
        nxt = _program(step_fn, state, n, unroll)
        if cost_model is not None:
            cost_model.compile_and_record(
                label, nxt.prepare, (step_fn, state, t0),
                cache_key=(label, step_fn, n, unroll, True,
                           _signature(state)))
        if nxt is not prog:
            nxt.load(state)
        ticket, outs, emit = launch(nxt, t0)
        parts.append(outs)
        if queued is not None:
            q_prog, q_ticket, q_emit = queued
            if q_prog.settle(step_fn, q_ticket):
                parts[-2] = q_prog.outputs(to_host=False)
                q_emit = read(step_fn, q_ticket[0], parts[-2])
                if nxt is not q_prog:
                    nxt.load(q_prog.carry)
                COUNTS["rerun_steps"] += n
                ticket, parts[-1], emit = launch(nxt, t0)
            q_emit()
        prog, state, queued = nxt, nxt.carry, (nxt, ticket, emit)
    if queued is not None:
        q_prog, q_ticket, q_emit = queued
        if q_prog.settle(step_fn, q_ticket):
            parts[-1] = q_prog.outputs(to_host=False)
            q_emit = read(step_fn, q_ticket[0], parts[-1])
        q_emit()
    if cost_model is not None and parts:
        cost_model.observe_execute(label, time.perf_counter() - t_exec)
    return state, parts


def rollout(step_fn: Callable, state0, steps: int, *, unroll: int = 1,
            telemetry=None, telemetry_every: int = 50,
            cost_model=None, cost_label: str | None = None):
    """Run ``steps`` iterations of ``step_fn`` as one compiled chunk
    (module docstring), ``unroll`` steps per captured body.

    ``telemetry``: a :class:`cbf_tpu_torch.obs.TelemetrySink`; the step is
    wrapped with the tap (cached on the sink) and the rollout runs as
    ``telemetry_every``-step chunks, each chunk's heartbeat emitted while
    the next one runs, so heartbeats arrive while the run goes on.
    ``cost_model``: a :class:`cbf_tpu_torch.obs.resource.CostModel`; each
    program is prepared and measured under ``cost_label`` (default
    ``rollout-s<steps>-u<unroll>``) before it runs, and the run's wall
    feeds ``observe_execute``. Neither changes a value.

    ``state0`` is never written. Returns (final_state, StepOutputs stacked
    over time, on the state's device; None for no steps)."""
    final, outs = rollout_extra(
        step_fn, state0, steps, unroll=unroll, telemetry=telemetry,
        telemetry_every=telemetry_every, cost_model=cost_model,
        cost_label=cost_label)
    return final, (None if outs is None else strip_extra(outs))


def rollout_extra(step_fn: Callable, state0, steps: int, *, unroll: int = 1,
                  telemetry=None, telemetry_every: int = 50,
                  cost_model=None, cost_label: str | None = None):
    """:func:`rollout` keeping the step wrappers' :class:`Extra` outputs
    (the checked rollout reads its flags there)."""
    if steps < 1:
        return state0, None
    label = cost_label or f"rollout-s{steps}-u{unroll}"
    if telemetry is not None:
        from cbf_tpu_torch.obs.tap import instrument_step

        step_fn = instrument_step(step_fn, telemetry, every=telemetry_every)
        state, parts = _run_tapped(
            step_fn, state0, plan_chunks(0, steps, telemetry_every),
            unroll=unroll, cost_model=cost_model, label=label)
    else:
        state, parts = _run_chunks(
            step_fn, state0, [(0, steps)], unroll=unroll, donate=True,
            to_host=False, cost_model=cost_model, label=label,
            observe_each=False)
    outs = parts[0] if len(parts) == 1 else _tree_map(
        lambda *xs: torch.cat(xs), *parts)
    if telemetry is not None:
        outs = outs.outputs             # the tap this call added
    return _tree_map(torch.clone, state), outs


def rollout_at(step_fn: Callable, state0, steps: int, t0: int, *,
               unroll: int = 1):
    """:func:`rollout`'s compiled chunk from global step ``t0`` — a
    resumed ensemble's clock (the JAX package scans ``t0 +
    arange(steps)`` there)."""
    if steps < 1:
        return state0, None
    prog = _program(step_fn, state0, steps, unroll)
    prog.load(state0)
    prog.run(step_fn, t0)
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

    ``checkpoint_dir``: the newest intact checkpoint there is restored
    first (unless ``resume=False``) and the run continues from its step;
    every chunk boundary is saved (:class:`cbf_tpu_torch.utils.checkpoint.
    CheckpointWriter`, its snapshot taken before the next chunk runs).
    Outputs cover only the steps run by this call.

    ``telemetry``/``telemetry_every``: as :func:`rollout`, each chunk's
    heartbeats emitted while the next runs, sampled on the global step, so
    a resumed run's land on the steps an uninterrupted one's would.

    ``donate_carry`` (None = donate exactly when no checkpoint writer
    runs, as in the JAX package): the program's static state buffers carry
    the state from chunk to chunk in place; False hands each chunk a fresh
    copy of the last one's state. An explicit True with a writer also
    waits for each boundary snapshot's copies before the next chunk. The
    caller's ``state0`` is never written either way.

    ``durable_hook``: called after every chunk as ``durable_hook(t1,
    state, outs_host)`` — before the boundary save, so a committed
    checkpoint at step t implies every output up to t is persisted
    (:mod:`cbf_tpu_torch.durable.rollout`).

    ``cost_model``/``cost_label``: as :func:`rollout`, each chunk size
    prepared once under ``cost_label`` (default
    ``rollout-c<chunk>-u<unroll>``) and every chunk's wall (run and host
    offload) observed.

    Returns (final_state, StepOutputs stacked over the executed steps as
    numpy arrays or None, start_step)."""
    from cbf_tpu_torch.utils import checkpoint as ckpt

    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if telemetry is not None:
        from cbf_tpu_torch.obs.tap import instrument_step

        step_fn = instrument_step(step_fn, telemetry, every=telemetry_every)
    state, start = state0, 0
    if checkpoint_dir and resume and \
            ckpt.latest_step(checkpoint_dir) is not None:
        state, start = ckpt.restore(checkpoint_dir, state0)
    writer = ckpt.CheckpointWriter(checkpoint_dir) if checkpoint_dir \
        else None
    donate = writer is None if donate_carry is None else bool(donate_carry)
    try:
        state, parts = _run_chunks(
            step_fn, state, plan_chunks(start, steps, chunk), unroll=unroll,
            donate=donate, to_host=True, writer=writer,
            wait_snapshot=donate, durable_hook=durable_hook,
            cost_model=cost_model,
            label=cost_label or f"rollout-c{chunk}-u{unroll}")
    finally:
        if writer is not None:
            writer.close()
    if not parts:
        return state, None, start
    if donate:
        state = _tree_map(torch.clone, state)
    return state, strip_extra(stack_host_chunks(parts)), start


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
