"""Program checks on the captured step (counterpart: cbf_tpu/analysis/
jaxpr_rules.py).

The JAX package asserts its invariants on the abstract jaxpr of each
public entry point. The port has no abstract trace: its compiled unit is
the rollout engine's program body (:meth:`cbf_tpu_torch.rollout.engine.
_Program.body`), which the card captures once as a CUDA graph and
replays. So the checks run one **eager** body — never inside a capture,
and never on a cached program a later run replays — under a
:class:`~torch.overrides.TorchFunctionMode`, which sees the Python-level
torch calls, and a :class:`~torch.utils._python_dispatch.TorchDispatchMode`,
which sees every ATen op the body issues, on the device it runs on:

* **JX001 — host traffic.** Anything that reads the card from the host
  or copies host data to it inside the body: ``torch.tensor``/
  ``as_tensor``/``asarray`` of host data, ``torch.from_numpy``, and the
  Tensor methods ``item``/``tolist``/``numpy``/``cpu``/``__bool__``/
  ``__float__``/``__int__``/``__index__`` (the function mode, the set the
  capture probe of ``tests/test_torch_rollout.py`` patches), plus
  ``aten._local_scalar_dense`` and any op that mixes a CPU tensor into
  CUDA work (the dispatch mode) — on the card a capture fails on these,
  or freezes the value read at capture time into every replay. A Python
  number that functorch wraps into a 0-dim CPU tensor for a scalar
  operand under vmap is a constant passed by value, not host traffic.
  :data:`APPROVED_HOST_CALLS` names what may: nothing, because the
  port's telemetry tap adds its values to the step's outputs and reads
  them between chunks (``obs/tap.py``), never inside the body.
* **JX002 — float64 drift.** An op that gives a float64 tensor from
  float32 (or narrower) float inputs and no float64 input: the entry
  points' paths are float32. :data:`APPROVED_F64` names the functions
  that may, with why.
* **JX003 — carry drift.** The carry the step hands back must have the
  shapes, dtypes and devices it took: the program's static buffers hold
  exactly those (``copy_`` into them would cast silently).

Kernel launches go through ctypes (``ops/knn.py``), below the dispatcher:
the modes see the wrappers' allocations and copies, not the launches.

:func:`trace_and_check` is the reusable core (the tests aim it at the
``utils/faults.py`` injectors); :func:`entrypoint_specs` lists the seven
entry points of the JAX package's checker, at its sizes (n=8), each as
the body the port captures; :func:`run_entrypoint_checks` runs them.
"""

from __future__ import annotations

import collections
import os
import sys
import weakref
from typing import Callable, Iterable

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from cbf_tpu_torch.analysis.registry import Finding

#: Host calls allowed inside a captured body: none (module docstring).
APPROVED_HOST_CALLS: tuple = ()

#: (file suffix, function) -> why it may take float32 inputs to float64.
APPROVED_F64 = {
    ("cbf_tpu_torch/ops/knn.py", "_sqrt_rn"):
        "the plain k-NN versions' correctly rounded float32 sqrt, taken in "
        "float64 and rounded once: PyTorch's vectorised CPU float32 sqrt "
        "is not correctly rounded, and the kernels' __fsqrt_rn is (the "
        "plain versions serve CPU tensors only; the kernel path on the "
        "card has no float64 op)",
}

_HOST_METHODS = frozenset({"item", "tolist", "numpy", "cpu", "__bool__",
                           "__float__", "__int__", "__index__"})
_HOST_DATA_FUNCS = {torch.tensor: "torch.tensor",
                    torch.as_tensor: "torch.as_tensor",
                    torch.asarray: "torch.asarray"}
_NARROW_FLOATS = (torch.float32, torch.float16, torch.bfloat16)


def _tensors(tree) -> list:
    out = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for e in v:
                walk(e)
        elif isinstance(v, dict):
            for e in v.values():
                walk(e)

    walk(tree)
    return out


_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_STDLIB_DIR = os.path.dirname(os.path.abspath(os.__file__))
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _site() -> str:
    """Where the body made the call: the innermost frame outside torch,
    the standard library and this module, as ``path:line (function)``."""
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if not (path.startswith((_TORCH_DIR, _STDLIB_DIR))
                or path == os.path.abspath(__file__)):
            rel = (os.path.relpath(path, _REPO)
                   if path.startswith(_REPO + os.sep) else path)
            return (f"{rel.replace(os.sep, '/')}:{frame.f_lineno} "
                    f"({frame.f_code.co_qualname})")
        frame = frame.f_back
    return "<unknown>"


def _approved_f64_frame() -> str | None:
    """The APPROVED_F64 function on the Python stack, if any."""
    frame = sys._getframe(2)
    while frame is not None:
        code = frame.f_code
        fname = code.co_filename.replace(os.sep, "/")
        for (suffix, name) in APPROVED_F64:
            if code.co_name == name and fname.endswith(suffix):
                return f"{suffix}:{name}"
        frame = frame.f_back
    return None


class _HostCalls(TorchFunctionMode):
    """The Python-level host traffic of the body."""

    def __init__(self, hits: list):
        super().__init__()
        self.hits = hits              # (what, site)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", None)
        if func in _HOST_DATA_FUNCS:
            data = args[0] if args else kwargs.get("data")
            if not isinstance(data, torch.Tensor):
                self.hits.append((f"{_HOST_DATA_FUNCS[func]}() of host "
                                  "data", _site()))
        elif func is torch.ops.aten.lift_fresh.default:
            self.hits.append(("torch.from_numpy() (host data lifted into "
                              "a tensor)", _site()))
        elif name in _HOST_METHODS and args and \
                isinstance(args[0], torch.Tensor):
            self.hits.append((f"Tensor.{name}()", _site()))
        return func(*args, **kwargs)


class _OpAudit(TorchDispatchMode):
    """The ATen ops of the body: devices, host reads, mixed-device ops
    and float64 promotions."""

    def __init__(self, hits: list):
        super().__init__()
        self.hits = hits              # (what, site)
        self.ops = 0
        self.bookkeeping = 0          # ops with no tensor (profiler spans)
        self.f64_ops = 0              # ops touching a float64 tensor
        # Python numbers wrapped into 0-dim CPU tensors (functorch does so
        # for a scalar operand under vmap): constants passed by value.
        self.scalars: dict[int, weakref.ref] = {}
        self.wrapped = 0
        self.devices: collections.Counter = collections.Counter()
        self.f64: list[tuple[str, str]] = []
        self.f64_allowed: collections.Counter = collections.Counter()

    def _scalar(self, t) -> bool:
        ref = self.scalars.get(id(t))
        return ref is not None and ref() is t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.ops.aten._to_copy.default and args and \
                not isinstance(args[0], torch.Tensor):
            for t in _tensors(out):
                self.scalars[id(t)] = weakref.ref(t)
            self.wrapped += 1
            return out
        ins = [t for t in _tensors((args, kwargs)) if not self._scalar(t)]
        outs = _tensors(out)
        if not (ins or outs):
            self.bookkeeping += 1
            return out
        self.ops += 1
        self.devices.update({t.device.type for t in outs or ins})
        self.f64_ops += any(t.dtype == torch.float64 for t in ins + outs)
        name = str(func)
        if func is torch.ops.aten._local_scalar_dense.default:
            self.hits.append((f"{name} (a device value read on the host)",
                              _site()))
        kinds = {t.device.type for t in ins + outs}
        if "cuda" in kinds and "cpu" in kinds:
            self.hits.append((f"{name} mixes CPU and CUDA tensors (a "
                              "host-to-device copy, or a CPU value frozen "
                              "into the launch)", _site()))
        if any(t.dtype == torch.float64 for t in outs):
            floats = [t.dtype for t in ins if t.is_floating_point()]
            if floats and torch.float64 not in floats and \
                    any(d in _NARROW_FLOATS for d in floats):
                where = _approved_f64_frame()
                if where is None:
                    self.f64.append((name, _site()))
                else:
                    self.f64_allowed[where] += 1
        return out


def _signature(tree) -> list[tuple[str, tuple, str, str]]:
    return [(f"carry[{i}]", tuple(t.shape), str(t.dtype), t.device.type)
            for i, t in enumerate(_tensors(tree))]


def _carry_findings(sig_in, sig_out, entry: str) -> list[Finding]:
    findings = []
    if len(sig_in) != len(sig_out):
        findings.append(Finding(
            "JX003", entry, 0, 0, entry,
            f"carry has {len(sig_in)} tensor leaves in and {len(sig_out)} "
            "out: the program's static buffers cannot hold it"))
    for (name, si, di, vi), (_, so, do, vo) in zip(sig_in, sig_out):
        if (si, di, vi) != (so, do, vo):
            findings.append(Finding(
                "JX003", entry, 0, 0, entry,
                f"carried leaf {name!r} drifts {di}{list(si)} on {vi} -> "
                f"{do}{list(so)} on {vo}: the program's static buffer "
                "cannot hold it"))
    return findings


def check_carry_stability(carry_in, carry_out, *, entry: str = "<entry>"
                          ) -> list[Finding]:
    """JX003: the carry comes back with the shapes, dtypes and devices it
    went in with (leaf by leaf, in tree order)."""
    return _carry_findings(_signature(carry_in), _signature(carry_out),
                           entry)


def trace_and_check(fn: Callable, args: tuple, *, entry: str,
                    carry_argnum: int | None = None,
                    carry_out: Callable | None = None,
                    stats: dict | None = None) -> list[Finding]:
    """Run ``fn(*args)`` once, eagerly, under the function and dispatch
    modes, and return its JX001/JX002 findings (+ JX003 when
    ``carry_argnum``/``carry_out`` name the carried state:
    ``carry_out(outputs)`` against ``args[carry_argnum]``).

    ``fn`` must not capture: a CUDA graph records no Python, so the modes
    would see nothing, and a mode active during a capture changes what is
    captured. ``stats``, when given, receives the op count, the devices
    of the ops' tensors (``{"cuda": n, ...}``), the host calls seen, the
    ops that touch a float64 tensor, the approved float64 promotions and
    the Python numbers wrapped into scalar tensors.
    Host traffic is reported once per call site."""
    carry_in = None if carry_argnum is None else _signature(
        args[carry_argnum])
    hits: list[tuple[str, str]] = []
    host_calls, ops = _HostCalls(hits), _OpAudit(hits)
    with host_calls, ops:
        out = fn(*args)
    findings = []
    by_site: dict[str, list[str]] = {}
    for what, site in hits:
        if not any(a in site for a in APPROVED_HOST_CALLS):
            by_site.setdefault(site, [])
            if what not in by_site[site]:
                by_site[site].append(what)
    for site, whats in by_site.items():
        findings.append(Finding(
            "JX001", entry, 0, 0, entry,
            f"host traffic inside the captured body at {site}: "
            + ", ".join(whats)))
    for name, site in dict.fromkeys(ops.f64):
        findings.append(Finding(
            "JX002", entry, 0, 0, entry,
            f"float64 from float32 inputs on the float32 path at {site}: "
            f"{name}"))
    if carry_in is not None and carry_out is not None:
        sig_out = _signature(carry_out(out))
        findings.extend(_carry_findings(carry_in, sig_out, entry))
    if stats is not None:
        stats.update(ops=ops.ops, bookkeeping_ops=ops.bookkeeping,
                     devices=dict(ops.devices), host_calls=hits,
                     f64_ops=ops.f64_ops, f64_allowed=dict(ops.f64_allowed),
                     wrapped_scalars=ops.wrapped)
    return findings


# -- the captured body of an entry point -----------------------------------

def body_call(step_fn: Callable, state):
    """``(run, carry)`` for one body of a FRESH program of ``step_fn``
    from ``state`` — the body the engine captures, never a cached program
    a later run replays. The program is loaded, started at t=0 and its
    first step run outside the audit (the warm-up a capture is preceded
    by: it builds the kernels' library, plans and cached constants);
    ``run(carry)`` then runs the next step as one body and returns the
    carry the step handed back (before the program copies it into its
    buffers, which would cast it silently). Audit it with
    ``trace_and_check(run, (carry,), carry_argnum=0,
    carry_out=lambda c: c)``."""
    from cbf_tpu_torch.rollout import engine

    prog = engine._Program(step_fn, state, 2, 1,
                           int(getattr(step_fn, "relax_rounds", 0)),
                           getattr(step_fn, "admm_blocks", None))
    prog.load(state)
    prog.start(0)
    prog.body(step_fn, 1)
    returned = []

    def probe(s, t, inputs=None):
        out = (step_fn(s, t) if inputs is None
               else step_fn(s, t, inputs=inputs))
        returned.append(out[0])
        return out

    def run(_carry):
        prog.body(probe, 1)
        return returned[-1]

    return run, prog.carry


def check_body(step_fn: Callable, state, *, entry: str,
               stats: dict | None = None) -> list[Finding]:
    """JX001-JX003 over one captured body of ``step_fn`` (:func:`body_call`)."""
    run, carry = body_call(step_fn, state)
    return trace_and_check(run, (carry,), entry=entry, carry_argnum=0,
                           carry_out=lambda c: c,
                           stats=stats)


# -- production entry points -----------------------------------------------

def _rollout_entry(entry: str, device, **fields) -> Callable:
    def thunk(stats=None) -> list[Finding]:
        from cbf_tpu_torch.scenarios import swarm

        cfg = swarm.Config(**fields)
        state0, step = swarm.make(cfg, device=device)
        return check_body(step, state0, entry=entry, stats=stats)
    return thunk


def entrypoint_specs(device=None) -> dict[str, Callable[..., list]]:
    """The checked production surface, one thunk per entry point of the
    JAX package's checker, each the body the port captures for it, at its
    sizes (n=8). ``device``: None for the card, or ``"cpu"``. Each thunk
    takes an optional ``stats`` dict (:func:`trace_and_check`)."""
    base = dict(n=8, steps=4, k_neighbors=4)

    def _rollout_telemetry(stats=None) -> list[Finding]:
        """The tapped step: its non-finite count is computed inside the
        body and read between chunks, so the body has no host call."""
        import tempfile

        from cbf_tpu_torch import obs
        from cbf_tpu_torch.scenarios import swarm

        state0, step = swarm.make(swarm.Config(**base), device=device)
        with tempfile.TemporaryDirectory() as d:
            sink = obs.TelemetrySink(d)
            try:
                tapped = obs.instrument_step(step, sink, every=2)
                return check_body(tapped, state0,
                                  entry="rollout[swarm+telemetry]",
                                  stats=stats)
            finally:
                sink.close()

    def _certificate_batched(stats=None) -> list[Finding]:
        """The lockstep certificate as the ensemble's body runs it: inside
        the body's relax guard with the whole ADMM budget (blocks None)."""
        from cbf_tpu_torch.scenarios import swarm
        from cbf_tpu_torch.sim.certificates import certificate_solver_seed
        from cbf_tpu_torch.solvers import exact2d

        cfg = swarm.Config(n=8, certificate=True,
                           certificate_backend="sparse",
                           certificate_warm_start=True,
                           certificate_iters=4, certificate_cg_iters=2)
        dev = swarm.resolve_device(device)
        E = 2
        seed = certificate_solver_seed(cfg.n, cfg.certificate_k, cfg.dtype,
                                       device=dev)
        carry0 = tuple(torch.stack([a] * E) for a in seed)
        x = swarm.initial_state(cfg, device=dev).x
        xx = torch.stack([x, 1.01 * x])
        uu = torch.zeros_like(xx)
        flag = torch.zeros((), dtype=torch.bool, device=dev)

        def body(u, xs, ss):
            with exact2d.guarded_relax(0, flag, None):
                return swarm.apply_certificate_batched(cfg, u, xs,
                                                       solver_state=ss)

        body(uu, xx, carry0)              # the warm-up
        return trace_and_check(body, (uu, xx, carry0),
                               entry="apply_certificate_batched",
                               carry_argnum=2, carry_out=lambda out: out[4],
                               stats=stats)

    def _sharded_rollout(stats=None) -> list[Finding]:
        """The ensemble's step program on the (1, 1) mesh in one process
        (built uncached: the audit never touches a program a later run
        replays)."""
        from cbf_tpu_torch.parallel import ensemble
        from cbf_tpu_torch.parallel.mesh import make_mesh
        from cbf_tpu_torch.scenarios import swarm

        cfg = swarm.Config(n=8, steps=3, k_neighbors=4)
        mesh = make_mesh(devices=device)
        cbf = swarm.default_cbf(cfg, device=mesh.device)
        step = ensemble._build_executable(cfg, mesh, 1, cbf)
        carry = ensemble._initial_carry(cfg, mesh, (0,))
        return check_body(step, carry, entry="sharded_swarm_rollout",
                          stats=stats)

    def _lockstep_chunk(stats=None) -> list[Finding]:
        """The continuous-batching chunk program: the vmapped traced step
        over B lanes, the lanes' inputs carried through the body."""
        from cbf_tpu_torch.parallel import ensemble
        from cbf_tpu_torch.scenarios import swarm

        cfg = swarm.Config(**base)
        static_cfg, traced0 = swarm.split_static_traced(cfg)
        dev = swarm.resolve_device(device)
        B = 2
        state0 = swarm.initial_state(static_cfg, device=dev)
        states = _stack_members(state0, B)
        traced = {k: torch.full((B,), float(v), dtype=cfg.dtype,
                                device=dev)
                  for k, v in traced0.items() if k != "n_active"}
        traced["n_active"] = torch.full((B,), cfg.n, dtype=torch.int32,
                                        device=dev)
        lanes = ensemble._lanes(states, traced,
                                torch.full((B,), 4, dtype=torch.int32),
                                torch.zeros((B,), dtype=torch.int32))
        program = ensemble._traced_program(static_cfg, None, dev)
        return check_body(program, (states, lanes),
                          entry="lockstep_traced_chunk", stats=stats)

    return {
        "rollout": _rollout_entry("rollout[swarm]", device, **base),
        "rollout_certificate_fused": _rollout_entry(
            "rollout[swarm+certificate_fused]", device, **base,
            certificate=True, certificate_backend="sparse",
            certificate_fused=True, certificate_warm_start=True,
            certificate_iters=4, certificate_cg_iters=2),
        "rollout_telemetry": _rollout_telemetry,
        "rollout_mixed": _rollout_entry(
            "rollout[swarm+mixed]", device, **base, dynamics="mixed",
            n_double=4),
        "certificate_batched": _certificate_batched,
        "sharded_rollout": _sharded_rollout,
        "lockstep_chunk": _lockstep_chunk,
    }


def _stack_members(state, B: int):
    """``state``'s tensor leaves stacked B times on a new leading axis."""
    from cbf_tpu_torch.rollout import engine

    return engine._tree_map(lambda a: torch.stack([a] * B), state)


def run_entrypoint_checks(only: Iterable[str] | None = None, *,
                          device=None) -> list[Finding]:
    """Run every production entry point's body under the audit and
    collect JX findings. An entry point that CRASHES is reported as a
    JX001 finding rather than an analyser exception: a body that does not
    run cannot be certified free of host traffic either."""
    specs = entrypoint_specs(device)
    names = list(only) if only is not None else list(specs)
    findings: list[Finding] = []
    for name in names:
        try:
            findings.extend(specs[name]())
        except Exception as e:                 # noqa: BLE001
            findings.append(Finding(
                "JX001", f"entrypoint:{name}", 0, 0, name,
                f"entry point's body failed to run under the audit: "
                f"{type(e).__name__}: {e}"))
    return findings
