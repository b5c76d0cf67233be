"""AST capture-safety linter (counterpart: cbf_tpu/analysis/ast_rules.py):
find host reads, host-to-device copies and program-cache hazards in code
that a CUDA graph captures, without importing or executing it.

The port's compiled unit is the rollout engine's program body
(:meth:`cbf_tpu_torch.rollout.engine._Program.body`): on the card it is
captured once and replayed, so anything in it that reads the card from the
host, copies host data to the card, or happens only while Python runs
(``print``, the host clock) either breaks the capture or is frozen into
every replay. The analyser works per module in two passes, as the JAX
package's does:

1. **Scope inference** — decide which functions are *captured scope*. A
   function is captured if any of:

   * it is a step a builder returns: a nested def whose parameters hold a
     state (``state``/``states``/``carry``) before a step clock ``t``, and
     whose enclosing function names it in a ``return`` (``swarm.
     _build_step``'s ``step``, ``_step_body``'s, ``make_step_traced``'s,
     the ensemble's programs, the ``utils/faults.py`` and ``obs/tap.py``
     wrappers);
   * it is passed (by name, or as an inline ``lambda``) to the engine —
     ``rollout``, ``rollout_chunked``, ``rollout_at``, ``eager_rollout``,
     ``_program`` — or to ``torch.func.vmap``/``grad`` (and their
     relatives) or ``torch.utils.checkpoint.checkpoint``, or decorated
     with one of those transforms;
   * it is defined inside a captured function.

   **Host scope** overrides it: the ``host_inputs(t0, n)`` hook (a def of
   that name, or what is assigned to an ``.host_inputs`` attribute) and
   ``obs/tap.py``'s ``chunk_heartbeats`` run between chunks, on the host —
   the counterpart of JAX's ``io_callback`` host scope — and a function
   under ``functools.lru_cache``/``cache`` is a cached constant, built on
   its first call (the engine's uncaptured warm-up) and looked up after.
   Captured-ness then propagates through same-module direct calls. Names
   resolve lexically: a nested def of an enclosing function, else a
   module-level one, and never one a local variable shadows.

   Inside a captured function the **eager branches** are host scope too:
   what runs only when the step is not inside the compiled body — the
   ``else`` of ``if exact2d.in_guarded_body():``, the body of ``if not
   ...in_guarded_body():``, the statements after an ``if
   ...in_guarded_body():`` block that returns, and the body of ``if
   ...takes_every_branch():`` (a vmapped member's eager pass). That is
   where the port's steps take a data-dependent branch on the host; the
   body takes its select form or its redo form
   (``exact2d.request_redo``).

2. **Rule checks** — inside captured scope, flag host reads and copies
   (TS001-TS008); module-wide, flag program-cache hazards (RC001-RC003).
   A value is *tensor-valued* ("arrayish") when it is built from
   ``torch.`` calls (``torch.where``, ``torch.linalg.norm``, ...; not
   ``torch.device``/``torch.func.vmap``/``torch.cuda.*`` and the like) or
   Tensor methods on such values, or from names assigned from such
   expressions. Branching on plain Python config (``if cfg.rta:``) or on
   metadata (``x.shape``, ``x.dim()``, ``x.dtype``) is never flagged. The
   inference is deliberately under-approximate: a miss is a finding the
   next reviewer can still catch, a false positive is a baseline entry
   forever.

Everything here is pure ``ast`` — no torch import, no code execution.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable

from cbf_tpu_torch.analysis.registry import Finding

# Transforms whose decorated function body runs inside the step.
CAPTURE_DECORATORS = frozenset({
    "torch.func.vmap", "torch.vmap", "torch.func.grad",
    "torch.func.grad_and_value", "torch.utils.checkpoint.checkpoint",
})

# Calls whose function-valued arguments become captured scope.
TRANSFORM_CALLS = frozenset({
    "torch.func.vmap", "torch.vmap", "torch.func.grad",
    "torch.func.grad_and_value", "torch.func.vjp", "torch.func.jvp",
    "torch.func.jacrev", "torch.func.jacfwd", "torch.func.hessian",
    "torch.utils.checkpoint.checkpoint",
})

# The rollout engine's entries: the step handed to them is the body a
# program captures (and the eager loop it is held to).
ENGINE_MODULES = ("cbf_tpu_torch.rollout.engine", "cbf_tpu_torch.rollout")
ENGINE_ENTRIES = ("rollout", "rollout_chunked", "rollout_at",
                  "eager_rollout", "_program")
ENGINE_CALLS = frozenset(f"{m}.{e}" for m in ENGINE_MODULES
                         for e in ENGINE_ENTRIES)
ROLLOUT_CALLS = frozenset(f"{m}.{e}" for m in ENGINE_MODULES
                          for e in ("rollout", "rollout_chunked",
                                    "rollout_at"))

# A step's parameters: a state before the step clock.
STATE_PARAMS = frozenset({"state", "states", "carry"})
CLOCK_PARAM = "t"

# Functions that run between chunks on the host (the io_callback host
# scope's counterpart).
HOST_SCOPE_NAMES = frozenset({"host_inputs", "chunk_heartbeats"})

# Tests that split a step into its compiled-body and eager forms
# (cbf_tpu_torch/solvers/exact2d.py).
GUARDED_BODY_TEST = "in_guarded_body"
EAGER_PASS_TEST = "takes_every_branch"

# Step builders (RC002): each call makes a new step object, and the
# engine caches programs on the step.
STEP_BUILDERS = frozenset({
    "cbf_tpu_torch.scenarios.swarm.make",
    "cbf_tpu_torch.scenarios.swarm._build_step",
    "cbf_tpu_torch.scenarios.meet_at_center.make",
    "cbf_tpu_torch.scenarios.cross_and_rescue.make",
    "cbf_tpu_torch.scenarios.antipodal.make",
    "cbf_tpu_torch.obs.tap.instrument_step",
    "cbf_tpu_torch.obs.instrument_step",
}) | frozenset(f"cbf_tpu_torch.utils.faults.{w}" for w in (
    "nan_at_step", "inf_at_step", "corrupt_output_at_step", "stall_at_step",
    "teleport_at_step", "poison_agent_at_step", "residual_blowup_at_step",
    "teleport_clump_at_step", "leak_host_callback", "promote_f64"))

# Program caches (RC001): their arguments are the program's key.
CACHE_DECORATORS = frozenset({"functools.lru_cache", "functools.cache"})

# numpy constructors that materialize host arrays (TS003).
NP_MATERIALIZERS = frozenset({"numpy.asarray", "numpy.array"})
ARRAY_CONSTRUCTOR_SUFFIXES = frozenset({
    "array", "asarray", "zeros", "ones", "full", "arange", "linspace",
    "eye", "broadcast_to", "stack", "concatenate", "tensor", "as_tensor",
    "from_numpy",
})

# Host data onto the card (TS008, RC003).
HOST_TO_DEVICE = frozenset({"torch.tensor", "torch.as_tensor",
                            "torch.from_numpy", "torch.asarray"})
DEVICE_WAITS = frozenset({"torch.cuda.synchronize"})

HOST_CLOCK_CALLS = frozenset({
    "time.time", "time.perf_counter", "time.monotonic", "time.sleep",
    "time.process_time",
})

# ``torch.`` calls that return no tensor.
_TORCH_NON_TENSOR = frozenset({
    "device", "dtype", "finfo", "iinfo", "Size", "Generator", "is_tensor",
    "is_floating_point", "is_complex", "get_default_dtype",
    "set_grad_enabled", "no_grad", "enable_grad", "inference_mode",
    "is_grad_enabled", "manual_seed", "get_num_threads",
    "set_num_threads", "numel", "typename", "result_type",
    "promote_types", "can_cast", "is_nonzero",
})
_TORCH_NON_TENSOR_MODULES = frozenset({
    "cuda", "backends", "func", "utils", "autograd", "distributed",
    "profiler", "overrides", "testing", "jit", "compiler", "_C", "nn",
    "multiprocessing", "library", "ops", "version", "hub", "onnx",
})
_TORCH_TENSOR_MODULES = ("torch.linalg.", "torch.special.", "torch.fft.",
                         "torch.nn.functional.")
# Tensor methods and attributes that return Python metadata.
_TENSOR_META = frozenset({
    "shape", "ndim", "dtype", "device", "layout", "is_cuda",
    "requires_grad", "_fields", "size", "dim", "numel", "element_size",
    "is_floating_point", "is_complex", "is_contiguous", "stride",
    "data_ptr", "get_device", "nelement", "ndimension", "storage_offset",
    "untyped_storage", "names", "grad_fn", "is_leaf",
})


def _is_transform(name: str | None) -> bool:
    return name in TRANSFORM_CALLS or name in ENGINE_CALLS


class _Func:
    """One function-like scope (def or lambda) with lint bookkeeping."""

    __slots__ = ("node", "qualname", "parent", "params", "traced", "host",
                 "cached", "program_rooted")

    def __init__(self, node, qualname: str, parent: "_Func | None"):
        self.node = node
        self.qualname = qualname
        self.parent = parent
        args = node.args
        names = [a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)]
        if args.vararg:
            names.append(args.vararg.arg)
        if args.kwarg:
            names.append(args.kwarg.arg)
        self.params = set(names)
        self.traced = False         # captured scope (JAX: traced)
        self.host = False
        self.cached = False         # host scope of its own body only
        self.program_rooted = False   # RC003: handed to the engine


def _is_step_signature(node) -> bool:
    """A state parameter before the step clock ``t``."""
    args = node.args
    names = [a.arg for a in (args.posonlyargs + args.args)]
    if CLOCK_PARAM not in names:
        return False
    return any(n in STATE_PARAMS for n in names[:names.index(CLOCK_PARAM)])


class ModuleLinter:
    """Lint one module's source: ``ModuleLinter(src, path).findings()``."""

    def __init__(self, source: str, path: str):
        self.path = path
        self.tree = ast.parse(source, filename=path)
        self.aliases = _import_aliases(self.tree)
        self.funcs: list[_Func] = []
        self._by_node: dict[ast.AST, _Func] = {}
        self._by_name: dict[str, list[_Func]] = {}
        self._collect(self.tree, parent=None, prefix="")
        self._scope_of: dict[ast.AST, _Func | None] = {}
        self._index_scopes(self.tree, None)
        self._bound_cache: dict[_Func, set[str]] = {}
        self._infer_scopes()

    # -- name normalization ----------------------------------------------

    def _dotted(self, node) -> str | None:
        """Normalized dotted path of an expression ("nn.functional.relu"
        after ``import torch.nn as nn`` -> "torch.nn.functional.relu"),
        or None for non-name expressions."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    def _call_target(self, call: ast.Call) -> str | None:
        name = self._dotted(call.func)
        if name == "functools.partial" and call.args:
            # functools.partial(torch.func.vmap, ...) IS the transform.
            return self._dotted(call.args[0])
        return name

    # -- pass 1: collect + scope inference -------------------------------

    def _collect(self, node, parent, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                fn = _Func(child, qn, parent)
                self.funcs.append(fn)
                self._by_node[child] = fn
                self._by_name.setdefault(child.name, []).append(fn)
                self._collect(child, fn, qn + ".")
            elif isinstance(child, ast.Lambda):
                qn = f"{prefix}<lambda L{child.lineno}>"
                fn = _Func(child, qn, parent)
                self.funcs.append(fn)
                self._by_node[child] = fn
                self._collect(child, fn, qn + ".")
            else:
                self._collect(child, parent, prefix)

    def _index_scopes(self, node, scope):
        """The enclosing function of every call and assignment."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Call, ast.Assign)):
                self._scope_of[child] = scope
            inner = self._by_node.get(child, scope)
            self._index_scopes(child, inner)

    def _bound(self, fn: _Func) -> set[str]:
        """Names ``fn`` binds other than by a nested def: its parameters
        and assignment targets."""
        if fn not in self._bound_cache:
            bound = set(fn.params)
            for n in self._own_nodes(fn, ast.Name):
                if isinstance(n.ctx, ast.Store):
                    bound.add(n.id)
            self._bound_cache[fn] = bound
        return self._bound_cache[fn]

    def _resolve_func_arg(self, node, scope=None) -> "_Func | None":
        """The function a lambda is, or that a name refers to from
        ``scope`` (lexically: a nested def of an enclosing function, else
        a module-level def; None where a local variable shadows it)."""
        if isinstance(node, ast.Lambda):
            return self._by_node.get(node)
        if not isinstance(node, ast.Name):
            return None
        cands = self._by_name.get(node.id, ())
        while scope is not None:
            inner = [c for c in cands if c.parent is scope]
            if inner:
                return inner[-1]
            if node.id in self._bound(scope):
                return None
            scope = scope.parent
        top = [c for c in cands if c.parent is None]
        return top[-1] if top else None

    def _is_cached(self, fn: _Func) -> bool:
        """Decorated with a cache: a constant the step builds on its first
        call (the engine's uncaptured warm-up) and looks up after."""
        for dec in getattr(fn.node, "decorator_list", ()):
            name = (self._dotted(dec.func) if isinstance(dec, ast.Call)
                    else self._dotted(dec))
            if name in CACHE_DECORATORS:
                return True
        return False

    def _returned_names(self, fn: _Func) -> set[str]:
        names: set[str] = set()
        for ret in self._own_nodes(fn, ast.Return):
            if ret.value is not None:
                names.update(n.id for n in ast.walk(ret.value)
                             if isinstance(n, ast.Name))
        return names

    def _infer_scopes(self):
        # Decorator roots.
        for fn in self.funcs:
            for dec in getattr(fn.node, "decorator_list", ()):
                name = (self._call_target(dec) if isinstance(dec, ast.Call)
                        else self._dotted(dec))
                if name in CAPTURE_DECORATORS:
                    fn.traced = True
        # Builder roots: a step the enclosing function returns.
        for fn in self.funcs:
            if fn.parent is None or isinstance(fn.node, ast.Lambda):
                continue
            if _is_step_signature(fn.node) and \
                    fn.node.name in self._returned_names(fn.parent):
                fn.traced = True
        # Call-site roots + host hooks, anywhere in the module.
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            t.attr in HOST_SCOPE_NAMES:
                        tgt = self._resolve_func_arg(node.value,
                                                     self._scope_of[node])
                        if tgt is not None:
                            tgt.host = True
                continue
            if not isinstance(node, ast.Call):
                continue
            name = self._call_target(node)
            if _is_transform(name):
                for arg in list(node.args) + [k.value for k in
                                              node.keywords]:
                    tgt = self._resolve_func_arg(arg, self._scope_of[node])
                    if tgt is not None:
                        tgt.traced = True
                        if name in ENGINE_CALLS:
                            tgt.program_rooted = True
        for fn in self.funcs:
            fn.cached = self._is_cached(fn)
            if getattr(fn.node, "name", None) in HOST_SCOPE_NAMES or \
                    fn.cached:
                fn.host = True
        # Nested defs of captured functions run inside the step; nested
        # defs of host hooks run on the host (a cached function's run where
        # they are called from: the steps it builds are roots of their
        # own). Then propagate captured-ness through same-module direct
        # calls to a fixpoint.
        changed = True
        while changed:
            changed = False
            for fn in self.funcs:
                parent = fn.parent
                if parent is not None:
                    if parent.host and not parent.cached and not fn.host:
                        fn.host = True
                        changed = True
                    if parent.traced and not parent.host and \
                            not fn.traced and not fn.host:
                        fn.traced = True
                        changed = True
                if not fn.traced or fn.host:
                    continue
                eager = self._eager_nodes(fn)
                for call in self._own_nodes(fn, ast.Call):
                    if call in eager:
                        continue
                    cand = self._resolve_func_arg(call.func, fn)
                    if cand is not None and not cand.traced \
                            and not cand.host:
                        cand.traced = True
                        changed = True

    def _own_nodes(self, fn: _Func, kind) -> Iterable:
        """Nodes lexically in ``fn``'s body, excluding nested function
        scopes (they are analyzed as their own scopes)."""
        body = (fn.node.body if isinstance(fn.node.body, list)
                else [fn.node.body])

        def walk(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                if isinstance(child, kind):
                    yield child
                yield from walk(child)

        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(stmt, kind):
                yield stmt
            yield from walk(stmt)

    # -- the eager branches of a step ------------------------------------

    def _guard_test(self, test) -> tuple[str, bool] | None:
        """("guarded"|"eager_pass", negated) for a test of the body/eager
        split, else None."""
        negated = False
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test, negated = test.operand, True
        if not isinstance(test, ast.Call) or test.args or test.keywords:
            return None
        name = self._dotted(test.func) or ""
        last = name.rsplit(".", 1)[-1]
        if last == GUARDED_BODY_TEST:
            return "guarded", negated
        if last == EAGER_PASS_TEST:
            return "eager_pass", negated
        return None

    def _eager_nodes(self, fn: _Func) -> set:
        """Every node of ``fn``'s own body that runs only outside the
        compiled body (module docstring)."""
        eager_stmts: list = []

        def terminates(stmts) -> bool:
            return bool(stmts) and isinstance(stmts[-1],
                                              (ast.Return, ast.Raise))

        def visit(stmts):
            for i, stmt in enumerate(stmts):
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(stmt, ast.If):
                    guard = self._guard_test(stmt.test)
                    if guard is not None:
                        kind, negated = guard
                        if kind == "eager_pass" and not negated:
                            eager_stmts.extend(stmt.body)
                            visit(stmt.orelse)
                            continue
                        if kind == "guarded":
                            body, other = ((stmt.orelse, stmt.body)
                                           if negated
                                           else (stmt.body, stmt.orelse))
                            eager_stmts.extend(other)
                            visit(body)
                            if terminates(body):
                                eager_stmts.extend(stmts[i + 1:])
                                return
                            continue
                for field in ("body", "orelse", "finalbody", "handlers"):
                    sub = getattr(stmt, field, None)
                    if isinstance(sub, list):
                        visit(sub)

        body = fn.node.body if isinstance(fn.node.body, list) else []
        visit(body)
        out: set = set()
        for stmt in eager_stmts:
            out.update(ast.walk(stmt))
        return out

    # -- tensor-valued dataflow ------------------------------------------

    def _torch_call_is_tensor(self, name: str) -> bool:
        if name.startswith(_TORCH_TENSOR_MODULES):
            return True
        parts = name.split(".")
        if len(parts) < 2:
            return False
        if parts[1] in _TORCH_NON_TENSOR_MODULES:
            return False
        return len(parts) == 2 and parts[1] not in _TORCH_NON_TENSOR

    def _arrayish_call(self, call: ast.Call, arrayish: set[str]) -> bool:
        name = self._dotted(call.func)
        if name is not None:
            if name.startswith("torch."):
                return self._torch_call_is_tensor(name)
            parts = name.split(".")
            if parts[0] in arrayish and len(parts) > 1:
                # method call on a tensor value: x.to(...), x.sum()
                return parts[-1] not in _TENSOR_META
        elif isinstance(call.func, ast.Attribute):
            if call.func.attr in _TENSOR_META:
                return False
            return self._arrayish(call.func.value, arrayish)
        return False

    def _arrayish(self, node, arrayish: set[str]) -> bool:
        if isinstance(node, ast.Name):
            return node.id in arrayish
        if isinstance(node, ast.Call):
            return self._arrayish_call(node, arrayish)
        if isinstance(node, ast.BinOp):
            return (self._arrayish(node.left, arrayish)
                    or self._arrayish(node.right, arrayish))
        if isinstance(node, ast.UnaryOp):
            return self._arrayish(node.operand, arrayish)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` are host-level identity checks
            # on the BINDING, not a host read of the tensor.
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return (self._arrayish(node.left, arrayish)
                    or any(self._arrayish(c, arrayish)
                           for c in node.comparators))
        if isinstance(node, ast.BoolOp):
            return any(self._arrayish(v, arrayish) for v in node.values)
        if isinstance(node, ast.Attribute):
            # Static metadata is Python-valued: .shape tuples, .ndim,
            # .dtype, .device — branching on them is the fixed-shape
            # idiom, not a host read.
            if node.attr in _TENSOR_META:
                return False
            return self._arrayish(node.value, arrayish)
        if isinstance(node, ast.Subscript):
            return self._arrayish(node.value, arrayish)
        if isinstance(node, ast.IfExp):
            return (self._arrayish(node.body, arrayish)
                    or self._arrayish(node.orelse, arrayish))
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self._arrayish(e, arrayish) for e in node.elts)
        return False

    def _arrayish_names(self, fn: _Func) -> set[str]:
        """Names bound (directly or transitively) to tensor results in
        ``fn``'s own body. Two passes so loop-carried rebinds settle."""
        arrayish: set[str] = set()
        for _ in range(2):
            for stmt in self._own_nodes(fn, (ast.Assign, ast.AugAssign,
                                             ast.AnnAssign)):
                value = stmt.value
                if value is None:
                    continue
                if not self._arrayish(value, arrayish):
                    continue
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Name):
                            arrayish.add(leaf.id)
        return arrayish

    # -- pass 2: rules ---------------------------------------------------

    def findings(self) -> list[Finding]:
        out: list[Finding] = []
        for fn in self.funcs:
            if fn.traced and not fn.host:
                out.extend(self._check_traced(fn))
        out.extend(self._check_recompile_hazards())
        out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return out

    def _find(self, rule, node, fn, message) -> Finding:
        sym = fn.qualname if fn is not None else "<module>"
        return Finding(rule, self.path, node.lineno, node.col_offset,
                       sym, message)

    def _check_traced(self, fn: _Func) -> list[Finding]:
        out = []
        arrayish = self._arrayish_names(fn)
        eager = self._eager_nodes(fn)
        for call in self._own_nodes(fn, ast.Call):
            if call in eager:
                continue
            name = self._dotted(call.func)
            if isinstance(call.func, ast.Attribute) and \
                    call.func.attr in ("item", "tolist", "cpu", "numpy"):
                out.append(self._find(
                    "TS001", call, fn,
                    f".{call.func.attr}() in captured scope reads the "
                    "card from the host"))
            if isinstance(call.func, ast.Name) and \
                    call.func.id in ("float", "int", "bool") and \
                    call.func.id not in self.aliases and call.args and \
                    self._arrayish(call.args[0], arrayish):
                out.append(self._find(
                    "TS002", call, fn,
                    f"{call.func.id}() reads a tensor on the host in "
                    "captured scope"))
            if name in NP_MATERIALIZERS and call.args and \
                    self._arrayish(call.args[0], arrayish):
                out.append(self._find(
                    "TS003", call, fn,
                    f"{name.split('.')[-1]}() copies a tensor to host "
                    "numpy inside captured scope"))
            if isinstance(call.func, ast.Name) and call.func.id == "print" \
                    and "print" not in self.aliases:
                out.append(self._find(
                    "TS006", call, fn,
                    "print() in captured scope runs at capture time, "
                    "never on a replay"))
            if name in HOST_CLOCK_CALLS:
                out.append(self._find(
                    "TS007", call, fn,
                    f"{name}() in captured scope is a capture-time "
                    "constant"))
            if name in HOST_TO_DEVICE and not (
                    call.args and self._arrayish(call.args[0], arrayish)):
                out.append(self._find(
                    "TS008", call, fn,
                    f"{name}() of host data in captured scope: a "
                    "host-to-device copy a capture refuses (build it once "
                    "outside the step)"))
            if name in DEVICE_WAITS:
                out.append(self._find(
                    "TS008", call, fn,
                    f"{name}() in captured scope: a device wait a "
                    "capture refuses"))
        for node in self._own_nodes(fn, ast.If):
            if node in eager:
                continue
            if self._arrayish(node.test, arrayish):
                out.append(self._find(
                    "TS004", node, fn,
                    "`if` branches on a tensor in captured scope; use "
                    "torch.where or exact2d.request_redo"))
        for node in self._own_nodes(fn, ast.While):
            if node in eager:
                continue
            if self._arrayish(node.test, arrayish):
                out.append(self._find(
                    "TS005", node, fn,
                    "`while` loops on a tensor in captured scope; use "
                    "fixed rounds under torch.where or "
                    "exact2d.request_redo"))
        return out

    # -- program-cache hazards -------------------------------------------

    def _check_recompile_hazards(self) -> list[Finding]:
        out = []
        # RC001: program caches (lru_cache'd builders) vs their keys.
        cached: dict[str, _Func] = {}
        for fn in self.funcs:
            for dec in getattr(fn.node, "decorator_list", ()):
                name = (self._dotted(dec.func) if isinstance(dec, ast.Call)
                        else self._dotted(dec))
                if name in CACHE_DECORATORS:
                    cached[fn.node.name] = fn
                    out.extend(self._check_cache_defaults(dec, fn))
        if cached:
            for call in ast.walk(self.tree):
                if isinstance(call, ast.Call):
                    out.extend(self._check_cache_keywords(call, cached))
        # RC002: a step built inside a loop that rolls it out.
        out.extend(self._check_build_in_loop(self.tree, None))
        # RC003: program steps closing over tensors made from host data.
        for fn in self.funcs:
            if fn.program_rooted and fn.parent is not None:
                out.extend(self._check_closure_arrays(fn))
        return out

    def _check_cache_defaults(self, dec, target: _Func) -> list[Finding]:
        out = []
        args_node = target.node.args
        params = [a.arg for a in (args_node.posonlyargs + args_node.args)]
        defaults = dict(zip(reversed(params), reversed(args_node.defaults)))
        defaults.update({a.arg: d for a, d in zip(args_node.kwonlyargs,
                                                  args_node.kw_defaults)
                         if d is not None})
        for pname, d in defaults.items():
            if isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(d, ast.Call) and
                    (self._dotted(d.func) or "").split(".")[-1]
                    in ARRAY_CONSTRUCTOR_SUFFIXES):
                out.append(self._find(
                    "RC001", dec, target.parent,
                    f"argument {pname!r} of the program cache "
                    f"{target.qualname}() defaults to an unhashable value "
                    "— every call with the default raises TypeError"))
        return out

    def _check_cache_keywords(self, call: ast.Call,
                              cached: dict[str, _Func]) -> list[Finding]:
        if isinstance(call.func, ast.Name) and call.func.id in cached:
            target = cached[call.func.id]
        elif self._dotted(call.func) == "functools.partial" and call.args \
                and isinstance(call.args[0], ast.Name) \
                and call.args[0].id in cached:
            target = cached[call.args[0].id]
        else:
            return []
        args_node = target.node.args
        if args_node.kwarg is not None:
            return []
        names = {a.arg for a in (args_node.args + args_node.kwonlyargs)}
        return [self._find(
            "RC001", call, self._scope_of.get(call),
            f"keyword {kw.arg!r} names no parameter of the program cache "
            f"{target.qualname}() (rename drift — every call raises "
            "TypeError)")
            for kw in call.keywords
            if kw.arg is not None and kw.arg not in names]

    def _loop_bound(self, loop) -> set[str]:
        bound: set[str] = set()
        if isinstance(loop, ast.For):
            bound.update(n.id for n in ast.walk(loop.target)
                         if isinstance(n, ast.Name))
        for node in ast.walk(loop):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    bound.update(n.id for n in ast.walk(t)
                                 if isinstance(n, ast.Name))
            elif isinstance(node, ast.For):
                bound.update(n.id for n in ast.walk(node.target)
                             if isinstance(n, ast.Name))
        return bound

    def _check_build_in_loop(self, node, fn) -> list[Finding]:
        out = []
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_build_in_loop(
                    child, self._by_node.get(child)))
                continue
            if isinstance(child, (ast.For, ast.While)):
                out.extend(self._check_loop(child, fn))
            out.extend(self._check_build_in_loop(child, fn))
        return out

    def _check_loop(self, loop, fn) -> list[Finding]:
        """A builder call in ``loop`` whose arguments the loop does not
        change, where the loop also rolls a step out: the same step built
        afresh each iteration, each one captured anew."""
        calls = [n for n in ast.walk(loop) if isinstance(n, ast.Call)]
        if not any(self._call_target(c) in ROLLOUT_CALLS for c in calls):
            return []
        bound = self._loop_bound(loop)
        out = []
        for call in calls:
            if self._call_target(call) not in STEP_BUILDERS:
                continue
            used = {n.id for n in ast.walk(call) if isinstance(n, ast.Name)}
            if used & bound:
                continue
            out.append(self._find(
                "RC002", call, fn,
                f"{self._call_target(call).rsplit('.', 1)[-1]}(...) builds "
                "the same step every iteration of a loop that rolls it "
                "out — each new step object captures a fresh program; "
                "build it once outside the loop"))
        return out

    def _check_closure_arrays(self, fn: _Func) -> list[Finding]:
        out = []
        bound = set(fn.params)
        for stmt in self._own_nodes(fn, (ast.Assign, ast.AugAssign,
                                         ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Name):
                        bound.add(leaf.id)
        for inner in self.funcs:
            if inner.parent is fn:
                bound.add(getattr(inner.node, "name", ""))
        free = set()
        for name in self._own_nodes(fn, ast.Name):
            if isinstance(name.ctx, ast.Load) and name.id not in bound:
                free.add(name.id)
        scope = fn.parent
        while scope is not None:
            for stmt in self._own_nodes(scope, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and t.id in free and \
                            isinstance(stmt.value, ast.Call) and \
                            self._dotted(stmt.value.func) in HOST_TO_DEVICE:
                        out.append(self._find(
                            "RC003", fn.node, fn,
                            f"captured step {fn.qualname}() closes over "
                            f"tensor {t.id!r} made from host data in "
                            f"{scope.qualname}() — baked into the "
                            "program; carry it through the step's inputs"))
            scope = scope.parent
        return out


def lint_source(source: str, path: str) -> list[Finding]:
    """Lint one module's source text. Raises SyntaxError on broken input."""
    return ModuleLinter(source, path).findings()


def lint_paths(paths: Iterable[str], repo_root: str | None = None
               ) -> list[Finding]:
    """Lint every ``.py`` file under ``paths`` (files or directories).

    Paths in findings are repo-root-relative when ``repo_root`` is given
    (the form the baseline stores), absolute/as-given otherwise.
    """
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git",
                                            "analysis_fixtures", "_build")]
                files.extend(os.path.join(dirpath, f)
                             for f in filenames if f.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    findings: list[Finding] = []
    for f in sorted(set(files)):
        rel = os.path.relpath(f, repo_root) if repo_root else f
        with open(f, encoding="utf-8") as fh:
            try:
                findings.extend(lint_source(fh.read(), rel))
            except SyntaxError as e:
                findings.append(Finding(
                    "TS001", rel, e.lineno or 0, 0, "<module>",
                    f"unparseable module: {e.msg}"))
    return findings


def _import_aliases(tree: ast.Module) -> dict[str, str]:
    """Map local names to canonical dotted module paths.

    ``import torch.nn.functional as F`` -> {"F": "torch.nn.functional"};
    ``from cbf_tpu_torch.rollout import engine`` ->
    {"engine": "cbf_tpu_torch.rollout.engine"}.
    """
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases
