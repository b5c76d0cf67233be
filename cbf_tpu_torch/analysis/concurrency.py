"""AST concurrency analyser (counterpart: cbf_tpu/analysis/concurrency.py):
lock discipline for the port's threaded serve/durable/obs/cluster stack,
checked without importing or executing it.

The threaded modules (``serve/engine.py``'s scheduler + condition and the
process-wide ``_PROGRAM_LOCK``, ``serve/ha.py``'s heartbeat,
``durable/journal.py``'s WAL, the cluster's router, worker and membership
threads, the obs watchdog/exporter/flight/trace/sink/resource/lanes
modules) share the JAX package's discipline: every cross-thread attribute
is guarded by a ``with self._lock:`` region, locks nest in one global
order, signal handlers touch nothing but an Event, and every started
thread has a join path. The analyser is the JAX package's, pure ``ast``
and conservatively under-approximate, with two changes: the device waits
of its blocking set are torch's (``torch.cuda.synchronize``,
``Event.synchronize``, ``Stream.synchronize``), and a module-level lock
held in a method (``with _PROGRAM_LOCK:``) is a lock like ``self._lock``,
named as its witness names it (the literal given to ``make_lock``, else
``<module>.<NAME>``) — the port serialises all serving device work on
one such lock, where the JAX package's classes hold only their own.

Per class the analyzer builds an inventory — locks/conditions/events
(``threading.*`` or the :mod:`~cbf_tpu_torch.analysis.lockwitness`
factories),
``Thread(target=self._m)`` entry points, ``signal.signal``/``atexit``
registrations — then infers *thread scopes* (which methods can run on
which thread: scheduler/watchdog/exporter entry reachability, signal
handlers, externally registered callbacks, plus the ambient "caller"
scope of every public method) and checks:

* **CC001** — shared mutable attribute written from >= 2 thread scopes
  (or >= 2 distinct methods of a threaded class) with no common lock
  held across the write sites.
* **CC002** — lock-order inversion: a cycle in the global acquisition-
  order graph (built across classes, through ``with`` regions,
  ``acquire()`` calls, same-class helper calls and attribute-typed
  cross-class calls).
* **CC003** — blocking call (``fsync``/``sleep``/``join``/device
  ``synchronize``/file ``open``/``write``/``flush``) inside a held-lock
  region.
* **CC004** — signal-handler body doing anything beyond ``Event.set``
  and constant flag writes (a handler that takes a
  lock can deadlock against the thread it interrupted).
* **CC005** — ``Condition.wait`` not wrapped in a predicate loop
  (spurious wakeup / missed-recheck).
* **CC006** — daemon thread doing file I/O with no join path: at
  interpreter teardown daemons are killed mid-write.
* **CC007** — lock acquired in ``__del__`` or an ``atexit`` path
  (finalizers run at unpredictable times, possibly mid-critical-section
  on the same lock).
* **CC008** — thread ``start()`` without a matching ``join``/``stop``
  contract anywhere in the class (or function, for local threads).

Held-region tracking is lexical (`with self._lock:` bodies and
``acquire()``/``release()`` straight-line spans) plus one sound
refinement: a private helper called *only* with some lock held inherits
that lock (the ``_scan_queue``-under-``self._lock`` idiom). The
acquisition-order graph and the per-class inventory are exported for
the runtime witness's subgraph assertion and the AUD008 concurrency-map
audit.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, NamedTuple

from cbf_tpu_torch.analysis.ast_rules import _import_aliases
from cbf_tpu_torch.analysis.registry import Finding

# Constructor dotted-names -> primitive kind.
_LOCK_CTORS = {"threading.Lock": "lock", "threading.RLock": "lock"}
_WITNESS_FACTORIES = {"make_lock": "lock", "make_condition": "condition",
                      "make_event": "event"}

# Dotted calls that block the calling thread.
_BLOCKING_DOTTED = {
    "os.fsync": "os.fsync", "os.replace": "os.replace",
    "time.sleep": "time.sleep", "subprocess.run": "subprocess.run",
    "subprocess.check_call": "subprocess.check_call",
    "subprocess.check_output": "subprocess.check_output",
    "shutil.copy": "shutil.copy", "shutil.move": "shutil.move",
    "torch.cuda.synchronize": "torch.cuda.synchronize",
}
# Attribute calls that block regardless of receiver (device waits:
# torch.cuda.Event.synchronize, torch.cuda.Stream.synchronize).
_BLOCKING_ATTRS = {"synchronize"}
# File-I/O blocking descs (the subset CC006 cares about).
_FILE_IO = {"open()", "os.fsync", "os.replace", ".write", ".flush"}

# Mutating method names on containers — a write for CC001 purposes.
_MUTATORS = {"append", "extend", "insert", "add", "discard", "remove",
             "pop", "popitem", "popleft", "appendleft", "clear",
             "update", "setdefault"}

_CALLER_DUNDERS = {"__enter__", "__exit__", "__call__"}


class Edge(NamedTuple):
    """One acquisition-order edge: ``dst`` acquired while ``src`` held."""
    src: str
    dst: str
    path: str
    line: int


class _ThreadRec(NamedTuple):
    entry: str           # entry-point method name ("" when unresolved)
    attr: str | None     # self attr holding the handle (None: not stored)
    daemon: bool
    line: int


class _Write(NamedTuple):
    attr: str
    method: str
    line: int
    held: frozenset


class _Acquire(NamedTuple):
    lock: str
    line: int
    held: frozenset


class _CallSite(NamedTuple):
    kind: str            # "self" | "cross"
    cls: str             # callee class name ("" for self)
    method: str
    line: int
    held: frozenset


class _Block(NamedTuple):
    desc: str
    line: int
    held: frozenset


class _Wait(NamedTuple):
    cond: str
    line: int
    in_loop: bool


class _MethodInfo:
    __slots__ = ("name", "node", "writes", "acquires", "calls", "blocks",
                 "waits", "calls_self", "inherited", "file_io", "attr_alias")

    def __init__(self, name: str, node: ast.FunctionDef):
        self.name = name
        self.node = node
        self.writes: list[_Write] = []
        self.acquires: list[_Acquire] = []
        self.calls: list[_CallSite] = []
        self.blocks: list[_Block] = []
        self.waits: list[_Wait] = []
        self.calls_self: set[str] = set()
        self.inherited: frozenset = frozenset()
        self.file_io = False
        self.attr_alias: dict[str, str] = {}   # local -> typed self attr


class _ClassInfo:
    __slots__ = ("name", "path", "node", "locks", "conditions", "events",
                 "threads", "file_attrs", "attr_ctors", "attr_types",
                 "methods", "minfo", "handlers", "joined", "started",
                 "inline_starts", "scopes", "callback_refs")

    def __init__(self, name: str, path: str, node: ast.ClassDef):
        self.name = name
        self.path = path
        self.node = node
        self.locks: dict[str, str] = {}
        self.conditions: dict[str, str | None] = {}   # attr -> aliased lock
        self.events: set[str] = set()
        self.threads: list[_ThreadRec] = []
        self.file_attrs: set[str] = set()
        self.attr_ctors: dict[str, str] = {}   # attr -> ctor class name
        self.attr_types: dict[str, "_ClassInfo"] = {}
        self.methods: dict[str, ast.FunctionDef] = {}
        self.minfo: dict[str, _MethodInfo] = {}
        self.handlers: list[tuple[str, ast.AST, str]] = []  # (qual, node, kind)
        self.joined: set[str] = set()          # thread attrs with join credit
        self.started: dict[str, int] = {}      # thread attr -> start line
        self.inline_starts: list[tuple[str, int]] = []  # (method, line)
        self.scopes: dict[str, set[str]] = {}
        self.callback_refs: set[str] = set()   # methods passed as callbacks

    @property
    def threaded(self) -> bool:
        return bool(self.locks or self.conditions or self.threads
                    or self.handlers)

    def lock_id(self, attr: str) -> str | None:
        """Canonical lock id for an attr; a condition aliases its lock."""
        if attr in self.locks:
            return f"{self.name}.{attr}"
        if attr in self.conditions:
            alias = self.conditions[attr]
            return f"{self.name}.{alias if alias else attr}"
        return None


class AnalysisResult(NamedTuple):
    findings: list[Finding]
    edges: list[Edge]
    inventory: dict


class _Analyzer:
    def __init__(self):
        self.modules: list[tuple[str, ast.Module, dict]] = []
        # path -> {module-level lock name -> lock id}
        self.module_locks: dict[str, dict[str, str]] = {}
        self.class_list: list[_ClassInfo] = []
        self.by_name: dict[str, _ClassInfo] = {}
        self.findings: list[Finding] = []
        self.edges: list[Edge] = []
        self._edge_keys: set[tuple[str, str]] = set()

    # -- loading ---------------------------------------------------------

    def add_module(self, source: str, path: str) -> None:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            return     # ast_rules already reports unparseable modules
        self.modules.append((path, tree, _import_aliases(tree)))

    # -- name helpers ----------------------------------------------------

    @staticmethod
    def _dotted(node, aliases) -> str | None:
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    @staticmethod
    def _self_attr(node) -> str | None:
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        return None

    # -- pass 1: inventory -----------------------------------------------

    def run(self) -> None:
        for path, tree, aliases in self.modules:
            self.module_locks[path] = self._module_lock_ids(
                path, tree, aliases)
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    cls = _ClassInfo(node.name, path, node)
                    self.class_list.append(cls)
                    # Ambiguous names resolve to the first definition;
                    # per-class analysis itself is keyed per (path, class).
                    self.by_name.setdefault(node.name, cls)
        for cls in self.class_list:
            self._inventory(cls, self._aliases_of(cls.path))
        # Resolve attr -> class types now every class is known.
        for cls in self.class_list:
            for attr, ctor in cls.attr_ctors.items():
                target = self.by_name.get(ctor)
                if target is not None and target is not cls:
                    cls.attr_types[attr] = target
        for cls in self.class_list:
            self._scopes(cls)
            for mname, mnode in cls.methods.items():
                self._scan_body(cls, mname, mnode)
        self._inherited_held()
        trans = self._transitive_acquires()
        self._collect_edges(trans)
        for cls in self.class_list:
            self._cc001(cls)
            self._cc003(cls)
            self._cc004(cls)
            self._cc005(cls)
            self._cc006(cls)
            self._cc007(cls)
            self._cc008(cls)
        self._cc002()
        self._module_functions()
        self.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    def _module_lock_ids(self, path: str, tree, aliases) -> dict[str, str]:
        """Module-level ``NAME = threading.Lock()`` / ``make_lock("id")``
        assignments: NAME -> the lock id."""
        out: dict[str, str] = {}
        stem = os.path.splitext(os.path.basename(path))[0]
        for node in tree.body:
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            kind = self._ctor_kind(node.value, aliases)
            if kind is None or kind[0] != "lock":
                continue
            first = node.value.args[0] if node.value.args else None
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = (first.value
                                 if isinstance(first, ast.Constant)
                                 and isinstance(first.value, str)
                                 else f"{stem}.{t.id}")
        return out

    def _ctor_kind(self, call: ast.Call, aliases) -> tuple[str, object] | None:
        """Classify a constructor call: ("lock"|"condition"|"event"|
        "thread"|"file"|"class", payload)."""
        if isinstance(call, ast.IfExp):
            # `x if x is not None else Ctor(...)`: the constructed type.
            return (self._ctor_kind(call.body, aliases)
                    or self._ctor_kind(call.orelse, aliases))
        if not isinstance(call, ast.Call):
            return None
        name = self._dotted(call.func, aliases)
        if name is None:
            return None
        last = name.split(".")[-1]
        if name in _LOCK_CTORS:
            return ("lock", None)
        if name == "threading.Condition":
            alias = self._self_attr(call.args[0]) if call.args else None
            return ("condition", alias)
        if name == "threading.Event":
            return ("event", None)
        if name == "threading.Thread":
            return ("thread", self._thread_info(call, aliases))
        if last in _WITNESS_FACTORIES:
            kind = _WITNESS_FACTORIES[last]
            if kind == "condition":
                alias = self._self_attr(call.args[1]) \
                    if len(call.args) > 1 else None
                for kw in call.keywords:
                    if kw.arg == "lock":
                        alias = self._self_attr(kw.value)
                return ("condition", alias)
            return (kind, None)
        if name == "open":
            return ("file", None)
        if last and last[0].isupper() and last in self.by_name:
            return ("class", last)
        return None

    def _thread_info(self, call: ast.Call, aliases) -> dict:
        entry, daemon = "", False
        for kw in call.keywords:
            if kw.arg == "target":
                attr = self._self_attr(kw.value)
                if attr is not None:
                    entry = attr
                elif isinstance(kw.value, ast.Name):
                    entry = kw.value.id
            elif kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
        return {"entry": entry, "daemon": daemon}

    def _inventory(self, cls: _ClassInfo, aliases) -> None:
        for child in cls.node.body:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls.methods[child.name] = child
        for mname, mnode in cls.methods.items():
            local_kinds: dict[str, tuple[str, object]] = {}
            local_thread_alias: dict[str, str] = {}   # local -> thread attr
            nested_defs = {n.name: n for n in ast.walk(mnode)
                           if isinstance(n, ast.FunctionDef) and n is not mnode}
            # Pass A: local `name = <ctor>` bindings. ast.walk is NOT
            # statement-ordered, so locals are collected exhaustively
            # before any use is resolved.
            for node in ast.walk(mnode):
                if isinstance(node, ast.Assign):
                    kind = self._ctor_kind(node.value, aliases)
                    if kind is not None:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                local_kinds[t.id] = kind
            # Pass B: attribute bindings + local<->attr aliases (both
            # `t = self._thread` for join credit and `self._thread = t`
            # so a later `t.start()` credits the attr).
            for node in ast.walk(mnode):
                if isinstance(node, ast.Assign):
                    kind = self._ctor_kind(node.value, aliases)
                    if kind is None and isinstance(node.value, ast.Name):
                        kind = local_kinds.get(node.value.id)
                    src_attr = self._self_attr(node.value)
                    for tgt in node.targets:
                        tgts = tgt.elts if isinstance(
                            tgt, (ast.Tuple, ast.List)) else [tgt]
                        for t in tgts:
                            attr = self._self_attr(t)
                            if attr is not None and kind is not None:
                                self._record_attr(cls, attr, kind,
                                                  node.lineno)
                                if isinstance(node.value, ast.Name) and \
                                        kind[0] == "thread":
                                    local_thread_alias[node.value.id] = attr
                            elif isinstance(t, ast.Name) and \
                                    src_attr is not None:
                                # alias: t = self._thread (join credit)
                                local_thread_alias[t.id] = src_attr
            # Pass C: starts/joins/handler registrations/callback refs.
            for node in ast.walk(mnode):
                if isinstance(node, ast.Call):
                    name = self._dotted(node.func, aliases)
                    # signal.signal(SIG, handler) / atexit.register(f)
                    if name == "signal.signal" and len(node.args) >= 2:
                        self._record_handler(cls, mname, node.args[1],
                                             nested_defs, "signal")
                    elif name == "atexit.register" and node.args:
                        self._record_handler(cls, mname, node.args[0],
                                             nested_defs, "atexit")
                    if isinstance(node.func, ast.Attribute):
                        recv = node.func.value
                        attr = node.func.attr
                        rattr = self._self_attr(recv)
                        if attr == "start":
                            if rattr is not None:
                                cls.started[rattr] = node.lineno
                            elif isinstance(recv, ast.Name) and \
                                    recv.id in local_thread_alias:
                                cls.started[local_thread_alias[recv.id]] = \
                                    node.lineno
                            elif isinstance(recv, ast.Name) and \
                                    local_kinds.get(recv.id, ("",))[0] \
                                    == "thread":
                                self._record_local_thread_start(
                                    cls, mname, recv.id, local_kinds,
                                    node.lineno, joined=self._local_joined(
                                        mnode, recv.id))
                            elif isinstance(recv, ast.Call) and \
                                    self._ctor_kind(recv, aliases) is not None \
                                    and self._ctor_kind(
                                        recv, aliases)[0] == "thread":
                                cls.inline_starts.append((mname, node.lineno))
                        elif attr == "join":
                            if rattr is not None:
                                cls.joined.add(rattr)
                            elif isinstance(recv, ast.Name) and \
                                    recv.id in local_thread_alias:
                                cls.joined.add(local_thread_alias[recv.id])
                # bare self._m reference (not a call target): callback
                if isinstance(node, ast.Call):
                    for arg in list(node.args) + \
                            [k.value for k in node.keywords]:
                        attr = self._self_attr(arg)
                        if attr is not None and attr in cls.methods:
                            cls.callback_refs.add(attr)

    def _local_joined(self, mnode, local: str) -> bool:
        for node in ast.walk(mnode):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "join" and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == local:
                return True
        return False

    def _record_local_thread_start(self, cls, mname, local, local_kinds,
                                   line, *, joined: bool) -> None:
        if not joined:
            cls.inline_starts.append((mname, line))

    def _record_attr(self, cls: _ClassInfo, attr: str,
                     kind: tuple[str, object], line: int) -> None:
        k, payload = kind
        if k == "lock":
            cls.locks[attr] = "lock"
        elif k == "condition":
            cls.conditions[attr] = payload
        elif k == "event":
            cls.events.add(attr)
        elif k == "thread":
            info = payload or {}
            cls.threads.append(_ThreadRec(info.get("entry", ""), attr,
                                          info.get("daemon", False), line))
        elif k == "file":
            cls.file_attrs.add(attr)
        elif k == "class":
            cls.attr_ctors[attr] = payload

    def _record_handler(self, cls, mname, hnode, nested_defs, kind) -> None:
        attr = self._self_attr(hnode)
        if attr is not None and attr in cls.methods:
            cls.handlers.append((f"{cls.name}.{attr}",
                                 cls.methods[attr], kind))
        elif isinstance(hnode, ast.Name) and hnode.id in nested_defs:
            cls.handlers.append((f"{cls.name}.{mname}.{hnode.id}",
                                 nested_defs[hnode.id], kind))

    # -- pass 2: thread scopes -------------------------------------------

    def _scopes(self, cls: _ClassInfo) -> None:
        calls_self: dict[str, set[str]] = {}
        for mname, mnode in cls.methods.items():
            calls = set()
            for node in ast.walk(mnode):
                if isinstance(node, ast.Call):
                    a = self._self_attr(node.func)
                    if a is not None and a in cls.methods:
                        calls.add(a)
            calls_self[mname] = calls
        thread_entries = {t.entry for t in cls.threads if t.entry}
        handler_methods = {q.split(".")[-1] for q, n, k in cls.handlers
                           if q.count(".") == 1}
        roots: list[tuple[str, str]] = []
        for entry in sorted(thread_entries):
            roots.append((entry, f"thread:{entry}"))
        for h in sorted(handler_methods):
            roots.append((h, "signal"))
        for m in sorted(cls.callback_refs):
            if m not in thread_entries and m not in handler_methods:
                roots.append((m, "callback"))
        for mname in cls.methods:
            if mname == "__init__":
                continue
            if not mname.startswith("_") or mname in _CALLER_DUNDERS:
                roots.append((mname, "caller"))
        scopes: dict[str, set[str]] = {m: set() for m in cls.methods}
        for root, label in roots:
            if root not in cls.methods:
                continue
            frontier = [root]
            seen = {root}
            while frontier:
                m = frontier.pop()
                scopes[m].add(label)
                for callee in calls_self.get(m, ()):
                    if callee not in seen and callee in cls.methods:
                        seen.add(callee)
                        frontier.append(callee)
        cls.scopes = scopes
        for mname in cls.methods:
            info = _MethodInfo(mname, cls.methods[mname])
            info.calls_self = calls_self.get(mname, set())
            cls.minfo[mname] = info

    # -- pass 3: held-region walk ----------------------------------------

    def _lock_of_expr(self, cls: _ClassInfo, node) -> str | None:
        attr = self._self_attr(node)
        if attr is not None:
            return cls.lock_id(attr)
        if isinstance(node, ast.Name):
            return self.module_locks.get(cls.path, {}).get(node.id)
        return None

    def _aliases_of(self, path: str) -> dict:
        for p, tree, aliases in self.modules:
            if p == path:
                return aliases
        return {}

    def _scan_body(self, cls: _ClassInfo, mname: str, mnode) -> None:
        info = cls.minfo[mname]
        aliases = self._aliases_of(cls.path)
        # `local = self.attr` of a typed attribute: calls on the local are
        # calls on the attribute's class.
        info.attr_alias = {
            t.id: self._self_attr(node.value)
            for node in ast.walk(mnode) if isinstance(node, ast.Assign)
            and self._self_attr(node.value) in cls.attr_types
            for t in node.targets if isinstance(t, ast.Name)}

        def blocking_desc(call: ast.Call) -> str | None:
            name = self._dotted(call.func, aliases)
            if name in _BLOCKING_DOTTED:
                return _BLOCKING_DOTTED[name]
            if isinstance(call.func, ast.Name) and call.func.id == "open" \
                    and "open" not in aliases:
                return "open()"
            if isinstance(call.func, ast.Attribute):
                attr = call.func.attr
                if attr in _BLOCKING_ATTRS:
                    return f".{attr}"
                recv = self._self_attr(call.func.value)
                if attr in ("write", "flush") and recv in cls.file_attrs:
                    return f".{attr}"
                if attr == "join" and recv is not None and (
                        recv in {t.attr for t in cls.threads} or
                        recv in cls.started):
                    return ".join"
                if attr == "wait" and recv in cls.events:
                    return "Event.wait"
            return None

        def visit(stmts, held: tuple, in_loop: bool):
            acquired_here: list[str] = []
            for stmt in stmts:
                h = held + tuple(acquired_here)
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    # A nested def runs with ITS caller's held set, not
                    # this method's; handlers get their own CC004 scan.
                    continue
                if isinstance(stmt, ast.With):
                    got = []
                    for item in stmt.items:
                        # `with a, b:` enters b with a held.
                        hi = h + tuple(got)
                        lid = self._lock_of_expr(cls, item.context_expr)
                        if lid is not None:
                            info.acquires.append(
                                _Acquire(lid, stmt.lineno, frozenset(hi)))
                            got.append(lid)
                        else:
                            # `with open(...) as f:` under a held lock is
                            # still a blocking call at entry.
                            self._scan_exprs(cls, info, item.context_expr,
                                             hi, in_loop, blocking_desc,
                                             aliases)
                    visit(stmt.body, h + tuple(got), in_loop)
                    continue
                if isinstance(stmt, (ast.While, ast.For)):
                    self._scan_exprs(cls, info, stmt, h, True,
                                     blocking_desc, aliases, top=True)
                    visit(stmt.body, h, True)
                    visit(stmt.orelse, h, in_loop)
                    continue
                if isinstance(stmt, ast.If):
                    self._scan_exprs(cls, info, stmt.test, h, in_loop,
                                     blocking_desc, aliases)
                    visit(stmt.body, h, in_loop)
                    visit(stmt.orelse, h, in_loop)
                    continue
                if isinstance(stmt, ast.Try):
                    visit(stmt.body, h, in_loop)
                    for handler in stmt.handlers:
                        visit(handler.body, h, in_loop)
                    visit(stmt.orelse, h, in_loop)
                    visit(stmt.finalbody, h, in_loop)
                    continue
                # straight-line acquire()/release() tracking
                if isinstance(stmt, ast.Expr) and \
                        isinstance(stmt.value, ast.Call) and \
                        isinstance(stmt.value.func, ast.Attribute):
                    recv = self._self_attr(stmt.value.func.value)
                    if recv is not None:
                        lid = cls.lock_id(recv)
                        if lid is not None:
                            if stmt.value.func.attr == "acquire":
                                info.acquires.append(
                                    _Acquire(lid, stmt.lineno, frozenset(h)))
                                acquired_here.append(lid)
                                continue
                            if stmt.value.func.attr == "release" and \
                                    lid in acquired_here:
                                acquired_here.remove(lid)
                                continue
                self._scan_exprs(cls, info, stmt, h, in_loop,
                                 blocking_desc, aliases)

        body = mnode.body if isinstance(mnode, (ast.FunctionDef,
                                                ast.AsyncFunctionDef)) else []
        visit(body, (), False)

    def _scan_exprs(self, cls, info, root, held, in_loop, blocking_desc,
                    aliases, top: bool = False) -> None:
        """Record writes / calls / blocking / waits in a statement (not
        descending into nested function defs or compound-stmt bodies —
        those are visited by the block walker with their own held set)."""
        h = frozenset(held)

        def nodes():
            stack = [root]
            while stack:
                node = stack.pop()
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef, ast.Lambda)):
                        continue
                    if top and isinstance(node, (ast.While, ast.For)) and \
                            child in getattr(node, "body", []) + \
                            getattr(node, "orelse", []):
                        continue
                    yield child
                    stack.append(child)

        mname = info.name
        seen = [root] if not top else []
        for node in list(seen) + list(nodes()):
            # writes: self.X = / self.X[..] = / self.X op= / self.X.mut()
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    tgts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else [t]
                    for leaf in tgts:
                        base = leaf
                        if isinstance(base, ast.Subscript):
                            base = base.value
                        attr = self._self_attr(base)
                        if attr is not None:
                            info.writes.append(
                                _Write(attr, mname, node.lineno, h))
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute):
                recv = node.func.value
                meth = node.func.attr
                rattr = self._self_attr(recv)
                if meth in _MUTATORS and rattr is not None:
                    info.writes.append(_Write(rattr, mname, node.lineno, h))
                if rattr is None and isinstance(recv, ast.Name):
                    rattr = info.attr_alias.get(recv.id)
                if meth == "wait":
                    cattr = rattr
                    if cattr is not None and cattr in cls.conditions:
                        info.waits.append(_Wait(cattr, node.lineno, in_loop))
                # call sites for edge/acquire propagation
                a = self._self_attr(node.func)
                if a is not None and a in cls.methods:
                    info.calls.append(
                        _CallSite("self", "", a, node.lineno, h))
                elif rattr is not None and rattr in cls.attr_types:
                    target = cls.attr_types[rattr]
                    if meth in target.methods:
                        info.calls.append(_CallSite(
                            "cross", target.name, meth, node.lineno, h))
            desc = blocking_desc(node)
            if desc is not None:
                info.blocks.append(_Block(desc, node.lineno, h))
                if desc in _FILE_IO:
                    info.file_io = True

    # -- pass 4: inherited held + transitive acquires --------------------

    def _inherited_held(self) -> None:
        """A private helper called ONLY with lock L held inherits L.

        Thread entries, signal handlers and registered callbacks are
        invoked externally with nothing held, so they never inherit —
        even when some same-class call site also reaches them."""
        for _ in range(3):
            for cls in self.class_list:
                external_roots = {t.entry for t in cls.threads} | \
                    {q.split(".")[-1] for q, n, k in cls.handlers} | \
                    cls.callback_refs
                sites: dict[str, list[frozenset]] = {}
                for mname, info in cls.minfo.items():
                    eff = info.inherited
                    for site in info.calls:
                        if site.kind == "self":
                            sites.setdefault(site.method, []).append(
                                site.held | eff)
                for mname, info in cls.minfo.items():
                    if not mname.startswith("_") or mname == "__init__":
                        continue
                    if mname in external_roots:
                        continue
                    held_sets = sites.get(mname)
                    if held_sets:
                        cls.minfo[mname].inherited = \
                            frozenset.intersection(*held_sets)

    def _transitive_acquires(self) -> dict[tuple[str, str], frozenset]:
        trans: dict[tuple[str, str], set] = {}
        for cls in self.class_list:
            for mname, info in cls.minfo.items():
                trans[(cls.name, mname)] = {a.lock for a in info.acquires}
        changed = True
        rounds = 0
        while changed and rounds < 20:
            changed = False
            rounds += 1
            for cls in self.class_list:
                for mname, info in cls.minfo.items():
                    cur = trans[(cls.name, mname)]
                    before = len(cur)
                    for site in info.calls:
                        key = (cls.name if site.kind == "self" else site.cls,
                               site.method)
                        cur |= trans.get(key, set())
                    if len(cur) != before:
                        changed = True
        return {k: frozenset(v) for k, v in trans.items()}

    def _collect_edges(self, trans) -> None:
        for cls in self.class_list:
            for mname, info in cls.minfo.items():
                inh = info.inherited
                for acq in info.acquires:
                    for held in acq.held | inh:
                        self._add_edge(held, acq.lock, cls.path, acq.line)
                for site in info.calls:
                    eff = site.held | inh
                    if not eff:
                        continue
                    key = (cls.name if site.kind == "self" else site.cls,
                           site.method)
                    for acquired in trans.get(key, ()):
                        for held in eff:
                            self._add_edge(held, acquired, cls.path,
                                           site.line)

    def _add_edge(self, src: str, dst: str, path: str, line: int) -> None:
        if src == dst:
            return
        if (src, dst) not in self._edge_keys:
            self._edge_keys.add((src, dst))
            self.edges.append(Edge(src, dst, path, line))

    # -- rules ------------------------------------------------------------

    def _cc001(self, cls: _ClassInfo) -> None:
        if not cls.threaded:
            return
        primitive = set(cls.locks) | set(cls.conditions) | cls.events
        by_attr: dict[str, list[_Write]] = {}
        for mname, info in cls.minfo.items():
            if mname == "__init__":
                continue
            # A method no concurrency root reaches (e.g. a private
            # helper called only from __init__) runs happens-before any
            # thread exists — its writes cannot race.
            if not cls.scopes.get(mname):
                continue
            for w in info.writes:
                if w.attr in primitive:
                    continue
                by_attr.setdefault(w.attr, []).append(w)
        for attr, writes in sorted(by_attr.items()):
            methods = {w.method for w in writes}
            scopes: set[str] = set()
            for m in methods:
                scopes |= cls.scopes.get(m, set())
            if len(methods) < 2 and len(scopes) < 2:
                continue
            held_sets = [w.held | cls.minfo[w.method].inherited
                         for w in writes]
            common = frozenset.intersection(*held_sets) if held_sets \
                else frozenset()
            if common:
                continue
            w0 = min(writes, key=lambda w: w.line)
            self.findings.append(Finding(
                "CC001", cls.path, w0.line, 0, f"{cls.name}.{attr}",
                f"attribute '{attr}' of threaded class {cls.name} is "
                f"written from {len(writes)} site(s) in "
                f"{sorted(methods)} spanning scopes {sorted(scopes)} "
                "with no common lock held"))

    def _cc002(self) -> None:
        adj: dict[str, set[str]] = {}
        sites: dict[tuple[str, str], Edge] = {}
        for e in self.edges:
            adj.setdefault(e.src, set()).add(e.dst)
            sites[(e.src, e.dst)] = e
        # Tarjan SCC, iterative.
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        counter = [0]
        sccs: list[list[str]] = []
        nodes = sorted(set(adj) | {d for ds in adj.values() for d in ds})

        def strongconnect(v0):
            work = [(v0, iter(sorted(adj.get(v0, ()))))]
            index[v0] = low[v0] = counter[0]
            counter[0] += 1
            stack.append(v0)
            on_stack.add(v0)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(adj.get(w, ())))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    if len(comp) > 1:
                        sccs.append(sorted(comp))

        for v in nodes:
            if v not in index:
                strongconnect(v)
        for comp in sccs:
            e = None
            for a in comp:
                for b in comp:
                    if (a, b) in sites:
                        e = sites[(a, b)]
                        break
                if e:
                    break
            self.findings.append(Finding(
                "CC002", e.path if e else "<lock-graph>",
                e.line if e else 0, 0, "<lock-order>",
                "lock-order inversion: acquisition-order cycle over "
                f"{{{', '.join(comp)}}} — two threads taking these locks "
                "in opposite orders deadlock"))

    def _cc003(self, cls: _ClassInfo) -> None:
        for mname, info in cls.minfo.items():
            offenses: list[_Block] = []
            for b in info.blocks:
                if b.held | info.inherited:
                    offenses.append(b)
            if not offenses:
                continue
            locks = sorted({lk for b in offenses
                            for lk in (b.held | info.inherited)})
            descs = ", ".join(f"{b.desc} (l.{b.line})" for b in offenses)
            self.findings.append(Finding(
                "CC003", cls.path, offenses[0].line, 0,
                f"{cls.name}.{mname}",
                f"blocking call(s) inside held-lock region of "
                f"{{{', '.join(locks)}}}: {descs} — every other thread "
                "contending for the lock stalls behind the I/O"))

    def _cc004(self, cls: _ClassInfo) -> None:
        for qual, hnode, kind in cls.handlers:
            if kind != "signal":
                continue
            offenses = []
            for node in ast.walk(hnode):
                if isinstance(node, ast.With):
                    for item in node.items:
                        if self._lock_of_expr(cls, item.context_expr):
                            offenses.append(("lock acquisition",
                                             node.lineno))
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Attribute):
                    recv = self._self_attr(node.func.value)
                    if node.func.attr == "set" and recv in cls.events:
                        continue       # the one blessed call
                    offenses.append((f".{node.func.attr}()", node.lineno))
                elif isinstance(node.func, ast.Name):
                    offenses.append((f"{node.func.id}()", node.lineno))
            if offenses:
                what = ", ".join(f"{d} (l.{ln})" for d, ln in offenses[:4])
                self.findings.append(Finding(
                    "CC004", cls.path, offenses[0][1], 0, qual,
                    f"signal handler does more than Event.set/flag "
                    f"writes: {what} — a handler interrupting the thread "
                    "that holds the lock it touches deadlocks (or "
                    "corrupts a mid-write journal)"))

    def _cc005(self, cls: _ClassInfo) -> None:
        for mname, info in cls.minfo.items():
            for w in info.waits:
                if not w.in_loop:
                    self.findings.append(Finding(
                        "CC005", cls.path, w.line, 0,
                        f"{cls.name}.{mname}",
                        f"Condition '{w.cond}'.wait() outside a predicate "
                        "loop — spurious wakeups and missed rechecks "
                        "proceed on a false predicate"))

    def _cc006(self, cls: _ClassInfo) -> None:
        for t in cls.threads:
            if not t.daemon or not t.entry or t.entry not in cls.methods:
                continue
            if t.attr is not None and t.attr in cls.joined:
                continue
            reach = {t.entry}
            frontier = [t.entry]
            while frontier:
                m = frontier.pop()
                for callee in cls.minfo[m].calls_self \
                        if m in cls.minfo else ():
                    if callee not in reach and callee in cls.minfo:
                        reach.add(callee)
                        frontier.append(callee)
            if any(cls.minfo[m].file_io for m in reach if m in cls.minfo):
                self.findings.append(Finding(
                    "CC006", cls.path, t.line, 0,
                    f"{cls.name}.{t.entry}",
                    f"daemon thread '{t.entry}' does file I/O with no "
                    "join path — interpreter teardown kills daemons "
                    "mid-write (torn file, lost record)"))

    def _cc007(self, cls: _ClassInfo) -> None:
        candidates: list[tuple[str, ast.AST]] = []
        if "__del__" in cls.methods:
            candidates.append((f"{cls.name}.__del__",
                               cls.methods["__del__"]))
        for qual, hnode, kind in cls.handlers:
            if kind == "atexit":
                candidates.append((qual, hnode))
        for qual, node in candidates:
            for n in ast.walk(node):
                lid = None
                if isinstance(n, ast.With):
                    for item in n.items:
                        lid = lid or self._lock_of_expr(
                            cls, item.context_expr)
                elif isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "acquire":
                    recv = self._self_attr(n.func.value)
                    if recv is not None:
                        lid = cls.lock_id(recv)
                if lid is not None:
                    self.findings.append(Finding(
                        "CC007", cls.path, n.lineno, 0, qual,
                        f"lock {lid} acquired in a finalizer path "
                        f"({qual.split('.')[-1]}) — finalizers run at "
                        "arbitrary points, possibly while the same lock "
                        "is held"))
                    break

    def _cc008(self, cls: _ClassInfo) -> None:
        for attr, line in sorted(cls.started.items()):
            if attr in cls.joined:
                continue
            self.findings.append(Finding(
                "CC008", cls.path, line, 0, f"{cls.name}.{attr}",
                f"thread handle '{attr}' is start()ed but never joined "
                f"anywhere in {cls.name} — no stop contract; the thread "
                "outlives every owner"))
        for mname, line in cls.inline_starts:
            self.findings.append(Finding(
                "CC008", cls.path, line, 0, f"{cls.name}.{mname}",
                "thread started fire-and-forget (handle dropped) — "
                "nothing can ever join or stop it"))

    # -- module-level functions ------------------------------------------

    def _module_functions(self) -> None:
        for path, tree, aliases in self.modules:
            funcs = [n for n in tree.body
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))]
            for fn in funcs:
                self._scan_function(path, tree, aliases, fn)
            # module-level locks + signal/atexit registrations
            module_locks = set()
            for node in tree.body:
                if isinstance(node, ast.Assign):
                    kind = self._ctor_kind(node.value, aliases)
                    if kind is not None and kind[0] == "lock":
                        module_locks.update(
                            t.id for t in node.targets
                            if isinstance(t, ast.Name))
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                name = self._dotted(node.func, aliases)
                if name == "atexit.register" and node.args and \
                        isinstance(node.args[0], ast.Name):
                    target = next((f for f in funcs
                                   if f.name == node.args[0].id), None)
                    if target is not None:
                        self._function_finalizer(path, target,
                                                 module_locks)

    def _function_finalizer(self, path: str, fn, module_locks) -> None:
        for n in ast.walk(fn):
            if isinstance(n, ast.With):
                for item in n.items:
                    d = None
                    if isinstance(item.context_expr, ast.Name) and \
                            item.context_expr.id in module_locks:
                        d = item.context_expr.id
                    if d is not None:
                        self.findings.append(Finding(
                            "CC007", path, n.lineno, 0, fn.name,
                            f"lock `{d}` acquired inside an atexit-"
                            "registered function — finalizers must not "
                            "block on locks"))
                        return

    def _scan_function(self, path, tree, aliases, fn) -> None:
        """Function-local concurrency: fire-and-forget threads (CC008)
        and blocking-under-local-lock (CC003)."""
        local_kinds: dict[str, tuple[str, object]] = {}
        nested = {n.name for n in ast.walk(fn)
                  if isinstance(n, ast.FunctionDef) and n is not fn}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                kind = self._ctor_kind(node.value, aliases)
                if kind is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            local_kinds[t.id] = kind
        started: dict[str, int] = {}
        joined: set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            recv, meth = node.func.value, node.func.attr
            if isinstance(recv, ast.Name) and \
                    local_kinds.get(recv.id, ("",))[0] == "thread":
                if meth == "start":
                    started[recv.id] = node.lineno
                elif meth == "join":
                    joined.add(recv.id)
            elif isinstance(recv, ast.Call) and meth == "start":
                kind = self._ctor_kind(recv, aliases)
                if kind is not None and kind[0] == "thread":
                    self.findings.append(Finding(
                        "CC008", path, node.lineno, 0, fn.name,
                        "thread started fire-and-forget (handle "
                        "dropped) — nothing can ever join or stop it"))
        for name, line in sorted(started.items()):
            if name not in joined:
                self.findings.append(Finding(
                    "CC008", path, line, 0, fn.name,
                    f"local thread '{name}' is start()ed but never "
                    "joined in this function — no stop contract"))
        # CC003 on local locks: `with lock:` around blocking calls.
        lock_names = {n for n, k in local_kinds.items() if k[0] == "lock"}
        if not lock_names:
            return
        for node in ast.walk(fn):
            if not isinstance(node, ast.With):
                continue
            holding = [item.context_expr.id for item in node.items
                       if isinstance(item.context_expr, ast.Name)
                       and item.context_expr.id in lock_names]
            if not holding:
                continue
            for inner in ast.walk(node):
                if not isinstance(inner, ast.Call):
                    continue
                name = self._dotted(inner.func, aliases)
                desc = _BLOCKING_DOTTED.get(name)
                if desc is None and isinstance(inner.func, ast.Name) and \
                        inner.func.id == "open" and "open" not in aliases:
                    desc = "open()"
                if desc is not None:
                    self.findings.append(Finding(
                        "CC003", path, inner.lineno, 0, fn.name,
                        f"blocking call(s) inside held-lock region of "
                        f"{{{', '.join(holding)}}}: {desc} "
                        f"(l.{inner.lineno}) — every other thread "
                        "contending for the lock stalls behind the I/O"))
                    break

    # -- inventory export -------------------------------------------------

    def inventory(self) -> dict:
        out: dict = {}
        for cls in sorted(self.class_list, key=lambda c: (c.name, c.path)):
            if not (cls.locks or cls.conditions or cls.events
                    or cls.threads or cls.handlers):
                continue
            out[cls.name] = {
                "path": cls.path,
                "locks": sorted(cls.locks),
                "conditions": {c: (a or c) for c, a in
                               sorted(cls.conditions.items())},
                "events": sorted(cls.events),
                "threads": [{"entry": t.entry, "attr": t.attr,
                             "daemon": t.daemon} for t in cls.threads],
                "handlers": sorted(q for q, n, k in cls.handlers),
            }
        # Module-level locks under their id's module part
        # ("serve.engine._PROGRAM_LOCK" -> "serve.engine": ["_PROGRAM_LOCK"]).
        for path, locks in sorted(self.module_locks.items()):
            for lid in sorted(locks.values()):
                mod, _, name = lid.rpartition(".")
                rec = out.setdefault(mod, {
                    "path": path, "locks": [], "conditions": {},
                    "events": [], "threads": [], "handlers": []})
                rec["locks"] = sorted(set(rec["locks"]) | {name})
        return out


# -- public API -------------------------------------------------------------


def _collect_files(paths: Iterable[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git",
                                            "analysis_fixtures")]
                files.extend(os.path.join(dirpath, f)
                             for f in filenames if f.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    return sorted(set(files))


def analyze_paths(paths: Iterable[str], repo_root: str | None = None
                  ) -> AnalysisResult:
    """Analyze every ``.py`` file under ``paths`` as ONE program (the
    cross-class lock graph needs the whole picture)."""
    ana = _Analyzer()
    for f in _collect_files(paths):
        rel = os.path.relpath(f, repo_root) if repo_root else f
        with open(f, encoding="utf-8") as fh:
            ana.add_module(fh.read(), rel)
    ana.run()
    return AnalysisResult(ana.findings, ana.edges, ana.inventory())


def analyze_source(source: str, path: str = "<source>") -> AnalysisResult:
    """Analyze one module's source text (the fixture-test entry point)."""
    ana = _Analyzer()
    ana.add_module(source, path)
    ana.run()
    return AnalysisResult(ana.findings, ana.edges, ana.inventory())


def static_edge_set(result: AnalysisResult) -> set[tuple[str, str]]:
    """The acquisition-order graph as (src, dst) pairs — the reference
    the runtime witness's observed graph must be a subgraph of."""
    return {(e.src, e.dst) for e in result.edges}
