"""Runtime lock-order witness (counterpart: the factories and witness of
cbf_tpu/analysis/lockwitness.py that the ``obs`` modules use).

Every lock, condition and event of the threaded ``serve``, ``durable``
and ``obs`` modules is made through :func:`make_lock` /
:func:`make_condition` / :func:`make_event` with a canonical name
(``"ClassName._attr"``). Disarmed — the default — they return the plain
``threading`` primitives. Armed (env ``CBF_TPU_LOCK_WITNESS=1`` at import,
or :func:`arm` before the objects are made), they return wrappers that
record, per thread, the stack of held locks, an edge ``(held, acquired)``
for every nested acquisition, and a held-while-blocking event for every
``Condition.wait`` / ``Event.wait`` entered with another lock held.
:func:`inversions` lists the pairs taken in both orders (each a latent
deadlock). A condition shares its lock's witness identity
(``ServeEngine._cond`` records as ``ServeEngine._lock``): the
:class:`WitnessCondition` wraps ``threading.Condition`` around the raw
lock inside the :class:`WitnessLock`, and ``wait()`` books the release
and the reacquisition. :func:`check_subgraph` holds the observed edges to
the transitive closure of the static acquisition-order graph of
:mod:`cbf_tpu_torch.analysis.concurrency` (``static_edge_set(
analyze_paths([...]))``): an observed edge the analyser cannot explain
means its model of the code is wrong.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = ["make_lock", "make_condition", "make_event", "arm", "disarm",
           "is_armed", "reset", "snapshot", "observed_edges", "inversions",
           "check_subgraph", "WitnessLock", "WitnessCondition",
           "WitnessEvent"]

_armed = os.environ.get("CBF_TPU_LOCK_WITNESS", "0") == "1"
_guard = threading.Lock()          # plain on purpose: the witness's leaf
_tls = threading.local()
_edges: dict[tuple[str, str], int] = {}
_blocking: list[dict] = []
_acquisitions = 0


def _stack() -> list[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _note_acquire(name: str) -> None:
    global _acquisitions
    st = _stack()
    with _guard:
        _acquisitions += 1
        for held in st:
            if held != name:
                _edges[(held, name)] = _edges.get((held, name), 0) + 1
    st.append(name)


def _note_release(name: str) -> None:
    st = _stack()
    for i in range(len(st) - 1, -1, -1):
        if st[i] == name:
            del st[i]
            break


def _note_blocking(kind: str, name: str, held: list[str]) -> None:
    with _guard:
        _blocking.append({"kind": kind, "name": name, "held": list(held)})


class WitnessLock:
    """``threading.Lock`` recording acquisition order under ``name``."""

    __slots__ = ("name", "_raw")

    def __init__(self, name: str):
        self.name = name
        self._raw = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._raw.acquire(blocking, timeout)
        if got:
            _note_acquire(self.name)
        return got

    def release(self) -> None:
        _note_release(self.name)
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class WitnessCondition:
    """Condition sharing its :class:`WitnessLock`'s witness identity."""

    __slots__ = ("name", "_wlock", "_cond")

    def __init__(self, wlock: WitnessLock):
        self.name = wlock.name
        self._wlock = wlock
        # Built on the RAW lock: the Condition's internal _is_owned probe
        # and wait()'s release/reacquire bypass the bookkeeping.
        self._cond = threading.Condition(wlock._raw)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._wlock.acquire(blocking, timeout)

    def release(self) -> None:
        self._wlock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def wait(self, timeout: float | None = None) -> bool:
        others = [h for h in _stack() if h != self.name]
        if others:
            _note_blocking("cond_wait", self.name, others)
        _note_release(self.name)
        try:
            return self._cond.wait(timeout)
        finally:
            # Reacquired inside cond.wait: re-book it, so a wait entered
            # with other locks held records the (other -> this) edge the
            # reacquisition really is.
            _note_acquire(self.name)

    def wait_for(self, predicate, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        result = predicate()
        while not result:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
            self.wait(remaining)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


class WitnessEvent:
    """Event recording held-while-blocking on ``wait()``."""

    __slots__ = ("name", "_ev")

    def __init__(self, name: str):
        self.name = name
        self._ev = threading.Event()

    def set(self) -> None:
        self._ev.set()

    def clear(self) -> None:
        self._ev.clear()

    def is_set(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        held = list(_stack())
        if held:
            _note_blocking("event_wait", self.name, held)
        return self._ev.wait(timeout)


def make_lock(name: str):
    """A lock named for the witness; a plain ``threading.Lock`` disarmed."""
    return WitnessLock(name) if _armed else threading.Lock()


def make_condition(name: str, lock=None):
    """A condition sharing ``lock``'s witness identity when armed.

    ``name`` documents the attribute; the recorded identity is the
    underlying lock's (a condition and its lock are ONE lock)."""
    if isinstance(lock, WitnessLock):
        return WitnessCondition(lock)
    if _armed and lock is None:
        return WitnessCondition(WitnessLock(name))
    return threading.Condition(lock)


def make_event(name: str):
    return WitnessEvent(name) if _armed else threading.Event()


def arm() -> None:
    """Arm the witness for objects made from now on."""
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def is_armed() -> bool:
    return _armed


def reset() -> None:
    """Drop the recorded edges and events (not the arm state)."""
    global _acquisitions
    with _guard:
        _edges.clear()
        _blocking.clear()
        _acquisitions = 0


def snapshot() -> dict:
    with _guard:
        return {"armed": _armed, "acquisitions": _acquisitions,
                "edges": [{"src": s, "dst": d, "count": c}
                          for (s, d), c in sorted(_edges.items())],
                "blocking": [dict(b) for b in _blocking]}


def observed_edges() -> set[tuple[str, str]]:
    with _guard:
        return set(_edges)


def inversions(edges: set[tuple[str, str]] | None = None
               ) -> list[tuple[str, str]]:
    """Pairs (a, b) observed in both orders — each a latent deadlock."""
    es = observed_edges() if edges is None else set(edges)
    return sorted({(min(a, b), max(a, b))
                   for (a, b) in es if (b, a) in es and a != b})


def _closure(edges: set[tuple[str, str]]) -> set[tuple[str, str]]:
    adj: dict[str, set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    closed: set[tuple[str, str]] = set()
    for src in adj:
        seen: set[str] = set()
        frontier = [src]
        while frontier:
            node = frontier.pop()
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        closed.update((src, d) for d in seen)
    return closed


def check_subgraph(static_edges) -> list[str]:
    """Explain every observed edge with the static graph.

    Returns one problem string per observed acquisition-order edge that
    is NOT in the transitive closure of ``static_edges`` (closure:
    holding A while a callee takes B then C books A->C at runtime even
    when the static graph only has the direct A->B and B->C steps).
    Empty list == the witness corroborates the analyser."""
    closed = _closure({(a, b) for a, b in static_edges})
    problems = []
    for a, b in sorted(observed_edges()):
        if (a, b) not in closed:
            problems.append(
                f"observed acquisition-order edge {a} -> {b} has no "
                "statically derived explanation — the concurrency "
                "analyzer's model of this code path is missing an edge")
    return problems
