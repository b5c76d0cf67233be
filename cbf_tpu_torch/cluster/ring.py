"""Consistent-hash placement ring over bucket signatures (counterpart:
cbf_tpu/cluster/ring.py, ported whole: :func:`ring_hash` is the same
sha1 prefix, so a label lands on the same engine in both packages).

The cluster's routing problem is capture affinity, not load spreading:
an engine that has captured (prewarmed) a bucket's program serves that
bucket at steady-state cost, while any other engine pays the capture on
first contact. So placement hashes the bucket *label*
(``n256-t128-...`` — the padded static signature, exactly the
program-identity key the engine itself buckets by), not the request
id: every request of a bucket lands on the same engine and that
engine's captured programs stay hot. A CUDA graph does not outlive its
process, so an engine a bucket fails over or is stolen onto captures it
anew.

Standard consistent hashing with virtual nodes: each engine owns
``vnodes`` pseudo-random points on a 64-bit ring (sha1 of
``"engine#i"`` — stable across processes and runs, no seed), and a
label is placed on the first engine point at or after its own hash,
wrapping. Removing an engine
moves ONLY the labels that engine owned (onto their next-clockwise
survivors) — the property rolling restarts and failover lean on: the
surviving engines' hot buckets do not reshuffle when the ring shrinks
by one.

Thread contract: the router's submit path, the steal sweep and the
membership plane all consult/mutate one ring, so every operation takes
the witnessed ``HashRing._lock``.
"""

from __future__ import annotations

import bisect
import hashlib

from cbf_tpu_torch.analysis import lockwitness


def ring_hash(s: str) -> int:
    """Stable 64-bit ring coordinate of a string (sha1 prefix — no
    process-seeded ``hash()``, so placement is identical across router
    restarts and processes)."""
    return int(hashlib.sha1(s.encode()).hexdigest()[:16], 16)


class HashRing:
    """Consistent-hash ring of engine names with virtual nodes."""

    def __init__(self, engines=(), *, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._lock = lockwitness.make_lock("HashRing._lock")
        self._points: list[tuple[int, str]] = []   # sorted (coord, engine)
        self._engines: set[str] = set()
        for e in engines:
            self.add(e)

    def add(self, engine: str) -> None:
        with self._lock:
            if engine in self._engines:
                return
            self._engines.add(engine)
            for i in range(self.vnodes):
                self._points.append((ring_hash(f"{engine}#{i}"), engine))
            self._points.sort()

    def remove(self, engine: str) -> None:
        with self._lock:
            self._engines.discard(engine)
            self._points = [p for p in self._points if p[1] != engine]

    def engines(self) -> list[str]:
        with self._lock:
            return sorted(self._engines)

    def __contains__(self, engine: str) -> bool:
        with self._lock:
            return engine in self._engines

    def __len__(self) -> int:
        with self._lock:
            return len(self._engines)

    def place(self, label: str) -> str:
        """The owning engine for a bucket label: first ring point at or
        after the label's coordinate (wrapping). Raises RuntimeError on
        an empty ring — the caller decides whether that is a shed or a
        wait."""
        h = ring_hash(label)
        with self._lock:
            if not self._points:
                raise RuntimeError("hash ring is empty — no engine "
                                   "enrolled to place onto")
            i = bisect.bisect_left(self._points, (h, ""))
            if i == len(self._points):
                i = 0
            return self._points[i][1]
