"""The cluster's membership/health plane: heartbeat monitoring, dead-
engine failover, rolling restarts, and the cluster-wide zero-loss
census (counterpart: cbf_tpu/cluster/membership.py, ported whole).

Liveness reuses the HA primitives unchanged: each worker renews its
own fenced lease (`serve.ha.Lease` + `Heartbeater`), and this plane
watches every lease with a `serve.ha.LeaseMonitor` on its OWN
monotonic clock — no cross-process wall-clock comparison, same expiry
semantics as the single-engine standby.

Failover is the other half of the arbitration `cluster.worker`'s boot
performs (both serialize on the per-engine ``recovery.lock`` flock):

1. Expiry detected → record the observed epoch, pull the engine from
   the ring (survivors' hot buckets do not move — consistent hashing),
   and re-route its UNCLAIMED inbox files onto their new ring owners
   (legal for the same reason stealing is: an inbox file is unacked by
   construction).
2. Under the recovery flock: re-read the lease. If the epoch moved past
   the one observed at detection, a restarted worker beat us to the log
   — stand down, it self-recovers. Otherwise ``Lease.acquire()`` (the
   bump fences any zombie at its next journal append/heartbeat), fold
   the dead epoch's journal (`durable.replay_journal` — request-id
   dedupe IS the fold), then ARCHIVE the journal family (rename to
   ``archived-e<epoch>.*``) so a later boot of that engine starts
   clean while the census still sees every record; then settle the dead
   engine's ``claimed/`` files (a departure from the JAX package, which
   leaves them: see `cluster.worker`) — one the journal never
   acknowledged is re-routed onto its ring placement like an inbox
   file, an acknowledged one is removed (the replay below re-homes or
   synthesizes its request).
3. Outside the flock: re-deposit every acknowledged-but-unresolved
   request onto the survivors (same request ids — the router's pending
   map does not care which engine answers), and synthesize a response
   for any id whose ``resolved`` record is durable but whose response
   file never landed (re-running it would be a duplicate execution).
   MTTR is detection → all orphans re-homed.

Rolling restart (the zero-loss gate): one engine at a time — quiesce
(out of the ring + unclaimed inbox re-routed), wait for its
``claimed/`` census to drain to zero (every acked request responded),
SIGTERM (the worker's drain path exits 0), restart via the injected
``respawn`` callable, wait for the ready file, re-enroll. At no point
does an acknowledged request exist only in a process being stopped.

:func:`cluster_census` folds EVERY journal family under the root
(active + archived): a lost ack is an id submitted anywhere whose
total ``resolved`` count is 0; a duplicate execution is a total > 1.
A clean cluster has both empty (``ok``).
"""

from __future__ import annotations

import glob
import os
import threading
import time

from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.cluster import transport
from cbf_tpu_torch.cluster.worker import recovery_flock
from cbf_tpu_torch.serve import ha as serve_ha

#: Generic telemetry event types this module emits (with
#: cluster.router's, they union to obs.schema.CLUSTER_EVENT_TYPES).
EMITTED_EVENT_TYPES: tuple[str, ...] = ("cluster.member", "cluster.roll")


class Membership:
    """Monitor + failover driver for one router's engine set. ``poll()``
    is the unit of progress (tests drive it synchronously); ``start()``
    runs it on the ``cluster-membership`` daemon thread."""

    def __init__(self, router, *, ttl_s: float = 1.0,
                 poll_s: float = 0.05, telemetry=None, respawn=None,
                 ready_timeout_s: float = 60.0):
        self.router = router
        self.ttl_s = ttl_s
        self.poll_s = poll_s
        self.telemetry = telemetry
        self.respawn = respawn   # callable(engine_name) — restart seam
        self.ready_timeout_s = ready_timeout_s
        self.failovers = 0
        self.mttr_s: list[float] = []
        self._monitors: dict[str, serve_ha.LeaseMonitor] = {}
        self._lock = lockwitness.make_lock("Membership._lock")
        self._stop = lockwitness.make_event("Membership._stop")
        self._thread: threading.Thread | None = None
        for name in router.ring.engines():
            self._watch(name)

    # -------------------------------------------------------- watching --

    def _watch(self, name: str) -> None:
        with self._lock:
            self._monitors[name] = serve_ha.LeaseMonitor(
                self.router.dirs[name].lease, ttl_s=self.ttl_s)

    def _member_event(self, name: str, state: str, *, epoch=None,
                      reenqueued: int = 0, deduped: int = 0,
                      mttr_s=None) -> None:
        if self.telemetry is not None:
            self.telemetry.event("cluster.member", {
                "engine": name, "state": state, "epoch": epoch,
                "reenqueued": reenqueued, "deduped": deduped,
                "mttr_s": mttr_s})

    def enroll(self, name: str) -> None:
        """(Re-)enroll an engine: back into the ring, watched again."""
        self.router.ring.add(name)
        self._watch(name)
        state = serve_ha.read_lease(self.router.dirs[name].lease)
        self._member_event(name, "up",
                           epoch=(state.epoch if state else None))

    def poll(self) -> list[str]:
        """One liveness pass over every watched engine; runs failover
        for each newly-expired lease. Returns the engines failed over
        this pass."""
        with self._lock:
            items = list(self._monitors.items())
        failed = []
        for name, mon in items:
            mon.poll()
            if not mon.expired():
                continue
            with self._lock:
                self._monitors.pop(name, None)   # one failover per death
            self.failover(name)
            failed.append(name)
        return failed

    # -------------------------------------------------------- failover --

    def failover(self, name: str) -> dict:
        """Fail a dead engine over onto the survivors (module docstring
        steps 1–3). Returns a report dict; emits ``cluster.member``."""
        t_detect = time.monotonic()
        dirs = self.router.dirs[name]
        observed = serve_ha.read_lease(dirs.lease)
        observed_epoch = observed.epoch if observed is not None else 0
        self._member_event(name, "dead", epoch=observed_epoch)
        self.router.ring.remove(name)
        rerouted = 0
        for path in transport.list_inbox(dirs):
            if self.router.reroute_file(name, path) is not None:
                rerouted += 1
        replay = None
        with recovery_flock(dirs):
            current = serve_ha.read_lease(dirs.lease)
            if current is not None and current.epoch > observed_epoch:
                # A restarted worker bumped the epoch first: it owns the
                # journal replay. Stand down — back into the ring (it
                # was pulled at detection), watch the new epoch.
                self.router.ring.add(name)
                self._watch(name)
                self._member_event(name, "up", epoch=current.epoch)
                return {"engine": name, "state": "up",
                        "epoch": current.epoch, "rerouted": rerouted}
            lease = serve_ha.Lease(dirs.lease, owner="membership",
                                   telemetry=self.telemetry)
            epoch = lease.acquire()     # fences any zombie appender
            replay = self._fold_and_archive(dirs, observed_epoch)
            reclaimed = self._settle_claims(name, dirs, replay)
        reenqueued = deduped = 0
        if replay is not None:
            # Deliver any response files the dead worker DID land before
            # synthesizing from journal evidence — a real result always
            # beats a synthesized placeholder.
            self.router.poll_once()
            for rid, cfg_json in replay.unresolved:
                label = self._label_for(rid)
                self.router.resubmit(rid, cfg_json, label)
                reenqueued += 1
            for rid in replay.resolved:
                if self.router.synthesize(rid, self._label_for(rid)):
                    deduped += 1
        mttr = time.monotonic() - t_detect
        with self._lock:
            self.failovers += 1
            self.mttr_s.append(mttr)
        self._member_event(name, "failover", epoch=epoch,
                           reenqueued=reenqueued, deduped=deduped,
                           mttr_s=mttr)
        if self.respawn is not None:
            # Heal the membership: bring the engine back (fresh epoch,
            # clean journal — the dead one is archived) and re-enroll.
            # MTTR above deliberately excludes this: the orphans are
            # already re-homed on survivors.
            from cbf_tpu_torch.utils.faults import wait_for_file

            try:
                os.remove(dirs.ready)   # the dead epoch's handshake
            except OSError:
                pass
            self.respawn(name)
            if wait_for_file(dirs.ready, self.ready_timeout_s):
                self.enroll(name)
        return {"engine": name, "state": "failover", "epoch": epoch,
                "rerouted": rerouted, "reclaimed": reclaimed,
                "reenqueued": reenqueued, "deduped": deduped,
                "mttr_s": mttr}

    def _label_for(self, rid: str) -> str:
        route = None
        with self.router._lock:
            route = self.router._routes.get(rid)
        return route.label if route is not None else ""

    def _settle_claims(self, name: str, dirs: transport.EngineDirs,
                       replay) -> int:
        """The dead engine's claimed files after the epoch bump: re-route
        each one its journal never acknowledged, remove the others.
        Returns the number re-routed. A journal that could not be
        folded (it is still in place) leaves them untouched: without its
        acknowledgments nothing can be re-routed safely."""
        from cbf_tpu_torch.durable.journal import journal_segments

        if replay is None and (os.path.exists(dirs.journal)
                               or journal_segments(dirs.journal)):
            return 0
        acked = set(replay.submitted) if replay is not None else set()
        reclaimed = 0
        for path in transport.list_claimed(dirs):
            payload = transport.read_json(path)
            if payload is not None \
                    and payload.get("request_id") not in acked:
                if self.router.reroute_file(name, path) is not None:
                    reclaimed += 1
                continue
            try:
                os.remove(path)
            except OSError:
                pass
        return reclaimed

    @staticmethod
    def _fold_and_archive(dirs: transport.EngineDirs, epoch: int):
        """Fold the dead epoch's journal family, then rename it to the
        ``archived-e<epoch>`` family: a later boot of this engine
        starts with a clean log, and :func:`cluster_census` still
        folds every record ever acked."""
        from cbf_tpu_torch.durable.journal import (RecoveryError,
                                             journal_segments,
                                             replay_journal)

        segments = journal_segments(dirs.journal)
        if not segments and not os.path.exists(dirs.journal):
            return None
        try:
            replay = replay_journal(dirs.journal)
        except RecoveryError:
            return None
        base = os.path.join(dirs.base, f"archived-e{epoch}.journal.wal")
        for seg in segments:
            suffix = os.path.basename(seg)[
                len(os.path.basename(dirs.journal)):]
            os.replace(seg, base + suffix)
        if os.path.exists(dirs.journal):
            os.replace(dirs.journal, base)
        return replay

    # -------------------------------------------------- rolling restart --

    def _roll_event(self, name: str, phase: str, *, drained: int = 0,
                    restart_s=None) -> None:
        if self.telemetry is not None:
            self.telemetry.event("cluster.roll", {
                "engine": name, "phase": phase, "drained": drained,
                "restart_s": restart_s})

    def quiesce(self, name: str) -> int:
        """Pull an engine from the ring and re-route its unclaimed
        inbox; returns the number of files re-routed. Claimed (acked)
        requests stay — the worker resolves them on its drain path."""
        self.router.ring.remove(name)
        with self._lock:
            self._monitors.pop(name, None)   # a draining lease is quiet
        moved = 0
        for path in transport.list_inbox(self.router.dirs[name]):
            if self.router.reroute_file(name, path) is not None:
                moved += 1
        return moved

    def rolling_restart(self, engines=None, *,
                        drain_timeout_s: float = 120.0,
                        term_timeout_s: float = 60.0) -> list[dict]:
        """Drain-then-restart each engine in turn (module docstring).
        Requires the ``respawn`` callable. Raises RuntimeError when a
        drain or restart misses its deadline — the gate, not a
        best-effort."""
        if self.respawn is None:
            raise RuntimeError("rolling_restart needs a respawn "
                               "callable to bring engines back")
        reports = []
        for name in (list(engines) if engines is not None
                     else self.router.ring.engines()):
            dirs = self.router.dirs[name]
            t0 = time.monotonic()
            drained = self.quiesce(name)
            self._roll_event(name, "drain", drained=drained)
            deadline = time.monotonic() + drain_timeout_s
            while (transport.inbox_depth(dirs)
                   or transport.claimed_depth(dirs)):
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"rolling restart: engine {name} did not drain "
                        f"in {drain_timeout_s}s")
                time.sleep(self.poll_s)
            self._terminate(dirs, term_timeout_s)
            self._roll_event(name, "restart", drained=drained)
            try:
                os.remove(dirs.ready)
            except OSError:
                pass
            self.respawn(name)
            from cbf_tpu_torch.utils.faults import wait_for_file

            if not wait_for_file(dirs.ready, self.ready_timeout_s):
                raise RuntimeError(
                    f"rolling restart: engine {name} not ready within "
                    f"{self.ready_timeout_s}s of respawn")
            restart_s = time.monotonic() - t0
            self.enroll(name)
            self._roll_event(name, "done", drained=drained,
                             restart_s=restart_s)
            reports.append({"engine": name, "drained": drained,
                            "restart_s": restart_s})
        return reports

    @staticmethod
    def _terminate(dirs: transport.EngineDirs, timeout_s: float) -> None:
        """SIGTERM the worker behind ``dirs`` (pid file) and wait for
        exit; no-op when no pid file (in-process worker — the caller's
        respawn owns its lifecycle)."""
        import signal

        rec = transport.read_json(dirs.pid)
        if not rec or not rec.get("pid"):
            return
        pid = int(rec["pid"])
        if pid == os.getpid():
            return   # in-process worker: the respawn owns its lifecycle
        try:
            os.kill(pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return
            # A direct child must also be reaped or kill(pid, 0) sees
            # the zombie forever.
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
                if done == pid:
                    return
            except ChildProcessError:
                pass
            time.sleep(0.02)
        raise RuntimeError(f"worker pid {pid} ignored SIGTERM for "
                           f"{timeout_s}s")

    # -------------------------------------------------- thread harness --

    def start(self) -> "Membership":
        self._stop.clear()
        t = threading.Thread(target=self._loop,
                             name="cluster-membership", daemon=True)
        with self._lock:
            self._thread = t
        t.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.poll()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()   # outside _lock: the loop's poll() takes it


def cluster_census(root: str) -> dict:
    """Fold every journal family under ``root`` (active + archived,
    every engine) into the cluster-wide exactly-once verdict. ``lost``
    lists ids acknowledged somewhere but never resolved anywhere;
    ``duplicates`` lists ids with more than one terminal record
    cluster-wide. The chaos gate is both empty."""
    from cbf_tpu_torch.durable.journal import RecoveryError, replay_journal

    submitted: set[str] = set()
    resolved_counts: dict[str, int] = {}
    journals = 0
    bases = []
    for engine_base in sorted(
            glob.glob(os.path.join(root, "engines", "*"))):
        bases.append(os.path.join(engine_base, "journal.wal"))
        bases.extend(sorted(
            p for p in glob.glob(
                os.path.join(engine_base, "archived-e*.journal.wal"))
            if ".journal.wal.seg" not in p))
    for base in bases:
        try:
            replay = replay_journal(base)
        except (RecoveryError, FileNotFoundError):
            continue
        journals += 1
        submitted.update(replay.submitted)
        for rid, n in replay.resolved_counts.items():
            resolved_counts[rid] = resolved_counts.get(rid, 0) + n
    lost = sorted(rid for rid in submitted
                  if resolved_counts.get(rid, 0) == 0)
    duplicates = sorted(rid for rid, n in resolved_counts.items()
                        if n > 1)
    return {"journals": journals, "submitted": len(submitted),
            "resolved": sum(1 for rid in submitted
                            if resolved_counts.get(rid, 0) == 1),
            "lost": lost, "duplicates": duplicates,
            "ok": not lost and not duplicates}
