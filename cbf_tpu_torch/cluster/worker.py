"""One cluster engine: a `ServeEngine` wrapped in the claim/ack/respond
loop, fenced lease, and WAL (counterpart: cbf_tpu/cluster/worker.py,
ported whole).

Boot protocol (the self-recovery side of the arbitration the membership
plane's failover is the other side of — both serialize on the flock at
``EngineDirs.recovery_lock``):

1. Under the recovery flock: ``Lease.acquire()`` (epoch bump — from
   this instant any zombie predecessor is fenced at the journal), note
   whether a journal to self-recover exists, and settle the claimed
   files a dead predecessor left (below). Bumping the epoch
   INSIDE the flock is what lets a concurrent router failover abort:
   it re-reads the lease under the same flock and stands down when the
   epoch moved past the one it observed at expiry detection.
2. Build the engine (its CUDA init comes with the first capture —
   deliberately OUTSIDE the flock; the membership plane must never wait
   seconds on a worker's device init), open the journal at the new
   epoch fenced by the lease, start the heartbeater, prewarm from the
   cluster's ``prewarm.json`` when present, then self-recover the
   journal's acknowledged-but-unresolved requests (request-id dedupe is
   the replay fold itself).
3. Write ``pid`` and ``ready``, then loop: claim the oldest inbox file
   (atomic rename — losing the race to a steal is not an error),
   ``submit`` it (the WAL ``submitted`` fsync inside submit IS the
   cluster-wide ack), and when the handle resolves write the outbox
   response (the ``resolved`` record is durable first — `PendingRequest`
   ordering) and delete the claimed file. ``claimed/`` size is
   therefore the engine's acked-in-flight census.

Exit contract matches the serve CLI: SIGTERM drains (stop claiming,
resolve every acked request, exit 0 — the rolling-restart gate);
a fenced journal/heartbeat exits ``EXIT_FENCED`` (4) so a supervisor
knows a newer epoch owns the log. A fenced worker answers for nothing:
a refused acknowledgment or a resolve the fence rejected writes no
response (the new owner serves those requests).

Claimed files a dead epoch left (where the port departs from the JAX
package, whose recovery looks at the journal alone): a worker killed
between its claim rename and its ``submitted`` fsync leaves a request
in ``claimed/`` that no journal acknowledges, and nothing would ever
serve it — its client would wait out its timeout. Whoever replays the
dead epoch settles ``claimed/`` after its epoch bump (the booting worker
here, or `cluster.membership`'s failover): an unacknowledged file goes
back to an inbox, an acknowledged one is bookkeeping for the journal's
replay (kept for an unresolved request this boot re-runs, removed
otherwise), so ``claimed/`` stays the acked-in-flight census.

The :class:`Worker` object is usable in-process (the tests run M
workers as threads against real engines; in one process they share the
program cache and ``serve.engine._PROGRAM_LOCK``, so their device work
serialises); :func:`run_worker` is the ``python -m cbf_tpu_torch cluster
worker`` process entry. ``device`` is the engine's: the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import numpy as np

from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.cluster import transport
from cbf_tpu_torch.serve import ha as serve_ha
from cbf_tpu_torch.serve.resilience import FencedError, ServeError


@contextlib.contextmanager
def recovery_flock(dirs: transport.EngineDirs):
    """Exclusive flock arbitrating journal-replay ownership for one
    engine: held across (epoch bump + journal claim/archive) by BOTH a
    booting worker (self-recovery) and the membership plane (failover
    replay), so exactly one of them ever replays a dead epoch's log."""
    import fcntl

    fd = os.open(dirs.recovery_lock, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)   # releases the flock


def _result_payload(name: str, epoch: int, r) -> dict:
    """Serialize one RequestResult's scalar surface for the outbox (the
    router reconstructs a loadgen-compatible result from this). The
    reductions run on the host arrays the engine's one copy per batch
    already made."""
    return {
        "ok": True, "request_id": r.request_id, "engine": name,
        "epoch": epoch, "bucket": r.bucket, "n": r.n, "steps": r.steps,
        "latency_s": float(r.latency_s),
        "queue_wait_s": float(r.queue_wait_s),
        "execute_s": float(r.execute_s),
        "batch_fill": int(r.batch_fill),
        "degraded": bool(r.degraded),
        "ttfp_s": (float(r.ttfp_s) if r.ttfp_s is not None else None),
        "min_pairwise_distance": float(np.min(
            r.outputs.min_pairwise_distance)),
        "infeasible_count": int(np.sum(r.outputs.infeasible_count)),
    }


def _error_payload(name: str, epoch: int, rid: str,
                   e: BaseException) -> dict:
    return {"ok": False, "request_id": rid, "engine": name,
            "epoch": epoch, "error_type": type(e).__name__,
            "message": str(e),
            "bucket": getattr(e, "bucket", None)}


class Worker:
    """The claim/ack/respond loop around one ServeEngine (see module
    docstring). ``start()`` runs the loop on a daemon thread (in-process
    cluster tests); ``run()`` blocks (the subprocess entry)."""

    def __init__(self, root: str, name: str, *, max_batch: int = 8,
                 flush_deadline_s: float = 0.05,
                 heartbeat_s: float = 0.2, cache_dir: str | None = None,
                 telemetry=None, poll_s: float = 0.005,
                 prewarm_path: str | None = None, engine_kw=None,
                 device=None):
        self.dirs = transport.EngineDirs(root, name)
        self.name = name
        self.max_batch = max_batch
        self.flush_deadline_s = flush_deadline_s
        self.heartbeat_s = heartbeat_s
        self.cache_dir = cache_dir
        self.telemetry = telemetry
        self.poll_s = poll_s
        self.prewarm_path = (prewarm_path if prewarm_path is not None
                             else os.path.join(self.dirs.root,
                                               "prewarm.json"))
        self.engine_kw = dict(engine_kw or {})
        self.device = device
        self.epoch: int | None = None
        self._fenced: FencedError | None = None   # a refused ack
        self.engine = None
        self.lease = None
        self.heartbeater = None
        self.prewarm_s: float | None = None
        self.recovered = 0
        self.served = 0
        self._inflight: list = []   # (rid, pending, claimed_path)
        self._lock = lockwitness.make_lock("Worker._lock")
        self._stop = lockwitness.make_event("Worker._stop")
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ boot --

    def boot(self) -> None:
        """Steps 1-2 of the boot protocol: lease, engine, journal,
        heartbeat, prewarm, self-recovery, ready file."""
        from cbf_tpu_torch.durable.journal import (RequestJournal,
                                             journal_segments)
        from cbf_tpu_torch.serve.engine import ServeEngine

        self.lease = serve_ha.Lease(self.dirs.lease, owner=self.name,
                                    telemetry=self.telemetry)
        with recovery_flock(self.dirs):
            self.epoch = self.lease.acquire()
            recover = (os.path.exists(self.dirs.journal)
                       or bool(journal_segments(self.dirs.journal)))
            kept = self._settle_claims(recover)
        journal = RequestJournal(self.dirs.journal,
                                 telemetry=self.telemetry,
                                 epoch=self.epoch,
                                 fence_path=self.dirs.lease)
        self.engine = ServeEngine(max_batch=self.max_batch,
                                  flush_deadline_s=self.flush_deadline_s,
                                  cache_dir=self.cache_dir,
                                  telemetry=self.telemetry,
                                  journal=journal, device=self.device,
                                  **self.engine_kw)
        self.engine.start()
        self.heartbeater = serve_ha.Heartbeater(
            self.lease, interval_s=self.heartbeat_s).start()
        cfgs = self._prewarm_configs()
        if cfgs:
            self.prewarm_s = self.engine.prewarm(cfgs)
        if recover:
            # Self-recovery: the replay fold dedupes on request id, so
            # an id with a durable ``resolved`` record is never re-run;
            # re-enqueued handles flow through the same responder path
            # as claimed traffic (the router's pending map is keyed by
            # request id — it does not care which boot resolves it).
            pendings = self.engine.recover(self.dirs.journal)
            self.recovered = len(pendings)
            with self._lock:
                for p in pendings:
                    self._inflight.append((p.request_id, p,
                                           kept.get(p.request_id)))
        transport.write_json_atomic(self.dirs.pid,
                                    {"pid": os.getpid()})
        transport.write_json_atomic(
            self.dirs.health,
            {"role": "cluster-worker", "engine": self.name,
             "epoch": self.epoch, "journal": self.dirs.journal})
        with open(self.dirs.ready, "w") as fh:
            fh.write(str(self.epoch))

    def _settle_claims(self, recover: bool) -> dict:
        """Under the recovery flock, after the epoch bump: return each
        claimed file the journal never acknowledged to this engine's
        inbox (the claim loop takes it again), remove those of resolved
        requests, and keep those of acknowledged-but-unresolved ones
        (returned by request id: the recovered handles remove them when
        they respond). See the module docstring."""
        from cbf_tpu_torch.durable.journal import replay_journal

        acked, resolved = set(), set()
        if recover:
            replay = replay_journal(self.dirs.journal)
            acked, resolved = set(replay.submitted), replay.resolved
        kept = {}
        for path in transport.list_claimed(self.dirs):
            req = transport.read_json(path)
            rid = req.get("request_id") if req else None
            if rid is not None and rid in acked and rid not in resolved:
                kept[rid] = path
            elif rid is not None and rid not in acked:
                transport.steal(self.dirs, self.dirs, path)
            else:
                with contextlib.suppress(OSError):
                    os.remove(path)
        return kept

    def _prewarm_configs(self) -> list:
        from cbf_tpu_torch.durable.rollout import config_from_json
        from cbf_tpu_torch.scenarios import swarm

        try:
            with open(self.prewarm_path) as fh:
                raw = json.load(fh)
        except (OSError, ValueError):
            return []
        cfgs = []
        for item in raw if isinstance(raw, list) else []:
            try:
                cfgs.append(config_from_json(swarm.Config, item))
            except (TypeError, ValueError):
                continue
        return cfgs

    # ------------------------------------------------------------ loop --

    def fenced(self) -> FencedError | None:
        fe = self.engine.fenced if self.engine is not None else None
        if fe is None and self.heartbeater is not None:
            fe = self.heartbeater.fenced
        return fe if fe is not None else self._fenced

    def _claim_one(self) -> bool:
        """Claim and submit the oldest inbox request. Returns True when
        a request was admitted (acked)."""
        from cbf_tpu_torch.durable.rollout import config_from_json
        from cbf_tpu_torch.scenarios import swarm

        for path in transport.list_inbox(self.dirs):
            claimed = transport.claim(self.dirs, path)
            if claimed is None:
                continue        # lost the race to a steal: not ours
            req = transport.read_json(claimed)
            if req is None:     # unreadable claim: refuse, don't hang
                with contextlib.suppress(OSError):
                    os.remove(claimed)
                continue
            rid = req["request_id"]
            try:
                cfg = config_from_json(swarm.Config, req["config"])
                # The ack: submit fsyncs the WAL ``submitted`` record
                # before returning. Before this line the request was
                # stealable; after it, it is this engine's to resolve.
                p = self.engine.submit(cfg, request_id=rid)
            except FencedError as fe:
                # A newer epoch owns this engine's log: the request was
                # never acknowledged here, and the new owner settles the
                # claimed file. Answer nothing; the loop exits fenced.
                self._fenced = fe
                return False
            except (ServeError, TypeError, ValueError) as e:
                transport.write_response(
                    self.dirs, rid,
                    _error_payload(self.name, self.epoch, rid, e))
                os.remove(claimed)
                return True
            with self._lock:
                self._inflight.append((rid, p, claimed))
            return True
        return False

    def _reap(self) -> int:
        """Write responses for resolved in-flight requests; returns how
        many were reaped."""
        done, live = [], []
        with self._lock:
            for rid, p, claimed in self._inflight:
                (done if p.done() else live).append((rid, p, claimed))
            self._inflight = live
        for rid, p, claimed in done:
            try:
                r = p.result(timeout=0)
                payload = _result_payload(self.name, self.epoch, r)
            except FencedError:
                continue        # the new owner re-runs it and answers
            except Exception as e:
                payload = _error_payload(self.name, self.epoch, rid, e)
            transport.write_response(self.dirs, rid, payload)
            if claimed is not None:
                try:
                    os.remove(claimed)
                except OSError:
                    pass
            with self._lock:
                self.served += 1
        return len(done)

    def run_loop(self) -> int:
        """The worker main loop until ``stop()``/SIGTERM drain or a
        fencing. Returns the process exit code (0 drained clean,
        EXIT_FENCED when a newer epoch took the log)."""
        while not self._stop.is_set():
            if self.fenced() is not None:
                break
            progressed = self._claim_one()
            progressed |= bool(self._reap())
            if not progressed:
                time.sleep(self.poll_s)
        # Drain: every acked request resolves and responds before exit
        # (claimed/ empties — the rolling-restart zero-lost-acks gate).
        deadline = time.monotonic() + 120.0
        while self._inflight and self.fenced() is None \
                and time.monotonic() < deadline:
            if not self._reap():
                time.sleep(self.poll_s)
        fe = self.fenced()
        try:
            self.engine.stop(drain=True)
        except Exception:
            pass
        if self.heartbeater is not None:
            self.heartbeater.stop()
        if fe is not None:
            serve_ha.note_fenced(fe, telemetry=self.telemetry)
            return serve_ha.EXIT_FENCED
        return 0

    # ------------------------------------------------- thread harness --

    def start(self) -> "Worker":
        self.boot()
        t = threading.Thread(target=self.run_loop,
                             name=f"cluster-worker-{self.name}",
                             daemon=True)
        with self._lock:
            self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()


def run_worker(root: str, name: str, **kw) -> int:
    """Subprocess entry (``python -m cbf_tpu_torch cluster worker``):
    build a :class:`Worker`, wire SIGTERM to the drain path, loop."""
    import signal

    w = Worker(root, name, **kw)
    w.boot()

    def _term(signum, frame):
        w._stop.set()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass                 # embedded off the main thread (tests)
    return w.run_loop()
