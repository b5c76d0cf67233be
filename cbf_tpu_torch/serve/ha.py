"""High availability: supervised primary/standby failover for ServeEngine
(counterpart: cbf_tpu/serve/ha.py, ported whole; the lease file and its
``.beat`` sidecar keep the JAX package's format, so either package reads
the other's lease).

The resilience ladder survives faults inside one engine process and the
write-ahead journal recovers a dead engine after the fact; this module
notices that the engine died, takes over for it, and keeps a zombie's
late writes out of the journal — the lease/fencing/log-shipping shape of
replicated-log systems, composed from the existing pieces:

- :class:`Lease` — a fsync'd lease file holding a MONOTONIC epoch plus a
  heartbeat counter in a sidecar. Every ``acquire`` bumps the epoch
  atomically (write-temp + rename + fsync), and the lease file doubles as
  the journal's fence (`durable.journal.RequestJournal(fence_path=...)`):
  the moment a standby acquires, every append the old owner attempts
  raises the typed :class:`~cbf_tpu_torch.serve.resilience.FencedError`
  before a byte lands. A paused (SIGSTOP) zombie that wakes after a
  takeover is fenced at the log, not merely assumed dead.
- :class:`LeaseMonitor` — the observer side of expiry. Expiry is judged
  by CHANGE, not by comparing wall clocks across machines: the monitor
  stamps each observed ``(epoch, beat)`` change on its OWN monotonic clock
  and declares the lease expired after ``ttl_s`` without change. A clock
  rebase (the observer's clock restarting from ~0) re-stamps instead of
  mis-firing.
- :class:`Heartbeater` — the primary's daemon thread renewing the lease
  every ``interval_s``; it refuses to renew over a NEWER epoch (that
  would un-fence a fenced zombie) and parks itself fenced instead.
- :func:`take_over` / :class:`Standby` — the hot standby: initialises its
  device, captures the buckets of the journal's acknowledged configs
  (``prewarm()``), tails shipped journal segments
  (`durable.journal.ship_segments`), and on lease expiry bumps the epoch,
  replays acknowledged-but-unresolved entries with request-id dedupe (an
  id already carrying a ``resolved`` record is never re-executed) and
  resumes serving under its own epoch. Every takeover emits an
  ``ha.takeover`` event and a flight-recorder capsule with the measured
  ``mttr_s`` (expiry detection -> serving resumed).
- :class:`Supervisor` — ``python -m cbf_tpu_torch serve --supervised``:
  restarts a crashed primary with exponential backoff and a crash-loop
  breaker (too many crashes inside ``crash_window_s`` — exit 3), never
  restarts a FENCED primary (exit 4: a newer epoch owns the log), and
  relies on the engine's persisted resilience state (quarantine table and
  circuit breakers beside the journal) so a poison signature cannot
  re-burn its quarantine threshold after each crash.

Where the port differs: the JAX standby prewarms through the persistent
compilation cache, so its captures are cheap; a CUDA graph does not
outlive its process, so the port's standby pays its own CUDA init (before
it reports ready) and captures each acknowledged bucket itself on its
tail passes, while the primary still serves. Everything here is host
code; the only device work is the engine's own (and the standby's CUDA
init).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import threading
import time
from typing import Any, Callable, NamedTuple

from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.serve.resilience import FencedError

#: Generic telemetry event types this module emits (AUD001-audited
#: against obs.schema.HA_EVENT_TYPES).
EMITTED_EVENT_TYPES: tuple[str, ...] = (
    "ha.lease", "ha.takeover", "ha.fenced", "ha.restart", "ha.crash_loop")

LEASE_SCHEMA_VERSION = 1

#: CLI exit code of a FENCED primary (superseded by a newer epoch): the
#: supervisor must NOT restart it — the standby owns the log now.
EXIT_FENCED = 4
#: CLI exit code of a tripped crash-loop breaker (actionable finding,
#: same convention as the other exit-3 verdicts).
EXIT_CRASH_LOOP = 3


class LeaseState(NamedTuple):
    """One parsed lease: the owning ``epoch`` (monotonic ownership
    generation) and ``owner`` string (diagnostic only — the epoch is
    the authority) from the lease file, plus the ``beat`` heartbeat
    counter from the ``.beat`` sidecar (bumped by every renewal; expiry
    is judged by beat/epoch CHANGE, not by wall time; 0 when the
    sidecar is missing or belongs to an older epoch) and ``t_wall``
    (the owner's wall stamp, for humans)."""
    epoch: int
    owner: str
    beat: int
    t_wall: float


def beat_path(path: str) -> str:
    """The heartbeat sidecar beside a lease file (see :class:`Lease`:
    renewals never rewrite the epoch-authority file)."""
    return path + ".beat"


def read_lease(path: str) -> LeaseState | None:
    """Parse a lease file + its ``.beat`` sidecar; None when the lease
    does not exist yet. Both writes are atomic (temp + rename), so a
    garbled file is real damage and raises ValueError rather than being
    silently treated as absent. A beat sidecar stamped with an OLDER
    epoch is a fenced zombie's late renewal — it counts as no beat at
    all, never as liveness for the current epoch."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable lease file {path}: {e}") from e
    epoch = int(data["epoch"])
    beat = 0
    try:
        with open(beat_path(path)) as fh:
            bdata = json.load(fh)
        if int(bdata.get("epoch", -1)) == epoch:
            beat = int(bdata.get("beat", 0))
    except FileNotFoundError:
        pass
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable lease beat file "
                         f"{beat_path(path)}: {e}") from e
    return LeaseState(epoch, str(data.get("owner", "")), beat,
                      float(data.get("t_wall", 0.0)))


class Lease:
    """Writer handle on the lease file (one per would-be owner).

    ``acquire()`` bumps the on-disk epoch and makes this instance the
    owner; ``heartbeat()`` renews (bumps ``beat``) — refusing, with
    :class:`FencedError`, to renew past a NEWER epoch. All writes are
    fsync'd write-temp + atomic rename + fsync'd directory entry, so a
    reader (or the journal's fence check) never sees a half-written
    file. The instance lock guards only the ``epoch``/``beat`` counters
    shared with the heartbeat thread — never file I/O: every write is
    an atomic whole-file rename, so racing writers can interleave
    freely and readers still see only complete states (a stale-epoch
    sidecar losing the race is discarded, see below).

    Two defenses keep the fence from ever rolling backwards:

    - The epoch lives in the lease file, written ONLY by ``acquire()``
      under an ``fcntl.flock`` on ``<path>.lock`` — concurrent
      acquirers serialize, so read-increment-write cannot lose an
      update and epochs are strictly monotonic.
    - Heartbeats write ONLY the ``.beat`` sidecar. The renewal's fence
      check is advisory — a process can be SIGSTOPped between the check
      and the write and resume after a takeover — so the write it
      guards must be harmless when stale: a late beat stamped with the
      old epoch is ignored by every reader (see :func:`read_lease`),
      while the epoch-authority file, which fences the journal, is
      untouched. The zombie's NEXT renewal observes the newer epoch and
      parks fenced."""

    def __init__(self, path: str, *, owner: str | None = None,
                 telemetry=None):
        self.path = os.path.abspath(path)
        self.owner = owner if owner is not None else f"pid{os.getpid()}"
        self.telemetry = telemetry
        self.epoch: int | None = None   # None until acquire()
        self._beat = 0
        self._lock = lockwitness.make_lock("Lease._lock")
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    def _write_file(self, path: str, payload: dict) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def acquire(self) -> int:
        """Claim ownership: bump the on-disk epoch (0 when no lease file
        exists yet) and reset the heartbeat sidecar. Returns the new
        epoch. This single fsync'd write IS the fence: every journal
        append the previous owner attempts from here on raises
        :class:`FencedError`. The whole read-increment-write runs under
        an exclusive flock so racing acquirers get distinct, strictly
        increasing epochs."""
        import fcntl

        lockfd = os.open(f"{self.path}.lock",
                         os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(lockfd, fcntl.LOCK_EX)
            prior = read_lease(self.path)
            epoch = (prior.epoch if prior else 0) + 1
            t_wall = round(time.time(), 6)
            # Sidecar first: when the new epoch becomes visible its
            # beat history is already reset.
            self._write_file(beat_path(self.path), {
                "epoch": epoch, "beat": 0, "t_wall": t_wall})
            self._write_file(self.path, {
                "schema": LEASE_SCHEMA_VERSION, "epoch": epoch,
                "owner": self.owner, "t_wall": t_wall})
        finally:
            os.close(lockfd)   # releases the flock
        with self._lock:
            self.epoch = epoch
            self._beat = 0
        if self.telemetry is not None:
            self.telemetry.event("ha.lease", {
                "path": self.path, "epoch": epoch, "owner": self.owner,
                "action": "acquire"})
        return epoch

    def heartbeat(self) -> None:
        """Renew the lease (bump ``beat`` in the sidecar). Raises
        :class:`FencedError` — WITHOUT writing — when the on-disk epoch
        has moved past ours: a takeover happened. Even when this check
        races a takeover (stopped between check and write), the write
        only touches the sidecar at OUR stale epoch — readers discard
        it and the fence stands (see the class docstring)."""
        with self._lock:
            if self.epoch is None:
                raise RuntimeError("heartbeat before acquire()")
            epoch = self.epoch
            self._beat += 1
            beat = self._beat
        current = read_lease(self.path)
        if current is not None and current.epoch > epoch:
            raise FencedError(
                f"lease {self.path} now owned by epoch "
                f"{current.epoch} (ours: {epoch}) — refusing to "
                "renew over a newer owner", epoch=epoch,
                fence_epoch=current.epoch, path=self.path)
        self._write_file(beat_path(self.path), {
            "epoch": epoch, "beat": beat,
            "t_wall": round(time.time(), 6)})


class LeaseMonitor:
    """Expiry observer on the standby's OWN monotonic clock.

    Wall clocks are not comparable across processes, so expiry is never
    ``now - t_wall``: each :meth:`poll` that observes a CHANGED
    ``(epoch, beat)`` re-stamps ``clock()``, and :meth:`expired` is true
    once ``ttl_s`` passes with no change after at least one observation.
    ``clock`` is injectable (default ``time.monotonic``); a rebased
    clock (elapsed going negative — the `obs.trace.Tracer` epoch
    restart shape) re-stamps instead of mis-declaring expiry."""

    def __init__(self, path: str, *, ttl_s: float,
                 clock: Callable[[], float] | None = None):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.path = os.path.abspath(path)
        self.ttl_s = ttl_s
        self._clock = clock if clock is not None else time.monotonic
        self._last: tuple[int, int] | None = None
        self._last_change: float | None = None

    def poll(self) -> LeaseState | None:
        """Read the lease; stamp the local clock when (epoch, beat)
        changed. Returns the parsed state (None while no lease file
        exists)."""
        state = read_lease(self.path)
        if state is None:
            return None
        key = (state.epoch, state.beat)
        if key != self._last:
            self._last = key
            self._last_change = self._clock()
        return state

    def expired(self) -> bool:
        """True once ``ttl_s`` has elapsed on the local clock since the
        last observed heartbeat change (requires at least one prior
        observation — a lease that never existed cannot expire)."""
        if self._last_change is None:
            return False
        elapsed = self._clock() - self._last_change
        if elapsed < 0:       # clock rebase: re-stamp, never mis-fire
            self._last_change = self._clock()
            return False
        return elapsed >= self.ttl_s


class Heartbeater:
    """The primary's lease-renewal daemon thread: beat every
    ``interval_s`` until stopped — or until a renewal is FENCED (a
    takeover happened while we were stalled), after which it stops
    beating and parks the error in ``self.fenced`` for the foreground
    to observe. The thread itself never touches the engine or the
    journal; fencing the data path is the journal's own append check."""

    def __init__(self, lease: Lease, *, interval_s: float = 0.2):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.lease = lease
        self.interval_s = interval_s
        self.fenced: FencedError | None = None
        self._stop = lockwitness.make_event("Heartbeater._stop")
        self._lock = lockwitness.make_lock("Heartbeater._lock")
        self._thread: threading.Thread | None = None

    def start(self) -> "Heartbeater":
        t = threading.Thread(target=self._run, name="ha-heartbeat",
                             daemon=True)
        # Publish the handle under the lock: a concurrent stop() must
        # never observe a started heartbeater with _thread still None.
        with self._lock:
            self._thread = t
        t.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.lease.heartbeat()
            except FencedError as e:
                self.fenced = e
                return
            except OSError:
                continue   # transient fs hiccup: retry on the next beat

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()   # join OUTSIDE the lock: the thread may be mid-beat


def note_fenced(err: FencedError, *, telemetry=None, flight=None) -> None:
    """Record a fencing rejection on the way out of a fenced process:
    one ``ha.fenced`` event plus a flight capsule. The caller (the CLI
    primary path) then exits :data:`EXIT_FENCED` so the supervisor knows
    NOT to restart it."""
    if telemetry is not None:
        telemetry.event("ha.fenced", {
            "epoch": err.epoch, "fence_epoch": err.fence_epoch,
            "path": err.path})
    if flight is not None:
        flight.trip("ha.fenced",
                    f"journal append fenced: epoch {err.epoch} < owner "
                    f"epoch {err.fence_epoch}")


@dataclasses.dataclass
class TakeoverReport:
    """One completed takeover: the new ``epoch`` vs the fenced
    ``prev_epoch``, how many journal ``records`` were folded, how many
    acknowledged-but-unresolved requests were ``reenqueued``, how many
    already-resolved ids the replay ``deduped`` (never re-executed),
    and the measured ``mttr_s`` (expiry detection -> serving resumed).
    ``pendings`` holds the re-enqueued request handles."""
    epoch: int
    prev_epoch: int
    records: int
    reenqueued: int
    deduped: int
    mttr_s: float
    pendings: list = dataclasses.field(default_factory=list)


def take_over(*, lease: Lease, journal_path: str, engine,
              rotate_bytes: int | None = None, telemetry=None,
              flight=None, t_detect: float | None = None) -> TakeoverReport:
    """Promote ``engine`` (built WITHOUT a journal) to primary: bump the
    lease epoch (this fences the old owner), open the journal under the
    new epoch with the lease as its fence, replay
    acknowledged-but-unresolved entries with request-id dedupe, and
    resume serving. ``t_detect`` (a ``time.monotonic`` stamp of when
    expiry was detected) anchors the reported MTTR; defaults to entry
    into this function."""
    t0 = t_detect if t_detect is not None else time.monotonic()
    prior = read_lease(lease.path)
    prev_epoch = prior.epoch if prior is not None else 0
    epoch = lease.acquire()
    from cbf_tpu_torch.durable.journal import RequestJournal, replay_journal

    journal = RequestJournal(journal_path, telemetry=telemetry, epoch=epoch,
                             fence_path=lease.path, rotate_bytes=rotate_bytes)
    engine.journal = journal
    replay = replay_journal(journal_path)
    deduped = sum(1 for rid in replay.submitted if rid in replay.resolved)
    if not engine._running:
        engine.start()
    pendings = engine.recover(journal_path)
    mttr_s = round(time.monotonic() - t0, 6)
    report = TakeoverReport(epoch=epoch, prev_epoch=prev_epoch,
                            records=replay.records,
                            reenqueued=len(pendings), deduped=deduped,
                            mttr_s=mttr_s, pendings=pendings)
    if telemetry is not None:
        telemetry.event("ha.takeover", {
            "epoch": epoch, "prev_epoch": prev_epoch,
            "records": report.records, "reenqueued": report.reenqueued,
            "deduped": report.deduped, "mttr_s": mttr_s})
    if flight is not None:
        flight.trip("ha.takeover",
                    f"standby took over at epoch {epoch} (prev "
                    f"{prev_epoch}): {report.reenqueued} re-enqueued, "
                    f"{report.deduped} deduped, mttr {mttr_s:.3f}s")
    return report


def warm_device(device) -> None:
    """Initialise the CUDA context on ``device`` (a no-op off the card):
    the standby pays this before it reports ready, so a takeover never
    waits on it, and the CLI's primary before it takes the lease, so the
    initialisation cannot starve its first heartbeats."""
    if getattr(device, "type", None) != "cuda":
        return
    import torch

    torch.cuda.init()
    with torch.cuda.device(device):
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)


class Standby:
    """Hot standby: initialise the device, capture, tail, watch, take over.

    The run loop (a) ships journal segments to ``replica_path`` when
    configured (`durable.journal.ship_segments` — the log-shipping leg;
    with primary and standby on one filesystem it tails ``journal_path``
    directly), (b) captures the buckets of every acknowledged config it
    sees in the journal (``engine.prewarm``: idempotent, so the programs
    are HOT before the failure — this process captures its own graphs),
    and (c) polls the :class:`LeaseMonitor`; on expiry it runs
    :func:`take_over` and returns the report. ``stop()`` (any thread)
    ends the loop without a takeover."""

    def __init__(self, *, lease_path: str, journal_path: str,
                 engine_factory: Callable[[], Any], ttl_s: float = 2.0,
                 poll_s: float = 0.05, owner: str = "standby",
                 replica_path: str | None = None,
                 rotate_bytes: int | None = None, telemetry=None,
                 flight=None, clock: Callable[[], float] | None = None):
        self.lease = Lease(lease_path, owner=owner, telemetry=telemetry)
        self.journal_path = os.path.abspath(journal_path)
        self.replica_path = (os.path.abspath(replica_path)
                             if replica_path else None)
        self.engine_factory = engine_factory
        self.poll_s = poll_s
        self.rotate_bytes = rotate_bytes
        self.telemetry = telemetry
        self.flight = flight
        self.monitor = LeaseMonitor(lease_path, ttl_s=ttl_s, clock=clock)
        self.engine = None
        self._stop = lockwitness.make_event("Standby._stop")
        self._prewarmed_rids: set[str] = set()

    def stop(self) -> None:
        self._stop.set()

    def _tail_once(self) -> None:
        """One tail pass: ship (when replicating), then prewarm any
        newly acknowledged configs' buckets. Reads never block the
        primary — shipping copies whole immutable segments and the
        replay fold tolerates the active file's torn tail."""
        from cbf_tpu_torch.durable import journal as dj

        read_path = self.journal_path
        if self.replica_path is not None:
            dj.ship_segments(self.journal_path, self.replica_path)
            read_path = self.replica_path
        try:
            replay = dj.replay_journal(read_path)
        except (dj.RecoveryError, OSError):
            return   # no journal yet (primary not up) — nothing to warm
        fresh = [rid for rid in replay.submitted
                 if rid not in self._prewarmed_rids]
        if not fresh:
            return
        from cbf_tpu_torch.scenarios import swarm
        from cbf_tpu_torch.durable.rollout import config_from_json

        cfgs = []
        for rid in fresh:
            try:
                cfgs.append(config_from_json(swarm.Config,
                                             replay.submitted[rid]))
            except (TypeError, ValueError):
                continue   # unwarmable config: recovery will surface it
            self._prewarmed_rids.add(rid)
        if cfgs:
            self.engine.prewarm(cfgs)

    def run(self, *, max_wait_s: float | None = None,
            on_ready: Callable[[], None] | None = None
            ) -> TakeoverReport | None:
        """Block until takeover (returns the report), ``stop()`` or
        ``max_wait_s`` (returns None). ``on_ready`` fires once after
        the device's initialisation and the first tail/prewarm pass —
        the harness hook that says the standby is HOT and the chaos can
        start."""
        if self.engine is None:
            self.engine = self.engine_factory()
        t_start = time.monotonic()
        warm_device(getattr(self.engine, "device", None))
        self._tail_once()
        if on_ready is not None:
            on_ready()
        while not self._stop.wait(self.poll_s):
            self._tail_once()
            self.monitor.poll()
            if self.monitor.expired():
                t_detect = time.monotonic()
                return take_over(
                    lease=self.lease, journal_path=self.journal_path,
                    engine=self.engine, rotate_bytes=self.rotate_bytes,
                    telemetry=self.telemetry, flight=self.flight,
                    t_detect=t_detect)
            if max_wait_s is not None \
                    and time.monotonic() - t_start >= max_wait_s:
                return None
        return None


class Supervisor:
    """Restart a crashed primary subprocess with exponential backoff and
    a crash-loop breaker.

    Exit contract: child exit 0 ends supervision (clean); child exit
    :data:`EXIT_FENCED` is passed through WITHOUT restarting (a newer
    epoch owns the log — restarting would only fence again and fight
    the standby); any other exit is a crash: backoff
    ``min(backoff_base_s * backoff_factor**attempt, backoff_max_s)``
    then restart, with the attempt counter reset after a run that
    stayed up past ``crash_window_s`` (a long-healthy child earns a
    fresh budget). More than ``max_restarts`` crashes inside a rolling
    ``crash_window_s`` trips the breaker: one ``ha.crash_loop`` event,
    a flight capsule, and return :data:`EXIT_CRASH_LOOP` — restart
    storms must become an operator page, not an infinite loop. Each
    restart emits ``ha.restart`` with the crash's exit code, uptime and
    the backoff applied."""

    def __init__(self, argv: list[str], *, backoff_base_s: float = 0.2,
                 backoff_factor: float = 2.0, backoff_max_s: float = 5.0,
                 max_restarts: int = 5, crash_window_s: float = 30.0,
                 telemetry=None, flight=None, popen=subprocess.Popen):
        if max_restarts < 1:
            raise ValueError(f"max_restarts must be >= 1, "
                             f"got {max_restarts}")
        self.argv = list(argv)
        self.backoff_base_s = backoff_base_s
        self.backoff_factor = backoff_factor
        self.backoff_max_s = backoff_max_s
        self.max_restarts = max_restarts
        self.crash_window_s = crash_window_s
        self.telemetry = telemetry
        self.flight = flight
        self._popen = popen
        self.restarts = 0

    def run(self) -> int:
        attempt = 0
        crash_times: list[float] = []
        while True:
            t0 = time.monotonic()
            proc = self._popen(self.argv)
            rc = proc.wait()
            uptime_s = time.monotonic() - t0
            if rc == 0:
                return 0
            if rc == EXIT_FENCED:
                return EXIT_FENCED
            now = time.monotonic()
            crash_times.append(now)
            crash_times = [t for t in crash_times
                           if now - t <= self.crash_window_s]
            if len(crash_times) > self.max_restarts:
                if self.telemetry is not None:
                    self.telemetry.event("ha.crash_loop", {
                        "restarts": len(crash_times) - 1,
                        "window_s": self.crash_window_s})
                if self.flight is not None:
                    self.flight.trip(
                        "ha.crash_loop",
                        f"primary crashed {len(crash_times)} times within "
                        f"{self.crash_window_s}s — breaker tripped, not "
                        "restarting")
                return EXIT_CRASH_LOOP
            if uptime_s >= self.crash_window_s:
                attempt = 0   # a long-healthy run earns a fresh budget
            backoff_s = min(
                self.backoff_base_s * self.backoff_factor ** attempt,
                self.backoff_max_s)
            attempt += 1
            self.restarts += 1
            if self.telemetry is not None:
                self.telemetry.event("ha.restart", {
                    "attempt": attempt, "exit_code": rc,
                    "backoff_s": round(backoff_s, 4),
                    "uptime_s": round(uptime_s, 4)})
            time.sleep(backoff_s)
