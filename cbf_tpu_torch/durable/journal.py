"""Write-ahead request journal for the serve engine (counterpart:
cbf_tpu/durable/journal.py, ported whole; one file format for both
packages, so either package's :func:`replay_journal` folds the other's
journal).

A crash loses the in-memory queue; the journal makes admission durable:
every request the engine ACKNOWLEDGES (accepted by ``submit``/``run``)
appends a ``submitted`` record — flushed and fsynced before the caller
learns of the acceptance — and every terminal outcome appends a
``resolved`` record BEFORE the caller's handle is released. ``packed``
records (batch formation) are observability breadcrumbs, not required
for recovery. After a hard kill, :func:`replay_journal` folds the log
into the set of acknowledged-but-unresolved requests and
:func:`recover_into` re-enqueues them on a fresh engine — at-least-once
semantics: a request whose ``resolved`` record was lost in the crash
re-runs; none is ever silently dropped. A request whose ``resolved`` record IS on
disk is never re-enqueued — replay dedupes on request id, so from the
client's view recovery is effectively exactly-once.

Format: schema-versioned JSONL, append-only. A SIGKILL can tear at most
the FINAL line (serialized appends), so replay tolerates exactly that;
a garbled line anywhere else is real damage and raises the typed
:class:`~cbf_tpu_torch.serve.resilience.RecoveryError`. Reopening a journal
REPAIRS the tear first (truncating the torn fragment back to the last
complete record) so the next append starts on a clean line — otherwise
the first post-restart record would concatenate onto the fragment,
garbling a NON-final line and losing that acknowledged record.

High availability adds three orthogonal mechanisms:

- **Epochs + fencing**: every record carries the appending owner's
  ``epoch`` (a monotonic ownership-generation counter, default 0). A
  journal opened with ``fence_path=`` (the HA lease file, which
  :mod:`cbf_tpu_torch.serve.ha`'s lease writes) re-reads the
  fence epoch under the append lock and raises the typed
  :class:`~cbf_tpu_torch.serve.resilience.FencedError` BEFORE writing
  when a newer epoch owns the log — a SIGSTOP'd zombie primary that wakes
  after a takeover cannot corrupt the new owner's log.
- **Segment rotation**: with ``rotate_bytes=``, the active file rotates
  to ``<path>.segNNNNNN`` once it crosses the threshold (checked after
  a complete append, under the same lock, so no record straddles
  files). Replay folds rotated segments in sequence order, then the
  active file; only the LAST file's final line may be torn.
- **Compaction**: after each rotation, rotated segments whose removal
  provably leaves the recovery work list unchanged are deleted
  (:func:`compact_segments`) — a fully-resolved segment stops costing
  disk and replay time, while any segment still contributing a
  ``submitted`` or a load-bearing ``resolved`` is kept.
"""

from __future__ import annotations

import json
import os
import time

from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.durable.rollout import config_from_json, config_to_json
from cbf_tpu_torch.serve.resilience import (FencedError, RecoveryError,
                                             ServeError)

EMITTED_EVENT_TYPES = ("durable.journal", "durable.recover")

JOURNAL_SCHEMA_VERSION = 1

#: Rotated-segment suffix: ``<journal>.seg000001``, ``.seg000002``, ...
_SEG_AFFIX = ".seg"


def _fsync_dir(dirname: str) -> None:
    """Make a rename/unlink in ``dirname`` durable (POSIX: directory
    entries have their own durability)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def read_fence_epoch(path: str) -> int:
    """The current fence (owner) epoch from a lease/fence file: a JSON
    object with an integer ``epoch``. Returns -1 when the file does not
    exist (nothing has ever claimed the log — every append passes).
    A garbled fence file raises :class:`RecoveryError`: lease writes are
    atomic (write-temp + rename), so damage here is real and ownership
    can no longer be arbitrated."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return -1
    except (OSError, ValueError) as e:
        raise RecoveryError(f"unreadable fence file {path}: {e}") from e
    try:
        return int(data["epoch"])
    except (KeyError, TypeError, ValueError) as e:
        raise RecoveryError(f"fence file {path} has no integer epoch") from e


def journal_segments(path: str) -> list[str]:
    """Rotated segment paths for ``path``, oldest first (sequence
    order). The active file itself is not included."""
    d = os.path.dirname(path) or "."
    prefix = os.path.basename(path) + _SEG_AFFIX
    try:
        names = os.listdir(d)
    except OSError:
        return []
    segs = [n for n in names
            if n.startswith(prefix) and n[len(prefix):].isdigit()]
    return [os.path.join(d, n)
            for n in sorted(segs, key=lambda n: int(n[len(prefix):]))]


class RequestJournal:
    """Append-only WAL handle. ``submitted`` arrives from submitter
    threads and ``resolved`` from whichever thread resolves, so a
    journal-owned lock serializes the ``write``/``flush``/``fsync``
    triple — interleaved records mid-file would be unrecoverable damage
    (:func:`replay_journal` only forgives the final line). The fence
    check and the rotation check run under the SAME lock: an append is
    fence-checked, written whole, and only then may rotate."""

    def __init__(self, path: str, *, telemetry=None, epoch: int = 0,
                 fence_path: str | None = None,
                 rotate_bytes: int | None = None):
        self.path = os.path.abspath(path)
        self.epoch = int(epoch)
        self.fence_path = os.path.abspath(fence_path) if fence_path else None
        if rotate_bytes is not None and rotate_bytes < 1:
            raise ValueError(f"rotate_bytes must be >= 1 (or None), "
                             f"got {rotate_bytes}")
        self.rotate_bytes = rotate_bytes
        self._lock = lockwitness.make_lock("RequestJournal._lock")
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        # Open-time fencing: refuse to even open for append when a newer
        # epoch owns the log — same typed error as the append-time check.
        self._check_fence()
        repaired = 0
        existing = None
        if os.path.exists(self.path):
            repaired = repair_torn_tail(self.path)
        if os.path.exists(self.path) or journal_segments(self.path):
            existing = replay_journal(self.path)
        segs = journal_segments(self.path)
        self._next_seq = 1 if not segs else \
            int(segs[-1].rsplit(_SEG_AFFIX, 1)[1]) + 1
        self._fh = open(self.path, "a")
        if telemetry is not None:
            telemetry.event("durable.journal", {
                "path": self.path,
                "records": existing.records if existing else 0,
                "unresolved": len(existing.unresolved) if existing else 0,
                "repaired_bytes": repaired,
                "epoch": self.epoch,
                "segments": len(segs),
            })

    def _check_fence(self) -> None:
        if self.fence_path is None:
            return
        fence = read_fence_epoch(self.fence_path)
        if fence > self.epoch:
            raise FencedError(
                f"journal {self.path} is fenced: appender epoch "
                f"{self.epoch} < owner epoch {fence} — a newer owner has "
                "taken over", epoch=self.epoch, fence_epoch=fence,
                path=self.fence_path)

    def _append(self, record: dict, *, fsync: bool) -> None:
        record["schema"] = JOURNAL_SCHEMA_VERSION
        record["epoch"] = self.epoch
        record["t"] = time.time()
        line = json.dumps(record, sort_keys=True) + "\n"
        with self._lock:
            # Fencing BEFORE the write: a stale-epoch appender must not
            # put a single byte into a log a newer epoch owns.
            self._check_fence()
            self._fh.write(line)
            self._fh.flush()
            if fsync:
                os.fsync(self._fh.fileno())
            if self.rotate_bytes is not None \
                    and self._fh.tell() >= self.rotate_bytes:
                # Rotation stays inside the append critical section:
                # it only ever runs after a COMPLETE append, so rotated
                # segments never carry a torn tail, and the atomic
                # rename stays ordered against the next fence check.
                # Fully-redundant segments are compacted away
                # immediately (compaction only touches rotated,
                # immutable files).
                self._fh.close()
                seg = f"{self.path}{_SEG_AFFIX}{self._next_seq:06d}"
                os.rename(self.path, seg)
                self._next_seq += 1
                _fsync_dir(os.path.dirname(self.path))
                self._fh = open(self.path, "a")
                compact_segments(self.path)

    def submitted(self, request_id: str, cfg) -> None:
        """The acknowledgment record — durable (fsync) BEFORE the caller
        learns its request was accepted, so 'acknowledged' and
        'journaled' are the same set."""
        self._append({"type": "submitted", "request_id": request_id,
                      "config": config_to_json(cfg)}, fsync=True)

    def packed(self, bucket: str, request_ids: list[str]) -> None:
        self._append({"type": "packed", "bucket": bucket,
                      "request_ids": list(request_ids)}, fsync=False)

    def resolved(self, request_id: str,
                 error: BaseException | None = None) -> None:
        self._append({
            "type": "resolved", "request_id": request_id,
            "outcome": "error" if error is not None else "ok",
            "error_type": type(error).__name__ if error is not None else None,
        }, fsync=True)

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass


class JournalReplay:
    """Folded journal state: ``unresolved`` is the recovery work list —
    ``(request_id, config)`` for every acknowledged request with no
    terminal record, in submission order. ``resolved_counts`` counts
    ``resolved`` records per request id across the whole log (the
    duplicate-execution census: exactly-once replay means no id ever
    exceeds 1 per acknowledgment). ``max_epoch`` is the newest ownership
    epoch that has written to the log."""

    def __init__(self, records: int, submitted: dict[str, dict],
                 resolved: set[str], order: list[str],
                 resolved_counts: dict[str, int] | None = None,
                 max_epoch: int = 0):
        self.records = records
        self.submitted = submitted
        self.resolved = resolved
        self.resolved_counts = resolved_counts or {}
        self.max_epoch = max_epoch
        self.unresolved: list[tuple[str, dict]] = [
            (rid, submitted[rid]) for rid in order if rid not in resolved]

    def unresolved_configs(self):
        """The work list with configs rebuilt as ``swarm.Config``."""
        from cbf_tpu_torch.scenarios import swarm

        return [(rid, config_from_json(swarm.Config, data))
                for rid, data in self.unresolved]


def repair_torn_tail(path: str) -> int:
    """Truncate the tear a killed appender can leave — a final line with
    no trailing newline (the write died mid-append) or a newline-
    terminated final line that is not valid JSON (the buffer flushed
    partially) — back to the end of the last complete record. Returns
    the number of bytes dropped (0 when the file is already clean).

    Run before reopening a journal for append: a record concatenated
    onto a torn fragment garbles a NON-final line, which loses that
    acknowledged record and makes every later replay raise. A dropped
    fragment was never fsync-acknowledged, so no caller was told it was
    durable. Damage farther from the tail is left alone for
    :func:`replay_journal` to surface as :class:`RecoveryError`. Only
    the ACTIVE file can tear — rotation renames only after a complete
    append — so rotated segments never need repair."""
    with open(path, "rb") as fh:
        data = fh.read()
    keep = len(data)
    if not data:
        return 0
    if not data.endswith(b"\n"):
        keep = data.rfind(b"\n") + 1   # 0 when no complete line exists
    else:
        start = data.rfind(b"\n", 0, len(data) - 1) + 1
        last = data[start:]
        if last.strip():
            try:
                json.loads(last)
            except ValueError:
                keep = start
    if keep != len(data):
        with open(path, "r+b") as fh:
            fh.truncate(keep)
            fh.flush()
            os.fsync(fh.fileno())
    return len(data) - keep


def _fold_files(paths: list[str]) -> JournalReplay:
    """Fold journal files in order. Tolerates a torn final line only in
    the LAST file (the active segment — the only one a killed appender
    can tear); anything else unparseable or unknown raises
    :class:`RecoveryError`."""
    submitted: dict[str, dict] = {}
    resolved: set[str] = set()
    resolved_counts: dict[str, int] = {}
    order: list[str] = []
    records = 0
    max_epoch = 0
    for fi, path in enumerate(paths):
        with open(path) as fh:
            lines = fh.read().splitlines()
        last_file = fi == len(paths) - 1
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                if last_file and i == len(lines) - 1:
                    break  # torn final line: the write died mid-append
                raise RecoveryError(
                    f"garbled journal line {i + 1} in {path}: {e}") from e
            if rec.get("schema") != JOURNAL_SCHEMA_VERSION:
                raise RecoveryError(
                    f"journal line {i + 1} in {path} has schema "
                    f"{rec.get('schema')!r}, expected "
                    f"{JOURNAL_SCHEMA_VERSION}")
            records += 1
            max_epoch = max(max_epoch, int(rec.get("epoch", 0)))
            kind = rec.get("type")
            if kind == "submitted":
                rid = rec["request_id"]
                if rid not in submitted:
                    order.append(rid)
                submitted[rid] = rec["config"]
                resolved.discard(rid)  # a re-submit (recovery) reopens it
            elif kind == "resolved":
                rid = rec["request_id"]
                resolved.add(rid)
                resolved_counts[rid] = resolved_counts.get(rid, 0) + 1
            elif kind != "packed":
                raise RecoveryError(
                    f"journal line {i + 1} in {path} has unknown record "
                    f"type {kind!r}")
    return JournalReplay(records, submitted, resolved, order,
                         resolved_counts, max_epoch)


def replay_journal(path: str) -> JournalReplay:
    """Fold a journal — rotated segments in sequence order, then the
    active file. Tolerates a torn FINAL line of the LAST file (the only
    tear a killed single appender can produce); anything else
    unparseable, no files at all, or an unknown schema raises
    :class:`RecoveryError`. A missing active file with rotated segments
    present is fine (a kill can land between rotation's rename and the
    new active file's creation)."""
    files = journal_segments(path)
    if os.path.exists(path):
        files = files + [path]
    if not files:
        raise RecoveryError(f"no request journal at {path}")
    return _fold_files(files)


def compact_segments(path: str) -> list[str]:
    """Delete rotated segments whose removal leaves the recovery work
    list unchanged, oldest first. The invariant IS the check: a segment
    is dropped only when replaying without it yields the identical
    ``unresolved`` list — which covers both directions of damage a
    naive rule invites (dropping a segment that still holds the only
    ``submitted`` for an unresolved id would lose an acknowledged
    request; dropping one that holds the only ``resolved`` for an id
    submitted elsewhere would resurrect it). Returns the removed paths.
    Safe to run while the active file is open for append: only rotated
    (immutable) segments are ever removed."""
    segs = journal_segments(path)
    if not segs:
        return []
    keep = list(segs)
    if os.path.exists(path):
        keep.append(path)
    baseline = _fold_files(keep).unresolved
    removed: list[str] = []
    for seg in segs:
        trial = [f for f in keep if f != seg]
        if trial and _fold_files(trial).unresolved == baseline:
            os.remove(seg)
            keep = trial
            removed.append(seg)
    if removed:
        _fsync_dir(os.path.dirname(path))
    return removed


def ship_segments(src_path: str, dst_path: str) -> int:
    """Ship journal bytes from a primary's journal to a standby replica
    directory: every rotated segment and the active file whose replica
    is missing or differs in size is copied whole (write-temp + atomic
    rename, so a reader of the replica never sees a half-shipped file).
    Returns the number of bytes copied (0 when the replica is already
    current). The standby tails this — cheap to call in a poll loop."""
    d = os.path.dirname(os.path.abspath(dst_path))
    if d:
        os.makedirs(d, exist_ok=True)
    shipped = 0
    pairs = [(seg, dst_path + _SEG_AFFIX + seg.rsplit(_SEG_AFFIX, 1)[1])
             for seg in journal_segments(src_path)]
    if os.path.exists(src_path):
        pairs.append((src_path, dst_path))
    for src, dst in pairs:
        try:
            src_size = os.path.getsize(src)
        except OSError:
            continue   # rotated away between listing and stat
        if os.path.exists(dst) and os.path.getsize(dst) == src_size:
            continue
        with open(src, "rb") as fh:
            data = fh.read()
        tmp = dst + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, dst)
        shipped += len(data)
    if shipped:
        _fsync_dir(d)
    return shipped


def recover_into(engine, journal_path: str) -> list:
    """Re-enqueue every acknowledged-but-unresolved request from
    ``journal_path`` onto a started ``engine`` (which should itself be
    journaling — usually to the same path — so the recovered requests'
    outcomes are journaled too). Request-id dedupe is the replay fold
    itself: an id already carrying a ``resolved`` record is NOT in the
    work list and is never re-executed — effectively exactly-once from
    the client's view. A request the recovering engine refuses at
    admission (shed, quarantined) is resolved as that typed error and
    journaled — refused, but never silently lost. Returns the list of
    re-enqueued :class:`~cbf_tpu_torch.serve.engine.PendingRequest` handles
    and emits one ``durable.recover`` event."""
    replay = replay_journal(journal_path)
    pendings = []
    refused = 0
    seen: set[str] = set()
    for rid, cfg in replay.unresolved_configs():
        if rid in seen:     # belt-and-braces: one execution per id
            continue
        seen.add(rid)
        try:
            pendings.append(engine.submit(cfg, request_id=rid))
        except ServeError as e:
            refused += 1
            if engine.journal is not None:
                engine.journal.resolved(rid, e)
    telemetry = getattr(engine, "telemetry", None)
    if telemetry is not None:
        telemetry.event("durable.recover", {
            "path": os.path.abspath(journal_path),
            "records": replay.records,
            "reenqueued": len(pendings),
            "refused": refused,
        })
    return pendings
