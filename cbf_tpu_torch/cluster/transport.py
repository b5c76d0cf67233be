"""File-IPC transport between the cluster router and its engines
(counterpart: cbf_tpu/cluster/transport.py, ported whole: the same
directory layout, file names and JSON, so either package's router and
workers read each other's files).

One directory tree per engine under the cluster root:

    <root>/engines/<name>/inbox/     routed request files (unacked)
    <root>/engines/<name>/claimed/   claimed by the worker (pre-ack gate)
    <root>/engines/<name>/outbox/    response files (terminal outcomes)
    <root>/engines/<name>/journal.wal   the worker's WAL (ack authority)
    <root>/engines/<name>/lease.json    the worker's fenced lease
    <root>/engines/<name>/recovery.lock flock arbitrating journal replay
    <root>/engines/<name>/ready / pid / health.json / metrics/

Every write is atomic (temp + ``os.replace``), so a reader never sees
a half-written request or response. The load-bearing primitive is
:func:`claim`: the worker takes a request by ``os.rename`` from
``inbox/`` to ``claimed/`` — and the router's steal sweep re-routes a
request by ``os.rename`` from one inbox to another. Both are renames
OUT of the same inbox entry, so the filesystem arbitrates the race:
exactly one side wins, the loser gets ``FileNotFoundError`` and walks
away. Since the worker acknowledges (fsyncs the WAL ``submitted``
record) only AFTER its claim rename succeeded, a request the steal
sweep can still see in an inbox is by construction unacked — the
never-steal-acked invariant is not a check, it is the protocol.

Inbox filenames are ``<seq:012d>_<request_id>.json`` with the router's
monotonic sequence number, so ``sorted(listdir)`` is submission order:
workers claim oldest-first and the steal sweep relocates oldest-first.

Host-side stdlib only — no torch import (workers import the engine
lazily so the router process never touches a device).
"""

from __future__ import annotations

import json
import os

REQUEST_SUFFIX = ".json"


class EngineDirs:
    """Path bundle for one engine's transport tree (creates the
    directories on construction — idempotent)."""

    def __init__(self, root: str, name: str):
        self.root = os.path.abspath(root)
        self.name = name
        self.base = os.path.join(self.root, "engines", name)
        self.inbox = os.path.join(self.base, "inbox")
        self.claimed = os.path.join(self.base, "claimed")
        self.outbox = os.path.join(self.base, "outbox")
        self.journal = os.path.join(self.base, "journal.wal")
        self.lease = os.path.join(self.base, "lease.json")
        self.recovery_lock = os.path.join(self.base, "recovery.lock")
        self.ready = os.path.join(self.base, "ready")
        self.pid = os.path.join(self.base, "pid")
        self.health = os.path.join(self.base, "health.json")
        self.metrics = os.path.join(self.base, "metrics")
        for d in (self.inbox, self.claimed, self.outbox, self.metrics):
            os.makedirs(d, exist_ok=True)


def write_json_atomic(path: str, payload: dict) -> None:
    """Write-temp + atomic rename: a concurrent reader sees the old
    file or the new one, never a torn one."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def read_json(path: str) -> dict | None:
    """Parse one transport file; None when it vanished (claimed/stolen
    between listing and read) or is mid-replace."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (FileNotFoundError, ValueError):
        return None
    except OSError:
        return None


def request_filename(seq: int, request_id: str) -> str:
    safe = request_id.replace(os.sep, "_")
    return f"{seq:012d}_{safe}{REQUEST_SUFFIX}"


def write_request(dirs: EngineDirs, seq: int, request_id: str,
                  payload: dict) -> str:
    """Atomically deposit a routed request into ``dirs.inbox``. The
    payload carries ``request_id``, the JSON-encoded config, and the
    bucket label the router placed by."""
    path = os.path.join(dirs.inbox, request_filename(seq, request_id))
    write_json_atomic(path, payload)
    return path


def list_inbox(dirs: EngineDirs) -> list[str]:
    """Unclaimed request files, oldest (lowest sequence) first."""
    try:
        names = sorted(n for n in os.listdir(dirs.inbox)
                       if n.endswith(REQUEST_SUFFIX))
    except OSError:
        return []
    return [os.path.join(dirs.inbox, n) for n in names]


def inbox_depth(dirs: EngineDirs) -> int:
    try:
        return sum(1 for n in os.listdir(dirs.inbox)
                   if n.endswith(REQUEST_SUFFIX))
    except OSError:
        return 0


def list_claimed(dirs: EngineDirs) -> list[str]:
    """Claimed request files, oldest (lowest sequence) first."""
    try:
        names = sorted(n for n in os.listdir(dirs.claimed)
                       if n.endswith(REQUEST_SUFFIX))
    except OSError:
        return []
    return [os.path.join(dirs.claimed, n) for n in names]


def claimed_depth(dirs: EngineDirs) -> int:
    try:
        return sum(1 for n in os.listdir(dirs.claimed)
                   if n.endswith(REQUEST_SUFFIX))
    except OSError:
        return 0


def claim(dirs: EngineDirs, inbox_path: str) -> str | None:
    """The worker's side of the race: atomically move one inbox file to
    ``claimed/``. Returns the claimed path, or None when the rename
    lost (the file was stolen or already claimed). Acknowledgment (the
    WAL ``submitted`` fsync) MUST happen only after this returns a
    path — that ordering is the never-steal-acked invariant."""
    dst = os.path.join(dirs.claimed, os.path.basename(inbox_path))
    try:
        os.rename(inbox_path, dst)
    except FileNotFoundError:
        return None
    except OSError:
        return None
    return dst


def steal(src: EngineDirs, dst: EngineDirs, inbox_path: str) -> str | None:
    """The router's side of the race: atomically relocate one UNCLAIMED
    request file from ``src.inbox`` to ``dst.inbox``. Returns the new
    path, or None when the worker's claim won the rename first. A
    claimed (and therefore possibly acked) request is unreachable here
    by construction — it is no longer in the inbox."""
    new = os.path.join(dst.inbox, os.path.basename(inbox_path))
    try:
        os.rename(inbox_path, new)
    except FileNotFoundError:
        return None
    except OSError:
        return None
    return new


def write_response(dirs: EngineDirs, request_id: str,
                   payload: dict) -> str:
    """Atomically deposit a terminal outcome into ``dirs.outbox`` (the
    WAL ``resolved`` record is already durable by the time the worker
    calls this — the response file is delivery, not the ack)."""
    safe = request_id.replace(os.sep, "_")
    path = os.path.join(dirs.outbox, f"{safe}{REQUEST_SUFFIX}")
    write_json_atomic(path, payload)
    return path


def list_outbox(dirs: EngineDirs) -> list[str]:
    try:
        names = sorted(n for n in os.listdir(dirs.outbox)
                       if n.endswith(REQUEST_SUFFIX))
    except OSError:
        return []
    return [os.path.join(dirs.outbox, n) for n in names]
