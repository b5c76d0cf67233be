"""Checkpoint/resume for long rollouts (counterpart:
cbf_tpu/utils/checkpoint.py, with ``torch.save`` in place of orbax).

A step lives in ``<dir>/<step>/``: ``state.pt``, a flat dict from leaf key
(:func:`cbf_tpu_torch.durable.integrity.tree_items`) to CPU tensor, and
``integrity.json``, the per-leaf SHA-256 manifest that is the commit
marker. The payload is written into a temp directory, fsynced and renamed
onto ``<step>``; the manifest is committed after it. Only plain tensors
are pickled, so :func:`restore` loads with ``torch.load(...,
weights_only=True)`` and rebuilds the caller's template (its named
tuples, ``()`` leaves and devices): a missing or extra key, a wrong shape
or dtype, a digest that differs from the manifest, or a payload that does
not load raises :class:`CheckpointCorrupt`. A restore of the latest step
walks back past corrupt steps to the newest intact one; a step with no
manifest and no loadable payload is refused ("refusing"), never restored
as fabricated state. ``max_to_keep`` steps are retained (default 2).

:class:`CheckpointWriter` takes its snapshot of the state when ``save`` is
called: each device leaf is copied into pinned host memory on the current
stream, with an event recorded after the copies, so the copy precedes any
later work on the stream — the next chunk's graph replay, which writes
the same static buffers — and the writer thread digests and writes that
snapshot once the event has passed. The manifest is digested from the
bytes that are written.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

from cbf_tpu_torch.analysis import lockwitness
from cbf_tpu_torch.durable import integrity
from cbf_tpu_torch.durable.integrity import CheckpointCorrupt

__all__ = ["CheckpointCorrupt", "CheckpointWriter", "latest_step",
           "restore", "restore_intact", "save"]

DATA_NAME = "state.pt"


def _snapshot(state: Any):
    """(key -> host tensor, CUDA event or None): device leaves copied into
    pinned memory asynchronously on the current stream, host leaves
    copied."""
    out, event = {}, None
    for key, leaf in integrity.tree_items(state):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            dst = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            dst.copy_(leaf.detach(), non_blocking=True)
            out[key] = dst
            event = event or torch.cuda.Event()
        elif isinstance(leaf, torch.Tensor):
            out[key] = leaf.detach().clone()
        else:
            out[key] = torch.from_numpy(np.array(leaf))
    if event is not None:
        event.record()
    return out, event


def _steps(directory: str) -> list[int]:
    """Every step with a finalized payload, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and os.path.isfile(
                      os.path.join(directory, name, DATA_NAME)))


def _write_step(directory: str, step: int, payload: dict,
                max_to_keep: int | None) -> None:
    """Payload into a temp dir, fsync, rename onto ``<step>`` (replacing a
    stale one), then commit the manifest digested from the same bytes and
    drop the steps beyond ``max_to_keep``."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    digests = integrity.leaf_digests(payload)
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".tmp-{step}-")
    try:
        with open(os.path.join(tmp, DATA_NAME), "wb") as fh:
            torch.save(payload, fh)
            fh.flush()
            os.fsync(fh.fileno())
        final = os.path.join(directory, str(step))
        if os.path.exists(final):
            trash = tempfile.mkdtemp(dir=directory, prefix=f".old-{step}-")
            os.replace(final, os.path.join(trash, "step"))
            os.replace(tmp, final)
            shutil.rmtree(trash, ignore_errors=True)
        else:
            os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    integrity.write_atomic(integrity.manifest_path(directory, step),
                           integrity.manifest_json(step, digests))
    if max_to_keep is not None:
        for old in _steps(directory)[:-max_to_keep]:
            shutil.rmtree(os.path.join(directory, str(old)),
                          ignore_errors=True)


def save(directory: str, step: int, state: Any, *,
         max_to_keep: int | None = 2) -> None:
    """Save a state tree under ``directory`` keyed by ``step``, synchronously
    (for repeated boundary saves use :class:`CheckpointWriter`)."""
    payload, event = _snapshot(state)
    if event is not None:
        event.synchronize()
    _write_step(directory, step, payload, max_to_keep)


class CheckpointWriter:
    """Boundary saves of one run, written on a background thread.

    ``save`` takes the snapshot (module docstring) and queues the write;
    the next device work on the stream may start at once.
    :meth:`wait_snapshot` blocks until the last snapshot's copies are done
    (a caller about to hand the saved buffers to other work on another
    stream), :meth:`wait_until_finished` until every queued step is
    committed, manifest included. A failed write raises at the next call
    (the error is handed over under ``_lock``, so none is lost between
    the writer's store and the caller's take). ``close`` drains; always
    call it (the rollout engine does, in a ``finally``)."""

    def __init__(self, directory: str, max_to_keep: int | None = 2):
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep
        self._jobs: queue.Queue = queue.Queue()
        self._lock = lockwitness.make_lock("CheckpointWriter._lock")
        self._error: BaseException | None = None
        self._event = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                step, payload, event = job
                with self._lock:
                    failed = self._error is not None
                if not failed:
                    if event is not None:
                        event.synchronize()
                    _write_step(self._dir, step, payload, self._keep)
            except BaseException as e:    # surfaced on the caller's thread
                with self._lock:
                    self._error = e
            finally:
                self._jobs.task_done()

    def _raise(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def save(self, step: int, state: Any) -> None:
        self._raise()
        payload, self._event = _snapshot(state)
        self._jobs.put((int(step), payload, self._event))

    def wait_snapshot(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def wait_until_finished(self) -> None:
        self._jobs.join()
        self._raise()

    def close(self) -> None:
        if self._thread.is_alive():
            self._jobs.put(None)
            self._thread.join()
        self._raise()


def latest_step(directory: str) -> int | None:
    """Newest step with a finalized payload in ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def _restore_step(directory: str, step: int, like: Any):
    """Restore and verify one step into ``like``'s structure and devices."""
    manifest = integrity.read_manifest(directory, step)   # garbled: raises
    path = os.path.join(os.path.abspath(directory), str(step), DATA_NAME)
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if not (isinstance(payload, dict) and all(
                isinstance(v, torch.Tensor) for v in payload.values())):
            raise ValueError("payload is not a dict of tensors")
    except Exception as e:
        if manifest is not None:
            raise CheckpointCorrupt(
                f"checkpoint under {directory} (step {step}) has a "
                f"committed integrity manifest but failed to restore: {e}",
                directory=directory, step=step) from e
        raise CheckpointCorrupt(
            f"checkpoint under {directory} (step {step}): payload "
            f"unreadable ({e}) and no integrity manifest — refusing to "
            "restore unvalidated state", directory=directory,
            step=step) from e
    template = dict(integrity.tree_items(like))
    bad = [f"{k}: missing" for k in sorted(set(template) - set(payload))]
    bad += [f"{k}: not in the template"
            for k in sorted(set(payload) - set(template))]
    for key in sorted(set(template) & set(payload)):
        want, got = template[key], payload[key]
        dtype = (want.dtype if isinstance(want, torch.Tensor)
                 else torch.from_numpy(np.array(want)).dtype)
        if tuple(got.shape) != tuple(np.shape(want)) or got.dtype != dtype:
            bad.append(f"{key}: stored {tuple(got.shape)} {got.dtype} != "
                       f"template {tuple(np.shape(want))} {dtype}")
    if bad:
        raise CheckpointCorrupt(
            f"checkpoint under {directory} (step {step}) does not match "
            "the restore template: " + "; ".join(bad),
            directory=directory, step=step)
    integrity.verify_restored(directory, step, payload, manifest=manifest)
    keys = iter(template)            # flattening order, as rebuilt

    def rebuild(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rebuild(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v) for v in node)
        value = payload[next(keys)]
        if isinstance(node, torch.Tensor):
            return value.to(node.device)
        return value.numpy()

    return rebuild(like), step


def restore(directory: str, like: Any, step: int | None = None):
    """Restore the tree saved at ``step`` (default: the newest intact one)
    into ``like``'s structure: tensor leaves come back on the template
    leaf's device, other leaves as numpy. Returns (restored, step). With
    ``step=None`` corrupt steps are skipped newest to oldest
    (:func:`restore_intact` also reports them); an explicit ``step``
    raises instead of falling back."""
    restored, found, _skipped = restore_intact(directory, like, step=step)
    return restored, found


def restore_intact(directory: str, like: Any, step: int | None = None):
    """:func:`restore` plus the corrupt steps skipped on the walk back:
    ``(restored, step, skipped)``, ``skipped`` newest first. Raises
    :class:`CheckpointCorrupt` when every step is corrupt,
    FileNotFoundError when there are none."""
    if step is not None:
        restored, found = _restore_step(directory, step, like)
        return restored, found, []
    steps = sorted(_steps(directory), reverse=True)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    skipped, errors = [], []
    for s in steps:
        try:
            restored, found = _restore_step(directory, s, like)
            return restored, found, skipped
        except CheckpointCorrupt as e:
            skipped.append(s)
            errors.append(str(e))
    raise CheckpointCorrupt(
        f"all {len(steps)} checkpoint step(s) under {directory} are "
        "corrupt: " + " | ".join(errors), directory=directory)
