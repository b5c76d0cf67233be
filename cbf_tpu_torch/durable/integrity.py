"""Integrity manifests over checkpoints (counterpart:
cbf_tpu/durable/integrity.py).

At save time :func:`write_manifest` records a SHA-256 digest plus shape and
dtype for every leaf of the saved tree, keyed by name path, and commits the
manifest atomically (temp file + fsync + ``os.replace``) inside the step
directory (``<dir>/<step>/integrity.json``), so retention deletes it with
the step and a manifest's existence marks a fully committed save. At
restore time :func:`verify_restored` re-digests the restored leaves: any
divergence (bit rot, truncation, a torn write) is a typed
:class:`CheckpointCorrupt`, never silently wrong state.

Digests cover the exact host bytes (``leaf -> numpy -> tobytes()``), and
the manifest schema and leaf keys are the JAX package's: a float32 state
made from the same arrays digests to the same manifest in both packages.
The key of a leaf is its path of namedtuple field names, dict keys and
sequence indices joined by ``/``, where index 0 is written ``[0]`` and
every other index bare (``certificate_solver_state/[0]``,
``certificate_solver_state/1``) — the JAX package's rule, which takes
``str(SequenceKey(0))`` because index 0 is falsy.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Iterator

import numpy as np
import torch

MANIFEST_NAME = "integrity.json"
MANIFEST_SCHEMA_VERSION = 1


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity verification: a leaf digest mismatched
    its manifest, the step's data is unreadable despite a committed
    manifest, or neither a readable payload nor a manifest exists to
    validate against (fail closed)."""

    def __init__(self, message: str, *, directory: str | None = None,
                 step: int | None = None):
        super().__init__(message)
        self.directory = directory
        self.step = step


def _index_part(i: int) -> str:
    return "[0]" if i == 0 else str(i)


def tree_items(tree: Any, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(key, leaf) for every leaf of a tree of (named) tuples, lists and
    dicts (sorted keys) in flattening order; ``()`` and None hold no
    leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from tree_items(v, prefix + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_items(v, prefix + (_index_part(i),))
    else:
        yield "/".join(prefix), tree


def host_array(leaf: Any) -> np.ndarray:
    """A leaf's host bytes as numpy (tensors copied off their device)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()


def leaf_digests(tree: Any) -> dict[str, dict]:
    """Per-leaf integrity records: key -> {sha256, shape, dtype}."""
    out = {}
    for key, leaf in tree_items(tree):
        arr = host_array(leaf)
        out[key] = {"sha256": _digest(arr), "shape": list(arr.shape),
                    "dtype": str(arr.dtype)}
    return out


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), str(step), MANIFEST_NAME)


def _commit(path: str, suffix: str, mode: str, write) -> None:
    """Write through a temp file in the target directory (rename must not
    cross filesystems), fsync it, then ``os.replace`` it onto ``path``: a
    kill mid-write leaves the old file or the new one, never a torn
    half."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=suffix)
    try:
        with os.fdopen(fd, mode) as fh:
            write(fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_atomic(path: str, data: str) -> None:
    """Commit the text ``data`` to ``path`` atomically."""
    _commit(path, "~", "w", lambda fh: fh.write(data))


def write_npz_atomic(path: str, arrays: dict[str, Any]) -> None:
    """:func:`write_atomic` for an npz payload."""
    _commit(path, ".npz~", "wb", lambda fh: np.savez(fh, **arrays))


def manifest_json(step: int, leaves: dict[str, dict]) -> str:
    """Serialized manifest from precomputed :func:`leaf_digests` records
    (the writer digests its snapshot, then commits after the data)."""
    return json.dumps({"schema": MANIFEST_SCHEMA_VERSION, "step": int(step),
                       "algorithm": "sha256", "leaves": leaves},
                      sort_keys=True)


def write_manifest(directory: str, step: int, state: Any) -> dict:
    """Digest ``state`` and atomically commit the manifest for ``step``.
    Call only after the step's data is on disk — the manifest is the
    commit marker."""
    leaves = leaf_digests(state)
    write_atomic(manifest_path(directory, step), manifest_json(step, leaves))
    return {"schema": MANIFEST_SCHEMA_VERSION, "step": int(step),
            "algorithm": "sha256", "leaves": leaves}


def read_manifest(directory: str, step: int) -> dict | None:
    """The committed manifest for ``step``, or None when there is none. An
    unreadable or garbled manifest is :class:`CheckpointCorrupt`: the
    atomic commit cannot produce one, so damage did."""
    path = manifest_path(directory, step)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            manifest = json.load(fh)
        if manifest["schema"] != MANIFEST_SCHEMA_VERSION:
            raise CheckpointCorrupt(
                f"integrity manifest schema {manifest['schema']} != "
                f"{MANIFEST_SCHEMA_VERSION} at {path}",
                directory=directory, step=step)
        manifest["leaves"]
        return manifest
    except CheckpointCorrupt:
        raise
    except Exception as e:
        raise CheckpointCorrupt(
            f"unreadable integrity manifest at {path}: {e}",
            directory=directory, step=step) from e


def manifest_shapes(manifest: dict) -> dict[tuple, tuple]:
    """Name-path -> shape of every leaf the manifest records."""
    return {tuple(k.split("/")): tuple(rec["shape"])
            for k, rec in manifest["leaves"].items()}


def verify_restored(directory: str, step: int, restored: Any,
                    *, manifest: dict | None = None) -> bool:
    """Re-digest ``restored`` against the step's manifest. Returns False
    when no manifest exists (nothing to check); raises
    :class:`CheckpointCorrupt` listing every divergent leaf otherwise.
    Leaves present on one side only are ignored."""
    if manifest is None:
        manifest = read_manifest(directory, step)
    if manifest is None:
        return False
    want = manifest["leaves"]
    bad = []
    for key, leaf in tree_items(restored):
        rec = want.get(key)
        if rec is None:
            continue
        arr = host_array(leaf)
        digest = _digest(arr)
        if digest != rec["sha256"]:
            bad.append(f"{key}: restored sha256 {digest[:12]}… != saved "
                       f"{rec['sha256'][:12]}… (shape {list(arr.shape)} vs "
                       f"saved {rec['shape']})")
    if bad:
        raise CheckpointCorrupt(
            f"checkpoint under {directory} (step {step}) failed integrity "
            "verification: " + "; ".join(bad),
            directory=directory, step=step)
    return True
