"""ctypes bindings for the async native trajectory sink (counterpart:
cbf_tpu/native/trajsink.py; source ``native/trajsink.cpp``).

Streaming I/O for long rollouts: the host hands float32 position chunks
to a C++ worker thread that owns the file, so the loop never blocks on
disk. The file format (``CBT1``: magic, agents, dims, frames, then the
float32 payload) is the JAX package's, so either package reads what the
other writes.

    from cbf_tpu_torch.native.trajsink import TrajectorySink, read_trajectory
    with TrajectorySink("run.cbt", n_agents=256, dims=2) as sink:
        for chunk in rollout_chunks:            # (frames, 256, 2) float32
            sink.append(chunk)
    traj = read_trajectory("run.cbt")           # (T, 256, 2)

``available()`` is False without a toolchain, and callers fall back to
host-side numpy (the CLI's ``--traj`` then writes ``.npy``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from cbf_tpu_torch.native import _BUILD_DIR, _build

_SO = os.path.join(_BUILD_DIR, "libtrajsink.so")
_HEADER_BYTES = 4 + 4 + 4 + 8
_MAGIC = b"CBT1"

_lib_cache: ctypes.CDLL | None = None
_build_err: str | None = None


def _lib() -> ctypes.CDLL:
    global _lib_cache, _build_err
    if _lib_cache is not None:
        return _lib_cache
    if _build_err is not None:
        raise RuntimeError(_build_err)
    err = _build("trajsink.cpp", "libtrajsink.so")
    if err is None and not os.path.exists(_SO):
        err = f"build produced no {_SO}"
    if err is not None:
        _build_err = err
        raise RuntimeError(err)
    lib = ctypes.CDLL(_SO)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.trajsink_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.trajsink_open.restype = ctypes.c_void_p
    lib.trajsink_append.argtypes = [ctypes.c_void_p, fp, ctypes.c_int64]
    lib.trajsink_append.restype = ctypes.c_int
    lib.trajsink_frames_written.argtypes = [ctypes.c_void_p]
    lib.trajsink_frames_written.restype = ctypes.c_int64
    lib.trajsink_close.argtypes = [ctypes.c_void_p]
    lib.trajsink_close.restype = ctypes.c_int64
    _lib_cache = lib
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except (RuntimeError, OSError):
        return False


class TrajectorySink:
    """Async binary writer of (frames, n_agents, dims) float32 chunks."""

    def __init__(self, path: str, n_agents: int, dims: int = 2):
        self._lib = _lib()
        self.path = path
        self.n_agents = int(n_agents)
        self.dims = int(dims)
        self._h = self._lib.trajsink_open(
            os.fsencode(path), self.n_agents, self.dims)
        if not self._h:
            raise OSError(f"trajsink_open failed for {path}")

    def append(self, frames) -> None:
        """Enqueue (T, n_agents, dims) — or (n_agents, dims) for one frame."""
        if self._h is None:
            raise ValueError("sink is closed")
        a = np.ascontiguousarray(frames, np.float32)
        if a.ndim == 2:
            a = a[None]
        if a.shape[1:] != (self.n_agents, self.dims):
            raise ValueError(
                f"chunk shape {a.shape} != (T, {self.n_agents}, {self.dims})")
        fp = ctypes.POINTER(ctypes.c_float)
        if self._lib.trajsink_append(self._h, a.ctypes.data_as(fp),
                                     a.shape[0]) != 0:
            raise OSError(f"trajsink write error on {self.path}")

    @property
    def frames_written(self) -> int:
        """Frames already flushed by the worker (lags append by design)."""
        if self._h is None:
            raise ValueError("sink is closed")
        return int(self._lib.trajsink_frames_written(self._h))

    def close(self) -> int:
        """Drain the queue, finalize the header; returns total frames."""
        if self._h is None:
            return -1
        frames = int(self._lib.trajsink_close(self._h))
        self._h = None
        if frames < 0:
            raise OSError(f"trajsink write error on {self.path}")
        return frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_trajectory(path: str) -> np.ndarray:
    """Read a sink file back as (T, n_agents, dims) float32."""
    with open(path, "rb") as f:
        head = f.read(_HEADER_BYTES)
        if len(head) != _HEADER_BYTES or head[:4] != _MAGIC:
            raise ValueError(f"{path}: not a CBT1 trajectory file")
        n_agents = int.from_bytes(head[4:8], "little")
        dims = int.from_bytes(head[8:12], "little")
        frames = int.from_bytes(head[12:20], "little", signed=True)
        data = np.fromfile(f, dtype=np.float32)
    expect = frames * n_agents * dims
    if frames < 0 or data.size < expect:
        raise ValueError(
            f"{path}: truncated (header says {frames} frames, "
            f"payload has {data.size} floats)")
    return data[:expect].reshape(frames, n_agents, dims)
