"""ctypes bindings for the native host-side QP solver (counterpart:
cbf_tpu/native/__init__.py).

The C++ sources are the repository's own ``native/qp2d.cpp`` and
``native/trajsink.cpp``, which use neither framework; this package binds
them by path. It builds them with ``make -C native BUILD=<dir>`` into
``cbf_tpu_torch/csrc/_build/`` (beside the CUDA kernels' library), so it
never shares an output file with the JAX package's ``native/build/``.
Nothing is built at import: the first call that needs a library builds
it, under a file lock, so concurrent processes do not race one build.

:func:`solve_qp_2d_batch` is a float64 batched 2-D QP solver by KKT
enumeration (the algorithm of :mod:`cbf_tpu_torch.solvers.exact2d`,
host-only), for golden traces and three-way parity checks. Every entry
point degrades as the JAX package's does: :func:`available` is False
where no toolchain exists, and callers fall back to the Python oracle.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(os.path.dirname(_PKG), "native")
_BUILD_DIR = os.path.join(_PKG, "csrc", "_build")
_SO = os.path.join(_BUILD_DIR, "libqp2d.so")

_lib_cache: ctypes.CDLL | None = None
_build_err: str | None = None


def _build(src_name: str = "qp2d.cpp",
           so_name: str = "libqp2d.so") -> str | None:
    """Ensure one native library is built (per-target freshness and a
    per-target make, so a broken sibling source cannot take this
    library down). Returns None, or why the build failed."""
    src = os.path.join(_SRC_DIR, src_name)
    so = os.path.join(_BUILD_DIR, so_name)
    if not os.path.exists(src):
        return f"source missing: {src}"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        lock = open(os.path.join(_BUILD_DIR, f".{so_name}.lock"), "w")
    except OSError as e:
        return f"build directory unusable: {e}"
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(src)):
            return None
        try:
            res = subprocess.run(
                ["make", "-C", _SRC_DIR, f"BUILD={_BUILD_DIR}", so],
                capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"build failed to run: {e}"
    if res.returncode != 0:
        return f"build failed:\n{res.stdout}\n{res.stderr}"
    return None


def _lib() -> ctypes.CDLL:
    global _lib_cache, _build_err
    if _lib_cache is not None:
        return _lib_cache
    if _build_err is not None:          # failed once — don't re-spawn make
        raise RuntimeError(_build_err)
    err = _build()
    if err is not None:
        _build_err = err
        raise RuntimeError(err)
    lib = ctypes.CDLL(_SO)
    d = ctypes.POINTER(ctypes.c_double)
    lib.qp2d_solve_batch.argtypes = [
        d, d, d, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        d, ctypes.POINTER(ctypes.c_ubyte), d, d,
    ]
    lib.qp2d_solve_batch.restype = None
    _lib_cache = lib
    return lib


def available() -> bool:
    """True when the native solver is built (or buildable) and loadable."""
    try:
        _lib()
        return True
    except (RuntimeError, OSError):
        return False


def solve_qp_2d_batch(A, b, relax_mask=None, *, max_relax: int = 64,
                      tol: float = 1e-6):
    """Native ``min ||x||^2 s.t. A x <= b`` over a batch.

    Args: A (N, M, 2), b (N, M), relax_mask (N, M) or None — the contract
    of :func:`cbf_tpu_torch.solvers.exact2d.solve_qp_2d_batch`, with the
    float64 feasibility tolerance (1e-6) as default, so feasibility flags
    and relax counts agree between the two. Numpy in and out.
    Returns (x (N, 2), feasible (N,) bool, relax_rounds (N,), viol (N,)).
    """
    lib = _lib()
    A = np.ascontiguousarray(A, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    n, m = b.shape
    if A.shape != (n, m, 2):
        raise ValueError(f"A shape {A.shape} != {(n, m, 2)}")
    if relax_mask is not None:
        relax_mask = np.ascontiguousarray(relax_mask, np.float64)
        if relax_mask.shape != (n, m):
            raise ValueError(f"relax_mask shape {relax_mask.shape} != {(n, m)}")

    x = np.empty((n, 2), np.float64)
    feas = np.empty((n,), np.uint8)
    rounds = np.empty((n,), np.float64)
    viol = np.empty((n,), np.float64)

    dp = ctypes.POINTER(ctypes.c_double)
    lib.qp2d_solve_batch(
        A.ctypes.data_as(dp), b.ctypes.data_as(dp),
        relax_mask.ctypes.data_as(dp) if relax_mask is not None else None,
        n, m, max_relax, tol,
        x.ctypes.data_as(dp), feas.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        rounds.ctypes.data_as(dp), viol.ctypes.data_as(dp),
    )
    return x, feas.astype(bool), rounds, viol


def qp_backend(A, b):
    """Single-problem adapter with the :class:`cbf_tpu_torch.oracle.OracleCBF`
    ``qp_backend`` signature: (A (M, 2), b (M,)) -> (x (2,), feasible).
    The oracle's own relax loop still drives retries."""
    x, feas, _, _ = solve_qp_2d_batch(A[None], b[None])
    return x[0], bool(feas[0])
