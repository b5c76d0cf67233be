"""Start a world of ranks on this machine and collect what each returns.

The JAX package runs its mesh as SPMD in one process over virtual
devices; the port runs one process per mesh slot. :func:`run_world`
starts ``world_size`` fresh Python processes, joins them with
:func:`cbf_tpu_torch.parallel.multihost.initialize` over a file store
(no TCP port, so concurrent worlds never collide), calls
``module:function(*args, **kwargs)`` on every rank, and returns the ranks'
results in rank order. A rank that raises fails the world: the others are
stopped (they would wait in a collective forever) and :class:`RankError`
carries the first failed rank's traceback. ``timeout_s`` bounds the whole
world the same way.

Each rank runs on ``threads`` torch threads and gets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``; the backend is
gloo on the CPU and where the ranks outnumber the cards (they share
them), NCCL where each has its own.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

from cbf_tpu_torch.parallel import multihost

#: The package's parent directory, put on every rank's ``sys.path``.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_BOOT = ("import sys; sys.path[:0] = sys.argv[3:]; "
         "from cbf_tpu_torch.parallel import launch; "
         "sys.exit(launch._rank_main(sys.argv[1], int(sys.argv[2])))")


class RankError(RuntimeError):
    """A rank of a :func:`run_world` world failed or the world timed out;
    the message holds the first failed rank's traceback."""


def run_world(target: str, world_size: int, args: tuple = (),
              kwargs: dict | None = None, *, device: str = "cpu",
              timeout_s: float | None = 600.0, threads: int = 1,
              sys_path: tuple = (), env: dict | None = None) -> list:
    """Run ``target`` ("package.module:function") on ``world_size`` ranks
    and return their results in rank order (module docstring).
    ``device`` picks the backend (:func:`multihost.default_backend`:
    gloo unless each rank has a card of its own); ``sys_path``
    entries are put first on each rank's ``sys.path`` (where ``target``'s
    module lives); ``env`` adds environment variables."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    work = tempfile.mkdtemp(prefix="cbf_world_")
    try:
        with open(os.path.join(work, "job.pkl"), "wb") as f:
            pickle.dump((target, tuple(args), dict(kwargs or {}), threads),
                        f)
        base = dict(os.environ)
        base.update(env or {})
        base.update({
            "WORLD_SIZE": str(world_size),
            "LOCAL_WORLD_SIZE": str(world_size),
            multihost.STORE_ENV: os.path.join(work, "store"),
            multihost.BACKEND_ENV: multihost.default_backend(device,
                                                             world_size),
            "OMP_NUM_THREADS": str(threads),
            "MKL_NUM_THREADS": str(threads)})
        for drop in ("MASTER_ADDR", "MASTER_PORT"):
            base.pop(drop, None)
        path = [str(p) for p in sys_path] + [_ROOT]
        procs = []
        for r in range(world_size):
            e = dict(base, RANK=str(r), LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _BOOT, work, str(r), *path],
                env=e, cwd=os.getcwd()))
        _wait(procs, work, timeout_s)
        out = []
        for r in range(world_size):
            with open(os.path.join(work, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _wait(procs, work: str, timeout_s: float | None) -> None:
    """Wait for every rank; on a failure or the timeout stop the rest and
    raise :class:`RankError` with the first failure's traceback."""
    t_end = None if timeout_s is None else time.monotonic() + timeout_s
    failed = None
    while True:
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            failed = bad
            break
        if all(c == 0 for c in codes):
            return
        if t_end is not None and time.monotonic() > t_end:
            break
        time.sleep(0.05)
    # Give ranks that are failing on their own a moment to write theirs.
    time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
    errors = []
    for r in range(len(procs)):
        path = os.path.join(work, f"error_{r}.txt")
        if os.path.exists(path):
            errors.append((os.path.getmtime(path), r, open(path).read()))
    if errors:
        _, r, text = min(errors)
        raise RankError(f"rank {r} of {len(procs)} failed:\n{text}")
    if failed:
        raise RankError(f"ranks {failed} of {len(procs)} exited with codes "
                        f"{[procs[r].returncode for r in failed]}")
    raise RankError(f"the world of {len(procs)} ranks did not finish in "
                    f"{timeout_s} s")


def _rank_main(work: str, rank: int) -> int:
    """One rank: join the world, run the job, write its result (or its
    traceback), leave the world."""
    try:
        with open(os.path.join(work, "job.pkl"), "rb") as f:
            target, args, kwargs, threads = pickle.load(f)
        import importlib

        import torch

        torch.set_num_threads(threads)
        multihost.initialize()
        mod, _, fn = target.partition(":")
        result = getattr(importlib.import_module(mod), fn)(*args, **kwargs)
        tmp = os.path.join(work, f"result_{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(work, f"result_{rank}.pkl"))
        multihost.shutdown()
        return 0
    except BaseException:
        with open(os.path.join(work, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        return 1
