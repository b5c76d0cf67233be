"""Fault injection: prove the failure-detection machinery fires
(counterpart: cbf_tpu/utils/faults.py, its step and process injectors).

Step injectors wrap a step and compose with ``rollout``,
``rollout_chunked``, ``checked_rollout`` and the telemetry tap like the
step itself. Each is capture-safe: the fault is a select on ``t`` — with a
Python int ``t`` (the eager loop) the wrapper picks on the host; with the
compiled rollout's 0-dim device ``t`` it is a ``torch.where``, which the
captured body replays. Constants a wrapper needs are made on its first
call, which the engine runs uncaptured. Each forwards the step's
``inputs``, ``relax_rounds``, ``admm_blocks`` and ``host_inputs``.

    step = faults.nan_at_step(step, step_index=50)
    checked_rollout(step, state0, 100)   # FloatingPointError at step 50

:func:`stall_at_step` stalls on the host: a captured graph cannot sleep,
so it holds the host before the chunk that holds its step (the program's
``host_inputs`` hook, which the engine calls before each chunk) — no
heartbeat at or after that step can arrive before the stall has passed.

The serving injectors plug into ``ServeEngine.fault_hook`` — a callable
``hook(key, entries, attempt, phase)`` the engine invokes before the
"compile" (the bucket program's capture) and "execute" stage of every
batch attempt:

    engine.fault_hook = faults.serve_executor_fault(times=2)
    # the first two batches raise InjectedExecutorFault -> engine retries

:func:`poison_config` is the data-plane poison: a request that passes
validation but blows its own lane up to non-finite values at runtime.

The process-level injectors (:func:`kill_schedule`,
:func:`run_process_until`, :func:`run_until_killed`, :func:`pause_after`,
:func:`resume`, :func:`wait_for_file`) drive kill-and-resume runs of the
CLI. :func:`leak_host_callback` and :func:`promote_f64` are the faults the
program checks (:mod:`cbf_tpu_torch.analysis.program_rules`, JX001 and
JX002) must catch; they run eagerly and on the CPU, and on the card the
first breaks a capture.
"""

from __future__ import annotations

import dataclasses
import functools
import time as _time
from typing import Callable

import numpy as np
import torch

from cbf_tpu_torch.rollout.engine import _tree_map, forward_attributes


def _select(hit, a, b):
    """``a`` where ``hit`` (a Python bool or a 0-dim bool tensor), else
    ``b``."""
    if isinstance(hit, bool):
        return a if hit else b
    return torch.where(hit, a, b)


def _call(step_fn, state, t, inputs):
    return step_fn(state, t) if inputs is None else \
        step_fn(state, t, inputs=inputs)


def _maybe_corrupt(leaf, hit, value):
    """``leaf`` with its first element set to ``value`` where ``hit``;
    non-float leaves pass through."""
    if not leaf.is_floating_point():
        return leaf
    if leaf.dim():
        corrupted = leaf.clone(memory_format=torch.contiguous_format)
        corrupted.view(-1)[:1].fill_(value)
    else:
        corrupted = torch.full_like(leaf, value)
    return _select(hit, corrupted, leaf)


def _value_at_step(step_fn: Callable, step_index: int, value) -> Callable:
    def wrapped(state, t, inputs=None):
        hit = t == step_index
        state = _tree_map(lambda leaf: _maybe_corrupt(leaf, hit, value),
                          state)
        return _call(step_fn, state, t, inputs)

    return forward_attributes(wrapped, step_fn)


def nan_at_step(step_fn: Callable, step_index: int) -> Callable:
    """Set the first element of every float state leaf to NaN at ``t ==
    step_index``."""
    return _value_at_step(step_fn, step_index, float("nan"))


def inf_at_step(step_fn: Callable, step_index: int) -> Callable:
    """:func:`nan_at_step` with +inf (overflow-style faults)."""
    return _value_at_step(step_fn, step_index, float("inf"))


def corrupt_output_at_step(step_fn: Callable, step_index: int, field: str,
                           value, *, until: int | None = None) -> Callable:
    """Overwrite one StepOutputs ``field`` with ``value`` for steps in
    ``[step_index, until)`` (``until=None``: that step alone). The state
    stays healthy; only the record is forged, so the telemetry chain (tap,
    sink, watchdog) can be shown to carry and alert on it. The field must
    be tracked (a ``()`` field raises ValueError)."""
    def wrapped(state, t, inputs=None):
        state, out = _call(step_fn, state, t, inputs)
        leaf = getattr(out, field)
        if isinstance(leaf, tuple):
            raise ValueError(
                f"StepOutputs.{field} is untracked (()) in this scenario — "
                "corrupt_output_at_step needs a tracked field")
        hit = (t == step_index if until is None
               else (t >= step_index) & (t < until))
        forged = _select(hit, torch.full_like(leaf, value), leaf)
        return state, out._replace(**{field: forged})

    return forward_attributes(wrapped, step_fn)


def stall_at_step(step_fn: Callable, step_index: int,
                  seconds: float) -> Callable:
    """Hold the host for ``seconds`` before step ``step_index`` runs — a
    wedge fault for missed-heartbeat detection (module docstring): in the
    compiled rollout before the chunk that holds the step, in the eager
    loop before the step itself (a chunk the engine redoes stalls twice)."""
    inner = getattr(step_fn, "host_inputs", None)

    def hook(t0, n):
        if t0 <= step_index < t0 + n:
            _time.sleep(seconds)
        return None if inner is None else inner(t0, n)

    def wrapped(state, t, inputs=None):
        if isinstance(t, int) and t == step_index:
            _time.sleep(seconds)
        return _call(step_fn, state, t, inputs)

    forward_attributes(wrapped, step_fn)
    wrapped.host_inputs = hook
    return wrapped


def teleport_at_step(step_fn: Callable, step_index: int,
                     agent: int = 0, offset=(0.0, 0.0)) -> Callable:
    """Move one agent by ``offset`` (float32, as the JAX package casts it)
    at ``t == step_index`` — a finite state corruption for the safety
    metrics and infeasibility flags rather than float checks."""
    off = np.asarray(offset, np.float32)

    @functools.lru_cache(maxsize=None)
    def delta(shape, dtype, device):
        d = torch.zeros(shape, dtype=dtype, device=device)
        d[agent] = torch.from_numpy(off).to(dtype)
        return d

    def wrapped(state, t, inputs=None):
        x = state.x
        x = _select(t == step_index,
                    x + delta(tuple(x.shape), x.dtype, x.device), x)
        return _call(step_fn, state._replace(x=x), t, inputs)

    return forward_attributes(wrapped, step_fn)


def poison_agent_at_step(step_fn: Callable, step_index: int,
                         agent: int = 0) -> Callable:
    """NaN-poison one agent's position row at ``t == step_index`` — the
    rung-3 (lane scrub) fault: with ``Config.rta`` the entry scrub
    replaces the row with its last-known-good carry plus a stop command;
    without RTA the consensus centroid takes the whole swarm non-finite.
    ``step_index < 0`` never fires."""
    def wrapped(state, t, inputs=None):
        x = state.x
        row = torch.arange(x.shape[0], device=x.device) == agent
        poisoned = torch.where(row[:, None], torch.nan, x)
        x = _select(t == step_index, poisoned, x)
        return _call(step_fn, state._replace(x=x), t, inputs)

    return forward_attributes(wrapped, step_fn)


def residual_blowup_at_step(step_fn: Callable, step_index: int,
                            scale: float = 1e8) -> Callable:
    """Scale every leaf of the certificate's warm ADMM carry by ``scale``
    at ``t == step_index`` — the rung-2 (backup controller) fault. Finite
    on purpose: the carry sanitizer must not reset it, so the solver
    fails to converge within its budget and the residual blows past the
    gate. Needs ``certificate_warm_start=True``."""
    def wrapped(state, t, inputs=None):
        ss = state.certificate_solver_state
        if isinstance(ss, tuple) and len(ss) == 0:
            raise ValueError(
                "residual_blowup_at_step corrupts the warm-start ADMM "
                "carry — enable certificate_warm_start")
        hit = t == step_index
        ss = tuple(_select(hit, leaf * scale, leaf) for leaf in ss)
        return _call(step_fn, state._replace(certificate_solver_state=ss),
                     t, inputs)

    return forward_attributes(wrapped, step_fn)


def teleport_clump_at_step(step_fn: Callable, step_index: int,
                           agents, spacing: float = 0.01,
                           center=(0.0, 0.0)) -> Callable:
    """Teleport ``agents`` into a sub-floor line clump (``spacing`` apart
    around ``center``) at ``t == step_index`` — the rung-1 (boosted
    re-solve) fault: the deep mutual violation drives the clumped agents'
    QPs past the relax cap or budget, and the boosted re-solve must
    restore feasibility and unpack the clump."""
    agents = list(agents)
    half = 0.5 * spacing * (len(agents) - 1)
    rows = [[center[0] - half + i * spacing, center[1]]
            for i in range(len(agents))]

    @functools.lru_cache(maxsize=None)
    def target(dtype, device):
        return (torch.tensor(agents, dtype=torch.int64, device=device),
                torch.tensor(rows, dtype=dtype, device=device))

    def wrapped(state, t, inputs=None):
        x = state.x
        idx, pos = target(x.dtype, x.device)
        x = _select(t == step_index, x.index_copy(0, idx, pos), x)
        return _call(step_fn, state._replace(x=x), t, inputs)

    return forward_attributes(wrapped, step_fn)


def leak_host_callback(step_fn: Callable, every: int = 1) -> Callable:
    """A host read inside the step — the capture-safety fault: a wrapper
    (a profiler shim, a stray debug print) that hands a device value to
    host code. With the eager loop's Python int ``t`` it reads every
    ``every`` steps; inside the compiled body (a device ``t``) on every
    step, where a CUDA graph capture refuses it. Exists so the program
    checks (rule JX001) can be proven to detect such a read."""
    def _leak(value):
        pass

    def wrapped(state, t, inputs=None):
        state, out = _call(step_fn, state, t, inputs)
        if not isinstance(t, int) or t % every == 0:
            _leak(out.min_pairwise_distance.item())
        return state, out

    return forward_attributes(wrapped, step_fn)


def promote_f64(step_fn: Callable, field: str = "min_pairwise_distance"
                ) -> Callable:
    """Route one StepOutputs FIELD through float64 and back — the
    dtype-drift fault: a stray float64 constant promoting part of the
    float32 path (invisible in the output dtype, doubled bytes inside).
    Exists so the program checks (rule JX002) can be proven to detect
    it."""
    def wrapped(state, t, inputs=None):
        state, out = _call(step_fn, state, t, inputs)
        leaf = getattr(out, field)
        if isinstance(leaf, tuple):
            raise ValueError(
                f"StepOutputs.{field} is untracked (()) in this scenario — "
                "promote_f64 needs a tracked field")
        drifted = leaf.to(torch.float64).to(leaf.dtype)
        return state, out._replace(**{field: drifted})

    return forward_attributes(wrapped, step_fn)


def poison_config(cfg):
    """A poisoned config of the same shape as ``cfg``: a 1e30 timestep
    overflows the position integration to inf, and the next step's
    pairwise math to NaN."""
    return dataclasses.replace(cfg, dt=1e30)


# ------------------------------------------------- serve-level chaos ----


class InjectedExecutorFault(RuntimeError):
    """The chaos harness's transient executor failure. A RuntimeError on
    purpose: `serve.resilience.is_retryable` classifies RuntimeErrors as
    transient, so the engine's backoff-retry path — not the bisect/fail
    path — is what these exercise."""


def serve_executor_fault(times: int, exc: BaseException | None = None
                         ) -> Callable:
    """Engine fault hook raising at the EXECUTE phase for the first
    ``times`` batch attempts it sees, then going quiet — the transient
    executor fault (preempted device, flaky interconnect). Default
    exception is :class:`InjectedExecutorFault` (retryable); pass e.g.
    a ``ValueError`` to simulate a permanent fault that must bisect."""
    remaining = [times]

    def hook(key, entries, attempt, phase):
        if phase == "execute" and remaining[0] > 0:
            remaining[0] -= 1
            raise exc if exc is not None else InjectedExecutorFault(
                f"injected executor fault ({remaining[0]} left) for bucket "
                f"{key.label()}")

    return hook


def serve_compile_failure(times: int) -> Callable:
    """Engine fault hook raising at the COMPILE phase for the first
    ``times`` batch attempts — the transient compile/lowering failure
    (cache race, OOM during lowering). Retryable; when the retry budget
    is exhausted the engine charges the BUCKET breaker (no request is at
    fault when the bucket cannot build)."""
    remaining = [times]

    def hook(key, entries, attempt, phase):
        if phase == "compile" and remaining[0] > 0:
            remaining[0] -= 1
            raise InjectedExecutorFault(
                f"injected compile failure ({remaining[0]} left) for bucket "
                f"{key.label()}")

    return hook


def serve_latency_spike(seconds: float, every: int = 1) -> Callable:
    """Engine fault hook sleeping ``seconds`` before every ``every``-th
    execute — the latency-spike fault (GC pause, noisy neighbor). Never
    raises: it exercises deadline expiry and queue growth, not the
    retry path."""
    count = [0]

    def hook(key, entries, attempt, phase):
        if phase == "execute":
            count[0] += 1
            if count[0] % every == 0:
                _time.sleep(seconds)

    return hook


def serve_chaos_hook(*hooks: Callable) -> Callable:
    """Compose several serve fault hooks into one (each called in order;
    the first to raise wins)."""
    def hook(key, entries, attempt, phase):
        for h in hooks:
            h(key, entries, attempt, phase)

    return hook


# ------------------------------------------------ process-level kills ----


def kill_schedule(seed: int, rounds: int, t_min: float,
                  t_max: float) -> list:
    """Seeded SIGKILL times for a preemption campaign: ``rounds`` uniform
    draws from ``[t_min, t_max)`` seconds (``np.random.default_rng``, the
    JAX package's draws for the same seed)."""
    rng = np.random.default_rng(seed)
    return [float(t) for t in rng.uniform(float(t_min), float(t_max),
                                          size=int(rounds))]


def run_process_until(argv, should_kill, *, poll_s: float = 0.1,
                      timeout_s: float = 600.0, env=None,
                      sig=None) -> tuple:
    """Run ``argv`` as a subprocess, polling ``should_kill(elapsed_s)``;
    deliver ``sig`` (default SIGKILL — no warning, no cleanup) the first
    time it returns True. Returns ``(returncode, killed, elapsed_s)``,
    ``killed`` False when the process finished first. A process that
    outlives ``timeout_s`` is killed and reported as ``returncode None``."""
    import signal
    import subprocess

    if sig is None:
        sig = signal.SIGKILL
    t0 = _time.monotonic()
    proc = subprocess.Popen(argv, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        while True:
            rc = proc.poll()
            elapsed = _time.monotonic() - t0
            if rc is not None:
                return rc, False, elapsed
            if elapsed > timeout_s:
                proc.kill()
                proc.wait()
                return None, True, elapsed
            if should_kill(elapsed):
                proc.send_signal(sig)
                proc.wait()
                return proc.returncode, True, _time.monotonic() - t0
            _time.sleep(poll_s)
    except BaseException:
        proc.kill()
        proc.wait()
        raise


def run_until_killed(argv, kill_after_s: float, **kw) -> tuple:
    """:func:`run_process_until` with a fixed kill time."""
    return run_process_until(argv, lambda t: t >= kill_after_s, **kw)


def pause_after(argv, pause_after_s: float, *, poll_s: float = 0.05,
                env=None, stdout=None, stderr=None):
    """Start ``argv`` and SIGSTOP it after ``pause_after_s`` seconds (a
    stalled, not dead, process). Returns the ``Popen`` handle; the caller
    resumes it with :func:`resume` and reaps it."""
    import signal
    import subprocess

    t0 = _time.monotonic()
    proc = subprocess.Popen(argv, env=env, stdout=stdout, stderr=stderr)
    while proc.poll() is None and _time.monotonic() - t0 < pause_after_s:
        _time.sleep(poll_s)
    if proc.poll() is None:
        proc.send_signal(signal.SIGSTOP)
    return proc


def resume(proc) -> None:
    """SIGCONT a process stopped by :func:`pause_after` (no-op once it
    exited)."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGCONT)


def wait_for_file(path: str, timeout_s: float = 60.0,
                  poll_s: float = 0.05) -> bool:
    """Poll until ``path`` exists. True when it appeared, False on
    timeout."""
    import os

    t0 = _time.monotonic()
    while _time.monotonic() - t0 < timeout_s:
        if os.path.exists(path):
            return True
        _time.sleep(poll_s)
    return os.path.exists(path)
