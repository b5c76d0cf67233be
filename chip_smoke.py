"""Chip smoke test of the PyTorch/CUDA port (``cbf_tpu_torch``).

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on any failure):

1. build the k-NN kernels from ``cbf_tpu_torch/csrc/knn.cu`` with nvcc,
   print the registers and spills of the k=8 kernels and of the k=16
   ``knn_stream`` scan, and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card —
   ``knn_fused`` at N in {1, 37, 256, 4096, 5000, 8192} and on rows 8
   bytes off a 16-byte boundary, ``knn_stream`` at N in {1, 37, 1000,
   2000, 4096 (forced), 16384, 20000, 65536} (1000 and 2000 split into
   several column ranges, so the merge launch is held too; the others
   scan one range), on rows 8 bytes off a 16-byte boundary and at k=1 and
   k=16 (N=20000), ``knn_banded`` at N in {4096, 65536}
   with the main path's windows, k=8, radius 0.4, seeded spawn positions,
   and the same spawns packed 4x closer (every row then holds more than k
   in-radius candidates, the top-k's overflow branch) — every output must
   be equal; ``knn_banded`` also on a thin band with a one-block window
   (the overflow flag must be raised), on float64 input, and at N=65536
   against ``knn_stream`` on the filled slots; and ``knn_banded``'s
   prologue kernel alone (``band_prologue``: sort order, sorted float32
   rows, window starts, overflow flags) equal to ``band_setup``'s PyTorch
   ops on every one of those inputs;
3. drive the main path — ``swarm.make(Config(n=4096))``, ``gating="auto"``,
   500 steps — and the same at the ``entry()`` size N=256, through the
   compiled ``rollout`` (the step captured as a CUDA graph and replayed;
   the first call captures): the run must equal the eager loop from the
   same initial state (``engine.eager_rollout``) on the final state and
   every ``StepOutputs`` field (``torch.equal``), launch ``knn_fused`` once
   per step (plus any step the engine redid eagerly) and no other kernel,
   and hold the separation floor with zero infeasible QPs; eager and
   compiled are timed in turns (eager, compiled, compiled, eager) and the
   peak device memory, the guarded relax rounds, the redo count and the
   per-step relax rounds are printed;
4. the same at N=16384 for 50 steps, which routes to ``knn_stream``; then
   hold both kernels against their plain versions again on the final
   states of phases 3 and 4, the main path's own inputs;
5. the same N=4096 initial state for 20 steps on the card and on the CPU
   (plain version there, the compiled rollout's body uncaptured):
   positions and min distances within a stated tolerance, the per-step
   counts equal;
6. time each kernel at its main-path shape (median of single launches)
   beside its bound and its plain version — ``knn_stream`` with its
   column plan and the scan's and the merge's device times apart,
   ``knn_banded`` as the whole
   wrapper, as its sorted-input launch alone and as its prologue alone,
   with the device ops one call issues (profiler); then profile 20 steps
   of every phase's run, eager and compiled side by side: device ops, device
   ms and busy share per step, the knn kernels seen inside the replay;
7. the banded path at full width — ``Config(n=65536, gating="banded")``,
   200 steps, trajectory recorded, compiled and held to the eager loop as
   in phase 3: one ``knn_banded`` launch per step and none of the others,
   the separation floor, zero infeasible QPs, the window overflow count
   printed; ``knn_banded`` held against its plain version on the final
   state;
8. the obstacle field at the north-star N=4096, 12 obstacles, banded
   gating, 300 steps, compiled and held to the eager loop as in phase 3:
   the "scatter" field above the floor with zero
   infeasible QPs, the default "orbit" ring with zero infeasible QPs (its
   min distance printed: the reference itself dips below the floor there,
   the ring outruns the agents ~13x), and 20 steps of the orbit run on
   the card and on the CPU with positions and min distances within a
   stated tolerance and every count equal;
9. the other dynamics families at N=4096, 300 steps each, compiled and
   held to the eager loop as in phase 3 (the headings included):
   ``dynamics="double"``, ``"unicycle"`` and ``"mixed"`` with
   ``n_double=2048`` (the per-agent filter path), each above its
   calibrated floor (``bench.py``: 0.08 double and mixed, 0.11 unicycle,
   on the projection points), the infeasible count, the per-step relax
   rounds and the rounds captured printed, unicycle's largest saturation
   deficit printed; then each family at N=256 for 50 steps on the card
   and on the CPU: positions and headings within a stated tolerance,
   every count equal;
10. the Verlet neighbour cache, ``Config(n=4096, gating_rebuild_skin=0.1)``
   x 500 with the trajectory recorded, compiled (a rebuild search on every
   step, the cached or rebuilt selection picked on the device) and held to
   the eager loop (a rebuild only when an agent has moved skin/2): 0
   infeasible, the sound floor metric at or below the true separation of
   every step and that above the L1 floor, the metric's minimum printed
   against tests/test_gating_truncation.py's N=512 bound of 0.13 (the
   reference's own N=4096 run dips below it too), the rebuild count and
   dropped count printed;
11. runtime assurance at N=4096 x 300: armed and healthy
   (``Config(rta=True)``) bit-equal to ``rta=False`` on x, v and every
   count with ``rta_mode`` all 0; a NaN-poisoned agent at step 30
   (rung 3 at step 30, released by the end, every row finite); an
   8-agent clump teleported at step 10 onto the ring of 12 obstacles
   (rung 1 engages and is released, the boosted re-solve runs in the
   eager redo, whose counts are printed for the whole rollout and for
   chunks of 50).
   Each compiled and held to the eager loop.

Phases 7-11 run before phase 6, which times their kernels and profiles
every phase.

Stdout ends with the ``{"kernels": [...]}`` line, each phase's compiled
and eager agent-QP-steps/s, the card line, and, last, the result line
``{"ok": true, "device": {...}}``. Without a card it exits 2 and prints
no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the
# f32 rate outside the tensor cores, at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# That f32 rate counts an FMA as two operations. The kernels are built with
# --fmad=false and issue no FMA, so each of their operations takes a lane
# slot an FMA would fill with two: they run at most at half the rate.
PEAK_F32_ISSUE_PER_S = PEAK_F32_PER_S / 2
# f32 operations per ordered pair: 2 sub, 2 mul, 1 add, 1 min, 2 compares.
OPS_PER_PAIR = 8
# Phase 2's packed inputs: spawns (grid spacing ~0.4 m) scaled to ~0.1 m,
# so even a corner agent holds ~14 > K in-radius candidates.
PACK = 0.25
K, RADIUS = 8, 0.4
FLOOR = 0.2 / math.sqrt(2.0) - 1e-4   # L1 barrier's Euclidean floor
ENTRY_N, ENTRY_STEPS = 256, 500    # the entry() size
MAIN_N, MAIN_STEPS = 4096, 500
STREAM_N, STREAM_STEPS = 16384, 50
BANDED_N, BANDED_STEPS = 65536, 200
OBST_N, OBST_M, OBST_STEPS = 4096, 12, 300
DYN_N, DYN_STEPS = 4096, 300
# bench.py's calibrated floors (SAFETY_FLOOR_DOUBLE, _UNICYCLE): the
# double rows' inertial transient dips below the single floor; unicycle
# distances are between projection points.
DYN_FLOORS = {"double": 0.08, "unicycle": 0.11, "mixed": 0.08}
DYN_CROSS_N, DYN_CROSS_STEPS = 256, 50
VERLET_STEPS, VERLET_SKIN = 500, 0.1
VERLET_FLOOR = 0.13   # tests/test_gating_truncation.py's bound at N=512
RTA_STEPS, RTA_POISON_AT, RTA_CLUMP_AT = 300, 30, 10
THIN_N = 4096   # phase 2's thin band: 8 blocks of rows in one 1e-3 m band
CROSS_STEPS = 20
# Card vs CPU after CROSS_STEPS steps: positions reach ~13 m, where a
# float32 ulp is ~1e-6, and the two devices reduce the centroid mean in
# different orders, so the trajectories part by a few ulps per step;
# 1e-4 m leaves ~5x headroom over 20 steps of that, and the min-distance
# series (values ~0.2 m, ulp ~1.5e-8) gets 1e-5.
CROSS_X_ATOL, CROSS_MD_ATOL = 1e-4, 1e-5
# The same bounds hold phase 9's 50 steps at N=256 (positions ~3 m, a
# float32 ulp ~2.4e-7): CUDA's and the CPU's cos/sin may differ by an ulp
# and the unicycle heading feeds that back every step, which 1e-4 covers
# ~400x over; theta (|theta| < ~10) gets the same 1e-4.


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int) -> tuple[float, float]:
    """(median ms of ``reps`` single calls, each between its own pair of
    CUDA events, so the host's launch gap counts; mean ms per call over
    ``reps`` calls back to back)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    single = sorted(start.elapsed_time(end) for start, end in pairs)
    start, end = pairs[0]
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return single[reps // 2], start.elapsed_time(end) / reps


def compare(kernel_fn, plain_fn, x, k=K, **kw) -> tuple[float, list]:
    """Kernel vs plain on the same card input: every output (four, or five
    with the banded overflow flag) must be equal. Returns the max abs
    difference of the float outputs (finite entries; 0.0 when equal) and
    the outputs."""
    import torch

    got, want = kernel_fn(x, RADIUS, k, **kw), plain_fn(x, RADIUS, k, **kw)
    torch.cuda.synchronize()
    names = (("idx", "dist", "nearest", "count") if len(want) == 4
             else ("idx", "dist", "nearest", "overflow", "count"))
    check(len(got) == len(want), "output count")
    err = 0.0
    for name, a, b in zip(names, got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} "
              f"{b.dtype}")
        if a.is_floating_point():
            fin = torch.isfinite(b)
            check(torch.equal(torch.isfinite(a), fin), f"{name}: inf pattern")
            if bool(fin.any()):
                err = max(err, float(torch.amax(torch.abs(a[fin] - b[fin]))))
        check(torch.equal(a, b), f"{name} differs from the plain version at "
              f"N={x.shape[0]}")
    return err, want


def timed(fn) -> float:
    """Host-clock seconds of ``fn()``, ended by a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def same_tree(a, b) -> bool:
    """Every tensor leaf torch.equal (dtype and shape included), every
    ``()`` field ``()`` on both sides."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    return (isinstance(a, tuple) and isinstance(b, tuple)
            and len(a) == len(b) and all(map(same_tree, a, b)))


def zero_counts(engine, knn) -> None:
    for name in knn.LAUNCHES:
        knn.LAUNCHES[name] = 0
    for name in engine.COUNTS:
        engine.COUNTS[name] = 0


def drive(swarm, engine, knn, cfg, label, kernel, wrap=None):
    """One main-path run through the user entry points: ``swarm.make`` and
    the compiled ``rollout`` (its first call on this step, so the capture
    is inside), with the launch and engine counts zeroed just before and
    read just after, and the peak device memory around it. Then the eager
    loop from the same initial state, which the compiled run must equal
    (final state and every StepOutputs field, torch.equal), and both timed
    in turns (eager, compiled, compiled, eager) with the graphs cached.
    ``wrap`` wraps the step (a fault injector). Checks ``kernel``
    launches and none of the others: one per step in the compiled run (a
    graph replays every step's search; the Verlet cache's too) plus the
    eager loop's where the chunk was redone, and one per step eagerly
    (the Verlet cache: one per rebuild). Returns a dict of the run."""
    import torch

    state0, step = swarm.make(cfg)
    if wrap is not None:
        step = wrap(step)
    torch.cuda.synchronize()
    zero_counts(engine, knn)
    torch.cuda.reset_peak_memory_stats()
    # Earlier phases' programs keep their buffers and graph pools: report
    # the peak over what was held before this run, too.
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    final, outs = engine.rollout(step, state0, cfg.steps)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = dict(knn.LAUNCHES)
    counts = dict(engine.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(engine, knn)
    eager_final, eager_outs = engine.eager_rollout(step, state0, cfg.steps)
    torch.cuda.synchronize()
    eager_launches = dict(knn.LAUNCHES)
    peak_eager = torch.cuda.max_memory_allocated()
    check(same_tree(final, eager_final),
          f"{label}: compiled final state differs from the eager loop's")
    for name, a, b in zip(engine.StepOutputs._fields, outs, eager_outs):
        check(same_tree(a, b), f"{label}: compiled {name} differs from the "
              "eager loop's")
    want = dict.fromkeys(knn.LAUNCHES, 0)
    want[kernel] = cfg.steps + (eager_launches[kernel]
                                if counts["redo_steps"] else 0)
    check(launches == want, f"{label}: launches {launches}, want {want}")
    if not cfg.gating_rebuild_skin:
        check(eager_launches[kernel] == cfg.steps,
              f"{label}: eager launches {eager_launches}")
    walls = {"eager": [], "compiled": []}
    for kind in ("eager", "compiled", "compiled", "eager"):
        run = engine.eager_rollout if kind == "eager" else engine.rollout
        walls[kind].append(timed(lambda: run(step, state0, cfg.steps)))
    rounds = torch.bincount(eager_outs.max_relax_rounds.int().cpu())
    run_info = {
        "steps": cfg.steps, "n": cfg.n, "relax_rounds_captured":
        step.relax_rounds, "redos": counts["redos"],
        "redo_steps": counts["redo_steps"], "captures": counts["captures"],
        "replays": counts["replays"], "first_call_s": first,
        "eager_s": walls["eager"], "compiled_s": walls["compiled"],
        "eager_step_ms": [w / cfg.steps * 1e3 for w in walls["eager"]],
        "compiled_step_ms": [w / cfg.steps * 1e3 for w in walls["compiled"]],
        "eager_agent_qp_steps_per_s": [cfg.n * cfg.steps / w
                                       for w in walls["eager"]],
        "compiled_agent_qp_steps_per_s": [cfg.n * cfg.steps / w
                                          for w in walls["compiled"]],
        "peak_mib_compiled_first_call": peak / 2**20,
        "peak_mib_eager": peak_eager / 2**20,
        "held_before_mib": base / 2**20,
        "peak_over_held_mib_compiled": (peak - base) / 2**20,
        "peak_over_held_mib_eager": (peak_eager - base) / 2**20,
        "max_relax_rounds_steps": {r: int(c) for r, c in enumerate(rounds)
                                   if int(c)},
        "eager_launches": eager_launches[kernel]}
    print(f"{label}: compiled == eager (final state, every StepOutputs "
          f"field); launches {launches}; " + json.dumps(run_info))
    return {"state0": state0, "step": step, "final": final,
            "outs": outs, "eager_outs": eager_outs, "launches": launches,
            "wall": min(walls["compiled"]), "info": run_info}


def check_run(label, cfg, final, outs, floor=FLOOR, feasible=True):
    """Shapes, finiteness (every state leaf), zero infeasible agent-steps
    (unless ``feasible`` is False: then the count is only printed) and
    (unless ``floor`` is None) the separation floor. Returns the min
    distance."""
    import torch

    md = outs.min_pairwise_distance
    check(tuple(md.shape) == (cfg.steps,), f"{label}: min-distance shape")
    check(tuple(final.x.shape) == (cfg.n, 2), f"{label}: state shape")
    leaves = [v for v in (final.x, final.v, final.theta)
              if isinstance(v, torch.Tensor)]
    check(all(bool(torch.isfinite(v).all()) for v in leaves),
          f"{label}: non-finite")
    md_min = float(md.min())
    infeasible = int(outs.infeasible_count.sum())
    if floor is not None:
        check(md_min >= floor, f"{label}: min distance {md_min} < {floor}")
    if feasible:
        check(infeasible == 0,
              f"{label}: {infeasible} infeasible agent-steps")
    overflow = ("" if isinstance(outs.gating_overflow_count, tuple) else
                f", window overflow {int(outs.gating_overflow_count.sum())}")
    print(f"{label}: min distance {md_min:.6f} "
          f"({'floor %.5f' % floor if floor is not None else 'not held'}), "
          f"infeasible {infeasible}, max relax rounds "
          f"{float(outs.max_relax_rounds.max()):.0f}, filter-active mean "
          f"{float(outs.filter_active_count.float().mean()):.1f}, "
          f"dropped {int(outs.gating_dropped_count.sum())}{overflow}")
    return md_min


def cross_check(swarm, engine, cfg, state0, label):
    """``cfg.steps`` steps of the compiled rollout from ``state0`` on the
    card and on the CPU (plain versions there, the body uncaptured):
    positions (and headings) and min distances within
    CROSS_X_ATOL/CROSS_MD_ATOL, every count equal."""
    import torch

    _, step_gpu = swarm.make(cfg)
    _, step_cpu = swarm.make(cfg, device="cpu")
    fg, og = engine.rollout(step_gpu, state0, cfg.steps)
    fc, oc = engine.rollout(
        step_cpu, engine._tree_map(lambda v: v.cpu(), state0), cfg.steps)
    dx = float(torch.amax(torch.abs(fg.x.cpu() - fc.x)))
    if isinstance(fg.theta, torch.Tensor):
        dx = max(dx, float(torch.amax(torch.abs(fg.theta.cpu()
                                                - fc.theta))))
    dmd = float(torch.amax(torch.abs(og.min_pairwise_distance.cpu()
                                     - oc.min_pairwise_distance)))
    print(f"{label}: card vs CPU over {cfg.steps} steps at N={cfg.n}: "
          f"max |dx| {dx:.3e} (atol {CROSS_X_ATOL}), max |d min-dist| "
          f"{dmd:.3e} (atol {CROSS_MD_ATOL})")
    check(dx <= CROSS_X_ATOL and dmd <= CROSS_MD_ATOL,
          f"{label}: card and CPU trajectories part beyond tolerance")
    for field in ("filter_active_count", "infeasible_count",
                  "gating_dropped_count", "gating_overflow_count",
                  "max_relax_rounds", "rta_mode"):
        a, b = getattr(og, field), getattr(oc, field)
        if isinstance(a, tuple):
            check(b == (), f"{field}: reported on one device only")
            continue
        a = a.cpu()
        print(f"  {field} per step, card vs CPU: sums {float(a.sum())} / "
              f"{float(b.sum())}")
        check(torch.equal(a, b), f"{field} differs between card and CPU")


def kernel_name(name: str) -> str:
    """A repo kernel's short name: "void (anonymous namespace)::knn_x<8>(
    ...)" -> "knn_x"."""
    return name[name.index("knn_"):].split("<")[0].split("(")[0]


def device_profile(fn, calls: int = 50) -> dict:
    """What one call of ``fn`` does on the device, from torch.profiler's
    CUDA activity over ``calls`` calls: device ops (kernels, copies and
    fills alike) and their distinct names, their summed device time, and
    the part of it spent in this repo's kernels (names with ``knn_``), in
    all and per kernel (the name up to its template arguments)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [ev for ev in prof.events() if ev.device_type == cuda
           and not getattr(ev, "is_user_annotation", False)]

    def ms(keep):
        return sum(ev.time_range.end - ev.time_range.start
                   for ev in evs if keep(ev.name)) / 1e3 / calls

    kernels = sorted({kernel_name(ev.name) for ev in evs
                      if "knn_" in ev.name})
    return {"device_ops_per_call": len(evs) / calls,
            "device_ms": ms(lambda name: True) if evs else "not measured",
            "kernel_device_ms": (ms(lambda name: "knn_" in name) if evs
                                 else "not measured"),
            "kernel_device_ms_by_name": {
                kname: ms(lambda name, kname=kname: "knn_" in name
                          and kernel_name(name) == kname)
                for kname in kernels},
            "device_op_names": sorted({ev.name[:80] for ev in evs})}


def time_call(fn) -> dict:
    """A wrapper call's times: the median of single calls and the
    back-to-back mean (both on CUDA events, the host's issue included),
    and its device profile."""
    ms, ms_b2b = cuda_ms(fn, reps=200, warmup=10)
    return {"ms": ms, "ms_mean_back_to_back": ms_b2b, **device_profile(fn)}


def time_only(knn, swarm, card: str) -> int:
    """``--time-only``: each kernel wrapper timed at its main-path shape on
    the seed-0 spawn, nothing else — so two checkouts (``--root``) can be
    compared in turns within one machine."""
    import torch

    out = {}
    for name, n in (("knn_fused", MAIN_N), ("knn_stream", STREAM_N),
                    ("knn_banded", BANDED_N)):
        cfg = swarm.Config(n=n)
        x = swarm.spawn_positions(cfg, 0, device="cuda").to(
            torch.float32).contiguous()
        kw = ({"window_blocks": swarm.banded_window_blocks(cfg)}
              if name == "knn_banded" else {})
        fn = getattr(knn, name)
        out[name] = {"n": n, **time_call(lambda: fn(x, RADIUS, K, **kw))}
        out[name].pop("device_op_names")
        if name == "knn_stream":
            out[name]["plan"] = knn.stream_plan(n, x.device)
    print(json.dumps({"time_only": out, "package": knn.__file__,
                      "card": card}))
    return 0


def profile_rollout(run, steps: int) -> dict:
    """Where a run of ``steps`` steps spends its time under torch.profiler
    (``run()`` once before, to warm it): device ops, device busy ms per
    step and the busy share of the wall; the knn kernels seen on the
    device, by name, with launches and device ms per step; and per phase
    (consensus/gating/filter/integrate) the host span and the device time
    inside its device-side range — which a graph replay does not record,
    so the compiled run shows "not measured" there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    phases = ("consensus", "gating", "filter", "integrate")
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels, ranges = [], {p: [] for p in phases}
    host = dict.fromkeys(phases, 0.0)
    knn_kernels = {}
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end)
        if ev.name in phases:
            if ev.device_type == cuda:
                ranges[ev.name].append(span)
            else:
                host[ev.name] += (span[1] - span[0]) / 1e3
        elif ev.device_type == cuda and not getattr(
                ev, "is_user_annotation", False):
            kernels.append(span)
            if "knn_" in ev.name:
                k = knn_kernels.setdefault(kernel_name(ev.name), [0, 0.0])
                k[0] += 1
                k[1] += (span[1] - span[0]) / 1e3
    busy_ms = sum(e - s for s, e in kernels) / 1e3
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_ops_per_step": len(kernels) / steps,
           "device_busy_ms_per_step": (busy_ms / steps if kernels
                                       else "not measured"),
           "device_busy_share": (busy_ms / wall_ms if kernels
                                 else "not measured"),
           "knn_kernels": {name: {"launches_per_step": c / steps,
                                  "device_ms_per_step": ms / steps}
                           for name, (c, ms) in sorted(knn_kernels.items())}}
    for p in phases:
        dev = sum(e - s for s, e in kernels
                  if any(a <= s and e <= b for a, b in ranges[p])) / 1e3
        out[p] = {"host_ms_per_step": host[p] / steps,
                  "device_ms_per_step": (dev / steps if ranges[p]
                                         else "not measured")}
    return out


def profile_both(engine, run, label: str, steps: int = 20) -> dict:
    """One eager and one compiled run of ``steps`` steps from the run's
    initial state, profiled side by side (the compiled one's graphs
    captured by the warm-up call)."""
    step, state0 = run["step"], run["state0"]
    prof = {
        "eager": profile_rollout(
            lambda: engine.eager_rollout(step, state0, steps), steps),
        "compiled": profile_rollout(
            lambda: engine.rollout(step, state0, steps), steps)}
    print(f"phase 6: {label} step profile, eager and compiled "
          + json.dumps(prof))
    return prof


def main(argv: list[str]) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--time-only", action="store_true",
                    help="only time the kernel wrappers (no checks, no "
                    "result line)")
    ap.add_argument("--root", default=None,
                    help="import cbf_tpu_torch from this checkout instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.root is not None:
        sys.path.insert(0, args.root)
    from cbf_tpu_torch.ops import knn
    from cbf_tpu_torch.rollout import engine
    from cbf_tpu_torch.scenarios import swarm

    if args.time_only:
        knn.build_library()
        return time_only(knn, swarm, card_line())

    # Full float32 everywhere: the port has no matrix product on the main
    # path, and these pin PyTorch's defaults for anything else.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. build + card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; CUDA graph conditional nodes "
          f"(CUDAGraph.begin_capture_to_if_node): "
          f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}")
    t0 = time.perf_counter()
    so = knn.build_library()
    print(f"phase 1: built {so} in {time.perf_counter() - t0:.1f} s")
    kernel = None
    for line in knn.build_log().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            shown = ("ILi8E" in name or "prologue" in name
                     or ("stream_partial" in name and "ILi16E" in name))
            kernel = name if shown else None
        elif kernel and ("registers" in line or "stack frame" in line):
            print(f"  {kernel}: {line.split(':', 1)[-1].strip()}")
            if "registers" in line:
                kernel = None

    # 2. kernels vs plain versions on the card
    def spawn(n):
        x = swarm.spawn_positions(swarm.Config(n=n), 0, device="cuda")
        return x.to(torch.float32).contiguous()

    plains = {"knn_fused": knn.knn_neighbors_plain,
              "knn_stream": knn.knn_neighbors_blocked_plain,
              "knn_banded": knn.knn_neighbors_banded_plain}
    errs = {name: {} for name in plains}       # N -> max abs err
    compared = {name: {} for name in plains}   # N -> input labels

    def window(n):   # the main path's window for N agents
        return swarm.banded_window_blocks(swarm.Config(n=n))

    def hold(name, label, x, w=None, k=K):
        n = x.shape[0]
        kw = {} if w is None else {"window_blocks": w}
        err, outs = compare(getattr(knn, name), plains[name], x, k=k, **kw)
        errs[name][n] = max(errs[name].get(n, 0.0), err)
        compared[name].setdefault(n, []).append(
            label if k == K else f"{label}, k={k}")
        over = int((outs[-1] > k).sum())
        plan = ""
        if name == "knn_stream":
            plan = " (column ranges %d x %d)" % knn.stream_plan(n, x.device)
        elif name == "knn_banded":
            w_eff = knn.band_setup(x, RADIUS, w)[4]
            plan = (f" (window {w_eff} blocks, ranges %d x %d; overflow rows "
                    f"{int(outs[3].sum())})" % knn.band_plan(n, w_eff,
                                                              x.device))
        print(f"  {name} N={n} k={k} {label}: equal, max_abs_err {err}, rows "
              f"with count > k: {over}{plan}")
        return over

    def hold_prologue(label, x, w):
        got = knn.band_prologue(x, RADIUS, w)
        want = knn.band_setup(x, RADIUS, w)
        torch.cuda.synchronize()
        for part, a, b in zip(("order", "xs", "starts", "block_overflow"),
                              got[:4], want[:4]):
            check(a.dtype == b.dtype and a.shape == b.shape
                  and torch.equal(a, b), f"band_prologue {part} differs from "
                  f"band_setup at N={x.shape[0]} ({label})")
        check(got[4] == want[4], "band_prologue window")
        print(f"  band_prologue N={x.shape[0]} {label}: equal to band_setup "
              f"(window {got[4]} blocks, {int(got[3].sum())} of "
              f"{got[3].shape[0]} row blocks overflow)")

    for n in (256, 4096, 5000, knn.MAX_N_FUSED):
        hold("knn_fused", "spawn", spawn(n))
        check(hold("knn_fused", "packed", spawn(n) * PACK) == n,
              f"packed N={n}: a row holds <= k candidates")
    for n in (1, 37):
        hold("knn_fused", "spawn", spawn(n))
    # Rows 8 bytes off a 16-byte boundary: the staging takes 8-byte copies.
    hold("knn_fused", "spawn, 8-byte aligned", spawn(MAIN_N + 1)[1:])
    for n in (1, 37, 1000, 2000, 4096, 16384, 20000, BANDED_N):
        hold("knn_stream", "spawn", spawn(n))
        over = hold("knn_stream", "packed", spawn(n) * PACK)
        check(n < 4096 or over == n,
              f"packed N={n}: a row holds <= k candidates")
    check(any(knn.stream_plan(n, "cuda")[1] > 1 for n in (1000, 2000)),
          "no phase-2 input splits the columns: the merge launch is not held")
    hold("knn_stream", "spawn, 8-byte aligned", spawn(20001)[1:])
    for k in (1, 16):
        hold("knn_stream", "spawn", spawn(20000), k=k)
        hold("knn_stream", "packed", spawn(20000) * PACK, k=k)
    compare(knn.knn_stream, knn.knn_neighbors_plain, spawn(4096))
    gen = torch.Generator().manual_seed(0)
    for n in (OBST_N, BANDED_N):
        hold("knn_banded", "spawn", spawn(n), window(n))
        check(hold("knn_banded", "packed", spawn(n) * PACK, window(n)) == n,
              f"packed N={n}: a row holds <= k candidates")
        # float64 rows a few float32 ulps apart: the sort sees them apart,
        # the cast may round neighbours onto one float32.
        x64 = (spawn(n).double() + 1e-7 * torch.rand(
            (n, 2), generator=gen, dtype=torch.float64).cuda()).contiguous()
        hold("knn_banded", "spawn float64", x64, window(n))
        for label, x in (("spawn", spawn(n)), ("packed", spawn(n) * PACK),
                         ("spawn float64", x64)):
            hold_prologue(label, x.contiguous(), window(n))
    thin = torch.stack([torch.rand(THIN_N, generator=gen) - 0.5,
                        torch.rand(THIN_N, generator=gen) * 1e-3], 1)
    thin = thin.cuda().contiguous()
    hold("knn_banded", "thin band, 1-block window", thin, 1)
    hold_prologue("thin band, 1-block window", thin, 1)
    check(bool(compare(knn.knn_banded, plains["knn_banded"], thin,
                       window_blocks=1)[1][3].any()),
          "thin band: the window overflow is not flagged")
    thin_big = torch.stack([torch.rand(BANDED_N, generator=gen) - 0.5,
                            torch.rand(BANDED_N, generator=gen) * 1e-2], 1)
    hold_prologue("thin band, 1-block window", thin_big.cuda().contiguous(),
                  1)
    x65 = spawn(BANDED_N)
    idx_b, dist_b, near_b, ovf_b, cnt_b = knn.knn_banded(
        x65, RADIUS, K, window_blocks=window(BANDED_N))
    idx_s, dist_s, near_s, cnt_s = knn.knn_stream(x65, RADIUS, K)
    filled = torch.isfinite(dist_s)
    close = near_s <= RADIUS
    check(not bool(ovf_b.any()) and torch.equal(cnt_b, cnt_s)
          and torch.equal(filled, torch.isfinite(dist_b))
          and torch.equal(idx_b[filled], idx_s[filled])
          and torch.equal(dist_b[filled], dist_s[filled])
          and torch.equal(near_b[close], near_s[close]),
          f"knn_banded and knn_stream differ at N={BANDED_N} on the spawn")
    print("phase 2: knn_fused equal at N=1/37/256/4096/5000/8192 (and on "
          "8-byte-aligned rows), knn_stream equal at N=1/37/1000/2000/4096/"
          f"16384/20000/{BANDED_N} (and on 8-byte-aligned rows, at k=1 and "
          "k=16, and to the fused plain version at 4096), "
          f"knn_banded equal at N={OBST_N}/{BANDED_N}, spawned, packed and "
          "float64, and on the thin band (overflow flagged); band_prologue "
          "equal to band_setup on all of those; knn_banded = knn_stream "
          f"on the filled slots at N={BANDED_N} ({int(filled.sum())} slots)")

    # 3. main path, fused kernel: the north-star N=4096 and the entry()
    # size N=256, each through the compiled rollout and held to the eager
    # loop.
    runs = {}
    for n, steps in ((ENTRY_N, ENTRY_STEPS), (MAIN_N, MAIN_STEPS)):
        cfg = swarm.Config(n=n, steps=steps)
        runs[n] = drive(swarm, engine, knn, cfg, f"phase 3: N={n}",
                        "knn_fused")
        check_run(f"phase 3: N={n} x {steps} steps", cfg, runs[n]["final"],
                  runs[n]["outs"])
    main = runs[MAIN_N]
    state0, final = main["state0"], main["final"]
    qps = MAIN_N * MAIN_STEPS / main["wall"]

    # 4. main path beyond the fused bound, streaming kernel
    cfg_s = swarm.Config(n=STREAM_N, steps=STREAM_STEPS)
    stream = drive(swarm, engine, knn, cfg_s, f"phase 4: N={STREAM_N}",
                   "knn_stream")
    check_run(f"phase 4: N={STREAM_N} x {STREAM_STEPS} steps", cfg_s,
              stream["final"], stream["outs"])
    state0_s, final_s = stream["state0"], stream["final"]
    # The kernels on the main path's own inputs: the states the runs reach.
    hold("knn_fused", "phase 3 final state", final.x.float().contiguous())
    hold("knn_stream", "phase 3 final state", final.x.float().contiguous())
    hold("knn_stream", "phase 4 final state",
         final_s.x.float().contiguous())
    print("phase 4: both kernels equal to their plain versions on the final "
          "states of phases 3 and 4")

    # 5. card vs CPU from the same initial state
    cross_check(swarm, engine, swarm.Config(n=MAIN_N, steps=CROSS_STEPS),
                state0, "phase 5")

    # 7. the banded path at full width, recording the trajectory (the
    # largest output buffer the compiled rollout holds)
    cfg_b = swarm.Config(n=BANDED_N, steps=BANDED_STEPS, gating="banded",
                         record_trajectory=True)
    w_b = swarm.banded_window_blocks(cfg_b)
    banded = drive(swarm, engine, knn, cfg_b, f"phase 7: N={BANDED_N}",
                   "knn_banded")
    check_run(f"phase 7: N={BANDED_N} x {BANDED_STEPS} steps, banded "
              f"(window {w_b} blocks)", cfg_b, banded["final"],
              banded["outs"])
    state0_b, final_b = banded["state0"], banded["final"]
    hold("knn_banded", "phase 7 final state", final_b.x.float().contiguous(),
         w_b)
    print("phase 7: knn_banded equal to its plain version on the final "
          "state (window overflow flags included)")

    # 8. the obstacle field at N=4096 on the banded path
    obst = {}
    for layout in ("scatter", "orbit"):
        cfg_o = swarm.Config(n=OBST_N, steps=OBST_STEPS, n_obstacles=OBST_M,
                             obstacle_layout=layout, gating="banded")
        obst[layout] = drive(swarm, engine, knn, cfg_o,
                             f"phase 8: N={OBST_N}, {OBST_M} obstacles "
                             f"({layout})", "knn_banded")
        obst[layout]["min_distance"] = check_run(
            f"phase 8: N={OBST_N}, {OBST_M} obstacles ({layout}) x "
            f"{OBST_STEPS} steps, banded", cfg_o, obst[layout]["final"],
            obst[layout]["outs"],
            floor=FLOOR if layout == "scatter" else None)
    cross_check(swarm, engine, swarm.Config(
        n=OBST_N, steps=CROSS_STEPS, n_obstacles=OBST_M, gating="banded"),
        obst["orbit"]["state0"], "phase 8 (orbit)")

    # 9. the other dynamics families at N=4096, and card vs CPU at N=256
    dyn = {}
    for family in ("double", "unicycle", "mixed"):
        split = {"n_double": DYN_N // 2} if family == "mixed" else {}
        cfg_d = swarm.Config(n=DYN_N, steps=DYN_STEPS, dynamics=family,
                             **split)
        label = f"phase 9: N={DYN_N}, {family}"
        dyn[family] = drive(swarm, engine, knn, cfg_d, label, "knn_fused")
        dyn[family]["min_distance"] = check_run(
            f"{label} x {DYN_STEPS} steps", cfg_d, dyn[family]["final"],
            dyn[family]["outs"], floor=DYN_FLOORS[family], feasible=False)
        if family == "unicycle":
            deficit = dyn[family]["outs"].saturation_deficit
            check(bool(torch.isfinite(deficit).all()),
                  "unicycle saturation deficit not finite")
            dyn[family]["max_deficit"] = float(deficit.max())
            print(f"{label}: max saturation deficit "
                  f"{dyn[family]['max_deficit']:.6f} m/s")
        small = {"n_double": DYN_CROSS_N // 2} if family == "mixed" else {}
        cfg_x = swarm.Config(n=DYN_CROSS_N, steps=DYN_CROSS_STEPS,
                             dynamics=family, **small)
        cross_check(swarm, engine, cfg_x, swarm.initial_state(cfg_x),
                    f"phase 9 ({family})")

    # 10. the Verlet neighbour cache
    cfg_v = swarm.Config(n=MAIN_N, steps=VERLET_STEPS,
                         gating_rebuild_skin=VERLET_SKIN,
                         record_trajectory=True)
    verlet = drive(swarm, engine, knn, cfg_v,
                   f"phase 10: N={MAIN_N}, Verlet skin {VERLET_SKIN}",
                   "knn_fused")
    verlet["min_distance"] = check_run(
        f"phase 10: N={MAIN_N}, Verlet skin {VERLET_SKIN} x {VERLET_STEPS} "
        "steps (sound floor metric)", cfg_v, verlet["final"],
        verlet["outs"], floor=None)
    # The metric is a lower bound on the true separation (seen pairs plus
    # a bound on the unseen): hold it below the true minimum of every
    # recorded step (the plain nearest-any, float32 sqrt through float64,
    # beside the metric's own float32 sqrt), and the true minimum above
    # the L1 floor. At N=4096 the bound sits below 0.13 (the N=512 bound
    # of tests/test_gating_truncation.py) in the reference too.
    metric = verlet["outs"].min_pairwise_distance
    true_min = torch.stack([
        knn.knn_neighbors_plain(p.contiguous(), RADIUS, K)[2].min()
        for p in verlet["outs"].trajectory]).to(metric.dtype)
    check(bool((metric <= true_min + 1e-6).all()),
          "phase 10: the sound metric exceeds the true separation")
    check(float(true_min.min()) >= FLOOR, f"phase 10: true separation "
          f"{float(true_min.min())} < {FLOOR}")
    verlet["true_min"] = float(true_min.min())
    print(f"phase 10: sound metric min {verlet['min_distance']:.6f} "
          f"{'>=' if verlet['min_distance'] >= VERLET_FLOOR else '<'} "
          f"{VERLET_FLOOR} (reported; the reference's own N=4096 run dips "
          f"too, ROADMAP Queue C), <= the true separation on every step; "
          f"true separation min {verlet['true_min']:.6f} (floor "
          f"{FLOOR:.5f})")
    rebuilds = verlet["info"]["eager_launches"]
    print(f"phase 10: {rebuilds} rebuilds in {VERLET_STEPS} eager steps; "
          f"the graph searches on all {VERLET_STEPS} ("
          f"{VERLET_STEPS / max(rebuilds, 1):.1f}x the eager searches); "
          f"dropped {int(verlet['outs'].gating_dropped_count.sum())}")
    hold("knn_fused", "phase 10 final state",
         verlet["final"].x.float().contiguous())

    # 11. runtime assurance
    from cbf_tpu_torch.rta import RUNG_RESOLVE, RUNG_SCRUB
    from cbf_tpu_torch.utils import faults

    cfg_r = swarm.Config(n=MAIN_N, steps=RTA_STEPS, rta=True)
    rta = {"healthy": drive(swarm, engine, knn, cfg_r,
                            f"phase 11: N={MAIN_N}, RTA armed, healthy",
                            "knn_fused")}
    check_run(f"phase 11: N={MAIN_N}, RTA armed, healthy x {RTA_STEPS} "
              "steps", cfg_r, rta["healthy"]["final"], rta["healthy"]["outs"])
    state_off, step_off = swarm.make(swarm.Config(n=MAIN_N, steps=RTA_STEPS))
    check(torch.equal(state_off.x, rta["healthy"]["state0"].x),
          "phase 11: the rta=False twin spawns elsewhere")
    final_off, outs_off = engine.rollout(step_off, state_off, RTA_STEPS)
    on = rta["healthy"]
    check(torch.equal(on["final"].x, final_off.x)
          and torch.equal(on["final"].v, final_off.v),
          "phase 11: armed-healthy RTA moves x or v")
    for name, a, b in zip(engine.StepOutputs._fields, on["outs"], outs_off):
        if name != "rta_mode":
            check(same_tree(a, b), f"phase 11: armed-healthy RTA changes "
                  f"{name}")
    check(int(on["outs"].rta_mode.max()) == 0,
          "phase 11: the healthy run engaged the ladder")
    print("phase 11: armed-healthy RTA bit-equal to rta=False (x, v, every "
          "count), rta_mode all 0")

    rta["poison"] = drive(
        swarm, engine, knn, cfg_r,
        f"phase 11: N={MAIN_N}, agent 0 poisoned at step {RTA_POISON_AT}",
        "knn_fused", wrap=lambda s: faults.poison_agent_at_step(
            s, RTA_POISON_AT, agent=0))
    modes = rta["poison"]["outs"].rta_mode
    check_run("phase 11: poisoned", cfg_r, rta["poison"]["final"],
              rta["poison"]["outs"], floor=None, feasible=False)
    check(int(modes[RTA_POISON_AT]) == RUNG_SCRUB and int(modes[-1]) == 0
          and all(bool(torch.isfinite(v).all())
                  for v in engine._leaves(rta["poison"]["final"])),
          f"phase 11: rung 3 not engaged at step {RTA_POISON_AT}, not "
          "released, or a row non-finite")
    print(f"phase 11: rung 3 at step {RTA_POISON_AT}, engaged steps "
          f"{int((modes > 0).sum())}, released by step {RTA_STEPS}, every "
          "row finite")

    cfg_c = swarm.Config(n=MAIN_N, steps=RTA_STEPS, n_obstacles=OBST_M,
                         rta=True)
    # On the obstacle ring, as the reference's N=16 clump at the origin
    # lies on its 0.34 m ring: at the origin of the N=4096 swarm (ring
    # radius 5.4 m) nothing passes to unpack the clump, and rung 1 holds
    # to the end of 300 steps (PERF.md §6, PR 7).
    ring = (cfg_c.obstacle_orbit_frac * cfg_c.pack_radius, 0.0)

    def clump(s):
        return faults.teleport_clump_at_step(s, RTA_CLUMP_AT,
                                             agents=range(8), spacing=0.01,
                                             center=ring)

    rta["clump"] = drive(
        swarm, engine, knn, cfg_c,
        f"phase 11: N={MAIN_N}, {OBST_M} obstacles, clump at step "
        f"{RTA_CLUMP_AT} at {ring}", "knn_fused", wrap=clump)
    modes = rta["clump"]["outs"].rta_mode
    check_run("phase 11: clump", cfg_c, rta["clump"]["final"],
              rta["clump"]["outs"], floor=None, feasible=False)
    check(bool((modes == RUNG_RESOLVE).any()) and int(modes[-1]) == 0,
          "phase 11: rung 1 not engaged or not released")
    engaged = (modes > 0).nonzero().flatten()
    zero_counts(engine, knn)
    step_c = clump(swarm.make(cfg_c)[1])
    final_k, outs_k, _ = engine.rollout_chunked(
        step_c, rta["clump"]["state0"], RTA_STEPS, chunk=50)
    chunk_counts = dict(engine.COUNTS)
    eager_outs = rta["clump"]["eager_outs"]
    check(same_tree(final_k, rta["clump"]["final"])
          and all(a == () if isinstance(b, tuple) else
                  np.array_equal(a, b.cpu().numpy())
                  for a, b in zip(outs_k, eager_outs)),
          "phase 11: rollout_chunked differs from the eager loop")
    rta["clump"]["chunked_redos"] = chunk_counts["redos"]
    print(f"phase 11: rung 1 engaged on steps {int(engaged[0])}-"
          f"{int(engaged[-1])} ({engaged.numel()} steps), released; redos: "
          f"rollout {rta['clump']['info']['redos']} of 1 chunk, "
          f"rollout_chunked(chunk=50) {chunk_counts['redos']} of "
          f"{RTA_STEPS // 50} chunks ({chunk_counts['redo_steps']} steps), "
          "both equal to the eager loop")

    # 6. timings at the main-path shapes; launches are every compiled
    # main-path run's of this call, by phase
    all_runs = {"phase 3 N=256": runs[ENTRY_N], "phase 3 N=4096": main,
                "phase 4": stream, "phase 7": banded,
                "phase 8 scatter": obst["scatter"],
                "phase 8 orbit": obst["orbit"],
                **{f"phase 9 {family}": run for family, run in dyn.items()},
                "phase 10": verlet,
                **{f"phase 11 {kind}": run for kind, run in rta.items()}}
    by_phase = {name: {label: run["launches"][name]
                       for label, run in all_runs.items()
                       if run["launches"][name]}
                for name in knn.LAUNCHES}
    rows = []
    x_b = state0_b.x.to(torch.float32).contiguous()
    for name, fn, plain, x, src_line, kw in (
            ("knn_fused", knn.knn_fused, knn.knn_neighbors_plain,
             state0.x.to(torch.float32).contiguous(),
             "cbf_tpu/ops/pallas_knn.py:94", {}),
            ("knn_stream", knn.knn_stream, knn.knn_neighbors_blocked_plain,
             state0_s.x.to(torch.float32).contiguous(),
             "cbf_tpu/ops/pallas_knn.py:184", {}),
            ("knn_banded", knn.knn_banded, knn.knn_neighbors_banded_plain,
             x_b, "cbf_tpu/ops/pallas_knn.py:309",
             {"window_blocks": w_b})):
        launches_n = sum(by_phase[name].values())
        n = x.shape[0]
        out = fn(x, RADIUS, K, **kw)
        count = out[-1]
        if name == "knn_banded":
            # Pairs in the windows (N_pad x W x CTILE); outputs add the
            # overflow flag; the windows' starts are read once.
            n_pad = -(-n // knn.CTILE) * knn.CTILE
            w = min(w_b, n_pad // knn.CTILE)
            pairs = n_pad * w * knn.CTILE
            nbytes = 8 * n + 4 * (n_pad // knn.RTILE) + n * (K * 8 + 9)
        else:
            pairs = n * n
            nbytes = 8 * n + n * K * 8 + n * 8
        ops = OPS_PER_PAIR * pairs + K * int(count.sum())
        t_ops = ops / PEAK_F32_ISSUE_PER_S
        t_bytes = nbytes / PEAK_BYTES_PER_S
        timed = time_call(lambda: fn(x, RADIUS, K, **kw))
        names = timed.pop("device_op_names")
        row = {
            "name": name, "route": "cuda",
            "source": "cbf_tpu_torch/csrc/knn.cu",
            "replaces": src_line, "launches": launches_n,
            "launches_by_phase": by_phase[name],
            "max_abs_err": errs[name][n], "equal": True, "n": n,
            "compared_at_n": compared[name][n], **timed,
            "plain_ms": cuda_ms(lambda: plain(x, RADIUS, K, **kw), reps=10,
                                warmup=2)[0],
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        }
        if name == "knn_stream":
            # The column plan, and the scan's and the merge's device times
            # apart (no merge is launched when the plan is one range).
            by_name = timed["kernel_device_ms_by_name"]
            row["cols_per_split"], row["splits"] = knn.stream_plan(n,
                                                                   x.device)
            row["partial_device_ms"] = by_name.get(
                "knn_stream_partial_kernel", "not measured")
            row["merge_device_ms"] = by_name.get(
                "knn_stream_merge_kernel",
                "not launched" if row["splits"] == 1 else "not measured")
        if name == "knn_banded":
            # The partials and merge alone, on the sorted inputs the
            # prologue makes (the earlier single-launch design's scope),
            # the prologue alone (sort included), and what one wrapper
            # call issues on the device.
            _, xs, starts, _, w_eff = knn.band_setup(x, RADIUS, w_b)
            row["window_blocks"] = w_eff
            row["overflow_rows"] = int(out[3].sum())
            row["kernel_only_ms"], row["kernel_only_ms_back_to_back"] = \
                cuda_ms(lambda: knn.knn_banded_sorted(xs, starts, RADIUS, K,
                                                      w_eff),
                        reps=200, warmup=10)
            row["kernel_only_device_ms"] = device_profile(
                lambda: knn.knn_banded_sorted(xs, starts, RADIUS, K, w_eff)
            )["kernel_device_ms"]
            row["prologue_ms"], row["prologue_ms_back_to_back"] = cuda_ms(
                lambda: knn.band_prologue(x, RADIUS, w_b), reps=200,
                warmup=10)
            prologue = device_profile(lambda: knn.band_prologue(x, RADIUS,
                                                                w_b))
            row["prologue_device_ms"] = prologue["device_ms"]
            row["prologue_kernel_device_ms"] = prologue["kernel_device_ms"]
            row["device_op_names"] = names
        rows.append(row)
    x4096 = state0.x.to(torch.float32).contiguous()
    stream_small = cuda_ms(lambda: knn.knn_stream(x4096, RADIUS, K),
                           reps=200, warmup=10)
    stream_small_dev = device_profile(
        lambda: knn.knn_stream(x4096, RADIUS, K))["kernel_device_ms"]
    print(f"phase 6: knn_stream at N={MAIN_N} (the gating='streaming' "
          f"shape, column ranges %d x %d): median {stream_small[0]:.4f} ms, "
          f"back to back {stream_small[1]:.4f} ms, device "
          f"{stream_small_dev} ms" % knn.stream_plan(MAIN_N, x4096.device))
    for label, run in ((f"N={ENTRY_N} fused", runs[ENTRY_N]),
                       (f"N={MAIN_N} fused", main),
                       (f"N={STREAM_N} streaming", stream),
                       (f"N={BANDED_N} banded", banded),
                       (f"N={OBST_N} obstacles (scatter), banded",
                        obst["scatter"]),
                       (f"N={OBST_N} obstacles (orbit), banded",
                        obst["orbit"]),
                       *((f"N={DYN_N} {family}", dyn[family])
                         for family in dyn),
                       (f"N={MAIN_N} Verlet", verlet),
                       (f"N={MAIN_N} RTA armed, healthy", rta["healthy"])):
        prof = profile_both(engine, run, label)
        check(prof["compiled"]["knn_kernels"] != {}
              or prof["compiled"]["device_ops_per_step"] == 0,
              f"{label}: no knn kernel inside the graph replay")
    print(f"elapsed {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print("compiled rollout, best of two (eager beside it): "
          + "; ".join(f"{label} x {run['info']['steps']} steps "
                      f"{max(run['info']['compiled_agent_qp_steps_per_s']):.1f}"
                      f" ({max(run['info']['eager_agent_qp_steps_per_s']):.1f}"
                      ") agent-QP-steps/s"
                      for label, run in ((f"N={ENTRY_N}", runs[ENTRY_N]),
                                         (f"N={MAIN_N}", main),
                                         (f"N={STREAM_N}", stream),
                                         (f"N={BANDED_N} banded", banded),
                                         (f"N={OBST_N} scatter",
                                          obst["scatter"]),
                                         (f"N={OBST_N} orbit",
                                          obst["orbit"]),
                                         *((f"N={DYN_N} {family}", run)
                                           for family, run in dyn.items()),
                                         (f"N={MAIN_N} Verlet", verlet),
                                         *((f"N={MAIN_N} RTA {kind}", run)
                                           for kind, run in rta.items())))
          + f"; main path {qps:.1f} agent-QP-steps/s; orbit min distance "
          f"{obst['orbit']['min_distance']:.6f}; card {card}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
