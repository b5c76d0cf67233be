"""Chip smoke test of the PyTorch/CUDA port (``cbf_tpu_torch``).

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on any failure):

1. build the k-NN kernels from ``cbf_tpu_torch/csrc/knn.cu`` with nvcc
   and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card —
   ``knn_fused`` at N in {256, 4096, 5000}, ``knn_stream`` at N in
   {4096 (forced), 16384, 20000}, k=8, radius 0.4, seeded spawn positions,
   and the same spawns packed 4x closer (every row then holds more than k
   in-radius candidates, the top-k's overflow branch) — every output must
   be equal;
3. drive the main path — ``swarm.make(Config(n=4096))``, ``gating="auto"``,
   500 steps through ``rollout`` — and check one ``knn_fused`` launch per
   step, the separation floor and zero infeasible QPs;
4. the same at N=16384 for 50 steps, which routes to ``knn_stream``; then
   hold both kernels against their plain versions again on the final
   states of phases 3 and 4, the main path's own inputs;
5. the same N=4096 initial state for 20 steps on the card and on the CPU
   (plain version there): positions and min distances within a stated
   tolerance, the per-step counts equal;
6. time each kernel at its main-path shape (median of single launches)
   beside its bound and its plain version; a short profile of the
   main-path step.

Stdout ends with the ``{"kernels": [...]}`` line, the main path's
agent-QP-steps/s, the card line, and, last, the result line
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
MAIN_N, MAIN_STEPS = 4096, 500
STREAM_N, STREAM_STEPS = 16384, 50
CROSS_STEPS = 20
# Card vs CPU after CROSS_STEPS steps: positions reach ~13 m, where a
# float32 ulp is ~1e-6, and the two devices reduce the centroid mean in
# different orders, so the trajectories part by a few ulps per step;
# 1e-4 m leaves ~5x headroom over 20 steps of that, and the min-distance
# series (values ~0.2 m, ulp ~1.5e-8) gets 1e-5.
CROSS_X_ATOL, CROSS_MD_ATOL = 1e-4, 1e-5


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


def compare(kernel_fn, plain_fn, x) -> tuple[float, int]:
    """Kernel vs plain on the same card input: all four outputs must be
    equal. Returns the max abs difference of the float outputs (finite
    entries; 0.0 when equal) and the rows holding more than k in-radius
    candidates (the top-k's overflow branch)."""
    import torch

    got, want = kernel_fn(x, RADIUS, K), plain_fn(x, RADIUS, K)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("idx", "dist", "nearest", "count"), got, want):
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
    return err, int((want[3] > K).sum())


def drive(swarm, rollout, knn, cfg):
    """One main-path run through the user entry points, counts zeroed just
    before and read just after. Returns (state0, final, outs, launches,
    wall_s)."""
    import torch

    state0, step = swarm.make(cfg)
    torch.cuda.synchronize()
    for name in knn.LAUNCHES:
        knn.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    final, outs = rollout(step, state0, cfg.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(knn.LAUNCHES)
    return state0, final, outs, launches, wall


def check_run(label, cfg, final, outs):
    import torch

    md = outs.min_pairwise_distance
    check(tuple(md.shape) == (cfg.steps,), f"{label}: min-distance shape")
    check(tuple(final.x.shape) == (cfg.n, 2), f"{label}: state shape")
    check(bool(torch.isfinite(final.x).all())
          and bool(torch.isfinite(final.v).all()), f"{label}: non-finite")
    md_min = float(md.min())
    infeasible = int(outs.infeasible_count.sum())
    check(md_min >= FLOOR, f"{label}: min distance {md_min} < {FLOOR}")
    check(infeasible == 0, f"{label}: {infeasible} infeasible agent-steps")
    print(f"{label}: min distance {md_min:.6f} (floor {FLOOR:.5f}), "
          f"infeasible 0, filter-active mean "
          f"{float(outs.filter_active_count.float().mean()):.1f}, "
          f"dropped {int(outs.gating_dropped_count.sum())}")


def profile_step(step, state, steps: int) -> dict:
    """Where a main-path step's time goes, over ``steps`` steps under
    torch.profiler: per phase (consensus/gating/filter/integrate) the host
    span and the device kernel time inside its device-side range, plus the
    device's busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    phases = ("consensus", "gating", "filter", "integrate")
    for _ in range(3):
        state, _ = step(state, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(steps):
            state, _ = step(state, t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels, ranges = [], {p: [] for p in phases}
    host = dict.fromkeys(phases, 0.0)
    n_kernels = 0
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
            n_kernels += 1
    busy_ms = sum(e - s for s, e in kernels) / 1e3
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_ops_per_step": n_kernels / steps,
           "device_busy_ms_per_step": (busy_ms / steps if kernels
                                       else "not measured"),
           "device_busy_share": (busy_ms / wall_ms if kernels
                                 else "not measured")}
    for p in phases:
        dev = sum(e - s for s, e in kernels
                  if any(a <= s and e <= b for a, b in ranges[p])) / 1e3
        out[p] = {"host_ms_per_step": host[p] / steps,
                  "device_ms_per_step": (dev / steps if ranges[p]
                                         else "not measured")}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from cbf_tpu_torch.ops import knn
    from cbf_tpu_torch.rollout.engine import rollout
    from cbf_tpu_torch.scenarios import swarm

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
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    so = knn.build_library()
    print(f"phase 1: built {so} in {time.perf_counter() - t0:.1f} s")
    kernel = None
    for line in knn.build_log().splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "ILi8E" in line else None
        elif kernel and "registers" in line:
            print(f"  k=8 {kernel}: {line.split(':', 1)[1].strip()}")
            kernel = None

    # 2. kernels vs plain versions on the card
    def spawn(n):
        x = swarm.spawn_positions(swarm.Config(n=n), 0, device="cuda")
        return x.to(torch.float32).contiguous()

    plains = {"knn_fused": knn.knn_neighbors_plain,
              "knn_stream": knn.knn_neighbors_blocked_plain}
    errs = {"knn_fused": {}, "knn_stream": {}}   # N -> max abs err
    compared = {"knn_fused": {}, "knn_stream": {}}   # N -> input labels

    def hold(name, label, x):
        n = x.shape[0]
        err, over = compare(getattr(knn, name), plains[name], x)
        errs[name][n] = max(errs[name].get(n, 0.0), err)
        compared[name].setdefault(n, []).append(label)
        plan = (" (column ranges %d x %d)" % knn.stream_plan(n, x.device)
                if name == "knn_stream" else "")
        print(f"  {name} N={n} {label}: equal, max_abs_err {err}, rows with "
              f"count > k: {over}{plan}")
        return over

    for n in (256, 4096, 5000):
        hold("knn_fused", "spawn", spawn(n))
        check(hold("knn_fused", "packed", spawn(n) * PACK) == n,
              f"packed N={n}: a row holds <= k candidates")
    for n in (4096, 16384, 20000):
        hold("knn_stream", "spawn", spawn(n))
        check(hold("knn_stream", "packed", spawn(n) * PACK) == n,
              f"packed N={n}: a row holds <= k candidates")
    compare(knn.knn_stream, knn.knn_neighbors_plain, spawn(4096))
    print("phase 2: knn_fused equal at N=256/4096/5000, knn_stream equal at "
          "N=4096/16384/20000 (and to the fused plain version at 4096), "
          "spawned and packed")

    # 3. main path, fused kernel
    cfg = swarm.Config(n=MAIN_N, steps=MAIN_STEPS)
    state0, final, outs, launches, wall = drive(swarm, rollout, knn, cfg)
    check(launches == {"knn_fused": MAIN_STEPS, "knn_stream": 0},
          f"main path launches {launches}")
    check_run(f"phase 3: N={MAIN_N} x {MAIN_STEPS} steps", cfg, final, outs)
    qps = MAIN_N * MAIN_STEPS / wall
    fused_launches = launches["knn_fused"]

    # 4. main path beyond the fused bound, streaming kernel
    cfg_s = swarm.Config(n=STREAM_N, steps=STREAM_STEPS)
    state0_s, final_s, outs_s, launches_s, wall_s = drive(
        swarm, rollout, knn, cfg_s)
    check(launches_s == {"knn_fused": 0, "knn_stream": STREAM_STEPS},
          f"streaming path launches {launches_s}")
    check_run(f"phase 4: N={STREAM_N} x {STREAM_STEPS} steps", cfg_s,
              final_s, outs_s)
    stream_launches = launches_s["knn_stream"]
    # The kernels on the main path's own inputs: the states the runs reach.
    hold("knn_fused", "phase 3 final state", final.x.float().contiguous())
    hold("knn_stream", "phase 3 final state", final.x.float().contiguous())
    hold("knn_stream", "phase 4 final state",
         final_s.x.float().contiguous())
    print("phase 4: both kernels equal to their plain versions on the final "
          "states of phases 3 and 4")

    # 5. card vs CPU from the same initial state
    cfg_c = swarm.Config(n=MAIN_N, steps=CROSS_STEPS)
    _, step_gpu = swarm.make(cfg_c)
    _, step_cpu = swarm.make(cfg_c, device="cpu")
    fg, og = rollout(step_gpu, state0, CROSS_STEPS)
    fc, oc = rollout(step_cpu, swarm.State(x=state0.x.cpu(),
                                           v=state0.v.cpu()), CROSS_STEPS)
    dx = float(torch.amax(torch.abs(fg.x.cpu() - fc.x)))
    dmd = float(torch.amax(torch.abs(og.min_pairwise_distance.cpu()
                                     - oc.min_pairwise_distance)))
    print(f"phase 5: card vs CPU over {CROSS_STEPS} steps at N={MAIN_N}: "
          f"max |dx| {dx:.3e} (atol {CROSS_X_ATOL}), max |d min-dist| "
          f"{dmd:.3e} (atol {CROSS_MD_ATOL})")
    check(dx <= CROSS_X_ATOL and dmd <= CROSS_MD_ATOL,
          "card and CPU trajectories part beyond tolerance")
    for field in ("filter_active_count", "infeasible_count",
                  "gating_dropped_count"):
        a, b = getattr(og, field).cpu(), getattr(oc, field)
        print(f"  {field} per step, card vs CPU: sums {int(a.sum())} / "
              f"{int(b.sum())}")
        check(torch.equal(a, b), f"{field} differs between card and CPU")

    # 6. timings at the main-path shapes
    rows = []
    for name, fn, plain, x, launches_n, src_line in (
            ("knn_fused", knn.knn_fused, knn.knn_neighbors_plain,
             state0.x.to(torch.float32).contiguous(), fused_launches,
             "cbf_tpu/ops/pallas_knn.py:94"),
            ("knn_stream", knn.knn_stream, knn.knn_neighbors_blocked_plain,
             state0_s.x.to(torch.float32).contiguous(), stream_launches,
             "cbf_tpu/ops/pallas_knn.py:184")):
        n = x.shape[0]
        count = fn(x, RADIUS, K)[3]
        ops = OPS_PER_PAIR * n * n + K * int(count.sum())
        nbytes = 8 * n + n * K * 8 + n * 8
        t_ops = ops / PEAK_F32_ISSUE_PER_S
        t_bytes = nbytes / PEAK_BYTES_PER_S
        ms, ms_b2b = cuda_ms(lambda: fn(x, RADIUS, K), reps=200, warmup=10)
        rows.append({
            "name": name, "route": "cuda",
            "source": "cbf_tpu_torch/csrc/knn.cu",
            "replaces": src_line, "launches": launches_n,
            "max_abs_err": errs[name][n], "equal": True, "n": n,
            "compared_at_n": compared[name][n],
            "ms": ms, "ms_mean_back_to_back": ms_b2b,
            "plain_ms": cuda_ms(lambda: plain(x, RADIUS, K), reps=10,
                                warmup=2)[0],
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
    x4096 = state0.x.to(torch.float32).contiguous()
    stream_small = cuda_ms(lambda: knn.knn_stream(x4096, RADIUS, K),
                           reps=200, warmup=10)
    print(f"phase 6: knn_stream at N={MAIN_N} (the gating='streaming' "
          f"shape): median {stream_small[0]:.4f} ms, back to back "
          f"{stream_small[1]:.4f} ms")
    prof = profile_step(swarm.make(swarm.Config(n=MAIN_N))[1], state0, 20)
    print("phase 6: main-path step profile " + json.dumps(prof))
    print(f"elapsed {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(f"main path N={MAIN_N}, {MAIN_STEPS} steps: "
          f"{qps:.1f} agent-QP-steps/s ({wall:.3f} s wall); "
          f"N={STREAM_N}, {STREAM_STEPS} steps: "
          f"{STREAM_N * STREAM_STEPS / wall_s:.1f} agent-QP-steps/s; "
          f"card {card}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
