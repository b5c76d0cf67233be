"""Chip smoke test of the PyTorch/CUDA port (``cbf_tpu_torch``).

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on any failure):

1. build the k-NN kernels from ``cbf_tpu_torch/csrc/knn.cu`` with nvcc,
   print the registers and spills of the k=8 kernels and of the k=16
   ``knn_fused`` and ``knn_stream`` scans (the certificate's search), and
   print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card —
   ``knn_fused`` at N in {1, 37, 256, 4096, 5000, 8192} and on rows 8
   bytes off a 16-byte boundary, ``knn_stream`` at N in {1, 37, 1000,
   2000, 4096 (forced), 16384, 20000, 65536} (1000 and 2000 split into
   several column ranges, so the merge launch is held too; the others
   scan one range), on rows 8 bytes off a 16-byte boundary and at k=1 and
   k=16 (N=20000), and at the certificate's search — k=16 at its
   binding-pair radius 0.5707 — ``knn_fused`` at N in {37, 256, 4096,
   8192} and ``knn_stream`` at N in {4096 (forced), 16384}, spawned and
   packed, ``knn_banded`` at N in {4096, 65536}
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
   compiled are timed in turns (eager, compiled, compiled, eager; the
   eager legs over the first 100 steps of the horizon) and the
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
   with the device ops one call issues (profiler); then profile 10 steps
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

12. the joint barrier certificate, each run compiled and held to the
   eager loop as in phase 3 (both certificate carries included), with
   ``knn_fused`` launched twice per step (the gating search and the
   certificate's): 12a ``Config(n=4096, certificate=True)`` x 20 (the
   sparse backend, k=16, 100 ADMM iterations x 8 CG); 12b the same warm
   started with ``certificate_tol=1e-5`` (the adaptive budget's guarded
   blocks), and again x 10 with one guarded block, which must redo its
   chunk eagerly and still equal the eager loop; 12c
   ``certificate_fused`` (Chebyshev) with the certificate's Verlet cache,
   skin 0.1, x 15 (eager rebuilds printed);
   12d ``Config(n=128, certificate=True)``, the dense backend (Cholesky
   in the captured body, one launch per step) x 50; each with max
   certificate residual < 1e-4 (``bench.py``'s gate), 0 infeasible and
   min distance >= 0.13 (``bench.py``'s floor), and R, B, redos, the
   per-step iterations histogram, the dropped count, peak memory and the
   first call's seconds printed; ``knn_fused`` at k=16 held on 12a's
   final state; 12e ``Config(n=256, certificate=True)`` x 10 on the card
   and on the CPU as in phase 5, the certificate's counts included. (12a-c
   ran 100/100/50 steps before phase 13 came; they were cut to 50/50/30,
   with the 12a profile from 3 steps to 2, to keep the script near ten
   minutes, and to 30/30/30, the 12a profile to 1 step and 12d's from 5
   to 2, when phase 17 came, to keep it under 850 s, and to 20/20/15 when
   phase 20 came: an eager sparse step takes 0.26-0.38 s on an H100 80GB HBM3
   at 700 W, PERF.md §5.)
13. the reference scenarios, the CLI and the compat layer: 13a
   ``meet_at_center`` (10 robots x 1000 iterations), 13b
   ``cross_and_rescue`` (4 robots, 6 ring obstacles, the dense
   certificate, x 3000) and 13c ``antipodal`` (N=32 x 1500), each at its
   default Config through its ``make`` and the compiled rollout over its
   whole horizon, held ``torch.equal`` to the eager loop over the first
   300 steps (13b: its first 100, as an eager step takes 54-107 ms on an
   H100 80GB HBM3 at 700 W, PERF.md §5),
   launching no knn kernel, each with the bounds of
   tests/test_scenarios.py (13a: free-agent spread < 0.35, min distance >
   0.05, the filter engaged on > 100 agent-steps of the first 400; 13b:
   goal distances min < 0.15 and max < 0.6, min distance > 0.1, residual
   < 1e-4; 13c: all 32 within 0.2 m of their antipodes, min distance >
   0.2/sqrt(2) - 5e-3) and 0 infeasible, R, redos, the relax histogram,
   the step walls eager and compiled in turns (13a and 13c over 200
   steps, 13b over 25), the
   device ops per step and the first call's seconds printed; 13d the
   golden anchor: float64 ``meet_at_center`` on the card for 5 steps
   within 5e-5 of the float64 numpy replay through the port's SLSQP
   oracle; 13e 13a and 13c for 50 steps on the card and on the CPU within
   CROSS_X_ATOL, every count equal; 13f ``cbf_tpu_torch.__main__.main``
   in process: ``run swarm --set n=4096 --steps 200 --traj`` (the floor,
   0 infeasible, one ``knn_fused`` launch per step, the ``.cbt`` read back
   equal to the run's trajectory), ``run meet_at_center --video`` (a gif)
   and ``list``; 13g ``examples.meet_at_center_compat`` x 200 on the card
   and on the CPU, final poses within CROSS_X_ATOL, wall per step printed.

14. the differentiable path, the trainer and the falsifier: 14a the
   member axis — ``knn_fused`` (N=256, 4096) and ``knn_stream`` (N=256,
   1000: several column ranges) at B in {1, 3, 16} members of different
   spawns, packed and spread, k=8 and 16, each output ``torch.equal`` to
   the batched plain version and to B single launches (B=1: to the
   single-swarm launch); 14b the trainer at N=4096, E=2, an 8-step
   horizon with remat, 3 Adam steps on the dense spawn of
   ``examples/train_safety_params.py`` (finite losses, a later one below
   the first; 2 x E x 8 ``knn_fused`` launches per step, the forward and
   the remat replay), and one loss and gradient at N=256 on the card and
   on the CPU within TRAIN_CROSS_*; 14c the same with
   ``gating="streaming"``: ``knn_stream`` launched, loss and gradient
   ``torch.equal`` to 14b's; 14d the two-layer trainer at N=512 (sparse
   certificate, k=4, 4-step horizon, 3 Adam steps, descending) and the
   certificate's gradient through ``_solve_K``'s Function against a
   finite-difference probe (tests/test_sparse_certificate.py:439-484's
   N=1024 probe); 14e the falsifier at ``bench.py``'s BENCH_VERIFY shape
   (N=256 x 200, batch 16): fresh and warm candidates/s, one
   member-batched ``knn_fused`` launch per step per batch, two of a
   batch's candidates run alone through the eager step against the
   batch's margins, ``random`` then ``cem`` (3 rounds each), and one
   ``gating="streaming"`` batch (member-batched ``knn_stream``); 14f the
   falsification walkthrough (``examples/falsify_swarm.py`` on the card:
   the weakened filter falsified, shrunk, confirmed in float64, archived
   and replayed; the default survives) and ``gradient_search``'s batch
   gradients finite; 14g the checked-in corpus replayed in float64 on the
   card and the CPU (verdicts exact, margins within CORPUS_REPLAY_ATOL)
   and ``verify`` in process on the weakened corpus config (exit 3) and
   the default (exit 0).

15. the member axis on one card: 15a the member-axis ``knn_banded`` (one
   launch set of the prologue, the window partials and the merge for B
   swarms) at B in {1, 3, 16} (N=256, 4096) and B=4 at N=65536 (phase
   7's width, W=4), members of different spawns, packed and spread, each
   output ``torch.equal`` to the batched plain version and to B single
   launches (B=1: the single-swarm launch), the member-axis prologue and
   sorted-order launches equal to ``band_setup`` and their plain version,
   and a thin member that alone flags overflow; timed at the falsifier's
   shape (N=256, B=16) and at N=65536, B=4, beside one member alone and
   the bound; 15b the falsifier on ``gating="banded"`` at BENCH_VERIFY's
   shape (one member-axis banded launch set per step per batch, 0
   redos, two candidates run alone against the batch within
   MEMBER_MARGIN_ATOL, fresh and warm candidates/s); then
   ``parallel.ensemble.sharded_swarm_rollout`` on the card's (1, 1) mesh,
   each run held ``torch.equal`` to the eager loop of the same step
   program (final carry and every metric), timed, launches per step and
   peak memory printed: 15c BASELINE.md:31's Monte-Carlo sweep, 1024
   seeds x 64 agents x 500 steps, held to the eager loop over the first
   100 (one member-axis ``knn_fused`` launch
   per step), 0 infeasible and in every member the floor, or, for the
   seeds whose reference run itself dips below it (MC_REFERENCE_DIPS,
   measured with the JAX package on the CPU), the reference's own
   minimum; 15d 8 members of 4096 x 300 steps, fused and forced
   streaming (member-axis ``knn_stream``), the two trajectories equal,
   held as 15c (ENS_REFERENCE_DIPS); in 15c and 15d the member-axis
   launch of the run (``knn_fused``; ``knn_stream`` in 15d streaming) is
   also called on the ensemble's own spawn and final positions at the
   step's radius and k, each output ``torch.equal`` to its plain version
   and to single launches of members 0, 1, E/2 and E-1, and one launch
   on the final positions timed beside its bound;
   15e the lockstep batched sparse certificate, 4 members of 4096 x 10
   steps: every member's residual under the gate, 0 infeasible, the
   batched run against each member run alone within LOCK_*_ATOL, device
   ops per step; 15f chunk=25 ``torch.equal`` to the unchunked run (4 x
   4096 x 100), a warm-carry resume at step 50 (``with_solver_state``,
   4 x 4096 sparse certificate, warm start under certificate_tol, no
   redo, its per-step iteration histogram printed)
   ``torch.equal`` to the straight run, and the Verlet cache at E=1
   against the exact search (equal trajectories below truncation, the
   sound floor at or below the exact separation).

16. durability and observability at the flagship width
   (``Config(n=4096)``, ``gating="auto"``: one ``knn_fused`` per step):
   16a ``rollout_chunked`` x 2000 in 500-step chunks with
   ``checkpoint_dir`` ``torch.equal`` to the run without (final state,
   every StepOutputs field), both timed in turns, the synchronous save
   and the verified restore timed per boundary, the bytes of a step,
   every retained manifest verified against its boundary's state, the
   damaged newest step walked back and a fully damaged directory
   refused; 16b ``python3 -m cbf_tpu_torch run swarm --device cuda --set
   n=4096 --steps 2000 --chunk 500 --durable-dir D`` SIGKILLed once its
   first manifest is committed, ``run --resume D`` from a step > 0, its
   stitched outputs and final state byte-identical to an uninterrupted
   ``run_durable`` of the same spec, the MTTR from ``resume_log.jsonl``;
   16c the compiled x 500 rollout with ``telemetry_every=50``: each
   heartbeat equal to ``StepOutputs[t]``, the run ``torch.equal`` to the
   one without, telemetry on and off timed in turns (off, on, on, off),
   the overhead printed beside JAX's 3% budget and held under 10% (and
   split: every-step chunks without the tap, the tap in one chunk, each
   timed in turns beside the run without, device ops and busy share on
   and off from torch.profiler over 50 steps), and the watchdog raising
   ``nan`` (``faults.nan_at_step``),
   ``certificate_blowup`` (``faults.residual_blowup_at_step`` on the warm
   sparse certificate at N=256) and ``stall`` (``faults.stall_at_step``,
   2 s); 16d ``checked_rollout`` clean on the x 500 run and locating an
   injected inf at its step, ``rollout(cost_model=)`` ``torch.equal`` to
   the run without (peak bytes per agent and the warm drift printed), and
   ``run --profile-dir`` writing a trace with the consensus, gating,
   filter and integrate spans and ``knn_fused``. Every run's launches are
   counted (zeroed just before, read just after) into the kernel table.

17. the traced-config serving path: 17a the radius array — ``knn_fused``
   at B=16 x N=256 (radii 0.4 + 0.003 (i % 5), 0.0 and 1.0), B=8 x
   N=4096 and at k=16 (r = 0.5707 +- 0.01), ``knn_stream`` at B=8 x
   N=4096 (forced) and B=4 x N=1000 (several ranges, the merge too), each
   launch with one radius per member ``torch.equal`` to B single launches
   at each member's radius and to the batched plain version, the launch
   with every radius equal to the scalar launch, each timed beside the
   scalar launch of its shape; 17b ``bench.py``'s ``serve_workload``
   (copied here) through ``parallel.ensemble.lockstep_traced_rollout``,
   one program per bucket, at full width (base 4096, B=8, 128 steps,
   max_batch 4: buckets 4096 and 2048) and at the serve bench's default
   (base 128, B=16, 512 steps, max_batch 8): one ``knn_fused`` launch per
   step per batch with the radius array, compiled ``torch.equal`` to the
   eager loop of the same vmapped step, each trimmed request held to its
   own ``swarm.make`` + ``rollout`` run (trajectory within 2e-4, 0
   infeasible, the first step where a count differs printed), then the
   batched programs timed against the same requests one after another
   (graphs cached) in turns, requests/s and member agent-QP-steps/s for
   both and their ratio beside the JAX package's 1.5x gate; 17c
   ``lockstep_traced_chunk`` (bucket 256, chunk 32, B=8): lanes at clocks
   0, 32 and 64 and two vacant, a lane joining at a chunk boundary
   ``torch.equal`` to it running alone, pads parked, one capture for
   every chunk call with the traced values changed between calls; 17d a
   B=4 bucket-64 batch x 64 steps on ``gating="streaming"`` (the
   ``knn_stream`` radius array) on the card and on the CPU, within
   CROSS_X_ATOL and CROSS_MD_ATOL, every count equal.
18. the serve engine's drain mode (``cbf_tpu_torch.serve.ServeEngine``):
   18a phase 17b's full-width workload (base 4096, B=8, 128 steps,
   ``max_batch`` 4) through ``prewarm`` (its captures and wall printed;
   phase 17b's programs are reused through the process-wide cache) and
   ``run()``: one ``knn_fused`` launch per step per batch, each result
   ``np.array_equal`` to its packed batch run through
   ``lockstep_traced_rollout`` directly, then ``run()`` and the direct
   programs timed in turns (requests/s both) and one ``run()``'s host
   spans per lifecycle phase printed; 18b queue mode at the serve default
   (base 128, B=16, 512 steps, ``max_batch`` 8): ``start``, 16 submits,
   ``stop``, equal to ``run()``'s results, p50/p99 latency, queue wait
   against execute and requests/s beside phase 17b's legs and the 1.5x
   gate, and a second engine without ``prewarm`` (the program cache
   cleared) that captures on its scheduler thread while this thread waits
   in ``result(timeout)``, equal too; 18c the fault ladder in bucket 256
   x 64 steps: a poisoned request (``faults.poison_config``) in a full
   batch of 8 fails alone with ``NonFiniteResult`` in one batch, its 7
   mates ``np.array_equal`` to a clean batch's lanes, one transient
   fault retried once, a permanent one bisected 3 times, a capture
   failure charging the bucket breaker with no capture, and
   ``rta_fallback`` rescuing a poisoned request (its outcome printed
   beside the JAX package's on the CPU, RESCUE_JAX_CPU); 18d ``python -m
   cbf_tpu_torch serve --journal J`` on 16 requests SIGKILLed once the
   first ``resolved`` record lands, then ``serve --journal J --recover``:
   every acknowledged request resolved exactly once, none lost, each
   recovered result's min distance and infeasible count equal to an
   uninterrupted run's, and the time from the kill to the first
   recovered result split into import and CUDA init, capture and
   execute.
19. the serve engine's continuous scheduler (``ServeEngine(continuous=
   True)``, lane tables advanced one ``lockstep_traced_chunk`` at a time):
   19a phase 17b's full-width workload with ``gating="pallas"``
   (buckets 4096 and 2048, ``max_batch`` 4, 32-step chunks) through
   ``prewarm`` (one capture per static config, no drain program) and
   ``start``: a 128-step request solo, then its twin joining a lane
   table where a 512-step runner is in flight — ``np.array_equal`` to the
   solo run, its partials at [32, 64, 96, 128] stitched equal to its
   resolved outputs, one ``knn_fused`` launch per chunk step, and
   against the drain engine's result for the same request (bit equality
   and the largest gap printed, held within 2e-4 with every count
   equal); the chunk wall and execute by lanes filled from the lane
   ledger; 19b a 4096-step request with a 0.5 s deadline leaving its
   table mid-flight while its 128-step batch-mate stays
   ``np.array_equal`` to its solo run; 19c ``LoadSpec(rps=24,
   duration_s=3, n 64-128, steps 128/256/512, gating="pallas")`` through
   ``run_loadgen`` on a drain and a continuous engine (``max_batch`` 8,
   16-step chunks), both prewarmed, in turns (drain, continuous,
   continuous, drain): every request completes above the floor with 0
   infeasible, achieved req/s, p50/p99 latency, queue wait against
   execute and TTFP printed per leg, the ledger's occupancy, bubble and
   dispatch shares with its exact identity; 19d ``python -m
   cbf_tpu_torch loadgen --continuous --metrics-dir M --telemetry-dir
   T`` in process: TTFP in the record, ``obs lanes M`` and ``obs top
   M`` exit 0 with a row per bucket, ``obs lanes T --export-timeline``
   one track per lane used, ``metrics.prom`` parsed (files under
   ``chiprun_out/phase19d/``).
20. high availability and the routed cluster (``serve.ha``,
   ``cluster``): 20a ``python -m cbf_tpu_torch serve --ha-standby``
   (lease TTL 1 s, ready file, telemetry) and then a paced ``serve
   --lease`` primary on 8 requests at 4096 agents x 128 steps
   (``gating="pallas"``, ``max_batch`` 4, heartbeat 0.1 s), SIGKILLed
   0.8 s after its first acknowledgment: the standby exits 0 with its
   takeover record at epoch 2, every acknowledged request resolved
   exactly once, the recovered ones above the floor with 0 infeasible;
   the standby's capture seconds, the primary's largest gap between
   beats (seen from this process through the ``.beat`` sidecar; held
   under the TTL) and the time from the kill to the first recovered
   result beside phase 18d's cold recovery; 20b a continuous engine
   (32-step chunks, ``max_batch`` 4, buckets 4096 and 2048) journaling
   under a lease, fenced by a second ``Lease.acquire`` with five lanes in
   flight and a request queued behind the full table: every handle
   resolves with ``FencedError`` (the queued one on the mid-join path),
   ``engine.fenced`` set, not a byte appended after the fence, the armed
   lock witness with no inversion and no journal append under
   ``_PROGRAM_LOCK``, one ``knn_fused`` launch per chunk step; 20c
   ``python -m cbf_tpu_torch cluster serve --engines 2 --prewarm
   --steal --lease-ttl-s 1.0`` on 24 requests at the serve default (one
   hot bucket), the worker holding the hot bucket SIGKILLed by its pid
   file once requests are in flight: exit 0, an exactly-once census,
   every result above the floor with 0 infeasible (two held to the
   reference's own dips), req/s and p50/p99 latency from the router's
   route events to the journals' resolved records, the steal count, the
   failover MTTR and the time from the kill to the survivor's first
   replayed result (files under ``chiprun_out/phase20*``).
21. the scenario DSL and the falsification fleet
   (``scenarios.platform.dsl``, ``verify.fleet``, the serve engine's
   background tenant): 21a the generator's 20 specs of seed 0 (their
   digest the JAX package's, ``DSL_SPECS_SHA256``) each through
   ``dsl.run_spec`` compiled at its own size and horizon: above its
   adapter's separation floor with 0 infeasible, ``knn_fused`` once per
   step, the minimum within ``DSL_MD_ATOL`` of the JAX package's CPU run
   (``DSL_REFERENCE``; a spec parting beyond ``CROSS_MD_ATOL`` printed);
   21b the fleet at ``FleetSettings()``'s defaults (seven targets, 16
   candidates per dispatch, 8 dispatches per round, 64 steps) for two
   rounds: candidates/s per round (the first holds the captures),
   ``knn_fused`` member launches per target, one swarm target's batch
   margins within ``MEMBER_MARGIN_ATOL`` of its candidates run alone, and
   the campaign dropped after round 1 and resumed ``==`` the whole one,
   its state file bit for bit; 21c tests/test_fleet.py's weakened dmin
   found within 6 rounds, shrunk, float64-confirmed, archived, a capsule
   tripped and the archive replayed clean, the time to detection; 21d 8
   queue-mode requests at the serve default with and without a campaign
   as the engine's background tenant, in turns: results
   ``np.array_equal``, latency p50, ``background_batches``/``_yields``,
   the campaign equal to its standalone run, every unit under
   ``_PROGRAM_LOCK`` with the lock witness armed (files under
   ``chiprun_out/phase21*``).

Phases 7-13 run before phase 6, which times their kernels (``knn_fused``
and ``knn_stream`` also at the certificate's k=16 shape) and profiles
every phase of 1-12 over 10 steps (12a over 1, 12d over 2; phase 13
profiles its own runs, 13b over 3).

Stdout ends with the ``{"kernels": [...]}`` line (the radius-array
launches in rows of their own, and in their kernel's launches), each
phase's compiled and eager agent-QP-steps/s, the card line, and, last,
the result line ``{"ok": true, "device": {...}}``. Without a card it exits 2 and prints
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
# Phase 12, the joint certificate: the sparse backend at the north-star
# width (k=16 rows per agent, its search at the binding-pair radius), the
# dense backend at its largest auto size, and card vs CPU at N=256. The
# sparse step's ~28 k device ops per step are profiled over
# CERT_PROFILE_STEPS steps (the dense step's ~6 k over
# CERT_DENSE_PROFILE_STEPS): a 20-step profile of them takes minutes of
# the script's time (PERF.md §5). Cut from 2 and 5 steps when phase 17
# came, to keep the script under 850 s: the two profiles took 35 and 14 s;
# 12a and 12b then went from 50 steps to 30, and with the HA phase to 10
# (12c from 30 to 15), to keep it under 880 s.
CERT_N, CERT_STEPS, CERT_FUSED_STEPS = 4096, 10, 15
CERT_PROFILE_STEPS, CERT_DENSE_PROFILE_STEPS = 1, 2
# 12b again with one guarded block, which the warm solves outgrow: the
# chunk is redone by the eager loop and must still equal it.
CERT_REDO_STEPS = 10
# 12d's dense certificate: 100 steps until the HA phase came, cut to
# keep the script under 880 s.
CERT_DENSE_N, CERT_DENSE_STEPS = 128, 50
CERT_CROSS_N, CERT_CROSS_STEPS = 256, 10
CERT_K = 16
CERT_SKIN, CERT_TOL = 0.1, 1e-5
CERT_FLOOR = 0.13          # bench.py's SAFETY_FLOOR
CERT_RESIDUAL_GATE = 1e-4  # bench.py's _gate_certificate
CROSS_STEPS = 20
# Card vs CPU after CROSS_STEPS steps: positions reach ~13 m, where a
# float32 ulp is ~1e-6, and the two devices reduce the centroid mean in
# different orders, so the trajectories part by a few ulps per step;
# 1e-4 m leaves ~5x headroom over 20 steps of that, and the min-distance
# series (values ~0.2 m, ulp ~1.5e-8) gets 1e-5.
CROSS_X_ATOL, CROSS_MD_ATOL = 1e-4, 1e-5
# Phase 13, the reference scenarios at their own sizes. cross_and_rescue's
# 3000 steps run compiled; the eager loop holds them on the first 50
# (an eager step of its dense certificate takes 54-107 ms on an H100 80GB
# HBM3 at 700 W, PERF.md §5; 300 until phase 17 came, 200 until the HA
# phase came), and the walls are timed over 25 (100, then 50).
SCEN_CAR_PREFIX, SCEN_CAR_TIMED = 50, 25
# 13a and 13c are held to the eager loop over their first SCEN_HOLD
# steps (their whole horizons, 1000 and 1500, until the HA phase came)
# and timed in turns over SCEN_TIMED steps (the whole horizons until
# phase 19 came: their timed eager legs took ~30 s of the script).
SCEN_TIMED, SCEN_HOLD = 200, 300
SCEN_ANCHOR_STEPS = 5          # tests/test_scenarios.py's golden anchor
SCEN_CROSS_STEPS = 50
SCEN_CLI_STEPS = 200
SCEN_COMPAT_STEPS = 200
# The same bounds hold phase 9's 50 steps at N=256 (positions ~3 m, a
# float32 ulp ~2.4e-7): CUDA's and the CPU's cos/sin may differ by an ulp
# and the unicycle heading feeds that back every step, which 1e-4 covers
# ~400x over; theta (|theta| < ~10) gets the same 1e-4.
# Phase 14. The trainer: examples/train_safety_params.py's dense spawn
# (k=4, pack spacing 0.02, spacing 0.15 m), E members, horizon, Adam
# steps; the two-layer bar of tests/test_sparse_certificate.py:487-520.
TRAIN_N, TRAIN_E, TRAIN_HORIZON, TRAIN_OPT_STEPS = 4096, 2, 8, 3
# The two-layer trainer's Adam steps: 3 until phase 17 came (9.6-15.6 s
# each on an H100 80GB HBM3 at 700 W, PERF.md §5), cut to keep the script
# under 850 s; the descent check needs two.
TWO_N, TWO_HORIZON, TWO_OPT_STEPS = 512, 4, 2
TRAIN_CROSS_N = 256
# Card vs CPU of one float32 loss and gradient over the 8-step horizon:
# the devices reduce the centroid in other orders (CROSS_X_ATOL's ulps per
# step), which the loss carries at ~1e-7 relative and the gradient, a sum
# over the backward pass, at ~1e-5.
TRAIN_CROSS_LOSS_RTOL, TRAIN_CROSS_GRAD_RTOL = 1e-5, 1e-3
# The certificate's finite-difference probe (tests/test_sparse_certificate
# .py:439-484): a 32 x 32 grid, k=8, one coordinate, eps 1e-3, 5e-3.
FD_SIDE, FD_EPS, FD_RTOL = 32, 1e-3, 5e-3
# bench.py's BENCH_VERIFY defaults (_child_verify): N, steps, batch,
# rounds; the member axis held at B in MEMBER_BS.
VERIFY_N, VERIFY_STEPS, VERIFY_BATCH, VERIFY_ROUNDS = 256, 200, 16, 3
MEMBER_BS = (1, 3, 16)
# Phase 15a: the member-axis knn_banded also at phase 7's width, B
# members.
BANDED_MEMBERS = 4
# Phase 15c: BASELINE.md:31's Monte-Carlo sweep, 1024 seeds x 64 agents
# (its 500 steps held against the eager loop over MC_EAGER_STEPS; all 500
# until the HA phase came).
MC_E, MC_N, MC_STEPS, MC_EAGER_STEPS = 1024, 64, 500, 100
# The sweep's seeds whose run dips below FLOOR in the JAX package itself
# (jax 0.9.0 on the CPU, this sweep's Config; the port's CPU run dips on
# the same 21 seeds, within 1e-6): seed -> the reference's minimum. Those
# members are held to it within CROSS_MD_ATOL instead of the floor.
MC_REFERENCE_DIPS = {
    29: 0.14129546, 37: 0.14130959, 193: 0.14129612, 194: 0.14100416,
    246: 0.13630636, 375: 0.13681684, 476: 0.14129606, 587: 0.14128754,
    599: 0.14117305, 634: 0.13361771, 698: 0.14131558, 730: 0.14131488,
    732: 0.14130966, 743: 0.14130147, 828: 0.14129603, 830: 0.14128154,
    925: 0.14128710, 947: 0.14129378, 955: 0.14063704, 956: 0.14128052,
    1013: 0.14129223}
# 15d: the north-star width in an ensemble; 15e: the lockstep certificate
# (tests/test_fused_batched.py's lockstep tolerances: x 2e-5, residual
# 1e-6, batched vs each member alone); 15f: chunk and resume.
ENS_E, ENS_STEPS = 8, 300
# 15d's seeds whose run dips below FLOOR in the JAX package itself (jax
# 0.9.0 on the CPU, E=8 x N=4096 x 300): seed -> the reference's minimum.
ENS_REFERENCE_DIPS = {4: 0.14131725, 6: 0.14130257}
# 15e's lockstep certificate: 20 steps until the HA phase came.
LOCK_E, LOCK_STEPS = 4, 10
LOCK_X_ATOL, LOCK_RES_ATOL = 2e-5, 1e-6
# 15f: 200 steps in chunks of 50 until the HA phase came.
ENS_STEPS_F, ENS_CHUNK = 100, 25
# A batch's margins against its candidates run alone: float32 margins
# ~0.1-1 m; on the CPU they are bit-equal (tests/test_torch_verify.py),
# on the card batched reductions may sum in another order.
MEMBER_MARGIN_ATOL = 1e-5
# The corpus replayed in float64 on the card and the CPU: the same
# operations in other summation orders over 150 steps.
CORPUS_REPLAY_ATOL = 1e-9
CORPUS_CFG = {"n": 16, "steps": 140, "k_neighbors": 4, "gating": "jnp"}
# Phase 16, durability and observability at the flagship width: 16a/16b
# run DUR_STEPS in DUR_CHUNK-step chunks (16b kills the CLI once its first
# checkpoint is committed); 16c streams a heartbeat every TEL_EVERY steps
# of TEL_STEPS and times telemetry on against off in TEL_TURNS turns of
# (off, on, on, off), the summed walls held under TEL_OVERHEAD_FAIL (the
# JAX package's budget, tests/test_telemetry.py:362-385, is
# TEL_OVERHEAD_BUDGET; noise alone must not fail the script);
# its watchdog sees a NaN at WATCH_NAN_AT, the warm certificate's carry
# blown up at CERT_WATCH_AT (N=CERT_WATCH_N) and a STALL_S host stall at
# STALL_AT; 16d checks 16c's run for a NaN or an inf, finds one injected
# at CHECKED_INF_AT, runs the cost model COST_REPS times and profiles
# PROFILE_STEPS steps through the CLI.
DUR_STEPS, DUR_CHUNK = 2000, 500
TEL_STEPS, TEL_EVERY, TEL_TURNS = 500, 50, 3
# 16c profiles the runs with and without telemetry over TEL_PROFILE_STEPS
# steps (TEL_STEPS until the HA phase came: ~141 k kernel events each).
TEL_PROFILE_STEPS = 50
TEL_OVERHEAD_BUDGET, TEL_OVERHEAD_FAIL = 0.03, 0.10
WATCH_STEPS, WATCH_NAN_AT = 200, 100
CERT_WATCH_N, CERT_WATCH_STEPS, CERT_WATCH_AT = 256, 10, 4
STALL_AT, STALL_S, STALL_TIMEOUT, STALL_EVERY = 100, 2.0, 0.5, 10
CHECKED_INF_AT = 250
COST_REPS, PROFILE_STEPS = 5, 50
# Phase 6's (and the scenarios') eager-vs-compiled profiles: steps per
# profiled run (20 until phase 17 came; cut to keep the script under
# 850 s).
PROFILE_RUN_STEPS = 10
# Phases 3-12's timed eager legs run the first TIMED_EAGER_STEPS steps of
# each horizon (the whole horizon until the HA phase came); the held
# eager run and the timed compiled legs keep the whole horizon.
TIMED_EAGER_STEPS = 100
# Phase 17, the traced-config serving path: 17b's workloads (bench.py's
# serve_workload at full width and at the serve bench's default), each
# trimmed request held to its own run within the reference's atol
# (tests/test_serve.py) and the batched/sequential ratio printed beside
# the JAX package's gate (tests/test_serve.py:322); 17c the chunk
# program; 17d card vs CPU.
SERVE_FULL, SERVE_FULL_BATCH = dict(base=4096, B=8, steps=128), 4
SERVE_DEFAULT, SERVE_DEFAULT_BATCH = dict(base=128, B=16, steps=512), 8
SERVE_X_ATOL, SERVE_GATE = 2e-4, 1.5
CHUNK_B, CHUNK_BUCKET, CHUNK, CHUNK_CALLS = 8, 256, 32, 3
CROSS_SERVE_STEPS = 64
# Phase 18, the serve engine's drain mode: 18a and 18b run phase 17b's two
# workloads through ServeEngine; 18c the fault ladder and 18d the journal
# across a kill in bucket FAULT_BUCKET x FAULT_STEPS (18d: 16 requests).
# 18c's rta_fallback rescue of poison_config(Config(**RESCUE_FIELDS)) is
# printed beside the JAX package's outcome for that request on the CPU,
# RESCUE_JAX_CPU (tests/test_torch_serve_faults.py::
# test_rta_rescue_outcome_of_the_jax_package holds this constant to it).
# The rescue's engine runs a horizon quantum of RESCUE_QUANTUM (its two
# programs, the poisoned and the rta=True one, each redo their chunk
# eagerly: 64 steps of those took 39 s of 18c in this PR's first call).
FAULT_BUCKET, FAULT_STEPS = 256, 64
RESCUE_FIELDS, RESCUE_QUANTUM = dict(n=256, steps=16, seed=3), 16
RESCUE_JAX_CPU = {"resolved": "result", "rta_engaged": True, "finite": True,
                  "bucket": "n256-t16-single-cert_off-gauto",
                  "min_distance": 0.230559}
# Phase 19, the continuous scheduler: 19a/19b at full width (phase 17b's
# workload with gating "pallas": buckets 4096 and 2048, max_batch 4,
# CONT_FULL_CHUNK-step chunks), a CONT_LONG_STEPS-step runner beside the
# joining request and a CONT_DOOMED_STEPS-step request evicted at its
# deadline; 19c seeded open-loop traffic at the serve default (CONT_LOAD),
# drain against continuous in turns; 19d the loadgen CLI (CONT_CLI) and the
# obs surfaces it feeds.
CONT_FULL, CONT_FULL_BATCH, CONT_FULL_CHUNK = \
    dict(base=4096, B=8, steps=128), 4, 32
CONT_LONG_STEPS, CONT_DOOMED_STEPS, CONT_DEADLINE_S = 512, 4096, 0.5
CONT_LOAD = dict(rps=24.0, duration_s=3.0, seed=0, n_min=64, n_max=128,
                 steps_choices=(128, 256, 512), gating="pallas")
CONT_LOAD_BATCH, CONT_LOAD_CHUNK = 8, 16
# CONT_LOAD's requests whose run dips below FLOOR in the JAX package itself
# (jax 0.9.0 on the CPU, gating "jnp", the drain engine; the port's CPU run
# dips on the same request, within 1.5e-8): schedule index -> the
# reference's minimum. Held to it within CROSS_MD_ATOL instead of the floor.
CONT_LOAD_REFERENCE_DIPS = {50: 0.14131689}
# Phase 20, high availability and the routed cluster. 20a: a hot standby
# (`serve --ha-standby`, lease TTL HA_TTL_S) and a paced `serve --lease`
# primary (HA_REQUESTS requests of HA_N agents x HA_STEPS steps,
# gating "pallas", max_batch HA_BATCH, one every HA_PACE_S, heartbeat
# every HA_BEAT_S) SIGKILLed HA_KILL_AFTER_S after its first
# acknowledgment. 20b: a continuous engine (FENCE_CHUNK-step chunks,
# max_batch FENCE_BATCH, buckets 2048 and 4096) fenced with lanes in
# flight. 20c: `cluster serve --engines 2` on CLUSTER_REQUESTS requests at
# the serve default (cluster_requests), one worker SIGKILLed once requests
# are in flight, the lease TTL CLUSTER_TTL_S.
HA_N, HA_STEPS, HA_REQUESTS, HA_BATCH = 4096, 128, 8, 4
HA_PACE_S, HA_BEAT_S, HA_TTL_S, HA_KILL_AFTER_S = 0.3, 0.1, 1.0, 0.8
FENCE_CHUNK, FENCE_BATCH, FENCE_LONG_STEPS, FENCE_SHORT_STEPS = \
    32, 4, 512, 128
CLUSTER_REQUESTS, CLUSTER_SEED, CLUSTER_TTL_S = 24, 20, 1.0
# cluster_requests()'s requests whose run dips below FLOOR in the JAX
# package itself (jax 0.9.0 on the CPU, gating "jnp", the drain engine):
# request index -> the reference's minimum, held within CROSS_MD_ATOL.
CLUSTER_REFERENCE_DIPS = {0: 0.14129062, 1: 0.14130925}
CONT_CLI = ["--continuous", "--chunk", "16", "--gating", "pallas", "--rps",
            "16", "--duration", "1"]
# Phase 21, the scenario DSL and the falsification fleet. 21a: the
# generator's DSL_COUNT specs of seed DSL_SEED, whose dataclasses.asdict
# list (json, sorted keys) hashes to DSL_SPECS_SHA256, each run through
# dsl.run_spec at its own size and horizon; DSL_REFERENCE is the JAX
# package's run of each on the CPU (jax 0.9.0, float32, its CPU "auto"
# gating): spec index -> (minimum pairwise distance, infeasible count).
# tests/test_torch_platform.py holds both constants to the JAX package
# (the minima in a slow test); the port's CPU runs lie within 1.7e-7 of
# them. A card run is held within DSL_MD_ATOL (float32 over up to 271
# steps with the card's rounding) and one that parts from the reference by
# more than CROSS_MD_ATOL is printed. 21b: the fleet at FleetSettings()'s
# defaults (FLEET_FIELDS empty) for FLEET_ROUNDS rounds; 21c the weakened
# dmin of tests/test_fleet.py found within FLEET_DETECT_ROUNDS; 21d a
# TENANT_* campaign as the background tenant of a queue-mode engine at the
# serve default with 8 foreground requests.
DSL_SEED, DSL_COUNT = 0, 20
DSL_SPECS_SHA256 = (
    "a9c1ce851c9f8f4534ec85ccfbb1c86ed3844afa469fc944c394e5fa1c3450fe")
DSL_REFERENCE = {
    0: (0.14146152138710022, 0), 1: (0.1492505520582199, 0),
    2: (0.14142456650733948, 0), 3: (0.14342449605464935, 0),
    4: (0.17729806900024414, 0), 5: (0.17751625180244446, 0),
    6: (0.27015823125839233, 0), 7: (0.14270560443401337, 0),
    8: (0.14162380993366241, 0), 9: (0.2250976711511612, 0),
    10: (0.1475902944803238, 0), 11: (0.1639646291732788, 0),
    12: (0.16240264475345612, 0), 13: (0.15796686708927155, 0),
    14: (0.14142146706581116, 0), 15: (0.1780606359243393, 0),
    16: (0.1414213329553604, 0), 17: (0.1461477279663086, 0),
    18: (0.65236896276474, 0), 19: (0.21493132412433624, 0)}
DSL_MD_ATOL = 1e-4
FLEET_FIELDS: dict = {}
FLEET_ROUNDS, FLEET_DETECT_ROUNDS = 2, 6
# tests/test_fleet.py:51-55 and :465-493: the weakened filter, the marginal
# config and the detection campaign's settings.
WEAK_CBF_FIELDS = dict(max_speed=15.0, k=0.0, dmin=0.16)
MARGINAL_FIELDS = dict(n=16, steps=140, k_neighbors=4, gating="jnp")
DETECT_FIELDS = dict(seed=0, batch=8, batches_per_round=2,
                     perturb_scale=0.04, perturb_norm=0.1, max_steps=140,
                     generated_count=0, include_rta=False)
TENANT_N, TENANT_ROUNDS = 64, 3
TENANT_FIELDS = dict(batch=16, batches_per_round=4, max_steps=64,
                     generated_count=0, include_rta=False)
TENANT_REQUESTS = dict(base=128, B=8, steps=512)


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


def compare(kernel_fn, plain_fn, x, k=K, radius=RADIUS, **kw
            ) -> tuple[float, list]:
    """Kernel vs plain on the same card input: every output (four, or five
    with the banded overflow flag) must be equal. Returns the max abs
    difference of the float outputs (finite entries; 0.0 when equal) and
    the outputs."""
    import torch

    got = kernel_fn(x, radius, k, **kw)
    want = plain_fn(x, radius, k, **kw)
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


def drive(swarm, engine, knn, cfg, label, kernel, wrap=None, per_step=1):
    """One main-path run through the user entry points: ``swarm.make`` and
    the compiled ``rollout`` (its first call on this step, so the capture
    is inside), with the launch and engine counts zeroed just before and
    read just after, and the peak device memory around it. Then the eager
    loop from the same initial state, which the compiled run must equal
    (final state and every StepOutputs field, torch.equal), and both timed
    in turns (eager, compiled, compiled, eager) with the graphs cached;
    every timed run must equal the first eager run too (run-to-run
    determinism). ``wrap`` wraps the step (a fault injector). Checks
    ``kernel`` launches and none of the others: ``per_step`` per step in
    the compiled run (a graph replays every step's searches — the gating
    search, the certificate's, and a Verlet cache's on every step) plus
    the eager loop's where the chunk was redone, and ``per_step`` per step
    eagerly (a Verlet cache: one per rebuild). Returns a dict of the
    run."""
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
    want[kernel] = per_step * cfg.steps + (eager_launches[kernel]
                                           if counts["redo_steps"] else 0)
    check(launches == want, f"{label}: launches {launches}, want {want}")
    if not (cfg.gating_rebuild_skin or cfg.certificate_rebuild_skin):
        check(eager_launches[kernel] == per_step * cfg.steps,
              f"{label}: eager launches {eager_launches}")
    walls = {"eager": [], "compiled": []}
    n_timed = {"eager": min(cfg.steps, TIMED_EAGER_STEPS),
               "compiled": cfg.steps}
    eager_head = engine._tree_map(lambda v: v[:n_timed["eager"]],
                                  eager_outs)
    head_final = eager_final if n_timed["eager"] == cfg.steps else None
    for kind in ("eager", "compiled", "compiled", "eager"):
        run = engine.eager_rollout if kind == "eager" else engine.rollout
        result = []
        walls[kind].append(timed(lambda: result.extend(
            run(step, state0, n_timed[kind]))))
        if kind == "eager":
            head_final = result[0] if head_final is None else head_final
            ok = same_tree(result[0], head_final) and same_tree(
                tuple(result[1]), tuple(eager_head))
        else:
            ok = same_tree(result[0], eager_final) and same_tree(
                tuple(result[1]), tuple(eager_outs))
        check(ok, f"{label}: a timed {kind} run differs from the first "
              "eager run")
    rounds = torch.bincount(eager_outs.max_relax_rounds.int().cpu())
    run_info = {
        "steps": cfg.steps, "n": cfg.n, "relax_rounds_captured":
        step.relax_rounds, "redos": counts["redos"],
        "redo_steps": counts["redo_steps"], "captures": counts["captures"],
        "replays": counts["replays"], "first_call_s": first,
        "eager_timed_steps": n_timed["eager"],
        "eager_s": walls["eager"], "compiled_s": walls["compiled"],
        "eager_step_ms": [w / n_timed["eager"] * 1e3
                          for w in walls["eager"]],
        "compiled_step_ms": [w / cfg.steps * 1e3 for w in walls["compiled"]],
        "eager_agent_qp_steps_per_s": [cfg.n * n_timed["eager"] / w
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
        "eager_launches": eager_launches[kernel],
        "determinism": "every timed run (2 eager, 2 compiled) equal to "
                       "the first eager run (the eager ones over their "
                       "steps)"}
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
                  "max_relax_rounds", "rta_mode",
                  "certificate_dropped_count", "certificate_iterations",
                  "certificate_carry_resets"):
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
    (consensus/gating/filter/certificate/integrate) the host span and the
    device time
    inside its device-side range — which a graph replay does not record,
    so the compiled run shows "not measured" there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    phases = ("consensus", "gating", "filter", "certificate", "integrate")
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


def profile_both(engine, run, label: str,
                 steps: int = PROFILE_RUN_STEPS) -> dict:
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


def drive_scenario(engine, knn, module, cfg, label, horizon, prefix=None,
                   timed_steps=None, profile_steps=PROFILE_RUN_STEPS):
    """13a-c: a reference scenario through its ``make`` on the card and
    the compiled ``rollout`` over the whole ``horizon`` (its first call on
    this step, so the capture is inside), the engine and launch counts
    zeroed just before and read just after. Held ``torch.equal`` to the
    eager loop over the first ``prefix`` steps (the whole horizon when
    None): every StepOutputs field, and the final state of a compiled run
    of that length. Eager and compiled are timed in turns over
    ``timed_steps`` steps (default: those), each timed run held to the
    eager loop, and 10 steps (``profile_steps``) profiled eager and
    compiled.
    The per-step relax histogram is the compiled run's (equal to the eager
    loop's wherever both ran: a step past R rounds would have redone its
    chunk). Returns a dict of the run."""
    import torch

    n_ref = horizon if prefix is None else prefix
    state0, step = module.make(cfg)
    torch.cuda.synchronize()
    zero_counts(engine, knn)
    t0 = time.perf_counter()
    final, outs = engine.rollout(step, state0, horizon)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts, launches = dict(engine.COUNTS), dict(knn.LAUNCHES)
    check(not any(launches.values()),
          f"{label}: a scenario without a kernel launched {launches}")
    eager_final, eager_outs = engine.eager_rollout(step, state0, n_ref)
    head = engine._tree_map(lambda v: v[:n_ref], outs)
    for name, a, b in zip(engine.StepOutputs._fields, head, eager_outs):
        check(same_tree(a, b), f"{label}: compiled {name} differs from the "
              f"eager loop's over the first {n_ref} steps")
    if n_ref == horizon:
        check(same_tree(final, eager_final),
              f"{label}: compiled final state differs from the eager loop's")
    else:
        pre_final, pre_outs = engine.rollout(step, state0, n_ref)
        check(same_tree(pre_final, eager_final)
              and same_tree(tuple(pre_outs), tuple(eager_outs)),
              f"{label}: a compiled run of {n_ref} steps differs from the "
              "eager loop's")
    n_timed = n_ref if timed_steps is None else min(timed_steps, n_ref)
    want_outs = engine._tree_map(lambda v: v[:n_timed], eager_outs)
    walls = {"eager": [], "compiled": []}
    for kind in ("eager", "compiled", "compiled", "eager"):
        run = engine.eager_rollout if kind == "eager" else engine.rollout
        result = []
        walls[kind].append(timed(lambda: result.extend(
            run(step, state0, n_timed))))
        check((n_timed < n_ref or same_tree(result[0], eager_final))
              and same_tree(tuple(result[1]), tuple(want_outs)),
              f"{label}: a timed {kind} run over {n_timed} steps differs "
              "from the first eager run")
    rounds = torch.bincount(outs.max_relax_rounds.int().cpu())
    prof = profile_both(engine, {"step": step, "state0": state0}, label,
                        steps=profile_steps)
    info = {
        "horizon": horizon, "held_equal_steps": n_ref,
        "relax_rounds_captured": step.relax_rounds,
        "redos": counts["redos"], "redo_steps": counts["redo_steps"],
        "captures": counts["captures"], "first_call_s": first,
        "timed_steps": n_timed,
        "eager_step_ms": [w / n_timed * 1e3 for w in walls["eager"]],
        "compiled_step_ms": [w / n_timed * 1e3 for w in walls["compiled"]],
        "device_ops_per_step": {
            kind: prof[kind]["device_ops_per_step"] for kind in prof},
        "device_busy_share": {
            kind: prof[kind]["device_busy_share"] for kind in prof},
        "max_relax_rounds_steps": {r: int(c) for r, c in enumerate(rounds)
                                   if int(c)},
        "infeasible": int(outs.infeasible_count.sum()),
        "min_distance": float(outs.min_pairwise_distance.min())}
    print(f"{label}: compiled == eager over the first {n_ref} of {horizon} "
          "steps (every StepOutputs field"
          + (", final state" if n_ref == horizon else
             f"; a compiled run of {n_ref} steps, final state included")
          + f"; timed runs of {n_timed} steps held too); "
          + json.dumps(info))
    return {"state0": state0, "step": step, "final": final, "outs": outs,
            "eager_final": eager_final, "info": info}


def golden_anchor(mac, cfg, steps: int, device=None) -> float:
    """13d: ``meet_at_center`` in float64 on ``device`` (None = the card;
    tests/test_torch_scenarios.py runs it on the CPU), ``steps`` steps,
    replayed in float64 numpy with the port's copy of the SLSQP oracle
    (``cbf_tpu_torch.oracle.OracleCBF``), as the JAX package's
    tests/test_scenarios.py::test_meet_at_center_trace_oracle_parity
    replays its own: the danger sets by the reference's loops, the filter
    by the oracle, the unicycle tail by the port's sim functions in
    float64 on the CPU. Every step's poses within 5e-5. Returns the
    largest difference."""
    import numpy as np
    import torch

    from cbf_tpu_torch.oracle import OracleCBF
    from cbf_tpu_torch.sim import (SimParams, adjacency_from_laplacian,
                                   complete_gl, cycle_gl, si_to_uni_dyn,
                                   unicycle_step)

    sim = SimParams()
    state, step = mac.make(cfg, sim, device=device)
    oracle = OracleCBF(max_speed=cfg.max_speed)
    fx = cfg.dyn_scale * np.zeros((4, 4))
    gx = cfg.dyn_scale * np.array([[1.0, 0], [0, 1.0], [0, 0], [0, 0]])
    nO, N = cfg.n_obstacles, cfg.n
    A_ring = adjacency_from_laplacian(cycle_gl(nO), dtype=torch.float64
                                      ).numpy()
    A_full = adjacency_from_laplacian(complete_gl(cfg.n_free),
                                      dtype=torch.float64).numpy()
    theta = -np.pi / nO
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]])
    poses = np.asarray(mac.initial_poses(cfg), dtype=np.float64)
    worst = 0.0
    for t in range(steps):
        state, _ = step(state, t)
        th = poses[2]
        x_si = poses[:2] + sim.projection_distance * np.stack(
            [np.cos(th), np.sin(th)])
        vo = rot @ (x_si[:, :nO] @ A_ring.T - x_si[:, :nO] * A_ring.sum(1))
        vf = x_si[:, nO:] @ A_full.T - x_si[:, nO:] * A_full.sum(1)
        si_vel = np.concatenate([vo, vf], axis=1)
        states4 = np.concatenate([poses[:2], si_vel], axis=0).T
        for i in range(nO, N):
            danger = []
            for j in range(N):
                dist = np.linalg.norm(states4[j, :2] - states4[i, :2])
                if dist < cfg.safety_distance and (j < nO or dist > 0):
                    danger.append(states4[j])
            if danger:
                si_vel[:, i] = oracle.get_safe_control(
                    states4[i], np.array(danger), fx, gx, si_vel[:, i])
        p = torch.as_tensor(poses)
        dxu = si_to_uni_dyn(torch.as_tensor(si_vel), p,
                            sim.projection_distance)
        poses = unicycle_step(p, dxu, sim).numpy()
        err = float(np.max(np.abs(state.poses.cpu().numpy() - poses)))
        worst = max(worst, err)
        check(err <= 5e-5, f"13d: the card's float64 meet_at_center left the "
              f"oracle replay by {err} at step {t}")
    return worst


def scenario_cross_check(engine, module, cfg, horizon, label) -> dict:
    """13e: ``horizon`` steps of a reference scenario's compiled rollout
    on the card and on the CPU from the same initial state: every pose
    (headings included) and min distance within CROSS_X_ATOL /
    CROSS_MD_ATOL, every count equal."""
    import torch

    state_g, step_g = module.make(cfg)
    state_c, step_c = module.make(cfg, device="cpu")
    fg, og = engine.rollout(step_g, state_g, horizon)
    fc, oc = engine.rollout(step_c, state_c, horizon)
    dx = max(float(torch.amax(torch.abs(a.cpu() - b)))
             for a, b in zip(engine._leaves(fg), engine._leaves(fc)))
    dmd = float(torch.amax(torch.abs(og.min_pairwise_distance.cpu()
                                     - oc.min_pairwise_distance)))
    print(f"{label}: card vs CPU over {horizon} steps: max |dx| {dx:.3e} "
          f"(atol {CROSS_X_ATOL}), max |d min-dist| {dmd:.3e} (atol "
          f"{CROSS_MD_ATOL})")
    check(dx <= CROSS_X_ATOL and dmd <= CROSS_MD_ATOL,
          f"{label}: card and CPU trajectories part beyond tolerance")
    for field in ("filter_active_count", "infeasible_count",
                  "max_relax_rounds", "gating_dropped_count"):
        a, b = getattr(og, field), getattr(oc, field)
        if isinstance(a, tuple):
            continue
        check(torch.equal(a.cpu(), b), f"{label}: {field} differs between "
              "card and CPU")
    return {"max_abs_dx": dx, "max_abs_dmd": dmd}


def phase13(engine, knn, swarm, t_start) -> dict:
    """Phase 13: the reference scenarios, the CLI and the compat example
    (module docstring). Returns what the kernel table and the summary
    need."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from cbf_tpu_torch import __main__ as cli
    from cbf_tpu_torch.examples import meet_at_center_compat
    from cbf_tpu_torch.native import trajsink
    from cbf_tpu_torch.scenarios import antipodal, cross_and_rescue
    from cbf_tpu_torch.scenarios import meet_at_center as mac

    out = {}
    # 13a meet_at_center, default Config.
    cfg = mac.Config()
    run = drive_scenario(engine, knn, mac, cfg, "phase 13a: meet_at_center",
                         cfg.iterations, prefix=SCEN_HOLD,
                         timed_steps=SCEN_TIMED)
    free = run["final"].poses[:2, cfg.n_obstacles:]
    spread = float(torch.amax(torch.linalg.norm(
        free - free.mean(dim=1, keepdim=True), dim=0)))
    engaged400 = int(run["outs"].filter_active_count[:400].sum())
    info = run["info"]
    check(spread < 0.35 and info["min_distance"] > 0.05
          and info["infeasible"] == 0 and engaged400 > 100,
          f"13a: spread {spread}, min distance {info['min_distance']}, "
          f"infeasible {info['infeasible']}, engaged {engaged400} over 400")
    info.update(free_spread=spread, engaged_first_400=engaged400)
    print(f"phase 13a: free-agent spread {spread:.4f} m (< 0.35), min "
          f"distance {info['min_distance']:.6f} (> 0.05), 0 infeasible, "
          f"engaged on {engaged400} agent-steps of the first 400 (> 100)")
    out["13a"] = run

    # 13b cross_and_rescue, default Config: the full horizon compiled, held
    # to the eager loop on a prefix (SCEN_CAR_PREFIX: 3000 eager steps of
    # the dense certificate's ~6 k ops would take minutes).
    cfg = cross_and_rescue.Config()
    run = drive_scenario(engine, knn, cross_and_rescue, cfg,
                         "phase 13b: cross_and_rescue", cfg.iterations,
                         prefix=SCEN_CAR_PREFIX, timed_steps=SCEN_CAR_TIMED,
                         profile_steps=3)
    dists = np.linalg.norm(run["final"].poses[:2].cpu().numpy().T
                           - np.array(cfg.goal), axis=1)
    res = float(run["outs"].certificate_residual.max())
    info = run["info"]
    check(dists.min() < 0.15 and dists.max() < 0.6
          and info["min_distance"] > 0.1 and res < CERT_RESIDUAL_GATE
          and info["infeasible"] == 0,
          f"13b: goal distances {dists}, min distance "
          f"{info['min_distance']}, residual {res}, infeasible "
          f"{info['infeasible']}")
    info.update(goal_distances=dists.tolist(), max_residual=res)
    print(f"phase 13b: robot distances to the goal {np.round(dists, 4)} "
          f"(min < 0.15, max < 0.6), min distance {info['min_distance']:.6f}"
          f" (> 0.1), max certificate residual {res:.3e} (< "
          f"{CERT_RESIDUAL_GATE}), 0 infeasible (script at "
          f"{time.perf_counter() - t_start:.1f} s)")
    out["13b"] = run

    # 13c antipodal, default Config (N=32).
    cfg = antipodal.Config()
    run = drive_scenario(engine, knn, antipodal, cfg, "phase 13c: antipodal",
                         cfg.steps, prefix=SCEN_HOLD,
                         timed_steps=SCEN_TIMED)
    d = torch.linalg.norm(run["final"].x - antipodal.goals(cfg), dim=1)
    arrived = int((d < 0.2).sum())
    info = run["info"]
    floor = 0.2 / math.sqrt(2.0) - 5e-3
    print(f"phase 13c: {arrived}/{cfg.n} agents within 0.2 m of their "
          f"antipodes, min distance {info['min_distance']:.6f} (> "
          f"{floor:.5f}), infeasible {info['infeasible']}")
    check(arrived == cfg.n and info["min_distance"] > floor
          and info["infeasible"] == 0, "13c: the swap did not complete "
          "safely")
    info["arrived"] = arrived
    out["13c"] = run

    # 13d the golden anchor on the card.
    worst = golden_anchor(mac, mac.Config(iterations=SCEN_ANCHOR_STEPS,
                                          dtype=torch.float64),
                          SCEN_ANCHOR_STEPS)
    print(f"phase 13d: float64 meet_at_center on the card within {worst:.3e}"
          f" of the oracle replay over {SCEN_ANCHOR_STEPS} steps (atol 5e-5)")
    out["13d"] = worst

    # 13e card vs CPU.
    out["13e"] = {
        "meet_at_center": scenario_cross_check(
            engine, mac, mac.Config(iterations=SCEN_CROSS_STEPS),
            SCEN_CROSS_STEPS, "phase 13e (meet_at_center)"),
        "antipodal": scenario_cross_check(
            engine, antipodal, antipodal.Config(steps=SCEN_CROSS_STEPS),
            SCEN_CROSS_STEPS, "phase 13e (antipodal)")}

    # 13f the CLI in process.
    def cli_run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        check(rc == 0, f"13f: {' '.join(argv)} exited {rc}")
        return buf.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        cbt = os.path.join(tmp, "swarm.cbt")
        torch.cuda.synchronize()
        zero_counts(engine, knn)
        record = json.loads(cli_run(
            ["run", "swarm", "--set", f"n={MAIN_N}", "--steps",
             str(SCEN_CLI_STEPS), "--traj", cbt]).strip().splitlines()[-1])
        launches, counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
        want = dict.fromkeys(knn.LAUNCHES, 0)
        want["knn_fused"] = SCEN_CLI_STEPS + counts["redo_steps"]
        check(launches == want, f"13f: launches {launches}, want {want}")
        check(record["min_pairwise_distance"] >= FLOOR
              and record["infeasible_agent_steps"] == 0
              and record["traj"] == cbt,
              f"13f: run swarm record {record}")
        traj = trajsink.read_trajectory(cbt)
        check(traj.shape == (SCEN_CLI_STEPS, MAIN_N, 2),
              f"13f: the .cbt holds {traj.shape}")
        state0, step = swarm.make(swarm.Config(
            n=MAIN_N, steps=SCEN_CLI_STEPS, record_trajectory=True))
        want_traj = engine.rollout(step, state0, SCEN_CLI_STEPS)[1].trajectory
        check(np.array_equal(traj, want_traj.cpu().numpy()),
              "13f: the .cbt differs from the run's trajectory")
        gif = os.path.join(tmp, "meet.gif")
        cli_run(["run", "meet_at_center", "--steps", str(SCEN_CLI_STEPS),
                 "--video", gif])
        with open(gif, "rb") as fh:
            check(fh.read(6) in (b"GIF87a", b"GIF89a"),
                  "13f: the video is not a gif")
        gif_bytes = os.path.getsize(gif)
        listing = cli_run(["list"])
        names = sorted(line.split()[0] for line in listing.splitlines()
                       if line and not line.startswith(" "))
        check(names == ["antipodal", "cross_and_rescue", "meet_at_center",
                        "swarm"], f"13f: list printed {names}")
    out["13f"] = {"launches": launches, "record": record,
                  "cbt_shape": list(traj.shape), "gif_bytes": gif_bytes,
                  "redos": counts["redos"]}
    print(f"phase 13f: run swarm n={MAIN_N} x {SCEN_CLI_STEPS}: min distance "
          f"{record['min_pairwise_distance']:.6f} (floor {FLOOR:.5f}), 0 "
          f"infeasible, launches {launches}; .cbt {list(traj.shape)} equal "
          f"to the run's trajectory; run meet_at_center --video: a "
          f"{gif_bytes}-byte gif; list: {names}")

    # 13g the compat example, card and CPU.
    walls, finals = {}, {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            finals[device] = meet_at_center_compat.main(
                steps=SCEN_COMPAT_STEPS, device=device)
        walls[device] = (time.perf_counter() - t0) / SCEN_COMPAT_STEPS * 1e3
    dx = float(np.max(np.abs(finals["cuda"] - finals["cpu"])))
    check(finals["cuda"].shape == (3, 10)
          and bool(np.isfinite(finals["cuda"]).all()) and dx <= CROSS_X_ATOL,
          f"13g: compat example card vs CPU max |dx| {dx}")
    out["13g"] = {"step_wall_ms": walls, "max_abs_dx": dx}
    print(f"phase 13g: meet_at_center_compat x {SCEN_COMPAT_STEPS} steps: "
          f"card vs CPU final poses max |dx| {dx:.3e} (atol {CROSS_X_ATOL}); "
          f"wall per step {walls['cuda']:.3f} ms on the card, "
          f"{walls['cpu']:.3f} ms on the CPU (every compat call crosses "
          f"host<->device) (script at {time.perf_counter() - t_start:.1f} s)")
    return out


def member_inputs(swarm, n: int, B: int, seed0: int = 0):
    """(B, n, 2) float32 members of different spawns on the card, every
    other one packed (PACK) so rows hold more than k candidates."""
    import torch

    xs = [swarm.spawn_positions(swarm.Config(n=n), seed0 + b,
                                device="cuda").float()
          * (PACK if b % 2 else 1.0) for b in range(B)]
    return torch.stack(xs).contiguous()


def member_bound(x, k: int, count) -> tuple[float, str]:
    """(bound ms, by) of one member-batched launch: B times the single
    launch's operations and bytes (module header)."""
    B, n = x.shape[0], x.shape[1]
    rate = PEAK_F32_PER_S / 2        # no FMA issued: one op per lane slot
    t_ops = (OPS_PER_PAIR * B * n * n + k * int(count.sum())) / rate
    t_bytes = B * (8 * n + n * k * 8 + n * 8) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase14(engine, knn, swarm, t_start) -> dict:
    """The differentiable path, the trainer and the falsifier (module
    docstring, phase 14). Returns the member-axis rows' data and each
    run's launches."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import numpy as np
    import torch

    from cbf_tpu_torch import verify as V
    from cbf_tpu_torch import __main__ as cli
    from cbf_tpu_torch.core.filter import CBFParams
    from cbf_tpu_torch.examples import falsify_swarm
    from cbf_tpu_torch.learn import tuning
    from cbf_tpu_torch.parallel.ensemble import ensemble_initial_states
    from cbf_tpu_torch.sim import certificates
    from cbf_tpu_torch.utils import prng
    from cbf_tpu_torch.verify import search

    out = {"runs": {}, "members": {}}

    # 14a. the member axis
    held = 0
    for name, fn, plain, ns in (
            ("knn_fused", knn.knn_fused, knn.knn_neighbors_plain,
             (VERIFY_N, MAIN_N)),
            ("knn_stream", knn.knn_stream, knn.knn_neighbors_blocked_plain,
             (VERIFY_N, 1000))):
        for n in ns:
            for k in (K, CERT_K):
                for B in MEMBER_BS:
                    x = member_inputs(swarm, n, B, seed0=7 * B)
                    got = fn(x, RADIUS, k)
                    want = plain(x, RADIUS, k)
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"14a: {name} B={B} N={n} k={k} differs from its "
                          "plain version")
                    for b in range(B):
                        single = fn(x[b].contiguous(), RADIUS, k)
                        check(all(torch.equal(a[b], c)
                                  for a, c in zip(got, single)),
                              f"14a: {name} B={B} N={n} k={k} member {b} "
                              "differs from its single launch")
                    held += 1
        xv = member_inputs(swarm, VERIFY_N, VERIFY_BATCH, seed0=100)
        count = fn(xv, RADIUS, K)[-1]
        bound, by = member_bound(xv, K, count)
        timed = time_call(lambda: fn(xv, RADIUS, K))
        timed.pop("device_op_names")
        single = time_call(lambda: fn(xv[0].contiguous(), RADIUS, K))
        single.pop("device_op_names")
        out["members"][name] = {
            "b": VERIFY_BATCH, "n": VERIFY_N, **timed,
            "single_member_ms": single["ms"],
            "single_member_device_ms": single["kernel_device_ms"],
            "plain_ms": cuda_ms(lambda: plain(xv, RADIUS, K), reps=10,
                                warmup=2)[0],
            "bound_ms": bound, "bound_by": by}
        print(f"14a: {name} (B={VERIFY_BATCH}, N={VERIFY_N}) median "
              f"{timed['ms']:.4f} ms, device {timed['kernel_device_ms']} ms "
              f"per launch; one member alone {single['ms']:.4f} ms "
              f"(device {single['kernel_device_ms']}); bound {bound:.5f} "
              f"ms ({by})")
    print(f"14a: {held} member-axis launches equal to their plain versions "
          "and to single launches (B=1: the single-swarm launch)")

    # 14b. the trainer at N=4096
    def dense_cfg(n, **kw):
        side = int(np.ceil(np.sqrt(n)))
        return swarm.Config(n=n, steps=0, k_neighbors=4, pack_spacing=0.02,
                            spawn_half_width_override=0.15 * (side - 1),
                            **kw)

    def params_line(p):
        sp = torch.nn.functional.softplus
        return (f"gamma={float(sp(p.gamma_raw)):.5f} "
                f"dmin={float(sp(p.dmin_raw)):.5f} "
                f"k={float(sp(p.k_raw)):.5f}")

    cfg_t = dense_cfg(TRAIN_N)
    tc = tuning.TrainConfig(steps=TRAIN_HORIZON, unroll_relax=2, remat=True,
                            learning_rate=3e-2)
    state_t = ensemble_initial_states(cfg_t, range(TRAIN_E), device="cuda")
    p0 = tuning.init_params(gamma=0.15, dmin=0.10, k=0.5, device="cuda")
    per_step = 2 * TRAIN_E * TRAIN_HORIZON
    lg = tuning.make_loss_and_grad_fn(cfg_t, None, tc)
    zero_counts(engine, knn)
    t0 = time.perf_counter()
    loss0, grad0 = lg(p0, *state_t)
    torch.cuda.synchronize()
    vg_s = time.perf_counter() - t0
    vg_launches = dict(knn.LAUNCHES)
    check(vg_launches["knn_fused"] == per_step
          and vg_launches["knn_stream"] == 0,
          f"14b: value_and_grad launches {vg_launches}, want knn_fused "
          f"{per_step}")
    train_step, opt = tuning.make_train_step(cfg_t, None, tc)
    params, opt_state = p0, opt.init(p0)
    losses, walls, step_launches = [], [], []
    for _ in range(TRAIN_OPT_STEPS):
        zero_counts(engine, knn)
        t0 = time.perf_counter()
        params, opt_state, loss = train_step(params, opt_state, *state_t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
        step_launches.append(knn.LAUNCHES["knn_fused"])
    check(all(n == per_step for n in step_launches),
          f"14b: knn_fused launches per train step {step_launches}, want "
          f"{per_step}")
    check(np.isfinite(losses).all() and min(losses[1:]) < losses[0],
          f"14b: losses {losses} not finite and descending")
    check(float(loss0) == losses[0], "14b: the train step's first loss "
          "differs from value_and_grad's")
    out["runs"]["phase 14b"] = {"launches": {
        "knn_fused": vg_launches["knn_fused"] + sum(step_launches)}}
    print(f"14b: N={TRAIN_N} E={TRAIN_E} horizon {TRAIN_HORIZON} (remat): "
          f"losses {[round(v, 6) for v in losses]}, train step "
          f"{[round(w, 3) for w in walls]} s (value_and_grad {vg_s:.3f} s), "
          f"knn_fused {per_step} launches per step; start "
          f"{params_line(p0)}, trained {params_line(params)}")
    cfg_c = dense_cfg(TRAIN_CROSS_N)
    lg_c = tuning.make_loss_and_grad_fn(cfg_c, None, tc)
    cross = {}
    for dev in ("cuda", "cpu"):
        p = tuning.TunableParams(*(v.to(dev) for v in p0))
        st = ensemble_initial_states(cfg_c, range(TRAIN_E), device=dev)
        cross[dev] = lg_c(p, *st)
    l_card, l_cpu = float(cross["cuda"][0]), float(cross["cpu"][0])
    g_card = np.array([float(v) for v in cross["cuda"][1]])
    g_cpu = np.array([float(v) for v in cross["cpu"][1]])
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_rel = float(np.abs(g_card - g_cpu).max() / np.abs(g_cpu).max())
    check(loss_rel <= TRAIN_CROSS_LOSS_RTOL
          and grad_rel <= TRAIN_CROSS_GRAD_RTOL,
          f"14b: N={TRAIN_CROSS_N} card vs CPU loss {l_card} / {l_cpu}, "
          f"gradients {g_card} / {g_cpu}")
    print(f"14b: N={TRAIN_CROSS_N} card vs CPU: loss {l_card:.9g} / "
          f"{l_cpu:.9g} (rel {loss_rel:.3e}), gradients rel {grad_rel:.3e}")

    # 14c. forced streaming
    lg_s = tuning.make_loss_and_grad_fn(
        dataclasses.replace(cfg_t, gating="streaming"), None, tc)
    zero_counts(engine, knn)
    t0 = time.perf_counter()
    loss_s, grad_s = lg_s(p0, *state_t)
    torch.cuda.synchronize()
    s_s = time.perf_counter() - t0
    s_launches = dict(knn.LAUNCHES)
    check(s_launches["knn_stream"] == per_step
          and s_launches["knn_fused"] == 0,
          f"14c: launches {s_launches}, want knn_stream {per_step}")
    check(torch.equal(loss_s, loss0)
          and all(torch.equal(a, b) for a, b in zip(grad_s, grad0)),
          "14c: streaming loss or gradient differs from 14b's")
    out["runs"]["phase 14c"] = {"launches": {"knn_stream": per_step}}
    print(f"14c: gating='streaming': {per_step} knn_stream launches, loss "
          f"and gradient torch.equal to 14b's ({s_s:.3f} s)")

    # 14d. the two-layer trainer at N=512 and the certificate's gradient
    cfg_2 = dense_cfg(TWO_N, certificate=True, certificate_backend="sparse")
    tc2 = tuning.TrainConfig(steps=TWO_HORIZON, unroll_relax=2,
                             learning_rate=3e-2)
    state_2 = ensemble_initial_states(cfg_2, range(TRAIN_E), device="cuda")
    ts2, opt2 = tuning.make_train_step(cfg_2, None, tc2)
    params2, st2 = p0, opt2.init(p0)
    losses2, walls2 = [], []
    zero_counts(engine, knn)
    for _ in range(TWO_OPT_STEPS):
        t0 = time.perf_counter()
        params2, st2, loss = ts2(params2, st2, *state_2)
        torch.cuda.synchronize()
        walls2.append(time.perf_counter() - t0)
        losses2.append(float(loss))
    out["runs"]["phase 14d"] = {"launches": dict(knn.LAUNCHES)}
    check(np.isfinite(losses2).all() and min(losses2[1:]) < losses2[0],
          f"14d: two-layer losses {losses2} not finite and descending")
    rng = np.random.default_rng(5)
    lin = np.linspace(-4.0, 4.0, FD_SIDE)
    gxm, gym = np.meshgrid(lin, lin)
    xg = torch.tensor(np.stack([gxm.ravel(), gym.ravel()])
                      + rng.uniform(-0.05, 0.05, (2, FD_SIDE ** 2)),
                      dtype=torch.float32, device="cuda")
    u = torch.tensor(rng.normal(0, 0.1, (2, FD_SIDE ** 2)),
                     dtype=torch.float32, device="cuda")

    def cert_loss(d):
        return torch.sum(certificates.si_barrier_certificate_sparse(
            d, xg, k=8, neighbor_backend="pallas",
            arena=(-5.0, 5.0, -5.0, 5.0)) ** 2)

    ug = u.clone().requires_grad_()
    g_fd, = torch.autograd.grad(cert_loss(ug), ug)
    up, um = u.clone(), u.clone()
    up[1, 100] += FD_EPS
    um[1, 100] -= FD_EPS
    with torch.no_grad():
        fd = (float(cert_loss(up)) - float(cert_loss(um))) / (2 * FD_EPS)
    check(bool(torch.isfinite(g_fd).all())
          and abs(float(g_fd[1, 100]) - fd) < FD_RTOL * max(abs(fd), 1.0),
          f"14d: certificate gradient {float(g_fd[1, 100])} vs finite "
          f"difference {fd}")
    print(f"14d: N={TWO_N} two layers, horizon {TWO_HORIZON}: losses "
          f"{[round(v, 6) for v in losses2]}, train step "
          f"{[round(w, 3) for w in walls2]} s, {params_line(params2)}; "
          f"certificate gradient at N={FD_SIDE ** 2} "
          f"{float(g_fd[1, 100]):.6f} vs finite difference {fd:.6f}")

    # 14e. the falsifier at BENCH_VERIFY's shape
    cfg_v = swarm.Config(n=VERIFY_N, steps=VERIFY_STEPS)
    settings = V.SearchSettings(budget=VERIFY_BATCH * VERIFY_ROUNDS,
                                batch=VERIFY_BATCH, seed=0)
    adapter = V.make_adapter("swarm", cfg_v, device="cuda")
    eval_b = V.make_eval_batch(adapter, settings)
    key = prng.prng_key(settings.seed)

    def deltas_for(r):
        return (settings.perturb_scale * prng.normal(
            prng.fold_in(key, r), (VERIFY_BATCH, VERIFY_N, 2),
            torch.float32)).to("cuda")

    d0 = deltas_for(0)
    zero_counts(engine, knn)
    t0 = time.perf_counter()
    m0 = eval_b(d0)
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    fresh_launches, fresh_counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
    check(fresh_launches["knn_fused_members"] == VERIFY_STEPS,
          f"14e: member launches {fresh_launches}, want {VERIFY_STEPS}")
    walls_v = []
    for r in range(1, VERIFY_ROUNDS + 1):
        d = deltas_for(r)
        t0 = time.perf_counter()
        eval_b(d)
        torch.cuda.synchronize()
        walls_v.append(time.perf_counter() - t0)
    warm_s = min(walls_v)
    one = V.make_eval_one(adapter, settings)
    gaps = []
    for b in (0, VERIFY_BATCH - 1):
        alone = one(d0[b])
        fin = torch.isfinite(alone)
        check(torch.equal(torch.isfinite(m0[b]), fin),
              f"14e: candidate {b}'s vacuous margins differ")
        gap = float((alone[fin] - m0[b][fin]).abs().max())
        gaps.append(gap)
        check(gap <= MEMBER_MARGIN_ATOL,
              f"14e: candidate {b} alone {alone} vs batched {m0[b]}")
    engines = {}
    member_launches = fresh_launches["knn_fused_members"]
    for name, fn in (("random", V.random_search), ("cem", V.cem_search)):
        zero_counts(engine, knn)
        t0 = time.perf_counter()
        res = fn(adapter, settings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(knn.LAUNCHES)
        check(launches["knn_fused_members"] == res.rounds * VERIFY_STEPS,
              f"14e: {name} launches {launches} over {res.rounds} rounds")
        member_launches += launches["knn_fused_members"]
        engines[name] = (res, wall, dict(engine.COUNTS))
    cfg_vs = dataclasses.replace(cfg_v, gating="streaming")
    adapter_s = V.make_adapter("swarm", cfg_vs, device="cuda")
    zero_counts(engine, knn)
    m_s = V.make_eval_batch(adapter_s, settings)(d0)
    torch.cuda.synchronize()
    stream_launches = knn.LAUNCHES["knn_stream_members"]
    check(stream_launches == VERIFY_STEPS
          and torch.equal(torch.isfinite(m_s), torch.isfinite(m0))
          and float((m_s - m0)[torch.isfinite(m0)].abs().max()) == 0.0,
          f"14e: the streaming batch ({stream_launches} launches) differs")
    out["runs"]["phase 14e"] = {"launches": {
        "knn_fused_members": member_launches,
        "knn_stream_members": stream_launches}}
    out["members"]["knn_fused"]["launches"] = member_launches
    out["members"]["knn_stream"]["launches"] = stream_launches
    print(f"14e: falsifier N={VERIFY_N} x {VERIFY_STEPS}, batch "
          f"{VERIFY_BATCH}: fresh {VERIFY_BATCH / fresh_s:.3f} candidates/s "
          f"({fresh_s:.3f} s, capture included; captures "
          f"{fresh_counts['captures']}, redos {fresh_counts['redos']}), warm "
          f"{VERIFY_BATCH / warm_s:.3f} candidates/s (rounds "
          f"{[round(w, 4) for w in walls_v]} s), {VERIFY_STEPS} member "
          f"launches per batch; candidates alone vs batched max gap "
          f"{max(gaps):.3e}; streaming batch equal, {stream_launches} "
          "knn_stream member launches")
    for name, (res, wall, counts) in engines.items():
        print(f"14e: {name}: margin {res.margin:.6f} ({res.property}), "
              f"found {res.found}, {res.evaluated} candidates in "
              f"{res.rounds} rounds, {wall:.3f} s, redos {counts['redos']}")

    # 14f. the falsification walkthrough and the gradient engine
    weak = CBFParams(max_speed=15.0, k=0.0, dmin=0.16)
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts(engine, knn)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = falsify_swarm.main(["--device", "cuda", "--out", tmp])
        walk_s = time.perf_counter() - t0
    print("\n".join("14f: " + line for line in buf.getvalue().splitlines()))
    check(rc == 0, f"14f: the falsification walkthrough returned {rc}")
    adapter_d = V.make_adapter("swarm", swarm.Config(**CORPUS_CFG),
                               cbf=weak, differentiable=True, device="cuda")
    grad_b = search.make_grad_batch(adapter_d, settings)
    dg = (0.04 * prng.normal(prng.prng_key(2), (8, 16, 2),
                             torch.float32)).to("cuda")
    obj, _, grads = grad_b(dg)
    check(bool(torch.isfinite(grads).all()) and float(grads.abs().sum()) > 0
          and bool(torch.isfinite(obj).all()),
          "14f: gradient_search's batch gradients not finite")
    print(f"14f: walkthrough {walk_s:.1f} s; gradient_search batch of 8: "
          f"objective min {float(obj.min()):.6f}, gradient norms "
          f"{float(grads.flatten(1).norm(dim=1).min()):.4e}-"
          f"{float(grads.flatten(1).norm(dim=1).max()):.4e}, finite")

    # 14g. the corpus in float64, card vs CPU, and the CLI
    import os
    corpus = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "corpus", "violations.jsonl")
    for entry in V.load_entries(corpus):
        card_r = V.replay_entry(entry, device="cuda")
        cpu_r = V.replay_entry(entry, device="cpu")
        gap = abs(card_r["margin"] - cpu_r["margin"])
        check(V.check_verdict(entry, card_r) == []
              and gap <= CORPUS_REPLAY_ATOL,
              f"14g: {entry['scenario']}/{entry['expect']} card "
              f"{card_r['margin']!r} cpu {cpu_r['margin']!r}")
        print(f"14g: {entry['scenario']} expect {entry['expect']}: card "
              f"{card_r['margin']!r}, CPU {cpu_r['margin']!r} (gap "
              f"{gap:.3e}), recorded {entry['margin_x64']!r}")
    args = ["verify", "swarm", "--device", "cuda", "--budget", "32",
            "--batch", "16", "--no-shrink", "--json"]
    for key_, value in CORPUS_CFG.items():
        args += ["--set", f"{key_}={value}"]
    for extra, want in ((["--weaken", "dmin=0.16"], 3), ([], 0)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args + extra)
        record = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == want, f"14g: verify {' '.join(extra)} exited {rc}, "
              f"want {want}")
        print(f"14g: verify {' '.join(extra) or '(default filter)'}: exit "
              f"{rc}; " + "; ".join(
                  f"{r['engine']} margin {r['margin']:.6f} found "
                  f"{r['found']}" for r in record["results"]))
    print(f"phase 14 done (script at {time.perf_counter() - t_start:.1f} s)")
    return out


def banded_member_bound(knn, x, w: int, k: int, count) -> tuple[float, str]:
    """(bound ms, by) of one member-axis ``knn_banded`` launch set on
    (B, N, 2) ``x``: B single launches' work, counted on this input —
    each row against the real columns of its block's window (the windows'
    starts from ``band_setup``), OPS_PER_PAIR each, plus k per in-radius
    candidate; bytes: positions read, the starts, and the five outputs."""
    import torch

    B, n = x.shape[0], x.shape[1]
    _, _, starts, _, w_eff = knn.band_setup(x, RADIUS, w)
    starts = starts.long()
    row0 = torch.arange(starts.shape[1], device=x.device) * knn.RTILE
    rows = (n - row0).clamp(min=0, max=knn.RTILE)
    cols = (starts + w_eff * knn.CTILE).clamp(max=n) - starts
    pairs = int((cols * rows[None]).sum())
    t_ops = (OPS_PER_PAIR * pairs + k * int(count.sum())) / \
        PEAK_F32_ISSUE_PER_S
    t_bytes = B * (8 * n + 4 * starts.shape[1] + n * (k * 8 + 9)) / \
        PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase15a(knn, swarm) -> dict:
    """15a: the member-axis ``knn_banded`` (module docstring, phase 15).
    Returns the member row's data at the falsifier's shape (N=256, B=16)
    and at phase 7's (N=65536, B=4)."""
    import torch

    held = 0
    for n, bs in ((VERIFY_N, MEMBER_BS),
                  (MAIN_N, MEMBER_BS), (BANDED_N, (BANDED_MEMBERS,))):
        w = swarm.banded_window_blocks(swarm.Config(n=n))
        for B in bs:
            x = member_inputs(swarm, n, B, seed0=11 * B + n)
            got = knn.knn_banded(x, RADIUS, K, window_blocks=w)
            want = knn.knn_neighbors_banded_plain(x, RADIUS, K,
                                                  window_blocks=w)
            check(all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(got, want)),
                  f"15a: knn_banded B={B} N={n} differs from its batched "
                  "plain version")
            for b in range(B):
                single = knn.knn_banded(x[b].contiguous(), RADIUS, K,
                                        window_blocks=w)
                check(all(torch.equal(a[b], c) for a, c in zip(got, single)),
                      f"15a: knn_banded B={B} N={n} member {b} differs from "
                      "its single launch")
            if n != VERIFY_N:
                pro = knn.band_prologue(x, RADIUS, w)
                setup = knn.band_setup(x, RADIUS, w)
                check(all(torch.equal(a, c) for a, c in zip(pro[:4],
                                                            setup[:4])),
                      f"15a: band_prologue B={B} N={n} differs from "
                      "band_setup")
                srt = knn.knn_banded_sorted(setup[1], setup[2], RADIUS, K,
                                            setup[4])
                check(all(torch.equal(a, c) for a, c in zip(
                    srt, knn.knn_banded_sorted_plain(
                        setup[1], setup[2], RADIUS, K, setup[4]))),
                      f"15a: knn_banded_sorted B={B} N={n} differs from "
                      "its plain version")
            held += 1
            print(f"  15a: knn_banded B={B} N={n} (window {w} blocks, "
                  f"ranges %d x %d): equal to the batched plain version and "
                  f"to {B} single launches; overflow rows per member "
                  f"{[int(v) for v in got[3].sum(dim=1)]}"
                  % knn.band_plan(n, min(w, knn._band_pad(n) // knn.CTILE),
                                  x.device, B))
    # A thin member beside spread ones: its overflow is flagged, theirs
    # not, and each equals its single launch.
    gen = torch.Generator().manual_seed(3)
    thin = torch.stack([torch.rand(MAIN_N, generator=gen) - 0.5,
                        torch.rand(MAIN_N, generator=gen) * 1e-3], 1)
    x = member_inputs(swarm, MAIN_N, 3, seed0=40)
    x[1] = thin.cuda()
    got = knn.knn_banded(x, RADIUS, K, window_blocks=1)
    flagged = [bool(v) for v in got[3].any(dim=1)]
    check(flagged[1] and all(torch.equal(a[b], c) for b in range(3)
                             for a, c in zip(got, knn.knn_banded(
                                 x[b].contiguous(), RADIUS, K,
                                 window_blocks=1))),
          f"15a: the thin member's overflow ({flagged}) or a member differs")
    print(f"15a: {held} member-axis knn_banded launch sets equal to their "
          f"batched plain versions and to single launches (B=1: the "
          f"single-swarm launch); a thin member flags overflow alone: "
          f"{flagged}")
    out = {}
    for label, n, B in (("falsifier", VERIFY_N, VERIFY_BATCH),
                        ("phase 7", BANDED_N, BANDED_MEMBERS)):
        w = swarm.banded_window_blocks(swarm.Config(n=n))
        x = member_inputs(swarm, n, B, seed0=100)
        count = knn.knn_banded(x, RADIUS, K, window_blocks=w)[-1]
        bound, by = banded_member_bound(knn, x, w, K, count)
        t = time_call(lambda: knn.knn_banded(x, RADIUS, K, window_blocks=w))
        t.pop("device_op_names")
        single = time_call(lambda: knn.knn_banded(
            x[0].contiguous(), RADIUS, K, window_blocks=w))
        out[label] = {
            "b": B, "n": n, "window_blocks": w, **t,
            "single_member_ms": single["ms"],
            "single_member_device_ms": single["kernel_device_ms"],
            "plain_ms": cuda_ms(lambda: knn.knn_neighbors_banded_plain(
                x, RADIUS, K, window_blocks=w), reps=3 if n > 4096 else 10,
                warmup=1)[0],
            "bound_ms": bound, "bound_by": by}
        print(f"15a: knn_banded member axis B={B} N={n} (W={w}): median "
              f"{t['ms']:.4f} ms, device {t['kernel_device_ms']} ms, "
              f"{t['device_ops_per_call']} device ops per launch set; one "
              f"member alone {single['ms']:.4f} ms (device "
              f"{single['kernel_device_ms']}); plain {out[label]['plain_ms']:.3f}"
              f" ms; bound {bound:.5f} ms ({by})")
    return out


def drive_ensemble(engine, knn, swarm, ens, mesh, cfg, seeds, label,
                   member_key, per_step=1, eager_prefix=None) -> dict:
    """15c-f: ``sharded_swarm_rollout`` on the card (its first call for
    this program, so the capture is inside), the launch and engine counts
    zeroed just before and read just after, the peak device memory around
    it; then the eager loop of the same step program from the same carry
    (``engine.eager_rollout``), which the compiled run must equal — final
    carry and every metric, ``torch.equal`` — over the whole horizon, or
    over its first ``eager_prefix`` steps against a compiled run of that
    length; then the compiled run timed again (graphs cached). Checks
    ``member_key`` launched ``per_step`` times per step (more only where a
    chunk was redone) and no kernel outside ``member_key``'s family.
    Returns a dict of the run."""
    import torch

    E = len(seeds)
    torch.cuda.synchronize()
    zero_counts(engine, knn)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, mets = ens.sharded_swarm_rollout(cfg, mesh, seeds)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches, counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    kernel = member_key.removesuffix("_members")
    others = {k: v for k, v in launches.items()
              if v and not k.startswith(kernel)}
    check(not others and launches[member_key] >= per_step * cfg.steps
          and (counts["redos"] or launches[member_key]
               == per_step * cfg.steps),
          f"{label}: launches {launches}, want {member_key} "
          f"{per_step * cfg.steps}")
    cbf = swarm.default_cbf(cfg, device=mesh.device)
    step = ens._rollout_executable(cfg, mesh, E, cbf)
    carry = ens._initial_carry(cfg, mesh, seeds)
    n_eager = cfg.steps if eager_prefix is None else eager_prefix
    zero_counts(engine, knn)
    eager = []
    eager_s = timed(lambda: eager.extend(engine.eager_rollout(step, carry,
                                                              n_eager)))
    ef, eo = eager
    if n_eager == cfg.steps:
        co = ens.EnsembleMetrics(*(torch.swapaxes(m, 0, 1) for m in mets))
        held = [same_tree(a, b) for a, b in zip(state, ef)]
    else:
        cf, co = engine.rollout(step, carry, n_eager)
        held = [same_tree(cf, ef)]
    check(all(held) and all(same_tree(a, b) for a, b in zip(co, eo)),
          f"{label}: compiled differs from the eager loop over {n_eager} "
          "steps")
    again = []
    wall = timed(lambda: again.extend(ens.sharded_swarm_rollout(
        cfg, mesh, seeds)))
    check(same_tree(tuple(again[0]), tuple(state))
          and all(same_tree(a, b) for a, b in zip(again[1], mets)),
          f"{label}: a timed compiled run differs from the first")
    info = {
        "e": E, "n": cfg.n, "steps": cfg.steps,
        "relax_rounds_captured": step.relax_rounds,
        "redos": counts["redos"], "redo_steps": counts["redo_steps"],
        "captures": counts["captures"], "replays": counts["replays"],
        "first_call_s": first, "compiled_s": wall,
        "compiled_step_ms": wall / cfg.steps * 1e3,
        "compiled_agent_qp_steps_per_s": E * cfg.n * cfg.steps / wall,
        "eager_steps": n_eager, "eager_s": eager_s,
        "eager_step_ms": eager_s / n_eager * 1e3,
        "eager_agent_qp_steps_per_s": E * cfg.n * n_eager / eager_s,
        "launches_per_step": launches[member_key] / cfg.steps,
        "peak_over_held_mib": (peak - base) / 2**20}
    print(f"{label}: compiled == eager over {n_eager} steps (final carry, "
          f"every metric); launches {launches}; " + json.dumps(info))
    # The member launches, and the same kernel's single launches beside
    # them (the lockstep certificate searches each member alone).
    record = {member_key: launches[member_key]}
    if launches[kernel] > launches[member_key]:
        record[kernel] = launches[kernel] - launches[member_key]
    return {"state": state, "mets": mets, "info": info, "launches": record}


def hold_ensemble_search(knn, name, cfg, positions, label) -> dict:
    """15c/15d: the member-axis launch of ``name`` (``knn_fused`` or
    ``knn_stream``) on an ensemble's own (E, N, 2) positions (label ->
    tensor) at the step's radius and k, every output ``torch.equal`` to
    its plain version and to single launches of members 0, 1, E/2 and
    E-1; then one launch on the last positions timed beside its bound and
    the plain version. Returns the member row's entry at this shape."""
    import torch

    fn = getattr(knn, name)
    plain = (knn.knn_neighbors_plain if name == "knn_fused"
             else knn.knn_neighbors_blocked_plain)
    r, k = cfg.safety_distance, min(cfg.k_neighbors, cfg.n - 1)
    for what, x in positions.items():
        x = x.to(torch.float32).contiguous()
        E = x.shape[0]
        got = fn(x, r, k)
        check(all(a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in zip(got, plain(x, r, k))),
              f"{label}: {name} on the {what} positions differs from its "
              "plain version")
        for b in sorted({0, 1, E // 2, E - 1}):
            single = fn(x[b].contiguous(), r, k)
            check(all(torch.equal(a[b], c) for a, c in zip(got, single)),
                  f"{label}: {name} member {b} on the {what} positions "
                  "differs from its single launch")
    count = got[-1]
    bound, by = member_bound(x, k, count)
    t = time_call(lambda: fn(x, r, k))
    t.pop("device_op_names")
    entry = {"b": E, "n": cfg.n, "k": k, "radius": r, **t,
             "plain_ms": cuda_ms(lambda: plain(x, r, k), reps=5,
                                 warmup=1)[0],
             "bound_ms": bound, "bound_by": by,
             "in_radius_candidates": int(count.sum())}
    print(f"{label}: {name} member axis on the ensemble's "
          f"{' and '.join(positions)} positions (B={E}, N={cfg.n}, k={k}, "
          f"r={r}) equal to its plain version and to single launches; one "
          f"launch median {t['ms']:.4f} ms, device {t['kernel_device_ms']} "
          f"ms, plain {entry['plain_ms']:.3f} ms, bound {bound:.5f} ms "
          f"({by})")
    return entry


def check_members(label, cfg, mets, floor=FLOOR, dips=None) -> float:
    """Finite metrics (the nearest distance may be +inf: no neighbour in
    the gating radius), 0 infeasible agent-steps, the floor (unless None)
    in every member — except a member listed in ``dips`` (member ->
    the reference's own minimum below the floor), held to that minimum
    within CROSS_MD_ATOL. Returns the smallest member minimum."""
    import torch

    md = mets.nearest_distance
    check(not bool(torch.isnan(md).any()) and all(
        bool(torch.isfinite(m).all()) for m in
        (mets.certificate_residual, mets.saturation_deficit)),
          f"{label}: non-finite metrics")
    per_member = md.amin(dim=1)
    infeasible = int(mets.infeasible_count.sum())
    check(infeasible == 0, f"{label}: {infeasible} infeasible agent-steps")
    if floor is not None:
        want = torch.full_like(per_member, floor)
        for member, ref_min in (dips or {}).items():
            want[member] = ref_min - CROSS_MD_ATOL
        below = torch.nonzero(per_member < want).flatten().tolist()
        check(not below, f"{label}: members {below} below the floor (or "
              f"their reference minimum): "
              f"{[float(per_member[m]) for m in below]}")
        if dips:
            print(f"{label}: {len(dips)} members held to the reference's "
                  f"own dip below the floor; their minima "
                  f"{[round(float(per_member[m]), 8) for m in dips]}")
    print(f"{label}: member min distances {float(per_member.min()):.6f}-"
          f"{float(per_member.max()):.6f} "
          f"({'floor %.5f' % floor if floor is not None else 'not held'}), "
          f"infeasible 0, dropped {int(mets.dropped_count.sum())}")
    return float(per_member.min())


def phase15(engine, knn, swarm, t_start) -> dict:
    """15b-f: the falsifier on a banded swarm, and the ensembles on one
    card (module docstring, phase 15). Returns each run's launches and
    the numbers PERF.md keeps."""
    import dataclasses

    import torch

    from cbf_tpu_torch import verify as V
    from cbf_tpu_torch.parallel import ensemble as ens
    from cbf_tpu_torch.parallel.mesh import make_mesh
    from cbf_tpu_torch.utils import prng

    out = {"runs": {}, "members": {"knn_fused": {}, "knn_stream": {}}}
    mesh = make_mesh()
    check(tuple(mesh) == (1, 1), f"15: the card's mesh is {tuple(mesh)}")

    # 15b. the falsifier on gating="banded" at BENCH_VERIFY's shape
    cfg_v = swarm.Config(n=VERIFY_N, steps=VERIFY_STEPS, gating="banded")
    settings = V.SearchSettings(batch=VERIFY_BATCH, seed=0)
    adapter = V.make_adapter("swarm", cfg_v, device="cuda")
    eval_b = V.make_eval_batch(adapter, settings)
    key = prng.prng_key(settings.seed)

    def deltas_for(r):
        return (settings.perturb_scale * prng.normal(
            prng.fold_in(key, r), (VERIFY_BATCH, VERIFY_N, 2),
            torch.float32)).to("cuda")

    d0 = deltas_for(0)
    zero_counts(engine, knn)
    t0 = time.perf_counter()
    m0 = eval_b(d0)
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    fresh, counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
    check(fresh["knn_banded_members"] == VERIFY_STEPS
          and fresh["knn_banded"] == VERIFY_STEPS
          and not any(v for k, v in fresh.items() if "banded" not in k)
          and counts["redos"] == 0,
          f"15b: launches {fresh}, engine {counts}; want one banded "
          f"launch set per step ({VERIFY_STEPS}) and no redo")
    walls = []
    for r in range(1, VERIFY_ROUNDS + 1):
        d = deltas_for(r)
        walls.append(timed(lambda: eval_b(d)))
    one = V.make_eval_one(adapter, settings)
    gaps = []
    for b in (0, VERIFY_BATCH - 1):
        alone = one(d0[b])
        fin = torch.isfinite(alone)
        check(torch.equal(torch.isfinite(m0[b]), fin),
              f"15b: candidate {b}'s vacuous margins differ")
        gaps.append(float((alone[fin] - m0[b][fin]).abs().max()))
        check(gaps[-1] <= MEMBER_MARGIN_ATOL,
              f"15b: candidate {b} alone {alone} vs batched {m0[b]}")
    out["runs"]["phase 15b"] = {"launches": {
        "knn_banded_members": fresh["knn_banded_members"]}}
    out["15b"] = {"fresh_candidates_per_s": VERIFY_BATCH / fresh_s,
                  "warm_candidates_per_s": VERIFY_BATCH / min(walls),
                  "fresh_s": fresh_s, "warm_s": walls, "max_gap": max(gaps),
                  "margin_min": float(m0[torch.isfinite(m0)].min())}
    print(f"15b: falsifier, gating='banded', N={VERIFY_N} x {VERIFY_STEPS}, "
          f"batch {VERIFY_BATCH}: fresh {VERIFY_BATCH / fresh_s:.3f} "
          f"candidates/s ({fresh_s:.3f} s, capture included), warm "
          f"{VERIFY_BATCH / min(walls):.3f} (rounds "
          f"{[round(w, 4) for w in walls]} s); {VERIFY_STEPS} banded member "
          f"launch sets, 0 redos; alone vs batched max gap {max(gaps):.3e}; "
          f"margin min {out['15b']['margin_min']:.6f}")

    # 15c. the Monte-Carlo sweep: 1024 seeds x 64 agents
    cfg_c = swarm.Config(n=MC_N, steps=MC_STEPS)
    run = drive_ensemble(engine, knn, swarm, ens, mesh, cfg_c,
                         list(range(MC_E)), f"15c: E={MC_E} x N={MC_N}",
                         "knn_fused_members", eager_prefix=MC_EAGER_STEPS)
    check_members(f"15c: E={MC_E} x N={MC_N} x {MC_STEPS}", cfg_c,
                  run["mets"], dips=MC_REFERENCE_DIPS)
    out["members"]["knn_fused"]["at_phase_15c"] = hold_ensemble_search(
        knn, "knn_fused", cfg_c,
        {"spawn": ens._initial_carry(cfg_c, mesh, range(MC_E))[0],
         "final": run["state"][0]}, "15c")
    out["runs"]["phase 15c"] = run
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 15d. the north-star width: 8 members of 4096, fused and streaming
    for gating in ("auto", "streaming"):
        cfg_d = swarm.Config(n=MAIN_N, steps=ENS_STEPS, gating=gating)
        key_d = ("knn_stream_members" if gating == "streaming"
                 else "knn_fused_members")
        run = drive_ensemble(engine, knn, swarm, ens, mesh, cfg_d,
                             list(range(ENS_E)),
                             f"15d: E={ENS_E} x N={MAIN_N}, {gating}", key_d)
        check_members(f"15d: E={ENS_E} x N={MAIN_N} x {ENS_STEPS}, "
                      f"{gating}", cfg_d, run["mets"],
                      dips=ENS_REFERENCE_DIPS)
        name = key_d.removesuffix("_members")
        out["members"][name]["at_phase_15d"] = hold_ensemble_search(
            knn, name, cfg_d,
            {"spawn": ens._initial_carry(cfg_d, mesh, range(ENS_E))[0],
             "final": run["state"][0]}, f"15d {gating}")
        out["runs"][f"phase 15d {gating}"] = run
    check(same_tree(out["runs"]["phase 15d auto"]["state"],
                    out["runs"]["phase 15d streaming"]["state"]),
          "15d: the streaming ensemble's trajectory differs from the fused "
          "one")
    print(f"15d: streaming trajectory torch.equal to the fused one  "
          f"(script at {time.perf_counter() - t_start:.1f} s)")

    # 15e. the lockstep batched certificate
    cfg_e = swarm.Config(n=CERT_N, steps=LOCK_STEPS, certificate=True)
    seeds_e = list(range(LOCK_E))
    run = drive_ensemble(engine, knn, swarm, ens, mesh, cfg_e, seeds_e,
                         f"15e: E={LOCK_E} x N={CERT_N}, lockstep sparse "
                         "certificate", "knn_fused_members")
    mets = run["mets"]
    res = mets.certificate_residual.amax(dim=1)
    check(bool((res < CERT_RESIDUAL_GATE).all()),
          f"15e: member residuals {res.tolist()} past the gate")
    check_members(f"15e: E={LOCK_E} x N={CERT_N} x {LOCK_STEPS}", cfg_e,
                  mets, floor=CERT_FLOOR)
    gap_x = gap_r = 0.0
    for e, seed in enumerate(seeds_e):
        (x1, _), m1 = ens.sharded_swarm_rollout(cfg_e, mesh, [seed])
        gap_x = max(gap_x, float((run["state"][0][e] - x1[0]).abs().max()))
        gap_r = max(gap_r, float((mets.certificate_residual[e]
                                  - m1.certificate_residual[0]).abs().max()))
    check(gap_x <= LOCK_X_ATOL and gap_r <= LOCK_RES_ATOL,
          f"15e: lockstep vs members alone: x gap {gap_x}, residual gap "
          f"{gap_r}")
    step_e = ens._rollout_executable(
        cfg_e, mesh, LOCK_E, swarm.default_cbf(cfg_e, device="cuda"))
    carry_e = ens._initial_carry(cfg_e, mesh, seeds_e)
    prof = profile_rollout(lambda: engine.rollout(step_e, carry_e,
                                                  CERT_PROFILE_STEPS),
                           CERT_PROFILE_STEPS)
    run["info"].update(residual_max=float(res.max()), lockstep_x_gap=gap_x,
                       lockstep_residual_gap=gap_r,
                       device_ops_per_step=prof["device_ops_per_step"],
                       device_busy_share=prof["device_busy_share"],
                       iterations=int(mets.certificate_iterations.max()))
    out["runs"]["phase 15e"] = run
    print(f"15e: residual max {float(res.max()):.3e} per member "
          f"{[f'{v:.2e}' for v in res.tolist()]}; lockstep vs each member "
          f"alone: x gap {gap_x:.3e} (atol {LOCK_X_ATOL}), residual gap "
          f"{gap_r:.3e}; {prof['device_ops_per_step']} device ops per step, "
          f"busy {prof['device_busy_share']}  (script at "
          f"{time.perf_counter() - t_start:.1f} s)")

    # 15f. chunk and resume, and the Verlet cache at E = 1
    cfg_f = swarm.Config(n=MAIN_N, steps=ENS_STEPS_F)
    seeds_f = list(range(LOCK_E))
    straight, mets_s = ens.sharded_swarm_rollout(cfg_f, mesh, seeds_f)
    chunked, mets_c = ens.sharded_swarm_rollout(cfg_f, mesh, seeds_f,
                                                chunk=ENS_CHUNK)
    check(same_tree(tuple(chunked), tuple(straight))
          and all(bool((torch.as_tensor(a) == b.cpu()).all())
                  for a, b in zip(mets_c, mets_s)),
          f"15f: chunk={ENS_CHUNK} differs from the unchunked run")
    # The warm carry under certificate_tol: the lockstep loop runs to its
    # slowest member, so its program takes the whole ADMM budget — no
    # chunk may be redone (each redo is the eager loop, ~0.5 s per step).
    cfg_w = swarm.Config(n=CERT_N, steps=ENS_STEPS_F, certificate=True,
                         certificate_warm_start=True,
                         certificate_tol=CERT_TOL)
    zero_counts(engine, knn)
    full, mets_w = ens.sharded_swarm_rollout(cfg_w, mesh, seeds_f,
                                             with_solver_state=True)
    half = ENS_STEPS_F // 2
    head, _ = ens.sharded_swarm_rollout(cfg_w, mesh, seeds_f, steps=half,
                                        with_solver_state=True)
    tail, _ = ens.sharded_swarm_rollout(cfg_w, mesh, seeds_f, steps=half,
                                        t0=half, initial_state=head,
                                        with_solver_state=True)
    check(same_tree(tuple(tail), tuple(full)),
          "15f: the warm-carry resume differs from the straight run")
    check(float(mets_w.certificate_residual.max()) < CERT_RESIDUAL_GATE,
          "15f: warm certificate residual past the gate")
    out["runs"]["phase 15f warm"] = {"launches": {
        "knn_fused_members": knn.LAUNCHES["knn_fused_members"],
        "knn_fused": (knn.LAUNCHES["knn_fused"]
                      - knn.LAUNCHES["knn_fused_members"])}}
    warm_counts = dict(engine.COUNTS)
    iters, steps_at = torch.unique(mets_w.certificate_iterations[0],
                                   return_counts=True)
    histogram = dict(zip(iters.tolist(), steps_at.tolist()))
    print(f"15f: warm start, tol {CERT_TOL}, E={LOCK_E} x N={CERT_N}: "
          f"redos {warm_counts['redos']} (redone steps "
          f"{warm_counts['redo_steps']}) over the three runs; lockstep "
          f"iterations per step -> steps of the straight run {histogram}")
    check(warm_counts["redos"] == 0, f"15f: the warm runs redid chunks "
          f"{warm_counts}")
    cfg_v1 = swarm.Config(n=MAIN_N, steps=ENS_STEPS_F,
                          gating_rebuild_skin=VERLET_SKIN)
    verlet = drive_ensemble(engine, knn, swarm, ens, mesh, cfg_v1, [0],
                            f"15f: E=1 x N={MAIN_N}, Verlet skin "
                            f"{VERLET_SKIN}", "knn_fused")
    exact = ens.sharded_swarm_rollout(dataclasses.replace(
        cfg_v1, gating_rebuild_skin=0.0), mesh, [0])
    floor_v = verlet["mets"].nearest_distance[0]
    near_e = exact[1].nearest_distance[0]
    same = torch.equal(verlet["state"][0], exact[0][0])
    check(int(verlet["mets"].infeasible_count.sum()) == 0
          and (same or int(exact[1].dropped_count.sum()) > 0),
          "15f: the Verlet run parts from the exact search below "
          "truncation")
    if same:
        check(bool((floor_v <= near_e).all()),
              "15f: the Verlet floor exceeds the exact separation")
    out["runs"]["phase 15f verlet"] = verlet
    out["15f"] = {"chunk": ENS_CHUNK, "verlet_equal_to_exact": same,
                  "verlet_floor_min": float(floor_v.min()),
                  "exact_min": float(near_e.min()),
                  "exact_dropped": int(exact[1].dropped_count.sum()),
                  "warm_iterations_max": int(
                      mets_w.certificate_iterations.max()),
                  "warm_iteration_histogram": histogram,
                  "warm_redos": warm_counts["redos"]}
    print(f"15f: chunk={ENS_CHUNK} torch.equal to the unchunked run "
          f"(E={LOCK_E} x N={MAIN_N} x {ENS_STEPS_F}); the warm-carry "
          f"resume at step {half} torch.equal to the straight run; Verlet "
          f"E=1: trajectory equal to the exact search {same}, its floor "
          f"{float(floor_v.min()):.6f} vs the exact minimum "
          f"{float(near_e.min()):.6f} (exact dropped "
          f"{out['15f']['exact_dropped']}); warm runs {warm_counts}  "
          f"(script at "
          f"{time.perf_counter() - t_start:.1f} s)")
    for run in out["runs"].values():
        run.pop("state", None)
        run.pop("mets", None)
    return out


def phase16(engine, knn, swarm, t_start) -> dict:
    """Phase 16: durability and observability on the card at the flagship
    width (module docstring). Returns each run's launches and the
    measurements."""
    import contextlib
    import glob
    import io
    import os
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    import cbf_tpu_torch
    from cbf_tpu_torch import __main__ as cli
    from cbf_tpu_torch import obs
    from cbf_tpu_torch.durable import rollout as durable
    from cbf_tpu_torch.utils import checkpoint as ckpt
    from cbf_tpu_torch.utils import debug, faults, profiling

    out = {"runs": {}, "info": {}}
    info = out["info"]
    t16 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase16-")

    def counted(label, fn, steps, per_step=1, prepared=False):
        """``fn()`` with the counts zeroed just before and read just
        after: ``knn_fused`` launched per_step times per step — the
        run's, the steps the engine redid eagerly, the steps of a tapped
        run's queued chunks it ran again after such a redo and, where a
        cost model ``prepared`` the program, each capture's warm-up step
        — and no other kernel. Returns (result, wall)."""
        torch.cuda.synchronize()
        zero_counts(engine, knn)
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
        want = dict.fromkeys(knn.LAUNCHES, 0)
        want["knn_fused"] = per_step * (
            steps + counts["redo_steps"] + counts["rerun_steps"]
            + (counts["captures"] if prepared else 0))
        check(launches == want, f"{label}: launches {launches}, want {want}")
        out["runs"][label] = {"launches": launches}
        return result, wall

    def host_tree_equal(a, b) -> bool:
        """numpy StepOutputs trees equal field by field (``()`` on both)."""
        return all(x == () if isinstance(y, tuple) else
                   np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(a, b))

    def damage(directory, step):
        path = os.path.join(directory, str(step), ckpt.DATA_NAME)
        with open(path, "r+b") as fh:
            b = fh.read(1)
            fh.seek(0)
            fh.write(bytes([b[0] ^ 0xFF]))

    try:
        # 16a. checkpointed chunked rollout
        cfg = swarm.Config(n=MAIN_N, steps=DUR_STEPS)
        state0, step = swarm.make(cfg)
        d = os.path.join(tmp, "ckpt")
        states = {}

        def keep(t1, state, outs_host):
            states[t1] = engine._tree_map(torch.clone, state)

        (final_c, outs_c, _), wall_c = counted(
            "phase 16a checkpointed", lambda: engine.rollout_chunked(
                step, state0, DUR_STEPS, chunk=DUR_CHUNK, checkpoint_dir=d,
                durable_hook=keep), DUR_STEPS)
        (final_p, outs_p, _), wall_p = counted(
            "phase 16a plain", lambda: engine.rollout_chunked(
                step, state0, DUR_STEPS, chunk=DUR_CHUNK), DUR_STEPS)
        check(same_tree(final_c, final_p) and host_tree_equal(outs_c, outs_p),
              "16a: the checkpointed run differs from the run without")
        # Both programs captured: the two timed in turns.
        turns = {"plain": [], "checkpointed": []}
        for kind in ("plain", "checkpointed", "checkpointed", "plain"):
            kw = {} if kind == "plain" else {"checkpoint_dir": os.path.join(
                tmp, f"turn{len(turns[kind])}")}
            turns[kind].append(timed(lambda: engine.rollout_chunked(
                step, state0, DUR_STEPS, chunk=DUR_CHUNK, **kw)))
        check(float(outs_c.min_pairwise_distance.min()) >= FLOOR
              and int(outs_c.infeasible_count.sum()) == 0
              and bool(torch.isfinite(final_c.x).all()),
              "16a: the run leaves the floor, is infeasible or non-finite")
        kept = ckpt._steps(d)
        check(kept == [DUR_STEPS - DUR_CHUNK, DUR_STEPS],
              f"16a: retained steps {kept}")
        restore_s = {}
        for s_ in kept:
            t0 = time.perf_counter()
            restored, at = ckpt.restore(d, state0, step=s_)
            torch.cuda.synchronize()
            restore_s[s_] = time.perf_counter() - t0
            check(at == s_ and same_tree(restored, states[s_]),
                  f"16a: step {s_} does not restore its state")
        save_s = {}
        for t1, st in sorted(states.items()):
            save_s[t1] = timed(lambda: ckpt.save(os.path.join(tmp, "sync"),
                                                 t1, st))
        step_bytes = sum(os.path.getsize(os.path.join(d, str(DUR_STEPS), f))
                         for f in os.listdir(os.path.join(d, str(DUR_STEPS))))
        damage(d, DUR_STEPS)
        restored, at, skipped = ckpt.restore_intact(d, state0)
        check(at == DUR_STEPS - DUR_CHUNK and skipped == [DUR_STEPS]
              and same_tree(restored, states[at]),
              f"16a: walk back gave step {at}, skipped {skipped}")
        damage(d, DUR_STEPS - DUR_CHUNK)
        try:
            ckpt.restore(d, state0)
            check(False, "16a: a fully damaged directory restored")
        except ckpt.CheckpointCorrupt:
            pass
        info["16a"] = {
            "steps": DUR_STEPS, "chunk": DUR_CHUNK,
            "first_call_s": {"checkpointed": wall_c, "plain": wall_p},
            "wall_s_in_turns": turns,
            "checkpoint_overhead": sum(turns["checkpointed"])
            / sum(turns["plain"]) - 1.0,
            "save_wall_s_per_boundary": save_s,
            "restore_wall_s_per_step": restore_s,
            "checkpoint_bytes_per_step": step_bytes,
            "retained_steps": kept, "walked_back_to": at,
            "skipped": skipped}
        print("phase 16a: checkpointed == plain (final state, every "
              "StepOutputs field); every committed manifest verifies; the "
              f"damaged newest step {skipped} walked back to {at}; a fully "
              "damaged directory raises CheckpointCorrupt; "
              + json.dumps(info["16a"]))
        print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

        # 16b. kill and resume through the CLI
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(cbf_tpu_torch.__file__)))
        env = dict(os.environ, PYTHONPATH=root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        kill_dir = os.path.join(tmp, "durable")
        argv = [sys.executable, "-m", "cbf_tpu_torch", "run", "swarm",
                "--device", "cuda", "--set", f"n={MAIN_N}", "--steps",
                str(DUR_STEPS), "--chunk", str(DUR_CHUNK), "--durable-dir",
                kill_dir]

        def committed(_elapsed):
            return bool(glob.glob(os.path.join(kill_dir, "ckpt", "*",
                                               "integrity.json")))

        rc, killed, kill_s = faults.run_process_until(
            argv, committed, poll_s=0.05, timeout_s=300.0, env=env)
        check(killed and rc == -9,
              f"16b: the run ended (rc={rc}) before the kill armed")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cbf_tpu_torch", "run", "--resume",
             kill_dir, "--device", "cuda"], env=env, capture_output=True,
            text=True, timeout=600)
        resume_wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"16b: run --resume exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        record = json.loads(proc.stdout.strip().splitlines()[-1])
        check(record["resumed_from_step"] > 0,
              f"16b: resumed from step {record['resumed_from_step']}")
        ref, _ = counted(
            "phase 16b uninterrupted", lambda: durable.run_durable(
                os.path.join(tmp, "durable-ref"), scenario="swarm",
                cfg=swarm.Config(n=MAIN_N, steps=DUR_STEPS),
                chunk=DUR_CHUNK), DUR_STEPS)
        res = durable.resume(kill_dir)
        check(res["resumed_from_step"] == DUR_STEPS,
              "16b: the resumed directory is not complete")
        got = [np.asarray(v) for _, v in durable.integrity.tree_items(
            res["outputs"])]
        want = [np.asarray(v) for _, v in durable.integrity.tree_items(
            ref["outputs"])]
        check(len(got) == len(want) and all(
            a.dtype == b.dtype and a.tobytes() == b.tobytes()
            for a, b in zip(got, want)) and same_tree(
                res["final_state"], ref["final_state"]),
            "16b: the killed-and-resumed run differs from the uninterrupted "
            "one")
        with open(os.path.join(kill_dir, durable.RESUME_LOG_NAME)) as fh:
            log = [json.loads(line) for line in fh]
        info["16b"] = {"killed_after_s": kill_s,
                       "resumed_from_step": record["resumed_from_step"],
                       "mttr_s": log[-1]["recovery_s"],
                       "resume_process_wall_s": resume_wall,
                       "min_pairwise_distance":
                           record["min_pairwise_distance"]}
        print("phase 16b: SIGKILLed at the first committed checkpoint, run "
              "--resume byte-identical to the uninterrupted --durable-dir "
              "run (outputs and final state); " + json.dumps(info["16b"]))
        print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

        # 16c. telemetry, its overhead, and the watchdog's alerts
        cfg = swarm.Config(n=MAIN_N, steps=TEL_STEPS)
        state0, step = swarm.make(cfg)
        run_dir = os.path.join(tmp, "telemetry")
        sink = obs.TelemetrySink(run_dir)
        (final_t, outs_t), _ = counted(
            "phase 16c telemetry", lambda: engine.rollout(
                step, state0, TEL_STEPS, telemetry=sink,
                telemetry_every=TEL_EVERY), TEL_STEPS)
        (final_0, outs_0), _ = counted(
            "phase 16c without telemetry",
            lambda: engine.rollout(step, state0, TEL_STEPS), TEL_STEPS)
        check(same_tree(final_t, final_0)
              and same_tree(tuple(outs_t), tuple(outs_0)),
              "16c: the run with telemetry differs from the run without")
        beats = [e for e in obs.read_events(run_dir)
                 if e.get("event") == "heartbeat"]
        check([e["step"] for e in beats] == list(range(0, TEL_STEPS,
                                                       TEL_EVERY)),
              f"16c: heartbeats at {[e['step'] for e in beats]}")
        for e in beats:
            t = e["step"]
            for f in obs.HEARTBEAT_FIELDS:
                if f.step_output is None:
                    check(e[f.name] == 0, f"16c: {f.name} at step {t}")
                    continue
                leaf = getattr(outs_0, f.step_output)
                if isinstance(leaf, tuple):
                    continue
                check(obs.schema.scalar_value(e[f.name]) == float(leaf[t]),
                      f"16c: heartbeat {f.name} at step {t} differs from "
                      "StepOutputs")
        walls = {"off": [], "on": []}
        for kind in ("off", "on", "on", "off") * TEL_TURNS:
            kw = ({"telemetry": sink, "telemetry_every": TEL_EVERY}
                  if kind == "on" else {})
            walls[kind].append(timed(lambda: engine.rollout(
                step, state0, TEL_STEPS, **kw)))
        overhead = sum(walls["on"]) / sum(walls["off"]) - 1.0
        check(overhead <= TEL_OVERHEAD_FAIL,
              f"16c: telemetry overhead {overhead:.2%} > "
              f"{TEL_OVERHEAD_FAIL:.0%}")
        # Where it goes: the chunking alone (every-step chunks, no tap)
        # and the tap alone (one chunk, heartbeats at its end), timed in
        # turns with the run without; then device ops and busy share.
        tap = obs.instrument_step(step, sink, every=TEL_EVERY)

        def chunked():
            s_ = state0
            for t_ in range(0, TEL_STEPS, TEL_EVERY):
                s_, _ = engine.rollout_at(step, s_, TEL_EVERY, t_)

        split = {"off": lambda: engine.rollout(step, state0, TEL_STEPS),
                 "chunks_only": chunked,
                 "tap_only": lambda: engine.rollout(tap, state0, TEL_STEPS),
                 "on": lambda: engine.rollout(
                     step, state0, TEL_STEPS, telemetry=sink,
                     telemetry_every=TEL_EVERY)}
        for fn in split.values():
            fn()
        split_s = {k: [] for k in split}
        for order in (list(split), list(split)[::-1]):
            for k in order:
                split_s[k].append(timed(split[k]))
        profiled = {"off": lambda: engine.rollout(
                        step, state0, TEL_PROFILE_STEPS),
                    "on": lambda: engine.rollout(
                        step, state0, TEL_PROFILE_STEPS, telemetry=sink,
                        telemetry_every=TEL_EVERY)}
        split_profile = {k: profile_rollout(fn, TEL_PROFILE_STEPS)
                         for k, fn in profiled.items()}
        sink.close()

        def watched(label, step_fn, state, steps, every, per_step=1, **kw):
            wdir = os.path.join(tmp, label.replace(" ", "_"))
            wsink = obs.TelemetrySink(wdir)
            with obs.Watchdog(wsink, **kw) as wd:
                counted(label, lambda: engine.rollout(
                    step_fn, state, steps, telemetry=wsink,
                    telemetry_every=every), steps, per_step)
            wsink.close()
            return wd.alerts, {e["step"]: e for e in obs.read_events(wdir)
                               if e.get("event") == "heartbeat"}

        cfg_w = swarm.Config(n=MAIN_N, steps=WATCH_STEPS)
        state_w, step_w = swarm.make(cfg_w)
        alerts, _ = watched("phase 16c nan", faults.nan_at_step(
            step_w, WATCH_NAN_AT), state_w, WATCH_STEPS, TEL_EVERY)
        nan = [a for a in alerts if a.kind == obs.ALERT_NAN]
        check(nan and nan[0].step == WATCH_NAN_AT,
              f"16c: NaN at step {WATCH_NAN_AT} raised {alerts}")
        cfg_b = swarm.Config(n=CERT_WATCH_N, steps=CERT_WATCH_STEPS,
                             certificate=True, certificate_backend="sparse",
                             certificate_warm_start=True)
        state_b, step_b = swarm.make(cfg_b)
        alerts, _ = watched("phase 16c certificate blow-up",
                            faults.residual_blowup_at_step(step_b,
                                                           CERT_WATCH_AT),
                            state_b, CERT_WATCH_STEPS, 1, per_step=2)
        blow = [a for a in alerts if a.kind == obs.ALERT_CERT_BLOWUP]
        check(blow and blow[0].step == CERT_WATCH_AT,
              f"16c: the blown-up carry raised {alerts}")
        stalled = faults.stall_at_step(step_w, STALL_AT, STALL_S)
        psink = obs.TelemetrySink(os.path.join(tmp, "stall-warm-up"))
        psink.pause()        # capture the programs before the watch
        engine.rollout(stalled, state_w, WATCH_STEPS, telemetry=psink,
                       telemetry_every=STALL_EVERY)
        psink.close()
        t0 = time.time()
        alerts, hbs = watched("phase 16c stall", stalled, state_w,
                              WATCH_STEPS, STALL_EVERY,
                              stall_timeout=STALL_TIMEOUT)
        stall = [a for a in alerts if a.kind == obs.ALERT_STALL]
        beats_w = [hbs[t]["t_wall"] for t in sorted(hbs)]
        gap = max(np.diff(beats_w))
        check(stall and stall[0].t_wall <= beats_w[-1] and gap >= STALL_S
              and len(beats_w) == WATCH_STEPS // STALL_EVERY,
              f"16c: the {STALL_S} s stall raised {alerts}, gap {gap}")
        info["16c"] = {
            "heartbeats": len(beats), "every": TEL_EVERY,
            "off_s": walls["off"], "on_s": walls["on"],
            "overhead": overhead, "budget": TEL_OVERHEAD_BUDGET,
            "met_budget": overhead <= TEL_OVERHEAD_BUDGET,
            "split_s": split_s,
            "split_vs_off": {k: sum(v) / sum(split_s["off"]) - 1.0
                             for k, v in split_s.items()},
            "profile": {k: {key: p[key] for key in (
                "device_ops_per_step", "device_busy_ms_per_step",
                "device_busy_share", "wall_ms_per_step")}
                for k, p in split_profile.items()},
            "alerts": {"nan_step": nan[0].step,
                       "certificate_blowup_step": blow[0].step,
                       "stall_after_s": stall[0].t_wall - t0,
                       "stall_heartbeat_gap_s": gap}}
        print(f"phase 16c: {len(beats)} heartbeats equal to StepOutputs, "
              "the trajectory equal to the run without telemetry; overhead "
              f"{overhead:.2%} (JAX's budget {TEL_OVERHEAD_BUDGET:.0%}, "
              f"held under {TEL_OVERHEAD_FAIL:.0%}); alerts nan, "
              "certificate_blowup, stall raised; " + json.dumps(info["16c"]))
        print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

        # 16d. the checked rollout, the cost model, the profiler
        (final_k, outs_k), _ = counted(
            "phase 16d checked", lambda: debug.checked_rollout(
                step, state0, TEL_STEPS), TEL_STEPS)
        check(same_tree(final_k, final_0)
              and same_tree(tuple(outs_k), tuple(outs_0)),
              "16d: the checked run differs from the plain run")
        try:
            debug.checked_rollout(faults.inf_at_step(step, CHECKED_INF_AT),
                                  state0, TEL_STEPS)
            check(False, "16d: the injected inf was not found")
        except debug.NonFiniteError as e:
            check(e.step == CHECKED_INF_AT and e.field == "state.x",
                  f"16d: the inf located at {e.step} {e.field}")
            located = str(e)
        _, step_m = swarm.make(cfg)
        model = obs.CostModel()
        label = f"n{MAIN_N}-s{TEL_STEPS}"
        for rep in range(COST_REPS):
            (final_m, outs_m), _ = counted(
                f"phase 16d cost model {rep}", lambda: engine.rollout(
                    step_m, state0, TEL_STEPS, cost_model=model,
                    cost_label=label), TEL_STEPS, prepared=rep == 0)
            check(same_tree(final_m, final_0)
                  and same_tree(tuple(outs_m), tuple(outs_0)),
                  "16d: the run with a cost model differs")
        entry = model.entries[label]
        peak = entry["cost"]["peak_bytes"]
        check(entry["compiles"] == 1 and entry["executes"] == COST_REPS
              and peak, f"16d: cost model entry {entry}")
        pdir = os.path.join(tmp, "profile")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            (rc, _) = counted("phase 16d profile", lambda: cli.main(
                ["run", "swarm", "--set", f"n={MAIN_N}", "--steps",
                 str(PROFILE_STEPS), "--profile-dir", pdir]), PROFILE_STEPS)
        check(rc == 0, f"16d: run --profile-dir exited {rc}")
        with open(os.path.join(pdir, profiling.TRACE_NAME)) as fh:
            trace = fh.read()
        lacks = [n for n in ("consensus", "gating", "filter", "integrate")
                 if not re.search(r'"name":\s*"%s"' % n, trace)]
        if not re.search(r'"name":\s*"[^"]*knn_fused', trace):
            lacks.append("knn_fused")
        check(not lacks, f"16d: the trace lacks {lacks}")
        info["16d"] = {
            "checked": "clean", "located": located,
            "cost_model": {"label": label, "peak_bytes": peak,
                           "peak_bytes_per_agent": peak / MAIN_N,
                           "argument_bytes": entry["cost"]["argument_bytes"],
                           "output_bytes": entry["cost"]["output_bytes"],
                           "capture_s": entry["compile_s"],
                           "execute_ewma_s": entry["execute_ewma_s"],
                           "drift_recent": entry["drift_recent"],
                           "warm_drift_median":
                               model.drift_summary()[label]},
            "trace_bytes": len(trace)}
        print("phase 16d: checked_rollout clean and the inf located ("
              f"{located}); the cost-model runs bit-identical; the trace "
              "holds the consensus/gating/filter/integrate spans and "
              "knn_fused; " + json.dumps(info["16d"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    info["wall_s"] = time.perf_counter() - t16
    print(f"phase 16 done in {info['wall_s']:.1f} s (script at "
          f"{time.perf_counter() - t_start:.1f} s)")
    return out


def serve_workload(swarm, rep: int, *, base: int, B: int, steps: int,
                   gating: str = "auto"):
    """bench.py:1101-1125's mixed-traffic request generator, copied (the
    script imports nothing of the JAX package, and bench.py does): B
    requests of mixed sizes (n, 3n/4, n/2, 3n/8: two buckets of the
    power-of-two ladder), mixed horizons and fresh per-request radius and
    gain every rep; each records its trajectory, which the checks
    compare."""
    sizes = [base, (3 * base) // 4] * (B // 4) + \
            [base // 2, (3 * base) // 8] * (B // 4)
    sizes += [base] * (B - len(sizes))
    return [swarm.Config(
        n=sizes[i], steps=max(steps - 7 * (i % 4), 1), seed=i,
        gating=gating, record_trajectory=True,
        safety_distance=0.4 + 0.003 * ((rep * B + i) % 5),
        consensus_gain=1.0 + 0.01 * ((rep * B + i) % 16))
        for i in range(B)]


def radius_launches(knn, swarm) -> dict:
    """Phase 17a: the radius array. Each member-batched launch with one
    radius per member held ``torch.equal`` to B single launches at each
    member's radius and to the batched plain version; the launch with
    every radius equal held to the scalar launch; each timed (median and
    device time) beside the scalar launch of the same shape and its
    bound (B single launches' work)."""
    import torch

    out = {}
    for label, name, n, B, k, radii in (
            ("fused B=16 N=256", "knn_fused", 256, 16, K,
             [0.4 + 0.003 * (i % 5) for i in range(14)] + [0.0, 1.0]),
            ("fused B=8 N=4096", "knn_fused", MAIN_N, 8, K,
             [0.4 + 0.003 * (i % 5) for i in range(8)]),
            ("stream B=8 N=4096", "knn_stream", MAIN_N, 8, K,
             [0.4 + 0.003 * (i % 5) for i in range(8)]),
            ("stream B=4 N=1000", "knn_stream", 1000, 4, K,
             [0.4, 0.403, 0.0, 1.0]),
            ("fused k=16 B=4 N=4096", "knn_fused", MAIN_N, 4, CERT_K,
             [0.5707, 0.5607, 0.5807, 0.5707])):
        fn = getattr(knn, name)
        plain = (knn.knn_neighbors_plain if name == "knn_fused"
                 else knn.knn_neighbors_blocked_plain)
        x = member_inputs(swarm, n, B, seed0=17)
        r = torch.tensor(radii, dtype=torch.float32, device="cuda")
        got = fn(x, r, k)
        want = plain(x, r, k)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            check(torch.equal(a, b), f"17a {label}: radius array differs "
                  "from the batched plain version")
        for b, rb in enumerate(radii):
            for a, s in zip(got, fn(x[b].contiguous(), rb, k)):
                check(torch.equal(a[b], s), f"17a {label}: member {b} "
                      f"differs from its single launch at r={rb}")
        same = fn(x, torch.full((B,), 0.403, device="cuda"), k)
        for a, s in zip(same, fn(x, 0.403, k)):
            check(torch.equal(a, s), f"17a {label}: equal radii differ "
                  "from the scalar launch")
        timed_r = time_call(lambda: fn(x, r, k))
        timed_r.pop("device_op_names")
        timed_s = time_call(lambda: fn(x, radii[0], k))
        timed_s.pop("device_op_names")
        bound, by = member_bound(x, k, got[3])
        out[label] = {
            "name": name, "n": n, "members": B, "k": k, "radii": radii,
            "ms": timed_r["ms"], "device_ms": timed_r["kernel_device_ms"],
            "scalar_ms": timed_s["ms"],
            "scalar_device_ms": timed_s["kernel_device_ms"],
            "plain_ms": cuda_ms(lambda: plain(x, r, k), reps=10,
                                warmup=2)[0],
            "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0,
            "in_radius_candidates": int(got[3].sum())}
        print(f"phase 17a: {label} radius array equal to {B} single "
              f"launches and the plain version; median "
              f"{timed_r['ms']:.4f} ms (device "
              f"{timed_r['kernel_device_ms']}) vs scalar "
              f"{timed_s['ms']:.4f} ms (device "
              f"{timed_s['kernel_device_ms']}), bound {bound:.4f} ms "
              f"({by})")
    return out


def phase17(engine, knn, swarm, t_start) -> dict:
    """Phase 17: the traced-config serving path (module docstring).
    Returns each driven run's launches, the radius-array rows and the
    measurements."""
    import numpy as np
    import torch

    from cbf_tpu_torch.parallel import ensemble as ens
    from cbf_tpu_torch.serve import buckets, pack

    out = {"runs": {}, "info": {}}
    info = out["info"]
    t17 = time.perf_counter()
    out["radius"] = radius_launches(knn, swarm)
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    def batches(cfgs, max_batch, device="cuda"):
        """The workload's bucket batches, in bucket order: (key, real
        requests, their traced dicts, stacked inputs)."""
        groups = {}
        for cfg in cfgs:
            key, traced = buckets.bucket_key(cfg)
            groups.setdefault(key, []).append((cfg, traced))
        out_b = []
        for key, members in groups.items():
            for i in range(0, len(members), max_batch):
                part = members[i:i + max_batch]
                reqs = [c for c, _ in part]
                trs = [t for _, t in part]
                out_b.append((key, reqs, trs, pack.stack_batch(
                    key, reqs, trs, max_batch, device=device)))
        return out_b

    def same_outs(a, b):
        return all(same_tree(x, y) for x, y in zip(a, b))

    def drain(label, cfgs, max_batch):
        """17b: the workload through one lockstep_traced_rollout program
        per bucket, compiled (first call captures) and held to the eager
        loop of the same vmapped step; each trimmed request held to its
        own single-request run; then timed against those runs one after
        another, in turns."""
        bs = batches(cfgs, max_batch)
        res = {"buckets": [b[0].label() for b in bs]}
        runs = [ens.lockstep_traced_rollout(key.static_cfg, key.horizon,
                                            donate_states=False)
                for key, _, _, _ in bs]
        torch.cuda.synchronize()
        zero_counts(engine, knn)
        t0 = time.perf_counter()
        results = [run(*inputs) for run, (_, _, _, inputs) in zip(runs, bs)]
        torch.cuda.synchronize()
        res["first_call_s"] = time.perf_counter() - t0
        launches, counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
        steps_run = sum(key.horizon for key, _, _, _ in bs)
        want = dict.fromkeys(knn.LAUNCHES, 0)
        want["knn_fused"] = want["knn_fused_members"] = \
            want["knn_fused_radii"] = steps_run + counts["redo_steps"]
        check(launches == want, f"{label}: launches {launches}, want "
              f"{want}")
        check(counts["captures"] == len(bs), f"{label}: {counts}")
        out["runs"][label] = {"launches": launches}
        res["counts"] = counts
        for (key, reqs, trs, inputs), (fin, outs) in zip(bs, results):
            program = ens._traced_program(key.static_cfg, None,
                                          torch.device("cuda"))
            lanes = ens._lanes(inputs[0], inputs[1], inputs[2],
                               torch.zeros(len(inputs[2]),
                                           dtype=torch.int32))
            (efin, _), eouts = engine.eager_rollout(
                program, (inputs[0], lanes), key.horizon)
            check(same_tree(fin, efin) and same_outs(
                outs, engine._tree_map(lambda v: torch.swapaxes(v, 0, 1),
                                       eouts)),
                  f"{label} {key.label()}: compiled != eager")
        # Each request against its own single-request run.
        singles = []
        res["requests"] = []
        for (key, reqs, trs, inputs), (fin, outs) in zip(bs, results):
            for slot, cfg in enumerate(reqs):
                state0, step = swarm.make(cfg)
                sfin, souts = engine.rollout(step, state0, cfg.steps)
                singles.append((step, state0, cfg.steps))
                tfin, touts = pack.trim_result(fin, outs, slot, cfg.n,
                                               cfg.steps)
                x_err = float(np.abs(tfin.x - sfin.x.cpu().numpy()).max())
                traj_err = float(np.abs(
                    touts.trajectory - souts.trajectory.cpu().numpy()).max())
                infeasible = int(touts.infeasible_count.sum())
                first = None
                for f in ("filter_active_count", "infeasible_count",
                          "gating_dropped_count", "max_relax_rounds"):
                    diff = np.nonzero(np.asarray(getattr(touts, f))
                                      != getattr(souts, f).cpu().numpy())[0]
                    if diff.size and (first is None
                                      or diff[0] < first[1]):
                        first = (f, int(diff[0]))
                rec = {"n": cfg.n, "steps": cfg.steps, "bucket": key.n,
                       "x_err": x_err, "trajectory_err": traj_err,
                       "infeasible": infeasible,
                       "counts_equal": first is None,
                       "first_count_difference": first}
                res["requests"].append(rec)
                print(f"  {label} n={cfg.n} x{cfg.steps} in bucket "
                      f"{key.n}: trajectory err {traj_err:.3g}, final x "
                      f"err {x_err:.3g}, infeasible {infeasible}, counts "
                      + ("equal" if first is None else
                         f"differ first at step {first[1]} ({first[0]})"))
                check(traj_err <= SERVE_X_ATOL and x_err <= SERVE_X_ATOL,
                      f"{label} n={cfg.n}: trajectory off its own run by "
                      f"{traj_err}")
                check(infeasible == 0, f"{label} n={cfg.n}: infeasible")
        # Timed in turns: sequential, batched, batched, sequential.
        inputs_all = [(run, b[3]) for run, b in zip(runs, bs)]

        def batched():
            for run, inputs in inputs_all:
                run(*inputs)

        def sequential():
            for step, state0, n_steps in singles:
                engine.rollout(step, state0, n_steps)

        walls = {"sequential": [], "batched": []}
        for leg in ("sequential", "batched", "batched", "sequential"):
            walls[leg].append(timed(batched if leg == "batched"
                                    else sequential))
        qp = sum(c.n * c.steps for c in cfgs)
        res["walls"] = walls
        res["requests_per_s"] = {leg: len(cfgs) / min(w)
                                 for leg, w in walls.items()}
        res["agent_qp_steps_per_s"] = {leg: qp / min(w)
                                       for leg, w in walls.items()}
        res["batched_over_sequential"] = (min(walls["sequential"])
                                          / min(walls["batched"]))
        print(f"phase 17b {label}: {len(cfgs)} requests in {len(bs)} "
              f"programs {res['buckets']}; first call "
              f"{res['first_call_s']:.2f} s; best of two: batched "
              f"{res['requests_per_s']['batched']:.2f} req/s "
              f"{res['agent_qp_steps_per_s']['batched']:.4g} member "
              f"agent-QP-steps/s, sequential "
              f"{res['requests_per_s']['sequential']:.2f} req/s "
              f"{res['agent_qp_steps_per_s']['sequential']:.4g}; batched/"
              f"sequential {res['batched_over_sequential']:.3f}x (the JAX "
              f"package's gate: {SERVE_GATE}x); walls {walls}")
        return res

    info["17b full"] = drain("phase 17b full width", serve_workload(
        swarm, 0, **SERVE_FULL), SERVE_FULL_BATCH)
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")
    info["17b default"] = drain("phase 17b serve default", serve_workload(
        swarm, 0, **SERVE_DEFAULT), SERVE_DEFAULT_BATCH)
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 17c. the chunk program: lanes at clocks 0, 32, 64 and two vacant; a
    # lane that joins at a chunk boundary equals it run alone.
    B, n_b = CHUNK_B, CHUNK_BUCKET
    reqs = [swarm.Config(n=n, steps=st, seed=40 + i, gating="auto",
                         safety_distance=0.4 + 0.004 * i,
                         dt=0.033 - 0.001 * i)
            for i, (n, st) in enumerate([(256, 160), (200, 128), (256, 96),
                                         (180, 150), (230, 140),
                                         (150, 120)])]
    keyed = [buckets.bucket_key(c, sizes=(n_b,)) for c in reqs]
    key = keyed[0][0]
    run = ens.lockstep_traced_chunk(key.static_cfg, CHUNK)
    joiner = reqs[5]
    live = list(range(5))
    table = pack.seed_lane_table(key, reqs[0], B)
    for i in live:
        table = pack.join_lane(table, i, pack.padded_initial_state(reqs[i],
                                                                   key))
    phase0 = {0: 0, 1: CHUNK, 2: 2 * CHUNK, 3: 0, 4: CHUNK}

    def traced_of(lane_traced):
        return {k: torch.tensor([t[k] for t in lane_traced],
                                dtype=torch.int32 if k == "n_active"
                                else key.static_cfg.dtype, device="cuda")
                for k in lane_traced[0]}

    lane_tr = [keyed[i][1] if i in live else keyed[0][1] for i in range(B)]
    joined, alone = [], []
    torch.cuda.synchronize()
    zero_counts(engine, knn)
    for c in range(CHUNK_CALLS):
        if c == 1:    # the joiner takes vacant lane 5 at this boundary
            table = pack.join_lane(table, 5, pack.padded_initial_state(
                joiner, key))
            lane_tr[5] = keyed[5][1]
        steps = [reqs[i].steps if i in live or (i == 5 and c >= 1) else 0
                 for i in range(B)]
        t0 = [phase0.get(i, 0) + c * CHUNK if i in live
              else (c - 1) * CHUNK if i == 5 and c >= 1 else 0
              for i in range(B)]
        # Vacant lanes get other traced values every call: still one
        # program.
        for i in (6, 7):
            lane_tr[i] = dict(keyed[0][1], safety_distance=0.4 + 0.01 * c)
        table, outs = run(table, traced_of(lane_tr),
                          torch.tensor(steps, dtype=torch.int32,
                                       device="cuda"),
                          torch.tensor(t0, dtype=torch.int32, device="cuda"))
        if c >= 1:
            joined.append(pack.slice_lane_chunk(outs, 5, CHUNK))
    torch.cuda.synchronize()
    launches, counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
    check(counts["captures"] == 1, f"phase 17c: one capture for every "
          f"chunk, got {counts}")
    out["runs"]["phase 17c chunk"] = {"launches": launches}
    # Pads of every live lane parked, v zero.
    for i in live + [5]:
        n_real = reqs[i].n
        check(torch.equal(table.x[i, n_real:], torch.as_tensor(
            pack.parking_rows(n_b - n_real, key.static_cfg.dtype),
            device="cuda")) and not bool(table.v[i, n_real:].any()),
            f"phase 17c lane {i}: pads moved")
    # The joiner alone: every other lane vacant.
    solo = pack.seed_lane_table(key, joiner, B)
    solo_tr = traced_of([keyed[5][1]] * B)
    for c in range(CHUNK_CALLS - 1):
        steps = [joiner.steps if i == 5 else 0 for i in range(B)]
        t0 = [c * CHUNK if i == 5 else 0 for i in range(B)]
        solo, outs = run(solo, solo_tr,
                         torch.tensor(steps, dtype=torch.int32,
                                      device="cuda"),
                         torch.tensor(t0, dtype=torch.int32, device="cuda"))
        alone.append(pack.slice_lane_chunk(outs, 5, CHUNK))
    for a, b in zip(joined, alone):
        check(all(np.array_equal(x, y) for x, y in zip(a, b)
                  if not isinstance(x, tuple)),
              "phase 17c: the joined lane differs from it running alone")
    check(torch.equal(solo.x[5], table.x[5]),
          "phase 17c: the joined lane's state differs from it alone")
    counts = dict(engine.COUNTS)
    check(counts["captures"] == 1, f"phase 17c: {counts}")
    info["17c"] = {"counts": counts, "chunks": CHUNK_CALLS,
                   "launches": launches}
    print(f"phase 17c: chunk program B={B} bucket {n_b} chunk {CHUNK}: "
          f"{CHUNK_CALLS} chunks with lanes at clocks 0/{CHUNK}/"
          f"{2 * CHUNK} and two vacant, one capture for every call "
          f"({counts}), the joiner equal to it alone, pads parked")

    # 17d. card vs CPU on the streaming kernel's radius array.
    cfgs = [swarm.Config(n=n, steps=CROSS_SERVE_STEPS, seed=60 + i,
                         gating="streaming",
                         safety_distance=0.4 + 0.005 * i,
                         spawn_half_width_override=1.2)
            for i, n in enumerate((64, 50, 40, 64))]
    keyed = [buckets.bucket_key(c, sizes=(64,)) for c in cfgs]
    key = keyed[0][0]
    trs = [t for _, t in keyed]
    run = ens.lockstep_traced_rollout(key.static_cfg, key.horizon,
                                      donate_states=False)
    torch.cuda.synchronize()
    zero_counts(engine, knn)
    fin_c, outs_c = run(*pack.stack_batch(key, cfgs, trs, len(cfgs)))
    torch.cuda.synchronize()
    launches, counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
    want = dict.fromkeys(knn.LAUNCHES, 0)
    want["knn_stream"] = want["knn_stream_members"] = \
        want["knn_stream_radii"] = key.horizon + counts["redo_steps"]
    check(launches == want, f"phase 17d: launches {launches}, want {want}")
    out["runs"]["phase 17d streaming"] = {"launches": launches}
    fin_h, outs_h = run(*pack.stack_batch(key, cfgs, trs, len(cfgs),
                                          device="cpu"))
    x_err = float(torch.amax(torch.abs(fin_c.x.cpu() - fin_h.x)))
    md_err = float(torch.amax(torch.abs(
        outs_c.min_pairwise_distance.cpu() - outs_h.min_pairwise_distance)))
    check(x_err <= CROSS_X_ATOL and md_err <= CROSS_MD_ATOL,
          f"phase 17d: card vs CPU x {x_err}, min distance {md_err}")
    for f in ("filter_active_count", "infeasible_count",
              "gating_dropped_count", "max_relax_rounds"):
        check(torch.equal(getattr(outs_c, f).cpu(), getattr(outs_h, f)),
              f"phase 17d: {f} differs card vs CPU")
    info["17d"] = {"x_err": x_err, "md_err": md_err}
    print(f"phase 17d: B=4 bucket 64 x {key.horizon} streaming, card vs "
          f"CPU: x {x_err:.3g}, min distance {md_err:.3g}, counts equal")
    info["seconds"] = time.perf_counter() - t17
    print(f"phase 17: {info['seconds']:.1f} s")
    return out


def fault_requests(swarm, n_b: int, steps: int, gating: str = "auto"):
    """Phase 18c/18d's requests: one full batch of 8 in bucket ``n_b``
    (n from n_b down to 3 n_b / 4), each with its own seed, radius and
    gain."""
    return [swarm.Config(n=n_b - (n_b // 32) * i, steps=steps, seed=80 + i,
                         gating=gating, record_trajectory=True,
                         safety_distance=0.4 + 0.003 * (i % 5),
                         consensus_gain=1.0 + 0.01 * i)
            for i in range(8)]


def same_result(a, b) -> bool:
    """Two RequestResults' host arrays bit-equal: the final x and v and
    every StepOutputs field (``()`` fields ``()`` on both)."""
    import numpy as np

    def eq(x, y):
        if isinstance(x, tuple) or isinstance(y, tuple):
            return isinstance(x, tuple) and isinstance(y, tuple) and len(
                x) == len(y) and all(map(eq, x, y))
        return x.shape == y.shape and np.array_equal(x, y)

    return (eq(a.final_state.x, b.final_state.x)
            and eq(a.final_state.v, b.final_state.v)
            and eq(tuple(a.outputs), tuple(b.outputs)))


def direct_results(ens, pack, cfgs, bucket_of, max_batch, dev):
    """The engine's batches formed by hand — requests grouped by bucket in
    order of arrival, ``max_batch`` at a time — packed, run through
    ``lockstep_traced_rollout`` and trimmed: the results the engine must
    equal bit for bit (it adds no arithmetic)."""
    groups = {}
    for i, cfg in enumerate(cfgs):
        key, traced = bucket_of(cfg)
        groups.setdefault(key, []).append((i, cfg, traced))
    out = [None] * len(cfgs)
    for key, members in groups.items():
        run = ens.lockstep_traced_rollout(key.static_cfg, key.horizon)
        for b in range(0, len(members), max_batch):
            part = members[b:b + max_batch]
            fin, outs = run(*pack.stack_batch(
                key, [c for _, c, _ in part], [t for _, _, t in part],
                max_batch, device=dev))
            fin = pack._tree(lambda a: a.cpu().numpy(), fin)
            outs = pack._tree(lambda a: a.cpu().numpy(), outs)
            for slot, (i, cfg, _) in enumerate(part):
                out[i] = pack.trim_result(fin, outs, slot, cfg.n, cfg.steps)
    return out


def phase18(engine, knn, swarm, t_start, p17, dev="cuda") -> dict:
    """Phase 18: the serve engine's drain mode (module docstring).
    Returns each driven run's launches and the measurements."""
    import os
    import statistics

    import numpy as np
    import torch

    from cbf_tpu_torch.durable import journal as dj
    from cbf_tpu_torch.obs.trace import Tracer
    from cbf_tpu_torch.parallel import ensemble as ens
    from cbf_tpu_torch.serve import (FaultPolicy, NonFiniteResult,
                                     ServeEngine, pack)
    from cbf_tpu_torch.utils import faults

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    out = {"runs": {}, "info": {}}
    info = out["info"]
    t18 = time.perf_counter()

    # 18a. run() at full width: phase 17b's workload through the engine,
    # prewarmed; each result bit-equal to its packed batch run directly;
    # then the engine and the direct programs timed in turns.
    cfgs = serve_workload(swarm, 0, **SERVE_FULL)
    tracer = Tracer()
    eng = ServeEngine(max_batch=SERVE_FULL_BATCH, device=dev,
                      tracer=tracer)
    zero_counts(engine, knn)
    t0 = time.perf_counter()
    eng.prewarm(cfgs)
    sync()
    prewarm_s = time.perf_counter() - t0
    prewarm_captures = engine.COUNTS["captures"]
    buckets_a = eng.manifest_extra()["serve"]["buckets"]
    print(f"phase 18a: prewarm of {buckets_a} in {prewarm_s:.3f} s with "
          f"{prewarm_captures} captures: "
          + (f"all {len(buckets_a)} programs reused from phase 17b's "
             "caches (same bucket, horizon and batch)"
             if prewarm_captures == 0 else
             f"{len(buckets_a) - prewarm_captures} reused from phase 17b's "
             "caches"))
    zero_counts(engine, knn)
    results = eng.run(cfgs)
    sync()
    launches, counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
    check(counts["captures"] == 0, f"18a: run() after prewarm captured "
          f"{counts}")
    want = dict.fromkeys(knn.LAUNCHES, 0)
    n_batches = eng.stats["batches"]
    horizon_a = eng.bucket_of(cfgs[0])[0].horizon
    want["knn_fused"] = want["knn_fused_members"] = \
        want["knn_fused_radii"] = n_batches * horizon_a \
        + counts["redo_steps"]
    check(launches == want, f"18a: launches {launches}, want {want}")
    out["runs"]["phase 18a run"] = {"launches": launches}
    direct = direct_results(ens, pack, cfgs, eng.bucket_of,
                            SERVE_FULL_BATCH, dev)
    for i, (res, (fin, outs)) in enumerate(zip(results, direct)):
        check(np.array_equal(res.final_state.x, fin.x)
              and np.array_equal(res.final_state.v, fin.v)
              and all(np.array_equal(a, b) for a, b in
                      zip(res.outputs, outs) if not isinstance(a, tuple)),
              f"18a: request {i} differs from its batch run directly")
        check(int(np.sum(res.outputs.infeasible_count)) == 0,
              f"18a: request {i} infeasible")
    print(f"phase 18a: {len(results)} results np.array_equal to their "
          f"packed batches run through lockstep_traced_rollout directly; "
          f"{n_batches} batches x {horizon_a} steps, launches {launches}")

    bs = []
    for cfg in cfgs:
        key, _ = eng.bucket_of(cfg)
        if key not in [k for k, _ in bs]:
            bs.append((key, ens.lockstep_traced_rollout(key.static_cfg,
                                                        key.horizon)))

    def direct_leg():
        groups = {}
        for cfg in cfgs:
            key, traced = eng.bucket_of(cfg)
            groups.setdefault(key, []).append((cfg, traced))
        for key, run in bs:
            members = groups[key]
            for b in range(0, len(members), SERVE_FULL_BATCH):
                part = members[b:b + SERVE_FULL_BATCH]
                run(*pack.stack_batch(key, [c for c, _ in part],
                                      [t for _, t in part],
                                      SERVE_FULL_BATCH, device=dev))

    walls = {"engine": [], "direct": []}
    spans_before = 0
    for leg in ("engine", "direct", "direct", "engine"):
        if leg == "engine":
            spans_before = len(tracer.spans)
        walls[leg].append(timed(lambda: eng.run(cfgs) if leg == "engine"
                                else direct_leg()))
        if leg == "engine":
            last_spans = tracer.spans[spans_before:]
    per_phase = {}
    for s in last_spans:
        per_phase[s.name] = per_phase.get(s.name, 0.0) + s.dur_s
    rps = {leg: len(cfgs) / min(w) for leg, w in walls.items()}
    info["18a"] = {"prewarm_s": prewarm_s,
                   "prewarm_captures": prewarm_captures,
                   "buckets": buckets_a, "walls": walls,
                   "requests_per_s": rps,
                   "engine_over_direct": rps["engine"] / rps["direct"],
                   "phase_totals_s": per_phase, "batches_per_run":
                   n_batches, "launches": launches}
    print(f"phase 18a: best of two: engine {rps['engine']:.3f} req/s, "
          f"direct programs {rps['direct']:.3f} req/s "
          f"(engine/direct {rps['engine'] / rps['direct']:.4f}); walls "
          f"{walls}; one run()'s host spans (s, {n_batches} batches): "
          + ", ".join(f"{k} {per_phase.get(k, 0.0):.6f}" for k in (
              "enqueue", "queue_wait", "pack", "executable_hit", "execute",
              "unpack", "resolve")))
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 18b. queue mode at the serve default: submit all, stop; equal to
    # run()'s results; a second engine, not prewarmed, captures on the
    # scheduler thread (the process's program cache cleared first) while
    # this thread waits in result(timeout).
    cfgs = serve_workload(swarm, 0, **SERVE_DEFAULT)
    eng_b = ServeEngine(max_batch=SERVE_DEFAULT_BATCH,
                        flush_deadline_s=0.05, device=dev)
    eng_b.prewarm(cfgs)
    ref = eng_b.run(cfgs)
    sync()

    def queue_run(e):
        e.start()
        try:
            t0 = time.perf_counter()
            pend = [e.submit(c) for c in cfgs]
            res = [p.result(timeout=600) for p in pend]
            wall = time.perf_counter() - t0
        finally:
            e.stop()
        return res, wall

    zero_counts(engine, knn)
    got, wall_q = queue_run(eng_b)
    sync()
    out["runs"]["phase 18b queue"] = {"launches": dict(knn.LAUNCHES)}
    check(engine.COUNTS["captures"] == 0, f"18b: {engine.COUNTS}")
    for i, (a, b) in enumerate(zip(got, ref)):
        check(same_result(a, b), f"18b: queued request {i} differs from "
              "run()'s")
    ens._traced_program.cache_clear()
    eng_c = ServeEngine(max_batch=SERVE_DEFAULT_BATCH,
                        flush_deadline_s=0.05, device=dev)
    zero_counts(engine, knn)
    got_c, wall_c = queue_run(eng_c)
    sync()
    check(engine.COUNTS["captures"] >= 1, f"18b: the engine without "
          f"prewarm captured nothing: {engine.COUNTS}")
    for i, (a, b) in enumerate(zip(got_c, ref)):
        check(same_result(a, b), f"18b: request {i} of the engine that "
              "captured on its scheduler thread differs from run()'s")
    lat = sorted(r.latency_s for r in got)
    qw = [r.queue_wait_s for r in got]
    ex = [r.execute_s for r in got]
    p17_default = p17["info"]["17b default"]["requests_per_s"]
    rps_q = len(cfgs) / wall_q
    info["18b"] = {
        "latency_p50_s": statistics.median(lat),
        "latency_p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "queue_wait_mean_s": statistics.mean(qw),
        "execute_mean_s": statistics.mean(ex), "requests_per_s": rps_q,
        "phase17_batched_requests_per_s": p17_default["batched"],
        "phase17_sequential_requests_per_s": p17_default["sequential"],
        "over_sequential": rps_q / p17_default["sequential"],
        "scheduler_capture": {"wall_s": wall_c,
                              "captures": engine.COUNTS["captures"],
                              "compile_miss": eng_c.stats["compile_miss"]},
        "stats": {k: eng_b.stats[k] for k in ("requests", "batches",
                                               "pad_slots")}}
    print(f"phase 18b: queue mode, {len(cfgs)} requests, max_batch "
          f"{SERVE_DEFAULT_BATCH}: equal to run()'s; latency p50 "
          f"{info['18b']['latency_p50_s']:.4f} s p99 "
          f"{info['18b']['latency_p99_s']:.4f} s, queue wait mean "
          f"{info['18b']['queue_wait_mean_s']:.4f} s vs execute mean "
          f"{info['18b']['execute_mean_s']:.4f} s; {rps_q:.3f} req/s "
          f"(phase 17b batched {p17_default['batched']:.3f}, sequential "
          f"{p17_default['sequential']:.3f}: {rps_q / p17_default['sequential']:.3f}x"
          f" beside the JAX package's {SERVE_GATE}x gate); without "
          f"prewarm: {engine.COUNTS['captures']} captures on the scheduler "
          f"thread, wall {wall_c:.3f} s, equal to run()'s")
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 18c. the fault ladder in bucket FAULT_BUCKET.
    cfgs = fault_requests(swarm, FAULT_BUCKET, FAULT_STEPS)
    policy_kw = dict(max_batch=8, bucket_sizes=(FAULT_BUCKET,),
                     flush_deadline_s=0.05, device=dev,
                     tracer=Tracer(enabled=False))
    eng_f = ServeEngine(**policy_kw)
    eng_f.prewarm(cfgs)
    zero_counts(engine, knn)
    clean = eng_f.run(cfgs)
    sync()
    out["runs"]["phase 18c clean"] = {"launches": dict(knn.LAUNCHES)}
    poisoned = list(cfgs)
    poisoned[3] = faults.poison_config(cfgs[3])
    e = ServeEngine(**policy_kw)
    e._execs = eng_f._execs
    e.start()
    try:
        pend = [e.submit(c) for c in poisoned]
        outcome = []
        for i, p in enumerate(pend):
            try:
                outcome.append(p.result(timeout=600))
            except NonFiniteResult:
                outcome.append("NonFiniteResult")
    finally:
        e.stop()
    check(outcome[3] == "NonFiniteResult", f"18c: the poisoned request "
          f"resolved {outcome[3]!r}")
    check(e.stats["batches"] == 1 and e.stats["nonfinite"] == 1
          and e.stats["requests"] == 7, f"18c: poison stats {e.stats}")
    for i in range(8):
        if i != 3:
            check(same_result(outcome[i], clean[i]), f"18c: mate {i} of "
                  "the poisoned lane differs from the clean batch")
    e = ServeEngine(**policy_kw)
    e._execs = eng_f._execs
    e.fault_hook = faults.serve_executor_fault(times=1)
    retried = e.run(cfgs)
    check(e.stats["retries"] == 1 and all(
        same_result(a, b) for a, b in zip(retried, clean)),
        f"18c: transient retry {e.stats}")
    e = ServeEngine(**policy_kw)
    e._execs = eng_f._execs
    bad = cfgs[5].seed

    def permanent(key, entries, attempt, phase):
        if phase == "execute" and any(x[1].seed == bad for x in entries):
            raise ValueError("request breaks the batch")

    e.fault_hook = permanent
    try:
        e.run(cfgs)
        check(False, "18c: the permanent fault did not surface")
    except ValueError:
        pass
    check(e.stats["bisects"] == 3 and e.stats["failed"] == 1
          and e.stats["requests"] == 7, f"18c: bisect stats {e.stats}")
    e = ServeEngine(**{**policy_kw, "fault_policy": FaultPolicy(
        max_retries=0)})
    e.fault_hook = faults.serve_compile_failure(times=1)
    captures0 = engine.COUNTS["captures"]
    try:
        e.run(cfgs[:1])
        check(False, "18c: the capture failure did not surface")
    except faults.InjectedExecutorFault:
        pass
    check(engine.COUNTS["captures"] == captures0 and e._bucket_breakers
          and e.stats["bisects"] == 0, f"18c: capture failure {e.stats}")
    e = ServeEngine(**{**policy_kw, "horizon_quantum": RESCUE_QUANTUM,
                       "fault_policy": FaultPolicy(rta_fallback=True)})
    rescued = e.run([faults.poison_config(swarm.Config(**RESCUE_FIELDS))])[0]
    fin_ok = bool(np.all(np.isfinite(rescued.final_state.x)))
    md = float(np.min(rescued.outputs.min_pairwise_distance))
    card_outcome = {"resolved": "result", "rta_engaged": rescued.rta_engaged,
                    "finite": fin_ok, "bucket": rescued.bucket,
                    "min_distance": round(md, 6)}
    check(e.stats["rta_rescued"] == 1 and rescued.rta_engaged and fin_ok,
          f"18c: rta rescue {card_outcome}")
    info["18c"] = {"rescue": {**card_outcome, "min_distance": md},
                   "jax_cpu": RESCUE_JAX_CPU}
    check({k: v for k, v in card_outcome.items() if k != "min_distance"}
          == {k: v for k, v in RESCUE_JAX_CPU.items()
              if k != "min_distance"},
          f"18c: the rescue's outcome {card_outcome} differs from the JAX "
          f"package's {RESCUE_JAX_CPU}")
    print(f"phase 18c: bucket {FAULT_BUCKET} x {FAULT_STEPS}: the poisoned "
          f"request fails alone (NonFiniteResult, 1 batch, the 7 mates "
          f"np.array_equal to the clean batch); one transient fault "
          f"retried once, equal to the clean run; a permanent fault "
          f"bisected 3 times to its request; a capture failure charged "
          f"the bucket breaker with no capture; rta_fallback on "
          f"{RESCUE_FIELDS}: card {card_outcome}; the JAX package on the "
          f"CPU: {RESCUE_JAX_CPU}")
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 18d. the journal across a kill.
    root = os.path.abspath(os.path.dirname(__file__) or ".")
    work = os.path.join(root, "chiprun_out", "phase18d")
    os.makedirs(work, exist_ok=True)
    journal = os.path.join(work, "j.jsonl")
    for stale in [journal, journal + ".resilience",
                  *dj.journal_segments(journal)]:
        if os.path.exists(stale):
            os.remove(stale)
    cfgs = fault_requests(swarm, FAULT_BUCKET, FAULT_STEPS) + \
        fault_requests(swarm, FAULT_BUCKET, FAULT_STEPS - 8)
    reqs = os.path.join(work, "requests.json")
    with open(reqs, "w") as fh:
        json.dump([{"steps": c.steps, "seed": c.seed, "overrides": {
            "n": c.n, "gating": c.gating, "record_trajectory": True,
            "safety_distance": c.safety_distance,
            "consensus_gain": c.consensus_gain}} for c in cfgs], fh)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m", "cbf_tpu_torch", "serve", "--device", dev,
           "--max-batch", "8", "--journal", journal]

    def resolved_landed(_elapsed):
        try:
            with open(journal) as fh:
                return '"resolved"' in fh.read()
        except OSError:
            return False

    rc, killed, t_first = faults.run_process_until(
        cli + [reqs], resolved_landed, poll_s=0.005, timeout_s=300.0,
        env=env)
    t_kill = time.perf_counter()
    check(killed and rc is not None, f"18d: the first child was not "
          f"killed (rc {rc})")
    before = dj.replay_journal(journal)
    acked = set(before.submitted)
    check(len(acked) == len(cfgs) and before.unresolved, f"18d: after the "
          f"kill {len(acked)} acknowledged, {len(before.unresolved)} "
          "unresolved")
    tel = os.path.join(work, "telemetry")
    proc = subprocess.run(cli + ["--recover", "--telemetry-dir", tel],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    t_done = time.perf_counter()
    check(proc.returncode == 0, f"18d: recover exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    after = dj.replay_journal(journal)
    check(after.unresolved == [] and set(after.resolved) == acked
          and all(after.resolved_counts.get(r, 0) == 1 for r in acked),
          f"18d: fold after recovery: unresolved {after.unresolved}, "
          f"counts {after.resolved_counts}")
    check(sorted(rec["recovered_request_ids"]) == sorted(
        r for r, _ in before.unresolved), "18d: recovered ids")
    # Each recovered result against an uninterrupted run in this process.
    from cbf_tpu_torch import obs

    by_id = {e_["request_id"]: e_ for e_ in obs.read_events(
        rec["telemetry"]) if e_["event"] == "request"}
    uninterrupted = ServeEngine(max_batch=8, device=dev).run(
        cfgs, request_ids=[f"r{i}" for i in range(len(cfgs))])
    for r in uninterrupted:
        if r.request_id in by_id:
            ev = by_id[r.request_id]
            check(ev["min_pairwise_distance"] == float(np.min(
                r.outputs.min_pairwise_distance)) and ev[
                    "infeasible_count"] == int(np.sum(
                        r.outputs.infeasible_count)),
                  f"18d: recovered {r.request_id} differs from the "
                  "uninterrupted run")
    spans = [e_ for e_ in obs.read_events(rec["telemetry"])
             if e_["event"] == "serve.span"]
    capture_s = sum(e_["dur_s"] for e_ in spans if e_["name"] == "compile")
    execute_s = sum(e_["dur_s"] for e_ in spans if e_["name"] == "execute")
    child_s = t_done - t_kill
    init_s = child_s - rec["wall_s"]
    first_s = init_s + min(ev["latency_s"] for ev in by_id.values())
    info["18d"] = {
        "requests": len(cfgs),
        "resolved_before_kill": len(before.resolved),
        "recovered": len(rec["recovered_request_ids"]),
        "kill_to_first_result_s": first_s, "kill_to_exit_s": child_s,
        "import_and_cuda_init_s": init_s, "capture_s": capture_s,
        "execute_s": execute_s, "run_wall_s": rec["wall_s"],
        "first_child_s": t_first}
    print(f"phase 18d: killed the serve child at {t_first:.2f} s with "
          f"{len(before.resolved)} of {len(cfgs)} resolved; the recover "
          f"child re-ran {len(rec['recovered_request_ids'])} under their "
          f"ids: every acknowledged request resolved once, none lost, "
          f"each equal to an uninterrupted run; kill -> first recovered "
          f"result {first_s:.2f} s (import and CUDA init {init_s:.2f} s, "
          f"capture {capture_s:.3f} s, execute {execute_s:.3f} s in all; "
          f"run wall {rec['wall_s']:.3f} s; kill -> exit {child_s:.2f} s)")
    info["seconds"] = time.perf_counter() - t18
    print(f"phase 18: {info['seconds']:.1f} s")
    return out


def parse_prom(text: str) -> dict:
    """tests/test_obs_resource.py's minimal Prometheus text parser,
    copied: {sample key: value}; raises on a malformed line, a re-typed
    family or a duplicate sample."""
    import re

    sample = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
        r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*='
        r'"[^"]*")*\})?'
        r" (NaN|[-+]?[0-9.eE+-]+)$")
    typed = re.compile(
        r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (counter|gauge|summary)$")
    families, samples = set(), {}
    for line in text.splitlines():
        if not line.strip():
            continue
        mt = typed.match(line)
        if mt:
            check(mt.group(1) not in families, f"prom: re-typed {line!r}")
            families.add(mt.group(1))
            continue
        ms = sample.match(line)
        check(ms is not None, f"prom: malformed line {line!r}")
        key = line.rsplit(" ", 1)[0]
        check(key not in samples, f"prom: duplicate sample {key!r}")
        samples[key] = float("nan") if ms.group(4) == "NaN" \
            else float(ms.group(4))
    return samples


def max_gap(a, b) -> tuple[float, bool]:
    """(largest |a - b| over the final x, v and every float StepOutputs
    field; every integer field equal) of two RequestResults."""
    import numpy as np

    gap, counts_equal = 0.0, True
    for x, y in [(a.final_state.x, b.final_state.x),
                 (a.final_state.v, b.final_state.v),
                 *zip(a.outputs, b.outputs)]:
        if isinstance(x, tuple):
            continue
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype.kind == "f":
            gap = max(gap, float(np.max(np.abs(x.astype(np.float64)
                                               - y.astype(np.float64)))))
        else:
            counts_equal = counts_equal and np.array_equal(x, y)
    return gap, counts_equal


def ledger_line(lanes: dict) -> str:
    return (f"occupancy {lanes['occupancy_pct']}%, bubble "
            f"{lanes['bubble_pct']}%, dispatch {lanes['dispatch_pct']}% of "
            f"lane-time over {lanes['chunks']} chunks, identity "
            f"{lanes['identity_ok']}")


def phase19(engine, knn, swarm, t_start, dev="cuda") -> dict:
    """Phase 19: the serve engine's continuous scheduler (module
    docstring). Returns each driven run's launches and the measurements."""
    import contextlib
    import dataclasses
    import io
    import os
    import shutil
    import statistics
    import threading

    import numpy as np
    import torch

    from cbf_tpu_torch import obs
    from cbf_tpu_torch.__main__ import main as cli
    from cbf_tpu_torch.serve import (DeadlineExceeded, LoadSpec,
                                     ServeEngine, build_schedule,
                                     run_loadgen)

    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fused_want(chunks: int, chunk: int, redo_steps: int) -> dict:
        want = dict.fromkeys(knn.LAUNCHES, 0)
        if cuda:
            want["knn_fused"] = want["knn_fused_members"] = \
                want["knn_fused_radii"] = chunks * chunk + redo_steps
        return want

    out = {"runs": {}, "info": {}}
    info = out["info"]
    t19 = time.perf_counter()

    # 19a. join and partials at full width.
    cfgs = serve_workload(swarm, 0, **CONT_FULL, gating="pallas")
    partials, plock = [], threading.Lock()

    def hook(rid, done, part):
        with plock:
            partials.append((rid, done, part))

    eng = ServeEngine(max_batch=CONT_FULL_BATCH, continuous=True,
                      chunk_steps=CONT_FULL_CHUNK, device=dev,
                      lane_ledger=True)
    eng.partial_hook = hook
    zero_counts(engine, knn)
    t0 = time.perf_counter()
    eng.prewarm(cfgs)
    sync()
    prewarm_s = time.perf_counter() - t0
    prewarm_captures = engine.COUNTS["captures"]
    chunk_buckets = eng.manifest_extra()["serve"]["chunk_buckets"]
    check(len(chunk_buckets) == 2 and not eng._execs,
          f"19a: prewarm made chunk programs {chunk_buckets} and drain "
          f"programs {list(eng._execs)}")
    check(not cuda or prewarm_captures == len(chunk_buckets),
          f"19a: prewarm captured {prewarm_captures} programs for "
          f"{chunk_buckets}")
    print(f"phase 19a: prewarm of the chunk programs {chunk_buckets} in "
          f"{prewarm_s:.3f} s with {prewarm_captures} captures (one per "
          "static config)")
    req = dataclasses.replace(cfgs[0], steps=CONT_FULL["steps"])
    long_cfg = dataclasses.replace(cfgs[1], steps=CONT_LONG_STEPS,
                                   seed=101)
    check(eng.bucket_of(req)[0].static_cfg
          == eng.bucket_of(long_cfg)[0].static_cfg,
          "19a: the long runner is not of the request's lane table")
    zero_counts(engine, knn)
    eng.start()
    try:
        solo = eng.submit(req).result(timeout=600)
        p_long = eng.submit(long_cfg)
        t_wait = time.perf_counter()
        while not any(r == p_long.request_id for r, _, _ in list(partials)):
            check(time.perf_counter() - t_wait < 120, "19a: the long "
                  "runner streamed no partial")
            time.sleep(0.001)
        p_twin = eng.submit(req)
        twin = p_twin.result(timeout=600)
        long_in_flight = not p_long.done()
        long_res = p_long.result(timeout=600)
    finally:
        eng.stop()
    sync()
    launches, counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
    out["runs"]["phase 19a"] = {"launches": launches}
    check(not cuda or counts["captures"] == 0,
          f"19a: traffic captured {counts}")
    want = fused_want(eng.stats["chunks_executed"], CONT_FULL_CHUNK,
                      counts["redo_steps"])
    check(launches == want, f"19a: launches {launches}, want {want}")
    check(long_in_flight and long_res.steps == CONT_LONG_STEPS,
          "19a: the long runner was not in flight when the twin resolved")
    check(same_result(twin, solo), "19a: the request that joined the long "
          "runner's table differs from its solo run")
    with plock:
        mine = [(d, part) for r, d, part in partials
                if r == p_twin.request_id]
    steps_seq = [d for d, _ in mine]
    want_seq = list(range(CONT_FULL_CHUNK, req.steps + 1, CONT_FULL_CHUNK))
    check(steps_seq == want_seq, f"19a: the twin's partials at "
          f"{steps_seq}, want {want_seq}")
    for f, (field, leaf) in enumerate(zip(twin.outputs._fields,
                                          twin.outputs)):
        if isinstance(leaf, tuple):
            continue
        stitched = np.concatenate([np.asarray(part[f]) for _, part in mine])
        check(np.array_equal(stitched, leaf), f"19a: stitched partials of "
              f"{field} differ from the resolved outputs")
    check(int(np.sum(twin.outputs.infeasible_count)) == 0
          and float(np.min(twin.outputs.min_pairwise_distance)) >= FLOOR,
          "19a: the request is infeasible or below the floor")
    drain = ServeEngine(max_batch=CONT_FULL_BATCH, device=dev).run([req])[0]
    sync()
    gap, counts_equal = max_gap(twin, drain)
    check(gap <= SERVE_X_ATOL and counts_equal, f"19a: continuous vs drain "
          f"gap {gap}, counts equal {counts_equal}")
    recs = eng.lanes.records()
    walls = {}
    for rec in recs:
        walls.setdefault(rec["fill"], []).append(
            (rec["wall_ns"] / 1e6, rec["execute_ns"] / 1e6))
    chunk_ms = {fill: {"n": len(v),
                       "wall_ms_median": statistics.median(w for w, _ in v),
                       "execute_ms_median": statistics.median(
                           e for _, e in v)}
                for fill, v in sorted(walls.items())}
    info["19a"] = {"prewarm_s": prewarm_s,
                   "prewarm_captures": prewarm_captures,
                   "chunk_buckets": chunk_buckets,
                   "continuous_vs_drain_bit_equal": gap == 0.0
                   and counts_equal, "continuous_vs_drain_max_gap": gap,
                   "chunk_ms_by_fill": chunk_ms,
                   "ttfp_s": twin.ttfp_s, "latency_s": twin.latency_s,
                   "long_latency_s": long_res.latency_s,
                   "stats": {k: eng.stats[k] for k in (
                       "chunks_executed", "lanes_joined", "lanes_vacated")},
                   "launches": launches}
    print(f"phase 19a: bucket {req.n} x {req.steps} steps joined a table "
          f"with a {CONT_LONG_STEPS}-step runner in flight: "
          f"np.array_equal to its solo run, partials at {steps_seq} "
          f"stitched equal to the resolved outputs; continuous vs drain "
          f"bit-equal {gap == 0.0 and counts_equal} (max gap {gap:.3e}, "
          f"counts equal {counts_equal}); chunk of {CONT_FULL_CHUNK} steps "
          f"by lanes filled: " + ", ".join(
              f"{fill}: wall {v['wall_ms_median']:.3f} ms, execute "
              f"{v['execute_ms_median']:.3f} ms (n={v['n']})"
              for fill, v in chunk_ms.items())
          + f"; twin TTFP {twin.ttfp_s} s, latency {twin.latency_s} s; "
          f"launches {launches}")
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 19b. a deadline leave at full width.
    surv_cfg = dataclasses.replace(cfgs[2], steps=CONT_FULL["steps"])
    doom_cfg = dataclasses.replace(cfgs[3], steps=CONT_DOOMED_STEPS)
    check(eng.bucket_of(surv_cfg)[0].static_cfg
          == eng.bucket_of(doom_cfg)[0].static_cfg,
          "19b: the doomed request is not of the survivor's lane table")
    zero_counts(engine, knn)
    eng.start()
    try:
        s_solo = eng.submit(surv_cfg).result(timeout=600)
        p_surv = eng.submit(surv_cfg)
        p_doom = eng.submit(doom_cfg, deadline_s=CONT_DEADLINE_S)
        t_wait = time.perf_counter()
        while not any(r == p_doom.request_id for r, _, _ in list(partials)):
            check(time.perf_counter() - t_wait < 120, "19b: the doomed "
                  "request streamed no partial")
            time.sleep(0.001)
        survivor = p_surv.result(timeout=600)
        try:
            p_doom.result(timeout=600)
            doom_err = None
        except DeadlineExceeded as e:
            doom_err = str(e)
    finally:
        eng.stop()
    sync()
    out["runs"]["phase 19b"] = {"launches": dict(knn.LAUNCHES)}
    check(doom_err is not None and "mid-flight" in doom_err,
          f"19b: the doomed request resolved {doom_err!r}")
    check(same_result(survivor, s_solo), "19b: the survivor differs from "
          "its solo run")
    doom_steps = max(d for r, d, _ in partials if r == p_doom.request_id)
    info["19b"] = {"doomed_error": doom_err, "doomed_steps_done":
                   doom_steps}
    print(f"phase 19b: the doomed request ({CONT_DOOMED_STEPS} steps, "
          f"deadline {CONT_DEADLINE_S} s) left mid-flight after "
          f"{doom_steps} steps ({doom_err}); its batch-mate "
          f"np.array_equal to its solo run")
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 19c. seeded open-loop traffic at the serve default, drain against
    # continuous in turns.
    class Events:
        """The engines' telemetry: every request's own min distance and
        infeasible count (the report aggregates them)."""
        registry = None

        def __init__(self):
            self.requests = {}

        def event(self, etype, payload):
            if etype == "request":
                self.requests[payload["request_id"]] = payload

    spec = LoadSpec(**CONT_LOAD)
    sched = [cfg for _, cfg in build_schedule(spec)]
    events = Events()
    engines = {
        "drain": ServeEngine(max_batch=CONT_LOAD_BATCH, device=dev,
                             telemetry=events),
        "continuous": ServeEngine(max_batch=CONT_LOAD_BATCH,
                                  continuous=True,
                                  chunk_steps=CONT_LOAD_CHUNK, device=dev,
                                  telemetry=events, lane_ledger=True)}
    prewarm = {}
    for name, e in engines.items():
        zero_counts(engine, knn)
        prewarm[name] = {"s": e.prewarm(sched),
                         "captures": engine.COUNTS["captures"]}
    sync()
    zero_counts(engine, knn)
    legs = []
    for leg, name in enumerate(("drain", "continuous", "continuous",
                                "drain")):
        prefix = f"{name}{leg}-"
        rep = run_loadgen(engines[name], spec, request_id_prefix=prefix)
        legs.append((name, rep))
        check(rep["completed"] == rep["requests"] > 0 and rep["errors"] == 0,
              f"19c {name}: {rep['completed']} of {rep['requests']} "
              f"completed, errors {rep['errors_by_type']}")
        for i in range(rep["requests"]):
            ev = events.requests[f"{prefix}{i}"]
            md, ref = ev["min_pairwise_distance"], \
                CONT_LOAD_REFERENCE_DIPS.get(i)
            check(ev["infeasible_count"] == 0 and (
                md >= FLOOR if ref is None
                else abs(md - ref) <= CROSS_MD_ATOL),
                  f"19c {name}: request {i} min distance {md} (reference "
                  f"dip {ref}), infeasible {ev['infeasible_count']}")
        if name == "continuous":
            check(rep["lanes"] is not None and rep["lanes"]["identity_ok"],
                  f"19c: the ledger's identity fails: {rep['lanes']}")
            check(rep["ttfp_p50_s"] is not None, "19c: no TTFP")
        else:
            check(rep["ttfp_p50_s"] is None, "19c: TTFP in drain mode")
    sync()
    out["runs"]["phase 19c"] = {"launches": dict(knn.LAUNCHES)}
    keys = ("achieved_rps", "requests", "latency_p50_s", "latency_p99_s",
            "queue_wait_p50_s", "queue_wait_p99_s", "execute_p50_s",
            "execute_p99_s", "ttfp_p50_s", "ttfp_p99_s", "batch_fill_mean",
            "min_pairwise_distance", "lanes")
    info["19c"] = {"spec": dict(CONT_LOAD), "prewarm": prewarm,
                   "buckets": {n: e.manifest_extra()["serve"][
                       "chunk_buckets" if e.continuous else "buckets"]
                       for n, e in engines.items()},
                   "legs": [{"engine": n, **{k: r[k] for k in keys}}
                            for n, r in legs]}
    for name, rep in legs:
        print(f"phase 19c {name}: {rep['requests']} requests offered at "
              f"{spec.rps} req/s, achieved {rep['achieved_rps']} req/s; "
              f"latency p50 {rep['latency_p50_s']} s p99 "
              f"{rep['latency_p99_s']} s; queue wait p50 "
              f"{rep['queue_wait_p50_s']} p99 {rep['queue_wait_p99_s']} s "
              f"against execute p50 {rep['execute_p50_s']} p99 "
              f"{rep['execute_p99_s']} s; TTFP p50 {rep['ttfp_p50_s']} p99 "
              f"{rep['ttfp_p99_s']} s; min distance "
              f"{rep['min_pairwise_distance']} (requests "
              f"{sorted(CONT_LOAD_REFERENCE_DIPS)} held to the reference's "
              "dips, the rest above the floor), 0 infeasible"
              + (f"; ledger {ledger_line(rep['lanes'])}"
                 if rep["lanes"] else ""))
    print(f"phase 19c: prewarm {prewarm}; launches {dict(knn.LAUNCHES)}")
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 19d. the loadgen CLI and the surfaces it feeds.
    root = os.path.abspath(os.path.dirname(__file__) or ".")
    work = os.path.join(root, "chiprun_out", "phase19d")
    shutil.rmtree(work, ignore_errors=True)
    mdir, tdir = os.path.join(work, "metrics"), os.path.join(work, "tel")
    timeline = os.path.join(work, "timeline.json")

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        return rc, buf.getvalue()

    zero_counts(engine, knn)
    rc, text = run_cli(["loadgen", "--device", dev, *CONT_CLI,
                        "--metrics-dir", mdir, "--telemetry-dir", tdir])
    sync()
    out["runs"]["phase 19d"] = {"launches": dict(knn.LAUNCHES)}
    check(rc == 0, f"19d: loadgen exited {rc}")
    record = json.loads(text.strip().splitlines()[-1])
    check(record["errors"] == 0 and record["completed"] == record["requests"]
          and record["ttfp_p50_s"] is not None and record["lanes"]
          ["identity_ok"], f"19d: the record {record}")
    buckets_d = sorted(record["by_bucket"])
    rc_l, lanes_text = run_cli(["obs", "lanes", mdir])
    rc_t, top_text = run_cli(["obs", "top", mdir])
    check(rc_l == 0 and rc_t == 0, f"19d: obs lanes {rc_l}, obs top {rc_t}")
    for b in buckets_d:
        check(any(line.startswith(b) for line in lanes_text.splitlines()),
              f"19d: obs lanes has no row for {b}")
        check(b in top_text, f"19d: obs top shows no {b}")
    rc_x, x_text = run_cli(["obs", "lanes", tdir, "--export-timeline",
                            timeline])
    check(rc_x == 0, f"19d: --export-timeline exited {rc_x}")
    summary = json.loads(x_text.strip().splitlines()[-1])
    used = {e["track"] for e in obs.read_events(tdir)
            if e["event"] == "serve.span" and e.get("track") is not None}
    check(summary["tracks"] == len(used) > 0 and all(
        t.rsplit("/lane", 1)[0] in buckets_d
        and int(t.rsplit("/lane", 1)[1]) < 8 for t in used),
        f"19d: timeline tracks {summary}, lanes used {sorted(used)}")
    with open(os.path.join(mdir, "metrics.prom")) as fh:
        samples = parse_prom(fh.read())
    check(samples.get("cbf_serve_lanes_chunks", 0) > 0,
          "19d: metrics.prom has no lane chunks")
    info["19d"] = {"record": {k: record[k] for k in (
        "requests", "achieved_rps", "latency_p50_s", "latency_p99_s",
        "ttfp_p50_s", "ttfp_p99_s", "lanes", "buckets")},
        "timeline": summary, "prom_samples": len(samples)}
    print(f"phase 19d: loadgen --continuous --metrics-dir: "
          f"{record['requests']} requests, TTFP p50 {record['ttfp_p50_s']} "
          f"s p99 {record['ttfp_p99_s']} s, ledger "
          f"{ledger_line(record['lanes'])}; obs lanes and obs top exit 0 "
          f"with a row per bucket {buckets_d}; the timeline has "
          f"{summary['tracks']} lane tracks ({summary['spans']} spans); "
          f"metrics.prom parses ({len(samples)} samples)")
    info["seconds"] = time.perf_counter() - t19
    print(f"phase 19: {info['seconds']:.1f} s")
    return out


def cluster_requests() -> list:
    """Phase 20c's request file: CLUSTER_REQUESTS requests at the serve
    default (n 64-128, horizons 128/256/512, gating "pallas"), two in
    three of them in one hot bucket (n 65-128 x 512 steps), drawn from
    CLUSTER_SEED."""
    import numpy as np

    rng = np.random.default_rng(CLUSTER_SEED)
    reqs = []
    for i in range(CLUSTER_REQUESTS):
        hot = i % 3 != 2
        n = int(rng.integers(65 if hot else 64, 129))
        steps = 512 if hot else int(rng.choice((128, 256)))
        reqs.append({"steps": steps, "seed": i,
                     "overrides": {"n": n, "gating": "pallas"}})
    return reqs


def journal_records(paths) -> list:
    """Every complete record of the given journal files, in file order
    (a torn final line is skipped)."""
    recs = []
    for path in paths:
        try:
            with open(path) as fh:
                lines = fh.readlines()
        except OSError:
            continue
        for line in lines:
            try:
                recs.append(json.loads(line))
            except ValueError:
                pass
    return recs


class BeatWatch:
    """Watches a lease from outside its owner: polls the lease file and
    its ``.beat`` sidecar every ``poll_s`` and stamps each change of
    (epoch, beat) at ``epoch`` on this process's monotonic clock — the
    owner's renewals as a standby sees them."""

    def __init__(self, lease_path: str, epoch: int, poll_s: float = 0.002):
        import threading

        self.lease_path, self.epoch, self.poll_s = lease_path, epoch, poll_s
        self.stamps: list = []     # (monotonic s, beat)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        from cbf_tpu_torch.serve import ha

        last = None
        while not self._stop.is_set():
            try:
                state = ha.read_lease(self.lease_path)
            except ValueError:
                state = None
            if state is not None and state.epoch == self.epoch \
                    and state.beat != last:
                last = state.beat
                self.stamps.append((time.monotonic(), state.beat))
            time.sleep(self.poll_s)

    def start(self) -> "BeatWatch":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def largest_gap(self) -> tuple:
        """(largest interval between two stamps, its start after the
        first stamp — the acquire), in seconds."""
        gaps = [(b[0] - a[0], a[0] - self.stamps[0][0])
                for a, b in zip(self.stamps, self.stamps[1:])]
        return max(gaps) if gaps else (float("nan"), float("nan"))


def phase20(engine, knn, swarm, t_start, p18, dev="cuda") -> dict:
    """Phase 20: high availability and the routed cluster (module
    docstring). Returns each driven run's launches and the
    measurements."""
    import os
    import shutil
    import signal
    import statistics

    import numpy as np
    import torch

    from cbf_tpu_torch import obs
    from cbf_tpu_torch.analysis import lockwitness
    from cbf_tpu_torch.cluster import HashRing
    from cbf_tpu_torch.durable import journal as dj
    from cbf_tpu_torch.serve import FencedError, ServeEngine, bucket_key
    from cbf_tpu_torch.serve import engine as serve_engine
    from cbf_tpu_torch.serve import ha
    from cbf_tpu_torch.utils import faults

    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = {"runs": {}, "info": {}}
    info = out["info"]
    t20 = time.perf_counter()
    root = os.path.abspath(os.path.dirname(__file__) or ".")
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m", "cbf_tpu_torch"]

    def fresh(name):
        work = os.path.join(root, "chiprun_out", name)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        return work

    def last_record(path):
        with open(path) as fh:
            lines = fh.read().strip().splitlines()
        return json.loads(lines[-1]) if lines else {}

    # 20a. a hot standby takes over from a SIGKILLed primary, through the
    # CLI.
    work = fresh("phase20a")
    lease, journal, ready, tel = (os.path.join(work, f) for f in (
        "lease.json", "j.jsonl", "ready", "standby"))
    reqs = os.path.join(work, "requests.json")
    with open(reqs, "w") as fh:
        json.dump([{"steps": HA_STEPS, "seed": i, "overrides": {
            "n": HA_N, "gating": "pallas"}} for i in range(HA_REQUESTS)], fh)
    s_out, s_err = (open(os.path.join(work, f), "w")
                    for f in ("standby.out", "standby.err"))
    t_spawn = time.perf_counter()
    standby = subprocess.Popen(
        cli + ["serve", "--ha-standby", "--lease", lease, "--journal",
               journal, "--lease-ttl-s", str(HA_TTL_S), "--ready-file",
               ready, "--standby-max-wait-s", "300", "--max-batch",
               str(HA_BATCH), "--telemetry-dir", tel, "--device", dev],
        env=env, stdout=s_out, stderr=s_err)
    marks = {}
    try:
        check(faults.wait_for_file(ready, 300), "20a: the standby never "
              "wrote its ready file")
        marks["ready"] = time.perf_counter() - t_spawn
        watch = BeatWatch(lease, epoch=1).start()

        def should_kill(elapsed):
            if "ack" not in marks:
                try:
                    with open(journal) as fh:
                        if '"submitted"' in fh.read():
                            marks["ack"] = elapsed
                except OSError:
                    pass
                return False
            if elapsed - marks["ack"] < HA_KILL_AFTER_S:
                return False
            marks["kill_wall"] = time.time()
            marks["kill"] = time.monotonic()
            return True

        try:
            rc, killed, _ = faults.run_process_until(
                cli + ["serve", reqs, "--lease", lease, "--journal",
                       journal, "--pace-s", str(HA_PACE_S), "--heartbeat-s",
                       str(HA_BEAT_S), "--max-batch", str(HA_BATCH),
                       "--device", dev],
                should_kill, poll_s=0.005, timeout_s=300.0, env=env)
        finally:
            watch.stop()
        check(killed and rc is not None, f"20a: the primary was not "
              f"killed (rc {rc})")
        standby.wait(timeout=300)
    except BaseException:
        standby.kill()
        standby.wait()
        raise
    finally:
        s_out.close()
        s_err.close()
    with open(os.path.join(work, "standby.err")) as fh:
        err_tail = fh.read()[-2000:]
    check(standby.returncode == 0, f"20a: the standby exited "
          f"{standby.returncode}: {err_tail}")
    rec = last_record(os.path.join(work, "standby.out"))
    check(rec.get("takeover") is True and rec.get("epoch") == 2
          and rec.get("prev_epoch") == 1 and not rec.get("errors"),
          f"20a: the takeover record {rec}")
    replay = dj.replay_journal(journal)
    acked = set(replay.submitted)
    check(replay.unresolved == [] and set(replay.resolved) == acked
          and all(replay.resolved_counts[r] == 1 for r in acked),
          f"20a: fold after the takeover: unresolved {replay.unresolved}, "
          f"counts {replay.resolved_counts}")
    recs = journal_records([journal])
    resolved = {r["request_id"]: r for r in recs if r["type"] == "resolved"}
    recovered = sorted(r for r, v in resolved.items() if v["epoch"] == 2)
    check(rec["reenqueued"] == len(recovered) > 0
          and sorted(s["request_id"] for s in rec["served"]) == recovered,
          f"20a: {rec['reenqueued']} re-enqueued, {recovered} resolved at "
          f"epoch 2, served {rec['served']}")
    events = obs.read_events(tel)
    by_id = {e["request_id"]: e for e in events if e["event"] == "request"}
    for rid in recovered:
        ev = by_id.get(rid)
        check(ev is not None and ev["min_pairwise_distance"] >= FLOOR
              and ev["infeasible_count"] == 0, f"20a: recovered {rid}: {ev}")
    summary = next((e for e in events if e["event"] == "summary"), {})
    compiled = summary.get("compile_events_during_run", {})
    capture_s = sum(v for k, v in compiled.items()
                    if k.startswith("serve.compile_ms[")) / 1000.0
    gap, gap_at = watch.largest_gap()
    acquire = watch.stamps[0][0] if watch.stamps else float("nan")
    first_s = min(v["t"] for r, v in resolved.items()
                  if r in recovered) - marks["kill_wall"]
    cold_s = p18["info"].get("18d", {}).get("kill_to_first_result_s",
                                             float("nan"))
    info["20a"] = {
        "acknowledged": len(acked), "resolved_before_kill":
        len(acked) - len(recovered), "recovered": recovered,
        "epoch": rec["epoch"], "records": rec["records"],
        "deduped": rec["deduped"], "mttr_s": rec["mttr_s"],
        "standby_ready_s": marks["ready"], "standby_capture_s": capture_s,
        "standby_compile_events": compiled,
        "beats_seen": len(watch.stamps),
        "primary_max_beat_gap_s": gap,
        "primary_max_beat_gap_after_acquire_s": gap_at,
        "primary_acquire_to_kill_s": marks["kill"] - acquire,
        "kill_to_first_recovered_s": first_s,
        "cold_recover_kill_to_first_result_s": cold_s,
        "min_distance": min(by_id[r]["min_pairwise_distance"]
                            for r in recovered)}
    check(gap < HA_TTL_S, f"20a: the primary's beats paused {gap:.3f} s, "
          f"beyond the TTL {HA_TTL_S} s")
    print(f"phase 20a: `serve --ha-standby` ready {marks['ready']:.2f} s "
          f"after spawn (import and CUDA init); the `serve --lease` "
          f"primary SIGKILLed {HA_KILL_AFTER_S} s after its first "
          f"acknowledgment with {len(acked) - len(recovered)} of "
          f"{len(acked)} acknowledged requests resolved; the standby took "
          f"over at epoch {rec['epoch']}: {rec['reenqueued']} re-enqueued "
          f"{recovered}, {rec['deduped']} deduped, every acknowledged id "
          f"resolved once, none lost; recovered results above the floor "
          f"with 0 infeasible (min {info['20a']['min_distance']:.6f}); "
          f"the standby's captures {capture_s:.3f} s, paid before the "
          f"kill; the primary's largest gap between beats {gap:.4f} s, "
          f"{gap_at:.3f} s after its acquire ({len(watch.stamps)} beats "
          f"seen over {marks['kill'] - acquire:.2f} s, TTL {HA_TTL_S} s); "
          f"mttr_s {rec['mttr_s']}; kill -> first recovered result "
          f"{first_s:.3f} s (a cold `serve --recover`, phase 18d: "
          f"{cold_s:.2f} s)")
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 20b. a continuous primary fenced with lanes in flight, in process.
    work = fresh("phase20b")
    lease, jpath = (os.path.join(work, f) for f in ("lease.json",
                                                   "j.jsonl"))

    def cfg_of(n, steps, seed):
        return swarm.Config(n=n, steps=steps, seed=seed, gating="pallas")

    longs = [cfg_of(HA_N, FENCE_LONG_STEPS, s) for s in range(3)]
    plus = cfg_of(HA_N, FENCE_SHORT_STEPS, 3)
    side = cfg_of(HA_N // 2, FENCE_LONG_STEPS, 4)
    late = cfg_of(HA_N, FENCE_SHORT_STEPS, 5)
    lockwitness.arm()
    lockwitness.reset()
    program_lock = serve_engine._PROGRAM_LOCK
    serve_engine._PROGRAM_LOCK = lockwitness.make_lock(
        "serve.engine._PROGRAM_LOCK")
    try:
        primary = ha.Lease(lease, owner="primary")
        eng = ServeEngine(
            continuous=True, chunk_steps=FENCE_CHUNK, max_batch=FENCE_BATCH,
            bucket_sizes=(HA_N // 2, HA_N), device=dev,
            journal=dj.RequestJournal(jpath, epoch=primary.acquire(),
                                      fence_path=lease))
        eng.prewarm([plus, side])
        sync()
        seen = {}
        eng.partial_hook = lambda rid, done, part: seen.setdefault(rid,
                                                                   done)
        zero_counts(engine, knn)
        eng.start()
        try:
            pend = [eng.submit(c) for c in longs + [plus, side]]
            t_wait = time.perf_counter()
            while len(seen) < len(pend):
                check(time.perf_counter() - t_wait < 120, f"20b: lanes "
                      f"in flight {sorted(seen)}")
                time.sleep(0.001)
            p_late = eng.submit(late)       # behind the full 4096 table
            joined = eng.stats["lanes_joined"]
            size = os.path.getsize(jpath)
            t_fence = time.perf_counter()
            fence_epoch = ha.Lease(lease, owner="standby").acquire()
            outcome = []
            for p in pend + [p_late]:
                try:
                    p.result(timeout=600)
                    outcome.append(None)
                except FencedError as e:
                    outcome.append(e)
            resolve_s = time.perf_counter() - t_fence
        finally:
            eng.stop(drain=True)
        sync()
        launches, counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
        inversions = lockwitness.inversions()
        edges = lockwitness.observed_edges()
    finally:
        serve_engine._PROGRAM_LOCK = program_lock
        lockwitness.disarm()
        lockwitness.reset()
    out["runs"]["phase 20b"] = {"launches": launches}
    check(joined == len(pend) and fence_epoch == 2, f"20b: {joined} lanes "
          f"joined before the fence at epoch {fence_epoch}")
    check(all(isinstance(e, FencedError) and (e.epoch, e.fence_epoch)
              == (1, 2) for e in outcome), f"20b: outcomes {outcome}")
    check(isinstance(eng.fenced, FencedError), "20b: engine.fenced unset")
    check(os.path.getsize(jpath) == size, f"20b: the journal grew from "
          f"{size} to {os.path.getsize(jpath)} bytes after the fence")
    recs = journal_records([jpath])
    packed = {r for rec in recs if rec["type"] == "packed"
              for r in rec["request_ids"]}
    check(p_late.request_id not in packed and p_late.request_id in {
        rec["request_id"] for rec in recs if rec["type"] == "submitted"},
        "20b: the late request did not take the mid-join fence path")
    check(inversions == [] and ("serve.engine._PROGRAM_LOCK",
                                "RequestJournal._lock") not in edges,
          f"20b: witness inversions {inversions}, edges {sorted(edges)}")
    want = dict.fromkeys(knn.LAUNCHES, 0)
    if cuda:
        want["knn_fused"] = want["knn_fused_members"] = \
            want["knn_fused_radii"] = (eng.stats["chunks_executed"]
                                       * FENCE_CHUNK + counts["redo_steps"])
    check(launches == want and (not cuda or counts["captures"] == 0),
          f"20b: launches {launches}, want {want}; counts {counts}")
    info["20b"] = {"lanes_in_flight": joined, "chunks": eng.stats[
        "chunks_executed"], "fenced_to_resolved_s": resolve_s,
        "journal_bytes": size, "edges": sorted(edges),
        "launches": launches}
    print(f"phase 20b: {joined} lanes in flight (buckets {HA_N} and "
          f"{HA_N // 2}, {FENCE_CHUNK}-step chunks) and one request queued "
          f"behind the full {HA_N} table when a second Lease.acquire "
          f"fenced the journal at epoch {fence_epoch}: all "
          f"{len(outcome)} resolved with FencedError within "
          f"{resolve_s:.3f} s (the queued one on the mid-join path: its "
          f"packed record refused), engine.fenced set, the journal "
          f"{size} bytes before and after; the armed witness: no "
          f"inversion over {len(edges)} edges, no journal append under "
          f"_PROGRAM_LOCK; launches {launches}")
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 20c. the routed cluster through the CLI, one worker SIGKILLed.
    work = fresh("phase20c")
    croot, ctel = os.path.join(work, "root"), os.path.join(work, "router")
    reqs = os.path.join(work, "requests.json")
    entries = cluster_requests()
    with open(reqs, "w") as fh:
        json.dump(entries, fh)
    labels = [bucket_key(swarm.Config(
        n=e["overrides"]["n"], steps=e["steps"], seed=e["seed"],
        gating="pallas"))[0].label() for e in entries]
    hot = statistics.mode(labels)
    victim = HashRing(["e0", "e1"]).place(hot)
    vdir = os.path.join(croot, "engines", victim)
    c_out, c_err = (open(os.path.join(work, f), "w")
                    for f in ("cluster.out", "cluster.err"))
    t_c = time.perf_counter()
    proc = subprocess.Popen(
        cli + ["cluster", "serve", reqs, "--engines", "2", "--device", dev,
               "--prewarm", "--steal", "--lease-ttl-s", str(CLUSTER_TTL_S),
               "--root", croot, "--telemetry-dir", ctel,
               "--worker-metrics", "--result-timeout", "120"], env=env,
        stdout=c_out, stderr=c_err)
    try:
        while True:
            check(proc.poll() is None, f"20c: cluster serve exited "
                  f"{proc.returncode} before the kill")
            check(time.perf_counter() - t_c < 300, "20c: no request in "
                  "flight on the hot engine")
            ready_both = all(os.path.exists(os.path.join(
                croot, "engines", e, "ready")) for e in ("e0", "e1"))
            recs = journal_records([os.path.join(vdir, "journal.wal")])
            done = {r["request_id"] for r in recs if r["type"] == "resolved"}
            flight = [r["request_id"] for r in recs
                      if r["type"] == "submitted"
                      and r["request_id"] not in done]
            if ready_both and flight:
                break
            time.sleep(0.002)
        with open(os.path.join(vdir, "pid")) as fh:
            vpid = json.load(fh)["pid"]
        os.kill(vpid, signal.SIGKILL)
        kill_wall = time.time()
        t_kill = time.perf_counter() - t_c
        proc.wait(timeout=480)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    finally:
        c_out.close()
        c_err.close()
    with open(os.path.join(work, "cluster.err")) as fh:
        err_tail = fh.read()[-2000:]
    crec = last_record(os.path.join(work, "cluster.out"))
    census = crec.get("census", {})
    check(proc.returncode == 0 and census.get("ok") and census.get(
        "submitted") == CLUSTER_REQUESTS and crec["completed"]
        == CLUSTER_REQUESTS and not crec["errors"]
        and crec["failovers"] >= 1, f"20c: exit {proc.returncode}, record "
          f"{crec}: {err_tail}")
    jfiles = []
    for e in ("e0", "e1"):
        base = os.path.join(croot, "engines", e)
        jfiles += [os.path.join(base, n) for n in sorted(os.listdir(base))
                   if n.endswith("journal.wal")]
    recs = journal_records(jfiles)
    resolved_t = {r["request_id"]: r["t"] for r in recs
                  if r["type"] == "resolved"}
    dead = journal_records([os.path.join(vdir, n) for n in sorted(
        os.listdir(vdir)) if n.startswith("archived-")])
    dead_done = {r["request_id"] for r in dead if r["type"] == "resolved"}
    orphans = {r["request_id"] for r in dead if r["type"] == "submitted"
               and r["request_id"] not in dead_done}
    check(bool(orphans), "20c: the killed worker left no acknowledged "
          "request to replay")
    routed = {e["request_id"]: e["t_wall"] for e in obs.read_events(ctel)
              if e["event"] == "cluster.route"}
    check(sorted(routed) == sorted(resolved_t), "20c: routed ids "
          f"{sorted(routed)}, resolved ids {sorted(resolved_t)}")
    served = {}
    for e in ("e0", "e1"):
        for ev in obs.read_events(os.path.join(croot, "engines", e,
                                               "telemetry")):
            if ev["event"] == "request":
                served.setdefault(ev["request_id"], []).append(ev)
    for i in range(CLUSTER_REQUESTS):
        rid, ref = f"c{i + 1}", CLUSTER_REFERENCE_DIPS.get(i)
        evs = served.get(rid, [])
        check(evs and all(
            ev["infeasible_count"] == 0 and (
                ev["min_pairwise_distance"] >= FLOOR if ref is None
                else abs(ev["min_pairwise_distance"] - ref)
                <= CROSS_MD_ATOL) for ev in evs),
              f"20c: request {i} ({rid}, reference dip {ref}): {evs}")
    lat = sorted(resolved_t[r] - routed[r] for r in routed)
    span = max(resolved_t.values()) - min(routed.values())
    replayed = min(resolved_t[r] for r in orphans) - kill_wall
    info["20c"] = {
        "requests": CLUSTER_REQUESTS, "hot_bucket": hot,
        "hot_requests": labels.count(hot), "victim": victim,
        "killed_at_s": t_kill, "orphans": sorted(orphans),
        "req_per_s": CLUSTER_REQUESTS / span,
        "latency_p50_s": statistics.median(lat),
        "latency_p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "stolen": crec["stolen"], "failovers": crec["failovers"],
        "mttr_s": crec["mttr_s"], "kill_to_first_replayed_s": replayed,
        "census": census, "wall_s": crec["wall_s"],
        "cli_s": time.perf_counter() - t_c}
    print(f"phase 20c: `cluster serve --engines 2 --prewarm --steal` on "
          f"{CLUSTER_REQUESTS} requests ({labels.count(hot)} in the hot "
          f"bucket {hot}, placed on {victim}): {victim} SIGKILLed "
          f"{t_kill:.2f} s after spawn with {len(orphans)} acknowledged "
          f"requests unresolved; exit 0, census {census}; "
          f"{info['20c']['req_per_s']:.3f} req/s from the first route to "
          f"the last resolve, latency p50 {info['20c']['latency_p50_s']:.4f}"
          f" s p99 {info['20c']['latency_p99_s']:.4f} s (route -> resolved "
          f"record); stolen {crec['stolen']}; failover MTTR "
          f"{crec['mttr_s']} s (detection -> re-homed, TTL {CLUSTER_TTL_S}"
          f" s before it); kill -> the survivor's first replayed result "
          f"{replayed:.3f} s; every result above the floor with 0 "
          f"infeasible (requests {sorted(CLUSTER_REFERENCE_DIPS)} held to "
          f"the reference's dips); wall {crec['wall_s']} s in the record, "
          f"{info['20c']['cli_s']:.2f} s for the command")
    info["seconds"] = time.perf_counter() - t20
    with open(os.path.join(root, "chiprun_out", "phase20.json"), "w") as fh:
        json.dump(info, fh, indent=1, default=str)
    print(f"phase 20: {info['seconds']:.1f} s")
    return out


def phase21(engine, knn, swarm, t_start, dev="cuda") -> dict:
    """Phase 21: the scenario DSL and the falsification fleet (module
    docstring). Returns each driven run's launches and the
    measurements."""
    import dataclasses
    import hashlib
    import os
    import shutil
    import statistics

    import numpy as np
    import torch

    from cbf_tpu_torch import obs
    from cbf_tpu_torch.analysis import lockwitness
    from cbf_tpu_torch.core.filter import CBFParams
    from cbf_tpu_torch.obs import flight as obs_flight
    from cbf_tpu_torch.scenarios.platform import dsl
    from cbf_tpu_torch.serve import ServeEngine
    from cbf_tpu_torch.serve import engine as serve_engine
    from cbf_tpu_torch.utils import prng
    from cbf_tpu_torch.verify import corpus, search
    from cbf_tpu_torch.verify import fleet as vfleet
    from cbf_tpu_torch.verify.properties import thresholds_for

    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = {"runs": {}, "info": {}}
    info = out["info"]
    t21 = time.perf_counter()
    root = os.path.abspath(os.path.dirname(__file__) or ".")

    def fresh(name):
        work = os.path.join(root, "chiprun_out", name)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        return work

    def launch_delta(before):
        return {k: knn.LAUNCHES[k] - before[k] for k in before}

    # 21a. the generator's batch, each spec end to end through run_spec.
    specs = dsl.generate(DSL_SEED, count=DSL_COUNT)
    digest = hashlib.sha256(json.dumps(
        [dataclasses.asdict(s) for s in specs],
        sort_keys=True).encode()).hexdigest()
    check(digest == DSL_SPECS_SHA256, f"21a: generate({DSL_SEED}, "
          f"{DSL_COUNT}) hashes to {digest}, not the JAX package's")
    dsl.enroll(specs, replace=True)
    sync()
    rows, total = [], dict.fromkeys(knn.LAUNCHES, 0)
    t_a = time.perf_counter()
    for i, spec in enumerate(specs):
        cfg = spec.to_config()
        zero_counts(engine, knn)
        t0 = time.perf_counter()
        _final, outs = dsl.run_spec(spec, device=dev)
        md, infeasible = dsl.run_summary(outs)      # one host copy
        wall = time.perf_counter() - t0
        launches, counts = dict(knn.LAUNCHES), dict(engine.COUNTS)
        want = dict.fromkeys(knn.LAUNCHES, 0)
        if cuda:
            want["knn_fused"] = cfg.steps + counts["redo_steps"]
        check(launches == want, f"21a: {spec.name} launches {launches}, "
              f"want {want} (counts {counts})")
        floor = thresholds_for(spec.name, cfg).separation_floor
        ref_md, ref_infeasible = DSL_REFERENCE[i]
        off = abs(md - ref_md)
        check(np.isfinite(md) and md > floor and infeasible == 0
              == ref_infeasible, f"21a: {spec.name} min distance {md} "
              f"(floor {floor}), {infeasible} infeasible")
        check(off <= DSL_MD_ATOL, f"21a: {spec.name} min distance {md} "
              f"parts from the JAX package's CPU run {ref_md} by {off}")
        for k, v in launches.items():
            total[k] += v
        rows.append({"spec": spec.name, "n": cfg.n, "steps": cfg.steps,
                     "dynamics": cfg.dynamics, "rta": cfg.rta,
                     "min_distance": md, "reference": ref_md, "off": off,
                     "parts": off > CROSS_MD_ATOL, "floor": floor,
                     "launches": launches["knn_fused"],
                     "captures": counts["captures"],
                     "redo_steps": counts["redo_steps"], "wall_s": wall})
    out["runs"]["phase 21a"] = {"launches": total}
    parted = [r["spec"] for r in rows if r["parts"]]
    info["21a"] = {"mode": "compiled (swarm.run: one capture per spec)",
                   "specs": rows, "wall_s": time.perf_counter() - t_a,
                   "max_off": max(r["off"] for r in rows),
                   "parted": parted}
    print(f"phase 21a: generate({DSL_SEED}, {DSL_COUNT}) equal to the JAX "
          f"package's (sha256 {digest[:12]}); each spec through "
          f"dsl.run_spec compiled on {dev} (a capture per spec): every one "
          f"above its separation floor with 0 infeasible, knn_fused once "
          f"per step (+ redone steps: "
          f"{sum(r['redo_steps'] for r in rows)}), min distance within "
          f"{info['21a']['max_off']:.3g} of the JAX package's CPU run "
          f"(bound {DSL_MD_ATOL}); parted beyond {CROSS_MD_ATOL}: "
          f"{parted or 'none'}; {info['21a']['wall_s']:.2f} s for "
          f"{sum(r['steps'] for r in rows)} steps")
    for r in rows:
        print(f"  {r['spec']} n={r['n']} x {r['steps']} {r['dynamics']}"
              f"{' rta' if r['rta'] else ''}: min {r['min_distance']:.8f} "
              f"(JAX CPU {r['reference']:.8f}, off {r['off']:.2e}"
              f"{', PARTS' if r['parts'] else ''}), launches "
              f"{r['launches']}, {r['wall_s']:.3f} s")
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 21b. the fleet at its defaults: seven targets, B candidates per
    # dispatch, its dispatches per round, for FLEET_ROUNDS rounds.
    work = fresh("phase21b")
    st = vfleet.FleetSettings(**FLEET_FIELDS)
    t0 = time.perf_counter()
    targets = vfleet.enroll_targets(st, device=dev)
    enroll_s = time.perf_counter() - t0
    per_target = {t.name: dict.fromkeys(knn.LAUNCHES, 0) for t in targets}
    per_dispatch = {t.name: [] for t in targets}

    def counted(target):
        def eval_b(deltas):
            before = dict(knn.LAUNCHES)
            t_d = time.perf_counter()
            margins = target.eval_b(deltas)
            sync()
            delta = launch_delta(before)
            for k, v in delta.items():
                per_target[target.name][k] += v
            per_dispatch[target.name].append(
                (time.perf_counter() - t_d, delta.get("knn_fused_members",
                                                      0)))
            return margins
        return target._replace(eval_b=eval_b)

    wrapped = [counted(t) for t in targets]
    fleet = vfleet.FalsificationFleet(
        st, budget_rounds=FLEET_ROUNDS, targets=wrapped,
        state_dir=os.path.join(work, "whole"))
    zero_counts(engine, knn)
    round_s, t_r = [], time.perf_counter()
    while True:
        unit = fleet.next_unit()
        if unit is None:
            break
        r = fleet._round
        unit()
        if fleet._round != r:
            round_s.append(time.perf_counter() - t_r)
            t_r = time.perf_counter()
    sync()
    launches_b, counts_b = dict(knn.LAUNCHES), dict(engine.COUNTS)
    by_target = {k: v["knn_fused_members"] for k, v in per_target.items()}
    dispatches = {k: list(v) for k, v in per_dispatch.items()}
    res = fleet.result()
    out["runs"]["phase 21b"] = {"launches": launches_b}
    per_round = st.batch * st.batches_per_round
    check(res.rounds == FLEET_ROUNDS and res.evaluated
          == FLEET_ROUNDS * per_round and not res.violations
          and np.isfinite(res.best_margin) and res.best_margin > 0,
          f"21b: {res}")
    check(len(targets) == 7 and res.cells_visited == res.cells_total,
          f"21b: {len(targets)} targets, cells {res.cells_visited}/"
          f"{res.cells_total}")
    swarm_family = {t.name for t in targets if t.cfg.__class__ is
                    swarm.Config}
    for name, lc in per_target.items():
        if name in swarm_family and cuda:
            check(lc["knn_fused_members"] == lc["knn_fused"] > 0,
                  f"21b: {name} launches {lc}")
        else:
            check(sum(lc.values()) == 0, f"21b: {name} launches {lc}")
    # One swarm target's first dispatch again, against its candidates run
    # alone (the falsifier's member contract).
    t_idx = [t.name for t in targets].index("swarm")
    tgt = targets[t_idx]
    kd = prng.fold_in(prng.fold_in(prng.fold_in(fleet._key, 0), t_idx), 0)
    deltas = vfleet.mutate_batch(kd, st.batch,
                                 tuple(tgt.adapter.delta_shape),
                                 search._state_dtype(tgt.adapter),
                                 st.perturb_scale, [])
    batch_m = tgt.eval_b(deltas).detach().cpu().numpy()
    one = search.make_eval_one(tgt.adapter, fleet._ss)
    alone = np.stack([one(torch.as_tensor(d)).detach().cpu().numpy()
                      for d in deltas])
    fin = np.isfinite(batch_m)
    member_err = float(np.max(np.abs(batch_m[fin] - alone[fin])))
    check(np.array_equal(fin, np.isfinite(alone))
          and member_err <= MEMBER_MARGIN_ATOL,
          f"21b: the swarm target's batch margins differ from each "
          f"candidate alone by {member_err}")
    # The same campaign dropped after round 1 and resumed.
    split = os.path.join(work, "split")
    part = vfleet.run_fleet(st, budget_rounds=1, targets=wrapped,
                            state_dir=split)
    resumed = vfleet.run_fleet(st, budget_rounds=FLEET_ROUNDS,
                               targets=wrapped, state_dir=split)
    check(part.rounds == 1 and resumed._replace(state_path=None)
          == res._replace(state_path=None), f"21b: resumed {resumed} != "
          f"uninterrupted {res}")
    with np.load(res.state_path) as a, np.load(resumed.state_path) as b:
        check(sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files),
            "21b: the resumed campaign's state differs from the "
            "uninterrupted one's")
    cps = [per_round / w for w in round_s]
    info["21b"] = {
        "targets": [t.name for t in targets], "batch": st.batch,
        "dispatches_per_round": st.batches_per_round,
        "max_steps": st.max_steps, "enroll_s": enroll_s,
        "round_s": round_s, "candidates_per_s": cps,
        "captures": counts_b["captures"], "redo_steps":
        counts_b["redo_steps"], "best_margin": res.best_margin,
        "launches_by_target": by_target,
        "dispatch_s_by_target": {k: [w for w, _ in v]
                                 for k, v in dispatches.items()},
        "member_margin_err": member_err}
    print(f"phase 21b: the fleet at its defaults ({len(targets)} targets, "
          f"B={st.batch}, {st.batches_per_round} dispatches per round, "
          f"{st.max_steps} steps) on {dev}: {FLEET_ROUNDS} rounds, "
          f"{res.evaluated} candidates, best margin {res.best_margin:.6f},"
          f" coverage {res.cells_visited}/{res.cells_total}; rounds "
          f"{[round(w, 3) for w in round_s]} s = "
          f"{[round(c, 2) for c in cps]} candidates/s (round 1 holds "
          f"{counts_b['captures']} captures); enroll {enroll_s:.3f} s; "
          f"knn_fused member launches by target "
          f"{info['21b']['launches_by_target']}; the swarm target's "
          f"margins within {member_err:.2e} of each candidate alone; "
          f"dropped after round 1 and resumed: equal to the uninterrupted "
          f"campaign, its state file bit for bit")
    for name, ds in dispatches.items():
        print(f"  {name}: dispatches (s, member launches) "
              f"{[(round(w, 4), n) for w, n in ds]}")
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 21c. detection: the weakened dmin found, shrunk, confirmed in
    # float64, archived, the capsule tripped, the archive replayed.
    work = fresh("phase21c")
    sink = obs.TelemetrySink(os.path.join(work, "run"))
    flight = obs_flight.FlightRecorder(
        os.path.join(sink.run_dir, "capsules")).attach(sink)
    st_c = vfleet.FleetSettings(**DETECT_FIELDS)
    weak = CBFParams(**WEAK_CBF_FIELDS)
    a = search.make_adapter("swarm", swarm.Config(**MARGINAL_FIELDS),
                            cbf=weak, device=dev)
    target = vfleet.FleetTarget(
        "swarm-weak", "swarm", "swarm", a.cfg, weak, a,
        search.make_eval_batch(a, vfleet._search_settings(st_c)))
    zero_counts(engine, knn)
    t0 = time.perf_counter()
    res_c = vfleet.run_fleet(st_c, budget_rounds=FLEET_DETECT_ROUNDS,
                             targets=[target],
                             corpus_dir=os.path.join(work, "corpus"),
                             telemetry=sink, flight=flight)
    detect_s = time.perf_counter() - t0
    out["runs"]["phase 21c"] = {"launches": dict(knn.LAUNCHES)}
    check(res_c.done and res_c.violations, f"21c: the weakened dmin was "
          f"not found in {FLEET_DETECT_ROUNDS} rounds: {res_c}")
    v = res_c.violations[0]
    check(v["confirmed_x64"] and v["margin_x64"] < 0
          and v["property"] == "separation" and v["corpus"]
          and os.path.exists(v["corpus"]), f"21c: violation {v}")
    capsules = sorted(os.listdir(os.path.join(sink.run_dir, "capsules")))
    check(any("fleet.violation" in c for c in capsules),
          f"21c: no fleet.violation capsule in {capsules}")
    replay = corpus.replay_corpus(os.path.join(work, "corpus"), device=dev)
    check(replay and all(problems == [] for _, _, problems in replay),
          f"21c: the archive does not replay clean: "
          f"{[p for _, _, p in replay]}")
    sink.close()
    info["21c"] = {"rounds": res_c.rounds, "evaluated": res_c.evaluated,
                   "detect_s": detect_s, "violation": v,
                   "capsules": capsules}
    print(f"phase 21c: the weakened dmin ({WEAK_CBF_FIELDS}) on "
          f"{MARGINAL_FIELDS} found in round {v['round'] + 1} of "
          f"{FLEET_DETECT_ROUNDS} after {res_c.evaluated} candidates, "
          f"{detect_s:.2f} s to detection (shrink and archive included): "
          f"{v['property']} margin {v['margin']:.6f}, float64 "
          f"{v['margin_x64']:.6f} confirmed, archived, capsule "
          f"{capsules}, the archive replays clean")
    print(f"  (script at {time.perf_counter() - t_start:.1f} s)")

    # 21d. the campaign as the background tenant of a queue-mode engine at
    # the serve default, with 8 foreground requests, in turns.
    cfgs = serve_workload(swarm, 0, **TENANT_REQUESTS)
    st_d = vfleet.FleetSettings(**TENANT_FIELDS)
    tcfg = swarm.Config(n=TENANT_N, steps=st_d.max_steps)
    a = search.make_adapter("swarm", tcfg, device=dev)
    inner = search.make_eval_batch(a, vfleet._search_settings(st_d))
    under_lock = []

    def tenant_eval(deltas):
        under_lock.append(serve_engine._PROGRAM_LOCK.locked())
        return inner(deltas)

    tiny = [vfleet.FleetTarget("tenant-swarm", "swarm", "swarm", a.cfg,
                               None, a, tenant_eval)]
    ref = vfleet.run_fleet(st_d, budget_rounds=TENANT_ROUNDS, targets=tiny)
    under_lock.clear()

    def fg_run(with_tenant):
        eng = ServeEngine(max_batch=TENANT_REQUESTS["B"],
                          flush_deadline_s=0.05, device=dev)
        eng.prewarm(cfgs)
        campaign = None
        eng.start()
        try:
            if with_tenant:
                campaign = vfleet.FalsificationFleet(
                    st_d, budget_rounds=TENANT_ROUNDS, targets=tiny)
                eng.attach_background(campaign)
                t_wait = time.perf_counter()
                while eng.stats["background_batches"] < 1:
                    check(time.perf_counter() - t_wait < 60,
                          "21d: the tenant never ran")
                    time.sleep(0.001)
            t0 = time.perf_counter()
            pend = [eng.submit(c) for c in cfgs]
            res_d = [p.result(timeout=600) for p in pend]
            wall = time.perf_counter() - t0
            if campaign is not None:
                t_wait = time.perf_counter()
                while not campaign._finished:
                    check(time.perf_counter() - t_wait < 120,
                          "21d: the campaign did not finish")
                    time.sleep(0.005)
                eng.attach_background(None)
        finally:
            eng.stop()
        sync()
        return res_d, wall, campaign, dict(eng.stats)

    lockwitness.arm()
    lockwitness.reset()
    program_lock = serve_engine._PROGRAM_LOCK
    serve_engine._PROGRAM_LOCK = lockwitness.make_lock(
        "serve.engine._PROGRAM_LOCK")
    legs = []
    try:
        for with_tenant in (False, True, True, False):
            zero_counts(engine, knn)
            got, wall, campaign, stats = fg_run(with_tenant)
            legs.append({"tenant": with_tenant, "results": got,
                         "wall_s": wall, "campaign": campaign,
                         "stats": stats, "launches": dict(knn.LAUNCHES)})
        inversions = lockwitness.inversions()
        acquisitions = lockwitness.snapshot()["acquisitions"]
    finally:
        serve_engine._PROGRAM_LOCK = program_lock
        lockwitness.disarm()
        lockwitness.reset()
    out["runs"]["phase 21d"] = {"launches": legs[1]["launches"]}
    check(inversions == [] and acquisitions > 0,
          f"21d: witness inversions {inversions}")
    check(under_lock and all(under_lock), "21d: a tenant unit ran "
          "outside _PROGRAM_LOCK")
    base = legs[0]["results"]
    for leg in legs:
        for i, (x, y) in enumerate(zip(leg["results"], base)):
            check(same_result(x, y), f"21d: request {i} with the tenant "
                  f"{leg['tenant']} differs from the engine without one")
        c = leg["campaign"]
        if c is not None:
            r = c.result()
            check((r.evaluated, r.best_margin, r.rounds)
                  == (ref.evaluated, ref.best_margin, ref.rounds),
                  f"21d: the tenant campaign {r} != standalone {ref}")
    p50 = {k: [statistics.median(x.latency_s for x in leg["results"])
               for leg in legs if leg["tenant"] == k] for k in (False, True)}
    info["21d"] = {
        "requests": len(cfgs), "max_batch": TENANT_REQUESTS["B"],
        "latency_p50_s": {"without": p50[False], "with": p50[True]},
        "walls_s": [(leg["tenant"], leg["wall_s"]) for leg in legs],
        "background_batches": [leg["stats"]["background_batches"]
                               for leg in legs if leg["tenant"]],
        "background_yields": [leg["stats"]["background_yields"]
                              for leg in legs if leg["tenant"]],
        "campaign": {"evaluated": ref.evaluated,
                     "best_margin": ref.best_margin},
        "units_under_lock": len(under_lock),
        "lock_acquisitions": acquisitions}
    print(f"phase 21d: {len(cfgs)} queue-mode requests (base "
          f"{TENANT_REQUESTS['base']}, {TENANT_REQUESTS['steps']} steps, "
          f"max_batch {TENANT_REQUESTS['B']}) with and without a "
          f"{TENANT_ROUNDS}-round campaign (N={TENANT_N}, B={st_d.batch}) "
          f"as the background tenant, in turns: results np.array_equal to "
          f"the engine without one; latency p50 without "
          f"{[round(x, 4) for x in p50[False]]} s, with "
          f"{[round(x, 4) for x in p50[True]]} s; background_batches "
          f"{info['21d']['background_batches']}, background_yields "
          f"{info['21d']['background_yields']}; the campaign ended equal "
          f"to its standalone run (evaluated {ref.evaluated}, best margin "
          f"{ref.best_margin:.6f}); {len(under_lock)} units, each under "
          f"_PROGRAM_LOCK; the armed witness: no inversion over "
          f"{acquisitions} acquisitions")
    info["seconds"] = time.perf_counter() - t21
    with open(os.path.join(root, "chiprun_out", "phase21.json"), "w") as fh:
        json.dump(info, fh, indent=1, default=str)
    print(f"phase 21: {info['seconds']:.1f} s")
    return out


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
    from cbf_tpu_torch.sim import certificates

    # The certificate's search radius at the main path's speed limit.
    cert_radius = certificates.binding_pair_radius(swarm._certificate_problem(
        swarm.Config(n=CERT_N, certificate=True))[0])

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
                     or (("stream_partial" in name or "fused" in name)
                         and "ILi16E" in name))
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

    def hold(name, label, x, w=None, k=K, radius=RADIUS):
        n = x.shape[0]
        kw = {} if w is None else {"window_blocks": w}
        err, outs = compare(getattr(knn, name), plains[name], x, k=k,
                            radius=radius, **kw)
        errs[name][n] = max(errs[name].get(n, 0.0), err)
        if radius != RADIUS:
            label = f"{label}, r={radius:.4f}"
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
    # The certificate's search: k=16 at the binding-pair radius.
    for n in (37, 256, MAIN_N, knn.MAX_N_FUSED):
        hold("knn_fused", "spawn", spawn(n), k=CERT_K, radius=cert_radius)
        over = hold("knn_fused", "packed", spawn(n) * PACK, k=CERT_K,
                    radius=cert_radius)
        check(n < MAIN_N or over == n,
              f"packed N={n}, k={CERT_K}: a row holds <= k candidates")
    for n in (MAIN_N, STREAM_N):
        hold("knn_stream", "spawn", spawn(n), k=CERT_K, radius=cert_radius)
        hold("knn_stream", "packed", spawn(n) * PACK, k=CERT_K,
             radius=cert_radius)
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
          f"8-byte-aligned rows; at k={CERT_K}, r={cert_radius:.4f}, "
          "N=37/256/4096/8192), knn_stream equal at N=1/37/1000/2000/4096/"
          f"16384/20000/{BANDED_N} (and on 8-byte-aligned rows, at k=1 and "
          f"k=16, at k={CERT_K}, r={cert_radius:.4f}, N=4096/16384, and to "
          "the fused plain version at 4096), "
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

    # 12. the joint certificate, compiled and held to the eager loop
    cert = {}

    def cert_run(key, cfg, per_step, note="", wrap=None):
        label = f"phase 12{key}: N={cfg.n}, certificate{note}"
        run = drive(swarm, engine, knn, cfg, label, "knn_fused",
                    per_step=per_step, wrap=wrap)
        outs, step, info = run["outs"], run["step"], run["info"]
        md = check_run(f"{label} x {cfg.steps} steps", cfg, run["final"],
                       outs, floor=CERT_FLOOR)
        res = float(outs.certificate_residual.max())
        check(res < CERT_RESIDUAL_GATE,
              f"{label}: certificate residual {res} >= {CERT_RESIDUAL_GATE}")
        check(bool(torch.isfinite(outs.certificate_residual).all()),
              f"{label}: non-finite certificate residual")
        settings = swarm._certificate_settings(cfg)
        backend = swarm.certificate_backend(cfg)
        if backend == "sparse":
            rows = cfg.n * min(cfg.certificate_k, cfg.n - 1)
        else:
            rows = min(cfg.certificate_pairs or 8 * cfg.n,
                       cfg.n * (cfg.n - 1) // 2) + 4 * cfg.n
        blocks = None
        if cfg.certificate_tol:
            blocks = (step.admm_blocks if step.admm_blocks is not None
                      else -(-settings.iters // settings.check_every))
        hist = torch.bincount(outs.certificate_iterations.long().cpu())
        run["cert"] = {
            "backend": backend, "rows_R": rows, "variables": 2 * cfg.n,
            "guarded_blocks_B": blocks, "redos": info["redos"],
            "redo_steps": info["redo_steps"],
            "certificate_iterations_histogram": {
                i: int(c) for i, c in enumerate(hist) if int(c)},
            "dropped_count": int(outs.certificate_dropped_count.sum()),
            "max_residual": res, "min_distance": md,
            "infeasible": int(outs.infeasible_count.sum()),
            "peak_over_held_mib_compiled":
                info["peak_over_held_mib_compiled"],
            "peak_over_held_mib_eager": info["peak_over_held_mib_eager"],
            "first_call_s": info["first_call_s"],
            "first_call_less_a_replay_s":
                info["first_call_s"] - min(info["compiled_s"]),
            "eager_step_ms": info["eager_step_ms"],
            "compiled_step_ms": info["compiled_step_ms"]}
        print(f"{label}: " + json.dumps(run["cert"])
              + f" (script at {time.perf_counter() - t_start:.1f} s)")
        cert[key] = run
        return run

    cert_run("a", swarm.Config(n=CERT_N, steps=CERT_STEPS,
                               certificate=True), per_step=2)
    hold("knn_fused", "phase 12a final state",
         cert["a"]["final"].x.float().contiguous(), k=CERT_K,
         radius=cert_radius)
    cert_run("b", swarm.Config(n=CERT_N, steps=CERT_STEPS, certificate=True,
                               certificate_warm_start=True,
                               certificate_tol=CERT_TOL), per_step=2,
             note=f", warm start, tol {CERT_TOL}")

    def one_block(step):
        step.admm_blocks = 1
        return step

    redo = cert_run("b B=1", swarm.Config(
        n=CERT_N, steps=CERT_REDO_STEPS, certificate=True,
        certificate_warm_start=True, certificate_tol=CERT_TOL), per_step=2,
        note=f", warm start, tol {CERT_TOL}, one guarded block",
        wrap=one_block)
    check(redo["info"]["redos"] == 1,
          f"phase 12b B=1: {redo['info']['redos']} redos, want 1")
    fused = cert_run("c", swarm.Config(
        n=CERT_N, steps=CERT_FUSED_STEPS, certificate=True,
        certificate_backend="sparse", certificate_fused=True,
        certificate_rebuild_skin=CERT_SKIN), per_step=2,
        note=f", fused (Chebyshev), skin {CERT_SKIN}")
    rebuilds = fused["info"]["eager_launches"] - CERT_FUSED_STEPS
    fused["cert"]["eager_rebuilds"] = rebuilds
    print(f"phase 12c: {rebuilds} certificate-search rebuilds in "
          f"{CERT_FUSED_STEPS} eager steps; the graph searches on all "
          f"{CERT_FUSED_STEPS}")
    cert_run("d", swarm.Config(n=CERT_DENSE_N, steps=CERT_DENSE_STEPS,
                               certificate=True), per_step=1,
             note=", dense")
    cfg_x = swarm.Config(n=CERT_CROSS_N, steps=CERT_CROSS_STEPS,
                         certificate=True)
    cross_check(swarm, engine, cfg_x, swarm.initial_state(cfg_x),
                "phase 12e (certificate, sparse)")

    # 13. the reference scenarios, the CLI and the compat example
    scen = phase13(engine, knn, swarm, t_start)

    # 14. the differentiable path, the trainer and the falsifier
    p14 = phase14(engine, knn, swarm, t_start)

    # 15. the member axis on one card: the banded kernel's, the falsifier
    # on a banded swarm, the ensembles
    p15a = phase15a(knn, swarm)
    p15 = phase15(engine, knn, swarm, t_start)

    # 16. durability and observability at the flagship width
    p16 = phase16(engine, knn, swarm, t_start)

    # 17. the traced-config serving path: the radius array, the drain and
    # chunk programs, card vs CPU
    p17 = phase17(engine, knn, swarm, t_start)

    # 18. the serve engine's drain mode: run() and queue mode on phase
    # 17b's workloads, the fault ladder, the journal across a kill
    p18 = phase18(engine, knn, swarm, t_start, p17)

    # 19. the continuous scheduler: joins and leaves at full width, seeded
    # traffic drain against continuous, the loadgen CLI and its surfaces
    p19 = phase19(engine, knn, swarm, t_start)

    # 20. high availability and the routed cluster: a standby's takeover
    # through the CLI, a continuous primary fenced in flight, the cluster
    # CLI with a worker killed
    p20 = phase20(engine, knn, swarm, t_start, p18)

    # 21. the scenario DSL and the falsification fleet: the generator's
    # batch end to end, the fleet at its defaults with a resume, the
    # weakened dmin detected, the campaign as a serve engine's tenant
    p21 = phase21(engine, knn, swarm, t_start)

    # 6. timings at the main-path shapes; launches are every compiled
    # main-path run's of this call, by phase (13f's run swarm included)
    all_runs = {"phase 3 N=256": runs[ENTRY_N], "phase 3 N=4096": main,
                "phase 4": stream, "phase 7": banded,
                "phase 8 scatter": obst["scatter"],
                "phase 8 orbit": obst["orbit"],
                **{f"phase 9 {family}": run for family, run in dyn.items()},
                "phase 10": verlet,
                **{f"phase 11 {kind}": run for kind, run in rta.items()},
                **{f"phase 12{key}": run for key, run in cert.items()},
                "phase 13f": scen["13f"], **p14["runs"], **p15["runs"],
                **p16["runs"], **p17["runs"], **p18["runs"],
                **p19["runs"], **p20["runs"], **p21["runs"]}
    by_phase = {name: {label: run["launches"][name]
                       for label, run in all_runs.items()
                       if run["launches"].get(name)}
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
        if name in ("knn_fused", "knn_stream"):
            # The certificate's search: k=16 at the binding-pair radius,
            # on phase 12a's initial state (knn_fused, the main path's
            # shape) and on phase 4's (knn_stream, the shape a certificate
            # beyond the fused bound would take).
            xc = (cert["a"]["state0"].x if name == "knn_fused"
                  else state0_s.x).to(torch.float32).contiguous()
            count_c = fn(xc, cert_radius, CERT_K)[-1]
            t_ops = (OPS_PER_PAIR * n * n + CERT_K * int(count_c.sum())
                     ) / PEAK_F32_ISSUE_PER_S
            t_bytes = (8 * n + n * CERT_K * 8 + n * 8) / PEAK_BYTES_PER_S
            timed_c = time_call(lambda: fn(xc, cert_radius, CERT_K))
            timed_c.pop("device_op_names")
            row["certificate_search"] = {
                "k": CERT_K, "radius": cert_radius, "n": n, **timed_c,
                "plain_ms": cuda_ms(lambda: plain(xc, cert_radius, CERT_K),
                                    reps=10, warmup=2)[0],
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "in_radius_candidates": int(count_c.sum())}
        rows.append(row)
    # The member-axis launches: one launch (the banded form: one launch
    # set) for a batch of members — the falsifier's VERIFY_BATCH
    # candidates, the shape timed here, and the ensembles' members —
    # held equal in 14a, 15a, 15c and 15d, and timed also at the
    # ensembles' shapes; launches from every phase that ran them.
    members = {"knn_fused": {**p14["members"]["knn_fused"],
                             **p15["members"]["knn_fused"]},
               "knn_stream": {**p14["members"]["knn_stream"],
                              **p15["members"]["knn_stream"]},
               "knn_banded": {**p15a["falsifier"],
                              "at_phase_7_width": p15a["phase 7"]}}
    vmaps = ("cbf_tpu/verify/search.py:327, "
             "cbf_tpu/parallel/ensemble.py:757")
    for name, src_line, where in (
            ("knn_fused", "cbf_tpu/ops/pallas_knn.py:94", vmaps),
            ("knn_stream", "cbf_tpu/ops/pallas_knn.py:184", vmaps),
            ("knn_banded", "cbf_tpu/ops/pallas_knn.py:309",
             "cbf_tpu/verify/search.py:327")):
        mem = dict(members[name])
        mem.pop("device_op_names", None)
        key = f"{name}_members"
        rows.append({
            "name": f"{name} (member axis)", "route": "cuda",
            "source": "cbf_tpu_torch/csrc/knn.cu",
            "replaces": f"{src_line} under jax.vmap ({where})",
            "max_abs_err": 0.0, "equal": True, "library_ms": None,
            **mem, "launches": sum(by_phase[key].values()),
            "launches_by_phase": by_phase[key]})
    # The radius-array launches (phase 17a's shapes; held equal there), one
    # row per kernel at the serving program's full-width shape, with the
    # launches of every phase-17 run that took a radius array.
    for name, label in (("knn_fused", "fused B=8 N=4096"),
                        ("knn_stream", "stream B=8 N=4096")):
        rad = dict(p17["radius"][label])
        key = f"{name}_radii"
        rows.append({
            "name": f"{name} (radius array)", "route": "cuda",
            "source": "cbf_tpu_torch/csrc/knn.cu",
            "replaces": ("cbf_tpu/ops/pallas_knn.py:90 (r2 read from SMEM) "
                         "under jax.vmap of cbf_tpu/parallel/ensemble.py:"
                         "780-872"),
            "equal": True, "library_ms": None,
            "launches": sum(by_phase[key].values()),
            "launches_by_phase": by_phase[key],
            "at": {k: v for k, v in p17["radius"].items()
                   if v["name"] == name}, **{k: rad[k] for k in (
                       "ms", "device_ms", "scalar_ms", "scalar_device_ms",
                       "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                       "n", "members")}})
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
                       (f"N={MAIN_N} RTA armed, healthy", rta["healthy"]),
                       (f"N={CERT_N} certificate (12a)", cert["a"]),
                       (f"N={CERT_DENSE_N} dense certificate (12d)",
                        cert["d"])):
        prof = profile_both(engine, run, label,
                            steps=(CERT_PROFILE_STEPS if run is cert["a"]
                                   else CERT_DENSE_PROFILE_STEPS
                                   if run is cert["d"]
                                   else PROFILE_RUN_STEPS))
        print(f"  (script at {time.perf_counter() - t_start:.1f} s)")
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
                                           for kind, run in rta.items()),
                                         *((f"phase 12{key}", run)
                                           for key, run in cert.items())))
          + f"; main path {qps:.1f} agent-QP-steps/s; orbit min distance "
          f"{obst['orbit']['min_distance']:.6f}; card {card}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
