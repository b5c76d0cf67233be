"""Ensemble rollouts with each member's whole swarm on one device
(counterpart: cbf_tpu/parallel/ensemble.py).

The JAX package runs Monte-Carlo members of the swarm over a (dp, sp)
mesh. On one card dp folds into the member axis and sp is 1
(:mod:`cbf_tpu_torch.parallel.mesh`), so every member is a whole swarm
and :func:`_local_swarm_step` is the JAX step's whole-swarm branch: the
k-NN kernels where :func:`knn.supported` (the zero-gradient selection on
the differentiable path, :func:`knn.knn_gating_pallas_diff`, which the
trainer :mod:`cbf_tpu_torch.learn.tuning` differentiates through), the
Verlet cache at E == 1, the filter, the joint certificate per member
(with its warm carry) or deferred to the caller, integration and the
step's metrics.

:func:`sharded_swarm_rollout` runs E members through the compiled
rollout (:mod:`cbf_tpu_torch.rollout.engine`), one step program of
:func:`_rollout_executable` for the whole ensemble:

- per member: ``torch.func.vmap`` of the member step over E, so every op
  carries all members and the k-NN kernels launch once per step for the
  ensemble (their member axis, through ``knn_select``'s vmap rule);
- lockstep (E > 1 with the sparse certificate): the pre-certificate step
  under ``vmap``, one batched certificate for all members
  (:func:`swarm.apply_certificate_batched`, one shared ADMM loop), and
  the finishing tail under ``vmap``, as the JAX package's ``one_batched``.

Each member carries its own relax flag under ``vmap`` (the body's shared
in-place flag cannot be written from inside it); the flags are ORed into
the body's. Eagerly the vmapped step runs the same guarded relax rounds
and, where a member needs more, again with every round the relax loop
could take — the result the loop gives — so a compiled run equals the
eager loop bit for bit.

The serving layer's programs, :func:`lockstep_traced_rollout` and
:func:`lockstep_traced_chunk`, vmap the traced-config step
(:func:`swarm.make_step_traced`) over a batch of HETEROGENEOUS requests of
one bucket — each member with its own traced values, padded-agent count,
horizon and (chunk) clock, all carried as per-lane tensors through the
engine's static buffers, so one captured program per (bucket, horizon or
chunk, B) serves any of them; the k-NN kernels read each member's radius
from their radius array.

Not ported (ROADMAP.md Queue A10): agent sharding (sp > 1, the exchange
search), dp across devices, and ``partition="spatial"``. Each raises
:class:`OutOfSliceError`.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from cbf_tpu_torch.core.filter import CBFParams, safe_controls
from cbf_tpu_torch.errors import SLICE_PARALLEL, OutOfSliceError
from cbf_tpu_torch.ops import knn
from cbf_tpu_torch.parallel.mesh import Mesh, check_single_device
from cbf_tpu_torch.rollout import engine
from cbf_tpu_torch.rollout.gating import knn_gating
from cbf_tpu_torch.scenarios import swarm as swarm_scenario
from cbf_tpu_torch.sim.certificates import certificate_solver_seed
from cbf_tpu_torch.solvers import exact2d
from cbf_tpu_torch.utils.math import safe_norm


class EnsembleMetrics(NamedTuple):
    """(E, steps) per-member series (the JAX package's fields): the
    nearest distance (the Verlet path's sound floor), engaged and
    infeasible agents, k-NN truncation drops, the certificate's residual,
    truncation and iterations (0 without the certificate or on the dense
    backend), and the unicycle's saturation deficit (0 otherwise)."""
    nearest_distance: Any
    engaged_count: Any
    infeasible_count: Any
    dropped_count: Any
    certificate_residual: Any
    certificate_dropped: Any
    saturation_deficit: Any
    certificate_iterations: Any = ()


def ensemble_initial_states(cfg: swarm_scenario.Config, seeds, *,
                            device=None):
    """(E, N, 2) positions and (E, N, 2) zero velocities, one spawn per
    seed (the scenario's spawn and obstacle-clearing push), plus (E, N)
    seeded headings in unicycle mode. The spawn draws JAX's stream
    (:mod:`cbf_tpu_torch.utils.prng`), so each member starts bit for bit
    where the JAX package's does."""
    dev = swarm_scenario.resolve_device(device)
    x0 = torch.stack([swarm_scenario.clear_obstacle_spawn(
        cfg, swarm_scenario.spawn_positions(cfg, int(s), device=dev))
        for s in seeds])
    if cfg.dynamics == "unicycle":
        theta0 = torch.stack([swarm_scenario.heading_spawn(cfg, int(s),
                                                           device=dev)
                              for s in seeds])
        return x0, torch.zeros_like(x0), theta0
    return x0, torch.zeros_like(x0)


class _PendingStep(NamedTuple):
    """What a deferred (``defer_certificate=True``) step hands the caller,
    so the joint layer runs outside the per-member vmap and
    :func:`_finish_swarm_step` completes integration and metrics — one
    tail for the deferred and the inline paths. Absent parts are ``()``
    (a vmapped function returns tensors only)."""
    body: Any            # original body centres (== x outside unicycle)
    theta: Any           # (N,) headings or ()
    v: Any               # (N, 2) incoming si velocities
    engaged: Any         # (N,) filter-engagement mask
    feasible: Any        # (N,) per-agent QP feasibility
    nearest1: Any        # (N,) gated nearest distance
    min_floor: Any       # Verlet sound-floor scalar or ()
    dropped: Any         # k-NN truncation counts
    new_cache: Any       # updated Verlet cache or ()


@functools.lru_cache(maxsize=64)
def _barrier_dynamics(cfg: swarm_scenario.Config, dtype, device):
    """``swarm.barrier_dynamics`` made once per (cfg, dtype, device): its
    rows are host data copied to the device, which a captured step may
    not do (the engine's warm-up body fills this cache first). Constants,
    never written."""
    return swarm_scenario.barrier_dynamics(cfg, dtype, device=device)


def _or_empty(v):
    return () if v is None else v


def _local_swarm_step(x, v, cfg: swarm_scenario.Config, cbf: CBFParams,
                      unroll_relax: int = 0, compute_metrics: bool = True,
                      t=0, theta=None, gating_cache=None,
                      cert_solver_state=None,
                      defer_certificate: bool = False, obstacles4=None):
    """One member's whole-swarm step (the JAX step at sp size 1). x, v:
    (N, 2); ``theta`` (N,) in unicycle mode (``x`` is then the body centre
    and the filter works on the projection points); ``t`` the global step
    (the obstacle ring is closed-form in it; ``obstacles4`` (M, 4) gives
    its rows where the caller has them, as the compiled body does).
    Differentiable with ``unroll_relax > 0`` and ``compute_metrics=False``.

    ``gating_cache``: the Verlet cache (``swarm.verlet_gating``), threaded
    by the caller; the nearest metric is then its sound floor.
    ``cert_solver_state``: the sparse certificate's warm carry, threaded
    by the caller. ``defer_certificate``: stop before the joint layer and
    return (u_filtered, x_si, :class:`_PendingStep`) for the lockstep
    batched certificate and :func:`_finish_swarm_step`.

    Returns (x_new, v_new, theta_new or None, metrics or None, nearest1
    (N,) — the gated nearest distance, inf with nothing in radius,
    new_cache or None, new_cert_state or None); v_new is the applied si
    velocity."""
    dt_ = x.dtype
    dev = x.device
    f, g, discrete = _barrier_dynamics(cfg, dt_, dev)
    K = min(cfg.k_neighbors, cfg.n - 1)
    M = cfg.n_obstacles

    unicycle = cfg.dynamics == "unicycle"
    body = x
    if unicycle:
        x = swarm_scenario.projection_points(cfg, body, theta)

    mean = torch.sum(x, dim=0) / cfg.n
    to_c = mean[None] - x
    d_c = safe_norm(to_c, keepdim=True)
    pull = torch.clamp(d_c - cfg.pack_radius, min=0.0)
    u0 = cfg.consensus_gain * pull * to_c / torch.clamp(d_c, min=1e-9)
    if M:
        if obstacles4 is None:
            obstacles4 = swarm_scenario.obstacle_states_at(cfg, t, dt_,
                                                           device=dev)
        dodge, d_o = swarm_scenario.lane_dodge(x, obstacles4,
                                               cfg.safety_distance)
        u0 = u0 + 2.0 * dodge
    double = cfg.dynamics == "double"
    vslots = v if (double or not discrete) else torch.zeros_like(v)
    states4 = torch.cat([x, vslots], dim=1)
    min_floor = None
    new_cache = None
    kernel = "streaming" if cfg.gating == "streaming" else "auto"
    if gating_cache is not None:
        if unroll_relax > 0:
            raise ValueError("the Verlet cache path is not differentiable "
                             "(rebuild cond + kernels) — train with "
                             "gating_rebuild_skin=0")
        if cfg.gating == "banded":
            raise ValueError("gating_rebuild_skin requires the pallas/jnp "
                             "gating backends (see scenarios.swarm.make)")
        # cfg.gating honoured as the scenario honours it: the shared
        # verlet_gating selects the same sets on both paths.
        use_kernel = (knn.supported(cfg.n) if cfg.gating == "auto"
                      else cfg.gating == "pallas")
        not_self = (None if use_kernel else
                    ~torch.eye(cfg.n, dtype=torch.bool, device=dev))
        obs_slab, mask, min_floor, dropped, new_cache = \
            swarm_scenario.verlet_gating(cfg, x, states4, gating_cache, K,
                                         use_kernel, not_self)
        d = torch.sqrt(torch.sum((x[:, None, :] - obs_slab[..., :2]) ** 2,
                                 dim=-1))
        nearest1 = torch.amin(torch.where(mask, d, torch.inf), dim=1)
    elif knn.supported(cfg.n):
        if unroll_relax > 0:
            # The kernels select, torch recomputes what the loss
            # differentiates.
            obs_slab, mask, nearest1, dropped = knn.knn_gating_pallas_diff(
                states4, cfg.safety_distance, K, kernel=kernel)
        else:
            obs_slab, mask, nearest_all, dropped = knn.knn_gating_pallas(
                states4, cfg.safety_distance, K, kernel=kernel)
            # The gated top-1 distance: nearest-any equals it within the
            # radius, and every consumer clips at the radius.
            nearest1 = torch.where(nearest_all < cfg.safety_distance,
                                   nearest_all, torch.inf)
    else:
        obs_slab, mask, dropped = knn_gating(
            states4, states4, cfg.safety_distance, K,
            exclude_self_row=torch.ones(cfg.n, dtype=torch.bool, device=dev),
            with_dropped=True)
        d = safe_norm(x[:, None, :] - obs_slab[..., :2], dim=-1)
        nearest1 = torch.amin(torch.where(mask, d, torch.inf), dim=1)

    u0 = swarm_scenario.complete_nominal(cfg, u0, x, v, obs_slab, mask)

    priority = None
    if M:
        obs_slab, mask, priority = swarm_scenario.attach_obstacle_rows(
            obs_slab, mask, obstacles4, d_o, cfg.safety_distance)
        nearest1 = torch.minimum(nearest1, torch.amin(d_o, dim=1))
        if min_floor is not None:
            # The Verlet bound covers agent pairs only; the obstacle
            # distances are exact every step.
            min_floor = torch.minimum(min_floor, torch.amin(d_o))

    priority, cap = swarm_scenario.relax_tiers(cfg, mask, priority)
    plain_box = double or unicycle
    u_safe, info = safe_controls(
        states4, obs_slab, mask, f, g, u0, cbf,
        unroll_relax=unroll_relax,
        priority_mask=priority, relax_cap=cap,
        reference_layout=not plain_box, vel_box_rows=not plain_box)
    engaged = torch.any(mask, dim=1)
    u = torch.where(engaged[:, None], u_safe, u0)

    aux = _PendingStep(body=body, theta=_or_empty(theta), v=v,
                       engaged=engaged, feasible=info.feasible,
                       nearest1=nearest1, min_floor=_or_empty(min_floor),
                       dropped=dropped, new_cache=_or_empty(new_cache))
    if defer_certificate:
        if cert_solver_state is not None:
            raise ValueError(
                "defer_certificate hands the joint layer to the caller — "
                "the batched solver carry is the caller's, not this "
                "step's (pass cert_solver_state=None)")
        return u, x, aux

    cert_res = torch.zeros((), dtype=dt_, device=dev)
    cert_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    cert_iters = torch.zeros((), dtype=torch.int32, device=dev)
    new_cert_state = None
    if cfg.certificate:
        if cert_solver_state is not None:
            (u, cert_res, cert_dropped, cert_iters,
             new_cert_state) = swarm_scenario.apply_certificate(
                cfg, u, x, solver_state=cert_solver_state)
        else:
            u, cert_res, cert_dropped, cert_iters = \
                swarm_scenario.apply_certificate(cfg, u, x)
    out = _finish_swarm_step(cfg, x, u, aux, cert_res, cert_dropped,
                             cert_iters, compute_metrics)
    return out + (new_cache, new_cert_state)


def _finish_swarm_step(cfg: swarm_scenario.Config, x, u, aux: _PendingStep,
                       cert_res, cert_dropped, cert_iters,
                       compute_metrics: bool = True):
    """Integration and metrics — the shared tail of the inline step and,
    per member under vmap, of the lockstep batched certificate. ``x`` is
    the si position set the filter acted on, ``u`` the (possibly
    certified) command. Returns (x_new, v_new, theta_new or None, metrics
    (8 scalars, :class:`EnsembleMetrics`' order) or None, nearest1)."""
    theta_new = None
    deficit = torch.zeros((), dtype=x.dtype, device=x.device)
    if cfg.dynamics == "unicycle":
        x_new, theta_new, p_new = swarm_scenario.unicycle_apply(
            cfg, aux.body, aux.theta, u)
        v_new = (p_new - x) / cfg.dt
        deficit = torch.amax(safe_norm(u - v_new))
    else:
        x_new, v_new = swarm_scenario.integrate(cfg, x, aux.v, u)
    metrics = None
    if compute_metrics:
        i32 = torch.int32
        metrics = (
            # The Verlet path reports its truncation-sound floor.
            torch.amin(aux.nearest1) if isinstance(aux.min_floor, tuple)
            else aux.min_floor,
            torch.sum(aux.engaged, dtype=i32),
            torch.sum(~aux.feasible & aux.engaged, dtype=i32),
            torch.sum(aux.dropped, dtype=i32),
            cert_res, cert_dropped.to(i32), deficit, cert_iters.to(i32))
    return (x_new, v_new, theta_new, metrics, aux.nearest1)


def _vmap_guarded(fn, args, rounds: int, blocks):
    """``torch.func.vmap(fn)`` over the leading member axis of ``args``,
    each member inside its own relax guard. Returns (outputs, (E,) flags
    — set where a member's QPs needed more than ``rounds`` rounds)."""
    leaf = engine._leaves(args)[0]
    flags = torch.zeros(leaf.shape[0], dtype=torch.bool, device=leaf.device)

    def one(flag, *a):
        with exact2d.guarded_relax(rounds, flag, blocks):
            out = fn(*a)
        return out, flag

    return torch.func.vmap(one)(flags, *args)


def _over_members(fn, args, rounds: int):
    """``fn`` over the member axis, vmapped. Inside the compiled body: the
    body's guarded rounds and blocks, the members' flags ORed into the
    body's. Eagerly: ``rounds`` guarded rounds, and where a member is not
    settled, again with every round — the relax loop's result."""
    if exact2d.in_guarded_body():
        body_rounds, blocks = exact2d.guard_settings()
        out, flags = _vmap_guarded(fn, args, body_rounds, blocks)
        exact2d.request_redo(torch.any(flags))
        return out
    out, flags = _vmap_guarded(fn, args, rounds, None)
    if bool(torch.any(flags)):
        out, _ = _vmap_guarded(fn, args, exact2d.ALL_ROUNDS, None)
    return out


def _cbf_key(cbf: CBFParams) -> tuple:
    """The program key of ``cbf``: a float leaf by value, a tensor leaf
    (per-agent leaves of mixed dynamics, learned parameters) by shape and
    dtype — its values are copied into the program's own buffer before
    each run, so equal parameters in new tensors replay one program."""
    return tuple((tuple(v.shape), v.dtype) if torch.is_tensor(v)
                 else float(v) for v in cbf)


def _rollout_executable(cfg: swarm_scenario.Config, mesh: Mesh, E: int,
                        cbf: CBFParams):
    """The ensemble's step program for (cfg, mesh, E) and ``cbf``'s float
    leaves, cached, so repeat calls replay their captured graphs instead
    of capturing again; ``cbf``'s tensor leaves are copied into the
    program's buffers here (the last call's values are the ones a run of
    the returned step reads). ``step(carry, t, inputs=None) -> (carry,
    EnsembleMetrics of (E,) tensors)``, carry = (x, v[, theta][, Verlet
    cache][, solver carry]) with E leading; it carries the compiled
    rollout's attributes (``relax_rounds``, ``admm_blocks``,
    ``host_inputs`` with obstacles)."""
    step = _cached_executable(cfg, mesh, E, _cbf_key(cbf))
    with torch.no_grad():
        for buf, v in zip(step.cbf, cbf):
            if torch.is_tensor(v):
                buf.copy_(v)
    return step


@functools.lru_cache(maxsize=64)
def _cached_executable(cfg: swarm_scenario.Config, mesh: Mesh, E: int,
                       cbf_key: tuple):
    """The step program of :func:`_rollout_executable` over a ``cbf`` of
    buffers made from ``cbf_key`` (``step.cbf``)."""
    cbf = CBFParams(*(
        torch.empty(k[0], dtype=k[1], device=mesh.device)
        if isinstance(k, tuple) else k for k in cbf_key))
    step = _build_executable(cfg, mesh, E, cbf)
    step.cbf = cbf
    return step


def _build_executable(cfg: swarm_scenario.Config, mesh: Mesh, E: int,
                      cbf: CBFParams):
    """The ensemble's step program for one (cfg, mesh, E, cbf), uncached.

    E == 1 runs the member step itself (the Verlet cache's only shape);
    E > 1 vmaps it over the members; with the sparse certificate, E > 1
    takes the lockstep batched certificate instead."""
    unicycle = cfg.dynamics == "unicycle"
    parts = 3 if unicycle else 2
    use_cache = cfg.gating_rebuild_skin > 0 and E == 1
    use_warm = cfg.certificate_warm_start
    use_batched_cert = (
        cfg.certificate and E > 1
        and swarm_scenario.certificate_backend(cfg) == "sparse")
    rounds = swarm_scenario.relax_rounds(cfg)

    def obstacle_rows(t, inputs):
        if not cfg.n_obstacles:
            return None
        if inputs is not None:
            return inputs
        return swarm_scenario.obstacle_states_at(cfg, t, cfg.dtype,
                                                 device=mesh.device)

    def member(st, t, obstacles4):
        """One member's step on its carry (no member axis)."""
        cstate = st[-1] if use_warm else None
        cache = st[parts] if use_cache else None
        th = st[2] if unicycle else None
        x2, v2, th2, met, _, cache2, cstate2 = _local_swarm_step(
            st[0], st[1], cfg, cbf, t=t, theta=th, gating_cache=cache,
            cert_solver_state=cstate, obstacles4=obstacles4)
        new = (x2, v2, th2) if unicycle else (x2, v2)
        if use_cache:
            new = new + (cache2,)
        if use_warm:
            new = new + (cstate2,)
        return new, EnsembleMetrics(*met)

    def per_member(carry, t, inputs=None):
        obs4 = obstacle_rows(t, inputs)
        if E == 1:
            new, met = member(engine._tree_map(lambda a: a[0], carry), t,
                              obs4)
            return (engine._tree_map(lambda a: a[None], new),
                    engine._tree_map(lambda m: m[None], met))
        return _over_members(lambda st: member(st, t, obs4), (carry,),
                             rounds)

    def lockstep(carry, t, inputs=None):
        obs4 = obstacle_rows(t, inputs)
        cstate = carry[-1] if use_warm else None

        def pre(x, v, *th):
            return _local_swarm_step(
                x, v, cfg, cbf, t=t, theta=th[0] if unicycle else None,
                defer_certificate=True, obstacles4=obs4)

        u, xsi, aux = _over_members(pre, carry[:parts], rounds)
        res = swarm_scenario.apply_certificate_batched(
            cfg, u, xsi, solver_state=cstate)
        u2, cert_res, cert_dropped, cert_iters = res[:4]

        def finish(um, xm, am, cr, cd, ci):
            x2, v2, th2, met, _ = _finish_swarm_step(cfg, xm, um, am, cr, cd,
                                                     ci)
            return ((x2, v2, th2) if unicycle else (x2, v2)), met

        new, met = torch.func.vmap(finish)(u2, xsi, aux, cert_res,
                                           cert_dropped, cert_iters)
        if use_warm:
            new = new + (res[4],)
        return new, EnsembleMetrics(*met)

    step = lockstep if use_batched_cert else per_member
    step.relax_rounds = rounds
    # The lockstep loop stops at its slowest member, so under
    # certificate_tol it outruns a budget sized for one swarm
    # (CERTIFICATE_BLOCKS): with it, a 4 x 4096 warm run on an H100 redid
    # 300 of 400 steps eagerly, and the lockstep needed 40-100 iterations
    # per step (PERF.md §5-6). It runs the whole budget instead (None),
    # which costs what the fixed budget costs and never redoes.
    step.admm_blocks = (None if use_batched_cert
                        else swarm_scenario.CERTIFICATE_BLOCKS)
    if cfg.n_obstacles:
        step.host_inputs = lambda t0, n: swarm_scenario.obstacle_table(
            cfg, t0, n, cfg.dtype)
    return step


def _repeated(seed, E: int):
    """A per-swarm seed carry repeated for E members (own storage)."""
    return tuple(torch.stack([a] * E) for a in seed)


def _initial_carry(cfg: swarm_scenario.Config, mesh: Mesh, seeds,
                   initial_state=None) -> tuple:
    """The ensemble rollout's full carry: (x, v[, theta]) from
    ``initial_state`` or the seeds' spawns, plus the Verlet cache (E == 1)
    and the certificate's warm carry (given as ``initial_state``'s extra
    element, or seeded cold), member-major — so chunked segments and
    resumed runs continue exactly."""
    unicycle = cfg.dynamics == "unicycle"
    parts = 3 if unicycle else 2
    E = len(seeds)
    use_warm = cfg.certificate_warm_start
    solver_state0 = None
    if initial_state is not None:
        n_given = len(initial_state)
        if n_given == parts + 1 and use_warm:
            solver_state0 = tuple(initial_state[parts])
            initial_state = tuple(initial_state[:parts])
        elif n_given != parts:
            extra = " (+1 solver carry under certificate_warm_start)" \
                if use_warm else ""
            raise ValueError(
                f"initial_state needs {parts} arrays{extra} for "
                f"dynamics={cfg.dynamics!r}, got {n_given}")
        if tuple(initial_state[0].shape) != (E, cfg.n, 2):
            raise ValueError(
                f"initial_state x0 shape {tuple(initial_state[0].shape)} "
                f"!= {(E, cfg.n, 2)}")
        if unicycle and tuple(initial_state[2].shape) != (E, cfg.n):
            raise ValueError(
                f"initial_state theta0 shape "
                f"{tuple(initial_state[2].shape)} != {(E, cfg.n)}")
        carry = tuple(initial_state)
    else:
        carry = tuple(ensemble_initial_states(cfg, seeds,
                                              device=mesh.device))
    if cfg.gating_rebuild_skin > 0 and E == 1:
        carry += (_repeated(swarm_scenario.verlet_cache_seed(
            cfg, device=mesh.device), E),)
    if use_warm:
        if solver_state0 is None:
            solver_state0 = _repeated(certificate_solver_seed(
                cfg.n, cfg.certificate_k, cfg.dtype, device=mesh.device), E)
        carry += (tuple(solver_state0),)
    return carry


def sharded_swarm_rollout(cfg: swarm_scenario.Config, mesh: Mesh, seeds,
                          steps: int | None = None,
                          cbf: CBFParams | None = None,
                          initial_state=None, t0: int = 0,
                          chunk: int | None = None,
                          with_solver_state: bool = False,
                          telemetry=None, telemetry_every: int = 50,
                          partition: str = "flat"):
    """Run len(seeds) independent swarms on ``mesh`` (a (1, 1) mesh of
    :func:`~cbf_tpu_torch.parallel.mesh.make_mesh`: the members share the
    device and every op carries the member axis), through the compiled
    rollout.

    ``initial_state``: optional (x0, v0) — (x0, v0, theta0) in unicycle
    mode — of (E, N, 2) / (E, N) tensors to start from instead of the
    seeds' spawns, with ``t0`` its global step (the obstacle ring resumes
    in phase). Under ``cfg.certificate_warm_start`` it may carry one more
    element: the solver carry a previous call returned with
    ``with_solver_state=True`` (5-tuple of (E, ...) leaves); without it a
    resumed run seeds the carry cold.

    ``chunk``: run ``chunk``-step segments and move each segment's
    metrics to the host between segments; state (the Verlet cache and the
    solver carry included) threads through exactly, so a chunked run
    equals an unchunked one. Metrics then come back as numpy arrays.

    ``telemetry``: a :class:`cbf_tpu_torch.obs.TelemetrySink`; each
    segment's host metrics emit the ``t % telemetry_every == 0``
    heartbeats as the segment ends (``obs.tap.emit_ensemble_chunk``),
    each channel reduced across members by the schema's reduction;
    without ``chunk`` they are emitted when the one segment ends.

    ``partition="spatial"`` (one swarm tiled over the mesh) is not ported
    (Queue A10) and raises.

    Returns ((x_final, v_final) — plus theta_final in unicycle mode, plus
    the final solver carry with ``with_solver_state=True`` — with
    (E, N, 2) / (E, N) shapes, EnsembleMetrics of (E, steps) series)."""
    if partition not in ("flat", "spatial"):
        raise ValueError(
            f"partition must be 'flat' or 'spatial', got {partition!r}")
    if partition == "spatial":
        if chunk is not None or with_solver_state:
            raise ValueError(
                "chunk/with_solver_state are flat-partition knobs — the "
                "spatial epoch loop host-offloads per rebin epoch and "
                "carries no solver state")
        raise OutOfSliceError("sharded_swarm_rollout(partition='spatial')",
                              SLICE_PARALLEL)
    steps = cfg.steps if steps is None else steps
    if cbf is None:
        cbf = swarm_scenario.default_cbf(cfg, device=mesh.device)
    unicycle = cfg.dynamics == "unicycle"
    parts = 3 if unicycle else 2
    E = len(seeds)
    n_dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    check_single_device(n_dp, n_sp)
    if E % n_dp or cfg.n % n_sp:
        raise ValueError(
            f"E={E} must divide by dp={n_dp} and N={cfg.n} by sp={n_sp}")
    if cfg.gating == "streaming" and not (
            n_sp == 1 and knn.supported(cfg.n)):
        raise ValueError(
            "gating='streaming' in ensembles requires sp == 1 and N "
            "within the kernels' bound (the forced kernel lives on the "
            "whole-swarm-per-member branch)")
    if cfg.gating == "streaming" and cfg.gating_rebuild_skin:
        raise ValueError(
            "gating_rebuild_skin keeps the auto kernel choice — unset it "
            "or use gating='auto'")
    if cfg.gating_rebuild_skin and (n_sp != 1 or E != n_dp):
        raise ValueError(
            "gating_rebuild_skin in ensembles requires one whole swarm "
            f"per device (E == dp and sp == 1; got E={E}, dp={n_dp}, "
            f"sp={n_sp}): under vmap the Verlet rebuild cond executes "
            "BOTH branches (no saving), and the cached index set needs "
            "the full swarm on-device")
    if cfg.certificate_rebuild_skin:
        raise ValueError(
            "certificate_rebuild_skin is scenario/bench-path only (the "
            "ensemble certificate keeps the exact search); set it to 0 "
            "for sharded rollouts")
    if with_solver_state and not cfg.certificate_warm_start:
        raise ValueError(
            "with_solver_state returns the certificate warm-start carry — "
            "set cfg.certificate_warm_start=True (without it no carry "
            "exists to return)")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    carry = _initial_carry(cfg, mesh, seeds, initial_state)
    step = _rollout_executable(cfg, mesh, E, cbf)

    def member_major(mets, to_host: bool):
        out = EnsembleMetrics(*(torch.swapaxes(m, 0, 1) for m in mets))
        if to_host:
            return EnsembleMetrics(*(m.cpu().numpy() for m in out))
        return out

    def emit(mets_host, t_start):
        if telemetry is not None:
            from cbf_tpu_torch.obs.tap import emit_ensemble_chunk

            emit_ensemble_chunk(telemetry, mets_host, t_start,
                                every=telemetry_every)

    if chunk is None:
        carry, mets = engine.rollout_at(step, carry, steps, t0)
        mets = member_major(mets, to_host=False)
        if telemetry is not None:
            emit(EnsembleMetrics(*(m.cpu().numpy() for m in mets)), t0)
    else:
        host_parts = []
        for t, n in engine.plan_chunks(t0, t0 + steps, chunk):
            carry, mets_c = engine.rollout_at(step, carry, n, t)
            host_parts.append(member_major(mets_c, to_host=True))
            emit(host_parts[-1], t)
        mets = engine.stack_host_chunks(host_parts, axis=1)

    state_out = tuple(carry[:parts])
    if with_solver_state:
        state_out += (carry[-1],)
    return state_out, mets


# ------------------------------------------------------- serving batch ----

# The traced inputs' order in a program's carry: the traced config fields,
# then the padded-bucket count.
TRACED_KEYS = swarm_scenario.TRACED_CONFIG_FIELDS + ("n_active",)


class _Lanes(NamedTuple):
    """A serving program's per-lane inputs, carried unchanged through its
    static buffers (one captured program for any values): the traced
    values in :data:`TRACED_KEYS` order, each (B,); the horizons ``steps``
    (B,) int32; the lane clocks ``t0`` (B,) int32."""
    traced: tuple
    steps: torch.Tensor
    t0: torch.Tensor


@functools.lru_cache(maxsize=64)
def _traced_program(static_cfg: swarm_scenario.Config, cbf, device):
    """The step program the serving programs of ``static_cfg`` share on
    ``device``: ``program((states, lanes), t) -> ((states, lanes),
    StepOutputs of (B, ...))``, lane b stepping at its own clock ``t0_b +
    t`` with its own traced values, frozen (every carry leaf re-selected
    unchanged) once that clock reaches its horizon. Cached, so the engine's
    programs (one per chunk length and batch, on the step) are captured
    once and replayed by every later call."""
    step = swarm_scenario.make_step_traced(static_cfg, cbf, device=device)
    rounds = step.relax_rounds

    def lane(state, traced, steps_i, t0_i, t):
        t_i = t0_i + t
        new, out = step(state, t_i, dict(zip(TRACED_KEYS, traced)))
        live = t_i < steps_i
        return engine._tree_map(lambda a, b: torch.where(live, a, b), new,
                                state), out

    def program(carry, t, inputs=None):
        states, lanes = carry
        new, outs = _over_members(
            lambda st, tr, s_i, t0_i: lane(st, tr, s_i, t0_i, t),
            (states, lanes.traced, lanes.steps, lanes.t0), rounds)
        return (new, lanes), outs

    program.relax_rounds = rounds
    program.admm_blocks = step.admm_blocks
    return program


def _lanes(states, traced, steps, t0) -> _Lanes:
    """The per-lane inputs of one call, on the states' device: ``traced``
    a dict of (B,) values (:func:`cbf_tpu_torch.serve.pack.stack_batch`'s
    keys)."""
    dev = states.x.device
    missing = [k for k in TRACED_KEYS if k not in traced]
    if missing:
        raise ValueError(f"traced lacks {missing}")
    return _Lanes(tuple(torch.as_tensor(traced[k], device=dev)
                        for k in TRACED_KEYS),
                  torch.as_tensor(steps, dtype=torch.int32, device=dev),
                  torch.as_tensor(t0, dtype=torch.int32, device=dev))


def _run_lanes(static_cfg, cbf, states, lanes: _Lanes, n: int):
    """``n`` steps of the serving program from the stacked ``states``.
    Returns (the program's final states — its buffers —, StepOutputs with
    (B, n, ...) leaves, new tensors)."""
    program = _traced_program(static_cfg, cbf, states.x.device)
    carry = (states, lanes)
    prog = engine._program(program, carry, n, 1)
    prog.load(carry)
    prog.run(program, 0)
    outs = engine._tree_map(lambda v: torch.swapaxes(v, 0, 1).clone(),
                            prog.outs)
    return prog.carry[0], outs


def lockstep_traced_rollout(static_cfg: swarm_scenario.Config,
                            horizon: int, *,
                            cbf: CBFParams | None = None,
                            donate_states: bool = True):
    """The serving layer's per-member traced-config program: a micro-batch
    of HETEROGENEOUS requests of one bucket run as one compiled program
    (the batch size is the inputs' leading axis; one captured program per
    (bucket, horizon, B)).

    Each member carries its own traced scalars
    (:func:`swarm.split_static_traced`: radius, gains, dt, ...), its own
    padded-agent count (``n_active``) and its own horizon (``steps``), all
    as per-lane tensors through one program: ``torch.func.vmap`` of
    :func:`swarm.make_step_traced` over the members (the k-NN kernels
    launch once per step for the batch, each member at its own radius).
    The program always runs ``horizon`` steps; a member whose ``steps`` is
    spent FREEZES — its carry is re-selected unchanged — so its later
    StepOutputs rows are repeats the caller trims. Each member has its own
    relax flag; where one is raised the engine redoes the chunk eagerly
    through the same vmapped step (every round, every branch).

    Returns ``run(states, traced, steps) -> (final_states, outs)``:
    ``states`` a member-stacked State ((B, ...) leaves), ``traced`` a dict
    of (B,) values (``split_static_traced``'s keys), ``steps`` (B,) int32;
    ``outs`` StepOutputs of (B, horizon, ...). With ``donate_states`` (the
    default) the final states are written into ``states``' own tensors
    and returned — the buffers are consumed, as JAX's donation allows;
    ``donate_states=False`` leaves them alone and returns new tensors."""
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")

    def run(states, traced, steps):
        B = states.x.shape[0]
        lanes = _lanes(states, traced, steps,
                       torch.zeros(B, dtype=torch.int32))
        final, outs = _run_lanes(static_cfg, cbf, states, lanes, horizon)
        if donate_states:
            engine._tree_map(lambda dst, src: dst.copy_(src), states, final)
            return states, outs
        return engine._tree_map(torch.clone, final), outs

    return run


def prepare_traced_rollout(static_cfg: swarm_scenario.Config, horizon: int,
                           states, traced, steps, *,
                           cbf: CBFParams | None = None):
    """Prepare the program :func:`lockstep_traced_rollout` runs for these
    inputs' shapes (the serve engine's "compile"): on the card a warm-up
    step and the CUDA graph capture of its body, unless an earlier call in
    this process captured it; on the CPU one step that allocates its
    buffers. ``states`` are left as they were. Returns the engine's
    program, whose ``analysis`` holds its measurements
    (:meth:`cbf_tpu_torch.rollout.engine._Program.prepare`)."""
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    B = states.x.shape[0]
    lanes = _lanes(states, traced, steps, torch.zeros(B, dtype=torch.int32))
    program = _traced_program(static_cfg, cbf, states.x.device)
    carry = (states, lanes)
    return engine._program(program, carry, horizon, 1).prepare(
        program, carry, 0)


def lockstep_traced_chunk(static_cfg: swarm_scenario.Config, chunk: int, *,
                          cbf: CBFParams | None = None):
    """The continuous-batching hook: one CHUNK of the program above, each
    lane at its own clock.

    Every lane advances ``chunk`` steps from its own local time ``t0``
    (its step counter is ``t0_b + i``), so one captured program serves
    every chunk boundary of every horizon of the bucket (one per
    (static_cfg, chunk, B)). The horizon mask applies as above: a lane
    whose clock reaches its ``steps`` freezes, so lanes at different
    phases of different horizons — and vacant lanes, ``steps = 0`` —
    share one batch, and a lane's outputs are bit-identical whether it
    joined an in-flight batch at a chunk boundary or ran the same chunks
    with every other lane vacant.

    Returns ``run(states, traced, steps, t0) -> (final_states, outs)``
    with (B, chunk, ...) outputs (the caller slices each lane's live
    prefix). Never donates: a failed chunk must be able to retry from the
    same carry, so ``states`` stay intact and the results are new
    tensors."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    def run(states, traced, steps, t0):
        final, outs = _run_lanes(static_cfg, cbf, states,
                                 _lanes(states, traced, steps, t0), chunk)
        return engine._tree_map(torch.clone, final), outs

    return run
