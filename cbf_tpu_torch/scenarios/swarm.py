"""Scaling scenario: N-agent rendezvous with pairwise-collision CBFs
(counterpart: cbf_tpu/scenarios/swarm.py).

The benchmark ladder's flagship (BASELINE.md: 4096 agents, 10k steps;
north-star metric agent-QP-steps/s). Every agent runs the reference CBF-QP
filter gated on its k nearest in-radius neighbours, and the swarm
rendezvous to a packed disk around its centroid. Velocity slots carry the
actual (previous filtered) velocities.

The port covers every dynamics family — single integrator (continuous or
discrete barrier rows), double integrator (acceleration control, exact
discrete rows), the unicycle (the filter runs on projection points, the
Robotarium step integrates with wheel saturation) and the mixed
single/double swarm (per-agent rows through the filter's per-agent path)
— the obstacle field (closed-form ring or scatter, exact priority rows,
spawn stand-off repair), every gating backend (``gating="pallas"``/
``"streaming"``/``"banded"`` name the hand-written CUDA kernels of
:mod:`cbf_tpu_torch.ops.knn`), the Verlet neighbour cache
(``gating_rebuild_skin``), runtime assurance (``rta``) and the joint
barrier certificate (``certificate``: the dense and the sparse backend,
the latter's Verlet cache, warm start and adaptive budget;
:mod:`cbf_tpu_torch.sim.certificates`). ``unroll_relax`` on the step,
the serving layer's ``active`` mask and the row-partitioned certificate
are later slices' and raise :class:`~cbf_tpu_torch.errors.OutOfSliceError`.

Branches of the reference step that depend on device data (the Verlet
rebuilds and RTA's boosted re-solve are ``lax.cond``s there, the adaptive
certificate budget a ``lax.while_loop``) are taken on the host by the
eager step. Inside the compiled rollout's body
(:func:`cbf_tpu_torch.solvers.exact2d.in_guarded_body`) a rebuild search
runs on every step and a ``torch.where`` on the 0-dim predicate picks
rebuilt or cached — bit-identical to either branch; the adaptive budget
runs ``step.admm_blocks`` selected blocks; and the re-solve is left out.
Where the re-solve would change a row, or the budget would run past its
blocks, the body raises the engine's redo flag and the chunk is run again
by the eager loop.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cbf_tpu_torch.core.filter import CBFParams, safe_controls
from cbf_tpu_torch.errors import (SLICE_DIFF, SLICE_PARALLEL, SLICE_SERVE,
                                  OutOfSliceError)
from cbf_tpu_torch.ops import knn
from cbf_tpu_torch.ops.pairwise import pairwise_distances
from cbf_tpu_torch.rollout.engine import StepOutputs, rollout
from cbf_tpu_torch.rollout.gating import knn_gating
from cbf_tpu_torch.rta.core import (RUNG_BACKUP, RUNG_RESOLVE,
                                    backup_control, demanded_rung,
                                    finite_rows, health_word, latch_update,
                                    rta_seed)
from cbf_tpu_torch.sim import certificates
from cbf_tpu_torch.sim.robotarium import SimParams, unicycle_step
from cbf_tpu_torch.sim.transformations import (si_to_uni_dyn,
                                               uni_to_si_states)
from cbf_tpu_torch.solvers import exact2d
from cbf_tpu_torch.solvers.sparse_admm import SparseADMMSettings
from cbf_tpu_torch.utils.math import l2_cap, safe_norm
from cbf_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class Config:
    """Every field of the JAX ``Config``, same names, defaults and string
    values; see cbf_tpu/scenarios/swarm.py for each field's rationale.
    ``dtype`` is a torch dtype."""
    n: int = 256
    steps: int = 1000
    k_neighbors: int = 8
    safety_distance: float = 0.4      # gating radius, wider than dmin
    consensus_gain: float = 1.0
    pack_spacing: float = 0.14
    dt: float = 0.033
    speed_limit: float = 0.2          # L2 cap on the nominal, pre-filter
    max_speed: float = 15.0
    dyn_scale: float = 0.1
    seed: int = 0
    record_trajectory: bool = False
    n_obstacles: int = 0
    obstacle_orbit_frac: float = 0.6
    obstacle_omega: float = 0.5
    barrier: str = "auto"
    relax_cap: float | None = 0.05
    dynamics: str = "single"
    n_double: int = 0
    accel_limit: float = 1.0
    vel_tracking_tau: float = 0.2
    projection_distance: float = 0.05
    certificate: bool = False
    certificate_pairs: int | None = None
    certificate_backend: str = "auto"
    certificate_k: int = 16
    certificate_rebuild_skin: float = 0.0
    certificate_iters: int | None = None
    certificate_cg_iters: int | None = None
    certificate_warm_start: bool = False
    certificate_tol: float | None = None
    certificate_check_every: int | None = None
    certificate_fused: bool = False
    certificate_partition: str = "auto"
    sep_gain: float = 1.0
    sep_target: float = 0.25
    # "auto": the kernel contract up to knn.MAX_N_BLOCKED (fused kernel to
    # MAX_N_FUSED, streaming beyond), else the dense path; "pallas" and
    # "streaming" force the kernels (streaming below the fused bound);
    # "jnp" the dense sort-based path; "banded" the O(N*W) y-sorted kernel
    # (window: gating_window_blocks, else banded_window_blocks' rule).
    gating: str = "auto"
    gating_window_blocks: int | None = None
    gating_rebuild_skin: float = 0.0
    spawn: str = "grid"
    goal: str = "rendezvous"
    obstacle_layout: str = "orbit"
    dtype: torch.dtype = torch.float32
    spawn_half_width_override: float | None = None
    arena_half_override: float | None = None
    rta: bool = False
    rta_recover_steps: int = 10
    rta_residual_gate: float = 1e-4
    rta_deficit_gate: float = 0.15
    rta_boost_budget: int = 128

    @property
    def spawn_half_width(self) -> float:
        # Spawn box grows with sqrt(N): grid spacing ~0.4 m > the 0.2 m
        # danger radius, outside the packing radius.
        if self.spawn_half_width_override is not None:
            return float(self.spawn_half_width_override)
        return max(1.5, 0.2 * float(np.sqrt(self.n)))

    @property
    def pack_radius(self) -> float:
        return self.pack_spacing * float(np.sqrt(self.n))


class State(NamedTuple):
    x: torch.Tensor      # (N, 2) positions (body centres in unicycle mode)
    v: torch.Tensor      # (N, 2) last applied (si) velocities
    # (N,) headings, unicycle mode only; () otherwise.
    theta: torch.Tensor | tuple = ()
    # Verlet cache, gating_rebuild_skin > 0 only: (idx (N, Kc) int32 —
    # the k-NN at build time under the inflated radius, x_build (N, 2),
    # dropped () int32 — build-time truncation vs the build radius,
    # min_dkth () — min over truncating agents of their k-th kept build
    # distance, which makes the between-rebuild floor metric sound).
    gating_cache: tuple = ()
    # The certificate's Verlet cache, certificate_rebuild_skin > 0 only:
    # (idx (N, kc) int32, x_build (N, 2), dropped () int32).
    certificate_cache: tuple = ()
    # The sparse ADMM's warm carry, certificate_warm_start only: (x (2N,),
    # z_p (R,), z_b (2N,), y_p (R,), y_b (2N,)), seeded all-zero.
    certificate_solver_state: tuple = ()
    # RTA carry, rta=True only: (mode (N,) int32 latched rung, streak (N,)
    # int32 consecutive healthy steps, lkg_x, lkg_v, lkg_theta | ()).
    rta: tuple = ()


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one, raise and tell the caller to
    pass ``device="cpu"`` — never carry on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; the port runs on the card by "
            "default — pass device='cpu' to run on the CPU")
    return dev


def spawn_layout(cfg: Config) -> tuple[np.ndarray, float]:
    """Host-side un-jittered spawn layout: ((N, 2) base positions, jitter
    spacing). Every layout keeps base spacing >= 0.4 m with jitter <=
    0.25*spacing, so the worst post-jitter gap stays >= 0.2 m."""
    n, half = cfg.n, cfg.spawn_half_width
    if cfg.spawn == "grid":
        side = int(np.ceil(np.sqrt(n)))
        lin = np.linspace(-half, half, side)
        gx, gy = np.meshgrid(lin, lin)
        grid = np.stack([gx.ravel(), gy.ravel()], axis=1)[:n]
        return grid, 2 * half / max(side - 1, 1)
    if cfg.spawn == "ring":
        radius = max(half, 0.4 * n / (2 * np.pi))
        th = 2 * np.pi * np.arange(n) / n
        ring = radius * np.stack([np.cos(th), np.sin(th)], axis=1)
        return ring, 2 * np.pi * radius / n
    if cfg.spawn == "clusters":
        m = int(np.ceil(n / 4))
        side = max(int(np.ceil(np.sqrt(m))), 1)
        extent = 0.2 * (side - 1)
        c = max(0.55 * half, extent + 0.4)
        lin = 0.4 * (np.arange(side) - (side - 1) / 2.0)
        gx, gy = np.meshgrid(lin, lin)
        sub = np.stack([gx.ravel(), gy.ravel()], axis=1)
        centers = np.array([[c, c], [-c, c], [-c, -c], [c, -c]])
        rows = [sub[i // 4] + centers[i % 4] for i in range(n)]
        return np.stack(rows, axis=0), 0.4
    if cfg.spawn == "corridor":
        lanes = max(int(np.ceil(np.sqrt(n))), 1)
        j = np.arange(n)
        x = -half - 0.4 * (j // lanes)
        y = 0.4 * (j % lanes - (lanes - 1) / 2.0)
        return np.stack([x, y], axis=1), 0.4
    raise ValueError(
        f"spawn must be grid|ring|clusters|corridor, got {cfg.spawn!r}")


def goal_layout(cfg: Config) -> np.ndarray | None:
    """Host-side (N, 2) per-agent goals, or None for the default
    rendezvous (closed-loop centroid consensus)."""
    n, half = cfg.n, cfg.spawn_half_width
    if cfg.goal == "rendezvous":
        return None
    if cfg.goal == "coverage":
        side = int(np.ceil(np.sqrt(n)))
        lin = np.linspace(-half, half, side)
        gx, gy = np.meshgrid(lin, lin)
        return np.stack([gx.ravel(), gy.ravel()], axis=1)[:n]
    if cfg.goal == "formation":
        radius = max(1.0, 0.3 * n / (2 * np.pi))
        th = 2 * np.pi * np.arange(n) / n
        return radius * np.stack([np.cos(th), np.sin(th)], axis=1)
    if cfg.goal == "corridor":
        lanes = max(int(np.ceil(np.sqrt(n))), 1)
        j = np.arange(n)
        x = half + 0.4 * (j // lanes)
        y = 0.4 * (j % lanes - (lanes - 1) / 2.0)
        return np.stack([x, y], axis=1)
    raise ValueError(
        f"goal must be rendezvous|coverage|corridor|formation, "
        f"got {cfg.goal!r}")


def spawn_positions(cfg: Config, seed: int, *, device=None):
    """Seeded collision-free (N, 2) start: :func:`spawn_layout` plus a
    float32 jitter of up to 0.25x the layout spacing, drawn on the CPU
    from a ``torch.Generator`` seeded with ``seed`` (so every device gets
    the same spawn). The stream differs from the JAX package's threefry
    one; tests carry a JAX state across with :mod:`cbf_tpu_torch.convert`
    instead."""
    grid, spacing = spawn_layout(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    lo = np.float32(-0.25 * spacing)
    hi = np.float32(0.25 * spacing)
    u = torch.rand((cfg.n, 2), generator=gen, dtype=torch.float32)
    jitter = u * float(hi - lo) + float(lo)
    x0 = torch.as_tensor(grid, dtype=cfg.dtype) + jitter.to(cfg.dtype)
    return x0.to(resolve_device(device))


def _orbit_ring(cfg: Config, t):
    """The closed-form obstacle field law for ``cfg.obstacle_layout`` at
    step ``t`` (a 0-dim tensor in the working dtype; the arithmetic
    follows the reference's grouping of Python-float products, so each
    product is rounded where JAX rounds it). "orbit" is the rotating ring,
    "static" that ring frozen at t=0, "scatter" a seed-free golden-angle
    spiral through the packing disk; the last two have zero velocity.
    Returns (pos (M, 2), vel (M, 2))."""
    M = cfg.n_obstacles
    k = torch.arange(M, dtype=t.dtype, device=t.device)
    if cfg.obstacle_layout == "scatter":
        r = (cfg.obstacle_orbit_frac * cfg.pack_radius
             * torch.sqrt((k + 0.5) / M))
        ang = (k + 0.5) * 2.39996322972865332  # golden angle (rad)
        pos = torch.stack([r * torch.cos(ang), r * torch.sin(ang)], dim=1)
        return pos, torch.zeros_like(pos)
    phases = k * (2 * np.pi / M)
    r = cfg.obstacle_orbit_frac * cfg.pack_radius
    if cfg.obstacle_layout == "static":
        pos = r * torch.stack([torch.cos(phases), torch.sin(phases)], dim=1)
        return pos, torch.zeros_like(pos)
    ang = phases + cfg.obstacle_omega * cfg.dt * t
    pos = r * torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
    vel = (cfg.obstacle_omega * r
           * torch.stack([-torch.sin(ang), torch.cos(ang)], dim=1))
    return pos, vel


def _host_obstacle_rows(cfg: Config, t, dtype):
    pos, vel = _orbit_ring(cfg, torch.tensor(float(t), dtype=dtype))
    return torch.cat([pos, vel], dim=1)


def obstacle_states_at(cfg: Config, t, dtype, *, device=None):
    """(M, 4) obstacle rows [x y vx vy] at step ``t``, computed on the host
    in ``dtype`` (a dozen closed-form rows: no device work, and the card
    and the CPU see the same obstacles) and copied to ``device`` without
    waiting for the device's queue."""
    return _host_obstacle_rows(cfg, t, dtype).to(resolve_device(device),
                                                 non_blocking=True)


def obstacle_table(cfg: Config, t0: int, n: int, dtype):
    """(n, M, 4) host rows of steps t0..t0+n-1, each row computed as
    :func:`obstacle_states_at` computes it, so a step that gathers its row
    from this table sees the same bits as one that asks per step."""
    return torch.stack([_host_obstacle_rows(cfg, t, dtype)
                        for t in range(t0, t0 + n)])


def obstacle_positions_at(cfg: Config, t: float) -> np.ndarray:
    """Host-side (M, 2) float64 obstacle positions at step ``t``."""
    pos, _ = _orbit_ring(cfg, torch.tensor(float(t), dtype=torch.float64))
    return pos.numpy()


def lane_dodge(x, obstacles4, safety_distance):
    """Sideways-out-of-the-lane nominal bias and the (N, M) agent-obstacle
    distances it is derived from: each agent inside an obstacle's gating
    radius is pushed to whichever side of the obstacle's travel lane it
    already is, so a fast obstacle empties its lane instead of squeezing
    the crowd along it. Returns (dodge (N, 2), d_o (N, M))."""
    rel = x[:, None, :] - obstacles4[None, :, :2]          # (N, M, 2)
    d_o = torch.linalg.norm(rel, dim=-1)                   # (N, M)
    ov = obstacles4[:, 2:]
    lane = ov / torch.clamp(torch.linalg.norm(ov, dim=1, keepdim=True),
                            min=1e-9)
    perp = torch.stack([-lane[:, 1], lane[:, 0]], dim=1)   # (M, 2)
    side = torch.sign(torch.sum(rel * perp[None], dim=-1) + 1e-9)
    w = torch.clamp(safety_distance - d_o, min=0.0)        # (N, M)
    dodge = torch.sum((w * side)[..., None] * perp[None], dim=1)
    return dodge, d_o


def attach_obstacle_rows(obs_slab, mask, obstacles4, d_o, safety_distance):
    """Append the exact obstacle slab to a k-NN agent slab: obstacles never
    go through k-NN truncation, and they are the PRIORITY rows of the
    tiered relaxation (a boxed-in agent yields inter-agent spacing before
    obstacle clearance).

    Args: obs_slab (N, K, 4), mask (N, K), obstacles4 (M, 4), d_o (N, M)
    (from :func:`lane_dodge`). Returns (obs_slab (N, K+M, 4), mask
    (N, K+M), priority (N, K+M))."""
    n = obs_slab.shape[0]
    ob_mask = d_o < safety_distance
    ob_slab = obstacles4[None].expand((n,) + tuple(obstacles4.shape))
    priority = torch.cat([torch.zeros_like(mask), torch.ones_like(ob_mask)],
                         dim=1)
    return (torch.cat([obs_slab, ob_slab], dim=1),
            torch.cat([mask, ob_mask], dim=1), priority)


# Rows per slice of clear_obstacle_spawn's pairwise repair: bounds its
# (rows, N, 2) temporaries; each row's sum is the same whatever the slice.
_REPAIR_ROWS = 2048


def clear_obstacle_spawn(cfg: Config, x0):
    """Push spawned agents radially off their nearest obstacle to at least
    a 0.25 m stand-off. The monotone radius map r -> 0.25 + 0.6 r keeps
    same-disk agents in radial order (a projection onto the 0.25 circle
    would stack them); 20 rounds of symmetric pairwise repair (each
    too-close pair moves apart by half its deficit) interleaved with the
    push, then a last repair, settle every pair above 0.25 m. No-op
    without obstacles."""
    if not cfg.n_obstacles:
        return x0
    n = x0.shape[0]
    opos = torch.as_tensor(obstacle_positions_at(cfg, 0.0), dtype=x0.dtype,
                           device=x0.device)
    rows = torch.arange(n, device=x0.device)

    def obstacle_push(x):
        diff = x[:, None, :] - opos[None, :, :]                # (N, M, 2)
        d = torch.linalg.norm(diff, dim=-1)
        j = torch.argmin(d, dim=1)
        dn = d[rows, j]
        dirn = diff[rows, j] / torch.clamp(dn, min=1e-6)[:, None]
        r_new = 0.25 + 0.6 * dn
        return x + torch.where(dn < 0.25, r_new - dn, 0.0)[:, None] * dirn

    def pairwise_repair(x):
        push = torch.empty_like(x)
        for r0 in range(0, n, _REPAIR_ROWS):
            r1 = min(n, r0 + _REPAIR_ROWS)
            diff = x[r0:r1, None, :] - x[None, :, :]           # (R, N, 2)
            d = torch.linalg.norm(diff, dim=-1)
            d[rows[:r1 - r0], rows[r0:r1]] += 1e9
            deficit = torch.clamp(0.25 - d, min=0.0) / 2.0
            push[r0:r1] = torch.sum(
                deficit[..., None] * diff
                / torch.clamp(d, min=1e-6)[..., None], dim=1)
        return x + push

    x0 = obstacle_push(x0)
    for _ in range(20):
        x0 = pairwise_repair(x0)
        x0 = obstacle_push(x0)
    return pairwise_repair(x0)


def dynamics_mask(cfg: Config, *, device=None) -> torch.Tensor:
    """(N,) bool — True rows are the double-integrator agents of a
    ``dynamics="mixed"`` swarm: agents ``[0, n_double)``."""
    return torch.arange(cfg.n, device=resolve_device(device)) < cfg.n_double


def _heading_seed(seed: int) -> int:
    """The headings' generator seed: derived from (seed, 1) by a hash,
    so member i's headings never alias member i+1's spawn jitter in a
    consecutive-seed ensemble (the reason JAX takes ``fold_in``)."""
    return int(np.random.SeedSequence((int(seed), 1)).generate_state(
        1, dtype=np.uint64)[0])


def heading_spawn(cfg: Config, seed, *, device=None) -> torch.Tensor:
    """(N,) seeded initial headings in [-pi, pi), drawn in float32 on the
    CPU from a ``torch.Generator`` of their own (:func:`_heading_seed`).
    The stream differs from the JAX package's; tests carry JAX's headings
    across with :mod:`cbf_tpu_torch.convert`."""
    gen = torch.Generator().manual_seed(_heading_seed(seed))
    lo, hi = np.float32(-np.pi), np.float32(np.pi)
    u = torch.rand((cfg.n,), generator=gen, dtype=torch.float32)
    theta = u * float(hi - lo) + float(lo)
    return theta.to(cfg.dtype).to(resolve_device(device))


def projection_points(cfg: Config, body_xy, theta):
    """(N, 2) si projection points ``projection_distance`` ahead of the
    wheel axis (the row-major twin of ``uni_to_si_states``)."""
    return body_xy + cfg.projection_distance * torch.stack(
        [torch.cos(theta), torch.sin(theta)], dim=1)


def verlet_cache_seed(cfg: Config, *, device=None):
    """Fresh Verlet cache (see ``State.gating_cache``): x_build = +inf
    forces a rebuild on the first step, so the zero seeds are never
    read."""
    dev = resolve_device(device)
    kc = min(cfg.k_neighbors, cfg.n - 1)
    return (torch.zeros((cfg.n, kc), dtype=torch.int32, device=dev),
            torch.full((cfg.n, 2), torch.inf, dtype=cfg.dtype, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=cfg.dtype, device=dev))


def initial_state(cfg: Config, *, device=None) -> State:
    x0 = clear_obstacle_spawn(cfg, spawn_positions(cfg, cfg.seed,
                                                   device=device))
    theta0 = ()
    if cfg.dynamics == "unicycle":
        theta0 = heading_spawn(cfg, cfg.seed, device=device)
    cache = (verlet_cache_seed(cfg, device=device)
             if cfg.gating_rebuild_skin else ())
    dev = x0.device
    ccache = (certificates.certificate_cache_seed(
        cfg.n, cfg.certificate_k, cfg.dtype, device=dev)
        if cfg.certificate_rebuild_skin else ())
    sstate = (certificates.certificate_solver_seed(
        cfg.n, cfg.certificate_k, cfg.dtype, device=dev)
        if cfg.certificate_warm_start else ())
    rta = rta_seed(x0, torch.zeros_like(x0), theta0) if cfg.rta else ()
    return State(x=x0, v=torch.zeros_like(x0), theta=theta0,
                 gating_cache=cache, certificate_cache=ccache,
                 certificate_solver_state=sstate, rta=rta)


def certificate_backend(cfg: Config) -> str:
    """Resolve Config.certificate_backend ("auto" -> dense to n=128,
    sparse beyond)."""
    if cfg.certificate_backend == "auto":
        return "dense" if cfg.n <= 128 else "sparse"
    return cfg.certificate_backend


def _certificate_problem(cfg: Config):
    """(CertificateParams, arena) of the joint second layer: the nominal
    pre-limit at ``speed_limit``, a square arena of half-width
    ``arena_half_override`` or 1.5x the spawn half-width."""
    half = (cfg.arena_half_override if cfg.arena_half_override is not None
            else cfg.spawn_half_width * 1.5)
    return (certificates.CertificateParams(magnitude_limit=cfg.speed_limit),
            (-half, half, -half, half))


def _certificate_settings(cfg: Config):
    """SparseADMMSettings from the Config budget knobs (the fused path
    pairs with the Chebyshev x-update)."""
    d = SparseADMMSettings()

    def pick(value, default):
        return default if value is None else value

    return SparseADMMSettings(
        iters=pick(cfg.certificate_iters, d.iters),
        cg_iters=pick(cfg.certificate_cg_iters, d.cg_iters),
        tol=pick(cfg.certificate_tol, d.tol),
        check_every=pick(cfg.certificate_check_every, d.check_every),
        fused=cfg.certificate_fused,
        ksolve="chebyshev" if cfg.certificate_fused else d.ksolve)


def apply_certificate(cfg: Config, u, x, neighbor_cache=None,
                      solver_state=None):
    """The joint second layer over already-filtered si velocities u
    (N, 2) at positions x (N, 2). Returns (u_certified (N, 2),
    primal_residual, dropped_count int32 — the sparse backend's k-slot
    truncation, 0 on the dense backend —, iterations int32 — the ADMM
    iterations run, 0 on the dense backend), plus a trailing new_cache
    when ``neighbor_cache`` is given (certificate_rebuild_skin) and a
    trailing new_solver_state when ``solver_state`` is given
    (certificate_warm_start)."""
    params, arena = _certificate_problem(cfg)
    if certificate_backend(cfg) == "sparse":
        out = certificates.si_barrier_certificate_sparse(
            u.T, x.T, params, settings=_certificate_settings(cfg),
            k=cfg.certificate_k, with_info=True, arena=arena,
            rebuild_skin=(cfg.certificate_rebuild_skin
                          if neighbor_cache is not None else 0.0),
            neighbor_cache=neighbor_cache, solver_state=solver_state)
        u_cert, cinfo = out[0], out[1]
        return (u_cert.T, cinfo.primal_residual, cinfo.dropped_count,
                cinfo.iterations) + tuple(out[2:])
    pairs = (cfg.certificate_pairs if cfg.certificate_pairs is not None
             else 8 * cfg.n)
    u_cert, cinfo = certificates.si_barrier_certificate(
        u.T, x.T, params, max_pairs=pairs, with_info=True, arena=arena)
    zero = torch.zeros((), dtype=torch.int32, device=u.device)
    return u_cert.T, cinfo.primal_residual, zero, zero


def apply_certificate_batched(cfg: Config, u, x, solver_state=None):
    """Lockstep-batched twin of :func:`apply_certificate` (sparse backend
    only): u, x (E, N, 2), ``solver_state`` an optional batched warm carry.
    Returns (u_certified (E, N, 2), primal_residual (E,), dropped (E,)
    int32, iterations (E,) int32)[, new_solver_state]."""
    if certificate_backend(cfg) != "sparse":
        raise ValueError(
            "apply_certificate_batched is sparse-backend only (the dense "
            "solver has no lockstep driver); resolved backend is "
            f"{certificate_backend(cfg)!r}")
    params, arena = _certificate_problem(cfg)
    out = certificates.si_barrier_certificate_sparse_batched(
        torch.swapaxes(u, 1, 2), torch.swapaxes(x, 1, 2), params,
        settings=_certificate_settings(cfg), k=cfg.certificate_k,
        with_info=True, arena=arena, solver_state=solver_state)
    u_cert, cinfo = out[0], out[1]
    ret = (torch.swapaxes(u_cert, 1, 2), cinfo.primal_residual,
           cinfo.dropped_count, cinfo.iterations)
    if solver_state is not None and solver_state != ():
        ret += (out[2],)
    return ret


def apply_certificate_sharded(cfg: Config, u, x, axis_name: str):
    """The row-partitioned twin (sp-sharded ensembles): not ported yet."""
    raise OutOfSliceError("apply_certificate_sharded", SLICE_PARALLEL)


def validate_config(cfg: Config) -> None:
    """Raise ValueError on invalid knob combinations — the JAX package's
    checks, unchanged. (Valid knobs of later slices raise
    OutOfSliceError when a step is built.)"""
    if cfg.dynamics not in ("single", "double", "unicycle", "mixed"):
        raise ValueError(f"dynamics must be single|double|unicycle|mixed, "
                         f"got {cfg.dynamics!r}")
    if cfg.n_double and cfg.dynamics != "mixed":
        raise ValueError(f'n_double={cfg.n_double} needs dynamics="mixed" '
                         f"(got {cfg.dynamics!r})")
    if cfg.dynamics == "mixed" and not 0 < cfg.n_double <= cfg.n:
        raise ValueError(
            f'dynamics="mixed" needs 0 < n_double <= n, got '
            f"n_double={cfg.n_double} with n={cfg.n} (use "
            f'dynamics="single" for a homogeneous swarm)')
    if cfg.spawn not in ("grid", "ring", "clusters", "corridor"):
        raise ValueError(
            f"spawn must be grid|ring|clusters|corridor, got {cfg.spawn!r}")
    if cfg.goal not in ("rendezvous", "coverage", "corridor", "formation"):
        raise ValueError(f"goal must be rendezvous|coverage|corridor|"
                         f"formation, got {cfg.goal!r}")
    if cfg.obstacle_layout not in ("orbit", "static", "scatter"):
        raise ValueError(f"obstacle_layout must be orbit|static|scatter, "
                         f"got {cfg.obstacle_layout!r}")
    if cfg.obstacle_layout != "orbit" and not cfg.n_obstacles:
        raise ValueError(f"obstacle_layout={cfg.obstacle_layout!r} needs "
                         "n_obstacles > 0")
    if cfg.certificate and cfg.dynamics in ("double", "mixed"):
        raise ValueError("certificate=True filters VELOCITY commands; "
                         "double/mixed modes output accelerations — the "
                         "combination is not meaningful")
    if cfg.certificate and cfg.n_obstacles:
        raise ValueError("certificate=True with moving obstacles is "
                         "rejected: the joint certificate is obstacle-blind")
    if cfg.certificate and cfg.certificate_backend not in ("auto", "dense",
                                                           "sparse"):
        raise ValueError(f"certificate_backend must be auto|dense|sparse, "
                         f"got {cfg.certificate_backend!r}")
    if cfg.certificate and cfg.certificate_partition not in ("auto",
                                                             "replicate"):
        raise ValueError(f"certificate_partition must be auto|replicate, "
                         f"got {cfg.certificate_partition!r}")
    sparse_only = {
        "certificate_rebuild_skin": bool(cfg.certificate_rebuild_skin),
        "certificate_iters/certificate_cg_iters": (
            cfg.certificate_iters is not None
            or cfg.certificate_cg_iters is not None),
        "certificate_warm_start/certificate_tol": (
            cfg.certificate_warm_start or cfg.certificate_tol is not None),
        "certificate_fused": cfg.certificate_fused,
    }
    if cfg.certificate_rebuild_skin < 0:
        raise ValueError("certificate_rebuild_skin must be >= 0")
    for knob, on in sparse_only.items():
        if not on:
            continue
        if not cfg.certificate:
            raise ValueError(f"{knob} needs certificate=True")
        if certificate_backend(cfg) != "sparse":
            raise ValueError(
                f"{knob} applies to the SPARSE certificate backend; the "
                f"resolved backend here is {certificate_backend(cfg)!r} — "
                "set certificate_backend='sparse'")
    if cfg.certificate_tol is not None and cfg.certificate_tol <= 0:
        raise ValueError(
            f"certificate_tol must be > 0, got {cfg.certificate_tol}")
    if cfg.certificate_check_every is not None:
        if cfg.certificate_tol is None:
            raise ValueError("certificate_check_every tunes the ADAPTIVE "
                             "budget — set certificate_tol too")
        if cfg.certificate_check_every < 1:
            raise ValueError(f"certificate_check_every must be >= 1, got "
                             f"{cfg.certificate_check_every}")
    if (cfg.certificate and cfg.certificate_pairs is not None
            and certificate_backend(cfg) == "sparse"):
        raise ValueError("certificate_pairs tunes the DENSE backend; the "
                         "resolved backend here is sparse — set "
                         "certificate_k instead")
    if cfg.certificate:
        side = 2 * (cfg.arena_half_override
                    if cfg.arena_half_override is not None
                    else 1.5 * cfg.spawn_half_width)
        if side * side < 2.0 * cfg.n * 0.12 * 0.12:
            raise ValueError(
                f"certificate boundary box ({side:.2f} m square) cannot "
                f"contain n={cfg.n} agents at the certified 0.12 m spacing")
    if cfg.dynamics == "unicycle":
        if not cfg.projection_distance > 0:
            raise ValueError(f"unicycle dynamics needs projection_distance "
                             f"> 0, got {cfg.projection_distance}")
        p = SimParams(dt=cfg.dt)
        vmax = p.wheel_radius * p.max_wheel_speed
        if cfg.speed_limit > vmax + 1e-9:
            raise ValueError(
                f"unicycle speed_limit {cfg.speed_limit} exceeds the "
                f"wheel-realizable max {vmax:.3f}")
    if cfg.rta:
        if cfg.rta_recover_steps < 1:
            raise ValueError(f"rta_recover_steps must be >= 1, got "
                             f"{cfg.rta_recover_steps}")
        if not cfg.rta_residual_gate > 0:
            raise ValueError(f"rta_residual_gate must be > 0, got "
                             f"{cfg.rta_residual_gate}")
        if not cfg.rta_deficit_gate > 0:
            raise ValueError(f"rta_deficit_gate must be > 0, got "
                             f"{cfg.rta_deficit_gate}")
        if cfg.rta_boost_budget < 1:
            raise ValueError(f"rta_boost_budget must be >= 1, got "
                             f"{cfg.rta_boost_budget}")
    if cfg.barrier not in ("auto", "continuous", "discrete"):
        raise ValueError(
            f"barrier must be auto|continuous|discrete, got {cfg.barrier!r}")
    if cfg.dynamics in ("double", "mixed"):
        if cfg.barrier == "continuous":
            raise ValueError(
                f"dynamics={cfg.dynamics!r} uses exact discrete-time rows; "
                'barrier="continuous" is not meaningful for it')
        if not (cfg.accel_limit > 0 and cfg.vel_tracking_tau > 0):
            raise ValueError(
                f"{cfg.dynamics} dynamics needs accel_limit > 0 and "
                f"vel_tracking_tau > 0, got {cfg.accel_limit}, "
                f"{cfg.vel_tracking_tau}")


def reject_out_of_slice(cfg: Config, *, unroll_relax: int = 0,
                        active=None) -> None:
    """Raise OutOfSliceError for every valid knob this slice does not
    port — never ignore one silently."""
    later = [
        (unroll_relax > 0, f"unroll_relax={unroll_relax} on the step",
         SLICE_DIFF),
        (active is not None, "the serving layer's active mask",
         SLICE_SERVE),
    ]
    for hit, what, slice_name in later:
        if hit:
            raise OutOfSliceError(what, slice_name)


def barrier_dynamics(cfg: Config, dtype, validate: bool = True, *,
                     device=None):
    """(f, g, discrete) for the configured dynamics and barrier
    discretization.

    double: the exact discrete rows of the semi-implicit update, f = dt *
    (pos <- vel), g = [[dt^2 I], [dt I]]. mixed: per-agent f (N, 4, 4) and
    g (N, 4, 2), double rows as above and single rows g = dt * [[I], [0]]
    (:func:`dynamics_mask`), which route the filter through its per-agent
    path. single and unicycle: "continuous" gives the reference's rows
    (f = 0, g = dyn_scale * I on the position slots), "discrete" f = dt *
    (pos <- vel), g = dt * I — the exact discrete-time CBF condition
    h_{k+1} >= (1-gamma) h_k; "auto" = discrete when obstacles are
    present, else continuous."""
    if validate:
        validate_config(cfg)
    dev = resolve_device(device)

    def rows(values):
        return torch.tensor(values, dtype=dtype, device=dev)

    coupling = rows([[0, 0, 1, 0], [0, 0, 0, 1], [0, 0, 0, 0], [0, 0, 0, 0]])
    if cfg.dynamics in ("double", "mixed"):
        dt = cfg.dt
        f = dt * coupling
        g_dbl = (rows([[1, 0], [0, 1], [1, 0], [0, 1]])
                 * rows([dt * dt, dt * dt, dt, dt])[:, None])
        if cfg.dynamics == "double":
            return f, g_dbl, True
        m = dynamics_mask(cfg, device=dev)
        g_sgl = dt * rows([[1, 0], [0, 1], [0, 0], [0, 0]])
        return (f[None].expand(cfg.n, 4, 4),
                torch.where(m[:, None, None], g_dbl[None], g_sgl[None]), True)
    discrete = (cfg.n_obstacles > 0 if cfg.barrier == "auto"
                else cfg.barrier == "discrete")
    scale = cfg.dt if discrete else cfg.dyn_scale
    g = scale * rows([[1, 0], [0, 1], [0, 0], [0, 0]])
    f = (cfg.dt * coupling if discrete
         else cfg.dyn_scale * torch.zeros((4, 4), dtype=dtype, device=dev))
    return f, g, discrete


def default_cbf(cfg: Config, *, device=None) -> CBFParams:
    """The scenario's filter parameters per dynamics family.

    single — k = 0: the position-only barrier h = |dx|+|dy| - dmin (at
    crowd scale the reference's k = 1 feeds evasive outputs back into the
    next step's h; with k = 0 h contracts geometrically to 0 and never
    crosses it). double — k = 1, the velocity term that gives an
    acceleration authority over the barrier; max_speed is the box on
    |a| (accel_limit). unicycle — the box at speed_limit, the
    wheel-realizable command. mixed — (N,) leaves on ``device``: each row
    its family's box bound and velocity term."""
    if cfg.dynamics == "double":
        return CBFParams(max_speed=cfg.accel_limit, k=1.0)
    if cfg.dynamics == "mixed":
        m = dynamics_mask(cfg, device=device)
        return CBFParams(
            max_speed=torch.where(m, cfg.accel_limit,
                                  cfg.max_speed).to(cfg.dtype),
            k=torch.where(m, 1.0, 0.0).to(cfg.dtype))
    if cfg.dynamics == "unicycle":
        return CBFParams(max_speed=cfg.speed_limit, k=0.0)
    return CBFParams(max_speed=cfg.max_speed, k=0.0)


def separation_bias(cfg: Config, x, obs_slab, mask):
    """Double mode: the short-range separation term of the nominal
    velocity field, from the agent slab (before obstacle rows are
    attached): pairs closer than ``sep_target`` push apart, so the packed
    core decompresses through the QP instead of freezing below the floor.
    Returns an (N, 2) bias, capped later with the rest of the nominal."""
    rel = x[:, None, :] - obs_slab[..., :2]               # (N, K, 2)
    d = safe_norm(rel)                                    # (N, K)
    w = torch.where(mask, torch.clamp(cfg.sep_target - d, min=0.0), 0.0)
    return cfg.sep_gain * torch.sum(
        (w / torch.clamp(d, min=1e-9))[..., None] * rel, dim=1)


def nominal_accel(cfg: Config, u_cmd, v):
    """Double mode: the velocity-tracking PD turns the nominal velocity
    field into a nominal acceleration, L2-capped at the actuator limit."""
    return l2_cap((u_cmd - v) / cfg.vel_tracking_tau, cfg.accel_limit)


def complete_nominal(cfg: Config, u0, x, v, obs_slab, mask):
    """Finish the nominal after gating: the separation term of double
    rows (it needs the agent slab), the L2 speed cap, then the double
    rows' conversion to an acceleration. A mixed swarm's single rows keep
    the homogeneous swarm's nominal bit for bit."""
    double = cfg.dynamics == "double"
    mixed = cfg.dynamics == "mixed"
    dmask = dynamics_mask(cfg, device=x.device) if mixed else None
    if (double or mixed) and cfg.sep_gain:
        bias = separation_bias(cfg, x, obs_slab, mask)
        if mixed:
            bias = torch.where(dmask[:, None], bias, 0.0)
        u0 = u0 + bias
    u0 = l2_cap(u0, cfg.speed_limit)
    if double:
        u0 = nominal_accel(cfg, u0, v)
    elif mixed:
        u0 = torch.where(dmask[:, None], nominal_accel(cfg, u0, v), u0)
    return u0


def relax_tiers(cfg: Config, mask, priority):
    """(priority_mask, relax_cap). double, unicycle and mixed: every row
    in the one eps tier, no cap — their per-step barrier authority is
    actuation-bounded, so the reference's +1 relax would neuter rows in a
    round. single: obstacle rows (when present) are the priority tier and
    agent rows carry ``relax_cap``."""
    if cfg.dynamics in ("double", "unicycle", "mixed"):
        return (torch.ones_like(mask) if priority is None
                else torch.ones_like(priority)), None
    return priority, (cfg.relax_cap if cfg.n_obstacles else None)


def banded_window_blocks(cfg: Config) -> int:
    """``gating="banded"``'s window in CTILE column blocks:
    ``gating_window_blocks``, else the density rule at the packed (densest)
    state — agents whose y lies within +-safety_distance of a 256-row band
    of the y-sorted order, the packed disk's density assumed uniform."""
    if cfg.gating_window_blocks is not None:
        return cfg.gating_window_blocks
    band = cfg.n * 2.0 * cfg.safety_distance / max(2.0 * cfg.pack_radius,
                                                   1e-6)
    return int(np.ceil((band + 2 * knn.RTILE) / knn.CTILE)) + 1


def unicycle_apply(cfg: Config, body_xy, theta, u_si):
    """Apply filtered si velocities to the unicycle fleet: map to
    (v, omega) through the projection point, one saturated unicycle step,
    and the new projection points. Returns (body_xy' (N, 2), theta' (N,),
    p' (N, 2))."""
    poses = torch.stack([body_xy[:, 0], body_xy[:, 1], theta])    # (3, N)
    dxu = si_to_uni_dyn(u_si.T, poses, cfg.projection_distance)
    new_poses = unicycle_step(poses, dxu, SimParams(dt=cfg.dt))
    p_new = uni_to_si_states(new_poses, cfg.projection_distance).T
    return (torch.stack([new_poses[0], new_poses[1]], dim=1), new_poses[2],
            p_new)


def integrate(cfg: Config, x, v, u):
    """(x_new, v_new): semi-implicit Euler in double mode (the update the
    barrier rows discretize exactly), the first-order update in single
    mode, and their per-row blend in a mixed swarm."""
    if cfg.dynamics == "double":
        v_new = v + cfg.dt * u
        return x + cfg.dt * v_new, v_new
    if cfg.dynamics == "mixed":
        m = dynamics_mask(cfg, device=x.device)[:, None]
        v_dbl = v + cfg.dt * u
        return (torch.where(m, x + cfg.dt * v_dbl, x + cfg.dt * u),
                torch.where(m, v_dbl, u))
    return x + cfg.dt * u, u


def verlet_gating(cfg: Config, x, states4, cache, K: int, use_kernel: bool,
                  not_self=None):
    """One Verlet-cached gating step (``gating_rebuild_skin``).

    The k-NN is rebuilt under the inflated radius r_build = safety_distance
    + skin only when some agent has moved more than skin/2 since the last
    build (then every pair now within safety_distance was within r_build
    at build time); otherwise fresh states are gathered by the cached
    index. The mask re-checks the true radius on fresh positions, so only
    the selection is stale. The rebuild searches with the kernels
    (:func:`knn.knn_select`) where ``use_kernel``, else densely (a stable
    sort keeps the lower index first, as ``lax.top_k`` does; ``not_self``
    (N, N) excludes the diagonal).

    Eagerly the rebuild is a host branch; inside the compiled body it runs
    every step and ``torch.where`` on the 0-dim predicate picks rebuilt or
    cached values, bit for bit either branch.

    Returns (obs_slab (N, Kc, 4), mask, min_dist_sound — the seen minimum
    at the build radius combined with a lower bound on every unseen pair,
    dropped () int32 — frozen at the last rebuild, counted vs the build
    radius, new_cache)."""
    skin = float(cfg.gating_rebuild_skin)
    r_build = cfg.safety_distance + skin
    Kc = min(K, cfg.n - 1)

    def rebuild():
        if use_kernel:
            idx, bdist, _, count = knn.knn_select(states4[:, :2], r_build, Kc)
        else:
            dist = pairwise_distances(x)
            eligible = (dist < r_build) & not_self
            bdist, idx = torch.sort(torch.where(eligible, dist, torch.inf),
                                    dim=1, stable=True)
            bdist, idx = bdist[:, :Kc], idx[:, :Kc].to(torch.int32)
            count = torch.sum(eligible, dim=1, dtype=torch.int32)
        dropped = torch.sum(torch.clamp(count - Kc, min=0), dtype=torch.int32)
        # Every build-time-truncated in-radius pair was at least as far as
        # both endpoints' k-th kept distance.
        d_kth = torch.amax(torch.where(torch.isfinite(bdist), bdist,
                                       -torch.inf), dim=1)
        min_dkth = torch.amin(torch.where(count > Kc, d_kth, torch.inf))
        return idx, x, dropped, min_dkth.to(x.dtype)

    disp2 = torch.amax(torch.sum((x - cache[1]) ** 2, dim=1))
    stale = disp2 > (0.5 * skin) ** 2
    if exact2d.in_guarded_body():
        cache = tuple(torch.where(stale, new, old)
                      for new, old in zip(rebuild(), cache))
    elif bool(stale):
        cache = rebuild()
    idx_c, xb_c, dropped_c, dkth_c = cache
    obs_slab = states4[idx_c.to(torch.int64)]              # fresh states
    d = torch.sqrt(torch.sum((x[:, None, :] - obs_slab[..., :2]) ** 2,
                             dim=-1))
    # 0 < d excludes self rows, exact coincidences and the fillers that
    # point at self; a filler pointing at an in-radius agent is a true
    # duplicate row, which the QP absorbs.
    mask = (d > 0.0) & (d < cfg.safety_distance)
    seen_min = torch.amin(torch.where((d > 0.0) & (d < r_build), d,
                                      torch.inf))
    disp_now = torch.sqrt(torch.amax(torch.sum((x - xb_c) ** 2, dim=1)))
    min_dist = torch.minimum(seen_min, dkth_c - 2.0 * disp_now)
    return obs_slab, mask, min_dist, dropped_c, cache


# Guarded relax rounds per step in the compiled rollout, beyond which a
# chunk is redone with the eager relax loop. Chosen from the per-step relax
# rounds measured on an H100 at N=4096 (PERF.md §5): without obstacles, or
# with the static scatter field, no single-integrator step needed more
# than one round; the orbiting ring needed up to 12. Each round costs a
# projection on every step, so the ring alone gets the deep guard.
RELAX_ROUNDS = 1
RELAX_ROUNDS_ORBIT = 12
# The other families put every row in the 0.01-per-round eps tier
# (relax_tiers); per family the deepest step of its 300-step histogram at
# N=4096 on the H100 (PERF.md §6, PR 7): double and mixed relaxed up to 3
# rounds (most steps 1-2), the unicycle once in 300 steps.
RELAX_ROUNDS_FAMILY = {"double": 3, "unicycle": 1, "mixed": 3}


# Guarded blocks of the certificate's adaptive ADMM budget
# (certificate_tol) in the compiled rollout, beyond which a chunk is redone
# with the eager loop (None would run the whole budget, ceil(iters /
# check_every) blocks, and never redo). Each block costs its compute on
# every step whether or not the loop has stopped. Chosen from the per-step
# iterations measured on an H100 at N=4096, warm start, tol 1e-5 (PERF.md
# §6): 40 on 43 of 50 steps, 50 on 7, so 5 blocks of 10.
CERTIFICATE_BLOCKS = 5


def relax_rounds(cfg: Config) -> int:
    """The guarded relax rounds a step of ``cfg`` captures."""
    rounds = RELAX_ROUNDS_FAMILY.get(cfg.dynamics, RELAX_ROUNDS)
    if cfg.n_obstacles and cfg.obstacle_layout == "orbit":
        rounds = max(rounds, RELAX_ROUNDS_ORBIT)
    return rounds


def _build_step(cfg: Config, cbf: CBFParams | None = None, *, active=None,
                unroll_relax: int = 0, device=None):
    """The scenario step factory — :func:`make` without the initial
    state. ``step(state, t, inputs=None) -> (state, StepOutputs)`` on
    ``device``; ``t`` is an int or a 0-dim integer tensor.

    For the compiled rollout the step carries ``relax_rounds`` (the
    guarded relax rounds to capture), ``admm_blocks`` (the guarded blocks
    of the certificate's adaptive budget) and, with obstacles, the hook
    ``host_inputs(t0, n)``: the (n, M, 4) obstacle rows of steps
    t0..t0+n-1 on the host. The rollout copies them to the device before
    it replays and hands each step its row as ``inputs``; without
    ``inputs`` the step computes the row itself from ``t``, on the host.
    ``active`` (the serving layer's padded-bucket mask) is not ported."""
    dev = resolve_device(device)
    validate_config(cfg)
    if cfg.gating not in ("auto", "pallas", "jnp", "banded", "streaming"):
        raise ValueError(f"gating must be auto|pallas|jnp|banded|streaming, "
                         f"got {cfg.gating!r}")
    if cfg.gating_rebuild_skin < 0:
        raise ValueError(f"gating_rebuild_skin must be >= 0, got "
                         f"{cfg.gating_rebuild_skin}")
    use_banded = cfg.gating == "banded"
    cache_skin = float(cfg.gating_rebuild_skin)
    if cache_skin and cfg.gating in ("banded", "streaming"):
        raise ValueError(
            "gating_rebuild_skin requires the pallas/jnp gating backends "
            "(the banded kernel's window bookkeeping has no cached form, "
            "and the cache's rebuild search keeps the auto kernel choice)")
    reject_out_of_slice(cfg, unroll_relax=unroll_relax, active=active)
    dt_ = cfg.dtype
    f, g, discrete = barrier_dynamics(cfg, dt_, validate=False, device=dev)
    double = cfg.dynamics == "double"
    unicycle = cfg.dynamics == "unicycle"
    mixed = cfg.dynamics == "mixed"
    dmask = dynamics_mask(cfg, device=dev) if mixed else None
    # Actuation-bounded families get the pure actuator box (the
    # reference's velocity-coupled box rows are a parity artifact).
    plain_box = cfg.dynamics != "single"
    goals_np = goal_layout(cfg)
    goals_c = (None if goals_np is None
               else torch.as_tensor(goals_np, dtype=dt_, device=dev))
    if cbf is None:
        cbf = default_cbf(cfg, device=dev)
    K = cfg.k_neighbors
    M = cfg.n_obstacles
    # "streaming" forces the streaming kernel below the fused bound.
    kernel = "streaming" if cfg.gating == "streaming" else "auto"
    use_kernel = (knn.supported(cfg.n) if cfg.gating == "auto"
                  else cfg.gating in ("pallas", "streaming"))
    not_self = None
    if use_banded:
        window_blocks = banded_window_blocks(cfg)
    elif not use_kernel:
        all_rows = torch.ones(cfg.n, dtype=torch.bool, device=dev)
        eye = torch.eye(cfg.n, dtype=torch.bool, device=dev)
        self_inf = torch.where(eye, torch.inf, 0.0).to(dt_)
        not_self = ~eye
    filter_kw = dict(reference_layout=not plain_box,
                     vel_box_rows=not plain_box)

    def step(state: State, t, inputs=None):
        scrub_bit = None
        if cfg.rta:
            # Rung-3 entry half (lane scrub): a non-finite carried row is
            # replaced by its last-known-good row before any geometry
            # touches it (one NaN would reach every agent through the
            # consensus centroid).
            mode_prev, streak_prev, lkg_x, lkg_v, lkg_th = state.rta
            ok_rows = finite_rows(state.x, state.v, state.theta)
            scrub_bit = ~ok_rows
            state = state._replace(
                x=torch.where(ok_rows[:, None], state.x, lkg_x),
                v=torch.where(ok_rows[:, None], state.v, lkg_v),
                theta=(torch.where(ok_rows, state.theta, lkg_th)
                       if unicycle else state.theta))
        # Unicycle: the filter works on the projection points.
        x = (projection_points(cfg, state.x, state.theta) if unicycle
             else state.x)                                     # (N, 2)
        with annotate("consensus"):
            if goals_c is not None:
                u0 = cfg.consensus_gain * (goals_c - x)
            else:
                centroid = torch.mean(x, dim=0)
                to_c = centroid[None] - x                      # (N, 2)
                d_c = torch.linalg.norm(to_c, dim=1, keepdim=True)
                # Pull toward the centroid only outside the packing disk.
                pull = torch.clamp(d_c - cfg.pack_radius, min=0.0)
                u0 = (cfg.consensus_gain * pull * to_c
                      / torch.clamp(d_c, min=1e-9))
            if M:
                obstacles4 = (obstacle_states_at(cfg, t, dt_, device=dev)
                              if inputs is None else inputs)
                dodge, d_o = lane_dodge(x, obstacles4, cfg.safety_distance)
                u0 = u0 + 2.0 * dodge
        # Discrete single rows zero the agents' velocity slots (u is the
        # unknown the row solves for); double rows and continuous rows
        # carry the actual velocities.
        if mixed:
            vslots = torch.where(dmask[:, None], state.v,
                                 torch.zeros_like(state.v))
        else:
            vslots = (state.v if (double or not discrete)
                      else torch.zeros_like(state.v))
        states4 = torch.cat([x, vslots], dim=1)                # (N, 4)

        overflow_count = ()
        new_cache = ()
        with annotate("gating"):
            if cache_skin:
                obs_slab, mask, min_dist, dropped, new_cache = verlet_gating(
                    cfg, x, states4, state.gating_cache, K, use_kernel,
                    not_self)
            elif use_banded:
                # O(N*W) y-sorted banded kernel; window overflow (possibly
                # missed neighbours) is surfaced, never swallowed.
                obs_slab, mask, nearest, overflow, dropped = \
                    knn.knn_gating_banded(states4, cfg.safety_distance, K,
                                          window_blocks=window_blocks)
                min_dist = torch.amin(nearest)
                overflow_count = torch.sum(overflow, dtype=torch.int32)
            elif use_kernel:
                # Distances + k-NN + nearest-any metric in one kernel
                # (knn_fused, or knn_stream beyond the fused bound or when
                # forced).
                obs_slab, mask, nearest, dropped = knn.knn_gating_pallas(
                    states4, cfg.safety_distance, K, kernel=kernel)
                min_dist = torch.amin(nearest)
            else:
                # Dense path: one distance matrix feeds both the gating and
                # the min-distance metric.
                dist = pairwise_distances(x)                   # (N, N)
                obs_slab, mask, dropped = knn_gating(
                    states4, states4, cfg.safety_distance, K,
                    exclude_self_row=all_rows, dist=dist, with_dropped=True)
                min_dist = torch.amin(dist + self_inf)

        u0 = complete_nominal(cfg, u0, x, state.v, obs_slab, mask)

        priority = None
        if M:
            obs_slab, mask, priority = attach_obstacle_rows(
                obs_slab, mask, obstacles4, d_o, cfg.safety_distance)
            min_dist = torch.minimum(min_dist, torch.amin(d_o))

        with annotate("filter"):
            priority, cap = relax_tiers(cfg, mask, priority)
            u_safe, info = safe_controls(
                states4, obs_slab, mask, f, g, u0, cbf,
                priority_mask=priority, relax_cap=cap, **filter_kw)
            engaged = torch.any(mask, dim=1)
            u = torch.where(engaged[:, None], u_safe, u0)

        if cfg.rta:
            # Rung 1: the flagged agents' QPs re-solved with the cap lifted
            # and the boosted budget. Eagerly a host branch; the compiled
            # body leaves it out and raises the redo flag where it would
            # change a row, so the eager loop runs that chunk again.
            bit_infeas = ~info.feasible & engaged
            boost = (bit_infeas | (mode_prev == RUNG_RESOLVE)) & engaged
            if exact2d.in_guarded_body():
                exact2d.request_redo(torch.any(boost))
            elif bool(torch.any(boost)):
                u_boost, _ = safe_controls(
                    states4, obs_slab, mask, f, g, u0, cbf,
                    priority_mask=priority, relax_cap=None,
                    max_relax=cfg.rta_boost_budget, **filter_kw)
                u = torch.where(boost[:, None], u_boost, u)

        cert_residual = cert_dropped = cert_iters = carry_resets = ()
        new_ccache = new_sstate = ()
        carry_reset = None
        if cfg.certificate:
            sstate_in = None
            if cfg.certificate_warm_start:
                # A non-finite warm carry cold-resets (counted) instead of
                # poisoning every later warm solve.
                sstate_in, carry_reset = certificates.sanitize_solver_state(
                    state.certificate_solver_state)
                carry_resets = carry_reset.to(torch.int32)
            # Second layer of the reference's stack: the joint certificate
            # over the already-filtered si velocities.
            with annotate("certificate"):
                res = apply_certificate(
                    cfg, u, x,
                    neighbor_cache=(state.certificate_cache
                                    if cfg.certificate_rebuild_skin
                                    else None),
                    solver_state=sstate_in)
                u, cert_residual, cert_dropped, cert_iters = res[:4]
                rest = list(res[4:])
                if cfg.certificate_rebuild_skin:
                    new_ccache = rest.pop(0)
                if cfg.certificate_warm_start:
                    new_sstate = rest.pop(0)

        if cfg.rta:
            # Rungs 2-3, pre-integration half: the backup command for
            # every agent whose latched or demanded rung asks for it. A
            # NaN certificate residual trips the trust gate (~(r <= gate)).
            health = health_word(
                cfg.n, infeasible=bit_infeas,
                cert_residual=(~(cert_residual <= cfg.rta_residual_gate)
                               if cfg.certificate else None),
                carry_reset=carry_reset, state_nonfinite=scrub_bit,
                control_nonfinite=~finite_rows(u))
            mode_eff = torch.maximum(mode_prev, demanded_rung(health))
            u = torch.where((mode_eff >= RUNG_BACKUP)[:, None],
                            backup_control(
                                state.v, dynamics=cfg.dynamics,
                                vel_tracking_tau=cfg.vel_tracking_tau,
                                accel_limit=cfg.accel_limit,
                                dynamics_mask=dmask), u)
            # A non-finite command never reaches the integrator.
            u = torch.where(torch.isfinite(u), u, torch.zeros_like(u))

        deficit = ()
        with annotate("integrate"):
            if unicycle:
                body_new, theta_new, p_new = unicycle_apply(
                    cfg, state.x, state.theta, u)
                # The applied si velocity at the projection point.
                x_new, v_new = body_new, (p_new - x) / cfg.dt
                deficit_pa = safe_norm(u - v_new)
                deficit = torch.amax(deficit_pa)
            else:
                x_new, v_new = integrate(cfg, x, state.v, u)
                theta_new = state.theta

        rta_mode = ()
        rta_carry = ()
        if cfg.rta:
            # Rung-3 exit half: a row the integrator broke is held at its
            # pre-step value with v = 0, and the trailing health bits
            # fold into the latch from the next step.
            post_ok = finite_rows(x_new, v_new,
                                  theta_new if unicycle else ())
            x_new = torch.where(post_ok[:, None], x_new, state.x)
            v_new = torch.where(post_ok[:, None], v_new,
                                torch.zeros_like(v_new))
            if unicycle:
                theta_new = torch.where(post_ok, theta_new, state.theta)
            health = health | health_word(
                cfg.n, state_nonfinite=~post_ok,
                actuation_deficit=(deficit_pa > cfg.rta_deficit_gate
                                   if unicycle else None))
            mode_new, streak_new = latch_update(
                mode_prev, streak_prev, demanded_rung(health),
                cfg.rta_recover_steps)
            rta_mode = torch.amax(mode_new)
            rta_carry = (mode_new, streak_new, x_new, v_new,
                         theta_new if unicycle else ())

        out = StepOutputs(
            min_pairwise_distance=min_dist,
            filter_active_count=torch.sum(engaged, dtype=torch.int32),
            infeasible_count=torch.sum(~info.feasible & engaged,
                                       dtype=torch.int32),
            max_relax_rounds=torch.amax(info.relax_rounds),
            trajectory=x if cfg.record_trajectory else (),
            gating_overflow_count=overflow_count,
            gating_dropped_count=torch.sum(dropped, dtype=torch.int32),
            certificate_residual=cert_residual,
            certificate_dropped_count=cert_dropped,
            saturation_deficit=deficit,
            certificate_iterations=cert_iters,
            certificate_carry_resets=carry_resets,
            rta_mode=rta_mode,
        )
        return state._replace(x=x_new, v=v_new, theta=theta_new,
                              gating_cache=new_cache,
                              certificate_cache=new_ccache,
                              certificate_solver_state=new_sstate,
                              rta=rta_carry), out

    step.relax_rounds = relax_rounds(cfg)
    step.admm_blocks = CERTIFICATE_BLOCKS
    if M:
        step.host_inputs = lambda t0, n: obstacle_table(cfg, t0, n, dt_)
    return step


def make(cfg: Config = Config(), cbf: CBFParams | None = None, *,
         unroll_relax: int = 0, device=None):
    """(initial State, step) on ``device`` (None = the card; without one
    this raises — pass ``device="cpu"`` for the CPU)."""
    step = _build_step(cfg, cbf, unroll_relax=unroll_relax, device=device)
    return initial_state(cfg, device=device), step


def run(cfg: Config = Config(), *, device=None, **kw):
    state0, step = make(cfg, device=device, **kw)
    return rollout(step, state0, cfg.steps)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run the default swarm scenario and print a summary.")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    cfg = Config()
    final, outs = run(cfg, device=args.device)
    md = outs.min_pairwise_distance.cpu().numpy()
    spread = float(torch.amax(torch.linalg.norm(
        final.x - torch.mean(final.x, dim=0), dim=1)))
    print(f"swarm: N={cfg.n}, {cfg.steps} steps, K={cfg.k_neighbors}")
    print(f"  min pairwise distance over run: {md.min():.4f} m")
    print(f"  final max spread from centroid: {spread:.4f} m")
    print(f"  infeasible agent-steps: "
          f"{int(outs.infeasible_count.sum())}")
    print(f"  k-NN dropped neighbor-steps: "
          f"{int(outs.gating_dropped_count.sum())}")


if __name__ == "__main__":
    main()
