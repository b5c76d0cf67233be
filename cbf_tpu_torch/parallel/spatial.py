"""Spatially tiled single-swarm decomposition: domain-decomposed steps with
halo exchange (counterpart: cbf_tpu/parallel/spatial.py).

The flat ``sp`` sharding (:mod:`cbf_tpu_torch.parallel.ensemble` with
:mod:`~cbf_tpu_torch.parallel.alltoall`) splits a swarm by ROW RANGE, so
every rank still sees all N candidates each step. This module splits it
by SPACE, one tile per rank of the mesh's ``sp`` axis:

- **Tiles.** The arena (``arena_half_override`` or ``1.5 *
  spawn_half_width``) is cut into ``n_tiles`` equal x-strips. Each tile
  owns a fixed-capacity slab of ``capacity`` agent slots, unoccupied slots
  parked at :data:`PARK` and masked out of every reduction.
- **Binning.** Every ``rebin_every`` steps an O(N) pass (stable argsort
  and cumsum ranks) assigns agents to tiles by x. It is deterministic in
  the positions, so every rank reaches the same plan from the same
  gathered positions. Agents beyond a tile's capacity raise
  :class:`SpatialOverflowError` (``on_overflow="raise"``) or spill into
  free slots of other tiles, counted (``"fallback"``; the
  ``spatial.overflow_fallback`` counter) — every agent keeps exactly one
  slot either way.
- **Halo exchange.** Only agents binned within ``band`` of a tile face are
  shipped to the adjacent tile, by two linear point-to-point chains
  (``Axis.ppermute``; the arena does not wrap, so edge tiles send nothing
  outward). ``band`` covers the interaction radius plus both endpoints'
  worst-case travel over an epoch, so the local tile and its halos hold
  every in-radius partner of every local agent for the whole epoch.
- **Sharded certificate.** The joint layer runs the row-partitioned ADMM
  solve (``solvers.sparse_admm``'s ``axis_name``) with the slab order as
  the variable order: each tile's rows are contiguous, pair rows are
  searched over local and halo candidates only, and the (n_tiles *
  capacity, 2) iterate is the only gathered object. Parked slots have a
  zero nominal, an infinite box and no pair rows, so they stay exactly
  zero.

The epoch loop has the JAX package's two host syncs per epoch (the bin's
overflow count, the halo's drop count). Single-integrator, obstacle-free
swarms only; every other knob is rejected up front.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from cbf_tpu_torch.core.filter import CBFParams, safe_controls
from cbf_tpu_torch.ops.pairwise import pairwise_distances
from cbf_tpu_torch.parallel.ensemble import EnsembleMetrics, _barrier_dynamics
from cbf_tpu_torch.scenarios import swarm as swarm_scenario
from cbf_tpu_torch.utils.math import safe_norm

# Unoccupied slab slots park here — far outside any arena, so no parked
# coordinate can fall inside a gating or certificate radius of an agent.
PARK = 1.0e6


class SpatialOverflowError(RuntimeError):
    """A tile's slab (or a halo band) exceeded its fixed capacity under
    ``on_overflow="raise"`` — the planned density assumption broke.
    Re-plan with a larger ``slack`` / ``halo_capacity`` or opt into the
    counted ``on_overflow="fallback"`` degradation."""


class SpatialSpec(NamedTuple):
    """The static tiling plan. Build with :func:`plan_tiles` (the
    constructor enforces none of the coverage invariants)."""
    n_tiles: int        # sp mesh extent; 1D x-strips
    capacity: int       # slab slots per tile (multiple of block_rows)
    halo_capacity: int  # shipped slots per face per step
    band: float         # face band width (bin coordinates) shipped as halo
    half: float         # arena half-width the strips partition
    rebin_every: int    # steps per epoch between re-binning passes
    block_rows: int     # gating/certificate row-block size
    pair_radius: float  # certificate binding radius (0.0: certificate off)


class SpatialMetrics(NamedTuple):
    """Per-step host metrics of a spatial rollout, (steps,) leaves: the
    eight channels of :class:`EnsembleMetrics` (one swarm) and the
    decomposition's own — ``drift_violations``, valid agents whose travel
    since the epoch's bin pass exceeded the planned allowance (must be 0
    for the coverage guarantee to hold)."""
    nearest_distance: np.ndarray
    engaged_count: np.ndarray
    infeasible_count: np.ndarray
    dropped_count: np.ndarray
    certificate_residual: np.ndarray
    certificate_dropped: np.ndarray
    saturation_deficit: np.ndarray
    certificate_iterations: np.ndarray
    drift_violations: np.ndarray


@dataclasses.dataclass(frozen=True)
class SpatialReport:
    """Epoch-level accounting of one spatial rollout (host ints)."""
    epochs: int
    overflow_total: int      # agents spilled to out-of-tile slots (fallback)
    halo_dropped_total: int  # band members beyond halo_capacity, all epochs
    occupancy_max: int       # max agents binned into any tile
    halo_used_max: int       # max shipped halo slots in use on any tile


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def plan_tiles(cfg: swarm_scenario.Config, n_tiles: int, *,
               slack: float = 1.3, rebin_every: int = 8,
               halo_capacity: int | None = None,
               block_rows: int | None = None) -> SpatialSpec:
    """Derive the static tiling plan for ``cfg`` over ``n_tiles`` strips
    (the JAX package's derivation and rejections, word for word).

    ``slack``: per-tile capacity headroom. ``rebin_every``: steps per
    epoch (a larger one widens ``band``). ``halo_capacity``: shipped slots
    per face (default: 2.2x the uniform-density expectation, min 16).
    ``block_rows``: gating/certificate row-block size (default 512,
    clamped to capacity). Raises when a strip is narrower than the halo
    band."""
    if n_tiles < 1:
        raise ValueError(f"n_tiles must be >= 1, got {n_tiles}")
    if rebin_every < 1:
        raise ValueError(f"rebin_every must be >= 1, got {rebin_every}")
    if slack < 1.0:
        raise ValueError(f"slack must be >= 1.0, got {slack}")
    params, _ = swarm_scenario._certificate_problem(cfg)
    half = (cfg.arena_half_override if cfg.arena_half_override is not None
            else cfg.spawn_half_width * 1.5)
    radius = float(cfg.safety_distance)
    pair_radius = 0.0
    if cfg.certificate:
        from cbf_tpu_torch.sim.certificates import binding_pair_radius
        pair_radius = binding_pair_radius(params)
        radius = max(radius, pair_radius)
    # Worst-case travel of one agent over an epoch (the QP's component box
    # caps |u_i| at speed_limit); both pair endpoints move.
    drift = math.sqrt(2.0) * float(cfg.speed_limit) * float(cfg.dt) \
        * rebin_every
    band = 1.05 * (radius + 2.0 * drift)
    width = 2.0 * half / n_tiles
    if n_tiles > 1 and width < band:
        raise ValueError(
            f"tile width {width:.3f} < halo band {band:.3f} "
            f"(radius {radius:.3f} + 2x epoch drift {drift:.3f}): "
            f"adjacent halos cannot cover the interaction radius — use "
            f"fewer tiles than {n_tiles} or a smaller rebin_every than "
            f"{rebin_every}")
    # Capacity: the consensus law packs the swarm toward ~2 * pack_radius,
    # so interior tiles hold more than N / n_tiles.
    extent = min(half, max(float(cfg.pack_radius), 1e-6))
    share = cfg.n * min(1.0, width / (2.0 * extent))
    cap0 = max(8, int(math.ceil(max(share, cfg.n / n_tiles) * slack)))
    block = block_rows if block_rows is not None else 512
    if block < 1:
        raise ValueError(f"block_rows must be >= 1, got {block}")
    block = min(block, _round_up(cap0, 8))
    capacity = _round_up(cap0, block)
    if n_tiles * capacity < cfg.n:
        raise ValueError(
            f"n_tiles * capacity = {n_tiles * capacity} < N = {cfg.n}")
    if halo_capacity is None:
        expected = capacity * min(1.0, band / max(width, band))
        halo_capacity = min(capacity,
                            _round_up(max(16, int(math.ceil(2.2 * expected))),
                                      8))
    if not 1 <= halo_capacity <= capacity:
        raise ValueError(
            f"halo_capacity must be in [1, capacity={capacity}], got "
            f"{halo_capacity}")
    return SpatialSpec(n_tiles=n_tiles, capacity=capacity,
                       halo_capacity=int(halo_capacity), band=float(band),
                       half=float(half), rebin_every=int(rebin_every),
                       block_rows=int(block), pair_radius=float(pair_radius))


# ------------------------------------------------------------ binning ----

def _bin(x, v, half: float, n_tiles: int, capacity: int):
    """The global binning pass: (x, v) (N, 2) -> (x_slab (T*C, 2) with
    parked slots at PARK, v_slab (T*C, 2), valid (T*C,) bool,
    slot_of_agent (N,) int64, overflow 0-dim int32 — agents whose tile was
    full, spilled into free slots of OTHER tiles — counts (T,) int32
    binned occupancy). O(N), branch-free, deterministic."""
    T, C = n_tiles, capacity
    n, dev = x.shape[0], x.device
    i32, i64 = torch.int32, torch.int64
    half_t = torch.tensor(half, dtype=x.dtype, device=dev)
    width = 2.0 * half_t / T
    tile = torch.clamp(torch.floor((x[:, 0] + half_t) / width), 0,
                       T - 1).to(i64)
    order = torch.argsort(tile, stable=True)
    tile_s = tile[order]
    counts = torch.bincount(tile, minlength=T)
    starts = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                        torch.cumsum(counts, 0)[:-1]])
    rank = torch.arange(n, device=dev) - starts[tile_s]
    fits = rank < C
    slot_primary = tile_s * C + rank
    occupied = torch.zeros(T * C, dtype=i32, device=dev).index_add_(
        0, torch.where(fits, slot_primary, 0), fits.to(i32))
    # Spill: the j-th overflowing agent (sorted order) takes the j-th free
    # slot (ascending slot id). T*C >= N guarantees enough.
    free_slots = torch.argsort(occupied, stable=True)
    ov_rank = torch.cumsum((~fits).to(i64), 0) - 1
    slot_s = torch.where(fits, slot_primary,
                         free_slots[torch.clamp(ov_rank, 0, T * C - 1)])
    slot_of_agent = torch.zeros(n, dtype=i64, device=dev).scatter_(
        0, order, slot_s)
    x_slab = torch.full((T * C, 2), PARK, dtype=x.dtype, device=dev)
    x_slab[slot_of_agent] = x
    v_slab = torch.zeros((T * C, 2), dtype=v.dtype, device=dev)
    v_slab[slot_of_agent] = v
    valid = torch.zeros(T * C, dtype=torch.bool, device=dev)
    valid[slot_of_agent] = True
    overflow = torch.sum(~fits, dtype=i32)
    return x_slab, v_slab, valid, slot_of_agent, overflow, counts.to(i32)


# ------------------------------------------------------- halo exchange ----

class _HaloPlan(NamedTuple):
    """Per-epoch (bin-time) halo membership of one tile: which local slots
    ship to each face, fixed for the whole epoch."""
    sel_l: Any    # (H,) local slots shipped to tile - 1
    flag_l: Any   # (H,) bool — slot actually in the left band
    sel_r: Any
    flag_r: Any
    dropped: Any  # 0-dim int32: band members beyond H, both faces
    used: Any     # 0-dim int32: shipped slots in use, both faces


def _halo_plan(xb, valid, spec: SpatialSpec, tile: int) -> _HaloPlan:
    T, H = spec.n_tiles, spec.halo_capacity
    width = 2.0 * spec.half / T
    tile_t = torch.tensor(tile, dtype=xb.dtype, device=xb.device)
    left_edge = -spec.half + tile_t * width
    in_l = valid & (xb[:, 0] < left_edge + spec.band) & (tile > 0)
    in_r = valid & (xb[:, 0] >= left_edge + width - spec.band) \
        & (tile < T - 1)

    def select(in_band):
        # lax.top_k of the 0/1 membership: members first, each group in
        # slot order.
        idx = torch.argsort((~in_band).to(torch.uint8), stable=True)[:H]
        return idx, in_band[idx]

    sel_l, flag_l = select(in_l)
    sel_r, flag_r = select(in_r)
    i32 = torch.int32
    n_l = torch.sum(in_l, dtype=i32)
    n_r = torch.sum(in_r, dtype=i32)
    dropped = (torch.clamp(n_l - H, min=0) + torch.clamp(n_r - H, min=0))
    used = torch.clamp(n_l, max=H) + torch.clamp(n_r, max=H)
    return _HaloPlan(sel_l, flag_l, sel_r, flag_r, dropped, used)


def _halo_candidates(states4, valid, plan: _HaloPlan, spec: SpatialSpec,
                     tile: int, axis):
    """Ship this step's states of the planned band members to the adjacent
    tiles (two linear chains; edge receivers get zero payloads whose flag
    channel masks them) and return the tile's candidate set (C + 2H rows):
    (cand_states4, cand_gid — slab-global slot ids — cand_ok)."""
    T, C, H = spec.n_tiles, spec.capacity, spec.halo_capacity
    dt_, dev = states4.dtype, states4.device

    def pack(sel, flag):
        pay = torch.cat([states4[sel], sel[:, None].to(dt_),
                         flag[:, None].to(dt_)], dim=1)
        # A non-member row is all zeros: it decodes as "no candidate".
        return pay * flag[:, None].to(dt_)

    if T > 1:
        # Left bands flow leftward (j -> j - 1): each tile receives its
        # right neighbour's left band, and symmetrically.
        from_right = axis.ppermute(pack(plan.sel_l, plan.flag_l),
                                   [(j, j - 1) for j in range(1, T)])
        from_left = axis.ppermute(pack(plan.sel_r, plan.flag_r),
                                  [(j, j + 1) for j in range(T - 1)])
    else:
        from_right = from_left = torch.zeros((H, 6), dtype=dt_, device=dev)

    def decode(pay, src_tile):
        ok = pay[:, 5] > 0.5
        slot = pay[:, 4].to(torch.int64)
        gid = torch.clamp(src_tile * C + slot, 0, T * C - 1)
        return pay[:, :4], gid, ok

    s4_r, gid_r, ok_r = decode(from_right, tile + 1)
    s4_l, gid_l, ok_l = decode(from_left, tile - 1)
    cand_s4 = torch.cat([states4, s4_l, s4_r], dim=0)
    cand_gid = torch.cat([tile * C + torch.arange(C, device=dev), gid_l,
                          gid_r])
    cand_ok = torch.cat([valid, ok_l, ok_r])
    return cand_s4, cand_gid, cand_ok


# ------------------------------------------------- blocked neighbour ops --

def _blocked_select(xq, q_gid, q_valid, xc, c_gid, c_ok, k: int, radius,
                    block: int, by_gid: bool):
    """Masked radius-limited k-nearest over the candidate set, in row
    blocks of ``block`` (the distance slab peaks at (block, C + 2H)).
    ``by_gid=False`` excludes self (and exact coincidences) by ``dist > 0``
    — the gating rule — while ``by_gid=True`` excludes by slot identity
    only — the certificate rule. The selection is the stable ascending
    sort (ties to the lower candidate index, as ``lax.top_k``). Returns
    (idx (Q, k) into the candidate axis, mask, dist, count)."""
    Q = xq.shape[0]
    if Q % block:
        raise ValueError(f"capacity {Q} must divide by block_rows {block}")
    outs = []
    for b0 in range(0, Q, block):
        xqb, gqb = xq[b0:b0 + block], q_gid[b0:b0 + block]
        d = pairwise_distances(xqb, xc)
        elig = (d < radius) & c_ok[None, :] & q_valid[b0:b0 + block, None]
        if by_gid:
            elig &= c_gid[None, :] != gqb[:, None]
        else:
            elig &= d > 0
        keyed = torch.where(elig, d, torch.inf)
        key, idx = torch.sort(keyed, dim=1, stable=True)
        key, idx = key[:, :k], idx[:, :k]
        outs.append((idx, torch.isfinite(key), key,
                     torch.sum(elig, dim=1, dtype=torch.int32)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


# -------------------------------------------------- sharded certificate ----

def _apply_certificate_spatial(cfg: swarm_scenario.Config,
                               spec: SpatialSpec, u, x, valid, row_gid,
                               cand_xy, cand_gid, cand_ok, tile: int, axis):
    """The joint layer over the SLAB ordering: the concatenated tile slabs
    (T*C rows, parked slots included) are the solve's variable vector, so
    each tile's rows are contiguous and the replicated iterate gathers
    straight from the local slabs. Pair rows are searched over local and
    halo candidates only."""
    from cbf_tpu_torch.sim.certificates import _arena_box, _pair_row_geometry
    from cbf_tpu_torch.solvers.sparse_admm import solve_pair_box_qp_admm

    params, arena = swarm_scenario._certificate_problem(cfg)
    settings = swarm_scenario._certificate_settings(cfg)
    C = spec.capacity
    kc = min(cfg.certificate_k, cfg.n - 1)
    dtype = x.dtype

    # Magnitude pre-limit, per row.
    norms = safe_norm(u, dim=1)
    scale = torch.clamp(norms / params.magnitude_limit, min=1.0)
    u_nom = torch.where(valid[:, None], u / scale[:, None], 0.0)

    # Slab-global (T*C, 2) gathers: the one globally materialised object.
    xt_g = axis.all_gather(x)
    un_g = axis.all_gather(u_nom)
    valid_g = axis.all_gather(valid)

    idx, maskk, _, count = _blocked_select(
        x, row_gid, valid, cand_xy, cand_gid, cand_ok, kc,
        spec.pair_radius, spec.block_rows, by_gid=True)
    I = row_gid[:, None].expand(C, kc).reshape(-1)
    J = cand_gid[idx].reshape(-1)
    maskf = maskk.reshape(-1)

    # Symmetric coverage accounting (the flat row-partitioned formula):
    # the reverse lookup needs every tile's kept slots.
    kept = torch.where(maskk, cand_gid[idx], -1)
    idx_g = axis.all_gather(kept)
    mask_g = axis.all_gather(maskk)
    mutual = maskf & torch.any((idx_g[J] == I[:, None]) & mask_g[J], dim=1)
    i32 = torch.int32
    D, S, M = axis.psum(torch.stack([
        torch.sum(torch.where(valid, count, 0), dtype=i32),
        torch.sum(maskk, dtype=i32), torch.sum(mutual, dtype=i32)]))
    dropped = D // 2 - (S - M // 2)

    coef, b_pair = _pair_row_geometry(xt_g, I, J, maskf, params, dtype)
    lo, hi = _arena_box(xt_g, params, arena, dtype)
    # Parked slots sit far outside the arena: an infinite box keeps their
    # components exactly zero through every update.
    big = torch.full_like(hi, torch.inf)
    lo = torch.where(valid_g[:, None], lo, -big)
    hi = torch.where(valid_g[:, None], hi, big)

    u_sol, sinfo = solve_pair_box_qp_admm(
        un_g, I, J, coef, b_pair, lo, hi, settings, axis_name=axis,
        agent_k=kc, rows_start=tile * C)
    u_rep = axis.pmax(u_sol)
    u_local = u_rep[tile * C:(tile + 1) * C]
    return (u_local, axis.pmax(sinfo.primal_residual), dropped,
            sinfo.iterations)


# ----------------------------------------------------------- tile step ----

def _tile_step(cfg: swarm_scenario.Config, cbf: CBFParams,
               spec: SpatialSpec, t, x, v, valid, xb, plan: _HaloPlan,
               tile: int, axis):
    """One spatially decomposed swarm step on this tile's slab — the
    masked mirror of the flat single-integrator step, the halo candidate
    set standing in for the whole swarm. x, v: (C, 2) slabs; xb the
    epoch's bin-time positions. Returns (x', v', metrics 9-tuple, reduced
    over the tiles)."""
    dt_, dev = x.dtype, x.device
    C = spec.capacity
    f, g, discrete = _barrier_dynamics(cfg, dt_, dev)
    K = min(cfg.k_neighbors, cfg.n - 1)

    mean = axis.psum(torch.sum(torch.where(valid[:, None], x, 0.0),
                               dim=0)) / cfg.n
    to_c = mean[None] - x
    d_c = safe_norm(to_c, keepdim=True)
    pull = torch.clamp(d_c - cfg.pack_radius, min=0.0)
    u0 = cfg.consensus_gain * pull * to_c / torch.clamp(d_c, min=1e-9)

    vslots = v if not discrete else torch.zeros_like(v)
    states4 = torch.cat([x, vslots], dim=1)
    row_gid = tile * C + torch.arange(C, device=dev)
    cand_s4, cand_gid, cand_ok = _halo_candidates(states4, valid, plan,
                                                  spec, tile, axis)

    idx, mask, dist, count = _blocked_select(
        x, row_gid, valid, cand_s4[:, :2], cand_gid, cand_ok, K,
        cfg.safety_distance, spec.block_rows, by_gid=False)
    obs_slab = cand_s4[idx]                               # (C, K, 4)
    nearest1 = torch.where(mask[:, 0], dist[:, 0], torch.inf)
    dropped_rows = torch.clamp(count - K, min=0)

    u0 = swarm_scenario.complete_nominal(cfg, u0, x, v, obs_slab, mask)
    priority, cap = swarm_scenario.relax_tiers(cfg, mask, None)
    u_safe, info = safe_controls(
        states4, obs_slab, mask, f, g, u0, cbf,
        priority_mask=priority, relax_cap=cap,
        reference_layout=True, vel_box_rows=True)
    engaged = torch.any(mask, dim=1) & valid
    u = torch.where(engaged[:, None], u_safe, u0)

    i32 = torch.int32
    cert_res = torch.zeros((), dtype=dt_, device=dev)
    cert_dropped = torch.zeros((), dtype=i32, device=dev)
    cert_iters = torch.zeros((), dtype=i32, device=dev)
    if cfg.certificate:
        u, cert_res, cert_dropped, cert_iters = _apply_certificate_spatial(
            cfg, spec, u, x, valid, row_gid, cand_s4[:, :2], cand_gid,
            cand_ok, tile, axis)

    u = torch.where(valid[:, None], u, 0.0)
    x_new, v_new = swarm_scenario.integrate(cfg, x, v, u)
    x_new = torch.where(valid[:, None], x_new, x)
    v_new = torch.where(valid[:, None], v_new, 0.0)

    # Drift accounting: the halo coverage proof budgets each agent
    # sqrt(2) * speed_limit * dt * rebin_every of travel per epoch.
    allow = 1.05 * math.sqrt(2.0) * float(cfg.speed_limit) \
        * float(cfg.dt) * spec.rebin_every
    drifted = valid & (torch.sum((x_new - xb) ** 2, dim=1) > allow * allow)

    # The reductions in two collectives: the counts' psum and a pmax of
    # the negated nearest distance (pmin), the residual and the
    # certificate's counts, each exact in float64.
    near = torch.amin(torch.where(valid, nearest1, torch.inf))
    sums = axis.psum(torch.stack([
        torch.sum(engaged, dtype=torch.int64),
        torch.sum(~info.feasible & engaged, dtype=torch.int64),
        torch.sum(torch.where(valid, dropped_rows, 0), dtype=torch.int64),
        torch.sum(drifted, dtype=torch.int64)]))
    f64 = torch.float64
    maxes = axis.pmax(torch.stack([-near.to(f64), cert_res.to(f64),
                                   cert_dropped.to(f64),
                                   cert_iters.to(f64)]))
    metrics = (-maxes[0].to(dt_), sums[0].to(i32), sums[1].to(i32),
               sums[2].to(i32), maxes[1].to(dt_), maxes[2].to(i32),
               torch.zeros((), dtype=dt_, device=dev),   # single only
               maxes[3].to(i32), sums[3].to(i32))
    return x_new, v_new, metrics


N_STEP_METRICS = len(SpatialMetrics._fields)


# -------------------------------------------------------------- rollout ----

def _validate_spatial(cfg: swarm_scenario.Config, mesh):
    """Honoured-or-rejected: every knob the spatial step does not implement
    raises up front (the JAX package's texts)."""
    if cfg.dynamics != "single":
        raise ValueError(
            f"partition='spatial' supports single-integrator swarms only "
            f"(got dynamics={cfg.dynamics!r})")
    if cfg.n_obstacles:
        raise ValueError(
            "partition='spatial' does not support moving obstacles yet — "
            "the obstacle ring is untested against parked slab slots")
    if cfg.gating != "auto":
        raise ValueError(
            f"partition='spatial' runs its own halo-tiled jnp gating; an "
            f"explicit gating={cfg.gating!r} label would be dishonored")
    if cfg.gating_rebuild_skin or cfg.certificate_rebuild_skin:
        raise ValueError(
            "Verlet skins are whole-swarm-per-device paths — unset "
            "gating_rebuild_skin/certificate_rebuild_skin for "
            "partition='spatial'")
    if cfg.certificate:
        if swarm_scenario.certificate_backend(cfg) != "sparse":
            raise ValueError(
                "partition='spatial' needs the sparse certificate backend "
                "(the dense solver factorizes the full system and cannot "
                "row-partition)")
        if cfg.certificate_warm_start or cfg.certificate_tol is not None:
            raise ValueError(
                "certificate_warm_start/certificate_tol are whole-swarm-"
                "per-device modes (the row-partitioned solve rejects "
                "adaptive exits and cross-step carries)")
        if cfg.certificate_fused:
            raise ValueError(
                "certificate_fused requires sp == 1 — the row-partitioned "
                "solve keeps the CG path")
        if cfg.certificate_partition not in ("auto",):
            raise ValueError(
                "partition='spatial' is always row-partitioned; "
                f"certificate_partition={cfg.certificate_partition!r} "
                "would be dishonored")
    if "sp" not in mesh.shape or "dp" not in mesh.shape:
        raise ValueError("spatial rollouts need a (dp, sp) mesh "
                         "(parallel.mesh.make_mesh)")
    if mesh.shape["dp"] != 1:
        raise ValueError(
            f"partition='spatial' decomposes ONE swarm over sp — build "
            f"the mesh with n_dp=1 (got dp={mesh.shape['dp']})")


def spatial_swarm_rollout(cfg: swarm_scenario.Config, mesh, *,
                          steps: int | None = None,
                          cbf: CBFParams | None = None,
                          initial_state=None, t0: int = 0,
                          seed: int | None = None,
                          spec: SpatialSpec | None = None,
                          on_overflow: str = "raise",
                          telemetry=None):
    """Run one swarm spatially decomposed over the mesh's ``sp`` axis (on
    every rank of the mesh, with the same arguments).

    Epoch loop: every ``spec.rebin_every`` steps the binning pass
    re-assigns agents to tiles, then each rank advances its tile's slab
    with per-step halo exchange. The two host syncs per epoch (bin and
    halo counts) are where ``on_overflow`` fires: ``"raise"`` raises
    :class:`SpatialOverflowError` on any tile- or halo-capacity
    saturation; ``"fallback"`` counts and continues.

    ``initial_state``: optional (x0, v0) of (N, 2) tensors; otherwise the
    scenario's seeded spawn at ``seed`` (default ``cfg.seed``).
    ``telemetry``: one ``spatial_epoch`` event and gauge/counter updates
    per epoch, written by the primary rank.

    Returns ((x, v) global (N, 2) tensors in agent order, the same on
    every rank, :class:`SpatialMetrics` of (steps,) host leaves,
    :class:`SpatialReport`)."""
    _validate_spatial(cfg, mesh)
    if on_overflow not in ("raise", "fallback"):
        raise ValueError(
            f"on_overflow must be 'raise' or 'fallback', got "
            f"{on_overflow!r}")
    T = mesh.shape["sp"]
    if spec is None:
        spec = plan_tiles(cfg, T)
    if spec.n_tiles != T:
        raise ValueError(
            f"spec.n_tiles={spec.n_tiles} != mesh sp extent {T}")
    steps = cfg.steps if steps is None else steps
    dev = mesh.device
    if cbf is None:
        cbf = swarm_scenario.default_cbf(cfg, device=dev)
    if initial_state is not None:
        x, v = (torch.as_tensor(a, device=dev) for a in initial_state)
        if tuple(x.shape) != (cfg.n, 2) or tuple(v.shape) != (cfg.n, 2):
            raise ValueError(
                f"initial_state needs (x, v) of shape {(cfg.n, 2)}, got "
                f"{tuple(x.shape)} / {tuple(v.shape)}")
    else:
        x = swarm_scenario.clear_obstacle_spawn(
            cfg, swarm_scenario.spawn_positions(
                cfg, cfg.seed if seed is None else int(seed), device=dev))
        v = torch.zeros_like(x)

    from cbf_tpu_torch.parallel import multihost

    axis = mesh.axis("sp")
    tile, C = axis.index, spec.capacity
    primary = multihost.is_primary()
    chunks: list[tuple] = []
    overflow_total = halo_dropped_total = 0
    occupancy_max = halo_used_max = epochs = 0
    t = t0
    with torch.no_grad():
        while t < t0 + steps:
            n = min(spec.rebin_every, t0 + steps - t)
            x_slab, v_slab, valid_g, slot_of_agent, overflow, counts = _bin(
                x, v, spec.half, T, C)
            overflow = int(overflow)
            if overflow and on_overflow == "raise":
                raise SpatialOverflowError(
                    f"{overflow} agents exceeded tile capacity "
                    f"{spec.capacity} at step {t} (occupancy "
                    f"{[int(c) for c in counts]}) — raise plan_tiles slack "
                    f"or use on_overflow='fallback'")
            sl = slice(tile * C, (tile + 1) * C)
            xl, vl, valid = x_slab[sl], v_slab[sl], valid_g[sl]
            xb = xl
            plan = _halo_plan(xb, valid, spec, tile)
            mets = []
            for i in range(n):
                xl, vl, met = _tile_step(cfg, cbf, spec, t + i, xl, vl,
                                         valid, xb, plan, tile, axis)
                mets.append(met)
            occ_used = axis.pmax(torch.stack(
                [torch.sum(valid, dtype=torch.int32), plan.used]))
            halo_dropped = int(axis.psum(plan.dropped))
            occ_max, halo_used = int(occ_used[0]), int(occ_used[1])
            if halo_dropped and on_overflow == "raise":
                raise SpatialOverflowError(
                    f"{halo_dropped} halo band members exceeded "
                    f"halo_capacity {spec.halo_capacity} in the epoch at "
                    f"step {t} — raise plan_tiles halo_capacity or use "
                    f"on_overflow='fallback'")
            xf, vf = axis.all_gather(xl), axis.all_gather(vl)
            x, v = xf[slot_of_agent], vf[slot_of_agent]
            chunks.append(tuple(torch.stack(c).cpu().numpy()
                                for c in zip(*mets)))
            epochs += 1
            overflow_total += overflow
            halo_dropped_total += halo_dropped
            occupancy_max = max(occupancy_max, occ_max)
            halo_used_max = max(halo_used_max, halo_used)
            if telemetry is not None and primary:
                telemetry.event("spatial_epoch", {
                    "t": int(t), "steps": int(n), "tiles": T,
                    "overflow": overflow, "halo_dropped": halo_dropped,
                    "occupancy_max": occ_max, "halo_used_max": halo_used,
                    "capacity": spec.capacity,
                    "halo_capacity": spec.halo_capacity})
                reg = telemetry.registry
                reg.gauge("spatial.tile_occupancy_max").set(occ_max)
                reg.gauge("spatial.halo_used_max").set(halo_used)
                reg.counter("spatial.overflow_fallback").add(overflow)
                reg.counter("spatial.halo_dropped").add(halo_dropped)
            t += n

    metrics = SpatialMetrics(*(
        np.concatenate([c[i] for c in chunks])
        for i in range(N_STEP_METRICS)))
    report = SpatialReport(
        epochs=epochs, overflow_total=overflow_total,
        halo_dropped_total=halo_dropped_total,
        occupancy_max=occupancy_max, halo_used_max=halo_used_max)
    return (x, v), metrics, report


def ensemble_adapter(cfg: swarm_scenario.Config, mesh, seeds,
                     steps: int | None, cbf, initial_state, t0: int,
                     telemetry=None, spec: SpatialSpec | None = None,
                     on_overflow: str = "raise"):
    """``sharded_swarm_rollout(partition="spatial")``'s delegate: one
    swarm (len(seeds) == 1, dp == 1), ensemble-shaped returns — (x, v)
    as (1, N, 2) tensors and the first eight metric channels as a
    (1, steps)-leaved EnsembleMetrics of numpy arrays."""
    if len(seeds) != 1:
        raise ValueError(
            f"partition='spatial' decomposes ONE swarm — pass exactly one "
            f"seed (got {len(seeds)}); Monte-Carlo ensembles use the flat "
            f"dp partition")
    if initial_state is not None:
        x0, v0 = initial_state[0], initial_state[1]
        if tuple(x0.shape) != (1, cfg.n, 2):
            raise ValueError(
                f"initial_state x0 shape {tuple(x0.shape)} != "
                f"{(1, cfg.n, 2)}")
        initial_state = (x0[0], v0[0])
    (x, v), m, _report = spatial_swarm_rollout(
        cfg, mesh, steps=steps, cbf=cbf, initial_state=initial_state,
        t0=t0, seed=seeds[0], spec=spec, on_overflow=on_overflow,
        telemetry=telemetry)
    em = EnsembleMetrics(*(np.asarray(getattr(m, f))[None]
                           for f in EnsembleMetrics._fields))
    return (x[None], v[None]), em


# ------------------------------------------------------- debug surface ----

def spatial_knn_sets(cfg: swarm_scenario.Config, mesh, x, *,
                     spec: SpatialSpec | None = None):
    """The spatial gating's per-agent neighbour sets at positions ``x``
    (N, 2), as a list of N sets of GLOBAL agent ids (the same on every
    rank) — one bin pass and one halo-tiled selection, no dynamics."""
    _validate_spatial(cfg, mesh)
    T = mesh.shape["sp"]
    if spec is None:
        spec = plan_tiles(cfg, T)
    dev = mesh.device
    x = torch.as_tensor(np.asarray(x), dtype=cfg.dtype, device=dev)
    v = torch.zeros_like(x)
    C = spec.capacity
    x_slab, _, valid_g, slot_of_agent, _, _ = _bin(x, v, spec.half, T, C)
    K = min(cfg.k_neighbors, cfg.n - 1)
    axis = mesh.axis("sp")
    tile = axis.index
    sl = slice(tile * C, (tile + 1) * C)
    xs, vs = x_slab[sl], valid_g[sl]
    plan = _halo_plan(xs, vs, spec, tile)
    states4 = torch.cat([xs, torch.zeros_like(xs)], dim=1)
    cand_s4, cand_gid, cand_ok = _halo_candidates(states4, vs, plan, spec,
                                                  tile, axis)
    row_gid = tile * C + torch.arange(C, device=dev)
    idx, mask, _, _ = _blocked_select(
        xs, row_gid, vs, cand_s4[:, :2], cand_gid, cand_ok, K,
        cfg.safety_distance, spec.block_rows, by_gid=False)
    kept = axis.all_gather(torch.where(mask, cand_gid[idx], -1))
    kept = kept.cpu().numpy()                            # (T*C, K) slab gids
    slot_of_agent = slot_of_agent.cpu().numpy()
    agent_of_slot = np.full((T * C,), -1, np.int64)
    agent_of_slot[slot_of_agent] = np.arange(cfg.n)
    return [{int(agent_of_slot[g]) for g in kept[int(slot_of_agent[a])]
             if g >= 0} for a in range(cfg.n)]
