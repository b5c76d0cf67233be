"""Joint all-agent barrier certificate — the second QP of the safety stack
(counterpart: cbf_tpu/sim/certificates.py).

A joint minimum-deviation QP over every agent's single-integrator velocity
enforcing (a) pairwise distance >= safety_radius through cubic-margin CBF
rows and (b) arena-boundary rows, after pre-limiting command magnitudes:

    min_u ||u - u_nom||^2
    s.t.  -2 (x_i - x_j)^T (u_i - u_j) <= gain * h_ij^3,   h_ij = ||x_i - x_j||^2 - r^2
          +-u_{k,axis} <= 0.4 * gain * (wall margin)^3

Two backends, as in the JAX package: the dense QP (all pairs, optionally
pruned to the ``max_pairs`` tightest, solved by
:mod:`cbf_tpu_torch.solvers.admm`) and the sparse one (each agent owns
``k`` rows to its nearest in-radius neighbours, solved matrix-free by
:mod:`cbf_tpu_torch.solvers.sparse_admm`). The sparse neighbour search
goes through :func:`cbf_tpu_torch.ops.knn.knn_select` — the ``knn_fused``
kernel up to ``knn.MAX_N_FUSED`` agents, ``knn_stream`` beyond (their
plain versions on a CPU tensor) — or, with ``neighbor_backend="jnp"``,
the dense difference-form search with a stable sort (ties to the lower
index, as ``lax.top_k``).

The sparse search's Verlet cache (``rebuild_skin``) is a ``lax.cond`` in
the JAX package. Eagerly it is a host branch; inside the compiled
rollout's body (:func:`cbf_tpu_torch.solvers.exact2d.in_guarded_body`)
the rebuild search runs on every step and ``torch.where`` on the 0-dim
predicate picks rebuilt or cached values — bit-identical to either branch.

The row-partitioned twin (:func:`si_barrier_certificate_sparse_sharded`)
runs on each rank of the mesh's ``sp`` axis: each rank searches and
iterates only its own agents' pair rows; the solver's psum completes the
transpose.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from cbf_tpu_torch.ops import knn
from cbf_tpu_torch.ops.pairwise import pairwise_distances
from cbf_tpu_torch.sim.robotarium import ARENA
from cbf_tpu_torch.solvers import exact2d
from cbf_tpu_torch.solvers.admm import ADMMSettings, solve_box_qp_admm
from cbf_tpu_torch.solvers.sparse_admm import (SparseADMMSettings,
                                               solve_pair_box_qp_admm,
                                               solve_pair_box_qp_admm_batched)
from cbf_tpu_torch.utils.math import safe_norm


class CertificateParams(NamedTuple):
    barrier_gain: float = 100.0
    safety_radius: float = 0.12
    magnitude_limit: float = 0.2


class SparseCertificateInfo(NamedTuple):
    primal_residual: torch.Tensor
    dual_residual: torch.Tensor
    # In-binding-radius pairs covered by neither endpoint's k row slots,
    # each lost pair counted once: the sparse path's truncation against
    # the dense all-pairs rows; callers surface it.
    dropped_count: torch.Tensor
    # ADMM iterations actually run (SparseADMMInfo.iterations).
    iterations: torch.Tensor = ()


@functools.lru_cache(maxsize=None)
def _triu_pairs(n: int, device: torch.device):
    """(I, J) int64 of every unordered pair i < j in row-major order
    (``np.triu_indices(n, k=1)``), built once per (n, device)."""
    I, J = np.triu_indices(n, k=1)
    return (torch.as_tensor(I, dtype=torch.int64, device=device),
            torch.as_tensor(J, dtype=torch.int64, device=device))


@functools.lru_cache(maxsize=None)
def _boundary_rows(n: int, dtype: torch.dtype, device: torch.device):
    """(4N, 2N) arena-boundary rows: per agent +u_y, -u_y, +u_x, -u_x."""
    A = np.zeros((4 * n, 2 * n))
    k = np.arange(n)
    A[4 * k + 0, 2 * k + 1] = 1.0
    A[4 * k + 1, 2 * k + 1] = -1.0
    A[4 * k + 2, 2 * k + 0] = 1.0
    A[4 * k + 3, 2 * k + 0] = -1.0
    return torch.as_tensor(A, dtype=dtype, device=device)


def si_barrier_certificate(dxi, x, params: CertificateParams = CertificateParams(),
                           settings: ADMMSettings = ADMMSettings(iters=250),
                           max_pairs: int | None = None,
                           with_info: bool = False,
                           arena: tuple | None = ARENA):
    """Filter joint single-integrator velocities: dxi (2, N), x (2, N) ->
    certified (2, N)[, ADMMInfo].

    The dense QP has 2N variables and N(N-1)/2 + 4N rows. ``max_pairs``
    keeps only that many tightest pair rows (smallest h; a stable sort, so
    ties keep the lower pair index first as ``lax.top_k`` does) — far
    pairs are slack under the cubic margin. ``arena`` (xmin, xmax, ymin,
    ymax) gives the boundary rows, None drops them."""
    N = x.shape[1]
    dtype = torch.promote_types(dxi.dtype, x.dtype)
    device = x.device

    # Magnitude pre-limit (threshold to magnitude_limit, keep direction).
    norms = torch.linalg.vector_norm(dxi, dim=0)
    scale = torch.clamp(norms / params.magnitude_limit, min=1.0)
    dxi = dxi / scale[None, :]

    I, J = _triu_pairs(N, device)
    err = x[:, I] - x[:, J]                                  # (2, P)
    h = torch.sum(err * err, dim=0) - params.safety_radius ** 2
    P_rows = I.shape[0]
    if max_pairs is not None and max_pairs < P_rows:
        keep = torch.sort(h, stable=True).indices[:max_pairs]
        I, J, h, err = I[keep], J[keep], h[keep], err[:, keep]
        P_rows = max_pairs
    # Row p holds -2 err at agent I[p] and 2 err at J[p], zero elsewhere:
    # selected out of place (an index_put_ into a fresh tensor cannot
    # take the falsifier's member axis under torch.func.vmap).
    agents = torch.arange(N, device=device)
    A3 = torch.where(
        (agents == I[:, None])[..., None], (-2.0 * err.T).to(dtype)[:, None],
        torch.where((agents == J[:, None])[..., None],
                    (2.0 * err.T).to(dtype)[:, None],
                    torch.zeros((), dtype=dtype, device=device)))
    A_pair = A3.reshape(P_rows, 2 * N)
    b_pair = params.barrier_gain * h ** 3

    if arena is not None:
        # Boundary rows: keep each agent r/2 inside the arena walls.
        xmin, xmax, ymin, ymax = arena
        r2 = params.safety_radius / 2.0
        gb = 0.4 * params.barrier_gain
        b_bnd = torch.stack([gb * (ymax - r2 - x[1]) ** 3,
                             gb * (x[1] - ymin - r2) ** 3,
                             gb * (xmax - r2 - x[0]) ** 3,
                             gb * (x[0] - xmin - r2) ** 3], dim=1)
        A = torch.cat([A_pair, _boundary_rows(N, dtype, device)], dim=0)
        b = torch.cat([b_pair, b_bnd.reshape(-1)]).to(dtype)
    else:
        A, b = A_pair, b_pair.to(dtype)

    u_nom = dxi.T.reshape(-1)                                # [ux0, uy0, ...]
    Pmat = torch.eye(2 * N, dtype=dtype, device=device)
    m = A.shape[0]
    lower = torch.full((m,), -torch.inf, dtype=dtype, device=device)
    u, info = solve_box_qp_admm(Pmat, -u_nom, A, lower, b, settings)
    out = u.reshape(N, 2).T
    if with_info:
        return out, info
    return out


@functools.lru_cache(maxsize=None)
def binding_pair_radius(params: CertificateParams,
                        headroom: float = 1.25,
                        solution_speed_cap: float | None = None) -> float:
    """Smallest separation beyond which a pair row can never bind, from
    the params: the row's left side is bounded by 4 d c (d the separation,
    c a bound on the certified per-agent speed, default 2 x
    magnitude_limit) while its margin is gain (d^2 - r^2)^3, so past the
    crossing the row is structurally slack. Host bisection, times
    ``headroom`` (the JAX package's function, copied; its docstring
    states the assumptions)."""
    gain, r = params.barrier_gain, params.safety_radius
    c = (2.0 * params.magnitude_limit if solution_speed_cap is None
         else solution_speed_cap)
    lo = r
    hi = max(4.0 * r, 1.0)
    while gain * (hi * hi - r * r) ** 3 < 4.0 * hi * c:
        hi *= 2.0
        if hi > 1e6:   # degenerate params (gain ~ 0): nothing ever slack
            return float("inf")
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if gain * (mid * mid - r * r) ** 3 < 4.0 * mid * c:
            lo = mid
        else:
            hi = mid
    return float(hi * headroom)


def certificate_cache_seed(N: int, k: int, dtype=torch.float32, *,
                           device="cpu"):
    """Fresh Verlet cache for the sparse certificate's neighbour search:
    (idx (N, kc) int32, x_build (N, 2) — +inf forces a first-step
    rebuild, dropped () int32 — the build-time coverage gap)."""
    return (torch.zeros((N, min(k, N - 1)), dtype=torch.int32,
                        device=device),
            torch.full((N, 2), torch.inf, dtype=dtype, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def certificate_solver_seed(N: int, k: int, dtype=torch.float32, *,
                            device="cpu"):
    """All-zero sparse-ADMM carry (x, z_p, z_b, y_p, y_b) — bitwise the
    solver's cold start; R = N * min(k, N-1) pair rows, 2N box slots."""
    R = N * min(k, N - 1)
    z2n = torch.zeros((2 * N,), dtype=dtype, device=device)
    zr = torch.zeros((R,), dtype=dtype, device=device)
    return (z2n, zr, z2n.clone(), zr.clone(), z2n.clone())


def sanitize_solver_state(solver_state):
    """Branch-free warm-carry sanitizer: ``(clean_state, reset)``. If any
    leaf holds a non-finite value the whole carry resets to the all-zero
    cold start, selected with ``torch.where`` (no host read). ``reset`` is
    a 0-dim bool tensor; ``()`` passes through with ``reset`` False."""
    if isinstance(solver_state, tuple) and len(solver_state) == 0:
        return solver_state, torch.zeros((), dtype=torch.bool)
    bad = torch.zeros((), dtype=torch.bool, device=solver_state[0].device)
    for leaf in solver_state:
        bad = bad | ~torch.all(torch.isfinite(leaf))
    clean = tuple(torch.where(bad, torch.zeros_like(leaf), leaf)
                  for leaf in solver_state)
    return clean, bad


def _agent_rows(N: int, k: int, device):
    """(N * k,) int64 owner of each agent-major row: repeat(arange(N), k)."""
    return torch.arange(N, device=device)[:, None].expand(N, k).reshape(-1)


def _nominal(dxi, params: CertificateParams):
    """(N, 2) nominal after the magnitude pre-limit (safe_norm, as the
    JAX package's sparse path takes it)."""
    norms = safe_norm(dxi, dim=0)
    scale = torch.clamp(norms / params.magnitude_limit, min=1.0)
    return (dxi / scale[None, :]).T


def si_barrier_certificate_sparse(
        dxi, x, params: CertificateParams = CertificateParams(),
        settings: SparseADMMSettings = SparseADMMSettings(),
        k: int = 32, pair_radius: float | None = None,
        with_info: bool = False, arena: tuple | None = ARENA,
        neighbor_backend: str = "auto", pallas_interpret: bool = False,
        rebuild_skin: float = 0.0, neighbor_cache=None,
        solver_state=None):
    """Swarm-scale joint certificate: the guarantee surface of
    :func:`si_barrier_certificate` in O(N k) rows.

    Each agent owns ``k`` rows to its nearest neighbours within
    ``pair_radius`` (default :func:`binding_pair_radius`); the arena rows
    become a component box; the QP solves matrix-free. In-radius pairs
    covered by neither endpoint's slots are counted in the returned info.
    ``neighbor_backend``: "auto" or "pallas" take the k-NN kernels
    (:func:`knn.knn_select`), "jnp" the dense search; ``pallas_interpret``
    is accepted for the JAX signature and changes nothing (a CPU tensor
    takes the kernels' plain versions).

    ``rebuild_skin`` > 0 with a ``neighbor_cache``
    (:func:`certificate_cache_seed`) applies the Verlet scheme to this
    search (module docstring) and appends the new cache to the return;
    ``solver_state`` (:func:`certificate_solver_seed` on step 0, ``()`` =
    absent) warm-starts the solve and appends the new carry last.

    Args/returns: dxi (2, N), x (2, N) -> certified (2, N)[,
    SparseCertificateInfo][, new_cache][, new_solver_state]."""
    N = x.shape[1]
    dtype = torch.promote_types(dxi.dtype, x.dtype)
    if pair_radius is None:
        pair_radius = binding_pair_radius(params)
    solver_state = solver_state or None

    u_nom = _nominal(dxi, params)
    xt = x.T
    k = min(k, N - 1)
    use_kernel = _use_pallas_search(neighbor_backend, N)

    def search(radius):
        return _exact_search(xt, k, radius, use_kernel, pallas_interpret)

    new_cache = None
    if rebuild_skin:
        if neighbor_cache is None:
            raise ValueError("rebuild_skin > 0 needs a neighbor_cache "
                             "(certificate_cache_seed) threaded through "
                             "the caller's carry")
        r_build = pair_radius + float(rebuild_skin)
        cache = tuple(neighbor_cache)

        def rebuild():
            idx, bmask, count = search(r_build)
            return idx, xt, _slot_coverage_gap(idx, bmask, count, N, k)

        disp2 = torch.amax(torch.sum((xt - cache[1]) ** 2, dim=1))
        stale = disp2 > (0.5 * float(rebuild_skin)) ** 2
        if exact2d.in_guarded_body():
            cache = tuple(torch.where(stale, new, old)
                          for new, old in zip(rebuild(), cache))
        elif bool(stale):
            cache = rebuild()
        idx, _, dropped = cache
        d = torch.sqrt(torch.sum(
            (xt[:, None, :] - xt[idx.to(torch.int64)]) ** 2, dim=-1))
        # Fresh-radius re-check (0 < d also masks self-pointing fillers):
        # rows beyond pair_radius stay out.
        mask = (d > 0.0) & (d < pair_radius)
        new_cache = cache
    else:
        idx, mask, count = search(pair_radius)
        dropped = _slot_coverage_gap(idx, mask, count, N, k)

    I = _agent_rows(N, k, x.device)
    J = idx.reshape(-1).to(torch.int64)
    coef, b_pair = _pair_row_geometry(xt, I, J, mask.reshape(-1), params,
                                      dtype)
    lo, hi = _arena_box(xt, params, arena, dtype)

    # The rows are agent-major (I = repeat(arange(N), k)): the solver's
    # transpose takes the I side as a reshape-sum.
    solve = solve_pair_box_qp_admm(u_nom, I, J, coef, b_pair, lo, hi,
                                   settings, agent_k=k,
                                   warm_state=solver_state,
                                   with_state=solver_state is not None)
    u, info = solve[0], solve[1]
    out = u.T
    ret = (out,)
    if with_info:
        ret += (SparseCertificateInfo(info.primal_residual,
                                      info.dual_residual, dropped,
                                      info.iterations),)
    if rebuild_skin:
        ret += (new_cache,)
    if solver_state is not None:
        ret += (solve[2],)
    return ret if len(ret) > 1 else out


def _use_pallas_search(neighbor_backend: str, N: int) -> bool:
    """The neighbour-backend dispatch, shared by the replicated and the
    batched entries: the kernels for "pallas", and for "auto" within the
    kernels' bound."""
    return (neighbor_backend == "pallas"
            or (neighbor_backend == "auto" and knn.supported(N)))


def _exact_search(xt, k: int, radius, use_kernel: bool,
                  pallas_interpret: bool = False):
    """(idx (N, k) int32, mask (N, k) bool, count (N,) int32) under
    ``radius`` over positions xt (N, 2): the one search of the exact path,
    the Verlet rebuild and the batched twin. The kernels exclude exact
    coincidences (d > 0), the dense form excludes by index."""
    N = xt.shape[0]
    if use_kernel:
        idx, dist_k, _, count = knn.knn_select(xt, radius, k)
        return idx, torch.isfinite(dist_k), count
    dist = pairwise_distances(xt)                           # (N, N)
    eye = torch.eye(N, dtype=torch.bool, device=xt.device)
    eligible = (dist < radius) & ~eye
    keyed = torch.where(eligible, dist, torch.inf)
    key, idx = torch.sort(keyed, dim=1, stable=True)
    return (idx[:, :k].to(torch.int32), torch.isfinite(key[:, :k]),
            torch.sum(eligible, dim=1, dtype=torch.int32))


def _slot_coverage_gap(idx, mask, count, N: int, k: int):
    """In-radius pairs covered by neither endpoint's k slots, each counted
    once: eligible unordered pairs D/2 less the covered ones S - M/2 (S
    kept entries, M kept entries whose reverse is also kept). 0-dim
    int32."""
    I = _agent_rows(N, k, idx.device)
    J = idx.reshape(-1).to(torch.int64)
    D = torch.sum(count, dtype=torch.int32)
    S = torch.sum(mask, dtype=torch.int32)
    mutual = mask.reshape(-1) & torch.any(
        (idx[J] == I[:, None].to(idx.dtype)) & mask[J], dim=1)
    M = torch.sum(mutual, dtype=torch.int32)
    return D // 2 - (S - M // 2)


def si_barrier_certificate_sparse_batched(
        dxi, x, params: CertificateParams = CertificateParams(),
        settings: SparseADMMSettings = SparseADMMSettings(),
        k: int = 32, pair_radius: float | None = None,
        with_info: bool = False, arena: tuple | None = ARENA,
        neighbor_backend: str = "auto", pallas_interpret: bool = False,
        solver_state=None):
    """Lockstep-batched twin of :func:`si_barrier_certificate_sparse` over
    a member axis: E certificates through one shared ADMM loop
    (:func:`solve_pair_box_qp_admm_batched`). dxi, x (E, 2, N) ->
    certified (E, 2, N)[, SparseCertificateInfo of (E,) leaves][,
    new_solver_state]. No Verlet cache."""
    E, _, N = x.shape
    dtype = torch.promote_types(dxi.dtype, x.dtype)
    if pair_radius is None:
        pair_radius = binding_pair_radius(params)
    solver_state = solver_state or None
    k = min(k, N - 1)
    use_kernel = _use_pallas_search(neighbor_backend, N)
    I = _agent_rows(N, k, x.device)

    parts = []
    for e in range(E):
        xt = x[e].T
        idx, mask, count = _exact_search(xt, k, pair_radius, use_kernel,
                                         pallas_interpret)
        J = idx.reshape(-1).to(torch.int64)
        coef, b_pair = _pair_row_geometry(xt, I, J, mask.reshape(-1),
                                          params, dtype)
        lo, hi = _arena_box(xt, params, arena, dtype)
        parts.append((_nominal(dxi[e], params), J, coef, b_pair, lo, hi,
                      _slot_coverage_gap(idx, mask, count, N, k)))
    u_nom, J, coef, b_pair, lo, hi, dropped = (torch.stack(p)
                                                for p in zip(*parts))
    solve = solve_pair_box_qp_admm_batched(
        u_nom, I, J, coef, b_pair, lo, hi, settings, agent_k=k,
        warm_state=solver_state, with_state=solver_state is not None)
    u, info = solve[0], solve[1]
    ret = (torch.swapaxes(u, 1, 2),)
    if with_info:
        ret += (SparseCertificateInfo(info.primal_residual,
                                      info.dual_residual, dropped,
                                      info.iterations),)
    if solver_state is not None:
        ret += (solve[2],)
    return ret if len(ret) > 1 else ret[0]


def _pair_row_geometry(xt, I, J, maskf, params: CertificateParams, dtype):
    """(coef, b_pair) for pair rows I -> J over positions xt (N, 2) — the
    one definition of the sparse certificate's row geometry."""
    err = xt[I] - xt[J]                                      # (R, 2)
    h = torch.sum(err * err, dim=1) - params.safety_radius ** 2
    coef = torch.where(maskf[:, None], -2.0 * err, 0.0).to(dtype)
    b_pair = torch.where(maskf, params.barrier_gain * h ** 3,
                         torch.inf).to(dtype)
    return coef, b_pair


def _arena_box(xt, params: CertificateParams, arena, dtype):
    """(lo, hi) (N, 2) component box from the arena-boundary rows."""
    N = xt.shape[0]
    if arena is None:
        hi = torch.full((N, 2), torch.inf, dtype=dtype, device=xt.device)
        return -hi, hi
    xmin, xmax, ymin, ymax = arena
    r2 = params.safety_radius / 2.0
    gb = 0.4 * params.barrier_gain
    hi = torch.stack([gb * (xmax - r2 - xt[:, 0]) ** 3,
                      gb * (ymax - r2 - xt[:, 1]) ** 3], dim=1)
    lo = torch.stack([-gb * (xt[:, 0] - xmin - r2) ** 3,
                      -gb * (xt[:, 1] - ymin - r2) ** 3], dim=1)
    return lo.to(dtype), hi.to(dtype)


def si_barrier_certificate_sparse_sharded(
        dxi, x, axis_name,
        params: CertificateParams = CertificateParams(),
        settings: SparseADMMSettings = SparseADMMSettings(),
        k: int = 32, pair_radius: float | None = None,
        with_info: bool = False, arena: tuple | None = ARENA):
    """Row-partitioned twin of :func:`si_barrier_certificate_sparse`, run
    on every rank of ``axis_name`` (the mesh's ``sp``
    :class:`~cbf_tpu_torch.parallel.mesh.Axis`): the joint QP still
    couples all N agents, but each rank builds and iterates only the pair
    rows its LOCAL agents own (agents [index * N / n, ...)), so the
    O(N * k) row work splits over the axis. The (N, 2) iterate stays
    replicated; the collectives are one (2N,) psum per K application and
    the residual reductions (solve_pair_box_qp_admm's ``axis_name``).

    Args: dxi, x — GLOBAL (2, N) tensors, the same on every rank; N must
    divide by the axis size. Returns the full certified (2, N), the same
    on every rank [, SparseCertificateInfo with globally reduced
    residuals and dropped count]. The neighbour search is the exact form
    on this rank's (n_local, N) block, stable-sorted (ties to the lower
    index, as ``lax.top_k``). No gradient is claimed (the trainer takes
    the replicated path)."""
    from cbf_tpu_torch.parallel.mesh import resolve_axis

    axis = resolve_axis(axis_name)
    N = x.shape[1]
    n_shards = axis.size
    if N % n_shards:
        raise ValueError(f"N={N} must be divisible by the {axis.name!r} "
                         f"axis size {n_shards}")
    n_local = N // n_shards
    dtype = torch.promote_types(dxi.dtype, x.dtype)
    if pair_radius is None:
        pair_radius = binding_pair_radius(params)
    k = min(k, N - 1)
    dev = x.device

    u_nom = _nominal(dxi, params)                            # (N, 2)
    xt = x.T                                                 # (N, 2)
    i0 = axis.index * n_local
    gI = i0 + torch.arange(n_local, device=dev)              # global rows
    dist = pairwise_distances(xt[i0:i0 + n_local], xt)       # (n_local, N)
    eligible = ((dist < pair_radius)
                & (torch.arange(N, device=dev)[None, :] != gI[:, None]))
    keyed = torch.where(eligible, dist, torch.inf)
    key, idx = torch.sort(keyed, dim=1, stable=True)
    idx = idx[:, :k]
    mask = torch.isfinite(key[:, :k])
    count = torch.sum(eligible, dim=1, dtype=torch.int32)

    # Symmetric coverage accounting (the replicated path's formula): the
    # reverse-row lookup needs every rank's kept slots, so the (N, k)
    # tables are gathered once and the counts psum to the global D/S/M.
    idx_g = axis.all_gather(idx)                             # (N, k)
    mask_g = axis.all_gather(mask)
    I = gI[:, None].expand(n_local, k).reshape(-1)
    J = idx.reshape(-1)
    maskf = mask.reshape(-1)
    mutual = maskf & torch.any((idx_g[J] == I[:, None]) & mask_g[J], dim=1)
    D = axis.psum(torch.sum(count, dtype=torch.int32))
    S = axis.psum(torch.sum(mask, dtype=torch.int32))
    M = axis.psum(torch.sum(mutual, dtype=torch.int32))
    dropped = D // 2 - (S - M // 2)

    coef, b_pair = _pair_row_geometry(xt, I, J, maskf, params, dtype)
    lo, hi = _arena_box(xt, params, arena, dtype)

    # agent_k/rows_start: this rank's rows are agent-major from its block
    # offset, so the solver's I-side transpose needs no scatter.
    u, info = solve_pair_box_qp_admm(u_nom, I, J, coef, b_pair, lo, hi,
                                     settings, axis_name=axis, agent_k=k,
                                     rows_start=i0)
    # The solve's outputs are replicated over the axis; the pmax is JAX's
    # (it re-asserts the replicated type there) and keeps the ranks
    # bit-identical here.
    out = axis.pmax(u).T
    if with_info:
        return out, SparseCertificateInfo(
            axis.pmax(info.primal_residual), axis.pmax(info.dual_residual),
            dropped, info.iterations)
    return out
