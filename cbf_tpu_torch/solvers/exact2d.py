"""Exact, branch-free, batched solver for 2-variable inequality QPs
(counterpart: cbf_tpu/solvers/exact2d.py).

``min ||x||^2 s.t. A x <= b`` is the Euclidean projection of the origin
onto a 2-D polyhedron, whose optimal active set has at most two
independent rows. So every KKT candidate is enumerated in fixed shape —
the origin, M single-row projections, M*(M-1)/2 two-row intersections —
each is checked for primal feasibility and dual sign, and the valid
candidate of least norm wins. An empty polyhedron (no valid candidate)
triggers the reference's recovery (cbf.py:78-87): +1 on every relaxable
row's RHS per round, bounded by ``max_relax``, the count reported.

The relax loop's condition is a scalar read on the host: one device sync
per round, and one per call in the all-feasible common case. Inside
:func:`guarded_relax` (the compiled rollout's step, which a CUDA graph
captures) the batch solver runs a fixed number of rounds on the device
instead and raises a device flag where the loop would have gone on
(:func:`relax_guarded`); the rollout then redoes that stretch eagerly.
Every lane runs its own relax schedule in both forms, so the full-row
lanes of the per-agent (mixed-dynamics) filter go through the same
loop and guard as the deduplicated ones.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import NamedTuple

import numpy as np
import torch

_BIG = 1e30


class QPInfo(NamedTuple):
    feasible: torch.Tensor       # bool — a valid KKT point was found
    relax_rounds: torch.Tensor   # float — +1 relaxations applied
    max_violation: torch.Tensor  # float — max(A x - b) at the solution


def _feas_tol(dtype) -> float:
    return 1e-6 if dtype == torch.float64 else 1e-4


@functools.lru_cache(maxsize=None)
def _pairs(m: int, device: torch.device):
    """(I, J) pair indices of M rows on ``device``, built once per (M,
    device): a host-to-device copy in the step would not survive graph
    capture."""
    I, J = np.triu_indices(m, k=1)
    return (torch.as_tensor(I, dtype=torch.int64, device=device),
            torch.as_tensor(J, dtype=torch.int64, device=device))


class _Geometry(NamedTuple):
    """What the enumeration needs of A alone (agents-last layout): the
    same for every relax round, so a round recomputes only what depends
    on b."""
    I: torch.Tensor
    J: torch.Tensor
    row_ok: torch.Tensor         # (M, N) row is not padding
    safe_n2: torch.Tensor        # (M, N) |a|^2, 1 on padding rows
    ai: torch.Tensor             # (P, 2, N) pair rows
    aj: torch.Tensor
    safe_det: torch.Tensor       # (P, N)
    gii: torch.Tensor            # (P, N) Gram entries
    gjj: torch.Tensor
    gij: torch.Tensor
    safe_detG: torch.Tensor
    pair_ok: torch.Tensor        # (P, N) both rows and both dets usable
    origin: torch.Tensor         # (1, 2, N) the origin candidate
    origin_ok: torch.Tensor      # (1, N) its dual sign (always True)


def _geometry(A, I, J) -> _Geometry:
    """:class:`_Geometry` of A (M, 2, N) with pair indices I, J."""
    N = A.shape[2]
    norms2 = torch.sum(A * A, dim=1)                      # (M, N)
    row_ok = norms2 > 1e-12
    ai, aj = A[I], A[J]                                   # (P, 2, N)
    det = ai[:, 0] * aj[:, 1] - ai[:, 1] * aj[:, 0]
    det_ok = torch.abs(det) > 1e-10
    gii, gjj = norms2[I], norms2[J]
    gij = torch.sum(ai * aj, dim=1)
    detG = gii * gjj - gij * gij
    detG_ok = torch.abs(detG) > 1e-20
    return _Geometry(
        I, J, row_ok, torch.where(row_ok, norms2, 1.0), ai, aj,
        torch.where(det_ok, det, 1.0), gii, gjj, gij,
        torch.where(detG_ok, detG, 1.0),
        det_ok & detG_ok & row_ok[I] & row_ok[J],
        torch.zeros((1, 2, N), dtype=A.dtype, device=A.device),
        torch.ones((1, N), dtype=torch.bool, device=A.device))


def _project(geo: _Geometry, A, b, tol):
    """Enumeration projection, agents-last layout, of A (M, 2, N) — whose
    :class:`_Geometry` is ``geo`` — and b (M, N). Returns (x (2, N),
    valid_found (N,), viol (N,)): the exact minimizer where a valid
    candidate exists, else the least-violating candidate."""
    N = A.shape[2]
    # Single-row candidates.
    x_single = A * (b / geo.safe_n2)[:, None, :]          # (M, 2, N)
    dual_single = geo.row_ok & (b <= tol)

    # Pair candidates.
    ai, aj = geo.ai, geo.aj
    bi, bj = b[geo.I], b[geo.J]
    x_pair = torch.stack(
        [(aj[:, 1] * bi - ai[:, 1] * bj) / geo.safe_det,
         (ai[:, 0] * bj - aj[:, 0] * bi) / geo.safe_det], dim=1)
    lam_i = (-bi * geo.gjj + bj * geo.gij) / geo.safe_detG
    lam_j = (-bj * geo.gii + bi * geo.gij) / geo.safe_detG
    dual_pair = geo.pair_ok & (lam_i >= -tol) & (lam_j >= -tol)

    X = torch.cat([geo.origin, x_single, x_pair], dim=0)  # (C, 2, N)
    dual_ok = torch.cat([geo.origin_ok, dual_single, dual_pair],
                        dim=0)                            # (C, N)
    AX = (X[:, None, 0, :] * A[None, :, 0, :]
          + X[:, None, 1, :] * A[None, :, 1, :])          # (C, M, N)
    viol = torch.amax(AX - b[None], dim=1)                # (C, N)
    valid = (viol <= tol) & dual_ok
    score = torch.sum(X * X, dim=1) + torch.where(valid, 0.0, _BIG)
    any_valid = torch.any(valid, dim=0)                   # (N,)
    score = torch.where(any_valid[None], score, viol)
    idx = torch.argmin(score, dim=0)                      # first minimizer
    x = torch.gather(X, 0, idx[None, None, :].expand(1, 2, N))[0]
    v = torch.gather(viol, 0, idx[None, :])[0]
    return x, any_valid, v


def _slack(t, rt, ct):
    slack = t * rt
    return slack if ct is None else torch.minimum(slack, ct)


def _relax_loop(At, bt, rt, ct, tol, I, J, max_relax: int):
    """The scalar-guarded relax loop over lanes: while any lane is
    infeasible, every unsolved lane retries at the batch-global
    t_next = max(t) + 1 (the JAX package's exact policy)."""
    geo = _geometry(At, I, J)
    x, found, viol = _project(geo, At, bt, tol)
    t = torch.zeros(found.shape, dtype=At.dtype, device=At.device)
    while bool(torch.any(~found) & (torch.amax(t) < max_relax)):
        t_next = torch.amax(t) + 1.0
        x2, f2, v2 = _project(geo, At, bt + _slack(t_next, rt, ct), tol)
        upd = ~found
        x = torch.where(upd[None], x2, x)
        viol = torch.where(upd, v2, viol)
        t = torch.where(upd, t_next, t)
        found = found | f2
    return x, found, t, viol


def _fixed_rounds(At, bt, rt, ct, tol, I, J, b0, rounds: int):
    """The first projection at RHS ``b0``, then ``rounds`` +1 relax
    attempts with where-selects (per-lane t): while a lane is unsolved it
    always advances to the latest attempt, matching the while form, which
    ends on the last attempt with t at the cap when nothing is ever
    feasible. Returns (x, found, t, viol)."""
    geo = _geometry(At, I, J)
    x, found, viol = _project(geo, At, b0, tol)
    t = torch.zeros(found.shape, dtype=At.dtype, device=At.device)
    for r in range(1, rounds + 1):
        x2, f2, v2 = _project(geo, At, bt + _slack(float(r), rt, ct), tol)
        upd = ~found
        x = torch.where(upd[None], x2, x)
        viol = torch.where(upd, v2, viol)
        t = torch.where(upd, float(r), t)
        found = found | f2
    return x, found, t, viol


def _relax_unrolled(At, bt, rt, ct, tol, I, J, rounds: int):
    """``unroll_relax``'s fixed rounds; the first projection adds a zero
    slack, as the JAX package's unrolled form does."""
    zero = torch.zeros((), dtype=At.dtype, device=At.device)
    return _fixed_rounds(At, bt, rt, ct, tol, I, J,
                         bt + _slack(zero, rt, ct), rounds)


def relax_guarded(At, bt, rt, ct, tol, I, J, max_relax: int, rounds: int):
    """The relax loop as ``R = min(rounds, max_relax)`` fixed rounds with
    where-selects and no host read.

    In the while form ``t_next = max(t) + 1`` is always the round number:
    solved lanes keep their t and unsolved lanes carry the newest. So the
    loop gives each lane the first round r in 1..max_relax at which it is
    feasible, or max_relax with the last attempt, and R rounds reproduce
    it bit for bit wherever every lane is solved by round R (the first
    projection is taken as :func:`_relax_loop` takes it, with no slack
    added, so signed zeros agree too). Returns (x, found, t, viol,
    pending): ``pending`` is the 0-dim device flag ``any(~found) & (R <
    max_relax)`` — set exactly where the loop would have gone on."""
    R = min(rounds, max_relax)
    x, found, t, viol = _fixed_rounds(At, bt, rt, ct, tol, I, J, bt, R)
    pending = (torch.any(~found) if R < max_relax
               else torch.zeros((), dtype=torch.bool, device=At.device))
    return x, found, t, viol, pending


class _Guard(NamedTuple):
    rounds: int
    flag: torch.Tensor
    blocks: int | None = None


_GUARD: contextvars.ContextVar = contextvars.ContextVar("relax_guard",
                                                         default=None)


@contextlib.contextmanager
def guarded_relax(rounds: int, flag, blocks: int | None = None):
    """Within this context the batch solver's relax loop (and the
    single-agent solver's while form) runs :func:`relax_guarded` with
    ``rounds`` rounds and ORs its pending flag into ``flag`` (a 0-dim bool
    tensor on the solver's device) in place — no host read, so the step
    can be captured. Outside it the host-guarded loop runs. ``blocks`` is
    the adaptive ADMM budget's guarded blocks (:func:`guarded_blocks`)."""
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if blocks is not None and blocks < 0:
        raise ValueError(f"blocks must be >= 0, got {blocks}")
    token = _GUARD.set(_Guard(rounds, flag, blocks))
    try:
        yield
    finally:
        _GUARD.reset(token)


def in_guarded_body() -> bool:
    """Whether the caller runs inside :func:`guarded_relax` — the compiled
    rollout's body, which may read nothing on the host. A step takes a
    data-dependent branch there in branch-free form or hands it to the
    eager redo (:func:`request_redo`)."""
    return _GUARD.get() is not None


# Guarded rounds that ask for what the relax loop gives: more than it can
# take (``relax_guarded`` runs min(rounds, max_relax)). A guard at this
# many rounds is a vmapped member's eager pass (the ensembles' and the
# serving programs' redo), which also takes every data-dependent branch
# in branch-free form (:func:`takes_every_branch`).
ALL_ROUNDS = 1 << 30


def takes_every_branch() -> bool:
    """Whether the caller runs inside a guard of :data:`ALL_ROUNDS`: the
    eager pass of a member under ``torch.func.vmap``, which cannot branch
    on the host per member. A step computes a branch it would take on the
    host for every row there and selects it per row — ``lax.cond`` under
    ``jax.vmap`` — instead of raising the redo flag."""
    guard = _GUARD.get()
    return guard is not None and guard.rounds >= ALL_ROUNDS


def guard_settings() -> tuple[int, int | None]:
    """Inside :func:`guarded_relax`: its (rounds, blocks), for a caller
    that opens a guard of its own with the same settings (the falsifier's
    member-batched step, one flag per member). Outside it: an error."""
    guard = _GUARD.get()
    if guard is None:
        raise RuntimeError("guard_settings outside guarded_relax")
    return guard.rounds, guard.blocks


def guarded_blocks() -> int | None:
    """Inside :func:`guarded_relax`: how many blocks of the sparse ADMM's
    adaptive budget the body runs before it hands the solve to the eager
    redo (None = the whole budget, which never redoes). Outside it: an
    error."""
    guard = _GUARD.get()
    if guard is None:
        raise RuntimeError("guarded_blocks outside guarded_relax")
    return guard.blocks


def request_redo(pred) -> None:
    """Inside :func:`guarded_relax`: OR the 0-dim device predicate
    ``pred`` into the guard's flag, so the engine redoes the chunk with the
    eager loop where it is set — the second source of the flag, for
    branches a captured body leaves out. Outside it: an error."""
    guard = _GUARD.get()
    if guard is None:
        raise RuntimeError("request_redo outside guarded_relax: take the "
                           "branch on the host instead")
    guard.flag.logical_or_(pred)


def _relax(At, bt, rt, ct, tol, I, J, max_relax: int, unroll_relax: int):
    """The relax policy: ``unroll_relax`` fixed rounds, else the guarded
    rounds inside :func:`guarded_relax`, else the host-guarded loop."""
    if unroll_relax > 0:
        return _relax_unrolled(At, bt, rt, ct, tol, I, J, unroll_relax)
    guard = _GUARD.get()
    if guard is None:
        return _relax_loop(At, bt, rt, ct, tol, I, J, max_relax)
    x, found, t, viol, pending = relax_guarded(At, bt, rt, ct, tol, I, J,
                                               max_relax, guard.rounds)
    if guard.rounds < max_relax:
        guard.flag.logical_or_(pending)
    return x, found, t, viol


def _lanes(A, b, relax_mask, relax_cap):
    """(At, bt, rt, ct, dtype) in the agents-last layout from (N, M, 2)
    rows; relax_mask None means no relaxable rows."""
    dtype = torch.promote_types(A.dtype, b.dtype)
    At = A.to(dtype).permute(1, 2, 0)                     # (M, 2, N)
    bt = b.to(dtype).T                                    # (M, N)
    rt = (torch.zeros_like(bt) if relax_mask is None
          else relax_mask.to(dtype).T)
    ct = None if relax_cap is None else relax_cap.to(dtype).T
    return At, bt, rt, ct, dtype


def project_polyhedron_2d(A, b, feas_tol=None):
    """Project the origin onto {x : A x <= b} by KKT enumeration.
    A (M, 2) — all-zero rows are inactive padding — and b (M,). Returns
    (x (2,), valid_found, max_violation)."""
    At, bt, _, _, dtype = _lanes(A[None], b[None], None, None)
    tol = _feas_tol(dtype) if feas_tol is None else feas_tol
    geo = _geometry(At, *_pairs(A.shape[0], A.device))
    x, valid, viol = _project(geo, At, bt, tol)
    return x[:, 0], valid[0], viol[0]


def solve_qp_2d(A, b, relax_mask=None, *, max_relax: int = 64,
                unroll_relax: int = 0, feas_tol=None, relax_cap=None):
    """``min ||x||^2 s.t. A x <= b`` for one agent with the reference's
    relaxation. A (M, 2), b (M,), relax_mask (M,) (1.0 on rows relaxed by
    +1 per round; None = no relaxation), relax_cap (M,) per-row ceiling on
    the total slack (inf = unbounded). ``unroll_relax > 0`` runs that many
    fixed rounds with where-selects instead of the while loop. Returns
    (x (2,), QPInfo of scalars)."""
    At, bt, rt, ct, dtype = _lanes(
        A[None], b[None], None if relax_mask is None else relax_mask[None],
        None if relax_cap is None else relax_cap[None])
    tol = _feas_tol(dtype) if feas_tol is None else feas_tol
    x, found, t, viol = _relax(At, bt, rt, ct, tol,
                               *_pairs(A.shape[0], A.device), max_relax,
                               unroll_relax)
    return x[:, 0], QPInfo(found[0], t[0], viol[0])


def solve_qp_2d_batch(A, b, relax_mask=None, *, max_relax: int = 64,
                      feas_tol=None, relax_cap=None, unroll_relax: int = 0):
    """Batched ``min ||x||^2 s.t. A x <= b`` over N agents.

    Args: A (N, M, 2), b (N, M), relax_mask (N, M), relax_cap optional
    (N, M) total-slack ceilings. Returns (x (N, 2), QPInfo of (N,)).
    Same semantics as solving each agent with :func:`solve_qp_2d`, but the
    relax loop is guarded by one batch-wide condition and retries every
    unsolved agent at t = max(t) + 1. ``unroll_relax > 0`` is the batched
    form of :func:`solve_qp_2d`'s unrolled path (per-agent t).

    Caller contract for caps: leave at least one relaxable row per agent
    uncapped, or an infeasible agent spins to max_relax."""
    At, bt, rt, ct, dtype = _lanes(A, b, relax_mask, relax_cap)
    tol = _feas_tol(dtype) if feas_tol is None else feas_tol
    x, found, t, viol = _relax(At, bt, rt, ct, tol,
                               *_pairs(b.shape[1], A.device), max_relax,
                               unroll_relax)
    return x.T, QPInfo(found, t, viol)
