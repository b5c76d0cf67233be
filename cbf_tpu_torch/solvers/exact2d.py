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
per round, and one per call in the all-feasible common case.
"""

from __future__ import annotations

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


def _pairs(m: int, device):
    I, J = np.triu_indices(m, k=1)
    return (torch.as_tensor(I, dtype=torch.int64, device=device),
            torch.as_tensor(J, dtype=torch.int64, device=device))


def _project_batch_lanes(A, b, tol, I, J):
    """Enumeration projection, agents-last layout.

    Args: A (M, 2, N), b (M, N); I, J pair indices. Returns
    (x (2, N), valid_found (N,), viol (N,)): the exact minimizer where a
    valid candidate exists, else the least-violating candidate."""
    N = A.shape[2]
    norms2 = torch.sum(A * A, dim=1)                      # (M, N)
    row_ok = norms2 > 1e-12
    safe_n2 = torch.where(row_ok, norms2, 1.0)

    # Single-row candidates.
    x_single = A * (b / safe_n2)[:, None, :]              # (M, 2, N)
    dual_single = row_ok & (b <= tol)

    # Pair candidates.
    ai, aj = A[I], A[J]                                   # (P, 2, N)
    bi, bj = b[I], b[J]
    det = ai[:, 0] * aj[:, 1] - ai[:, 1] * aj[:, 0]
    det_ok = torch.abs(det) > 1e-10
    safe_det = torch.where(det_ok, det, 1.0)
    x_pair = torch.stack(
        [(aj[:, 1] * bi - ai[:, 1] * bj) / safe_det,
         (ai[:, 0] * bj - aj[:, 0] * bi) / safe_det], dim=1)   # (P, 2, N)
    gii, gjj = norms2[I], norms2[J]
    gij = torch.sum(ai * aj, dim=1)
    detG = gii * gjj - gij * gij
    detG_ok = torch.abs(detG) > 1e-20
    safe_detG = torch.where(detG_ok, detG, 1.0)
    lam_i = (-bi * gjj + bj * gij) / safe_detG
    lam_j = (-bj * gii + bi * gij) / safe_detG
    dual_pair = (det_ok & detG_ok & row_ok[I] & row_ok[J]
                 & (lam_i >= -tol) & (lam_j >= -tol))

    X = torch.cat([torch.zeros((1, 2, N), dtype=A.dtype, device=A.device),
                   x_single, x_pair], dim=0)              # (C, 2, N)
    dual_ok = torch.cat([torch.ones((1, N), dtype=torch.bool,
                                    device=A.device),
                         dual_single, dual_pair], dim=0)  # (C, N)
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
    x, found, viol = _project_batch_lanes(At, bt, tol, I, J)
    t = torch.zeros(found.shape, dtype=At.dtype, device=At.device)
    while bool(torch.any(~found) & (torch.amax(t) < max_relax)):
        t_next = torch.amax(t) + 1.0
        x2, f2, v2 = _project_batch_lanes(At, bt + _slack(t_next, rt, ct),
                                          tol, I, J)
        upd = ~found
        x = torch.where(upd[None], x2, x)
        viol = torch.where(upd, v2, viol)
        t = torch.where(upd, t_next, t)
        found = found | f2
    return x, found, t, viol


def _relax_unrolled(At, bt, rt, ct, tol, I, J, rounds: int):
    """Fixed ``rounds`` relax attempts with where-selects (per-lane t):
    while a lane is unsolved it always advances to the latest attempt,
    matching the while form, which ends on the last attempt with t at the
    cap when nothing is ever feasible."""
    zero = torch.zeros((), dtype=At.dtype, device=At.device)
    x, found, viol = _project_batch_lanes(At, bt + _slack(zero, rt, ct),
                                          tol, I, J)
    t = torch.zeros(found.shape, dtype=At.dtype, device=At.device)
    for r in range(1, rounds + 1):
        x2, f2, v2 = _project_batch_lanes(
            At, bt + _slack(zero + float(r), rt, ct), tol, I, J)
        upd = ~found
        x = torch.where(upd[None], x2, x)
        viol = torch.where(upd, v2, viol)
        t = torch.where(upd, float(r), t)
        found = found | f2
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
    x, valid, viol = _project_batch_lanes(At, bt, tol,
                                          *_pairs(A.shape[0], A.device))
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
    I, J = _pairs(A.shape[0], A.device)
    if unroll_relax > 0:
        x, found, t, viol = _relax_unrolled(At, bt, rt, ct, tol, I, J,
                                            unroll_relax)
    else:
        x, found, t, viol = _relax_loop(At, bt, rt, ct, tol, I, J,
                                        max_relax)
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
    I, J = _pairs(b.shape[1], A.device)
    if unroll_relax > 0:
        x, found, t, viol = _relax_unrolled(At, bt, rt, ct, tol, I, J,
                                            unroll_relax)
    else:
        x, found, t, viol = _relax_loop(At, bt, rt, ct, tol, I, J,
                                        max_relax)
    return x.T, QPInfo(found, t, viol)
