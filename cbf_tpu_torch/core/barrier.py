"""Batched CBF barrier-row construction (counterpart:
cbf_tpu/core/barrier.py).

The reference barrier h(d) = |dx| + |dy| + k*(sign(dx)*dvx + sign(dy)*dvy)
- dmin over a padded, masked obstacle slab; the QP decision variable is the
delta du = u - u0. Masked slots give the null row ``0 * du <= MASKED_ROW_RHS``.

The JAX package pins its 4x4 / 4x2 contractions to ``Precision.HIGHEST``.
Here they are written as explicit broadcast sums, so no matrix product —
and no TF32 path on the card — is involved.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

# RHS for masked (inactive) constraint rows: never binds for a 0-row and
# stays exact in float32.
MASKED_ROW_RHS = 1e6


class _Rows(NamedTuple):
    """The fixed row data: the 8 box-row directions (reference layout),
    the 4 sign classes and the 4 deduped box directions."""
    box_rows: torch.Tensor
    signs: torch.Tensor
    box_dirs: torch.Tensor


@functools.lru_cache(maxsize=None)
def _constants(dtype: torch.dtype, device: torch.device) -> _Rows:
    """Built once per (dtype, device) and kept: a host-to-device copy in
    the step would not survive graph capture."""
    def rows(values):
        return torch.tensor(values, dtype=dtype, device=device)
    return _Rows(
        rows([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0],
              [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]]),
        rows([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]]),
        rows([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]))


def _signs(d):
    """(sx, sy) in {+1, -1} with d == 0 mapping to +1 (the reference's
    ``if d < 0``), in d's dtype."""
    sx = 1.0 - 2.0 * (d[..., 0] < 0).to(d.dtype)
    sy = 1.0 - 2.0 * (d[..., 1] < 0).to(d.dtype)
    return sx, sy


def _g_times(g, u):
    """g @ u over leading batch axes: g (4, 2) or per-row (..., 4, 2),
    u (..., 2) -> (..., 4)."""
    return torch.sum(g * u[..., None, :], dim=-1)


def barrier_rhs(d, hs, f, gu0, *, dmin, k, gamma):
    """b = gamma*(hs@d - dmin) + hs@(f@d) + hs@(g@u0), shape-agnostic over
    leading batch axes — the single source of the barrier RHS for both
    assemblies. d, hs (..., K, 4), f (4, 4) or per-row (..., 4, 4),
    gu0 (..., 4); dmin and gamma scalars or broadcastable to (..., K)."""
    h = torch.sum(hs * d, dim=-1) - dmin
    fd = torch.sum(d[..., None, :] * f[..., None, :, :], dim=-1)  # (f @ d)
    L_f = torch.sum(hs * fd, dim=-1)
    return gamma * h + L_f + torch.sum(hs * gu0[..., None, :], dim=-1)


def barrier_rows(robot_state, obs_states, obs_mask, f, g, u0, *, dmin, k,
                 gamma):
    """CBF rows for one agent against K masked obstacles (also batched
    over leading axes). robot_state (..., 4), obs_states (..., K, 4),
    obs_mask (..., K), u0 (..., 2); f (4, 4) and g (4, 2) shared, or
    per-row (..., 4, 4) and (..., 4, 2); dmin, k and gamma scalars or
    broadcastable to (..., K) (per-row parameters as (..., 1)). Returns
    A (..., K, 2) zeroed where masked and b (..., K) with MASKED_ROW_RHS
    where masked."""
    d = robot_state[..., None, :] - obs_states                 # (..., K, 4)
    sx, sy = _signs(d)
    hs = torch.stack([sx, sy, k * sx, k * sy], dim=-1)        # (..., K, 4)
    gu0 = _g_times(g, u0)                                      # (..., 4)
    A = -torch.sum(hs[..., :, None] * g[..., None, :, :], dim=-2)  # (.., K, 2)
    b = barrier_rhs(d, hs, f, gu0, dmin=dmin, k=k, gamma=gamma)
    A = torch.where(obs_mask[..., None], A, 0.0)
    b = torch.where(obs_mask, b, MASKED_ROW_RHS)
    return A, b


def box_rows(robot_state, u0, max_speed, *, reference_layout: bool = True,
             vel_box_rows: bool = True):
    """The 8 box rows G du <= S (also batched over leading axes).

    ``reference_layout=True`` keeps the reference's quirky row/RHS pairing
    (cbf.py:66-70: rows 1-3 pair a y row with an x bound and vice versa);
    ``False`` gives the corrected pairing. ``vel_box_rows=False`` drops the
    velocity coupling from rows 5-8."""
    ms = max_speed
    dtype = torch.promote_types(robot_state.dtype, u0.dtype)
    if vel_box_rows:
        vx, vy = robot_state[..., 2], robot_state[..., 3]
    else:
        vx = vy = torch.zeros_like(u0[..., 0])
    u0x, u0y = u0[..., 0], u0[..., 1]
    G = _constants(dtype, u0.device).box_rows.expand(
        tuple(u0.shape[:-1]) + (8, 2))
    if reference_layout:
        S = [ms - u0x, ms + u0x, ms - u0y, ms + u0y]
    else:
        S = [ms - u0x, ms - u0y, ms + u0x, ms + u0y]
    S += [ms - vx - u0x, ms + vx + u0x, ms - vy - u0y, ms + vy + u0y]
    return G, torch.stack(S, dim=-1)


def assemble_qp_dedup(robot_states, obs_states, obs_mask, f, g, u0, *, dmin,
                      k, gamma, max_speed, reference_layout=True,
                      vel_box_rows=True, priority_mask=None,
                      priority_relax_weight=0.01):
    """Batched QP assembly with direction deduplication: K+8 rows -> 8.

    Every CBF row is ``-(sx*u + sy*w)`` with u = g[0] + k*g[2],
    w = g[1] + k*g[3], so the rows fall into 4 sign classes and only the
    smallest RHS per class binds; the 4 box rows dedup by direction the
    same way. The feasible region — hence the QP optimum, infeasibility
    and the +1 relax semantics — is unchanged. ``priority_mask`` (N, K)
    gives priority rows their own 4 classes relaxing at
    ``priority_relax_weight`` (8 -> 12 rows).

    Args: robot_states (N, 4), obs_states (N, K, 4), obs_mask (N, K),
    f (4, 4), g (4, 2), u0 (N, 2). Returns (A (N, R, 2), b (N, R),
    relax_mask (N, R)), R = 8 or 12.
    """
    N = robot_states.shape[0]
    dtype = torch.promote_types(
        torch.promote_types(robot_states.dtype, obs_states.dtype), u0.dtype)
    dev = robot_states.device

    d = robot_states[:, None, :] - obs_states                 # (N, K, 4)
    sx, sy = _signs(d)
    hs = torch.stack([sx, sy, k * sx, k * sy], dim=-1)        # (N, K, 4)
    gu0 = _g_times(g, u0)                                      # (N, 4)
    b_all = barrier_rhs(d, hs, f, gu0, dmin=dmin, k=k, gamma=gamma)

    u_vec = g[0] + k * g[2]                                    # (2,)
    w_vec = g[1] + k * g[3]
    consts = _constants(dtype, dev)
    signs = consts.signs
    A_dir = -(signs[:, 0:1] * u_vec[None] + signs[:, 1:2] * w_vec[None])
    A_cbf = A_dir[None].expand(N, 4, 2)

    def class_min(member_mask):
        cols = []
        for s1, s2 in ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)):
            member = member_mask & (sx == s1) & (sy == s2)
            cols.append(torch.amin(
                torch.where(member, b_all, MASKED_ROW_RHS), dim=1))
        return torch.stack(cols, dim=1)                        # (N, 4)

    if priority_mask is None:
        b_cbf = class_min(obs_mask)
    else:
        b_cbf = torch.cat([class_min(obs_mask & ~priority_mask),
                           class_min(obs_mask & priority_mask)], dim=1)
        A_cbf = torch.cat([A_cbf, A_cbf], dim=1)               # (N, 8, 2)

    # Box rows deduped by direction: min of the two RHS per direction, in
    # the reference's pairing (see box_rows).
    ms = max_speed
    if vel_box_rows:
        vx, vy = robot_states[:, 2], robot_states[:, 3]
    else:
        vx = vy = torch.zeros((N,), dtype=dtype, device=dev)
    u0x, u0y = u0[:, 0], u0[:, 1]
    A_box = consts.box_dirs[None].expand(N, 4, 2)
    if reference_layout:
        b_box = torch.stack(
            [torch.minimum(ms - u0x, ms - vx - u0x),
             torch.minimum(ms + u0x, ms - vy - u0y),
             torch.minimum(ms - u0y, ms + vx + u0x),
             torch.minimum(ms + u0y, ms + vy + u0y)], dim=1)
    else:
        b_box = torch.stack(
            [torch.minimum(ms - u0x, ms - vx - u0x),
             torch.minimum(ms - u0y, ms - vy - u0y),
             torch.minimum(ms + u0x, ms + vx + u0x),
             torch.minimum(ms + u0y, ms + vy + u0y)], dim=1)

    A = torch.cat([A_cbf, A_box], dim=1)                       # (N, R, 2)
    b = torch.cat([b_cbf, b_box], dim=1)                       # (N, R)
    ones = torch.ones((N, 4), dtype=dtype, device=dev)
    zeros = torch.zeros((N, 4), dtype=dtype, device=dev)
    if priority_mask is None:
        relax_mask = torch.cat([ones, zeros], dim=1)
    else:
        relax_mask = torch.cat([ones, priority_relax_weight * ones, zeros],
                               dim=1)
    return A, b, relax_mask


def assemble_qp(robot_state, obs_states, obs_mask, f, g, u0, *, dmin, k,
                gamma, max_speed, reference_layout=True, vel_box_rows=True,
                priority_mask=None, priority_relax_weight=0.01):
    """Full (K+8)-row QP data for one agent (also batched over leading
    axes, with shared or per-row dynamics and parameters as
    :func:`barrier_rows` takes them; ``max_speed`` scalar or (...,)).
    Returns (A, b, relax_mask): ``min ||du||^2 s.t. A du <= b``;
    relax_mask is 1.0 on real CBF rows, 0.0 on masked and box rows, and
    ``priority_relax_weight`` on rows ``priority_mask`` marks."""
    A_cbf, b_cbf = barrier_rows(robot_state, obs_states, obs_mask, f, g, u0,
                                dmin=dmin, k=k, gamma=gamma)
    G, S = box_rows(robot_state, u0, max_speed,
                    reference_layout=reference_layout,
                    vel_box_rows=vel_box_rows)
    A = torch.cat([A_cbf, G.to(A_cbf.dtype)], dim=-2)
    b = torch.cat([b_cbf, S.to(b_cbf.dtype)], dim=-1)
    weights = obs_mask.to(b.dtype)
    if priority_mask is not None:
        weights = weights * torch.where(
            priority_mask, torch.full_like(weights, priority_relax_weight),
            torch.ones_like(weights))
    relax_mask = torch.cat([weights, torch.zeros(
        tuple(weights.shape[:-1]) + (8,), dtype=b.dtype, device=b.device)],
        dim=-1)
    return A, b, relax_mask
