"""The batched CBF safety filter (counterpart: cbf_tpu/core/filter.py).

Equivalent of the reference's ``ControlBarrierFunction.get_safe_control``
(cbf.py:18-92) over fixed shapes, batched over all agents: every agent's
QP is assembled and solved at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cbf_tpu_torch.core.barrier import assemble_qp, assemble_qp_dedup
from cbf_tpu_torch.solvers.exact2d import solve_qp_2d, solve_qp_2d_batch


class CBFParams(NamedTuple):
    """Filter parameters (reference defaults: cbf.py:6-16). A leaf is a
    float, or with per-agent dynamics an (N,) tensor (one value per
    row)."""
    max_speed: float = 15.0
    dmin: float = 0.2
    k: float = 1.0
    gamma: float = 0.5


_RELAX_CAP_NEEDS_PRIORITY = (
    "relax_cap requires priority_mask: capping every relaxable row leaves "
    "no mechanism to restore feasibility (the relax loop would spin to "
    "max_relax and return a least-violating control)")


def _cbf_row_caps(priority_mask, relax_cap, dtype):
    """Per-CBF-row caps of the full (K+8)-row layout: priority rows stay
    uncapped (their eps growth is what restores feasibility), box rows
    never relax."""
    if priority_mask is None:
        raise ValueError(_RELAX_CAP_NEEDS_PRIORITY)
    inf = torch.full(priority_mask.shape, torch.inf, dtype=dtype,
                     device=priority_mask.device)
    cbf_caps = torch.where(priority_mask, inf,
                           torch.full_like(inf, relax_cap))
    box = torch.full(tuple(priority_mask.shape[:-1]) + (8,), torch.inf,
                     dtype=dtype, device=priority_mask.device)
    return torch.cat([cbf_caps, box], dim=-1)


def _rows(leaf):
    """An (N,) per-agent leaf as (N, 1), to meet (N, K) rows; anything
    else as it is."""
    if isinstance(leaf, torch.Tensor) and leaf.dim() == 1:
        return leaf[:, None]
    return leaf


def safe_control(robot_state, obs_states, obs_mask, f, g, u0,
                 params: CBFParams = CBFParams(), *, max_relax: int = 64,
                 unroll_relax: int = 0, reference_layout: bool = True,
                 vel_box_rows: bool = True, priority_mask=None,
                 priority_relax_weight: float = 0.01, relax_cap=None):
    """Filter one agent's nominal control. Returns (u (2,), QPInfo).

    robot_state (4,), obs_states (K, 4), obs_mask (K,) bool, f (4, 4),
    g (4, 2), u0 (2,). Builds CBF + box rows, solves for du = u - u0 with
    +1 relaxation of the CBF rows on infeasibility, clamps u to
    +-max_speed (cbf.py:89-92)."""
    A, b, relax_mask = assemble_qp(
        robot_state, obs_states, obs_mask, f, g, u0,
        dmin=params.dmin, k=params.k, gamma=params.gamma,
        max_speed=params.max_speed, reference_layout=reference_layout,
        vel_box_rows=vel_box_rows, priority_mask=priority_mask,
        priority_relax_weight=priority_relax_weight)
    cap_arr = (None if relax_cap is None
               else _cbf_row_caps(priority_mask, relax_cap, b.dtype))
    du, info = solve_qp_2d(A, b, relax_mask, max_relax=max_relax,
                           unroll_relax=unroll_relax, relax_cap=cap_arr)
    u = torch.clamp(du + u0, -params.max_speed, params.max_speed)
    return u, info


def safe_controls(robot_states, obs_states, obs_mask, f, g, u0,
                  params: CBFParams = CBFParams(), *, max_relax: int = 64,
                  unroll_relax: int = 0, reference_layout: bool = True,
                  vel_box_rows: bool = True, priority_mask=None,
                  priority_relax_weight: float = 0.01, relax_cap=None):
    """All-agent batched filter. Returns (u (N, 2), QPInfo of (N,)).

    Default path: direction-deduped assembly (K+8 rows -> 8, exactly
    equivalent) and the batch solver's scalar-guarded relax loop. With
    ``unroll_relax > 0``: the full (K+8)-row per-agent QPs, solved with
    that many unrolled relax rounds each (the JAX package's vmap of
    :func:`safe_control`). Both give the same controls.

    Per-agent dynamics (the mixed swarm): f (N, 4, 4), g (N, 4, 2), and
    ``params`` leaves that may be (N,) tensors. This is the JAX package's
    vmap of :func:`safe_control` batched: the full (K+8)-row assembly with
    each row's own dynamics, box bound and velocity term, and the batch
    solver, whose relax rounds are per lane (a lane's t is the round in
    which it first becomes feasible, as its own while loop gives). The
    tensor leaves are pinned to the states' dtype first, as JAX pins them
    before its vmap.

    Args: robot_states (N, 4), obs_states (N, K, 4), obs_mask (N, K),
    f (4, 4), g (4, 2), u0 (N, 2); ``priority_mask`` (N, K) marks rows
    that relax at ``priority_relax_weight`` per round (tiered relaxation).

    Agents whose mask is all False still solve against the box rows alone
    (u == u0 whenever |u0| <= max_speed); callers wanting the reference's
    skip select ``where(mask.any(-1), u, u0)``, as the swarm step does.
    """
    per_agent = f.dim() == 3
    if per_agent:
        params = CBFParams(*(leaf.to(robot_states.dtype)
                             if isinstance(leaf, torch.Tensor) else leaf
                             for leaf in params))
    kw = dict(dmin=_rows(params.dmin), k=_rows(params.k),
              gamma=_rows(params.gamma), max_speed=params.max_speed,
              reference_layout=reference_layout, vel_box_rows=vel_box_rows,
              priority_mask=priority_mask,
              priority_relax_weight=priority_relax_weight)
    max_speed = _rows(params.max_speed)
    if per_agent or unroll_relax > 0:
        A, b, relax_mask = assemble_qp(robot_states, obs_states, obs_mask,
                                       f, g, u0, **kw)
        # JAX's per-agent solve takes its first attempt at b + 0*relax
        # (a -0.0 RHS becomes +0.0); the unrolled form adds that zero too.
        b = b + 0.0
        cap_arr = (None if relax_cap is None
                   else _cbf_row_caps(priority_mask, relax_cap, b.dtype))
    else:
        A, b, relax_mask = assemble_qp_dedup(robot_states, obs_states,
                                             obs_mask, f, g, u0, **kw)
        cap_arr = None
        if relax_cap is not None:
            if priority_mask is None:
                raise ValueError(_RELAX_CAP_NEEDS_PRIORITY)
            # Dedup layout: 4 normal-CBF rows (capped) + 4 priority rows +
            # 4 box rows (uncapped).
            row_caps = torch.full((b.shape[1],), torch.inf, dtype=b.dtype,
                                  device=b.device)
            row_caps[:4] = relax_cap
            cap_arr = row_caps[None].expand(b.shape)
    du, info = solve_qp_2d_batch(A, b, relax_mask, max_relax=max_relax,
                                 relax_cap=cap_arr, unroll_relax=unroll_relax)
    u = torch.clamp(du + u0, -max_speed, max_speed)
    return u, info
