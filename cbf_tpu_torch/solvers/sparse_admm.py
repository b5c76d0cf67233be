"""Matrix-free OSQP-style ADMM for neighbour-sparse pair QPs (counterpart:
cbf_tpu/solvers/sparse_admm.py).

The QP the joint certificate is:

    min_u ||u - u_nom||^2
    s.t.  c_r . (u_{I_r} - u_{J_r}) <= b_r     (R neighbour-pair rows)
          lo <= u <= hi                        (component box rows)

``A v`` is a gather (each row touches two agents), ``A^T y`` a segment sum,
and the x-update solves ``K x = rhs`` with K = (1 + sigma + rho) I + rho
A_pair^T A_pair by a short fixed conjugate-gradient (or, fused, Chebyshev)
iteration instead of a factorization. Same splitting, settings, carries
and fixed points as the JAX package; the drivers below are its, with the
member axis of the lockstep-batched driver written out (every tensor has
a leading E axis; a single problem is E = 1) instead of ``vmap``.

The transpose. The JAX package scatter-adds the J side (``z.at[J].add``)
in every K application. On the card a float ``index_add_`` uses atomics,
whose order changes from run to run, and a CUDA graph replay must equal
the eager loop bit for bit. J is fixed for one call, so each call lays the
transpose out once (:func:`_segment_plan`: a stable argsort of the
indices and their segment offsets by ``searchsorted``) and every
application is a gather into that order and one ``torch.segment_reduce``
sum, which reduces each segment in order: deterministic, no host read
(``unsafe=True`` skips its checks, which read the offsets on the host), so
a graph captures it. On the CPU the sums run in another order than XLA's
scatter, so parity with JAX is held by tolerance.

The fused iteration keeps its pair-row iterates (z, y and the carried
pair image) in the transpose's own order instead (:class:`_Slots`): each
row sits once in every segment it is summed into, so a transpose is one
``segment_reduce`` with no gather before it, and the pair image is
gathered straight into that order. One iteration is then four serialized
gather/segment passes, as the JAX package's is (the chain-depth audit,
AUD003); the sums, their order and every iterate are bit-equal to the
row-order form's, whose rows the solver's carry keeps.

The adaptive budget (``settings.tol > 0``) is a ``lax.while_loop`` in the
JAX package. Eagerly it is a host ``while`` that reads the residual once
per block of ``check_every`` iterations. Inside the compiled rollout's
body (:func:`cbf_tpu_torch.solvers.exact2d.in_guarded_body`) it is B
blocks, each applied through ``torch.where`` on the 0-dim "still above
tol" flag, so a converged state freezes — bit-identical to the loop
having exited — and where the loop would have run past B blocks the body
raises the engine's redo flag (:func:`exact2d.request_redo`). B comes
from the guard (:func:`exact2d.guarded_blocks`; None = the whole budget,
which never redoes). A NaN residual stops both forms (``NaN > tol`` is
False).

The gradient. ``_solve_K`` is an ``autograd.Function`` with the JAX
package's implicit rule (its ``custom_vjp``): the backward is one more CG
solve ``K w = cotangent`` with the same budget, then ``w`` for the
right-hand side and the closed-form cotangent of the pair coefficients;
differentiating through the unrolled CG instead is numerically explosive
in float32. Its backward reuses the call's segment plans, so the
transpose stays deterministic. The rest of the iteration is plain torch
and differentiates as it stands.

Row-partitioned mode (``axis_name``, the mesh's ``sp``
:class:`~cbf_tpu_torch.parallel.mesh.Axis`): each rank holds only the pair
rows it owns (I and J still index the full variable vector), so the
transpose's segment sums are completed by one (2N,) psum over the axis per
application, and the primal residual's pair part by one pmax. The (2N,)
iterate stays replicated, so every CG dot product is local. The fused
iteration and the adaptive budget raise the JAX package's ValueErrors
there.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from cbf_tpu_torch.solvers import exact2d
from cbf_tpu_torch.solvers.admm import relaxed_zy_update
from cbf_tpu_torch.utils.math import safe_norm


class SparseADMMSettings(NamedTuple):
    """The JAX package's settings, same defaults: ``tol`` > 0 switches the
    fixed budget to blocks of ``check_every`` iterations that stop at
    max(primal, dual) <= tol, capped at ``iters`` rounded up to a whole
    block; ``fused`` restructures each iteration around the carried pair
    image ``A x``; ``ksolve`` is the x-update's inner solver, "cg" or
    "chebyshev" (fused only), ``cg_iters`` its budget."""
    rho: float = 1.0
    sigma: float = 1e-6
    alpha: float = 1.6       # over-relaxation
    iters: int = 100
    cg_iters: int = 8        # x-update inner budget (CG or Chebyshev)
    tol: float = 0.0         # 0 = fixed iters
    check_every: int = 10
    fused: bool = False      # carried-Ax fused iteration
    ksolve: str = "cg"       # "cg" | "chebyshev" (chebyshev needs fused)


class SparseADMMInfo(NamedTuple):
    primal_residual: torch.Tensor
    dual_residual: torch.Tensor
    # ADMM iterations run: settings.iters in fixed mode, blocks *
    # check_every under tol > 0 (int32).
    iterations: torch.Tensor = ()


def _vdot(a, b):
    """Per-member inner product over the last axis: (E, n) -> (E,)."""
    return torch.sum(a * b, dim=-1)


def _cg(apply_K, rhs, iters: int):
    """Fixed-iteration zero-start CG for SPD K, per member (no early
    exit). Callers wanting a warm start solve for the delta from their
    guess. ``rhs`` (E, n)."""
    r = rhs
    p = r
    x = torch.zeros_like(rhs)
    rs = _vdot(r, r)
    for _ in range(iters):
        Kp = apply_K(p)
        a = rs / torch.clamp(_vdot(p, Kp), min=1e-30)
        x = x + a[:, None] * p
        r = r - a[:, None] * Kp
        rs_new = _vdot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=1e-30))[:, None] * p
        rs = rs_new
    return x


def _chebyshev(apply_K, rhs, iters: int, ev_lo: float, ev_hi):
    """Fixed-degree Chebyshev semi-iteration ``x ~= K^{-1} rhs`` for SPD K
    with spectrum inside [ev_lo, ev_hi] (``ev_hi`` (E,), a provable bound
    from :func:`_prepare_ops`) — the reduction-free twin of :func:`_cg`
    (zero start)."""
    theta = 0.5 * (ev_hi + ev_lo)
    delta = torch.maximum(0.5 * (ev_hi - ev_lo), 1e-12 * theta)
    sigma1 = theta / delta
    rho_prev = 1.0 / sigma1
    r = rhs
    dvec = r / theta[:, None]
    x = dvec
    for _ in range(max(int(iters), 1)):
        r = r - apply_K(dvec)
        rho_new = 1.0 / (2.0 * sigma1 - rho_prev)
        dvec = ((rho_new * rho_prev)[:, None] * dvec
                + (2.0 * rho_new / delta)[:, None] * r)
        x = x + dvec
        rho_prev = rho_new
    return x


class _SegmentPlan(NamedTuple):
    """One scatter-add's layout, built once per call: ``perm`` puts the
    flattened (E * rows) values in the stable order of their target
    agents, ``offsets`` (E * N + 1,) bounds each agent's segment."""
    perm: torch.Tensor
    offsets: torch.Tensor


def _member_index(idx, n: int):
    """(E, R) per-member agent indices -> (E * R,) int64 indices into the
    flattened (E * N) agents."""
    E = idx.shape[0]
    base = torch.arange(E, dtype=torch.int64, device=idx.device) * n
    return (idx.to(torch.int64) + base[:, None]).reshape(-1)


def _segment_plan(flat_idx, total: int) -> _SegmentPlan:
    """:class:`_SegmentPlan` of flattened target indices (values in
    [0, total))."""
    perm = torch.argsort(flat_idx, stable=True)
    keys = flat_idx.index_select(0, perm)
    bounds = torch.arange(total + 1, dtype=torch.int64,
                          device=flat_idx.device)
    return _SegmentPlan(perm, torch.searchsorted(keys, bounds))


def _segments(flat, offsets, E: int, n: int):
    """Segment sums of (rows, C) values already in segment order: (E, n,
    C), each target's rows summed in order, empty targets 0."""
    out = torch.segment_reduce(flat, "sum", offsets=offsets, axis=0,
                               unsafe=True, initial=0.0)
    return out.reshape(E, n, flat.shape[-1])


def _segment_sum(values, plan: _SegmentPlan, E: int, n: int):
    """Scatter-add of (E, R, C) values onto (E, n, C) by ``plan`` — each
    target's rows summed in row order; empty targets get 0."""
    flat = values.reshape(-1, values.shape[-1]).index_select(0, plan.perm)
    return _segments(flat, plan.offsets, E, n)


class _Slots(NamedTuple):
    """The fused iteration's layout of the pair rows: L = 2R slots per
    member, where the transpose reads them. Generic rows: the one-pass
    plan's order of the I and J endpoints (every row twice, its J copy
    with ``neg`` set). Agent-major rows (``agent_k``): the R rows in
    order (the reshape-summed I side), then the J plan's order. Every
    index is flattened over the E members."""
    src: torch.Tensor      # (E * L,) the row (of E * R) each slot holds
    Ig: torch.Tensor       # (E * L,) the slot's endpoints in the (E * N)
    Jg: torch.Tensor       # agents
    neg: torch.Tensor      # (E, L) bool: the slot adds -contribution
    offsets: torch.Tensor  # segment bounds of the summed slots
    back: torch.Tensor     # (E * R,) one slot of each row


class _Pair(NamedTuple):
    """The pair operator's index data for one call: gathers (``Ig``,
    ``Jg`` into the flattened (E * N) agents) and the transpose's
    segment plans (``plan_I`` None on the agent-major fast path), or the
    fused iteration's :class:`_Slots`."""
    Ig: torch.Tensor
    Jg: torch.Tensor
    plan_I: _SegmentPlan | None
    plan_J: _SegmentPlan | None
    slots: _Slots | None
    E: int
    n: int
    agent_k: int | None
    rows_start: int
    axis: Any = None      # row-partitioned mode: the axis the psum spans


def _slot_layout(plan: _SegmentPlan, Ig, Jg, E: int, R: int,
                 agent_k) -> _Slots:
    """:class:`_Slots` of the fused iteration from its transpose plan:
    the one-pass plan over the (E, 2R) concatenated endpoints, or (agent
    rows) the J plan over (E, R)."""
    dev = plan.perm.device
    if agent_k is None:
        item = plan.perm
        member, p = item // (2 * R), item % (2 * R)
        src = member * R + p % R
        neg = (p >= R).reshape(E, 2 * R)
        # Each row's I copy: the inverse permutation's first R per member.
        back = torch.argsort(plan.perm).reshape(E, 2 * R)[:, :R]
    else:
        rows = torch.arange(E * R, dtype=torch.int64, device=dev)
        src = torch.cat([rows.reshape(E, R), plan.perm.reshape(E, R)],
                        dim=1)
        neg = torch.zeros((E, 2 * R), dtype=torch.bool, device=dev)
        back = (rows.reshape(E, R)
                + R * torch.arange(E, dtype=torch.int64, device=dev)[:, None])
    src = src.reshape(-1)
    return _Slots(src, Ig.index_select(0, src), Jg.index_select(0, src),
                  neg, plan.offsets, back.reshape(-1))


def _to_slots(rows, slots: _Slots):
    """(E, R, ...) pair-row values -> the (E, L, ...) slot layout."""
    E = rows.shape[0]
    flat = rows.reshape(-1, *rows.shape[2:]).index_select(0, slots.src)
    return flat.reshape(E, -1, *rows.shape[2:])


def _to_rows(values, slots: _Slots):
    """(E, L) slot-layout values -> (E, R) rows (every copy of a row holds
    the same bits)."""
    E = values.shape[0]
    return values.reshape(-1).index_select(0, slots.back).reshape(E, -1)


def _pair_layout(I, J, n: int, zero_rows, *, agent_k=None,
                 rows_start: int = 0, fused: bool = False,
                 axis=None) -> _Pair:
    """Index data of the pair operator over ``I`` (R,) shared and ``J``
    (E, R) per member, for ``n`` agents; ``fused`` lays out the fused
    iteration's :class:`_Slots`.

    The transpose's plans file each all-zero row (``zero_rows`` (E, R),
    whose contribution is 0) under agent ``row % n`` instead of its
    endpoint: padding rows tend to share one endpoint (the k-NN search
    reports agent 0 on every empty slot), and one segment of tens of
    thousands of rows would serialise the segment sum on the card. The
    sums gain only exact zeros."""
    E, R = J.shape
    Ie = I.to(torch.int64)[None].expand(E, -1)
    Je = J.to(torch.int64)
    Ig, Jg = _member_index(Ie, n), _member_index(Je, n)

    def keyed(idx, zero):
        spread = torch.arange(idx.shape[1], dtype=torch.int64,
                              device=idx.device) % n
        return _member_index(torch.where(zero, spread, idx), n)

    plan_I = plan_J = slots = None
    if agent_k is not None:
        plan_J = _segment_plan(keyed(Je, zero_rows), E * n)
        if fused:
            slots = _slot_layout(plan_J, Ig, Jg, E, R, agent_k)
    elif fused:
        plan_IJ = _segment_plan(
            keyed(torch.cat([Ie, Je], dim=1),
                  torch.cat([zero_rows, zero_rows], dim=1)), E * n)
        slots = _slot_layout(plan_IJ, Ig, Jg, E, R, None)
    else:
        plan_I = _segment_plan(keyed(Ie, zero_rows), E * n)
        plan_J = _segment_plan(keyed(Je, zero_rows), E * n)
    return _Pair(Ig, Jg, plan_I, plan_J, slots, E, n, agent_k,
                 int(rows_start), axis)


def _gather(v, index, E: int):
    """(E, N, 2) -> (E, R, 2) rows of ``v`` at flattened ``index``."""
    return v.reshape(-1, 2).index_select(0, index).reshape(E, -1, 2)


def _make_apply_K(coef_s, pair: _Pair, rho, sigma, coef_T=None):
    """The x-update operator K = (1 + sigma + rho) I + rho A_pair^T A_pair
    over flattened (E, 2N) vectors — the one definition of the pair
    operator. Returns (apply_K, A_pair, A_pair_T). With the fused
    iteration's slots, ``coef_s`` and the pair vectors are in the slot
    layout and ``coef_T`` is ``coef_s`` with the ``neg`` slots negated."""
    E, n, k = pair.E, pair.n, pair.agent_k
    sl = pair.slots

    def agent_block(contrib):
        """The agent-major I side: each agent's k rows summed, in place."""
        block = torch.sum(contrib.reshape(E, -1, k, 2), dim=2)
        m = block.shape[1]
        if m != n:
            block = torch.nn.functional.pad(
                block, (0, 0, pair.rows_start, n - m - pair.rows_start))
        return block

    Ig, Jg = (pair.Ig, pair.Jg) if sl is None else (sl.Ig, sl.Jg)

    def A_pair(v):                           # (E, N, 2) -> (E, R) or (E, L)
        return torch.sum(coef_s * (_gather(v, Ig, E) - _gather(v, Jg, E)),
                         dim=2)

    def A_pair_T(y):                         # (E, R) or (E, L) -> (E, N, 2)
        if sl is not None:
            if k is None:
                return _segments((coef_T * y[..., None]).reshape(-1, 2),
                                 sl.offsets, E, n)
            R = y.shape[1] // 2
            return (agent_block(coef_T[:, :R] * y[:, :R, None])
                    - _segments((coef_T[:, R:] * y[:, R:, None])
                                .reshape(-1, 2), sl.offsets, E, n))
        contrib = coef_s * y[..., None]
        if k is not None:
            z = agent_block(contrib) - _segment_sum(contrib, pair.plan_J,
                                                    E, n)
        else:
            z = (_segment_sum(contrib, pair.plan_I, E, n)
                 - _segment_sum(contrib, pair.plan_J, E, n))
        return z if pair.axis is None else pair.axis.psum(z)

    def apply_K(v2):
        v = v2.reshape(E, n, 2)
        out = (1.0 + sigma + rho) * v + rho * A_pair_T(A_pair(v))
        return out.reshape(E, 2 * n)

    return apply_K, A_pair, A_pair_T


class _SolveK(torch.autograd.Function):
    """x = K^{-1} rhs with the implicit gradient (``_solve_K_fwd``/
    ``_solve_K_bwd``): dL/drhs = w with K w = dL/dx (K symmetric, one more
    CG solve of the same budget); dL/dcoef_s = -rho (A w (x_I - x_J) +
    A x (w_I - w_J)) per row, from dL = -w^T dK x restricted to K's rho
    A^T A block; x does not depend on the warm start."""

    @staticmethod
    def forward(coef_s, rhs, x_warm, iters, rho, sigma, pair):
        apply_K, _, _ = _make_apply_K(coef_s, pair, rho, sigma)
        return x_warm + _cg(apply_K, rhs - apply_K(x_warm), iters)

    @staticmethod
    def setup_context(ctx, inputs, output):
        coef_s, _, _, iters, rho, sigma, pair = inputs
        ctx.save_for_backward(coef_s, output)
        ctx.consts = (iters, rho, sigma, pair)

    @staticmethod
    def backward(ctx, ct):
        coef_s, x = ctx.saved_tensors
        iters, rho, sigma, pair = ctx.consts
        apply_K, A_pair, _ = _make_apply_K(coef_s, pair, rho, sigma)
        w = _cg(apply_K, ct, iters)
        E = pair.E
        xv, wv = x.reshape(E, -1, 2), w.reshape(E, -1, 2)
        dx_p = _gather(xv, pair.Ig, E) - _gather(xv, pair.Jg, E)
        dw_p = _gather(wv, pair.Ig, E) - _gather(wv, pair.Jg, E)
        Ax = torch.sum(coef_s * dx_p, dim=2)
        Aw = torch.sum(coef_s * dw_p, dim=2)
        d_coef = -rho * (Aw[..., None] * dx_p + Ax[..., None] * dw_p)
        return d_coef, w, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, coef_s, rhs, x_warm, iters, rho, sigma, pair):
        """The mapped axis folded into the member axis: B batches of E
        members solve as B * E members through the Function itself, so
        the implicit rule holds under ``torch.func.vmap`` (JAX's
        ``custom_vjp`` does under ``jax.vmap``)."""
        B, E = info.batch_size, pair.E

        def lead(t, dim):
            return t.expand(B, *t.shape) if dim is None else t.movedim(dim, 0)

        def fold(t, dim):
            t = lead(t, dim)
            return t.reshape(B * E, *t.shape[2:])

        def shifted(idx, stride):
            """(B, L) flat indices, batch b's shifted by b * stride."""
            base = torch.arange(B, dtype=idx.dtype, device=idx.device)
            return idx + base[:, None] * stride

        def fold_plan(plan, dims):
            """B plans over L values each -> one plan over B * L values:
            batch b's targets follow batch b - 1's, so its permutation and
            segment offsets shift by b * L."""
            if plan is None:
                return None
            perm = lead(plan.perm, dims.perm)
            L = perm.shape[1]
            offsets = shifted(lead(plan.offsets, dims.offsets), L)
            return _SegmentPlan(shifted(perm, L).reshape(-1),
                                torch.cat([offsets[:, :-1].reshape(-1),
                                           offsets[-1, -1:]]))

        pd = in_dims[6]
        stride = E * pair.n
        folded = _Pair(shifted(lead(pair.Ig, pd.Ig), stride).reshape(-1),
                       shifted(lead(pair.Jg, pd.Jg), stride).reshape(-1),
                       fold_plan(pair.plan_I, pd.plan_I),
                       fold_plan(pair.plan_J, pd.plan_J),
                       None,         # the fused iteration never solves here
                       B * E, pair.n, pair.agent_k, pair.rows_start,
                       pair.axis)
        x = _SolveK.apply(fold(coef_s, in_dims[0]), fold(rhs, in_dims[1]),
                          fold(x_warm, in_dims[2]), iters, rho, sigma,
                          folded)
        return x.reshape(B, E, *x.shape[1:]), 0


def _solve_K(iters: int, rho_sigma, coef_s, pair: _Pair, rhs, x_warm):
    """Warm-started SPD solve x = K^{-1} rhs: x_warm + CG(K, rhs - K
    x_warm), differentiable by the implicit rule of :class:`_SolveK` —
    under ``torch.func.vmap`` too, whose batched tensors hide
    ``requires_grad``, so the Function applies whenever grad mode is on."""
    rho, sigma = rho_sigma
    if torch.is_grad_enabled():
        return _SolveK.apply(coef_s, rhs, x_warm, iters, rho, sigma, pair)
    return _SolveK.forward(coef_s, rhs, x_warm, iters, rho, sigma, pair)


class _PairOps(NamedTuple):
    """Prepared per-problem operands for one ADMM drive, every leaf with
    the member axis E leading."""
    pair: _Pair           # gathers and transpose plans
    coef_s: torch.Tensor  # (E, R, 2) equilibrated row directions
    b_s: torch.Tensor     # (E, R) equilibrated pair bounds
    q: torch.Tensor       # (E, 2N) linear term (-u_nom flattened)
    lo: torch.Tensor      # (E, 2N) box lower
    hi: torch.Tensor      # (E, 2N) box upper
    d: torch.Tensor       # (E, R) row equilibration scales (> 0)
    coef: torch.Tensor    # (E, R, 2) original rows (residual geometry)
    b_pair: torch.Tensor  # (E, R) original pair bounds
    ev_hi: torch.Tensor   # (E,) Chebyshev upper spectral bound for K
    # The fused iteration: coef_s, b_s, d and b_pair are in the slot layout
    # (L for R), and coef_T is coef_s signed for the transpose.
    coef_T: torch.Tensor | None = None


def _prepare_ops(u_nom, I, J, coef, b_pair, lo, hi, settings,
                 agent_k=None, rows_start: int = 0, axis=None) -> _PairOps:
    """Equilibrate rows and precompute what the iteration consumes, for
    (E, N, 2) nominals and (E, R) rows. Pair row norm = sqrt(2) ||c||; a
    zero (padding) row gets d = 1 and stays inert. ``ev_hi`` (Chebyshev
    only): lambda_max(K) <= (1 + sigma + rho) + rho ||A||_1 ||A||_inf."""
    E, N = u_nom.shape[0], u_nom.shape[1]
    dtype = torch.promote_types(u_nom.dtype, coef.dtype)
    rho, sigma = settings.rho, settings.sigma

    c_norm = 2.0 ** 0.5 * safe_norm(coef, dim=2)
    d = torch.where(c_norm > 1e-10,
                    1.0 / torch.clamp(c_norm, min=1e-10), 1.0)
    coef_s = coef * d[..., None]
    zero_rows = torch.all(coef_s == 0.0, dim=2)
    pair = _pair_layout(I, J, N, zero_rows, agent_k=agent_k,
                        rows_start=rows_start, fused=settings.fused,
                        axis=axis)
    b_s = torch.where(torch.isfinite(b_pair), b_pair * d, b_pair)
    q = -u_nom.reshape(E, -1)

    if settings.ksolve == "chebyshev":
        a = torch.abs(coef_s)
        row_l1 = 2.0 * torch.sum(a, dim=2)          # full-row L1 (-c, +c)
        # |coef_s| onto both endpoints, by the generic two-sided plans.
        both = (pair if pair.plan_I is not None
                else _pair_layout(I, J, N, zero_rows))
        col = (_segment_sum(a, both.plan_I, E, N)
               + _segment_sum(a, both.plan_J, E, N))
        a_inf = _amax0(row_l1)
        a_one = _amax0(col.reshape(E, -1))
        ev_hi = (1.0 + sigma + rho) + rho * a_inf * a_one
    else:
        ev_hi = torch.zeros((E,), dtype=dtype, device=u_nom.device)

    coef_T = None
    sl = pair.slots
    if sl is not None:
        coef_s, b_s, d, b_pair = (
            _to_slots(a, sl) for a in (coef_s, b_s, d, b_pair))
        coef_T = torch.where(sl.neg[..., None], -coef_s, coef_s)
    return _PairOps(pair=pair, coef_s=coef_s, b_s=b_s, q=q,
                    lo=torch.broadcast_to(lo, (E, N, 2)).reshape(E, -1),
                    hi=torch.broadcast_to(hi, (E, N, 2)).reshape(E, -1),
                    d=d, coef=coef, b_pair=b_pair, ev_hi=ev_hi,
                    coef_T=coef_T)


def _amax0(x):
    """Per-member max over the last axis with 0 as the initial value
    (``jnp.max(x, axis=-1, initial=0.0)``): (E, n) -> (E,)."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return torch.clamp(torch.amax(x, dim=-1), min=0.0)


def _iteration_fns(N: int, settings):
    """(step, residuals, init_carry, final_carry) over (_PairOps, carry) —
    the solver's iteration machinery, shared by the single-problem and the
    lockstep batched drivers. Carry: (x, z_p, z_b, y_p, y_b), each (E,
    ...), plus the pair image ``A x`` of the current x in fused mode
    (recomputed from x every iteration, never accumulated; the pair rows
    in the slot layout). The external warm-state contract stays the
    5-tuple in row order (``final_carry``)."""
    rho, sigma, alpha = settings.rho, settings.sigma, settings.alpha
    fused = settings.fused
    ev_lo = 1.0 + sigma + rho

    def step(ops, carry):
        apply_K, A_pair, A_pair_T = _make_apply_K(ops.coef_s, ops.pair,
                                                  rho, sigma, ops.coef_T)
        E = ops.pair.E
        if fused:
            x, z_p, z_b, y_p, y_b, Ax = carry
            # rhs - K x in one transpose: the sigma x proximal term and
            # K's (1 + sigma + rho) x diagonal cancel to -(1 + rho) x, and
            # the carried pair image supplies K's A^T A term.
            r0 = (A_pair_T(rho * z_p - y_p - rho * Ax).reshape(E, -1)
                  + (rho * z_b - y_b) - ops.q - (1.0 + rho) * x)
            if settings.ksolve == "chebyshev":
                dx = _chebyshev(apply_K, r0, settings.cg_iters, ev_lo,
                                ops.ev_hi)
            else:
                dx = _cg(apply_K, r0, settings.cg_iters)
            x_new = x + dx
        else:
            x, z_p, z_b, y_p, y_b = carry
            # rhs = sigma x - q + A^T (rho z - y), split over the blocks.
            rhs = (sigma * x - ops.q
                   + A_pair_T(rho * z_p - y_p).reshape(E, -1)
                   + (rho * z_b - y_b))
            x_new = _solve_K(settings.cg_iters, (rho, sigma), ops.coef_s,
                             ops.pair, rhs, x)
        Ax_p = A_pair(x_new.reshape(E, N, 2))
        z_p_new, y_p_new = relaxed_zy_update(
            Ax_p, z_p, y_p, rho, alpha,
            lambda w: torch.minimum(w, ops.b_s))
        z_b_new, y_b_new = relaxed_zy_update(
            x_new, z_b, y_b, rho, alpha,
            lambda w: torch.clamp(w, ops.lo, ops.hi))
        new = (x_new, z_p_new, z_b_new, y_p_new, y_b_new)
        return new + ((Ax_p,) if fused else ())

    def residuals(ops, carry):
        """(primal, dual), each (E,), in the original row geometry (the
        dual residual is scale-invariant). Fused: the carried pair image
        is exactly A_pair(x) in scaled geometry, so the primal check
        unscales it instead of paying a fresh gather."""
        x, y_p, y_b = carry[0], carry[3], carry[4]
        E = ops.pair.E
        _, _, A_pair_T = _make_apply_K(ops.coef_s, ops.pair, rho, sigma,
                                       ops.coef_T)
        if fused:
            Ax_orig = carry[5] / ops.d
        else:
            u = x.reshape(E, N, 2)
            Ax_orig = torch.sum(ops.coef * (_gather(u, ops.pair.Ig, E)
                                            - _gather(u, ops.pair.Jg, E)),
                                dim=2)
        viol_p = _amax0(torch.clamp(Ax_orig - ops.b_pair, min=0.0))
        if ops.pair.axis is not None:
            # Each rank sees its own rows: the max completes over the axis.
            viol_p = ops.pair.axis.pmax(viol_p)
        viol_b = _amax0(torch.clamp(
            torch.maximum(ops.lo - x, x - ops.hi), min=0.0))
        primal = torch.maximum(viol_p, viol_b)
        dual_vec = x + ops.q + A_pair_T(y_p).reshape(E, -1) + y_b
        dual = torch.amax(torch.abs(dual_vec), dim=1)
        return primal, dual

    def init_carry(ops, warm_state):
        E = ops.pair.E
        if warm_state is not None:
            carry = tuple(warm_state)
            if fused:
                # The pair rows into the slot layout.
                carry = tuple(_to_slots(a, ops.pair.slots) if i in (1, 3, 5)
                              else a for i, a in enumerate(carry))
            if fused and len(carry) == 5:
                _, A_pair, _ = _make_apply_K(ops.coef_s, ops.pair, rho,
                                             sigma, ops.coef_T)
                carry = carry + (A_pair(carry[0].reshape(E, N, 2)),)
            return carry
        x0 = torch.zeros_like(ops.q)
        zp0 = torch.zeros_like(ops.b_s)
        carry = (x0, zp0, x0, zp0, x0)
        if fused:
            carry = carry + (zp0,)   # A_pair(0) == 0
        return carry

    def final_carry(ops, carry):
        """The solver's external 5-tuple carry, pair rows in row order."""
        carry = tuple(carry[:5])
        if fused:
            carry = tuple(_to_rows(a, ops.pair.slots) if i in (1, 3) else a
                          for i, a in enumerate(carry))
        return carry

    return step, residuals, init_carry, final_carry


def _worst_above(residuals, ops, state, tol: float):
    """0-dim bool: the worst member's max(primal, dual) residual above
    ``tol`` (False on NaN, as ``NaN > tol`` is in the JAX loop)."""
    p, dd = residuals(ops, state)
    return torch.amax(torch.maximum(p, dd)) > tol


def _drive(step, residuals, ops, carry0, settings):
    """Run the ADMM loop — a fixed loop (tol == 0) or blocks of
    ``check_every`` iterations stopping at tol (module docstring: a host
    loop eagerly, B selected blocks inside the compiled body). One loop
    drives every member (lockstep: the worst member's residual decides).
    Returns (final_carry, iterations 0-dim int32)."""
    device = ops.q.device

    def run(state, n):
        for _ in range(n):
            state = step(ops, state)
        return state

    if settings.tol <= 0.0:
        state = run(carry0, settings.iters)
        return state, torch.full((), settings.iters, dtype=torch.int32,
                                 device=device)
    n_blocks = -(-settings.iters // settings.check_every)
    state = carry0
    if not exact2d.in_guarded_body():
        blocks = 0
        while blocks < n_blocks and bool(
                _worst_above(residuals, ops, state, settings.tol)):
            state = run(state, settings.check_every)
            blocks += 1
        return state, torch.full((), blocks * settings.check_every,
                                 dtype=torch.int32, device=device)
    B = exact2d.guarded_blocks()
    B = n_blocks if B is None else min(int(B), n_blocks)
    blocks = torch.zeros((), dtype=torch.int32, device=device)
    for _ in range(B):
        going = _worst_above(residuals, ops, state, settings.tol)
        new = run(state, settings.check_every)
        state = tuple(torch.where(going, a, b) for a, b in zip(new, state))
        blocks = blocks + going.to(torch.int32)
    if B < n_blocks:
        exact2d.request_redo(_worst_above(residuals, ops, state,
                                          settings.tol))
    return state, blocks * settings.check_every


def _validate_settings(settings, axis_name):
    if settings.ksolve not in ("cg", "chebyshev"):
        raise ValueError(f"SparseADMMSettings.ksolve must be cg|chebyshev, "
                         f"got {settings.ksolve!r}")
    if settings.ksolve == "chebyshev" and not settings.fused:
        raise ValueError("SparseADMMSettings.ksolve='chebyshev' is the "
                         "fused iteration's inner solver — set fused=True")
    if settings.fused and axis_name is not None:
        raise ValueError(
            "SparseADMMSettings.fused is not supported in row-partitioned "
            "mode (axis_name set): the carried pair image and the "
            "spectral-bound reduction are unproven under shard_map "
            "varying-manual-axes promotion — sharded solves keep the CG "
            "path")
    if settings.tol > 0.0 and axis_name is not None:
        # The residual check's collectives would decide a host loop per
        # rank; the JAX package rejects it here, at the one place the
        # incompatibility lives.
        raise ValueError(
            "SparseADMMSettings.tol > 0 (adaptive budget) is not "
            "supported in row-partitioned mode (axis_name set): the "
            "while_loop's residual cond would run collectives — use "
            "a fixed iteration budget for sharded solves")


def solve_pair_box_qp_admm(u_nom, I, J, coef, b_pair, lo, hi,
                           settings: SparseADMMSettings = SparseADMMSettings(),
                           axis_name: str | None = None,
                           agent_k: int | None = None, rows_start: int = 0,
                           warm_state=None, with_state: bool = False):
    """Solve the neighbour-pair QP above. Returns (u (N, 2),
    SparseADMMInfo)[, final carry].

    Args as the JAX package's: u_nom (N, 2); I, J (R,) integer pair
    endpoints (a pair may repeat in either order); coef (R, 2) row
    directions (a zero row with b >= 0 is inert padding); b_pair (R,)
    upper bounds; lo, hi (N, 2) component box (+-inf = unbounded).
    ``agent_k`` declares ``I == rows_start + repeat(arange(R // agent_k),
    agent_k)`` (the certificate's layout), so the I side of the transpose
    is a reshape-sum. ``warm_state`` is a previous call's carry (x, z_p,
    z_b, y_p, y_b), which ``with_state=True`` appends to the return.
    ``axis_name``: row-partitioned mode (module docstring) — this rank
    passes only the rows it owns, u_nom/lo/hi replicated; the returned u
    and residuals are replicated over the axis."""
    _validate_settings(settings, axis_name)
    axis = None
    if axis_name is not None:
        from cbf_tpu_torch.parallel.mesh import resolve_axis

        axis = resolve_axis(axis_name)
        if axis.size == 1:
            axis = None
    N = u_nom.shape[0]
    u, info, state = _solve_members(
        u_nom[None], I, J[None], coef[None], b_pair[None],
        torch.broadcast_to(lo, (N, 2))[None],
        torch.broadcast_to(hi, (N, 2))[None], settings, agent_k, rows_start,
        None if warm_state is None else tuple(s[None] for s in warm_state),
        axis)
    info = SparseADMMInfo(info.primal_residual[0], info.dual_residual[0],
                          info.iterations)
    if with_state:
        return u[0], info, tuple(s[0] for s in state)
    return u[0], info


def _solve_members(u_nom, I, J, coef, b_pair, lo, hi, settings, agent_k,
                   rows_start, warm_state, axis=None):
    """The shared driver over a leading member axis. Returns (u (E, N, 2),
    SparseADMMInfo of (E,) residuals and 0-dim iterations, 5-tuple
    carry)."""
    E, N = u_nom.shape[0], u_nom.shape[1]
    ops = _prepare_ops(u_nom, I, J, coef, b_pair, lo, hi, settings,
                       agent_k=agent_k, rows_start=rows_start, axis=axis)
    step, residuals, init_carry, final_carry = _iteration_fns(N, settings)
    carry0 = init_carry(ops, warm_state)
    state, iterations = _drive(step, residuals, ops, carry0, settings)
    primal, dual = residuals(ops, state)
    return (state[0].reshape(E, N, 2),
            SparseADMMInfo(primal, dual, iterations),
            final_carry(ops, state))


def solve_pair_box_qp_admm_batched(
        u_nom, I, J, coef, b_pair, lo, hi,
        settings: SparseADMMSettings = SparseADMMSettings(),
        agent_k: int | None = None, warm_state=None,
        with_state: bool = False):
    """Lockstep-batched twin of :func:`solve_pair_box_qp_admm`: E members'
    solves through one shared iteration loop, each op carrying every
    member's rows; under ``tol > 0`` the loop stops when the worst
    member's residual clears tol, and every member reports the shared trip
    count.

    Args as the single-problem entry with a leading member axis on
    ``u_nom`` (E, N, 2), ``J`` (E, R), ``coef`` (E, R, 2), ``b_pair``
    (E, R), ``lo``/``hi`` (E, N, 2) and each leaf of ``warm_state``; ``I``
    (R,) stays shared. Returns (u (E, N, 2), SparseADMMInfo with (E,)
    residuals and (E,) iterations)[, 5-tuple carry of (E, ...) leaves]."""
    if u_nom.dim() != 3:
        raise ValueError(f"batched solver needs (E, N, 2) nominals, got "
                         f"{tuple(u_nom.shape)}")
    if J.dim() != 2:
        raise ValueError(f"batched solver needs a member-batched (E, R) J, "
                         f"got {tuple(J.shape)} (I stays shared)")
    _validate_settings(settings, None)
    E = u_nom.shape[0]
    u, info, state = _solve_members(
        u_nom, I, J, coef, b_pair, lo, hi, settings, agent_k, 0,
        None if warm_state is None else tuple(warm_state))
    info = info._replace(iterations=info.iterations.expand(E))
    if with_state:
        return u, info, state
    return u, info


def admm_iteration_spec(N: int = 64, k: int = 8,
                        settings: SparseADMMSettings = SparseADMMSettings(),
                        agent_k: int | None = None, device=None):
    """(step_fn, carry0): ONE ADMM iteration as a unary function of its
    carry, on the JAX package's deterministic synthetic agent-major pair
    problem (same numpy construction: I = repeat(arange(N), k), J never
    self, non-degenerate directions), one member — the hook of the
    chain-depth audit (AUD003, :func:`cbf_tpu_torch.analysis.audits.
    chain_profile`). ``device`` None is the card."""
    from cbf_tpu_torch.scenarios.swarm import resolve_device

    device = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    idx = np.arange(N * k)
    I = t(np.repeat(np.arange(N), k), torch.int32)
    J = t((np.repeat(np.arange(N), k) + 1 + idx % (N - 1)) % N, torch.int32)
    ang = 0.1 + 0.7 * (idx % 13)
    coef = t(np.stack([np.cos(ang), np.sin(ang)], axis=1))
    b_pair = torch.full((N * k,), 0.5, dtype=torch.float32, device=device)
    s = np.arange(N)
    u_nom = t(0.1 * np.stack([np.cos(s), np.sin(s)], axis=1))
    lo = torch.full((N, 2), -1.0, dtype=torch.float32, device=device)
    hi = torch.full((N, 2), 1.0, dtype=torch.float32, device=device)
    _validate_settings(settings, None)
    ops = _prepare_ops(u_nom[None], I, J[None], coef[None], b_pair[None],
                       lo[None], hi[None], settings, agent_k=agent_k)
    step, _, init_carry, _ = _iteration_fns(N, settings)
    return (lambda carry: step(ops, carry)), init_carry(ops, None)
