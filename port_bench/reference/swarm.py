"""Plain reference of the swarm step that the benchmark's cells drive.

Written from the published semantics of the rendezvous swarm under the
CBF safety filter and the joint barrier certificate, in plain PyTorch
ops, for the configurations the benchmark runs: single-integrator agents,
the continuous position barrier, no obstacles. It imports nothing of the
program and takes nothing the program made: it is handed positions and
velocities and works out everything else again.

One step, per member of a leading batch axis (x (..., N, 2)):

1. consensus nominal: pull toward the centroid, only outside the packing
   disk, then an L2 cap at ``speed_limit``;
2. gating: each agent's ``k`` nearest agents within ``radius`` (squared
   distances in the working dtype, difference form; ties to the lower
   index; coincident points are no neighbours), the in-radius count and
   the nearest distance to any agent;
3. the filter: per agent ``min ||du||^2`` subject to the barrier rows
   ``-s (sx, sy) . du <= gamma h + s (sx, sy) . u0`` of its kept
   neighbours (h = |dx| + |dy| - dmin, s the barrier's control scale) and
   the actuator box rows; rows of one sign class reduce to the tightest.
   The 2-D problem is solved exactly by enumerating its KKT candidates;
   when it is empty, every barrier row is relaxed by 1 per round, up to
   ``max_relax`` rounds, and the round count is reported;
4. optionally the joint certificate: ``min ||u - u_nom||^2`` over all
   agents with cubic pair rows to each agent's ``cert_k`` nearest within
   the binding radius and an arena box, by the fixed-budget over-relaxed
   ADMM with a conjugate-gradient x-update (rows equilibrated to unit
   norm), cold-started;
5. first-order integration ``x + dt u``.

``dtype`` is the working precision: float32 is the configuration's,
bfloat16 is the control that a sound comparison must reject.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Params(NamedTuple):
    """The sizes and gains of one configuration (``from_config``)."""
    n: int
    k: int
    radius: float
    consensus_gain: float
    pack_radius: float
    speed_limit: float
    max_speed: float
    dmin: float
    gamma: float
    dyn_scale: float
    dt: float
    max_relax: int
    certificate: bool
    cert_k: int
    cert_gain: float
    cert_radius: float
    cert_limit: float
    arena_half: float
    admm_iters: int
    cg_iters: int
    rho: float
    sigma: float
    alpha: float


def binding_pair_radius(gain: float, r: float, limit: float,
                        headroom: float = 1.25) -> float:
    """Separation beyond which a certificate pair row cannot bind: the
    row's left side is at most 4 d c (c = 2 x the magnitude limit) while
    its margin is gain (d^2 - r^2)^3; the crossing by bisection, times
    ``headroom``."""
    c = 2.0 * limit
    lo, hi = r, max(4.0 * r, 1.0)
    while gain * (hi * hi - r * r) ** 3 < 4.0 * hi * c:
        hi *= 2.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if gain * (mid * mid - r * r) ** 3 < 4.0 * mid * c:
            lo = mid
        else:
            hi = mid
    return hi * headroom


def from_config(cfg: dict) -> Params:
    """Params from a configuration file's ``swarm`` fields (the program's
    defaults where a field is absent, as the file states them)."""
    s = cfg["swarm"]
    if s.get("dynamics", "single") != "single" or s.get("n_obstacles", 0):
        raise ValueError("the reference covers single-integrator swarms "
                         "without obstacles")
    if s.get("barrier", "auto") not in ("auto", "continuous"):
        raise ValueError("the reference covers the continuous barrier")
    n = int(s["n"])
    half = max(1.5, 0.2 * math.sqrt(n))
    cert = bool(s.get("certificate", False))
    if cert and (n <= 128 or s.get("certificate_warm_start")
                 or s.get("certificate_tol") is not None
                 or s.get("certificate_fused")):
        raise ValueError("the reference covers the sparse certificate at "
                         "its fixed, cold-started budget")
    gain, r_safe, limit = 100.0, 0.12, float(s.get("speed_limit", 0.2))
    return Params(
        n=n, k=int(s.get("k_neighbors", 8)),
        radius=float(s.get("safety_distance", 0.4)),
        consensus_gain=float(s.get("consensus_gain", 1.0)),
        pack_radius=float(s.get("pack_spacing", 0.14)) * math.sqrt(n),
        speed_limit=limit, max_speed=float(s.get("max_speed", 15.0)),
        dmin=0.2, gamma=0.5, dyn_scale=float(s.get("dyn_scale", 0.1)),
        dt=float(s.get("dt", 0.033)), max_relax=64, certificate=cert,
        cert_k=min(int(s.get("certificate_k", 16)), n - 1), cert_gain=gain,
        cert_radius=r_safe, cert_limit=limit, arena_half=1.5 * half,
        admm_iters=int(s.get("certificate_iters") or 100),
        cg_iters=int(s.get("certificate_cg_iters") or 8),
        rho=1.0, sigma=1e-6, alpha=1.6)


class StepOut(NamedTuple):
    """What one reference step gives, per member (leading axes of x)."""
    u: torch.Tensor              # (..., N, 2) applied control
    x_new: torch.Tensor          # (..., N, 2)
    nearest: torch.Tensor        # (..., N) nearest distance to any agent
    engaged: torch.Tensor        # (..., N) bool: some neighbour kept
    feasible: torch.Tensor       # (..., N) bool
    relax_rounds: torch.Tensor   # (..., N)
    dropped: torch.Tensor        # (..., N) in-radius agents beyond k
    cert_residual: torch.Tensor | None
    cert_dropped: torch.Tensor | None


def sqrt_rn(d2):
    """Square root rounded once to d2's dtype (taken in float64)."""
    return torch.sqrt(d2.to(torch.float64)).to(d2.dtype)


def pair_d2(x):
    """(..., N, N) squared distances, difference form, each operation
    rounded on its own."""
    dx = x[..., :, None, 0] - x[..., None, :, 0]
    dy = x[..., :, None, 1] - x[..., None, :, 1]
    return dx * dx + dy * dy


def knn(x, radius: float, k: int):
    """(idx (..., N, k) int64, kept (..., N, k) bool, count (..., N),
    nearest (..., N)): each agent's k nearest within ``radius`` (0 < d^2
    < r^2, r^2 formed in x's dtype), ties to the lower index."""
    n = x.shape[-2]
    d2 = pair_d2(x)
    r = torch.tensor(radius, dtype=x.dtype, device=x.device)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    nearest = sqrt_rn(torch.amin(torch.where(eye, inf, d2), dim=-1))
    eligible = (d2 < r * r) & (d2 > 0)
    count = torch.sum(eligible, dim=-1)
    key, idx = torch.sort(torch.where(eligible, d2, inf), dim=-1,
                          stable=True)
    return idx[..., :k], torch.isfinite(key[..., :k]), count, nearest


def _gather_rows(x, idx):
    """x (..., N, 2) at idx (..., N, k) -> (..., N, k, 2)."""
    lead = x.shape[:-2]
    flat = x.reshape(-1, x.shape[-2], 2)
    fidx = idx.reshape(flat.shape[0], -1)
    out = torch.gather(flat, 1, fidx[..., None].expand(-1, -1, 2))
    return out.reshape(lead + idx.shape[-2:] + (2,))


def nominal(x, p: Params):
    """Consensus nominal with the L2 speed cap, (..., N, 2)."""
    centroid = torch.mean(x, dim=-2, keepdim=True)
    to_c = centroid - x
    d_c = torch.linalg.vector_norm(to_c, dim=-1, keepdim=True)
    pull = torch.clamp(d_c - p.pack_radius, min=0.0)
    u0 = p.consensus_gain * pull * to_c / torch.clamp(d_c, min=1e-9)
    mag = torch.linalg.vector_norm(u0, dim=-1, keepdim=True)
    return u0 * torch.clamp(p.speed_limit / torch.clamp(mag, min=1e-9),
                            max=1.0)


_I, _J = torch.triu_indices(8, 8, 1)


def project(A, b, present, tol: float):
    """Euclidean projection of the origin onto {du : A du <= b} over the
    present rows, by KKT enumeration (origin, single rows, row pairs).
    A (..., M, 2), b (..., M). Returns (du (..., 2), found, violation)."""
    I, J = _I.to(A.device), _J.to(A.device)
    b = torch.where(present, b, torch.zeros_like(b))
    n2 = torch.sum(A * A, dim=-1)
    ok = present & (n2 > 1e-12)
    x1 = A * (b / torch.where(ok, n2, torch.ones_like(n2)))[..., None]
    d1 = ok & (b <= tol)
    ai, aj, bi, bj = A[..., I, :], A[..., J, :], b[..., I], b[..., J]
    det = ai[..., 0] * aj[..., 1] - ai[..., 1] * aj[..., 0]
    gii, gjj = n2[..., I], n2[..., J]
    gij = torch.sum(ai * aj, dim=-1)
    detg = gii * gjj - gij * gij
    pok = (ok[..., I] & ok[..., J] & (torch.abs(det) > 1e-10)
           & (torch.abs(detg) > 1e-20))
    one = torch.ones_like(det)
    sdet, sdetg = torch.where(pok, det, one), torch.where(pok, detg, one)
    x2 = torch.stack([(aj[..., 1] * bi - ai[..., 1] * bj) / sdet,
                      (ai[..., 0] * bj - aj[..., 0] * bi) / sdet], dim=-1)
    li = (-bi * gjj + bj * gij) / sdetg
    lj = (-bj * gii + bi * gij) / sdetg
    d2 = pok & (li >= -tol) & (lj >= -tol)
    X = torch.cat([torch.zeros_like(x1[..., :1, :]), x1, x2], dim=-2)
    dual = torch.cat([torch.ones_like(d1[..., :1]), d1, d2], dim=-1)
    ax = torch.sum(X[..., :, None, :] * A[..., None, :, :], dim=-1)
    slack = torch.where(present[..., None, :], ax - b[..., None, :],
                        torch.full_like(ax, -float("inf")))
    viol = torch.amax(slack, dim=-1)                     # (..., C)
    valid = (viol <= tol) & dual
    norm2 = torch.sum(X * X, dim=-1)
    found = torch.any(valid, dim=-1)
    score = torch.where(found[..., None],
                        torch.where(valid, norm2,
                                    torch.full_like(norm2, float("inf"))),
                        viol)
    pick = torch.argmin(score, dim=-1)
    du = torch.gather(X, -2, pick[..., None, None].expand(
        pick.shape + (1, 2)))[..., 0, :]
    v = torch.gather(viol, -1, pick[..., None])[..., 0]
    return du, found, v


def filter_rows(x, v, u0, idx, kept, p: Params):
    """The deduplicated rows (A (..., N, 8, 2), b, present, relax) of every
    agent: 4 barrier sign classes, then 4 box directions."""
    dtype = x.dtype
    d = x[..., :, None, :] - _gather_rows(x, idx)         # (..., N, k, 2)
    sx = torch.where(d[..., 0] < 0, -1.0, 1.0).to(dtype)
    sy = torch.where(d[..., 1] < 0, -1.0, 1.0).to(dtype)
    h = sx * d[..., 0] + sy * d[..., 1] - p.dmin
    s = p.dyn_scale
    b_row = (p.gamma * h
             + s * (sx * u0[..., None, 0] + sy * u0[..., None, 1]))
    big = torch.full_like(b_row, float("inf"))
    classes, present = [], []
    for cx, cy in ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)):
        member = kept & (sx == cx) & (sy == cy)
        classes.append(torch.amin(torch.where(member, b_row, big), dim=-1))
        present.append(torch.any(member, dim=-1))
    ms = p.max_speed
    u0x, u0y, vx, vy = u0[..., 0], u0[..., 1], v[..., 0], v[..., 1]
    # The actuator box in the reference layout's pairing of rows and
    # bounds (velocity-coupled rows included), tightest per direction.
    box = [torch.minimum(ms - u0x, ms - vx - u0x),
           torch.minimum(ms + u0x, ms - vy - u0y),
           torch.minimum(ms - u0y, ms + vx + u0x),
           torch.minimum(ms + u0y, ms + vy + u0y)]
    b = torch.stack(classes + box, dim=-1)
    pres = torch.stack(present + [torch.ones_like(present[0])] * 4, dim=-1)
    dirs = torch.tensor([[-s, -s], [-s, s], [s, -s], [s, s],
                         [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]],
                        dtype=dtype, device=x.device)
    A = dirs.expand(b.shape + (2,))
    relax = torch.tensor([1.0] * 4 + [0.0] * 4, dtype=dtype,
                         device=x.device)
    return A, b, pres, relax


def solve_filter(A, b, present, relax, max_relax: int, tol: float = 1e-4):
    """Each agent's QP at the first relax round (0..max_relax) where it is
    feasible; the least-violating point at max_relax where none is.
    Returns (du, feasible, rounds)."""
    du, found, _ = project(A, b, present, tol)
    rounds = torch.zeros(found.shape, dtype=b.dtype, device=b.device)
    r = 0
    while r < max_relax and not bool(torch.all(found)):
        r += 1
        du2, f2, _ = project(A, b + r * relax, present, tol)
        upd = ~found
        du = torch.where(upd[..., None], du2, du)
        rounds = torch.where(upd, torch.full_like(rounds, r), rounds)
        found = found | f2
    return du, found, rounds


def certificate(u, x, p: Params):
    """The joint certificate of one swarm: u, x (N, 2). Returns
    (u_certified, primal residual, uncovered in-radius pairs)."""
    n, k = x.shape[0], p.cert_k
    dtype, dev = x.dtype, x.device
    norms = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    u_nom = u / torch.clamp(norms / p.cert_limit, min=1.0)
    radius = binding_pair_radius(p.cert_gain, p.cert_radius, p.cert_limit)
    idx, kept, count, _ = knn(x, radius, k)
    I = torch.arange(n, device=dev).repeat_interleave(k)
    J = idx.reshape(-1)
    keep = kept.reshape(-1)
    # Uncovered pairs: in-radius pairs kept by neither endpoint.
    mutual = keep & torch.any((idx[J] == I[:, None]) & kept[J], dim=1)
    dropped = (torch.sum(count) // 2
               - (torch.sum(keep) - torch.sum(mutual) // 2))
    err = x[I] - x[J]
    h = torch.sum(err * err, dim=1) - p.cert_radius ** 2
    coef = torch.where(keep[:, None], -2.0 * err, torch.zeros_like(err))
    b = torch.where(keep, p.cert_gain * h ** 3,
                    torch.full_like(h, float("inf")))
    half, r2, gb = p.arena_half, p.cert_radius / 2.0, 0.4 * p.cert_gain
    hi = torch.stack([gb * (half - r2 - x[:, 0]) ** 3,
                      gb * (half - r2 - x[:, 1]) ** 3], dim=1).reshape(-1)
    lo = torch.stack([-gb * (x[:, 0] + half - r2) ** 3,
                      -gb * (x[:, 1] + half - r2) ** 3], dim=1).reshape(-1)
    cn = math.sqrt(2.0) * torch.linalg.vector_norm(coef, dim=1)
    dsc = torch.where(cn > 1e-10, 1.0 / torch.clamp(cn, min=1e-10),
                      torch.ones_like(cn))
    cs = coef * dsc[:, None]
    bs = torch.where(torch.isfinite(b), b * dsc, b)
    rho, sigma, alpha = p.rho, p.sigma, p.alpha

    def A_pair(w):                                # (2N,) -> (R,)
        w = w.reshape(n, 2)
        return torch.sum(cs * (w[I] - w[J]), dim=1)

    def A_pair_T(y):                              # (R,) -> (2N,)
        c = cs * y[:, None]
        z = torch.zeros((n, 2), dtype=dtype, device=dev)
        z.index_add_(0, I, c)
        z.index_add_(0, J, -c)
        return z.reshape(-1)

    def apply_K(w):
        return (1.0 + sigma + rho) * w + rho * A_pair_T(A_pair(w))

    def cg(rhs):
        r, q = rhs, rhs
        w = torch.zeros_like(rhs)
        rs = torch.sum(r * r)
        for _ in range(p.cg_iters):
            Kq = apply_K(q)
            a = rs / torch.clamp(torch.sum(q * Kq), min=1e-30)
            w = w + a * q
            r = r - a * Kq
            rs_new = torch.sum(r * r)
            q = r + (rs_new / torch.clamp(rs, min=1e-30)) * q
            rs = rs_new
        return w

    q_lin = -u_nom.reshape(-1)
    w = torch.zeros(2 * n, dtype=dtype, device=dev)
    zb, yb = torch.zeros_like(w), torch.zeros_like(w)
    zp = torch.zeros(I.shape[0], dtype=dtype, device=dev)
    yp = torch.zeros_like(zp)
    for _ in range(p.admm_iters):
        rhs = sigma * w - q_lin + A_pair_T(rho * zp - yp) + (rho * zb - yb)
        w = w + cg(rhs - apply_K(w))
        ax = alpha * A_pair(w) + (1.0 - alpha) * zp
        zp_new = torch.minimum(ax + yp / rho, bs)
        yp = yp + rho * (ax - zp_new)
        zp = zp_new
        axb = alpha * w + (1.0 - alpha) * zb
        zb_new = torch.clamp(axb + yb / rho, lo, hi)
        yb = yb + rho * (axb - zb_new)
        zb = zb_new
    ucert = w.reshape(n, 2)
    viol_p = torch.clamp(torch.sum(coef * (ucert[I] - ucert[J]), dim=1) - b,
                         min=0.0)
    viol_b = torch.clamp(torch.maximum(lo - w, w - hi), min=0.0)
    residual = torch.maximum(torch.amax(viol_p), torch.amax(viol_b))
    return ucert, residual, dropped


def step(x, v, p: Params) -> StepOut:
    """One reference step from positions x and last applied velocities v
    (..., N, 2), in their dtype."""
    u0 = nominal(x, p)
    idx, kept, count, nearest = knn(x, p.radius, p.k)
    A, b, pres, relax = filter_rows(x, v, u0, idx, kept, p)
    du, feasible, rounds = solve_filter(A, b, pres, relax, p.max_relax)
    engaged = torch.any(kept, dim=-1)
    u = torch.clamp(du + u0, -p.max_speed, p.max_speed)
    u = torch.where(engaged[..., None], u, u0)
    res = cdrop = None
    if p.certificate:
        if x.dim() != 2:
            raise ValueError("the certificate reference takes one swarm")
        u, res, cdrop = certificate(u, x, p)
    dropped = torch.clamp(count - p.k, min=0)
    return StepOut(u, x + p.dt * u, nearest, engaged, feasible, rounds,
                   dropped, res, cdrop)
