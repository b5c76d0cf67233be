"""Fixed-iteration OSQP-style ADMM for general dense QPs (counterpart:
cbf_tpu/solvers/admm.py).

Solves ``min 1/2 x^T P x + q^T x  s.t.  l <= A x <= u`` with a fixed
iteration count and no data-dependent exit, so the whole solve runs on the
device without a host read and a CUDA graph can capture it. The linear
system ``K = P + sigma I + rho A^T A`` is factored once per problem by
``torch.linalg.cholesky_ex`` (``torch.linalg.cholesky`` would read its
info flag on the host) and every iteration solves with two triangular
solves (``torch.linalg.solve_triangular``; one ``cholesky_solve`` on
the CPU, bit for bit). ``torch.cholesky_solve`` of a batch, which
``torch.func.vmap`` over the falsifier's candidates makes, runs MAGMA's
batched solve on the card, and that allocates device memory itself, so
a CUDA graph cannot capture it.

Used for the dense joint barrier certificate
(:func:`cbf_tpu_torch.sim.certificates.si_barrier_certificate`), whose QP
has 2N variables and O(N^2) pair rows.

Algorithm (standard OSQP splitting, fixed rho/sigma/alpha):
    x+ = (P + sigma I + rho A^T A)^{-1} (sigma x - q + A^T (rho z - y))
    z+ = clip(A x+ + y / rho, l, u)
    y+ = y + rho (A x+ - z+)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ADMMSettings(NamedTuple):
    rho: float = 1.0
    sigma: float = 1e-6
    alpha: float = 1.6       # over-relaxation
    iters: int = 200


class ADMMInfo(NamedTuple):
    primal_residual: torch.Tensor
    dual_residual: torch.Tensor


def relaxed_zy_update(Ax, z, y, rho, alpha, project):
    """One over-relaxed ADMM (z, y) block update — the one definition of
    the splitting's projection step, shared with the sparse solver's
    drivers. ``project`` is the constraint-set projection for the block
    (a clip for two-sided rows, a min for one-sided pair rows)."""
    Ax_relaxed = alpha * Ax + (1.0 - alpha) * z
    z_new = project(Ax_relaxed + y / rho)
    y_new = y + rho * (Ax_relaxed - z_new)
    return z_new, y_new


def _scale_bound(bound, d):
    """``bound * d`` where finite; infinite bounds keep their sign (0 *
    inf would be nan)."""
    return torch.where(torch.isfinite(bound), bound * d, bound)


def solve_box_qp_admm(P, q, A, l, u, settings: ADMMSettings = ADMMSettings()):
    """Solve one QP. Returns (x, ADMMInfo).

    Rows of (A, l, u) are equilibrated to unit norm before splitting (the
    certificate's rows mix scales across orders of magnitude, which stalls
    fixed-rho ADMM); the residuals are reported in the original row
    geometry."""
    n = q.shape[0]
    m = l.shape[0]
    dtype = torch.promote_types(torch.promote_types(P.dtype, q.dtype),
                                A.dtype)
    rho, sigma, alpha = settings.rho, settings.sigma, settings.alpha

    A_orig, l_orig, u_orig = A, l, u
    row_norm = torch.linalg.vector_norm(A, dim=1)
    d = 1.0 / torch.clamp(row_norm, min=1e-10)
    A = A * d[:, None]
    l = _scale_bound(l, d)
    u = _scale_bound(u, d)

    K = (P + sigma * torch.eye(n, dtype=dtype, device=q.device)
         + rho * (A.T @ A))
    L, _ = torch.linalg.cholesky_ex(K)

    x = torch.zeros((n,), dtype=dtype, device=q.device)
    z = torch.zeros((m,), dtype=dtype, device=q.device)
    y = torch.zeros((m,), dtype=dtype, device=q.device)
    for _ in range(settings.iters):
        rhs = sigma * x - q + A.T @ (rho * z - y)
        w = torch.linalg.solve_triangular(L, rhs[:, None], upper=False)
        x = torch.linalg.solve_triangular(L.mT, w, upper=True)[:, 0]
        z, y = relaxed_zy_update(A @ x, z, y, rho, alpha,
                                 lambda w: torch.clamp(w, l, u))

    Ax = A_orig @ x
    primal = torch.amax(torch.abs(Ax - torch.clamp(Ax, l_orig, u_orig)))
    dual = torch.amax(torch.abs(P @ x + q + A.T @ y))
    return x, ADMMInfo(primal, dual)
