"""The port's ADMM solvers (cbf_tpu_torch.solvers.admm, the dense
OSQP splitting the dense certificate runs, and
cbf_tpu_torch.solvers.sparse_admm, the matrix-free pair-QP solver of the
sparse certificate) against the JAX package's, on the same numpy inputs
made from a seed.

Tolerances and why:
- float64 (the ``x64`` fixture): 1e-9 on solutions and residuals — both
  packages run the same arithmetic and differ only in summation order
  (XLA's scatter-adds and dots against the port's segment sums and
  reductions), a few ulps per iteration;
- float32: 1e-5 on solutions (tests/test_admm.py's tight tolerance) and
  residuals (~1e-7 at convergence); the dense dual residual, a max over
  rows of sums of ~1e1-sized terms, gets 10x;
- the iterations of the adaptive budget exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.solvers import admm as jadmm
from cbf_tpu.solvers import sparse_admm as jsp
from cbf_tpu.sim import certificates as jcert
from cbf_tpu_torch.sim import certificates as tcert
from cbf_tpu_torch.solvers import admm as tadmm
from cbf_tpu_torch.solvers import sparse_admm as tsp

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "f64": (jnp.float64, torch.float64, 1e-9)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dtypes(name, request):
    """(jax dtype, torch dtype, atol); float64 enables x64 for the test."""
    if name == "f64":
        request.getfixturevalue("x64")
    return DTYPES[name]


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(),
                               np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


def _cluster_states(n, rng):
    """tests/test_admm.py's states: half the agents clustered within ~2x
    the safety radius (binding pairs), half spread over the arena."""
    tight = rng.normal(0, 0.08, (2, n // 2))
    loose = rng.uniform(-1.2, 1.2, (2, n - n // 2))
    return np.concatenate([tight, loose], axis=1), rng.normal(0, 0.3, (2, n))


# -- the dense solver and certificate ----------------------------------------

@pytest.mark.parametrize("n", [4, 16, 32])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_dense_certificate_matches_jax(dt, n, request):
    jdt, tdt, atol = _dtypes(dt, request)
    x, dxi = _cluster_states(n, np.random.default_rng(100 + n))
    u_j, info_j = jcert.si_barrier_certificate(
        jnp.asarray(dxi, jdt), jnp.asarray(x, jdt), with_info=True)
    u_t, info_t = tcert.si_barrier_certificate(
        torch.as_tensor(dxi, dtype=tdt), torch.as_tensor(x, dtype=tdt),
        with_info=True)
    assert u_t.dtype == tdt and u_t.shape == (2, n)
    _close(u_t, u_j, atol, "u")
    _close(info_t.primal_residual, info_j.primal_residual, atol, "primal")
    _close(info_t.dual_residual, info_j.dual_residual, atol * 10, "dual")
    assert float(info_t.primal_residual) < 1e-4


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_dense_solver_two_sided_rows_match_jax(dt, request):
    """A general QP: SPD P, two-sided rows with some infinite bounds."""
    jdt, tdt, atol = _dtypes(dt, request)
    rng = np.random.default_rng(7)
    n, m = 12, 30
    M = rng.normal(size=(n, n))
    P = M @ M.T / n + np.eye(n)
    q, A = rng.normal(size=n), rng.normal(size=(m, n))
    l = rng.normal(size=m) - 1.0
    u = l + rng.uniform(0.1, 2.0, size=m)
    l[::4], u[1::5] = -np.inf, np.inf
    st = jadmm.ADMMSettings(iters=120)
    x_j, info_j = jadmm.solve_box_qp_admm(
        *(jnp.asarray(a, jdt) for a in (P, q, A, l, u)), st)
    x_t, info_t = tadmm.solve_box_qp_admm(
        *(torch.as_tensor(a, dtype=tdt) for a in (P, q, A, l, u)),
        tadmm.ADMMSettings(iters=120))
    _close(x_t, x_j, atol, "x")
    _close(info_t.primal_residual, info_j.primal_residual, atol, "primal")
    _close(info_t.dual_residual, info_j.dual_residual, atol * 10, "dual")


def test_dense_max_pairs_pruning_matches_jax():
    """N=64 pruned to 16N pair rows (a stable sort in the port, lax.top_k
    in JAX): the same rows, the same solution."""
    x, dxi = _cluster_states(64, np.random.default_rng(64))
    u_j, info_j = jcert.si_barrier_certificate(
        jnp.asarray(dxi, jnp.float32), jnp.asarray(x, jnp.float32),
        max_pairs=16 * 64, with_info=True)
    u_t, info_t = tcert.si_barrier_certificate(
        torch.as_tensor(dxi, dtype=torch.float32),
        torch.as_tensor(x, dtype=torch.float32), max_pairs=16 * 64,
        with_info=True)
    _close(u_t, u_j, 1e-5, "u")
    _close(info_t.primal_residual, info_j.primal_residual, 1e-5, "primal")


# -- the sparse solver -------------------------------------------------------

def _pair_problem(seed=4, N=64, k=6):
    """tests/test_sparse_certificate.py's agent-major problem: random
    partners (never self), 30% masked rows (zero coef, +inf bound)."""
    rng = np.random.default_rng(seed)
    I = np.repeat(np.arange(N), k)
    J = rng.integers(0, N, N * k)
    J = np.where(J == I, (J + 1) % N, J)
    mask = rng.random(N * k) < 0.7
    coef = np.where(mask[:, None], rng.normal(0, 1.0, (N * k, 2)), 0.0)
    b = np.where(mask, rng.uniform(0.1, 2.0, N * k), np.inf)
    u_nom = rng.normal(0, 0.2, (N, 2))
    return dict(u_nom=u_nom, I=I, J=J, coef=coef, b_pair=b,
                lo=np.full((N, 2), -0.5), hi=np.full((N, 2), 0.5)), k


# (fused, ksolve, agent-major rows, tol, warm start)
SPARSE_CASES = {
    "cg agent_k": (False, "cg", True, 0.0, False),
    "cg generic": (False, "cg", False, 0.0, False),
    "fused cg one_pass": (True, "cg", False, 0.0, False),
    "fused chebyshev agent_k": (True, "chebyshev", True, 0.0, False),
    "cg agent_k tol": (False, "cg", True, 1e-5, False),
    "cg agent_k tol warm": (False, "cg", True, 1e-5, True),
    "fused cg agent_k tol warm": (True, "cg", True, 1e-5, True),
    "fused chebyshev one_pass tol warm": (True, "chebyshev", False, 1e-5,
                                          True),
}


def _both(prob, jdt, tdt):
    j = {k: (jnp.asarray(v, jnp.int32) if k in "IJ" else jnp.asarray(v, jdt))
         for k, v in prob.items()}
    t = {k: (torch.as_tensor(v, dtype=torch.int32) if k in "IJ"
             else torch.as_tensor(v, dtype=tdt)) for k, v in prob.items()}
    return j, t


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_sparse_solver_matches_jax(dt, case, request):
    jdt, tdt, atol = _dtypes(dt, request)
    fused, ksolve, agent_major, tol, warm = SPARSE_CASES[case]
    prob, k = _pair_problem()
    kw = dict(iters=60, cg_iters=6, tol=tol, fused=fused, ksolve=ksolve)
    j, t = _both(prob, jdt, tdt)
    agent_k = k if agent_major else None
    j_ws = t_ws = None
    if warm:
        # The warm carry of a solve of a nearby problem, from JAX.
        shifted = dict(j, u_nom=j["u_nom"] * 0.9)
        _, _, j_ws = jsp.solve_pair_box_qp_admm(
            **shifted, settings=jsp.SparseADMMSettings(iters=30),
            agent_k=agent_k, with_state=True)
        t_ws = tuple(torch.as_tensor(np.array(a), dtype=tdt) for a in j_ws)
    u_j, info_j, st_j = jsp.solve_pair_box_qp_admm(
        **j, settings=jsp.SparseADMMSettings(**kw), agent_k=agent_k,
        warm_state=j_ws, with_state=True)
    u_t, info_t, st_t = tsp.solve_pair_box_qp_admm(
        **t, settings=tsp.SparseADMMSettings(**kw), agent_k=agent_k,
        warm_state=t_ws, with_state=True)
    assert int(info_t.iterations) == int(info_j.iterations)
    if tol:
        assert int(info_t.iterations) < 60
    _close(u_t, u_j, atol, "u")
    _close(info_t.primal_residual, info_j.primal_residual, atol, "primal")
    _close(info_t.dual_residual, info_j.dual_residual, atol, "dual")
    assert len(st_t) == 5
    for a, b in zip(st_t, st_j):
        _close(a, b, atol * 100, "carry")


def test_sparse_solver_batched_matches_members_and_jax():
    """The lockstep driver at E=3: equal (fixed budget) to each member's
    own solve, and to JAX's batched driver under the adaptive budget."""
    probs = [_pair_problem(seed=s)[0] for s in (1, 2, 3)]
    k = 6
    stack = {name: np.stack([p[name] for p in probs])
             for name in ("u_nom", "J", "coef", "b_pair", "lo", "hi")}
    I = probs[0]["I"]
    t = {name: torch.as_tensor(v, dtype=torch.int32 if name == "J"
                               else torch.float32)
         for name, v in stack.items()}
    tI = torch.as_tensor(I, dtype=torch.int32)
    fixed = tsp.SparseADMMSettings(iters=40, cg_iters=6)
    u_b, info_b = tsp.solve_pair_box_qp_admm_batched(
        I=tI, settings=fixed, agent_k=k, **t)
    assert info_b.iterations.shape == (3,)
    for e in range(3):
        u_e, info_e = tsp.solve_pair_box_qp_admm(
            t["u_nom"][e], tI, t["J"][e], t["coef"][e], t["b_pair"][e],
            t["lo"][e], t["hi"][e], fixed, agent_k=k)
        _close(u_b[e], u_e.numpy(), 1e-6, f"member {e}")
        _close(info_b.primal_residual[e], info_e.primal_residual.numpy(),
               1e-6)
    adaptive = dict(iters=60, cg_iters=6, tol=1e-5)
    u_j, info_j, st_j = jsp.solve_pair_box_qp_admm_batched(
        I=jnp.asarray(I, jnp.int32),
        settings=jsp.SparseADMMSettings(**adaptive), agent_k=k,
        with_state=True,
        **{name: jnp.asarray(v, jnp.int32 if name == "J" else jnp.float32)
           for name, v in stack.items()})
    u_t, info_t, st_t = tsp.solve_pair_box_qp_admm_batched(
        I=tI, settings=tsp.SparseADMMSettings(**adaptive), agent_k=k,
        with_state=True, **t)
    assert info_t.iterations.tolist() == np.asarray(info_j.iterations).tolist()
    _close(u_t, u_j, 1e-5, "u")
    _close(info_t.primal_residual, info_j.primal_residual, 1e-5)
    assert [a.shape for a in st_t] == [tuple(a.shape) for a in st_j]


def test_sparse_solver_settings_raise_like_jax():
    prob, _ = _pair_problem(N=8, k=2)
    t = _both(prob, jnp.float32, torch.float32)[1]
    with pytest.raises(ValueError, match="fused"):
        tsp.solve_pair_box_qp_admm(
            **t, settings=tsp.SparseADMMSettings(ksolve="chebyshev"))
    with pytest.raises(ValueError, match="ksolve"):
        tsp.solve_pair_box_qp_admm(
            **t, settings=tsp.SparseADMMSettings(ksolve="lu"))
