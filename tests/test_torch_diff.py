"""The port's differentiable path held to the JAX package on the CPU:
``knn_select``'s zero-gradient Function and the member axis of the k-NN
entries, ``knn_gating_pallas_diff`` against JAX's interpret-mode twin,
``_solve_K``'s implicit gradient and the sparse certificate's gradient
against JAX's and finite differences, the unrolled QP and the unrolled
swarm step. Same numpy inputs through both packages.

Tolerances: float64 gradients rtol 1e-9 (both packages run the same
operations; summation orders differ); float32 atol 1e-6 as
tests/test_pallas_knn.py holds JAX's two gating paths; finite
differences 5e-3 relative as tests/test_sparse_certificate.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.core import filter as jfil
from cbf_tpu.ops import pallas_knn
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.sim import certificates as jcert
from cbf_tpu.solvers import sparse_admm as jadmm
from cbf_tpu_torch import convert
from cbf_tpu_torch.core import filter as tfil
from cbf_tpu_torch.ops import knn
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.sim import certificates as tcert
from cbf_tpu_torch.solvers import sparse_admm as tadmm

F64_RTOL = 1e-9
F32_ATOL = 1e-6
FD_RTOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close64(got, want):
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=F64_RTOL * scale)


# -- knn_select's Function and the member axis --------------------------------

def test_knn_gating_pallas_diff_gradients_match_jax_twin():
    """After tests/test_pallas_knn.py's interpret-mode gradient test: the
    port's diff twin (its kernels' plain versions on the CPU) gives JAX's
    gradients of a loss over the slab and the gated nearest distance."""
    rng = np.random.default_rng(11)
    N, K, radius = 96, 8, 0.5
    x = rng.uniform(-1.0, 1.0, (N, 2))
    s4 = np.concatenate([x, rng.normal(0, 0.1, (N, 2))], 1).astype(
        np.float32)

    def loss_j(s):
        obs, mask, nearest1, _ = pallas_knn.knn_gating_pallas_diff(
            s, radius, K, interpret=True)
        hinge = jnp.sum(jnp.maximum(0.2 - jnp.minimum(nearest1, radius),
                                    0.0) ** 2)
        return hinge + jnp.sum(jnp.where(mask[..., None], obs, 0.0) ** 2)

    st = torch.tensor(s4, requires_grad=True)
    obs, mask, nearest1, dropped = knn.knn_gating_pallas_diff(st, radius, K)
    loss_t = (torch.sum(torch.clamp(0.2 - torch.clamp(nearest1, max=radius),
                                    min=0.0) ** 2)
              + torch.sum(torch.where(mask[..., None], obs, 0.0) ** 2))
    g_t, = torch.autograd.grad(loss_t, st)
    g_j = jax.grad(loss_j)(jnp.asarray(s4))
    want_loss = float(loss_j(jnp.asarray(s4)))
    assert abs(float(loss_t.detach()) - want_loss) <= 1e-6 * abs(want_loss)
    assert bool(torch.isfinite(g_t).all())
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                               atol=F32_ATOL)
    want = pallas_knn.knn_gating_pallas_diff(jnp.asarray(s4), radius, K,
                                             interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(want[3]))


def test_knn_select_zero_gradient_and_loud_raw_gating():
    x = torch.tensor(np.random.default_rng(2).uniform(-1, 1, (50, 2)),
                     dtype=torch.float32, requires_grad=True)
    idx, dist, near, count = knn.knn_select(x, 0.5, 8)
    assert not idx.requires_grad and not count.requires_grad
    g, = torch.autograd.grad(near.sum() + torch.where(
        torch.isfinite(dist), dist, 0.0).sum(), x)
    assert torch.equal(g, torch.zeros_like(x))
    s4 = torch.cat([x, torch.zeros_like(x)], dim=1)
    with pytest.raises(RuntimeError, match="knn_gating_pallas_diff"):
        knn.knn_gating_pallas(s4, 0.5, 8)
    with torch.no_grad():
        knn.knn_gating_pallas(s4, 0.5, 8)


@pytest.mark.parametrize("kernel", ["auto", "streaming"])
@pytest.mark.parametrize("B,n,k", [(1, 37, 8), (3, 100, 16), (5, 600, 4)])
def test_member_axis_plain_versions_match_single_calls(kernel, B, n, k):
    """The plain versions' member axis (the kernels' (B, N, 2) launch):
    each member equal to its own single call, through the dispatch and
    through ``torch.func.vmap`` of ``knn_select``."""
    rng = np.random.default_rng(B * 1000 + n)
    spread = 0.1 * np.sqrt(n) * rng.uniform(0.3, 1.5, (B, 1, 1))
    x = torch.tensor(rng.uniform(-1, 1, (B, n, 2)) * spread,
                     dtype=torch.float32)
    batched = knn._kernel_dispatch(x, 0.4, k, kernel)
    mapped = torch.func.vmap(lambda z: knn.knn_select(z, 0.4, k, kernel))(x)
    for b in range(B):
        single = knn._kernel_dispatch(x[b], 0.4, k, kernel)
        for got, vm, want in zip(batched, mapped, single):
            assert torch.equal(got[b], want)
            assert torch.equal(vm[b], want)


def test_banded_member_axis_raises():
    """The banded search takes a member axis now — (B, N, 2) or vmapped —
    and what it still raises is a gradient: the JAX package's banded
    kernel has none (its gradient engine forces gating="jnp"), so a
    backward through it, batched or vmapped, raises."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-1, 1, (2, 64, 2)), dtype=torch.float32,
                     requires_grad=True)
    dist = knn.knn_neighbors_banded(x, 0.4, 8, window_blocks=1)[1]
    with pytest.raises(RuntimeError, match="no gradient"):
        torch.autograd.grad(dist[torch.isfinite(dist)].sum(), x)
    dist = torch.func.vmap(lambda z: knn.knn_neighbors_banded(
        z, 0.4, 8, window_blocks=1))(x)[1]
    with pytest.raises(RuntimeError, match="no gradient"):
        torch.autograd.grad(dist[torch.isfinite(dist)].sum(), x)


# -- _solve_K's implicit gradient and the certificate --------------------------

def _pair_problem(N=12, k=3, seed=0):
    rng = np.random.default_rng(seed)
    I = np.repeat(np.arange(N), k)
    J = (I + 1 + rng.integers(0, N - 1, N * k)) % N
    coef = rng.normal(0, 1, (N * k, 2))
    coef[::5] = 0.0                                  # inert padding rows
    b = rng.uniform(-0.2, 0.5, N * k)
    b[::5] = np.inf
    u = rng.normal(0, 0.5, (N, 2))
    return u, I, J, coef, b, -0.6 * np.ones((N, 2)), 0.6 * np.ones((N, 2))


def test_solve_K_gradient_matches_jax_and_fd(x64):
    u, I, J, coef, b, lo, hi = _pair_problem()
    N, k = u.shape[0], 3
    settings = jadmm.SparseADMMSettings(iters=40)

    def loss_j(u_nom, c):
        out, _ = jadmm.solve_pair_box_qp_admm(
            u_nom, jnp.asarray(I, jnp.int32), jnp.asarray(J, jnp.int32), c,
            jnp.asarray(b), jnp.asarray(lo), jnp.asarray(hi), settings,
            agent_k=k)
        return jnp.sum(out * jnp.asarray(np.linspace(-1, 1, 2 * N)
                                         .reshape(N, 2)))

    def loss_t(u_nom, c):
        out, _ = tadmm.solve_pair_box_qp_admm(
            u_nom, torch.as_tensor(I), torch.as_tensor(J), c,
            torch.as_tensor(b), torch.as_tensor(lo), torch.as_tensor(hi),
            tadmm.SparseADMMSettings(iters=40), agent_k=k)
        return torch.sum(out * torch.linspace(-1, 1, 2 * N,
                                              dtype=torch.float64)
                         .reshape(N, 2))

    gj_u, gj_c = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(u),
                                                    jnp.asarray(coef))
    ut = torch.tensor(u, requires_grad=True)
    ct = torch.tensor(coef, requires_grad=True)
    gt_u, gt_c = torch.autograd.grad(loss_t(ut, ct), (ut, ct))
    _close64(gt_u.numpy(), gj_u)
    _close64(gt_c.numpy(), gj_c)
    # Finite differences on one coefficient and one nominal.
    eps = 1e-6
    for arr, g, idx in ((coef, gt_c, (7, 1)), (u, gt_u, (4, 0))):
        up, um = arr.copy(), arr.copy()
        up[idx] += eps
        um[idx] -= eps
        args = (lambda a: (torch.as_tensor(a), torch.as_tensor(coef))) \
            if arr is u else (lambda a: (torch.as_tensor(u),
                                         torch.as_tensor(a)))
        with torch.no_grad():
            fd = (float(loss_t(*args(up))) - float(loss_t(*args(um)))) \
                / (2 * eps)
        assert abs(float(g[idx]) - fd) < FD_RTOL * max(abs(fd), 1.0)


def _cert_inputs(side=6, seed=5):
    rng = np.random.default_rng(seed)
    lin = np.linspace(-0.6, 0.6, side)
    gx, gy = np.meshgrid(lin, lin)
    x = np.stack([gx.ravel(), gy.ravel()]) + rng.uniform(
        -0.03, 0.03, (2, side * side))
    u = rng.normal(0, 0.1, (2, side * side))
    return x, u


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_certificate_gradient_matches_jax_and_fd(backend, x64):
    """The sparse certificate differentiates end to end — its search
    through ``knn_select`` (``neighbor_backend="pallas"``) or the dense
    one — with JAX's gradient (JAX's jnp search) and finite differences."""
    x, u = _cert_inputs()
    arena = (-1.2, 1.2, -1.2, 1.2)
    w = np.linspace(-1, 1, u.size).reshape(u.shape)

    def loss_j(d):
        return jnp.sum(jcert.si_barrier_certificate_sparse(
            d, jnp.asarray(x), k=4, neighbor_backend="jnp",
            arena=arena) * w)

    def loss_t(d):
        return torch.sum(tcert.si_barrier_certificate_sparse(
            d, torch.as_tensor(x), k=4, neighbor_backend=backend,
            arena=arena) * torch.as_tensor(w))

    gj = jax.grad(loss_j)(jnp.asarray(u))
    ut = torch.tensor(u, requires_grad=True)
    gt, = torch.autograd.grad(loss_t(ut), ut)
    assert bool(torch.isfinite(gt).all())
    _close64(gt.numpy(), gj)
    eps = 1e-6
    up, um = u.copy(), u.copy()
    up[1, 10] += eps
    um[1, 10] -= eps
    with torch.no_grad():
        fd = (float(loss_t(torch.as_tensor(up)))
              - float(loss_t(torch.as_tensor(um)))) / (2 * eps)
    assert abs(float(gt[1, 10]) - fd) < FD_RTOL * max(abs(fd), 1.0)


# -- the unrolled QP and step -------------------------------------------------

@pytest.mark.parametrize("rounds", [1, 3])
def test_unrolled_qp_gradients_match_jax(rounds, x64):
    rng = np.random.default_rng(rounds)
    N, K = 24, 6
    states = rng.normal(0, 0.3, (N, 4))
    obs = states[:, None, :] + rng.normal(0, 0.12, (N, K, 4))
    mask = rng.uniform(size=(N, K)) < 0.7
    u0 = rng.normal(0, 0.5, (N, 2))
    f = np.zeros((4, 4))
    g = 0.1 * np.array([[1, 0], [0, 1], [0, 0], [0, 0]], float)
    w = rng.normal(size=(N, 2))

    def loss_j(s, o, v):
        u, _ = jfil.safe_controls(s, o, jnp.asarray(mask), jnp.asarray(f),
                                  jnp.asarray(g), v,
                                  jfil.CBFParams(k=0.3, dmin=0.2),
                                  unroll_relax=rounds)
        return jnp.sum(u * w)

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(states), jnp.asarray(obs), jnp.asarray(u0))
    ts, to, tu = (torch.tensor(a, requires_grad=True)
                  for a in (states, obs, u0))
    u, _ = tfil.safe_controls(ts, to, torch.as_tensor(mask),
                              torch.as_tensor(f), torch.as_tensor(g), tu,
                              tfil.CBFParams(k=0.3, dmin=0.2),
                              unroll_relax=rounds)
    gt = torch.autograd.grad(torch.sum(u * torch.as_tensor(w)),
                             (ts, to, tu))
    for a, b in zip(gt, gj):
        assert bool(torch.isfinite(a).all())
        _close64(a.numpy(), b)


@pytest.mark.parametrize("override", [
    {}, {"dynamics": "unicycle"}])
def test_unrolled_step_gradients_match_jax(override, x64):
    """Two differentiable steps (unroll_relax=2, dense gating) from a
    packed float64 start: positions and their gradient equal JAX's."""
    steps = 2
    jcfg = jsw.Config(n=16, steps=steps, dtype=jnp.float64, gating="jnp",
                      pack_spacing=0.02, spawn_half_width_override=0.3,
                      **override)
    js0, jstep = jsw.make(jcfg, unroll_relax=2)

    def loss_j(x):
        s, tot = js0._replace(x=x), 0.0
        for t in range(steps):
            s, o = jstep(s, t)
            tot = tot + jnp.sum(s.x ** 2) + o.min_pairwise_distance
        return tot

    fields = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    tcfg = convert.config_from_fields({**fields, "dtype": torch.float64})
    _, tstep = tsw.make(tcfg, unroll_relax=2, device="cpu")
    ts0 = convert.state_from_reference(js0, device="cpu",
                                       dtype=torch.float64)
    x = ts0.x.clone().requires_grad_()
    s, tot = ts0._replace(x=x), 0.0
    for t in range(steps):
        s, o = tstep(s, t)
        tot = tot + torch.sum(s.x ** 2) + o.min_pairwise_distance
    gt, = torch.autograd.grad(tot, x)
    lj, gj = jax.value_and_grad(loss_j)(js0.x)
    assert abs(float(tot.detach()) - float(lj)) <= F64_RTOL * abs(float(lj))
    assert bool(torch.isfinite(gt).all())
    _close64(gt.numpy(), gj)
