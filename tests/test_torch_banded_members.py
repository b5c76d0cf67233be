"""The banded k-NN under a member axis (cbf_tpu_torch.ops.knn
``knn_neighbors_banded`` on (B, N, 2) positions and under
``torch.func.vmap``) held to what ``jax.vmap`` makes of the JAX package's
``knn_neighbors_banded`` in interpret mode, and the falsifier on a banded
swarm held to the JAX falsifier's margins, on the CPU.

Tolerances: idx, count and the overflow flags exact; dist and nearest
rtol 1e-6 (XLA:CPU contracts the interpret-mode d^2 into an FMA, the
port rounds each operation — tests/test_torch_knn.py's note); the
falsifier's float32 margins atol 1e-5, tests/test_torch_swarm.py's
float32 bound for whole rollouts. On the CPU the wrapper runs the plain
version; the CUDA member kernels are held equal to it on the card by
chip_smoke.py (phase 15a).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu import verify as JV
from cbf_tpu.ops import pallas_knn
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu_torch import verify as TV
from cbf_tpu_torch.ops import knn
from cbf_tpu_torch.scenarios import swarm as tsw

RADIUS, K = 0.4, 8
DIST_RTOL, MARGIN_ATOL = 1e-6, 1e-5
NAMES = ("idx", "dist", "nearest", "overflow", "count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _members(kind, B=3, n=300, seed=0):
    """(B, n, 2) float32 members from a numpy seed: spawn-like grids of
    different spreads, or (``thin``) one member squeezed into a 1e-3 m band
    so its blocks overflow a one-block window while the others do not."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    ij = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1)
    grid = ij.reshape(-1, 2)[:n].astype(np.float64)
    x = np.stack([(grid - side / 2) * s + rng.uniform(-0.05, 0.05, (n, 2))
                  for s in np.linspace(0.12, 0.4, B)])
    if kind == "thin":
        x[1] = np.stack([rng.uniform(-3, 3, n), rng.uniform(0, 1e-3, n)], 1)
    return x.astype(np.float32)


def _jax_members(x, w):
    return [np.asarray(a) for a in jax.vmap(
        lambda m: pallas_knn.knn_neighbors_banded(
            m, RADIUS, K, window_blocks=w, interpret=True))(jnp.asarray(x))]


@pytest.mark.parametrize("kind,n,w", [("spread", 300, 1), ("spread", 300, 2),
                                      ("thin", 1100, 1)])
def test_members_match_jax_vmap(kind, n, w):
    """N = 300 fits one 512-column window; the thin member of N = 1100
    (three row blocks of 512) overflows its one-block window alone."""
    x = _members(kind, n=n)
    want = _jax_members(x, w)
    got = [a.numpy() for a in knn.knn_neighbors_banded(
        torch.as_tensor(x), RADIUS, K, window_blocks=w)]
    for name, g, j in zip(NAMES, got, want):
        assert g.shape == j.shape, name
        if name in ("dist", "nearest"):
            np.testing.assert_allclose(g, j, rtol=DIST_RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, j, err_msg=name)
    flagged = got[3].any(axis=1)
    if kind == "thin":
        assert flagged.tolist() == [False, True, False]
    else:
        assert not flagged.any()


@pytest.mark.parametrize("kind", ["spread", "thin"])
def test_vmap_and_batch_equal_single_calls(kind):
    """(B, N, 2) input and ``torch.func.vmap`` give each member's single
    call, bit for bit, and vmap reaches the dispatch once for the batch
    (one launch set on the card)."""
    x = torch.as_tensor(_members(kind, B=4, n=700, seed=1))
    batched = knn.knn_neighbors_banded(x, RADIUS, K, window_blocks=1)
    calls = []
    dispatch = knn._banded_dispatch

    def counted(z, *a):
        calls.append(tuple(z.shape))
        return dispatch(z, *a)

    mp = pytest.MonkeyPatch()
    mp.setattr(knn, "_banded_dispatch", counted)
    try:
        mapped = torch.func.vmap(lambda z: knn.knn_neighbors_banded(
            z, RADIUS, K, window_blocks=1))(x)
    finally:
        mp.undo()
    assert calls == [(4, 700, 2)]
    assert bool(batched[3].any()) == (kind == "thin")
    for b in range(4):
        single = knn.knn_neighbors_banded(x[b], RADIUS, K, window_blocks=1)
        for got, vm, want in zip(batched, mapped, single):
            assert torch.equal(got[b], want) and torch.equal(vm[b], want)


def test_gating_banded_under_vmap_equals_single_members():
    """``knn_gating_banded`` (the swarm step's banded gating) vmapped over
    members: each member's slab, mask, nearest, overflow and drops."""
    x = torch.as_tensor(_members("spread", B=3, n=150, seed=2))
    states4 = torch.cat([x, torch.zeros_like(x)], dim=-1)
    mapped = torch.func.vmap(lambda s: knn.knn_gating_banded(
        s, RADIUS, K, window_blocks=1))(states4)
    for b in range(3):
        single = knn.knn_gating_banded(states4[b], RADIUS, K,
                                       window_blocks=1)
        assert all(torch.equal(m[b], s) for m, s in zip(mapped, single))


def test_band_setup_takes_members():
    x = torch.as_tensor(_members("thin", B=2, n=700))
    got = knn.band_setup(x, RADIUS, 1)
    assert got[4] == 1
    for b in range(2):
        want = knn.band_setup(x[b], RADIUS, 1)
        assert all(torch.equal(g[b], w) for g, w in zip(got[:4], want[:4]))


def test_backward_through_the_member_axis_raises():
    x = torch.as_tensor(_members("spread", B=2, n=64)).requires_grad_()
    out = knn.knn_neighbors_banded(x, RADIUS, K, window_blocks=1)
    assert not out[0].requires_grad and out[1].requires_grad
    with pytest.raises(RuntimeError, match="gating='jnp'"):
        out[1][torch.isfinite(out[1])].sum().backward()


def test_falsifier_on_a_banded_swarm_matches_jax():
    """The falsifier's batch on ``gating="banded"`` (the JAX falsifier
    keeps the config's gating outside the gradient engine): the port's
    member-batched evaluation — one banded search per step for the batch
    — against JAX's ``jit(vmap(eval_one))`` on the same deltas."""
    fields = dict(n=64, steps=40, gating="banded")
    aj = JV.make_adapter("swarm", jsw.Config(**fields))
    at = TV.make_adapter("swarm", tsw.Config(**fields), device="cpu")
    deltas = np.random.default_rng(4).normal(0, 0.04, (3, 64, 2)).astype(
        np.float32)
    settings = dict(perturb_norm=0.1)
    want = np.asarray(JV.make_eval_batch(aj, JV.SearchSettings(**settings))(
        jnp.asarray(deltas)))
    calls = []
    dispatch = knn._banded_dispatch

    def counted(z, *a):
        calls.append(tuple(z.shape))
        return dispatch(z, *a)

    mp = pytest.MonkeyPatch()
    mp.setattr(knn, "_banded_dispatch", counted)
    try:
        got = TV.make_eval_batch(at, TV.SearchSettings(**settings))(
            torch.as_tensor(deltas)).numpy()
    finally:
        mp.undo()
    assert calls == [(3, 64, 2)] * fields["steps"]
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=MARGIN_ATOL)
