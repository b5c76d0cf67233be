"""The port's Verlet neighbour cache (cbf_tpu_torch.scenarios.swarm with
gating_rebuild_skin > 0: verlet_cache_seed, verlet_gating, the rebuild
search through cbf_tpu_torch.ops.knn.knn_select) against the JAX
package's, and against the port's own exact search.

Anchors (tests/test_gating_truncation.py): below truncation (N=128,
k=16, skin 0.15) the cached run is identical to the exact search; at
packed density the sound floor metric and the dropped count are the
reference's. Float32 only: under x64 the reference's rebuild cond fails
to trace (its dropped count sums to int64 in one branch, int32 in the
other). Tolerances as tests/test_torch_swarm.py states them: min distance
atol 1e-6, x and v atol 1e-5, every count exact; the rebuild cache's
indices equal on the filled slots.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.ops import pallas_knn
from cbf_tpu.rollout import engine as jeng
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu_torch import convert
from cbf_tpu_torch.ops import knn
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import swarm as tsw

COUNTS = ("filter_active_count", "infeasible_count", "gating_dropped_count",
          "max_relax_rounds")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_config(jcfg, **override):
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    fields.update(override)
    return convert.config_from_fields(fields)


def _run_both(jcfg, **port_override):
    s0, jstep = jsw.make(jcfg)
    jf, jo = jeng.rollout(jstep, s0, jcfg.steps)
    tcfg = _port_config(jcfg, **port_override)
    _, tstep = tsw.make(tcfg, device="cpu")
    ts0 = convert.state_from_reference(s0, device="cpu", dtype=tcfg.dtype)
    tf, to = teng.rollout(tstep, ts0, tcfg.steps)
    return jf, jo, tf, to


def _assert_close(jf, jo, tf, to):
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    np.testing.assert_allclose(to.min_pairwise_distance.numpy(),
                               np.asarray(jo.min_pairwise_distance), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tf.v.numpy(), np.asarray(jf.v), rtol=0,
                               atol=1e-5)
    # The cache: build positions, dropped count and k-th distance floor,
    # and the indices on the filled slots (a filler slot points at the
    # search's own tie-break: index 0 from the kernels, the lowest
    # ineligible index from the dense search).
    jidx, jxb, jdrop, jdkth = (np.asarray(a) for a in jf.gating_cache)
    tidx, txb, tdrop, tdkth = (a.numpy() for a in tf.gating_cache)
    assert tidx.dtype == np.int32 and tidx.shape == jidx.shape
    np.testing.assert_allclose(txb, jxb, rtol=0, atol=1e-5)
    assert int(tdrop) == int(jdrop)
    np.testing.assert_allclose(tdkth, jdkth, rtol=0, atol=1e-6)
    d = np.linalg.norm(jxb[:, None, :] - jxb[jidx], axis=-1)
    filled = (d > 0) & (d < 0.4 + 0.15)
    np.testing.assert_array_equal(tidx[filled], jidx[filled])


@pytest.mark.parametrize("gating,port_gating", [("jnp", "jnp"),
                                                ("pallas", "auto")])
def test_verlet_below_truncation_matches_jax(gating, port_gating):
    """N=128, k=16, skin 0.15 (test_gating_truncation.py's regime): the
    dense rebuild against JAX's top_k, the kernel rebuild (plain version)
    against JAX's interpret-mode kernel."""
    jcfg = jsw.Config(n=128, steps=40, k_neighbors=16,
                      gating_rebuild_skin=0.15, gating=gating)
    jf, jo, tf, to = _run_both(jcfg, gating=port_gating)
    _assert_close(jf, jo, tf, to)
    assert int(to.filter_active_count.min()) > 0


@pytest.mark.parametrize("gating", ["jnp", "auto"])
def test_verlet_below_truncation_equals_exact_search(gating):
    """Below truncation the cached selection holds every in-radius pair
    and the mask re-checks the true radius on fresh positions: the run is
    identical to the port's own exact per-step search, the floor equal."""
    base = dict(n=128, steps=40, k_neighbors=16, gating=gating)
    s0, exact = tsw.make(tsw.Config(**base), device="cpu")
    se, cached = tsw.make(tsw.Config(**base, gating_rebuild_skin=0.15),
                          device="cpu")
    fe, oe = teng.rollout(exact, s0, base["steps"])
    fc, oc = teng.rollout(cached, se, base["steps"])
    assert torch.equal(fc.x, fe.x) and torch.equal(fc.v, fe.v)
    assert float(oc.min_pairwise_distance.min()) == float(
        oe.min_pairwise_distance.min())
    assert int(oc.infeasible_count.sum()) == 0
    assert int(oc.gating_dropped_count.sum()) == 0


@pytest.mark.parametrize("gating,port_gating", [("jnp", "jnp"),
                                                ("pallas", "auto")])
def test_verlet_packed_density_matches_jax(gating, port_gating):
    """A packed start (spawn box 0.6 m for 64 agents, k=4): every build
    truncates, so the sound metric's unseen-pair floor and the frozen
    dropped count are live from the first step — both equal JAX's."""
    jcfg = jsw.Config(n=64, steps=30, k_neighbors=4, gating_rebuild_skin=0.1,
                      spawn_half_width_override=0.6, gating=gating)
    jf, jo, tf, to = _run_both(jcfg, gating=port_gating)
    _assert_close(jf, jo, tf, to)
    assert int(to.gating_dropped_count.min()) > 0
    assert np.isfinite(float(tf.gating_cache[3]))   # a truncating build


def test_verlet_cache_seed_and_knob_checks():
    jcfg = jsw.Config(n=10, k_neighbors=16, gating_rebuild_skin=0.1)
    tcfg = _port_config(jcfg)
    for got, want in zip(tsw.verlet_cache_seed(tcfg, device="cpu"),
                         jsw.verlet_cache_seed(jcfg)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    s0 = tsw.initial_state(tcfg, device="cpu")
    assert s0.gating_cache[0].shape == (10, 9)      # k clamped to N - 1
    assert tsw.initial_state(tsw.Config(n=10), device="cpu").gating_cache \
        == ()
    for gating in ("banded", "streaming"):
        with pytest.raises(ValueError):
            jsw.make(jsw.Config(n=16, gating_rebuild_skin=0.1,
                                gating=gating))
        with pytest.raises(ValueError, match="gating_rebuild_skin"):
            tsw.make(tsw.Config(n=16, gating_rebuild_skin=0.1,
                                gating=gating), device="cpu")


def test_knn_select_matches_jax_and_guards_autograd():
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, size=(300, 2)).astype(np.float32)
    for radius, k in ((0.5, 8), (0.3, 3)):
        want = pallas_knn.knn_select(jnp.asarray(x), radius, k, True)
        got = knn.knn_select(torch.as_tensor(x), radius, k)
        filled = np.isfinite(np.asarray(want[1]))
        np.testing.assert_array_equal(np.isfinite(got[1].numpy()), filled)
        np.testing.assert_array_equal(got[0].numpy()[filled],
                                      np.asarray(want[0])[filled])
        np.testing.assert_allclose(got[1].numpy()[filled],
                                   np.asarray(want[1])[filled], rtol=1e-6)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        for a, b in zip(got, knn._kernel_dispatch(torch.as_tensor(x),
                                                  radius, k)):
            assert torch.equal(a, b)
    # Under autograd the selection passes a zero gradient to x (the JAX
    # package's custom_vjp); the raw gating entry raises instead.
    xg = torch.as_tensor(x).requires_grad_()
    idx, dist, near, count = knn.knn_select(xg, 0.5, 8)
    assert not idx.requires_grad and not count.requires_grad
    g, = torch.autograd.grad(torch.sum(torch.where(
        torch.isfinite(dist), dist, 0.0)) + near.sum(), xg)
    assert torch.equal(g, torch.zeros_like(xg))
    s4 = torch.cat([xg, torch.zeros_like(xg)], dim=1)
    with pytest.raises(RuntimeError, match="knn_gating_pallas_diff"):
        knn.knn_gating_pallas(s4, 0.5, 8)
    with torch.no_grad():
        knn.knn_select(xg, 0.5, 8)
