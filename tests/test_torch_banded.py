"""The port's banded k-NN form (cbf_tpu_torch.ops.knn knn_neighbors_banded,
knn_gating_banded, and the swarm's gating="banded" branch) against the JAX
package's (cbf_tpu.ops.pallas_knn, interpret mode).

On the CPU the port runs the plain version; chip_smoke.py holds the CUDA
kernel ``knn_banded`` equal to it on the card. Tolerances: idx (every
slot, the ``order[0]`` filler of empty slots included), count, overflow
and mask exact; dist and nearest rtol 1e-6 — XLA:CPU contracts the
interpret-mode d^2 into an FMA, the port rounds each operation, so the two
differ by <= 1 ulp. The swarm run keeps test_torch_swarm.py's tolerances:
min distance rtol 1e-6, x and v atol 1e-5, every count exact.
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

# (n, k, radius, window_blocks): the three cases of test_pallas_knn.py's
# banded test, and a packed one where every row holds more than k.
CASES = [(200, 4, 0.4, 1), (600, 8, 0.3, 2), (1100, 4, 0.25, 2)]
PACKED = (700, 6, 0.4, 2)


def _cloud(n, seed, spread=3.0):
    return np.random.default_rng(seed).uniform(
        -spread, spread, (n, 2)).astype(np.float32)


def _jax(x, radius, k, w):
    return [np.asarray(a) for a in pallas_knn.knn_neighbors_banded(
        jnp.asarray(x), radius, k, window_blocks=w, interpret=True)]


def _port(x, radius, k, w):
    return [a.numpy() for a in knn.knn_neighbors_banded(
        torch.from_numpy(x), radius, k, window_blocks=w)]


def _assert_banded_contract(got, want):
    idx_g, dist_g, near_g, ovf_g, cnt_g = got
    idx_w, dist_w, near_w, ovf_w, cnt_w = want
    np.testing.assert_array_equal(idx_g, idx_w)
    np.testing.assert_array_equal(cnt_g, cnt_w)
    np.testing.assert_array_equal(ovf_g, ovf_w)
    np.testing.assert_array_equal(np.isfinite(dist_g), np.isfinite(dist_w))
    fin = np.isfinite(dist_w)
    np.testing.assert_allclose(dist_g[fin], dist_w[fin], rtol=1e-6)
    np.testing.assert_array_equal(np.isfinite(near_g), np.isfinite(near_w))
    near_fin = np.isfinite(near_w)
    np.testing.assert_allclose(near_g[near_fin], near_w[near_fin], rtol=1e-6)
    assert idx_g.dtype == np.int32 and cnt_g.dtype == np.int32
    assert ovf_g.dtype == np.bool_


@pytest.mark.parametrize("n,k,radius,w", CASES + [PACKED])
def test_plain_banded_matches_jax(n, k, radius, w):
    spread = 1.0 if (n, k, radius, w) == PACKED else 3.0
    x = _cloud(n, n, spread)
    got, want = _port(x, radius, k, w), _jax(x, radius, k, w)
    _assert_banded_contract(got, want)
    if spread == 1.0:
        assert (got[4] > k).all()           # every row past the k slots
    else:
        assert not got[3].any()
    # Empty slots report order[0], the agent with the lowest y.
    empty = ~np.isfinite(got[1])
    if empty.any():
        assert (got[0][empty] == np.argmin(x[:, 1])).all()


def test_thin_band_overflow_is_flagged():
    """A y-degenerate cloud in one thin band with a one-block window: the
    flag must be raised (test_pallas_knn.py's overflow case)."""
    rng = np.random.default_rng(11)
    n = 1200
    x = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(0, 1e-3, n)],
                 1).astype(np.float32)
    got, want = _port(x, 0.4, 4, 1), _jax(x, 0.4, 4, 1)
    assert got[3].any()
    _assert_banded_contract(got, want)


def test_equal_y_values_follow_the_stable_sort():
    """Rows on a few exactly shared y values: the stable sort keeps agent
    order inside each y, which decides every sorted index and so the
    neighbour order on exact distance ties."""
    xs = np.arange(-6, 6, dtype=np.float32) * np.float32(0.1)
    ys = np.array([0.3, 0.0, 0.1, 0.0, 0.3, 0.1], np.float32)
    x = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    x = x[np.random.default_rng(3).permutation(len(x))]
    got, want = _port(x, 0.25, 8, 1), _jax(x, 0.25, 8, 1)
    _assert_banded_contract(got, want)
    ties = np.array([len(np.unique(d[np.isfinite(d)]))
                     < np.isfinite(d).sum() for d in got[1]])
    assert ties.sum() > len(x) // 2        # the tie rule is exercised
    order = np.argsort(x[:, 1], kind="stable")
    np.testing.assert_array_equal(
        knn.band_setup(torch.from_numpy(x), 0.25, 1)[0].numpy(), order)


def test_float64_input_sorts_before_the_cast(x64):
    """Two y values that differ in float64 but round to one float32: the
    sort runs in the input dtype, as jnp.argsort does before _pad_coords."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (300, 2))
    x[::2, 1] = 0.5
    x[1::2, 1] = 0.5 - 1e-12 * np.arange(1, 151)
    want = [np.asarray(a) for a in pallas_knn.knn_neighbors_banded(
        jnp.asarray(x, jnp.float64), 0.4, 6, window_blocks=1,
        interpret=True)]
    got = [a.numpy() for a in knn.knn_neighbors_banded(
        torch.from_numpy(x), 0.4, 6, window_blocks=1)]
    _assert_banded_contract(got, [want[0].astype(np.int32), *want[1:]])


def test_window_blocks_below_one_raises():
    x = np.zeros((16, 2), np.float32)
    with pytest.raises(ValueError):
        _jax(x, 0.4, 2, 0)
    with pytest.raises(ValueError, match="window_blocks"):
        _port(x, 0.4, 2, 0)


@pytest.mark.parametrize("n,k,radius,w", CASES)
def test_banded_equals_streaming_on_masked_slots(n, k, radius, w):
    """Without overflow the window holds every in-radius candidate, so
    the banded form equals the streaming one wherever a slot is filled."""
    x = torch.from_numpy(_cloud(n, n + 7))
    idx_b, dist_b, near_b, ovf, cnt_b = knn.knn_neighbors_banded(
        x, radius, k, window_blocks=w)
    idx_s, dist_s, near_s, cnt_s = knn.knn_neighbors_blocked(x, radius, k)
    assert not ovf.any()
    assert torch.equal(cnt_b, cnt_s)
    mask = torch.isfinite(dist_s)
    assert torch.equal(mask, torch.isfinite(dist_b))
    assert torch.equal(idx_b[mask], idx_s[mask])
    assert torch.equal(dist_b[mask], dist_s[mask])
    close = near_s <= radius
    assert torch.equal(near_b[close], near_s[close])


def test_banded_gating_matches_jax():
    rng = np.random.default_rng(9)
    n, k, radius, w = 600, 6, 0.4, 2
    s4 = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                         rng.normal(0, 0.1, (n, 2))], 1).astype(np.float32)
    obs_j, mask_j, near_j, ovf_j, drop_j = (
        np.asarray(a) for a in pallas_knn.knn_gating_banded(
            jnp.asarray(s4), radius, k, window_blocks=w, interpret=True))
    obs_t, mask_t, near_t, ovf_t, drop_t = (
        a.numpy() for a in knn.knn_gating_banded(
            torch.from_numpy(s4), radius, k, window_blocks=w))
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(ovf_t, ovf_j)
    np.testing.assert_array_equal(drop_t, drop_j)
    assert drop_t.sum() > 0
    np.testing.assert_array_equal(obs_t, obs_j)     # fillers included
    np.testing.assert_allclose(near_t, near_j, rtol=1e-6)


@pytest.mark.parametrize("n,safety,want", [(4096, 0.4, 3), (4096, 2.0, 4),
                                            (1000, 0.4, 3)])
def test_window_rule(n, safety, want):
    """The make() window rule (swarm.py:1508-1511): a band of N * 2r /
    (2 * pack radius) sorted rows plus two row blocks, in column blocks,
    plus one — e.g. N=4096 with r=2 m: 914 rows, W = ceil(1426/512) + 1 =
    4. An explicit gating_window_blocks wins."""
    cfg = tsw.Config(n=n, safety_distance=safety)
    assert tsw.banded_window_blocks(cfg) == want
    assert tsw.banded_window_blocks(
        dataclasses.replace(cfg, gating_window_blocks=7)) == 7


def _port_config(jcfg, **override):
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    fields.update(override)
    return convert.config_from_fields(fields)


def test_swarm_banded_path_matches_jax():
    """test_pallas_knn.py's banded swarm config, JAX (interpret mode) and
    the port from the same initial state, step by step."""
    jcfg = jsw.Config(n=640, steps=6, k_neighbors=4, gating="banded",
                      gating_window_blocks=2)
    s0, jstep = jsw.make(jcfg)
    jf, jo = jeng.rollout(jstep, s0, jcfg.steps)
    tcfg = _port_config(jcfg)
    _, tstep = tsw.make(tcfg, device="cpu")
    tf, to = teng.rollout(tstep, convert.state_from_numpy(
        np.asarray(s0.x), np.asarray(s0.v), device="cpu",
        dtype=tcfg.dtype), tcfg.steps)
    for name in ("filter_active_count", "infeasible_count",
                 "gating_dropped_count", "gating_overflow_count",
                 "max_relax_rounds"):
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    assert int(to.filter_active_count.min()) > 0
    np.testing.assert_allclose(to.min_pairwise_distance.numpy(),
                               np.asarray(jo.min_pairwise_distance),
                               rtol=1e-6)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), atol=1e-5)
    np.testing.assert_allclose(tf.v.numpy(), np.asarray(jf.v), atol=1e-5)


def test_banded_and_auto_agree_on_cpu():
    """Same run through gating="banded" (wide window) and "auto": equal
    trajectories, and only the banded run reports an overflow count."""
    cfg = tsw.Config(n=300, steps=5, gating_window_blocks=2)
    state0, step_a = tsw.make(cfg, device="cpu")
    _, step_b = tsw.make(dataclasses.replace(cfg, gating="banded"),
                         device="cpu")
    fa, oa = teng.rollout(step_a, state0, cfg.steps)
    fb, ob = teng.rollout(step_b, state0, cfg.steps)
    assert torch.equal(fa.x, fb.x)
    assert oa.gating_overflow_count == ()
    assert ob.gating_overflow_count.tolist() == [0] * cfg.steps
    assert torch.equal(oa.min_pairwise_distance, ob.min_pairwise_distance)


@pytest.mark.parametrize("gating", ["banded", "streaming"])
def test_rebuild_skin_rejected_before_out_of_slice(gating):
    """JAX rejects a Verlet skin with the banded/streaming backends as a
    ValueError; the port raises that, not OutOfSliceError."""
    kw = dict(n=16, gating=gating, gating_rebuild_skin=0.1)
    with pytest.raises(ValueError, match="gating_rebuild_skin requires"):
        jsw.make(jsw.Config(**kw))
    with pytest.raises(ValueError, match="gating_rebuild_skin requires"):
        tsw.make(tsw.Config(**kw), device="cpu")
