"""The device steps of the port's streaming k-NN (cbf_tpu_torch.ops.knn,
``knn_stream``) through their plain models in the kernel's own form.

``knn_stream`` splits the columns into S ranges; its scan writes, per row
and range, the k lexicographically smallest (d^2, column) in-radius keys,
the nearest d^2 and the count (``stream_partials_plain``), formed by the
kernel's warps as ``_warp_lists_model`` says (lane l on columns l + 32 t
of each half of the range, per-lane sorted insertion, k warp minima, then
the half merge); its merge folds the ranges in order
(``stream_merge_plain``). Held here on the CPU:

- the two models composed, bit for bit, against
  ``knn_neighbors_blocked_plain`` (the plain version the card compares the
  kernel with) for every plan, one range (S = 1) included;
- ``_warp_lists_model`` against ``stream_partials_plain``, range by range;
- the model path against the JAX package's ``knn_neighbors_blocked`` in
  interpret mode with tests/test_torch_knn.py's tolerance: idx, count and
  mask exact; dist and nearest rtol 1e-6 (XLA:CPU contracts the
  interpret-mode d^2 into an FMA, the port rounds each operation).

Inputs are made with numpy from a seed: spawn grids (0.4 m spacing, the
swarm's jitter), the same packed 8x closer (every row over k), an exact
0.125 m grid in shuffled order (exact ties) and spawns whose odd rows sit
on their even neighbours (coincident points). The CUDA kernel itself is
held equal to ``knn_neighbors_blocked_plain`` on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cbf_tpu.ops import pallas_knn
from cbf_tpu_torch.ops import knn

RADIUS = 0.4
NS = [1, 31, 33, 37, 600]
KS = [1, 8, 16]
# Columns per range; None is one range (S = 1). 40 ends ranges off the
# 32-column steps, 200 leaves a short last range.
COLS = [None, 40, 64, 200]
KINDS = ["spawn", "packed", "ties", "coincident"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The models work on tiny tensors: torch's intra-op pool only spins
    # idle cores that the rest of a parallel test run is timing on.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _grid(n, spacing):
    side = int(np.ceil(np.sqrt(n)))
    ij = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1)
    return ij.reshape(-1, 2)[:n] * spacing


def _positions(kind, n, seed=0):
    rng = np.random.default_rng([n, KINDS.index(kind), seed])
    if kind == "ties":
        x = _grid(n, 0.125)[rng.permutation(n)]
    else:
        x = _grid(n, 0.4) + rng.uniform(-0.1, 0.1, (n, 2))
        if kind == "packed":
            x = x * 0.125
        elif kind == "coincident":
            x[1::2] = x[0:n - 1:2]
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _plan(n, cols):
    cols = n if cols is None else cols
    return cols, -(-n // cols)


def _assert_equal(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_partials_then_merge_equal_blocked_plain(n, k, cols, kind):
    x = _positions(kind, n)
    plan = _plan(n, cols)
    parts = knn.stream_partials_plain(x, RADIUS, k, *plan)
    assert tuple(parts[0].shape) == (n, plan[1], k)
    assert tuple(parts[2].shape) == (n, plan[1])
    want = knn.knn_neighbors_blocked_plain(x, RADIUS, k)
    _assert_equal(knn.stream_merge_plain(*parts), want)
    if kind == "packed" and n >= 31:     # the top-k's overflow branch
        assert bool((want[3] > k).all())
    if kind == "coincident" and n >= 2:  # a collision: nearest 0, not gated
        assert float(want[2][0]) == 0.0
        assert not bool((want[0][0][torch.isfinite(want[1][0])] == 1).any())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_warp_lists_model_equals_partials(n, k, cols, kind):
    x = _positions(kind, n)
    plan = _plan(n, cols)
    parts = knn.stream_partials_plain(x, RADIUS, k, *plan)
    for s, (c0, c1) in enumerate(knn._ranges(n, *plan)):
        _assert_equal(knn._warp_lists_model(x, RADIUS, k, c0, c1),
                      [p[:, s] for p in parts])


def _model_path(x, k, cols):
    plan = _plan(x.shape[0], cols)
    return knn.stream_merge_plain(*knn.stream_partials_plain(
        x, RADIUS, k, *plan))


def _assert_contract(got, want):
    idx_g, dist_g, near_g, cnt_g = got
    idx_w, dist_w, near_w, cnt_w = want
    np.testing.assert_array_equal(idx_g, idx_w)
    np.testing.assert_array_equal(cnt_g, cnt_w)
    np.testing.assert_array_equal(np.isfinite(dist_g), np.isfinite(dist_w))
    fin = np.isfinite(dist_w)
    np.testing.assert_allclose(dist_g[fin], dist_w[fin], rtol=1e-6)
    np.testing.assert_array_equal(np.isfinite(near_g), np.isfinite(near_w))
    near_fin = np.isfinite(near_w)
    np.testing.assert_allclose(near_g[near_fin], near_w[near_fin], rtol=1e-6)


@pytest.mark.parametrize("n,k,cols,kind", [
    *[(n, 8, 64, kind) for n in NS for kind in KINDS],
    (600, 1, None, "spawn"), (600, 16, None, "packed"),
    (600, 1, 40, "ties"), (600, 16, 200, "coincident")])
def test_model_path_matches_jax(n, k, cols, kind):
    x = _positions(kind, n)
    got = [a.numpy() for a in _model_path(x, k, cols)]
    want = [np.asarray(a) for a in pallas_knn.knn_neighbors_blocked(
        jnp.asarray(x.numpy()), RADIUS, k, interpret=True)]
    _assert_contract(got, want)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 150), k=st.integers(1, 16),
       cols=st.integers(1, 160), spacing=st.sampled_from([0.0625, 0.125,
                                                          0.25]),
       seed=st.integers(0, 2**31 - 1))
def test_random_plans_on_tie_heavy_grids(n, k, cols, spacing, seed):
    """Random plans over exact grids with repeated points: every
    (d^2, column) order question is a tie there."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((_grid(n, spacing)[rng.integers(0, n, n)])
                         .astype(np.float32))
    cols = min(cols, n)
    parts = knn.stream_partials_plain(x, RADIUS, k, *_plan(n, cols))
    _assert_equal(knn.stream_merge_plain(*parts),
                  knn.knn_neighbors_blocked_plain(x, RADIUS, k))
    for s, (c0, c1) in enumerate(knn._ranges(n, *_plan(n, cols))):
        _assert_equal(knn._warp_lists_model(x, RADIUS, k, c0, c1),
                      [p[:, s] for p in parts])


@pytest.mark.parametrize("n,cols,splits", [(37, 40, 2), (37, 0, 1),
                                           (600, 64, 9), (600, 64, 11)])
def test_a_plan_that_does_not_split_the_columns_raises(n, cols, splits):
    with pytest.raises(ValueError, match="do not split"):
        knn.stream_partials_plain(torch.zeros((n, 2)), RADIUS, 4, cols,
                                  splits)


def test_ties_keep_the_lower_column_across_ranges():
    """Agent 0 with four equal-distance neighbours spread over three
    ranges and a nearer one in the last: each range's partial is sorted
    by (d^2, column), and the merge keeps the tied ones in column order
    after the nearest."""
    x = torch.tensor([[0.0, 0.0], [0.125, 0.0], [0.0, 0.125], [-0.125, 0.0],
                      [0.0, -0.125], [0.0625, 0.0]])
    parts = knn.stream_partials_plain(x, RADIUS, 4, 2, 3)
    assert parts[1][0].tolist() == [[1, 0, 0, 0], [2, 3, 0, 0],
                                    [5, 4, 0, 0]]
    idx, _, _, count = knn.stream_merge_plain(*parts)
    assert idx[0].tolist() == [5, 1, 2, 3]
    assert int(count[0]) == 5
    np.testing.assert_array_equal(
        idx, knn.knn_neighbors_blocked_plain(x, RADIUS, 4)[0])


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_stream_launch_takes_cuda_tensors_only(device, monkeypatch):
    """knn_stream launches or raises: a tensor off the card is refused
    before any plan or allocation, and no launch is counted."""
    def boom(*_a, **_k):
        raise AssertionError("reached past the device check")

    monkeypatch.setattr(knn, "_library", boom)
    monkeypatch.setattr(knn, "_partials", boom)
    before = dict(knn.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn.knn_stream(torch.zeros((64, 2), device=device), RADIUS, 8)
    assert knn.LAUNCHES == before
