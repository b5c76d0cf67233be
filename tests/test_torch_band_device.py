"""The device-side steps of the port's banded k-NN (cbf_tpu_torch.ops.knn):
the prologue kernel (gather, cast, window search) and the merge that
writes each sorted row straight to its agent, through their plain models
in the kernels' own form.

Each model is held bit for bit against the plain function it replaces
(``band_setup``, ``torch.searchsorted``, ``band_unsort``), and the whole
model path (prologue model, sorted window scan, scatter model) against
the JAX package's ``knn_neighbors_banded`` in interpret mode, with
test_torch_banded.py's tolerances: idx (empty-slot fillers included),
count, overflow and mask exact; dist and nearest rtol 1e-6 (XLA:CPU
contracts the interpret-mode d^2 into an FMA, the port rounds each
operation). The CUDA kernels themselves are held equal to these models'
plain counterparts on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.ops import pallas_knn
from cbf_tpu_torch.ops import knn


def _cloud(n, seed, spread=3.0):
    return np.random.default_rng(seed).uniform(
        -spread, spread, (n, 2)).astype(np.float32)


def _thin(n=1200):
    rng = np.random.default_rng(11)
    return np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(0, 1e-3, n)],
                    1).astype(np.float32)


def _equal_y():
    xs = np.arange(-6, 6, dtype=np.float32) * np.float32(0.1)
    ys = np.array([0.3, 0.0, 0.1, 0.0, 0.3, 0.1], np.float32)
    x = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    return x[np.random.default_rng(3).permutation(len(x))]


def _f64_pairs():
    """y values that differ in float64 but round to one float32."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (300, 2))
    x[::2, 1] = 0.5
    x[1::2, 1] = 0.5 - 1e-12 * np.arange(1, 151)
    return x


# name -> (positions, radius, k, window_blocks)
INPUTS = {
    "cloud-200": (lambda: _cloud(200, 200), 0.4, 4, 1),
    "cloud-600": (lambda: _cloud(600, 600), 0.3, 8, 2),
    "cloud-1100": (lambda: _cloud(1100, 1100), 0.25, 4, 2),
    "packed-700": (lambda: _cloud(700, 700, 1.0), 0.4, 6, 2),
    "thin-band": (_thin, 0.4, 4, 1),
    "equal-y": (_equal_y, 0.25, 8, 1),
    "f64-pairs": (_f64_pairs, 0.4, 6, 1),
    "n-1": (lambda: _cloud(1, 1), 0.4, 4, 1),
    "n-257": (lambda: _cloud(257, 257, 0.5), 0.4, 4, 1),
    "n-513-wide": (lambda: _cloud(513, 513, 0.5), 0.4, 8, 9),
    "pure-padding": (lambda: _cloud(600, 41), 0.4, 4, 1),
}


def _input(name):
    make, radius, k, w = INPUTS[name]
    return torch.from_numpy(make()), radius, k, w


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_prologue_model_equals_band_setup(name):
    x, radius, _, w = _input(name)
    want = knn.band_setup(x, radius, w)
    got = knn.band_prologue_plain(x, radius, w)
    for part, a, b in zip(("order", "xs", "starts", "block_overflow"),
                          got[:4], want[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape, part
        assert torch.equal(a, b), part
    assert got[4] == want[4]
    n = x.shape[0]
    if name == "thin-band":
        assert want[3].any()
    if name == "pure-padding":         # blocks past the rows clamp to the tail
        assert want[2].shape[0] * knn.RTILE - knn.RTILE >= n
        assert int(want[2][-1]) == want[2].shape[0] * knn.RTILE \
            - want[4] * knn.CTILE
    if name == "n-513-wide":           # the window clips to the padded rows
        assert want[4] == knn._band_pad(n) // knn.CTILE


@pytest.mark.parametrize("n,levels,right", [
    (1, 1, False), (1, 1, True), (31, 4, False), (33, 33, True),
    (700, 9, False), (700, 9, True), (4096, 4096, False),
    (4096, 64, True), (5000, 2, False)])
def test_warp_search_model_equals_searchsorted(n, levels, right):
    """The kernel's 32-probe search against torch.searchsorted on sorted
    float32 values with runs of equal values, queries on and between
    them, below the first and above the last."""
    rng = np.random.default_rng(n + levels)
    grid = np.sort(rng.uniform(-1, 1, levels)).astype(np.float32)
    ys = torch.from_numpy(np.sort(rng.choice(grid, n)).astype(np.float32))
    v = torch.from_numpy(np.concatenate([
        grid, grid + np.float32(1e-3), rng.uniform(-1.5, 1.5, 64),
        [-np.inf, np.inf]]).astype(np.float32))
    got = knn._warp_search_model(lambda rows: ys[rows], n, v, right)
    assert torch.equal(got, torch.searchsorted(ys, v, right=right))


@pytest.mark.parametrize("name", ["cloud-600", "packed-700", "thin-band",
                                  "equal-y", "n-1", "pure-padding"])
def test_scatter_model_equals_band_unsort(name):
    """The merge's write-to-order[i] epilogue against the inverse
    permutation and gathers, on the sorted window scan's own results."""
    x, radius, k, w = _input(name)
    order, xs, starts, block_overflow, w = knn.band_setup(x, radius, w)
    sorted_out = knn.knn_banded_sorted_plain(xs, starts, radius, k, w)
    got = knn.band_scatter_plain(order, block_overflow, *sorted_out)
    want = knn.band_unsort(order, block_overflow, *sorted_out)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    empty = ~torch.isfinite(got[1])
    assert bool((got[0][empty] == order[0]).all())


def test_scatter_model_empty_slots_report_order_zero():
    """A row with no neighbour keeps id 0 in sorted order, so every slot
    of it reports order[0] after the scatter, as after band_unsort."""
    n, k = 600, 3
    order = torch.from_numpy(np.random.default_rng(2).permutation(n))
    idx_s = torch.zeros((n, k), dtype=torch.int32)
    dist_s = torch.full((n, k), torch.inf)
    near_s = torch.arange(n, dtype=torch.float32)
    cnt_s = torch.zeros(n, dtype=torch.int32)
    bovf = torch.tensor([True, False, True])
    got = knn.band_scatter_plain(order, bovf, idx_s, dist_s, near_s, cnt_s)
    want = knn.band_unsort(order, bovf, idx_s, dist_s, near_s, cnt_s)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((got[0] == order[0]).all())
    assert torch.equal(got[3][order], bovf[torch.arange(n) // knn.RTILE])


def _model_path(x, radius, k, w):
    order, xs, starts, block_overflow, w = knn.band_prologue_plain(
        x, radius, w)
    return knn.band_scatter_plain(
        order, block_overflow,
        *knn.knn_banded_sorted_plain(xs, starts, radius, k, w))


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


@pytest.mark.parametrize("name", ["cloud-200", "cloud-600", "cloud-1100",
                                  "packed-700", "thin-band", "equal-y",
                                  "n-257", "pure-padding"])
def test_model_path_matches_jax(name):
    x, radius, k, w = _input(name)
    got = [a.numpy() for a in _model_path(x, radius, k, w)]
    want = [np.asarray(a) for a in pallas_knn.knn_neighbors_banded(
        jnp.asarray(x.numpy()), radius, k, window_blocks=w, interpret=True)]
    _assert_banded_contract(got, want)
    if name == "thin-band":
        assert got[3].any()


def test_model_path_matches_jax_float64(x64):
    x, radius, k, w = _input("f64-pairs")
    got = [a.numpy() for a in _model_path(x, radius, k, w)]
    want = [np.asarray(a) for a in pallas_knn.knn_neighbors_banded(
        jnp.asarray(x.numpy(), jnp.float64), radius, k, window_blocks=w,
        interpret=True)]
    _assert_banded_contract(got, [want[0].astype(np.int32), *want[1:]])


@pytest.mark.parametrize("name", ["cloud-600", "packed-700", "thin-band",
                                  "f64-pairs", "n-513-wide"])
def test_model_path_equals_plain_version(name):
    """The models compose to knn_neighbors_banded_plain, bit for bit."""
    x, radius, k, w = _input(name)
    got = _model_path(x, radius, k, w)
    want = knn.knn_neighbors_banded_plain(x, radius, k, window_blocks=w)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_prologue_launch_takes_cuda_tensors_only(device, monkeypatch):
    """band_prologue launches or raises: a tensor off the card is refused
    before any sort, plan or allocation, and no launch is counted."""
    def boom(*_a, **_k):
        raise AssertionError("reached past the device check")

    monkeypatch.setattr(knn, "_library", boom)
    monkeypatch.setattr(torch, "argsort", boom)
    before = dict(knn.LAUNCHES)
    x = torch.zeros((64, 2), device=device)
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn.band_prologue(x, 0.4, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn.knn_banded(x, 0.4, 8, window_blocks=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn.knn_banded_sorted(x, torch.zeros(2, dtype=torch.int32), 0.4, 8,
                              1)
    assert knn.LAUNCHES == before


def test_prologue_checks_dtype_past_the_device():
    class FakeCuda:
        def __init__(self, t):
            self._t = t
            self.device = torch.device("cuda")

        def __getattr__(self, name):
            return getattr(self._t, name)

    for shape, dtype in [((16, 3), torch.float32), ((16, 2), torch.int32)]:
        with pytest.raises(ValueError, match="positions"):
            knn._check_launch("band_prologue",
                              FakeCuda(torch.zeros(shape, dtype=dtype,
                                                   device="meta")),
                              None, knn.MAX_N_BLOCKED,
                              dtypes=(torch.float32, torch.float64))


def test_plan_cache_sits_behind_the_library(monkeypatch):
    """A cached split plan is never served without the library: with no
    build, band_plan and stream_plan raise as before."""
    dev = torch.device("cpu")
    monkeypatch.setitem(knn._plans, ("knn_banded", dev, (4096, 3)), (512, 3))
    monkeypatch.setitem(knn._plans, ("knn_stream", dev, (4096,)), (512, 8))

    def no_build():
        raise RuntimeError("nvcc not found (stub)")

    monkeypatch.setattr(knn, "_library", no_build)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        knn.band_plan(4096, 3, dev)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        knn.stream_plan(4096, dev)


def test_window_blocks_below_one_raises_in_the_model():
    x = torch.zeros((16, 2))
    with pytest.raises(ValueError, match="window_blocks"):
        knn.band_prologue_plain(x, 0.4, 0)
