"""The port's k-NN kernel contract (cbf_tpu_torch.ops.knn) against the JAX
Pallas kernels (cbf_tpu.ops.pallas_knn, interpret mode).

On the CPU the port's wrappers run their plain PyTorch versions; the
CUDA kernels themselves are held against those plain versions on the
card by chip_smoke.py. Tolerances: count, mask and (for distinct
distances) idx exact; dist and nearest within rtol 1e-6 — XLA:CPU
contracts the interpret-mode d^2 into an FMA, the port rounds each
operation (as the CUDA kernels do), so the two differ by <= 1 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.ops import pallas_knn
from cbf_tpu.rollout.gating import knn_gating as jax_knn_gating
from cbf_tpu_torch.ops import knn

CASES = [(100, 4, 0.5), (600, 8, 0.4), (1025, 3, 0.3)]
PORT = {"fused": knn.knn_neighbors_plain,
        "blocked": knn.knn_neighbors_blocked_plain}
JAX = {"fused": pallas_knn.knn_neighbors,
       "blocked": pallas_knn.knn_neighbors_blocked}


def _jax(form, x, radius, k):
    return [np.asarray(a) for a in JAX[form](jnp.asarray(x), radius, k,
                                             interpret=True)]


def _port(form, x, radius, k):
    return [a.numpy() for a in PORT[form](torch.from_numpy(x), radius, k)]


def _assert_contract(got, want):
    idx_g, dist_g, near_g, cnt_g = got
    idx_w, dist_w, near_w, cnt_w = want
    np.testing.assert_array_equal(cnt_g, cnt_w)
    np.testing.assert_array_equal(np.isfinite(dist_g), np.isfinite(dist_w))
    fin = np.isfinite(dist_w)
    np.testing.assert_allclose(dist_g[fin], dist_w[fin], rtol=1e-6)
    np.testing.assert_allclose(near_g, near_w, rtol=1e-6)
    # idx exact on rows whose kept distances are distinct; as sets where a
    # row holds a tie.
    for i in range(idx_w.shape[0]):
        d = dist_w[i][fin[i]]
        if len(np.unique(d)) == len(d):
            np.testing.assert_array_equal(idx_g[i], idx_w[i])
        else:
            assert set(idx_g[i][fin[i]]) == set(idx_w[i][fin[i]])
    # Empty slots report index 0 (the TPU kernels' convention).
    assert not idx_g[~fin].any()


@pytest.mark.parametrize("form", ["fused", "blocked"])
@pytest.mark.parametrize("n,k,radius", CASES)
def test_plain_versions_match_jax_kernels(form, n, k, radius):
    rng = np.random.default_rng(n)
    x = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    _assert_contract(_port(form, x, radius, k), _jax(form, x, radius, k))


@pytest.mark.parametrize("n,k,radius", CASES)
def test_plain_versions_agree_bit_for_bit(n, k, radius):
    """The two plain versions compute one contract with identical
    float32 arithmetic, so their outputs are equal — the same equality
    chip_smoke.py demands of each kernel on the card."""
    rng = np.random.default_rng(n + 1)
    x = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    for a, b in zip(_port("fused", x, radius, k),
                    _port("blocked", x, radius, k)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["fused", "blocked"])
def test_empty_neighborhoods(form):
    x = np.random.default_rng(0).uniform(-100, 100, (32, 2)).astype(
        np.float32)
    idx, dist, nearest, count = _port(form, x, 0.01, 4)
    assert not count.any() and not idx.any()
    assert not np.isfinite(dist).any()
    assert np.isfinite(nearest).all()
    _assert_contract((idx, dist, nearest, count), _jax(form, x, 0.01, 4))


@pytest.mark.parametrize("form", ["fused", "blocked"])
def test_coincident_points_excluded(form):
    # 0 < d drops a coincident pair from gating, but the nearest-any
    # metric must still report 0 (a collision).
    x = np.zeros((4, 2), np.float32)
    x[2:] = 5.0
    got = _port(form, x, 1.0, 2)
    assert not np.isfinite(got[1][:2]).any()
    np.testing.assert_array_equal(got[2][:2], 0.0)
    _assert_contract(got, _jax(form, x, 1.0, 2))


def test_ties_go_to_the_lower_index():
    # Agent 0 at the origin with four neighbours at distance 0.1 (exact
    # ties) and one at 0.05: the kept order is nearest first, then the
    # tied ones by index.
    x = np.array([[0, 0], [0.1, 0], [0, 0.1], [-0.1, 0], [0, -0.1],
                  [0.05, 0]], np.float32)
    for form in ("fused", "blocked"):
        idx, dist, _, count = _port(form, x, 0.5, 4)
        assert idx[0].tolist() == [5, 1, 2, 3]
        assert count[0] == 5
        np.testing.assert_array_equal(idx, _jax(form, x, 0.5, 4)[0])


@pytest.mark.parametrize("kernel", ["auto", "streaming"])
@pytest.mark.parametrize("n,k,radius", [(100, 8, 0.5), (600, 8, 0.4)])
def test_gating_epilogue_and_dropped_match_jax(kernel, n, k, radius):
    rng = np.random.default_rng(7)
    s4 = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                         rng.normal(0, 0.1, (n, 2))], 1).astype(np.float32)
    obs_j, mask_j, near_j, drop_j = (np.asarray(a) for a in
                                     pallas_knn.knn_gating_pallas(
                                         jnp.asarray(s4), radius, k,
                                         interpret=True, kernel=kernel))
    obs_t, mask_t, near_t, drop_t = (a.numpy() for a in
                                     knn.knn_gating_pallas(
                                         torch.from_numpy(s4), radius, k,
                                         kernel=kernel))
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(drop_t, drop_j)
    np.testing.assert_allclose(near_t, near_j, rtol=1e-6)
    np.testing.assert_array_equal(np.where(mask_t[..., None], obs_t, 0),
                                  np.where(mask_j[..., None], obs_j, 0))
    # The kernel contract against the dense sort-based reference path.
    obs_r, mask_r, drop_r = (np.asarray(a) for a in jax_knn_gating(
        jnp.asarray(s4), jnp.asarray(s4), radius, k,
        exclude_self_row=jnp.ones(n, bool), with_dropped=True))
    np.testing.assert_array_equal(mask_t, mask_r)
    np.testing.assert_array_equal(drop_t, drop_r)


def test_dispatch_picks_fused_iff_within_bound(monkeypatch):
    calls = []
    monkeypatch.setattr(knn, "knn_neighbors",
                        lambda x, r, k: calls.append("fused"))
    monkeypatch.setattr(knn, "knn_neighbors_blocked",
                        lambda x, r, k: calls.append("stream"))
    for n, kernel, want in [(knn.MAX_N_FUSED, "auto", "fused"),
                            (knn.MAX_N_FUSED + 1, "auto", "stream"),
                            (16, "auto", "fused"),
                            (16, "streaming", "stream"),
                            (knn.MAX_N_FUSED, "streaming", "stream")]:
        knn._kernel_dispatch(torch.empty((n, 2)), 0.4, 8, kernel=kernel)
        assert calls.pop() == want, (n, kernel)
        assert knn.uses_fused(n, kernel) == (want == "fused")
    assert knn.supported(knn.MAX_N_BLOCKED)
    assert not knn.supported(knn.MAX_N_BLOCKED + 1)


def test_kernel_fused_name_is_rejected():
    x = torch.zeros((16, 4))
    with pytest.raises(ValueError, match="auto|streaming"):
        knn.knn_gating_pallas(x, 0.4, 8, kernel="fused")


@pytest.mark.parametrize("entry,kw", [
    ("knn_neighbors", {}), ("knn_neighbors_blocked", {}),
    ("knn_neighbors_banded", {"window_blocks": 2}),
    ("knn_gating_banded", {"window_blocks": 2})])
def test_non_cpu_tensor_never_falls_back(entry, kw, monkeypatch):
    """Only a CPU tensor may take the plain version: any other device goes
    to the kernel wrapper, which launches or raises."""
    def boom(*_a, **_k):
        raise AssertionError("fell back to the plain version")

    for plain in ("knn_neighbors_plain", "knn_neighbors_blocked_plain",
                  "knn_neighbors_banded_plain"):
        monkeypatch.setattr(knn, plain, boom)
    before = dict(knn.LAUNCHES)
    width = 4 if entry == "knn_gating_banded" else 2
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(knn, entry)(torch.zeros((64, width), device="meta"), 0.4, 8,
                            **kw)
    assert knn.LAUNCHES == before


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No card and no toolkit here: a launch must raise at the build, not
    hand back plain results."""
    monkeypatch.setattr(knn, "_find_nvcc", lambda: None)
    monkeypatch.setattr(knn, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(knn, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        knn.build_library()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        knn._library()
    # The banded window plan asks the same library: no plan without it.
    with pytest.raises(RuntimeError, match="nvcc not found"):
        knn.band_plan(4096, 3, torch.device("cpu"))


@pytest.mark.parametrize("shape,dtype,k,match", [
    ((16, 3), torch.float32, 8, "positions"),
    ((16, 2), torch.float64, 8, "positions"),
    ((16, 2), torch.float32, knn.KNN_MAX_K + 1, "k <="),
    ((16, 2), torch.float32, 0, "k <="),
])
def test_wrapper_checks_inputs(shape, dtype, k, match):
    x = torch.zeros(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn.knn_fused(x, 0.4, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn.knn_banded(x, 0.4, k, window_blocks=2)
    # The same checks past the device one (device check bypassed).
    with pytest.raises(ValueError, match=match):
        knn._check_launch("knn_fused", _FakeCuda(x), k, knn.MAX_N_FUSED)
    # knn_banded's sorted-input launch takes float32 alone; its entry also
    # takes float64 (the sort runs in the input dtype, then the cast).
    with pytest.raises(ValueError, match=match):
        knn._check_launch("knn_banded", _FakeCuda(x), k, knn.MAX_N_BLOCKED)
    if dtype == torch.float64 and match == "positions":
        knn._check_launch("knn_banded", _FakeCuda(x), k, knn.MAX_N_BLOCKED,
                          dtypes=(torch.float32, torch.float64))


class _FakeCuda:
    """A meta tensor that reports a CUDA device, to reach the wrapper's
    shape/dtype/k checks without a card."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_radius_squared_in_float32():
    # r^2 formed in float32 from float32(radius), like _pad_coords.
    r2 = knn._radius_sq(0.4)
    assert r2 == float(np.float32(0.4) * np.float32(0.4))
    assert r2 == float(jnp.asarray(0.4, jnp.float32) ** 2)


@pytest.mark.parametrize("name", ["TILE", "RTILE", "CTILE", "MAX_N_FUSED",
                                  "MAX_N_BLOCKED"])
def test_reference_constants_match_jax(name):
    # Same bounds, so both packages route fused vs streaming alike.
    assert getattr(knn, name) == getattr(pallas_knn, name)
