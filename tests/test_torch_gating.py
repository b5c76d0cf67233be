"""The port's dense gating path and numerics helpers (cbf_tpu_torch.ops.
pairwise, .rollout.gating, .utils) against the JAX package's.

Tolerances: float64 atol 1e-12 on distances; masks, indices (distinct
distances) and dropped counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.ops import pairwise as jpw
from cbf_tpu.rollout import gating as jgat
from cbf_tpu.utils import math as jmath
from cbf_tpu_torch.ops import pairwise as tpw
from cbf_tpu_torch.rollout import gating as tgat
from cbf_tpu_torch.utils import math as tmath
from cbf_tpu_torch.utils import profiling


def _states(seed, n, spread=1.0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                           rng.normal(0, 0.1, (n, 2))], 1)


def test_pairwise_forms_match_jax(x64):
    a = _states(0, 40)[:, :2]
    b = _states(1, 25)[:, :2]
    for args in ((a,), (a, b)):
        np.testing.assert_allclose(
            tpw.pairwise_distances(*map(torch.as_tensor, args)).numpy(),
            np.asarray(jpw.pairwise_distances(*map(jnp.asarray, args))),
            rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            tpw.pairwise_sq_distances(*map(torch.as_tensor, args)).numpy(),
            np.asarray(jpw.pairwise_sq_distances(*map(jnp.asarray, args))),
            rtol=0, atol=1e-12)
    # Self-distances are exactly 0 with a finite (zero) gradient.
    x = torch.as_tensor(a).requires_grad_(True)
    tpw.pairwise_distances(x).sum().backward()
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("exclude_self", [False, True])
def test_danger_slab_matches_jax(x64, exclude_self):
    s = _states(2, 30, spread=0.5)
    cand = np.concatenate([_states(3, 5, spread=0.5), s])
    excl = np.r_[np.zeros(5, bool), np.ones(30, bool)] if exclude_self \
        else None
    obs_j, mask_j = jgat.danger_slab(
        jnp.asarray(s), jnp.asarray(cand), 0.3,
        None if excl is None else jnp.asarray(excl))
    obs_t, mask_t = tgat.danger_slab(
        torch.as_tensor(s), torch.as_tensor(cand), 0.3,
        None if excl is None else torch.as_tensor(excl))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    if exclude_self:
        assert not mask_t.numpy()[np.arange(30), 5 + np.arange(30)].any()


@pytest.mark.parametrize("n,k,radius", [(50, 4, 0.6), (50, 8, 0.3),
                                        (6, 10, 5.0)])
def test_knn_gating_matches_jax(x64, n, k, radius):
    """Dense top-k gating, including k above the candidate count (clamped)
    and neighbourhoods beyond k (dropped > 0)."""
    s = _states(4, n)
    excl = np.ones(n, bool)
    obs_j, mask_j, drop_j = jgat.knn_gating(
        jnp.asarray(s), jnp.asarray(s), radius, k,
        exclude_self_row=jnp.asarray(excl), with_dropped=True)
    obs_t, mask_t, drop_t = tgat.knn_gating(
        torch.as_tensor(s), torch.as_tensor(s), radius, k,
        exclude_self_row=torch.as_tensor(excl), with_dropped=True)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(drop_t.numpy(), np.asarray(drop_j))
    np.testing.assert_array_equal(obs_t.numpy()[mask_t.numpy()],
                                  np.asarray(obs_j)[np.asarray(mask_j)])
    obs_t2, mask_t2 = tgat.knn_gating(torch.as_tensor(s),
                                      torch.as_tensor(s), radius, k)
    assert mask_t2.shape == (n, min(k, n))


def test_knn_gating_ties_keep_the_lower_index(x64):
    # Four candidates at exactly the same distance: lax.top_k keeps the
    # lowest indices first; the port's stable sort must too.
    s = np.zeros((5, 4))
    s[1:, :2] = [[0.1, 0.0], [0.0, 0.1], [-0.1, 0.0], [0.0, -0.1]]
    excl = np.ones(5, bool)
    obs_j, _ = jgat.knn_gating(jnp.asarray(s), jnp.asarray(s), 0.5, 3,
                               exclude_self_row=jnp.asarray(excl))
    obs_t, _ = tgat.knn_gating(torch.as_tensor(s), torch.as_tensor(s), 0.5,
                               3, exclude_self_row=torch.as_tensor(excl))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    np.testing.assert_array_equal(obs_t.numpy()[0, :, :2], s[1:4, :2])


def test_math_helpers_match_jax(x64):
    x = np.array([[0.0, 0.0], [3.0, 4.0], [1e-6, 0.0], [0.3, -0.1]])
    for lim in (0.2, 10.0):
        np.testing.assert_allclose(
            tmath.l2_cap(torch.as_tensor(x), lim).numpy(),
            np.asarray(jmath.l2_cap(jnp.asarray(x), lim)),
            rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        tmath.safe_norm(torch.as_tensor(x)).numpy(),
        np.asarray(jmath.safe_norm(jnp.asarray(x))), rtol=0, atol=1e-15)
    # Gradients at the zero vector are finite on both sides.
    g_j = jax.grad(lambda v: jnp.sum(jmath.safe_norm(v)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    tmath.safe_norm(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-12)


def test_annotate_shows_in_profiler_trace():
    with torch.profiler.profile() as prof:
        with profiling.annotate("gating"):
            torch.ones(3).sum()
    assert any(ev.name == "gating" for ev in prof.events())
