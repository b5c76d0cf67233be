"""The port's JAX random streams (cbf_tpu_torch/utils/prng.py) held to
``jax.random`` on the CPU: keys, fold_in and the raw bits bit for bit,
uniforms and float64 normals bit for bit, float32 normals within
FLOAT32_NORMAL_ULPS (XLA's float32 log is its own approximation), and the
swarm spawn and headings that draw from them equal to the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu_torch import convert
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.utils import prng

# float32 normals: measured at most 3 ulps off JAX's over 4 x 200k draws
# (0.45% of draws differ at all), from XLA's float32 log.
FLOAT32_NORMAL_ULPS = 4
SEEDS = [0, 1, 7, 123456789, 2 ** 33 + 5]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _words(key) -> np.ndarray:
    return np.asarray(key, np.uint32).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_bit_equal(seed, x64):
    kj, kt = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert torch.equal(kt, convert.prng_key_from_numpy(np.asarray(kj)))
    for data in (0, 1, 3, 77, 2 ** 31 + 9):
        np.testing.assert_array_equal(
            prng.fold_in(kt, data).numpy(),
            _words(jax.random.fold_in(kj, data)))


@pytest.mark.parametrize("shape", [(1,), (7,), (5, 7), (3, 4, 2)])
def test_random_bits_bit_equal(shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(11), 2)
    kt = prng.fold_in(prng.prng_key(11), 2)
    np.testing.assert_array_equal(
        prng.random_bits(kt, 32, shape).numpy(),
        _words(jax.random.bits(kj, shape, jnp.uint32)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_bit_equal(dtype, x64):
    kj = jax.random.fold_in(jax.random.PRNGKey(5), 9)
    kt = prng.fold_in(prng.prng_key(5), 9)
    for lo, hi in ((0.0, 1.0), (-0.3, 0.7), (-np.pi, np.pi)):
        want = np.asarray(jax.random.uniform(kj, (999, 3), getattr(
            jnp, dtype), lo, hi))
        got = prng.uniform(kt, (999, 3), getattr(torch, dtype), lo, hi)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 42])
def test_normal_float64_bit_equal(seed, x64):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    kt = prng.fold_in(prng.prng_key(seed), 1)
    want = np.asarray(jax.random.normal(kj, (40000,), jnp.float64))
    np.testing.assert_array_equal(
        prng.normal(kt, (40000,), torch.float64).numpy(), want)


@pytest.mark.parametrize("seed", [0, 42])
def test_normal_float32_within_ulp_bound(seed):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    kt = prng.fold_in(prng.prng_key(seed), 1)
    want = np.asarray(jax.random.normal(kj, (40000,), jnp.float32))
    got = prng.normal(kt, (40000,), torch.float32).numpy()
    ulps = (np.abs(got.astype(np.float64) - want)
            / np.spacing(np.abs(want)).astype(np.float64))
    assert ulps.max() <= FLOAT32_NORMAL_ULPS
    assert np.mean(got != want) < 0.01


def test_erfinv_edges_and_fma():
    x = torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float64)
    out = prng.erfinv(x)
    assert out[0] == -np.inf and out[1] == np.inf and out[2] == 0.0
    # The emulated fused multiply-add rounds once: 1 + 2^-53 is lost by a
    # separate multiply and add, kept by the fused form's exact product.
    a = torch.tensor([1.0 + 2.0 ** -30], dtype=torch.float64)
    fused = prng._fma(a, a, -1.0)
    assert float(fused[0]) == 2.0 ** -29 + 2.0 ** -60


@pytest.mark.parametrize("n,seed", [(16, 0), (300, 3), (257, 11)])
def test_spawn_and_headings_match_jax(n, seed):
    jcfg = jsw.Config(n=n, dynamics="unicycle")
    tcfg = tsw.Config(n=n, dynamics="unicycle")
    np.testing.assert_array_equal(
        tsw.spawn_positions(tcfg, seed, device="cpu").numpy(),
        np.asarray(jsw.spawn_positions(jcfg, seed)))
    np.testing.assert_array_equal(
        tsw.heading_spawn(tcfg, seed, device="cpu").numpy(),
        np.asarray(jsw.heading_spawn(jcfg, seed)))
