"""The port's JAX random streams (cbf_tpu_torch/utils/prng.py) held to
``jax.random`` on the CPU: keys, fold_in and the raw bits bit for bit,
uniforms and float64 normals bit for bit, float32 normals within
FLOAT32_NORMAL_ULPS (XLA's float32 log is its own approximation), split,
randint (spans that are not powers of two, empty spans and bounds beyond
the dtype) and bernoulli bit for bit, and the swarm spawn and headings
that draw from them equal to the JAX package's.
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


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_split_bit_equal(seed):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
    kt = prng.fold_in(prng.prng_key(seed), 4)
    for num in (2, 3):
        np.testing.assert_array_equal(prng.split(kt, num).numpy(),
                                      _words(jax.random.split(kj, num)))


# Spans 1, 3, 5, 6 and 7 (MUTATION_OPS has 6; the seed pools are small)
# catch a floor-of-uniform shortcut that power-of-two spans hide; an empty
# span returns minval; the int8/int16 rows cross their dtype's bounds.
RANDINT_CASES = [
    (0, 1, "int32"), (0, 3, "int32"), (0, 5, "int32"), (0, 6, "int32"),
    (0, 7, "int32"), (-3, 4, "int32"), (0, 8, "int32"), (5, 2, "int32"),
    (-2 ** 31, 2 ** 31 - 1, "int32"), (-200, 300, "int8"),
    (-7, 40000, "int16"), (0, 6, "int64"), (0, 2 ** 31 + 10, "int64"),
    (-2 ** 40, 2 ** 40, "int64"), (0, 2 ** 31 + 10, "int16")]


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(16,), (5, 7)])
@pytest.mark.parametrize("lo,hi,dtype", RANDINT_CASES)
def test_randint_bit_equal(seed, shape, lo, hi, dtype):
    """``prng.randint`` equals ``jax.random.randint`` bit for bit; int64
    (and bounds beyond int32) under ``jax_enable_x64``, as JAX needs."""
    wide = dtype == "int64" or abs(lo) > 2 ** 31 or abs(hi) > 2 ** 31
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    kt = prng.fold_in(prng.prng_key(seed), 3)
    with jax.enable_x64(wide):
        want = np.asarray(jax.random.randint(kj, shape, lo, hi,
                                             getattr(jnp, dtype)))
    got = prng.randint(kt, shape, lo, hi, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("x64_on", [False, True])
def test_bernoulli_bit_equal(p, x64_on):
    """``uniform < p`` in p's dtype: float32, or float64 under
    ``jax_enable_x64`` (the port's ``dtype``)."""
    for seed in SEEDS[:4]:
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
        kt = prng.fold_in(prng.prng_key(seed), 5)
        with jax.enable_x64(x64_on):
            want = np.asarray(jax.random.bernoulli(kj, p, (9, 4, 1)))
        got = prng.bernoulli(kt, p, (9, 4, 1),
                             torch.float64 if x64_on else torch.float32)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
