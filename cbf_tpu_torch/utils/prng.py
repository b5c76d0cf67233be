"""JAX's default random streams, reproduced in PyTorch (counterpart:
``jax.random`` with the threefry2x32 implementation and
``jax_threefry_partitionable`` on, the default since jax 0.5).

The falsifier's engines draw their candidates from ``fold_in``-derived
keys (``cbf_tpu/verify/search.py``), so a campaign is reproducible from
its seed alone. This module gives the port the same streams: a key is a
(2,) int64 tensor holding the two uint32 words of JAX's raw key, and

- :func:`prng_key` is ``jax.random.PRNGKey`` (``threefry_seed``);
- :func:`fold_in` is ``jax.random.fold_in`` (``_threefry_fold_in``);
- :func:`random_bits` is ``_threefry_random_bits_partitionable``: the
  threefry2x32 hash of a flat uint64 counter, split into its high and low
  words;
- :func:`uniform` and :func:`normal` are ``jax.random``'s ``_uniform``
  (mantissa bits under a unit exponent, shifted and scaled) and
  ``_normal_real`` (``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``),
  with XLA's erfinv polynomials (Giles' single- and double-precision
  fits, as the CHLO decomposition evaluates them) and XLA's log1p (a
  Cephes rational below sqrt(2) - 1, ``log(1 + x)`` above).

torch has no full uint32 arithmetic, so every word rides in int64 and is
masked back to 32 bits after each add and shift. The draws are made on
the host CPU — a batch of proposals is a few thousand numbers — and the
caller moves them to the card outside any captured region.

XLA's CPU code contracts each multiply-add of those polynomials (and the
uniform's scale and shift) into one fused multiply-add, which torch's CPU ops do not: :func:`_fma` emulates a
correctly rounded one (Dekker's exact product, then Boldo and Melquiond's
round-to-odd sum). float64's ``log`` is the C library's (``math.log``),
as XLA's CPU code calls it, and every square root is correctly rounded.
So the bits, the uniforms and the float64
normals are JAX's exactly; float32's ``log`` is XLA's own approximation,
which torch's is not, so float32 normals are held to JAX's within a
stated ulp bound (tests/test_torch_prng.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x):
    return x & _MASK


def _rotl(v, r: int):
    return _u32(v << r) | (v >> (32 - r))


def threefry2x32(k1: int, k2: int, x1, x2):
    """The threefry2x32 hash (20 rounds) of counter words ``x1``, ``x2``
    (int64 tensors of uint32 values) under key words ``k1``, ``k2``."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK)
    x = [_u32(x1 + ks[0]), _u32(x2 + ks[1])]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = _u32(x[0] + x[1])
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = _u32(x[0] + ks[(i + 1) % 3])
        x[1] = _u32(x[1] + ks[(i + 2) % 3] + i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64)


def _words(key) -> tuple[int, int]:
    key = torch.as_tensor(key)
    if key.shape != (2,):
        raise ValueError(f"a key is a (2,) tensor of uint32 words, got "
                         f"shape {tuple(key.shape)}")
    k1, k2 = (int(v) & _MASK for v in key.tolist())
    return k1, k2


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    pair ``(0, uint32(data))``."""
    k1, k2 = _words(key)
    y1, y2 = threefry2x32(k1, k2, torch.tensor([0], dtype=torch.int64),
                          torch.tensor([int(data) & _MASK],
                                       dtype=torch.int64))
    return torch.cat([y1, y2])


def random_bits(key, bit_width: int, shape) -> torch.Tensor:
    """``_threefry_random_bits_partitionable`` for 32- and 64-bit words:
    int64 tensor of ``shape`` — uint32 values for 32 bits (the two hash
    words XORed); for 64 bits the words as (hi, lo) int64 pair stacked on
    a trailing axis, since a uint64 does not fit int64."""
    k1, k2 = _words(key)
    shape = tuple(int(s) for s in shape)
    count = torch.arange(math.prod(shape), dtype=torch.int64)
    b1, b2 = threefry2x32(k1, k2, count >> 32, count & _MASK)
    if bit_width == 32:
        return (b1 ^ b2).reshape(shape)
    if bit_width == 64:
        return torch.stack([b1, b2], dim=-1).reshape(shape + (2,))
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _unit_floats(key, shape, dtype):
    """Floats in [1, 2) from the top mantissa bits, minus 1: [0, 1)."""
    if dtype == torch.float32:
        bits = random_bits(key, 32, shape)
        fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
        return fbits.view(torch.float32) - 1.0
    if dtype == torch.float64:
        hl = random_bits(key, 64, shape)
        mant = (hl[..., 0] << 20) | (hl[..., 1] >> 12)
        fbits = mant | 0x3FF0000000000000
        return fbits.view(torch.float64) - 1.0
    raise ValueError(f"dtype must be float32 or float64, got {dtype}")


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0):
    """``jax.random.uniform``: [minval, maxval) in ``dtype`` (float32 or
    float64), every operation in ``dtype`` — the scale and shift one fused
    multiply-add, as XLA's CPU code emits it."""
    lo = torch.tensor(minval, dtype=dtype)
    hi = torch.tensor(maxval, dtype=dtype)
    floats = _unit_floats(key, shape, dtype)
    return torch.maximum(lo, _fma(floats, (hi - lo).expand_as(floats), lo))


# XLA's erfinv (Giles' fits), leading coefficient first. float32: two
# ranges of w = -log1p(-x^2), split at 5.
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
# float64: three ranges, split at 6.25 and 16.
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221),
)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """(p, e) with p + e == a * b exactly (Dekker's split, no FMA)."""
    f = 134217729.0 if a.dtype == torch.float64 else 4097.0
    p = a * b
    ta, tb = f * a, f * b
    ah, bh = ta - (ta - a), tb - (tb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a, b, c):
    """Correctly rounded a * b + c: the exact product's two parts and c
    summed with the low parts rounded to odd, then once to nearest."""
    c = torch.as_tensor(c, dtype=a.dtype).expand_as(a)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    s, e = _two_sum(tl, ul)
    ibits = torch.int64 if s.dtype == torch.float64 else torch.int32
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    odd = torch.where((e != 0) & ((s.view(ibits) & 1) == 0),
                      torch.nextafter(s, toward), s)
    return th + odd


def _horner(coeffs, w):
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, w, c)
    return p


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log(y):
    if y.dtype == torch.float64:
        return torch.tensor([math.log(v) if v > 0 else
                             (-math.inf if v == 0 else math.nan)
                             for v in y.reshape(-1).tolist()],
                            dtype=y.dtype).reshape(y.shape)
    return torch.log(y)


def _sqrt(y):
    """Correctly rounded sqrt (torch's vectorized CPU sqrt can miss by an
    ulp): float32 through float64, float64 through the C library."""
    if y.dtype == torch.float64:
        return torch.tensor([math.sqrt(v) if v >= 0 else math.nan
                             for v in y.reshape(-1).tolist()],
                            dtype=y.dtype).reshape(y.shape)
    return torch.sqrt(y.to(torch.float64)).to(y.dtype)


def log1p(x):
    """XLA's log1p: x - x^2/2 + x^3 P(x)/Q(x) below sqrt(2) - 1 in
    magnitude, ``log(1 + x)`` above."""
    small = torch.abs(x) < 0.41421356237309504880
    x2 = x * x
    rat = (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)) * (x * x2)
    near = x + _fma(torch.full_like(x, -0.5), x2, rat)
    far = _log(torch.where(small, 1.0, x + 1.0))
    return torch.where(small, near, far)


def erfinv(x):
    """XLA's erfinv in the input's dtype (float32 or float64): Horner on
    the range's polynomial in a shifted w, times x; +-inf at +-1."""
    w = -log1p(-x * x)
    if x.dtype == torch.float32:
        lt = w < 5.0
        ws = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
        p = torch.where(lt, _horner(_ERFINV32[0], ws),
                        _horner(_ERFINV32[1], ws))
    elif x.dtype == torch.float64:
        lt6, lt16 = w < 6.25, w < 16.0
        ws = torch.where(lt6, w - 3.125,
                         _sqrt(w) - torch.where(lt16, 3.25, 5.0))
        p = torch.where(lt6, _horner(_ERFINV64[0], ws),
                        torch.where(lt16, _horner(_ERFINV64[1], ws),
                                    _horner(_ERFINV64[2], ws)))
    else:
        raise ValueError(f"erfinv takes float32 or float64, got {x.dtype}")
    return torch.where(torch.abs(x) == 1.0, x * torch.inf, p * x)


def normal(key, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` on the host CPU."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(np_dtype(-1.0), np_dtype(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0)
    return torch.tensor(float(np_dtype(np.sqrt(2))), dtype=dtype) * erfinv(u)
