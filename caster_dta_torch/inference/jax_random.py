"""JAX's threefry2x32 random numbers in numpy: ``PRNGKey(seed)``,
``split(key)``, the random bits, ``uniform`` and ``normal`` in f32, as
``jax.random`` draws them with its default implementation. The explainer
(inference/explain.py) starts its mask logits from these draws, as the JAX
package's does (caster_dta_tpu/inference/explain.py:68-71), so the same
inputs give the same masks without JAX.

The layout is the one of ``jax_threefry_partitionable=True``, JAX's default
since 0.5 (tests/test_torch_jax_random.py pins it against JAX 0.9.0): a draw
of shape S hashes the 64-bit iota over S, split into its high and low words,
with one threefry2x32 call; ``split`` keeps both output words as the new
keys' words and the 32-bit random bits are their xor.

``normal`` is ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
``(nextafter(-1, 0), 1)``. The uniform is bit for bit JAX's. ``erfinv`` is
XLA's f32 polynomial (Giles' two branches on ``w = -log1p(-x * x)``); its
``log1p`` is numpy's, which may differ from XLA's by an ulp, so a normal draw
may differ from JAX's by a few ulps (the test states the bound).
"""
from __future__ import annotations

import math

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's ErfInv32 coefficients, highest degree first (w < 5, else w >= 5)
_ERFINV_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                          1.50140941], np.float32)
_ERFINV_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                          2.83297682], np.float32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the word pairs ``(x1, x2)``
    under ``key`` (uint32 [2]) -> two uint32 arrays of their shape."""
    k1, k2 = (np.asarray(k, _U32) for k in key)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def _hash_iota(key: np.ndarray, shape) -> tuple:
    """threefry2x32 of the 64-bit iota over ``shape`` (high word, low word)."""
    n = math.prod(shape)
    iota = np.arange(n, dtype=np.uint64)
    hi = (iota >> np.uint64(32)).astype(_U32).reshape(shape)
    lo = (iota & np.uint64(0xFFFFFFFF)).astype(_U32).reshape(shape)
    return threefry2x32(key, hi, lo)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key data: the seed's high and low 32
    bits (uint32 [2])."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], _U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> uint32 [num, 2]."""
    bits1, bits2 = _hash_iota(key, (num,))
    return np.stack([bits1, bits2], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    bits1, bits2 = _hash_iota(key, tuple(shape))
    return bits1 ^ bits2


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23 random
    mantissa bits under the exponent of 1.0, minus 1, scaled to the range."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> _U32(9)) | np.float32(1.0).view(_U32)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv``: Giles' polynomial in ``w - 2.5`` for
    ``w = -log1p(-x * x) < 5``, else in ``sqrt(w) - 3``, times ``x``;
    ``+-inf`` at ``+-1``."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        small = w < np.float32(5.0)
        w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
        p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
        for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
            p = np.where(small, a, b) + p * w
        out = p * x
        return np.where(np.abs(x) == 1, x * np.float32(np.inf), out)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)
