"""The port's numpy threefry2x32 (caster_dta_torch/inference/jax_random.py)
against ``jax.random`` with its default implementation and the
partitionable layout (``jax_threefry_partitionable=True``, JAX 0.9.0 here).

Tolerances: keys, ``split``, the random bits and the uniform are held bit
for bit. ``normal`` goes through ``erfinv``, whose ``log1p`` is numpy's in
the port and XLA's in JAX: measured at most 3 ulps apart over 5.2M draws
(5.0% of them differ at all), so a normal draw is held within NORMAL_ULPS = 4
ulps, and the explainer's initial logits (0.1 x normal) within 4 ulps too.
"""
import jax
import numpy as np
import pytest

from caster_dta_torch.inference import jax_random as jr

NORMAL_ULPS = 4
SEEDS = (0, 1, 42, 2**31 - 1, 123456789)
SHAPES = ((1,), (2,), (5,), (3, 7), (8, 511), (2, 3, 5), (17, 129))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_partitionable_layout_is_the_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_for_bit(seed):
    key = jr.prng_key(seed)
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(seed)))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(jr.split(key, num),
                                      np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)))
    # a split of a split, as the explainer's keys are drawn
    k_n, k_e = jr.split(key)
    jk_n, jk_e = jax.random.split(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(jr.split(k_e, 3), np.asarray(jax.random.split(jk_e, 3)))
    np.testing.assert_array_equal(k_n, np.asarray(jk_n))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bit_for_bit(shape):
    lo = np.nextafter(np.float32(-1), np.float32(0))
    for seed in SEEDS:
        jkey, key = jax.random.PRNGKey(seed), jr.prng_key(seed)
        np.testing.assert_array_equal(
            jr.random_bits(key, shape), np.asarray(jax.random.bits(jkey, shape, np.uint32)))
        for minval, maxval in ((0.0, 1.0), (lo, 1.0), (-3.0, 2.5)):
            want = np.asarray(jax.random.uniform(jkey, shape, minval=minval, maxval=maxval))
            got = jr.uniform(key, shape, minval, maxval)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES + ((64, 4099),))
def test_normal_within_stated_ulps(shape):
    for seed in SEEDS:
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = jr.normal(jr.prng_key(seed), shape)
        assert got.shape == want.shape and got.dtype == np.float32
        assert _ulps(got, want).max() <= NORMAL_ULPS


def test_erfinv_edges_and_range():
    x = np.linspace(-0.9999999, 0.9999999, 200001).astype(np.float32)
    want = np.asarray(jax.scipy.special.erfinv(x))
    assert _ulps(jr.erfinv_f32(x), want).max() <= NORMAL_ULPS
    edges = np.array([-1.0, 1.0, 0.0], np.float32)
    np.testing.assert_array_equal(jr.erfinv_f32(edges),
                                  np.asarray(jax.scipy.special.erfinv(edges)))


def test_explainer_initial_logits():
    """The draws of caster_dta_tpu/inference/explain.py:68-71 at padded
    [B, N] and [B, E] shapes."""
    k_n, k_e = jr.split(jr.prng_key(0))
    jk_n, jk_e = jax.random.split(jax.random.PRNGKey(0))
    for shape in ((4, 48), (4, 512), (8, 64), (3, 4097)):
        for key, jkey in ((k_n, jk_n), (k_e, jk_e)):
            want = np.asarray(0.1 * jax.random.normal(jkey, shape))
            got = np.float32(0.1) * jr.normal(key, shape)
            assert _ulps(got, want).max() <= NORMAL_ULPS
