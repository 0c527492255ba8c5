"""The port's threefry streams (``repro_torch.core.prng``) against
``jax.random`` on the CPU, bit for bit (tolerance 0): keys, ``fold_in``,
``split``, 32-bit ``bits``, ``uniform``, ``randint`` and
``permutation``, including a batch of keys in the leading dimensions.
The reference draws under ``jax_threefry_partitionable``, JAX's default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import prng

SHAPES = [(), (1,), (7,), (3, 5), (40, 32)]  # (C, 2F) of a small model last


def _words(k):
    return np.asarray(jax.random.key_data(k))


def test_threefry_partitionable_is_the_reference_default():
    k = jax.random.key(0)
    assert jax.config.jax_threefry_partitionable
    assert np.array_equal(_words(jax.random.split(k, 3)[2]),
                          _words(jax.random.fold_in(k, 2)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, -1, 123456789])
def test_key(seed):
    assert np.array_equal(prng.key_data(prng.key(seed)), _words(jax.random.key(seed)))


@pytest.mark.parametrize("data", [0, 1, 5, 0x7E000000, 0x5F5F5F5F, 2**32 - 1])
def test_fold_in(data):
    k = jax.random.key(42)
    want = _words(jax.random.fold_in(k, data))
    assert np.array_equal(prng.key_data(prng.fold_in(prng.key(42), data)), want)
    # a batch of keys on the tensor path gives the same words
    batch = prng.fold_in(prng.split(prng.key(42), 3), data)
    want = _words(jax.vmap(lambda kk: jax.random.fold_in(kk, data))(
        jax.random.split(k, 3)))
    assert np.array_equal(prng.key_data(batch), want)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_split(n):
    assert np.array_equal(prng.key_data(prng.split(prng.key(3), n)),
                          _words(jax.random.split(jax.random.key(3), n)))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform(shape):
    k, kt = jax.random.key(9), prng.key(9)
    bits = np.asarray(jax.random.bits(k, shape, dtype=jnp.uint32))
    assert np.array_equal(prng.random_bits(kt, shape).numpy().astype(np.uint32), bits)
    u = prng.uniform(kt, shape)
    assert u.dtype == torch.float32
    assert np.array_equal(u.numpy(), np.asarray(jax.random.uniform(k, shape)))


def test_uniform_over_a_batch_of_keys():
    ks = jax.random.split(jax.random.key(5), 4)
    want = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (3, 4)))(ks))
    got = prng.uniform(prng.split(prng.key(5), 4), (3, 4))
    assert np.array_equal(got.numpy(), want)


# spans 1, 2, 9 (a power of two and not), one past 2**16 (the multiplier
# wraps in uint32), an empty range (span forced to 1) and a shifted one
@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 2), (0, 9), (0, 1000003), (5, 5), (3, 17)])
@pytest.mark.parametrize("shape", [(), (13,)])
def test_randint(lo, hi, shape):
    k = jax.random.key(21)
    got = prng.randint(prng.key(21), shape, lo, hi)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jax.random.randint(k, shape, lo, hi)))


# n = 1 (no round), 100 (one sort round), 2000 and 5000 (two rounds)
@pytest.mark.parametrize("n", [1, 100, 2000, 5000])
def test_permutation(n):
    want = np.asarray(jax.random.permutation(jax.random.key(13), n))
    assert np.array_equal(prng.permutation(prng.key(13), n).numpy(), want)


def test_keys_cross_between_the_packages():
    k = jax.random.fold_in(jax.random.key(77), 3)
    kt = convert.key_from_numpy(_words(k))
    assert np.array_equal(prng.key_data(prng.fold_in(kt, 9)),
                          _words(jax.random.fold_in(k, 9)))
    back = jax.random.wrap_key_data(prng.key_data(kt))
    assert np.array_equal(_words(back), _words(k))
    with pytest.raises(ValueError, match="two uint32 words"):
        convert.key_from_numpy(np.zeros(3, np.uint32))
