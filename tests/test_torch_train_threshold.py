"""The integer form of the ``tm_train`` kernel's uniform compares, on the
CPU: a uniform drawn from 32 random bits is ``u = (bits >> 9) * 2**-23``
exactly, so ``u < p`` iff ``bits >> 9 < ceil(p * 2**23)``
(``kernels.tm_train.kernel.uniform_threshold``), and iff ``bits <
ceil(p * 2**23) << 9`` below a threshold of 2**23.  Held exactly, for every
``m`` within 2 of each threshold, at every probability the kernel
compares with: each selection probability ``k / 2T`` (float32 division,
as the prologue divides), the feedback probabilities of several
specificities, and random float32 values."""

import numpy as np
import pytest

from repro_torch.core import prng
from repro_torch.core.tm import TMConfig
from repro_torch.core.train import feedback_thresholds
from repro_torch.kernels.tm_train.kernel import uniform_threshold


def _uniform(m):
    """The float32 uniform of mantissa bits ``m``: 1.m minus 1, as the
    reference computes it."""
    return (np.asarray(m, np.uint32) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)


def _probabilities():
    ps = []
    for T in (1, 15, 100):
        ps += [np.float32(k) / np.float32(2 * T) for k in range(2 * T + 1)]
    for s in (1.0, 3.9, 10.0):
        ps += [np.float32(1.0 / s), np.float32((s - 1.0) / s)]
        cfg = TMConfig(2, 2, 2, specificity=s, boost_true_positive=False)
        ps += [np.float32(p) for p in feedback_thresholds(cfg)]
    ps += list(np.random.default_rng(0).random(2000).astype(np.float32))
    ps += [np.float32(0), np.float32(1), np.float32(2**-23), np.float32(1 - 2**-24)]
    return np.array(ps, np.float32)


def test_integer_threshold_equals_the_float_compare():
    ps = _probabilities()
    thr = uniform_threshold(ps).astype(np.int64)
    assert thr.dtype == np.int64 and thr.min() >= 0 and thr.max() <= 1 << 23
    for d in range(-2, 3):
        m = np.clip(thr + d, 0, (1 << 23) - 1)
        want = _uniform(m) < ps
        assert np.array_equal(m < thr, want), d
        # the compare on the raw bits, as the kernel makes it: every word
        # whose top 23 bits are m
        lim = (thr << 9) & 0xFFFFFFFF
        always = thr >= 1 << 23
        for low in (0, 1, 511):
            bits = (m << 9) | low
            assert np.array_equal((bits < lim) | always, want), (d, low)


@pytest.mark.parametrize("seed", [0, 1])
def test_integer_threshold_on_drawn_uniforms(seed):
    """The port's threefry uniforms against their bits: the same decision."""
    k = prng.key(seed)
    u = prng.uniform(k, (4096,)).numpy()
    bits = prng.random_bits(k, (4096,)).numpy().astype(np.int64) & 0xFFFFFFFF
    for p in _probabilities()[::37]:
        t = int(uniform_threshold(p))
        assert np.array_equal(u < p, (bits >> 9) < t)


def test_threshold_edges():
    assert uniform_threshold(np.float32(1.0)) == 1 << 23
    assert uniform_threshold(np.float32(0.0)) == 0
    assert uniform_threshold(np.float32(-0.5)) == 0
    assert uniform_threshold(np.float32(np.nan)) == 0
    assert uniform_threshold(np.float32(3.0)) == 1 << 23
    assert uniform_threshold(np.float32(2**-23)) == 1
    assert uniform_threshold(np.float32(2**-24)) == 1  # u < 2**-24 only for m == 0
    assert uniform_threshold([0.25, 0.5]).tolist() == [1 << 21, 1 << 22]
