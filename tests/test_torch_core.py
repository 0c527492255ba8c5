"""Parity of the port's dense model, packing and bit helpers
(repro_torch.core) with the JAX reference (repro.core.tm), exact.

Inputs are made with numpy from a seed and handed to both packages;
packed words cross as numpy uint32 (the port holds them as int32 bit
patterns).  Sizes stay small: M <= 8, C <= 16, F <= 48, W <= 4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import tm as jtm
from repro_torch.core import bits, tm

SHAPES = [(3, 6, 20, 2), (5, 10, 33, 3), (8, 16, 48, 4)]  # M, C, F, W


def _model(seed, M, C, F, density=0.1):
    rng = np.random.default_rng(seed)
    acts = rng.random((M, C, 2 * F)) < density
    acts[:, ::3] = False  # all-excluded clauses (inference: output 0)
    return rng, acts


def _states(M, C, F, acts):
    jcfg = jtm.TMConfig(n_classes=M, n_clauses=C, n_features=F)
    tcfg = tm.TMConfig(n_classes=M, n_clauses=C, n_features=F)
    return (
        jcfg, jtm.state_from_actions(jcfg, acts),
        tcfg, tm.state_from_actions(tcfg, torch.from_numpy(acts)),
    )


@pytest.mark.parametrize("M,C,F,W", SHAPES)
def test_literals_and_pack_literals_match(M, C, F, W):
    rng = np.random.default_rng(M)
    x = rng.integers(0, 2, (32 * W, F), dtype=np.uint8)
    np.testing.assert_array_equal(
        tm.literals(torch.from_numpy(x)).numpy(),
        np.asarray(jtm.literals(jnp.asarray(x))),
    )
    packed = tm.pack_literals(torch.from_numpy(x))
    assert packed.dtype == torch.int32 and packed.shape == (2 * F, W)
    np.testing.assert_array_equal(
        bits.to_u32(packed), np.asarray(jtm.pack_literals(jnp.asarray(x)))
    )


@pytest.mark.parametrize("M,C,F,W", SHAPES)
def test_unpack_bits_matches(M, C, F, W):
    words = np.random.default_rng(F).integers(
        0, 2**32, (M, W), dtype=np.uint32
    )
    words[0, 0] = 0xFFFFFFFF  # bit 31 set: the int32 view is negative
    np.testing.assert_array_equal(
        tm.unpack_bits(bits.from_u32(words)).numpy(),
        np.asarray(jtm.unpack_bits(jnp.asarray(words))),
    )


@pytest.mark.parametrize("M,C,F,W", SHAPES)
def test_batch_class_sums_match_with_empty_clauses(M, C, F, W):
    rng, acts = _model(C, M, C, F)
    jcfg, jstate, tcfg, tstate = _states(M, C, F, acts)
    x = rng.integers(0, 2, (32 * W, F), dtype=np.uint8)
    want = np.asarray(jtm.batch_class_sums(jcfg, jstate, jnp.asarray(x)))
    got = tm.batch_class_sums(tcfg, tstate, torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tm.predict(tcfg, tstate, torch.from_numpy(x)).numpy(),
        np.asarray(jtm.predict(jcfg, jstate, jnp.asarray(x))),
    )


@pytest.mark.parametrize("M,C,F,W", SHAPES)
def test_batch_class_sums_weighted_match(M, C, F, W):
    rng, acts = _model(F, M, C, F)
    jcfg, jstate, tcfg, tstate = _states(M, C, F, acts)
    x = rng.integers(0, 2, (32 * W, F), dtype=np.uint8)
    w = rng.integers(1, 9, (M, C)).astype(np.int32)
    want = np.asarray(jtm.batch_class_sums_weighted(
        jcfg, jstate, jnp.asarray(x), jnp.asarray(w)
    ))
    got = tm.batch_class_sums_weighted(
        tcfg, tstate, torch.from_numpy(x), torch.from_numpy(w)
    )
    np.testing.assert_array_equal(got.numpy(), want)
    # no weights is the unweighted oracle
    np.testing.assert_array_equal(
        tm.batch_class_sums_weighted(tcfg, tstate, torch.from_numpy(x)).numpy(),
        tm.batch_class_sums(tcfg, tstate, torch.from_numpy(x)).numpy(),
    )


@pytest.mark.parametrize("M,C,F,W", SHAPES)
def test_packed_class_sums_match(M, C, F, W):
    rng, acts = _model(W, M, C, F)
    jcfg, jstate, tcfg, tstate = _states(M, C, F, acts)
    x = rng.integers(0, 2, (32 * W, F), dtype=np.uint8)
    jpacked = jtm.pack_literals(jnp.asarray(x))
    want = np.asarray(jtm.packed_class_sums(jcfg, jstate, jpacked))
    got = tm.packed_class_sums(tcfg, tstate, tm.pack_literals(torch.from_numpy(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tm.batch_class_sums(tcfg, tstate, torch.from_numpy(x)).numpy()
    )


def test_include_actions_and_states_match():
    _, acts = _model(0, 4, 6, 10)
    jcfg, jstate, tcfg, tstate = _states(4, 6, 10, acts)
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))
    np.testing.assert_array_equal(
        tm.include_actions(tcfg, tstate).numpy(), acts
    )
    np.testing.assert_array_equal(
        tm.clause_polarities(tcfg).numpy(),
        np.asarray(jtm.clause_polarities(jcfg)),
    )


def test_bits_helpers_against_numpy():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    t = bits.from_u32(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(bits.to_u32(t), words)
    want = np.array([bin(int(v)).count("1") for v in words])
    np.testing.assert_array_equal(bits.popcount(t).numpy(), want)
    for s in (0, 1, 7, 16, 31):
        np.testing.assert_array_equal(
            bits.to_u32(bits.lshr(t, s)), words >> np.uint32(s)
        )
    wide = torch.from_numpy(words.astype(np.int64))
    np.testing.assert_array_equal(bits.to_u32(bits.wrap_i32(wide)), words)
