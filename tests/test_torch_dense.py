"""Parity of the port's dense clause paths with the JAX reference, exact.

``clause_eval`` (bitwise) and ``clause_matmul`` (matrix product), their
oracles and their class-sum entry points are held to the reference's
Pallas kernels run in interpret mode and to its oracles, on the shape
grids of the reference's own kernel tests, with integer equality
(tolerance 0: every output is an integer word or count).  On the CPU the
wrappers run their plain twins; ``test_torch_kernels_cuda.py`` holds the
CUDA kernels to the twins on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import TMConfig as JTMConfig
from repro.core import batch_class_sums as jbatch_class_sums
from repro.core import pack_literals as jpack_literals
from repro.kernels.clause_eval.kernel import clause_eval as jclause_eval
from repro.kernels.clause_eval.ops import tm_dense_class_sums as jdense
from repro.kernels.clause_eval.ref import (
    class_sums_from_clause_words as jclass_sums_from_words,
)
from repro.kernels.clause_eval.ref import clause_eval_ref as jclause_eval_ref
from repro.kernels.clause_matmul.kernel import clause_matmul as jclause_matmul
from repro.kernels.clause_matmul.ops import tm_matmul_class_sums as jmatmul
from repro.kernels.clause_matmul.ref import clause_matmul_ref as jclause_matmul_ref
from repro_torch import convert
from repro_torch.core.bits import from_u32, to_u32
from repro_torch.core.tm import TMConfig, include_actions, literals, pack_literals
from repro_torch.kernels.clause_eval import (
    class_sums_from_clause_words,
    clause_eval,
    clause_eval_plain,
    clause_eval_ref,
    tm_dense_class_sums,
)
from repro_torch.kernels.clause_eval import kernel as ce_kernel
from repro_torch.kernels.clause_matmul import (
    clause_matmul,
    clause_matmul_plain,
    clause_matmul_ref,
    tm_matmul_class_sums,
)
from repro_torch.kernels.clause_matmul import kernel as cm_kernel


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


# the reference's grid (tests/test_kernels.py), block sizes included
CLAUSE_EVAL_GRID = [
    (8, 16, 1, 8, 1),
    (100, 64, 3, 32, 2),
    (256, 128, 8, 64, 4),
    (33, 30, 2, 16, 2),  # non-divisible padding path
    (5, 8, 1, 128, 8),  # block bigger than data
]


@pytest.mark.parametrize("nc,l2,w,bc,bw", CLAUSE_EVAL_GRID)
def test_clause_eval_matches_reference(nc, l2, w, bc, bw):
    rng = np.random.default_rng(nc * 1000 + l2)
    actions = (rng.random((nc, l2)) < 0.15).astype(np.int32)
    actions[nc // 2] = 0  # an empty clause gives 0
    lits = _u32(rng, (l2, w))
    want = np.asarray(jclause_eval(
        jnp.asarray(actions), jnp.asarray(lits),
        block_clauses=bc, block_words=bw, interpret=True,
    ))
    np.testing.assert_array_equal(
        np.asarray(jclause_eval_ref(jnp.asarray(actions), jnp.asarray(lits))),
        want,
    )
    ta, tl = torch.from_numpy(actions), from_u32(lits)
    for fn in (clause_eval, clause_eval_plain, clause_eval_ref):
        got = fn(ta, tl)
        assert got.dtype == torch.int32 and got.shape == (nc, w)
        np.testing.assert_array_equal(to_u32(got), want)
    assert not want[nc // 2].any()


def test_clause_eval_empty_clause_is_zero():
    actions = torch.zeros((4, 16), dtype=torch.int32)
    lits = torch.full((16, 2), -1, dtype=torch.int32)  # all ones
    assert not clause_eval(actions, lits).any()
    assert not clause_eval_ref(actions, lits).any()


def test_clause_eval_plain_chunks_match_one_pass(monkeypatch):
    """The twin's chunked halving gives the same words at any chunk size,
    ragged literal counts included."""
    rng = np.random.default_rng(3)
    actions = torch.from_numpy((rng.random((12, 77)) < 0.3).astype(np.int32))
    lits = from_u32(_u32(rng, (77, 5)))
    want = clause_eval_ref(actions, lits)
    for elements in (1, 60, 600, 1 << 24):
        monkeypatch.setattr(ce_kernel, "_TWIN_ELEMENTS", elements)
        assert torch.equal(clause_eval_plain(actions, lits), want)


def test_class_sums_from_clause_words_matches_reference():
    rng = np.random.default_rng(4)
    words = _u32(rng, (6 * 4, 3))
    pol = np.tile(np.array([1, -1, 1, -1], np.int32), 6)
    want = np.asarray(jclass_sums_from_words(jnp.asarray(words), jnp.asarray(pol), 6))
    got = class_sums_from_clause_words(from_u32(words), torch.from_numpy(pol), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_state(seed, M, C, F, zero_class=None):
    """A reference TA state (numpy) with ~10 % includes and its config."""
    rng = np.random.default_rng(seed)
    jcfg = JTMConfig(n_classes=M, n_clauses=C, n_features=F)
    acts = rng.random((M, C, 2 * F)) < 0.1
    if zero_class is not None:
        acts[zero_class] = False
    state = np.where(acts, jcfg.n_states + 1, jcfg.n_states).astype(np.int32)
    return rng, jcfg, TMConfig(M, C, F), state


@pytest.mark.parametrize("zero_class", [None, 2])
def test_dense_class_sums_full_pipeline(zero_class):
    """JAX TA state -> convert.state_from_numpy -> include_actions ->
    tm_dense_class_sums, against the JAX entry point and the dense
    ``batch_class_sums`` oracle; a zero-include class sums to 0."""
    rng, jcfg, cfg, state = _jax_state(5, 6, 16, 40, zero_class)
    x = rng.integers(0, 2, (96, 40)).astype(np.uint8)
    oracle = np.asarray(jbatch_class_sums(jcfg, jnp.asarray(state), jnp.asarray(x)))
    jacts = jnp.asarray(state > jcfg.n_states).astype(jnp.int32)
    want = np.asarray(jdense(
        jacts, jpack_literals(jnp.asarray(x)), n_classes=6, interpret=True
    ))
    tstate = convert.state_from_numpy(cfg, state, device="cpu")
    got = tm_dense_class_sums(
        include_actions(cfg, tstate), pack_literals(torch.from_numpy(x)),
        n_classes=6,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().T, oracle)
    if zero_class is not None:
        assert not got[zero_class].any()


# the reference's grid (tests/test_kernels.py), block sizes included
CLAUSE_MATMUL_GRID = [
    (8, 16, 32, 8, 16, 8),
    (100, 64, 96, 32, 32, 32),
    (256, 200, 128, 128, 128, 128),
    (33, 30, 40, 16, 16, 16),  # padding on every dim
]


@pytest.mark.parametrize("nc,l2,b,bc,bb,bk", CLAUSE_MATMUL_GRID)
def test_clause_matmul_matches_reference(nc, l2, b, bc, bb, bk):
    rng = np.random.default_rng(nc * 1000 + b)
    actions = (rng.random((nc, l2)) < 0.15).astype(np.int32)
    actions[nc // 3] = 0  # an empty clause never fires
    lits = rng.integers(0, 2, (l2, b)).astype(np.int32)
    want = np.asarray(jclause_matmul(
        jnp.asarray(actions), jnp.asarray(lits),
        block_c=bc, block_b=bb, block_k=bk, interpret=True,
    ))
    np.testing.assert_array_equal(
        np.asarray(jclause_matmul_ref(jnp.asarray(actions), jnp.asarray(lits))),
        want.astype(bool),
    )
    ta, tl = torch.from_numpy(actions), torch.from_numpy(lits)
    for fn in (clause_matmul, clause_matmul_plain):
        got = fn(ta, tl)
        assert got.dtype == torch.int32 and got.shape == (nc, b)
        np.testing.assert_array_equal(got.numpy(), want)
    ref = clause_matmul_ref(ta, tl)
    assert ref.dtype == torch.bool
    np.testing.assert_array_equal(ref.numpy(), want.astype(bool))
    assert not want[nc // 3].any()


@pytest.mark.parametrize("zero_class", [None, 1])
def test_matmul_class_sums_full_pipeline(zero_class):
    """JAX TA state -> convert.state_from_numpy -> include_actions ->
    tm_matmul_class_sums on unpacked interleaved literals [2F, B], against
    the JAX entry point and the dense oracle."""
    rng, jcfg, cfg, state = _jax_state(6, 5, 14, 33, zero_class)
    x = rng.integers(0, 2, (48, 33)).astype(np.uint8)
    oracle = np.asarray(jbatch_class_sums(jcfg, jnp.asarray(state), jnp.asarray(x)))
    lits = np.stack([x, 1 - x], -1).reshape(48, -1).T.astype(np.int32)
    want = np.asarray(jmatmul(
        jnp.asarray(state > jcfg.n_states).astype(jnp.int32), jnp.asarray(lits),
        n_classes=5, interpret=True,
    ))
    tstate = convert.state_from_numpy(cfg, state, device="cpu")
    tlits = literals(torch.from_numpy(x)).T
    np.testing.assert_array_equal(tlits.numpy(), lits)  # the same layout
    got = tm_matmul_class_sums(include_actions(cfg, tstate), tlits, n_classes=5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().T, oracle)
    if zero_class is not None:
        assert not got[zero_class].any()


def test_dense_wrappers_check_operands():
    a = torch.ones((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        clause_eval(a, torch.zeros((8, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="literals"):
        clause_eval(a, torch.zeros((7, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="non-empty"):
        clause_eval(a, torch.zeros((8, 0), dtype=torch.int32))
    with pytest.raises(ValueError, match="literals"):
        clause_matmul(a, torch.zeros((7, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        clause_eval(a.to("meta"), torch.zeros((8, 2), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        clause_matmul(a.to("meta"), torch.zeros((8, 2), dtype=torch.int32, device="meta"))


def test_cpu_tensors_count_no_launch():
    rng = np.random.default_rng(7)
    a = torch.from_numpy((rng.random((10, 16)) < 0.2).astype(np.int32))
    before = (ce_kernel.launches, cm_kernel.launches)
    clause_eval(a, from_u32(_u32(rng, (16, 2))))
    clause_matmul(a, torch.from_numpy(rng.integers(0, 2, (16, 64)).astype(np.int32)))
    assert (ce_kernel.launches, cm_kernel.launches) == before
