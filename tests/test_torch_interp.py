"""Parity of the port's plan interpreter with the JAX reference, exact.

``tm_interp`` (plain twin on the CPU), its sequential oracle
``tm_interp_ref`` and the entry points ``tm_compressed_class_sums`` and
``pack_interleaved_literals`` are held to the reference's Pallas
``tm_interp`` run in interpret mode, its oracle and the dense
``batch_class_sums``, on the shape grid of the reference's own kernel
tests, with integer equality (tolerance 0: the outputs are integer
sums).  ``test_torch_kernels_cuda.py`` holds the CUDA kernel to the
plain twin on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import TMConfig as JTMConfig
from repro.core import batch_class_sums as jbatch_class_sums
from repro.core.compress import decode_to_plan as jdecode_to_plan
from repro.core.compress import encode as jencode
from repro.kernels.tm_interp.kernel import tm_interp as jtm_interp
from repro.kernels.tm_interp.ops import (
    pack_interleaved_literals as jpack_interleaved,
)
from repro.kernels.tm_interp.ops import plan_to_operands as jplan_to_operands
from repro.kernels.tm_interp.ops import (
    tm_compressed_class_sums as jcompressed_class_sums,
)
from repro.kernels.tm_interp.ref import tm_interp_ref as jtm_interp_ref
from repro_torch.core import compress
from repro_torch.core.bits import from_u32, to_u32
from repro_torch.core.tm import TMConfig
from repro_torch.kernels.tm_interp import (
    clause_ends,
    compressed_operands,
    pack_interleaved_literals,
    plan_to_operands,
    tm_compressed_class_sums,
    tm_interp,
    tm_interp_plain,
    tm_interp_ref,
)
from repro_torch.kernels.tm_interp import kernel as ti_kernel


def _models(seed, M, C, F, zero_class=None):
    """The same include mask encoded by both packages."""
    rng = np.random.default_rng(seed)
    acts = rng.random((M, C, 2 * F)) < 0.08
    if zero_class is not None:
        acts[zero_class] = False
    jcfg = JTMConfig(n_classes=M, n_clauses=C, n_features=F)
    jplan = jdecode_to_plan(jencode(jcfg, acts))
    tplan = compress.decode_to_plan(compress.encode(TMConfig(M, C, F), acts))
    state = np.where(acts, jcfg.n_states + 1, jcfg.n_states).astype(np.int32)
    return rng, jcfg, state, jplan, tplan


# the reference's grid (tests/test_kernels.py), block sizes included
INTERP_GRID = [
    (4, 12, 25, 64, 64, 1),
    (3, 8, 100, 32, 128, 1),
    (6, 20, 60, 128, 256, 2),
    (2, 4, 10, 96, 32, 4),  # word blocking
]


@pytest.mark.parametrize("M,C,F,B,bi,bw", INTERP_GRID)
def test_tm_interp_matches_reference(M, C, F, B, bi, bw):
    rng, jcfg, state, jplan, tplan = _models(M * 100 + F, M, C, F)
    x = rng.integers(0, 2, (B, F)).astype(np.uint8)
    oracle = np.asarray(jbatch_class_sums(jcfg, jnp.asarray(state), jnp.asarray(x)))
    jlits = jpack_interleaved(jnp.asarray(x))
    i_cap = max(bi, -(-tplan.n_includes // bi) * bi)
    jops = jplan_to_operands(jplan, i_cap)
    tops = plan_to_operands(tplan, i_cap)
    for a, b in zip(tops, jops):
        np.testing.assert_array_equal(a, b)
    want = np.asarray(jtm_interp(
        *(jnp.asarray(a) for a in jops), jlits, m_cap=8,
        block_instructions=bi, block_words=bw, interpret=True,
    ))
    np.testing.assert_array_equal(want[:M, :B].T, oracle)
    tlits = pack_interleaved_literals(torch.from_numpy(x))
    np.testing.assert_array_equal(to_u32(tlits), np.asarray(jlits))
    targs = tuple(torch.from_numpy(a) for a in tops) + (tlits,)
    for fn in (tm_interp_plain, tm_interp_ref):
        got = fn(*targs, 8)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tm_interp(*targs, m_cap=8).numpy(), want)


@pytest.mark.parametrize("n_inc,extra", [(256, 0), (250, 13)])
def test_tm_interp_matches_on_bare_operands(n_inc, extra):
    """Raw operands not built from a model: random clause ends, unsorted
    classes, a trailing run of includes that never emits and an
    instruction count that is not a multiple of 32."""
    rng = np.random.default_rng(n_inc + extra)
    L2, W, M = 64, 2, 8
    i_cap = n_inc + extra
    lit_idx = rng.integers(0, L2, i_cap).astype(np.int32)
    last = (rng.random(i_cap) < 0.2).astype(np.int32)
    last[n_inc - 1] = 1
    last[n_inc:] = 0
    pol = np.where(rng.random(i_cap) < 0.5, 1, -1).astype(np.int32)
    cls = rng.integers(0, M, i_cap).astype(np.int32)
    lits = rng.integers(0, 2**32, (L2, W), dtype=np.uint32)
    jargs = tuple(jnp.asarray(a) for a in (lit_idx, last, pol, cls, lits))
    want = np.asarray(jtm_interp(
        *jargs, m_cap=M, block_instructions=64, block_words=1, interpret=True
    ))
    np.testing.assert_array_equal(np.asarray(jtm_interp_ref(*jargs, m_cap=M)), want)
    targs = tuple(torch.from_numpy(a) for a in (lit_idx, last, pol, cls)) + (
        from_u32(lits),
    )
    np.testing.assert_array_equal(tm_interp_plain(*targs, M).numpy(), want)
    np.testing.assert_array_equal(tm_interp_ref(*targs, M).numpy(), want)


@pytest.mark.parametrize("zero_class", [None, 1])
def test_compressed_class_sums_matches_reference(zero_class):
    """Plan -> operands -> tm_compressed_class_sums on a ragged batch,
    against the JAX entry point and the dense oracle; a class with no
    includes has an all-zero row."""
    rng, jcfg, state, jplan, tplan = _models(9, 5, 10, 30, zero_class)
    x = rng.integers(0, 2, (70, 30)).astype(np.uint8)  # 70: not whole words
    oracle = np.asarray(jbatch_class_sums(jcfg, jnp.asarray(state), jnp.asarray(x)))
    want = np.asarray(jcompressed_class_sums(
        jplan, jpack_interleaved(jnp.asarray(x)), m_cap=7, i_cap=333,
        interpret=True,
    ))
    got = tm_compressed_class_sums(
        tplan, pack_interleaved_literals(torch.from_numpy(x)), m_cap=7, i_cap=333
    )
    assert got.shape == (7, 96)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:5, :70].T, oracle)
    assert not got[5:].any()
    if zero_class is not None:
        assert not got[zero_class].any()


def test_class_ids_are_clamped_like_the_reference():
    """The kernel clamps a class id into the bank, as the reference's
    ``clip`` does (the program build refuses such ids beforehand)."""
    lit_idx = np.array([0, 1, 2, 3], np.int32)
    last = np.array([0, 1, 0, 1], np.int32)
    pol = np.array([1, 1, -1, -1], np.int32)
    cls = np.array([0, 9, 0, -4], np.int32)
    lits = np.array([[0xFFFFFFFF], [0xF0F0F0F0], [0xFFFF0000], [0x12345678]], np.uint32)
    jargs = tuple(jnp.asarray(a) for a in (lit_idx, last, pol, cls, lits))
    want = np.asarray(jtm_interp(*jargs, m_cap=3, interpret=True))
    targs = tuple(torch.from_numpy(a) for a in (lit_idx, last, pol, cls)) + (
        from_u32(lits),
    )
    np.testing.assert_array_equal(tm_interp_plain(*targs, 3).numpy(), want)
    np.testing.assert_array_equal(tm_interp_ref(*targs, 3).numpy(), want)
    with pytest.raises(ValueError, match="out of range"):
        plan_to_operands(_models(1, 4, 6, 10)[4], 256, m_cap=2)


def test_tm_interp_checks_operands_and_counts_no_cpu_launch():
    v = torch.zeros(8, dtype=torch.int32)
    lits = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tm_interp(v.long(), v, v, v, lits, m_cap=2)
    with pytest.raises(ValueError, match="equal non-empty"):
        tm_interp(v, v[:7], v, v, lits, m_cap=2)
    with pytest.raises(ValueError, match="m_cap"):
        tm_interp(v, v, v, v, lits, m_cap=0)
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        m = torch.device("meta")
        tm_interp(v.to(m), v.to(m), v.to(m), v.to(m), lits.to(m), m_cap=2)
    before = ti_kernel.launches
    assert not tm_interp(v, v, v, v, lits, m_cap=2).any()  # nothing emits
    assert ti_kernel.launches == before


@pytest.mark.parametrize(
    "bad", ["int64", "2-D", "longer than I_cap", "another device"]
)
def test_tm_interp_checks_the_clause_table(bad):
    """The clause table is held to the operands before anything runs; a
    table the wrapper cannot check without reading the device (its
    values) comes only from ``clause_ends``."""
    v = torch.zeros(8, dtype=torch.int32)
    lits = torch.zeros((4, 1), dtype=torch.int32)
    table = {
        "int64": torch.zeros(2, dtype=torch.int64),
        "2-D": torch.zeros((1, 2), dtype=torch.int32),
        "longer than I_cap": torch.zeros(9, dtype=torch.int32),
        "another device": torch.zeros(2, dtype=torch.int32, device="meta"),
    }[bad]
    with pytest.raises(ValueError, match="clause_end must be"):
        tm_interp(v, v, v, v, lits, m_cap=2, clause_end=table)


def test_compressed_class_sums_builds_the_clause_table_from_last():
    _, _, _, _, tplan = _models(3, 4, 6, 10)
    _, last, _, _ = plan_to_operands(tplan, 200)
    ends = clause_ends(last)
    assert ends.dtype == np.int32
    np.testing.assert_array_equal(ends, np.flatnonzero(last == 1))
    assert ends.size == tplan.n_clauses_total
    assert np.all(np.diff(ends) > 0) and ends[-1] < tplan.n_includes
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 2, (40, 10)))
    lits = pack_interleaved_literals(x.to(torch.uint8))
    ops = [torch.from_numpy(a) for a in plan_to_operands(tplan, 200)]
    np.testing.assert_array_equal(
        tm_compressed_class_sums(tplan, lits, m_cap=4, i_cap=200).numpy(),
        tm_interp(*ops, lits, m_cap=4, clause_end=torch.from_numpy(ends)).numpy(),
    )


def _walk_by_class(lit_idx, cls, pol, lits, ends, m_cap):
    """The CUDA kernel's walk, in numpy: class m scans the clause table
    and sums the clauses whose clamped class ``clip(cls[end])`` is m, each
    the AND of its instruction range (ends[k-1], ends[k]]."""
    l2, w = lits.shape
    sums = np.zeros((m_cap, 32 * w), np.int64)
    for m in range(m_cap):
        for k, end in enumerate(ends):
            if min(max(cls[end], 0), m_cap - 1) != m:
                continue
            acc = np.full(w, 0xFFFFFFFF, np.uint32)
            for t in range(ends[k - 1] + 1 if k else 0, end + 1):
                acc &= lits[min(max(lit_idx[t], 0), l2 - 1)]
            bits = (acc[:, None] >> np.arange(32, dtype=np.uint32)) & 1
            sums[m] += pol[end] * bits.reshape(-1).astype(np.int64)
    return sums


def _bare_operands(seed, i_cap, n_inc, m_lo, m_hi):
    """Random clause ends and a class per clause drawn from [m_lo, m_hi):
    clauses out of class order, ids possibly outside the bank."""
    rng = np.random.default_rng(seed)
    lit_idx = rng.integers(0, 64, i_cap).astype(np.int32)
    last = (rng.random(i_cap) < 0.25).astype(np.int32)
    last[n_inc - 1] = 1
    last[n_inc:] = 0
    clause_of = np.cumsum(last) - last
    n = int(last.sum())
    pol = np.where(rng.random(n + 1) < 0.5, 1, -1).astype(np.int32)[clause_of]
    cls = rng.integers(m_lo, m_hi, n + 1).astype(np.int32)[clause_of]
    lits = rng.integers(0, 2**32, (64, 2), dtype=np.uint32)
    lits[::3] = 0xFFFFFFFF  # some rows all ones, so that clauses fire
    return lit_idx, last, pol, cls, lits


@pytest.mark.parametrize("case", [
    "model", "model with an empty class, m_cap above it",
    "out of class order", "class ids out of range",
])
def test_class_bucketed_walk_gives_the_reference_sums(case):
    """The CUDA kernel's split of the walk, each class summing the clauses
    of ``clause_ends`` whose clamped class is its own, gives the JAX
    Pallas kernel's sums (interpret mode)."""
    m_cap = 8
    if case.startswith("model"):
        zero = 2 if "empty" in case else None
        rng, _, _, jplan, tplan = _models(21, 5, 10, 32, zero_class=zero)
        ops = plan_to_operands(tplan, 448)
        for a, b in zip(ops, jplan_to_operands(jplan, 448)):
            np.testing.assert_array_equal(a, b)
        lit_idx, last, pol, cls = ops
        x = rng.integers(0, 2, (64, 32)).astype(np.uint8)
        lits = to_u32(pack_interleaved_literals(torch.from_numpy(x)))
    else:
        lo, hi = (0, m_cap) if case == "out of class order" else (-3, m_cap + 3)
        lit_idx, last, pol, cls, lits = _bare_operands(5, 320, 300, lo, hi)
    want = np.asarray(jtm_interp(
        *(jnp.asarray(a) for a in (lit_idx, last, pol, cls, lits)),
        m_cap=m_cap, block_instructions=64, block_words=1, interpret=True,
    ))
    ends = clause_ends(last)
    if case == "out of class order":
        assert np.any(np.diff(cls[ends]) < 0)
    got = _walk_by_class(lit_idx, cls, pol, lits, ends, m_cap)
    np.testing.assert_array_equal(got, want)
    assert want.any()
    if "empty" in case:
        assert not want[2].any() and not want[5:].any()


def test_compressed_operands_are_views_of_one_buffer():
    """The entry point's operands and clause table reach the device in
    one copy: five contiguous views of one buffer, equal to the JAX
    operands and ``clause_ends``."""
    _, _, _, jplan, tplan = _models(4, 6, 8, 20, zero_class=3)
    got = compressed_operands(tplan, 384, 9, torch.device("cpu"))
    assert len(got) == 5 and all(t.dtype == torch.int32 for t in got)
    assert len({t.untyped_storage().data_ptr() for t in got}) == 1
    assert all(t.is_contiguous() for t in got)
    for a, b in zip(got[:4], jplan_to_operands(jplan, 384)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(got[4].numpy(), clause_ends(got[1].numpy()))


@pytest.mark.parametrize("limit", ["m_cap", "literal words"])
def test_tm_interp_kernel_wrapper_refuses_sizes_past_its_limits(limit):
    """The kernel's wrapper raises ValueError, before it touches the
    device, for a class bank past grid.y or a literal panel whose byte
    offsets would not fit 32 bits."""
    v = torch.zeros(8, dtype=torch.int32)
    ends = torch.zeros(1, dtype=torch.int32)
    if limit == "m_cap":
        lits, m_cap = torch.zeros((4, 1), dtype=torch.int32), ti_kernel.MAX_M_CAP + 1
    else:  # 2^15 x 2^15 words, a broadcast view: nothing is allocated
        lits, m_cap = torch.zeros((1, 1), dtype=torch.int32).expand(1 << 15, 1 << 15), 2
    with pytest.raises(ValueError, match="tm_interp kernel takes"):
        ti_kernel._tm_interp_cuda(v, v, v, lits, m_cap, ends)
