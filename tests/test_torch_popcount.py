"""Parity of the port's popcount path with the JAX reference, exact.

The plain twin ``tm_popcount_plain`` and the sequential oracle
``tm_popcount_ref`` are held to the reference's ``tm_popcount_xla`` and
``tm_popcount_ref`` (the Pallas ``tm_popcount`` itself does not run on
this jax), with weight planes, ragged instruction counts and padding; the
program build (``plan_to_popcount_operands``) gives equal arrays and
refuses the same malformed plans.  The CUDA kernel is held to the plain
twin where a card exists (marked ``cuda``; skips itself otherwise).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import compress as jcomp
from repro.core.tm import TMConfig as JTMConfig
from repro.kernels.tm_popcount import kernel as jkernel
from repro.kernels.tm_popcount import ops as jops
from repro.kernels.tm_popcount.ref import tm_popcount_ref as jref
from repro_torch.core import compress
from repro_torch.core.bits import from_u32, segmented_and_scan, to_u32
from repro_torch.core.tm import TMConfig, pack_literals
from repro_torch.kernels.tm_popcount import kernel, ops
from repro_torch.kernels.tm_popcount.ref import tm_popcount_ref


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_bit_transpose32_matches(axis):
    shape = [3, 5, 4]
    shape[axis] = 32
    x = _u32(np.random.default_rng(axis), shape)
    got = kernel.bit_transpose32(from_u32(x), axis)
    np.testing.assert_array_equal(
        to_u32(got), np.asarray(jkernel.bit_transpose32(jnp.asarray(x), axis))
    )
    # an involution: transposing twice gives the input back
    np.testing.assert_array_equal(to_u32(kernel.bit_transpose32(got, axis)), x)


@pytest.mark.parametrize("planes", [None, 1, 3])
def test_popcount_reduce_matches(planes):
    rng = np.random.default_rng(planes or 0)
    emit = _u32(rng, (96, 3))
    emit[rng.random(96) < 0.6] = 0
    lead = () if planes is None else (planes,)
    pos, neg = _u32(rng, lead + (5, 3)), _u32(rng, lead + (5, 3))
    got = kernel.popcount_reduce(from_u32(emit), from_u32(pos), from_u32(neg))
    want = jkernel.popcount_reduce(
        jnp.asarray(emit), jnp.asarray(pos), jnp.asarray(neg)
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _program(seed, M=6, C=12, F=40, weighted=False, zero_class=False):
    rng = np.random.default_rng(seed)
    acts = rng.random((M, C, 2 * F)) < 0.08
    if zero_class:
        acts[2] = False
    w = rng.integers(1, 8, (M, C)) if weighted else None
    jm = jcomp.encode(JTMConfig(M, C, F), acts, w)
    tm_ = compress.encode(TMConfig(M, C, F), acts, w)
    return rng, jm, tm_


# (seed, weighted, weight_planes, i_cap slack, zero class)
PROGRAMS = [
    (0, False, None, 0, False),
    (1, False, None, 13, True),  # ragged I_cap, padding, zero-include class
    (2, True, None, 7, False),  # weighted: auto-sized 3-D masks
    (3, False, 3, 40, False),  # weightless at a pinned plane depth
    (4, True, 4, 1, True),
]


@pytest.mark.parametrize("seed,weighted,planes,slack,zero", PROGRAMS)
def test_plain_and_ref_match_reference(seed, weighted, planes, slack, zero):
    rng, jm, tm_ = _program(seed, weighted=weighted, zero_class=zero)
    jplan, tplan = jcomp.decode_to_plan(jm), compress.decode_to_plan(tm_)
    i_cap = tplan.n_includes + slack
    jops_ = jops.plan_to_popcount_operands(
        jplan, i_cap, 6, l2_cap=80, weight_planes=planes
    )
    tops = ops.plan_to_popcount_operands(
        tplan, i_cap, 6, l2_cap=80, weight_planes=planes
    )
    for a, b in zip(tops, jops_):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    x = rng.integers(0, 2, (96, 40), dtype=np.uint8)
    packed = pack_literals(torch.from_numpy(x))
    li, last, mp, mn = tops
    targs = (
        torch.from_numpy(li), torch.from_numpy(last),
        from_u32(mp), from_u32(mn), packed,
    )
    jargs = tuple(jnp.asarray(a) for a in jops_) + (jnp.asarray(to_u32(packed)),)
    want = np.asarray(jkernel.tm_popcount_xla(*jargs))
    np.testing.assert_array_equal(kernel.tm_popcount_plain(*targs).numpy(), want)
    np.testing.assert_array_equal(tm_popcount_ref(*targs).numpy(), want)
    # the wrapper on CPU tensors is the plain twin
    program = kernel.popcount_program(*targs[:4])
    np.testing.assert_array_equal(kernel.tm_popcount(program, packed).numpy(), want)
    if mp.ndim == 2:  # the reference oracle takes 2-D masks only
        np.testing.assert_array_equal(np.asarray(jref(*jargs)), want)
    if zero:
        assert not want[2].any()


@pytest.mark.parametrize("seed", [5, 6])
def test_plain_matches_on_bare_operands(seed):
    """Random operands not built from a model: arbitrary clause ends and
    trailing includes that never emit; masks with fewer chunks than the
    instruction count needs are padded with zeros, as the reference's
    ``tm_popcount_xla`` pads them."""
    rng = np.random.default_rng(seed)
    i_cap, l2, w = 77, 20, 2
    lit_idx = rng.integers(0, l2, i_cap).astype(np.int32)
    last = (rng.random(i_cap) < 0.3).astype(np.int32)
    last[-5:] = 0
    pos, neg = _u32(rng, (4, 3)), _u32(rng, (4, 3))
    lits = _u32(rng, (l2, w))
    want = np.asarray(jkernel.tm_popcount_xla(
        jnp.asarray(lit_idx), jnp.asarray(last), jnp.asarray(pos),
        jnp.asarray(neg), jnp.asarray(lits),
    ))
    targs = (
        torch.from_numpy(lit_idx), torch.from_numpy(last),
        from_u32(pos), from_u32(neg), from_u32(lits),
    )
    np.testing.assert_array_equal(kernel.tm_popcount_plain(*targs).numpy(), want)
    np.testing.assert_array_equal(tm_popcount_ref(*targs).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jref(*(
        jnp.asarray(a) for a in (lit_idx, last, pos, neg, lits)
    ))), want)
    short = np.ascontiguousarray(pos[:, :2]), np.ascontiguousarray(neg[:, :2])
    want = np.asarray(jkernel.tm_popcount_xla(
        jnp.asarray(lit_idx), jnp.asarray(last), *map(jnp.asarray, short),
        jnp.asarray(lits),
    ))
    targs = targs[:2] + tuple(map(from_u32, short)) + targs[4:]
    np.testing.assert_array_equal(kernel.tm_popcount_plain(*targs).numpy(), want)
    np.testing.assert_array_equal(tm_popcount_ref(*targs).numpy(), want)


def test_class_sums_entry_matches_reference():
    rng, jm, tm_ = _program(7, weighted=True)
    x = rng.integers(0, 2, (64, 40), dtype=np.uint8)
    packed = pack_literals(torch.from_numpy(x))
    got = ops.tm_popcount_class_sums(
        compress.decode_to_plan(tm_), packed, m_cap=8, i_cap=512
    )
    want = jops.tm_popcount_class_sums(
        jcomp.decode_to_plan(jm), jnp.asarray(to_u32(packed)),
        m_cap=8, i_cap=512, implementation="xla",
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_malformed_plans_raise_the_same():
    _, jm, tm_ = _program(8, weighted=True)
    jplan, tplan = jcomp.decode_to_plan(jm), compress.decode_to_plan(tm_)
    cases = [
        dict(m_cap=3),  # class id outside the accumulator bank
        dict(l2_cap=10),  # literal slot outside the feature memory
        dict(weight_planes=1),  # a weight needs more planes
    ]
    for case in cases:
        kw = dict(m_cap=6, l2_cap=80, weight_planes=None)
        kw.update(case)
        m_cap = kw.pop("m_cap")
        with pytest.raises(ValueError) as te:
            ops.plan_to_popcount_operands(tplan, 512, m_cap, **kw)
        with pytest.raises(ValueError) as je:
            jops.plan_to_popcount_operands(jplan, 512, m_cap, **kw)
        assert str(te.value) == str(je.value)


def test_clause_ends_cover_every_emitting_include():
    _, _, tm_ = _program(9)
    li, last, _, _ = ops.plan_to_popcount_operands(
        compress.decode_to_plan(tm_), 512, 6
    )
    ends = ops.clause_ends(last)
    assert ends.dtype == np.int32
    np.testing.assert_array_equal(ends, np.flatnonzero(last == 1))
    assert ends[-1] == compress.decode_to_plan(tm_).n_includes - 1


def test_wrapper_checks_operands():
    _, _, tm_ = _program(10)
    li, last, mp, mn = ops.plan_to_popcount_operands(
        compress.decode_to_plan(tm_), 512, 6
    )
    args = [torch.from_numpy(li), torch.from_numpy(last), from_u32(mp),
            from_u32(mn)]
    bad_dtype = list(args)
    bad_dtype[0] = bad_dtype[0].long()
    with pytest.raises(TypeError, match="int32"):
        kernel.popcount_program(*bad_dtype)
    bad_masks = list(args)
    bad_masks[2] = bad_masks[3] = torch.zeros((6, 50), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        kernel.popcount_program(*bad_masks)
    program = kernel.popcount_program(*args)
    with pytest.raises(ValueError, match="packed_lits"):
        kernel.tm_popcount(program, torch.zeros((80,), dtype=torch.int32))


def _clause_space_sums(li, last, mp, mn, packed, n_chunks=None):
    """The kernel's two steps in plain PyTorch: compact clause words (the
    AND scan read at each clause's last instruction), then the popcount
    reduction against the masks gathered into clause space."""
    ends = torch.from_numpy(ops.clause_ends(last.numpy()))
    cpos, cneg = kernel.clause_space_masks(mp, mn, ends, n_chunks)
    emit = last == 1
    start = torch.cat([emit.new_ones(1), emit[:-1]])
    words = segmented_and_scan(packed[li.long()], start)[ends.long()]
    words = torch.nn.functional.pad(
        words, (0, 0, 0, 32 * cpos.shape[-1] - words.shape[0])
    )
    return kernel.popcount_reduce(words, cpos, cneg), cpos


@pytest.mark.parametrize("seed,weighted,planes,slack,zero", PROGRAMS)
@pytest.mark.parametrize("malformed", [False, True])
def test_clause_space_masks_give_the_reference_sums(
    seed, weighted, planes, slack, zero, malformed
):
    """The reference's instruction-space masks, gathered into clause
    space, reduce the compact clause words to the sums of its
    ``tm_popcount_xla``; also for a malformed mask that selects one
    instruction for two classes and one that selects an instruction no
    clause ends on, and at a capacity-padded width."""
    rng, jm, _ = _program(seed, weighted=weighted, zero_class=zero)
    jplan = jcomp.decode_to_plan(jm)
    i_cap = jplan.n_includes + slack
    li, last, mp, mn = (np.asarray(a) for a in jops.plan_to_popcount_operands(
        jplan, i_cap, 6, l2_cap=80, weight_planes=planes
    ))
    if malformed:
        mp, mn = mp.copy(), mn.copy()
        ends = np.flatnonzero(last == 1)
        t, u = int(ends[len(ends) // 2]), int(ends[0]) + 1
        assert last[u] == 0
        bank = mp[..., 5, :] if mp.ndim == 2 else mp[:, 5, :]
        bank[..., t // 32] |= np.uint32(1) << np.uint32(t % 32)
        mn[..., u // 32] |= np.uint32(1) << np.uint32(u % 32)
    x = rng.integers(0, 2, (64, 40), dtype=np.uint8)
    packed = pack_literals(torch.from_numpy(x))
    want = np.asarray(jkernel.tm_popcount_xla(
        jnp.asarray(li), jnp.asarray(last), jnp.asarray(mp), jnp.asarray(mn),
        jnp.asarray(to_u32(packed)),
    ))
    targs = (torch.from_numpy(li), torch.from_numpy(last), from_u32(mp),
             from_u32(mn), packed)
    for width in (None, -(-i_cap // 32)):
        got, cpos = _clause_space_sums(*targs, n_chunks=width)
        np.testing.assert_array_equal(got.numpy(), want)
        assert cpos.shape[:-1] == mp.shape[:-1]
    np.testing.assert_array_equal(kernel.tm_popcount_plain(*targs).numpy(), want)


def test_clause_space_masks_bit_layout_and_width():
    """Bit k of the clause-space mask is the bit of clause k's last
    instruction; a chunk past the masks reads as 0; a width narrower than
    the clauses need raises."""
    mask = torch.zeros((2, 3), dtype=torch.int32)
    mask[1, 2] = 1 << 4  # instruction 68
    mask[0, 0] = -(1 << 31)  # instruction 31
    ends = torch.tensor([3, 31, 40, 68, 200], dtype=torch.int32)
    pos, neg = kernel.clause_space_masks(mask, mask, ends, n_chunks=2)
    assert pos.shape == (2, 2) and torch.equal(pos, neg)
    assert pos.tolist() == [[1 << 1, 0], [1 << 3, 0]]
    with pytest.raises(ValueError, match="need 2 chunks"):
        kernel.clause_space_masks(mask, mask, torch.arange(33), n_chunks=1)


def _scattered_masks(rng, last, m_cap, planes):
    """Instruction-space masks that are not class-major: every clause end
    goes to a random class of the first ``m_cap - 1`` (the last is left
    empty) with a random polarity and, at ``planes``, a random weight;
    one clause is selected for a second class besides."""
    ends = np.flatnonzero(last == 1)
    lead = (1,) if planes is None else (planes,)
    pos = np.zeros(lead + (m_cap, -(-last.size // 32)), np.uint32)
    neg = np.zeros_like(pos)
    for t in ends:
        bank = pos if rng.random() < 0.5 else neg
        weight = int(rng.integers(1, 2 ** lead[0]))
        for p in range(lead[0]):
            if weight >> p & 1:
                bank[p, rng.integers(m_cap - 1), t // 32] |= np.uint32(1 << t % 32)
    t = ends[len(ends) // 2]
    pos[0, 0, t // 32] |= np.uint32(1 << t % 32)
    pos[0, 1, t // 32] |= np.uint32(1 << t % 32)
    return (pos[0], neg[0]) if planes is None else (pos, neg)


@pytest.mark.parametrize("planes", [None, 3])
@pytest.mark.parametrize("layout", ["class-major", "scattered"])
def test_class_chunk_ranges_cover_every_mask_word(planes, layout):
    """Each class's range holds every non-zero word of its clause-space
    masks, an empty class gets ``lo == hi``, and at a capacity-padded
    width only the first ``ceil(n_clauses / 32)`` chunks count."""
    rng, _, tm_ = _program(13, C=30, weighted=planes is not None, zero_class=True)
    plan = compress.decode_to_plan(tm_)
    i_cap = plan.n_includes + 70  # capacity: chunks past the clauses
    _, last, mp, mn = ops.plan_to_popcount_operands(
        plan, i_cap, 7, weight_planes=planes
    )
    if layout == "scattered":
        mp, mn = _scattered_masks(rng, last, 7, planes)
    ends = torch.from_numpy(ops.clause_ends(last))
    n_chunks = -(-ends.numel() // 32)
    width = -(-i_cap // 32)
    assert width > n_chunks
    cpos, cneg = kernel.clause_space_masks(from_u32(mp), from_u32(mn), ends, width)
    # a word past the clauses, as a malformed padded mask could hold
    cpos[..., 0, n_chunks] = 1
    ranges = kernel.class_chunk_ranges(cpos, cneg, n_chunks)
    assert ranges.dtype == torch.int32 and ranges.shape == (7, 2)
    live = ((cpos | cneg) != 0)[..., :n_chunks]
    live = live.any(dim=0) if live.dim() == 3 else live
    for m, (lo, hi) in enumerate(ranges.tolist()):
        chunks = torch.nonzero(live[m]).flatten().tolist()
        if chunks:
            assert (lo, hi) == (chunks[0], chunks[-1] + 1)
        else:
            assert lo == hi
    assert not live[6].any() and ranges[6].tolist() == [0, 0]
    if layout == "class-major":
        assert not live[2].any() and ranges[2].tolist() == [0, 0]
        assert int((ranges[:, 1] - ranges[:, 0]).sum()) < 2 * n_chunks
    else:
        assert int((ranges[:, 1] - ranges[:, 0]).sum()) > 3 * n_chunks
    # the full width counts the stray word past the clauses
    assert kernel.class_chunk_ranges(cpos, cneg)[0, 1] == n_chunks + 1


@pytest.mark.parametrize("weighted", [False, True])
def test_popcount_program_holds_class_ranges(weighted):
    """The engine's ``PopcountProgram`` carries the class ranges at the
    capacity shape ``[m_cap, 2]``; a 10 x 200 class-major machine walks 70
    (class, chunk) pairs over its 63 chunks (7 of 9 class borders fall
    inside a chunk)."""
    from repro_torch.accel.capacity import CapacityPlan
    from repro_torch.accel.engines import PopcountEngine

    rng = np.random.default_rng(14)
    M, C, F = 10, 200, 24
    acts = np.zeros((M, C, 2 * F), bool)
    feats = rng.integers(0, F, (M, C))
    acts[np.arange(M)[:, None], np.arange(C), 2 * feats] = True
    w = rng.integers(1, 200, (M, C)) if weighted else None
    model = compress.encode(TMConfig(M, C, F), acts, w)
    planes = 8 if weighted else 1
    cap = CapacityPlan(instruction_capacity=2100, feature_capacity=F,
                       class_capacity=12, batch_words=1, weight_planes=planes)
    engine = PopcountEngine(cap, device="cpu")
    prog = engine.program(model)
    ranges = prog["popcount"].class_ranges
    assert ranges.shape == (12, 2) and ranges.dtype == torch.int32
    assert int((ranges[:, 1] - ranges[:, 0]).sum()) == 70
    assert prog["plane_chunks"] == planes * 63
    assert ranges[10:].tolist() == [[0, 0], [0, 0]]


@pytest.mark.cuda
@pytest.mark.parametrize("weighted,w", [(False, 7), (True, 7), (True, 37)])
def test_cuda_kernel_matches_plain_twin(weighted, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng, _, tm_ = _program(11, weighted=weighted, zero_class=True)
    plan = compress.decode_to_plan(tm_)
    li, last, mp, mn = ops.plan_to_popcount_operands(
        plan, plan.n_includes + 9, 6, weight_planes=3 if weighted else None
    )
    dev = torch.device("cuda")
    x = rng.integers(0, 2, (32 * w, 40), dtype=np.uint8)
    args = (
        torch.from_numpy(li).to(dev), torch.from_numpy(last).to(dev),
        from_u32(mp, dev), from_u32(mn, dev),
        pack_literals(torch.from_numpy(x).to(dev)),
    )
    program = kernel.popcount_program(*args[:4])
    before = kernel.launches
    got = kernel.tm_popcount(program, args[4])
    assert kernel.launches == before + 2
    torch.testing.assert_close(got, kernel.tm_popcount_plain(*args), rtol=0, atol=0)


def test_instruction_overflow_is_a_value_error_not_an_assert():
    """The reference guards ``n_includes <= i_cap`` with ``assert`` (gone
    under ``python -O``); the port raises ``ValueError`` with the same
    text."""
    _, jm, tm_ = _program(12)
    with pytest.raises(ValueError) as te:
        ops.plan_to_popcount_operands(compress.decode_to_plan(tm_), 8, 6)
    with pytest.raises(AssertionError) as je:
        jops.plan_to_popcount_operands(jcomp.decode_to_plan(jm), 8, 6)
    assert str(te.value) == str(je.value)
