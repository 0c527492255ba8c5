"""The port's kernels against their plain twins on a CUDA card, exact
(integer words, counts and sums: tolerance 0), on the shapes that break
their tilings.

Marked ``cuda``; every test skips itself without a card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import compress
from repro_torch.core.bits import from_u32
from repro_torch.core.tm import TMConfig
from repro_torch.kernels.clause_eval import kernel as ce_kernel
from repro_torch.kernels.clause_eval.ref import clause_eval_ref
from repro_torch.kernels.clause_matmul import kernel as cm_kernel
from repro_torch.kernels.tm_interp import kernel as ti_kernel
from repro_torch.kernels.tm_interp.ops import (
    clause_ends,
    compressed_operands,
    plan_to_operands,
)
from repro_torch.kernels.pack_literals import kernel as pl_kernel
from repro_torch.kernels.tm_popcount import kernel as popcount_kernel
from repro_torch.kernels.tm_popcount import ops as popcount_ops
from repro_torch.kernels.tm_train import kernel as tt_kernel
from repro_torch.kernels.tm_train import pack_ta_state
from repro_torch.core import prng

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("nc,l2,w", [(33, 30, 2), (200, 1568, 37), (7, 5000, 300)])
def test_clause_eval_kernel_matches_plain_twin(dev, nc, l2, w):
    rng = np.random.default_rng(nc)
    actions = (rng.random((nc, l2)) < 0.01).astype(np.int32)
    actions[0] = 0
    a, lits = torch.from_numpy(actions).to(dev), from_u32(_u32(rng, (l2, w)), dev)
    before = ce_kernel.launches
    got = ce_kernel.clause_eval(a, lits)
    assert ce_kernel.launches == before + 1
    torch.testing.assert_close(got, ce_kernel.clause_eval_plain(a, lits), rtol=0, atol=0)
    torch.testing.assert_close(
        got.cpu(), clause_eval_ref(a.cpu(), lits.cpu()), rtol=0, atol=0
    )


# rows off the 16-byte grain (L2 = 1567, 1563, 5: 4-byte copies, some rows
# on the grain and some off it), NC = 1 and W = 1, a row of three staging
# rounds with every even literal included
@pytest.mark.parametrize("nc,l2,w,dense", [
    (1, 1567, 9, False), (40, 1563, 1, False), (3, 5, 2, False),
    (1, 1, 1, False), (5, 4101, 3, True),
])
def test_clause_eval_kernel_on_edge_shapes(dev, nc, l2, w, dense):
    rng = np.random.default_rng(l2 + w)
    actions = (rng.random((nc, l2)) < 0.3).astype(np.int32)
    lits = _u32(rng, (l2, w))
    if dense:  # every positive literal, all ones: the row fires
        actions[:, ::2], actions[:, 1::2] = 1, 0
        lits[::2] = 0xFFFFFFFF
    a, packed = torch.from_numpy(actions).to(dev), from_u32(lits, dev)
    got = ce_kernel.clause_eval(a, packed)
    torch.testing.assert_close(got, ce_kernel.clause_eval_plain(a, packed), rtol=0, atol=0)
    if dense:
        assert got.any()


# NC off the 64- and 128-clause tiles (2000, 37), B off the 256-datapoint
# tile and below it (8191, 100, 40), L2 off the 64- and 128-byte K steps
# (1568, 100, 30, 33) and exactly on them (128, 256)
@pytest.mark.parametrize("nc,l2,b", [
    (33, 30, 40), (200, 1568, 8191), (129, 33, 129), (2000, 1568, 8192),
    (37, 100, 100), (2000, 100, 8191), (128, 128, 256), (64, 256, 512),
])
def test_clause_matmul_kernel_matches_plain_twin(dev, nc, l2, b):
    rng = np.random.default_rng(nc + b)
    actions = (rng.random((nc, l2)) < 0.01).astype(np.int32)
    actions[::2, l2 // 2:] = 0  # even clauses include only the all-ones half
    actions[1] = 0  # an all-zero action row: never fires
    lits = rng.integers(0, 2, (l2, b)).astype(np.int32)
    lits[: l2 // 2] = 1
    a, l01 = torch.from_numpy(actions).to(dev), torch.from_numpy(lits).to(dev)
    before = cm_kernel.launches
    got = cm_kernel.clause_matmul(a, l01)
    assert cm_kernel.launches == before + 2  # narrow both operands, product
    torch.testing.assert_close(got, cm_kernel.clause_matmul_plain(a, l01), rtol=0, atol=0)
    assert got.any() and not got[1].any()


@pytest.mark.parametrize("nc,b", [(37, 100), (2000, 300)])
def test_clause_matmul_kernel_on_one_literal(dev, nc, b):
    """L2 = 1: a single K step, almost all of it TMA's zero fill."""
    rng = np.random.default_rng(b)
    actions = rng.integers(0, 2, (nc, 1)).astype(np.int32)
    actions[0] = 0
    lits = rng.integers(0, 2, (1, b)).astype(np.int32)
    a, l01 = torch.from_numpy(actions).to(dev), torch.from_numpy(lits).to(dev)
    got = cm_kernel.clause_matmul(a, l01)
    torch.testing.assert_close(got, cm_kernel.clause_matmul_plain(a, l01), rtol=0, atol=0)
    assert got.any() and not got[0].any()


def _scattered_masks(rng, last, m_cap, n_cls, planes):
    """Instruction-space masks that are not class-major: every clause end
    goes to a random class of the first ``n_cls`` with a random polarity
    and, at ``planes``, a random weight; one clause is selected for a
    second class besides."""
    ends = np.flatnonzero(last == 1)
    lead = 1 if planes is None else planes
    pos = np.zeros((lead, m_cap, -(-last.size // 32)), np.uint32)
    neg = np.zeros_like(pos)
    for t in ends:
        bank = pos if rng.random() < 0.5 else neg
        weight = int(rng.integers(1, 2 ** lead))
        for p in range(lead):
            if weight >> p & 1:
                bank[p, rng.integers(n_cls), t // 32] |= np.uint32(1 << t % 32)
    t = ends[len(ends) // 2]
    pos[0, 0, t // 32] |= np.uint32(1 << t % 32)
    pos[0, 1, t // 32] |= np.uint32(1 << t % 32)
    return (pos[0], neg[0]) if planes is None else (pos, neg)


def _popcount_case(dev, n_clauses_per_class, m_cap, w, planes, i_slack, seed,
                   scattered=False):
    """A program of ``len(n_clauses_per_class)`` classes with the given
    clause counts (0: a class with no clauses), weights 1 to 2^planes - 1
    above one plane, its popcount operands on the card (``scattered``:
    its masks replaced by ``_scattered_masks``), and packed literals of
    ``w`` batch words."""
    rng = np.random.default_rng(seed)
    n_cls, n_clauses, n_feat = len(n_clauses_per_class), max(n_clauses_per_class), 40
    acts = rng.random((n_cls, n_clauses, 2 * n_feat)) < 0.05
    acts[:, :, 1::2] &= rng.random((n_cls, n_clauses, n_feat)) < 0.3
    for m, n in enumerate(n_clauses_per_class):
        acts[m, n:] = False
    weights = (
        rng.integers(1, 2 ** planes, (n_cls, n_clauses)) if (planes or 0) > 1
        else None
    )
    plan = compress.decode_to_plan(
        compress.encode(TMConfig(n_cls, n_clauses, n_feat), acts, weights)
    )
    li, last, mp, mn = popcount_ops.plan_to_popcount_operands(
        plan, plan.n_includes + i_slack, m_cap, l2_cap=2 * n_feat,
        weight_planes=planes,
    )
    if scattered:
        mp, mn = _scattered_masks(rng, last, m_cap, n_cls, planes)
    lits = from_u32(_u32(rng, (2 * n_feat, w)), dev)
    lits[::2] = -1  # positive literals all ones, so that clauses fire
    ops = [torch.from_numpy(li).to(dev), torch.from_numpy(last).to(dev),
           from_u32(mp, dev), from_u32(mn, dev)]
    return ops, lits


# clause counts per class: 1000 + 999 clauses (n_clauses not a multiple of
# 32, class 0's last chunk straddles into class 1); a class with none; the
# paper's 10 x 200; 18 classes in 20 rows, 16 of them empty, so that a class
# lies past index 16.  planes None: 2-D masks; 1: 3-D masks of one plane;
# 3: weights 1-7 in three planes; 8: weights 1-255 in eight.  scattered:
# masks that are not class-major (random classes, one clause in two).
@pytest.mark.parametrize("counts,m_cap,w,planes,scattered", [
    ((1000, 999), 2, 37, None, False), ((1000, 999), 2, 8, 3, False),
    ((40, 0, 40, 25), 20, 37, 3, False), ((40, 0, 40, 25), 20, 37, 1, False),
    ((200,) * 10, 10, 256, None, False),
    ((200,) * 10, 10, 256, 3, False),
    ((300, 250, 280), 4, 37, None, True), ((300, 250, 280), 4, 37, 3, True),
    ((40,) + (0,) * 16 + (45,), 20, 37, 3, False),
    ((300, 250, 280), 3, 37, 8, False),
])
def test_tm_popcount_kernel_matches_plain_twin(
    dev, counts, m_cap, w, planes, scattered
):
    ops, lits = _popcount_case(
        dev, counts, m_cap, w, planes, 13, len(counts), scattered
    )
    ends = clause_ends(ops[1].cpu().numpy())
    # one program: its clause table padded to capacity, its masks in clause
    # space at the capacity's chunk count, their class ranges
    program = popcount_kernel.popcount_program(*ops)
    assert program.n_clauses == ends.size
    assert torch.equal(program.clause_end[: ends.size].cpu(), torch.from_numpy(ends))
    assert program.clause_masks[0].shape[-1] == -(-ops[0].numel() // 32)
    ranges = program.class_ranges
    want = popcount_kernel.tm_popcount_plain(*ops, lits)
    before = popcount_kernel.launches
    got = popcount_kernel.tm_popcount(program, lits)
    assert popcount_kernel.launches == before + 2
    assert torch.equal(got, want)
    assert want.any()
    live = (ops[2] | ops[3]) != 0
    live = (live.any(dim=0) if live.dim() == 3 else live).any(dim=1)
    for m, n in enumerate(counts):
        if n == 0 and not scattered:
            assert not live[m]
    for m in torch.nonzero(~live).flatten().tolist():
        assert not want[m].any() and not got[m].any()
    spans = (ranges[:, 1] - ranges[:, 0]).sum().item()
    if scattered:
        assert spans > 2 * -(-ends.size // 32)  # wide ranges


@pytest.mark.parametrize(
    "i_cap_extra,w,zero_class", [(0, 8, None), (13, 37, 2), (5, 300, None)]
)
def test_tm_interp_kernel_matches_plain_twin(dev, i_cap_extra, w, zero_class):
    rng = np.random.default_rng(11)
    acts = rng.random((20, 30, 80)) < 0.08
    if zero_class is not None:
        acts[zero_class] = False
    plan = compress.decode_to_plan(compress.encode(TMConfig(20, 30, 40), acts))
    i_cap = plan.n_includes + i_cap_extra
    ops = [torch.from_numpy(a).to(dev) for a in plan_to_operands(plan, i_cap)]
    lits = from_u32(_u32(rng, (80, w)), dev)
    lits[::2] = -1  # positive literals all ones, so that clauses fire
    before = ti_kernel.launches
    got = ti_kernel.tm_interp(*ops, lits, m_cap=20)
    assert ti_kernel.launches == before + 1
    torch.testing.assert_close(
        got, ti_kernel.tm_interp_plain(*ops, lits, 20), rtol=0, atol=0
    )
    assert got.any()
    if zero_class is not None:
        assert not got[zero_class].any()
    table = torch.from_numpy(clause_ends(ops[1].cpu().numpy())).to(dev)
    torch.testing.assert_close(
        ti_kernel.tm_interp(*ops, lits, m_cap=20, clause_end=table), got,
        rtol=0, atol=0,
    )


def _interp_case(dev, case):
    """Operands, literals and m_cap of one program that breaks a layout
    of the kernel: a clause of 75 includes, clauses out of class order
    with class ids out of range, W = 1, m_cap above the model's classes."""
    rng = np.random.default_rng(7)
    acts = rng.random((6, 12, 160)) < 0.05
    m_cap, w = 6, 5
    if case == "long clause":
        acts[2, 3] = False
        acts[2, 3, 0:150:2] = True  # 75 positive literals
    plan = compress.decode_to_plan(compress.encode(TMConfig(6, 12, 80), acts))
    ops = [torch.from_numpy(a).to(dev) for a in plan_to_operands(plan, plan.n_includes + 9)]
    if case == "out of class order":
        last = ops[1].cpu().numpy()
        clause_of = np.cumsum(last) - last
        cls = rng.integers(-3, 9, int(last.sum()) + 1).astype(np.int32)[clause_of]
        ops[3] = torch.from_numpy(cls).to(dev)
    if case == "W=1":
        w = 1
    if case == "m_cap above classes":
        m_cap = 9
    lits = from_u32(_u32(rng, (160, w)), dev)
    lits[::2] = -1  # positive literals all ones, so that clauses fire
    return plan, ops, lits, m_cap


@pytest.mark.parametrize(
    "case", ["long clause", "out of class order", "W=1", "m_cap above classes"]
)
def test_tm_interp_kernel_on_edge_programs(dev, case):
    plan, ops, lits, m_cap = _interp_case(dev, case)
    want = ti_kernel.tm_interp_plain(*ops, lits, m_cap)
    got = ti_kernel.tm_interp(*ops, lits, m_cap=m_cap)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert want.any()
    if case == "m_cap above classes":
        assert not got[6:].any()
    if case != "out of class order":  # the host table of the entry point
        *hops, ends = compressed_operands(plan, ops[0].numel(), m_cap, dev)
        got = ti_kernel.tm_interp(*hops, lits, m_cap=m_cap, clause_end=ends)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_tm_interp_kernel_stays_in_bounds_on_a_bad_clause_table(dev):
    """Entries outside [0, I_cap) are skipped and a run never starts
    before instruction 0: a malformed table reads nothing outside the
    operands (the sums are then not the plan's)."""
    acts = np.random.default_rng(5).random((4, 6, 20)) < 0.2
    plan = compress.decode_to_plan(compress.encode(TMConfig(4, 6, 10), acts))
    ops = [torch.from_numpy(a).to(dev) for a in plan_to_operands(plan, 256)]
    lits = torch.full((20, 3), -1, dtype=torch.int32, device=dev)
    table = torch.tensor([-7, 2, 1 << 30, 5, 3], dtype=torch.int32, device=dev)
    got = ti_kernel.tm_interp(*ops, lits, m_cap=4, clause_end=table)
    torch.cuda.synchronize()
    assert got.shape == (4, 96)
    assert got.abs().max() <= 3  # at most the three in-range entries emit


@pytest.mark.parametrize("limit", ["m_cap", "literal words"])
def test_tm_interp_kernel_refuses_sizes_past_its_limits(dev, limit):
    """m_cap past grid.y, or a literal panel of 2^30 words or more (its
    byte offsets would not fit 32 bits), raises ValueError on the card."""
    v = torch.zeros(8, dtype=torch.int32, device=dev)
    if limit == "m_cap":
        lits, m_cap = torch.zeros((4, 1), dtype=torch.int32, device=dev), 65536
    else:  # a broadcast view: nothing is allocated
        lits = torch.zeros((1, 1), dtype=torch.int32, device=dev).expand(1 << 15, 1 << 15)
        m_cap = 2
    with pytest.raises(ValueError, match="tm_interp kernel takes"):
        ti_kernel.tm_interp(v, v, v, v, lits, m_cap=m_cap)


def _train_case(dev, M, C, F, B, seed, excluded=False, **cfg_kw):
    rng = np.random.default_rng(seed)
    cfg = TMConfig(M, C, F, **cfg_kw)
    if excluded:  # every clause empty: training outputs 1 everywhere
        state = np.ones((M, C, 2 * F), np.int32)
    else:
        state = rng.integers(1, 2 * cfg.n_states + 1, (M, C, 2 * F)).astype(np.int32)
        state[:, 0], state[:, 1] = 1, 2 * cfg.n_states  # the walls
        state[:, 2:] = np.where(rng.random((M, C - 2, 2 * F)) < 0.9,
                                cfg.n_states, state[:, 2:])  # sparse includes
    packed = pack_ta_state(cfg, torch.from_numpy(state)).to(dev)
    batches = [(torch.from_numpy(rng.integers(0, 2, (B, F), dtype=np.uint8)).to(dev),
                torch.from_numpy(rng.integers(0, M, B).astype(np.int32)).to(dev))
               for _ in range(3)]
    return cfg, packed, batches


# small; C off a multiple of 32 with a ragged B; a sub-word B; B off the
# update kernel's 256-sample round; the literal tile ragged (2F = 1568);
# labels past either end, which index as the reference's (a negative one
# counts from the end, a read clamps, a target still out of range drops
# its update); with M = 2 and every label -1 both rows of each sample are
# class 1, so a block lists two entries per sample
@pytest.mark.parametrize("M,C,F,B,excluded,labels", [
    (2, 6, 5, 16, False, None), (3, 40, 11, 33, False, None),
    (5, 10, 16, 7, False, None), (4, 24, 12, 300, False, None),
    (10, 30, 784, 37, False, None), (3, 12, 9, 20, True, None),
    (3, 40, 11, 40, False, [3, -1, -4, 2**31 - 1, -(2**31), 0, 2]),
    (2, 40, 11, 300, False, [-1]),
    (10, 30, 784, 256, False, None), (3, 40, 11, 1, False, None),
])
def test_tm_train_kernel_matches_plain_twin(dev, M, C, F, B, excluded, labels):
    """Three chained steps: the kernel's state feeds its next step."""
    cfg, packed, batches = _train_case(dev, M, C, F, B, M * C + B, excluded)
    if labels is not None:
        y = torch.tensor(np.resize(np.array(labels, np.int32), B), device=dev)
        batches = [(x, y) for x, _ in batches]
    got = want = packed
    for step, (x, y) in enumerate(batches):
        kb = prng.fold_in(prng.key(7), step)
        before = tt_kernel.launches
        got = tt_kernel.fused_train_batch(cfg, got, kb, x, y)
        assert tt_kernel.launches == before + 2
        want = tt_kernel.fused_train_batch_plain(cfg, want, kb, x, y)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, packed)


# the configurations the paper's defaults never reach: no boost of true
# positives (the strengthen < 1 branch), s = 1 and 10, T = 1, N = 8, and
# all of them off the defaults at once
@pytest.mark.parametrize("cfg_kw", [
    dict(boost_true_positive=False), dict(specificity=1.0), dict(specificity=10.0),
    dict(threshold=1), dict(n_states=8),
    dict(boost_true_positive=False, specificity=1.5, threshold=3, n_states=8),
], ids=["no-boost", "s=1", "s=10", "T=1", "N=8", "mixed"])
@pytest.mark.parametrize("M,C,F,B", [(3, 40, 11, 33), (10, 30, 784, 37)])
def test_tm_train_kernel_on_other_configs(dev, cfg_kw, M, C, F, B):
    """Three chained steps, as the default-config cases above."""
    cfg, packed, batches = _train_case(dev, M, C, F, B, M + C + B, **cfg_kw)
    got = want = packed
    for step, (x, y) in enumerate(batches):
        kb = prng.fold_in(prng.key(8), step)
        got = tt_kernel.fused_train_batch(cfg, got, kb, x, y)
        want = tt_kernel.fused_train_batch_plain(cfg, want, kb, x, y)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, packed)


def test_tm_train_wrapper_refuses_what_the_kernel_does_not_take(dev):
    cfg, packed, [(x, y), *_] = _train_case(dev, 3, 40, 11, 33, 1)
    plits = tt_kernel._pack_batch(x)
    cw = tt_kernel.packed_clause_words(packed.reshape(3, 40, 22) >= 0, plits)
    key = prng.key(1)
    with pytest.raises(ValueError, match="contiguous"):
        tt_kernel.tm_train(cfg, packed.transpose(0, 1), cw, plits, y, key)
    with pytest.raises(ValueError, match="contiguous"):
        tt_kernel.tm_train(cfg, packed, cw, plits.T.contiguous().T, y, key)
    with pytest.raises(ValueError, match="several devices"):
        tt_kernel.tm_train(cfg, packed, cw, plits, y.cpu(), key)
    with pytest.raises(ValueError, match="2 <= classes"):
        one = TMConfig(1, 40, 11)
        tt_kernel.tm_train(one, packed[:1].contiguous(), cw[:1].contiguous(),
                           plits, torch.zeros_like(y), key)
    with pytest.raises(TypeError, match="int32 words"):
        tt_kernel.tm_train(cfg, packed, cw.to(torch.int64), plits, y, key)


# -- the stream interpreter -------------------------------------------------------


def _stream(dev, case, w):
    """(imem, n_inst, feature memory, weight memory or None, m_cap) of one
    stream case on ``dev``: a weightless or weighted model, one with
    EXTENDs (literal slots past 4095), one that does not open with a
    toggle (E and CC flipped), one whose classes run past m_cap, one with
    m_cap above its classes, or a random word stream."""
    rng = np.random.default_rng(len(case) + w)
    M, C, F, m_cap, extra = 10, 30, 100, 10, 13
    if case == "EXTENDs":
        M, C, F = 2, 3, 2100
    acts = rng.random((M, C, 2 * F)) < (0.002 if case == "EXTENDs" else 0.04)
    if case == "EXTENDs":
        acts[0, 0, 4150] = acts[1, 2, [4101, 4198]] = True
    weights = rng.integers(1, 9, (M, C)) if case == "weighted" else None
    model = compress.encode(TMConfig(M, C, F), acts, weights)
    ins = model.instructions.astype(np.int64)
    if case == "no opening toggle":
        ins ^= (1 << 15) | (1 << 14)
    if case == "random words":
        ins = rng.integers(0, 1 << 16, 3000)
    m_cap = {"classes past m_cap": 4, "m_cap above classes": 23}.get(case, m_cap)
    imem = np.zeros(ins.size + extra, np.int32)
    imem[: ins.size] = ins
    feats = from_u32(_u32(rng, (F + 5, w)), dev)
    wmem = None
    if weights is not None:
        wmem = np.ones(imem.size, np.int32)
        wmem[: model.n_weights] = model.clause_weights
        wmem = torch.from_numpy(wmem).to(dev)
    elif case == "random words":
        wmem = torch.from_numpy(rng.integers(-3, 9, 40).astype(np.int32)).to(dev)
    return torch.from_numpy(imem).to(dev), int(ins.size), feats, wmem, m_cap


@pytest.mark.parametrize("case", [
    "weightless", "weighted", "EXTENDs", "no opening toggle", "classes past m_cap",
    "m_cap above classes", "random words",
])
@pytest.mark.parametrize("w", [1, 37, 256])
def test_interp_stream_kernel_matches_plain_twin(dev, case, w):
    from repro_torch.kernels.interp_stream import kernel as is_kernel
    from repro_torch.kernels.interp_stream.ref import interpret_stream_ref

    imem, n_inst, feats, wmem, m_cap = _stream(dev, case, w)
    before = is_kernel.launches
    got = is_kernel.interp_stream(imem, n_inst, feats, wmem, m_cap=m_cap)
    assert is_kernel.launches == before + 2  # decode, then evaluate
    want = is_kernel.interpret_stream_plain(imem, n_inst, feats, wmem, m_cap)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert want.any()
    if w == 1:
        torch.testing.assert_close(
            got, interpret_stream_ref(imem, n_inst, feats, wmem, m_cap), rtol=0, atol=0)
    # fewer live instructions than the stream holds: the rest do nothing
    part = is_kernel.interp_stream(imem, n_inst // 3, feats, wmem, m_cap=m_cap)
    torch.testing.assert_close(
        part, is_kernel.interpret_stream_plain(imem, n_inst // 3, feats, wmem, m_cap),
        rtol=0, atol=0)


@pytest.mark.parametrize("case", [
    "weightless", "weighted", "EXTENDs", "no opening toggle", "classes past m_cap",
    "m_cap above classes", "random words",
])
def test_interp_stream_decode_tables_match_the_plain_decode(dev, case):
    """Launch A's tables against ``decode_stream_plain`` on the same
    stream, for all live instructions, a third of them and none."""
    from repro_torch.kernels.interp_stream import kernel as is_kernel

    imem, n_inst, feats, wmem, m_cap = _stream(dev, case, 1)
    for n in (n_inst, n_inst // 3, 0, imem.numel() + 9):
        got = is_kernel.decode_stream(imem, n, feats.shape[0], m_cap, wmem)
        want = is_kernel.decode_stream_plain(imem, n, feats.shape[0], m_cap, wmem)
        assert got.n_mid == want.n_mid
        for name, a, b in zip(got._fields[:-1], got[:-1], want[:-1]):
            assert torch.equal(a, b), (name, n)


def test_interp_stream_decode_carries_across_tiles(dev):
    """A stream of many decode tiles (1,024 instructions each), random
    words, weighted: the look-back from tile to tile."""
    from repro_torch.kernels.interp_stream import kernel as is_kernel

    rng = np.random.default_rng(11)
    imem = torch.from_numpy(rng.integers(0, 1 << 16, 20000).astype(np.int32)).to(dev)
    wmem = torch.from_numpy(rng.integers(-9, 9, 100).astype(np.int32)).to(dev)
    feats = from_u32(_u32(rng, (50, 3)), dev)
    for n in (4095, 4096, 4097, 20000):
        got = is_kernel.decode_stream(imem, n, 50, 7, wmem)
        want = is_kernel.decode_stream_plain(imem, n, 50, 7, wmem)
        assert got.n_mid == want.n_mid
        assert all(torch.equal(a, b) for a, b in zip(got[:-1], want[:-1])), n
        sums = is_kernel.interp_stream(imem, n, feats, wmem, m_cap=7)
        torch.testing.assert_close(
            sums, is_kernel.interpret_stream_plain(imem, n, feats, wmem, 7), rtol=0, atol=0)


@pytest.mark.parametrize("w", [1, 256])
def test_interp_stream_pointer_wraps_as_int32(dev, w):
    """524,417 EXTENDs in one clause carry the pointer past 2**31: the
    decode's unsigned sum goes through the block scan and a look-back over
    ~500 tiles, wraps negative, and the next include reads feature row 0
    where an unbounded pointer would clip to the last row."""
    from repro_torch.kernels.interp_stream import kernel as is_kernel

    extend = 0x0FFF
    n_ext = (1 << 31) // extend + 2
    head = 0x8000 | 0x4000 | 0x2000 | 3  # E, CC, P: opens class 0, offset 3
    imem = torch.from_numpy(np.concatenate([
        [head], np.full(n_ext, extend | 0xC000), [0x8000 | 0x4000 | 5],
        [0x4000 | 0x2000 | 1]]).astype(np.int32)).to(dev)
    f_cap, m_cap, n = 6, 2, imem.numel()
    got = is_kernel.decode_stream(imem, n, f_cap, m_cap, None)
    want = is_kernel.decode_stream_plain(imem, n, f_cap, m_cap, None)
    assert got.n_mid == want.n_mid
    for name, a, b in zip(got._fields[:-1], got[:-1], want[:-1]):
        assert torch.equal(a, b), name
    assert got.include_row.tolist() == [1, 0, 0]
    rng = np.random.default_rng(w)
    feats = _u32(rng, (f_cap, w))
    feats[0], feats[1], feats[f_cap - 1] = 0xF0F0F0F0, 0xFF00FF00, 0x0F0F0F0F
    feats = from_u32(feats, dev)
    sums = is_kernel.interp_stream(imem, n, feats, m_cap=m_cap)
    torch.testing.assert_close(
        sums, is_kernel.interpret_stream_plain(imem, n, feats, None, m_cap), rtol=0, atol=0)
    assert sums[0].any()


@pytest.mark.parametrize("f_cap,m_cap", [(4096, 64), (784, 400), (20000, 1190)])
def test_interp_stream_kernel_on_large_memories(dev, f_cap, m_cap):
    """Feature and class-sum memories far past the parent kernel's shared
    memory, which held both (F_cap + 32 m_cap words); the kernel now takes
    m_cap <= 65535 and F_cap * W < 2**30."""
    from repro_torch.kernels.interp_stream import kernel as is_kernel

    rng = np.random.default_rng(f_cap)
    acts = rng.random((12, 20, 200)) < 0.05
    model = compress.encode(TMConfig(12, 20, 100), acts)
    imem = torch.from_numpy(model.instructions.astype(np.int32)).to(dev)
    feats = from_u32(_u32(rng, (f_cap, 3)), dev)
    got = is_kernel.interp_stream(imem, model.n_instructions, feats, m_cap=m_cap)
    want = is_kernel.interpret_stream_plain(imem, model.n_instructions, feats, None, m_cap)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.any()


def test_interp_stream_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.interp_stream import kernel as is_kernel

    imem = torch.zeros(64, dtype=torch.int32, device=dev)
    feats = torch.zeros((100, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="interp_stream kernel takes"):
        is_kernel.interp_stream(imem, 10, feats, m_cap=65536)
    huge = torch.zeros((1, 1), dtype=torch.int32, device=dev).expand(1 << 15, 1 << 15)
    with pytest.raises(ValueError, match="interp_stream kernel takes"):
        is_kernel.interp_stream(imem, 10, huge, m_cap=2)  # F_cap * W = 2**30 words
    with pytest.raises(ValueError, match="contiguous"):
        is_kernel.interp_stream(imem, 10, feats.T.contiguous().T, m_cap=2)
    with pytest.raises(ValueError, match="is on"):
        is_kernel.interp_stream(imem.cpu(), 10, feats, m_cap=2)


# -- pruning on the card -------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 37, 512])
def test_clause_fire_counts_on_the_card_match_the_plain_version(dev, B):
    from repro_torch import prune
    from repro_torch.kernels.clause_eval import kernel as ce
    from repro_torch.prune.rank import clause_fire_counts_plain

    rng = np.random.default_rng(B)
    cfg = TMConfig(10, 30, 100)
    acts = rng.random((10, 30, 200)) < 0.02
    acts[0, 0] = False
    acts[0, 0, 1::2] = True  # negated literals only: would fire on pad rows
    acts[1, 1] = False  # empty: never fires
    X = rng.integers(0, 2, (B, 100)).astype(np.uint8)
    before = ce.launches
    got = prune.clause_fire_counts(cfg, acts, X, device=dev)
    assert ce.launches == before + 1
    want = clause_fire_counts_plain(cfg, acts, X, device=dev)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, prune.clause_fire_counts(cfg, acts, X, device="cpu"))
    assert got[1, 1] == 0


def test_prune_policy_on_the_card_equals_the_cpu(dev):
    from repro_torch import prune

    rng = np.random.default_rng(3)
    cfg = TMConfig(4, 20, 30)
    acts = rng.random((4, 20, 60)) < 0.06
    acts[:, 3] = acts[:, 5]  # duplicate pairs to merge
    X = rng.integers(0, 2, (77, 30)).astype(np.uint8)
    y = rng.integers(0, 4, 77).astype(np.int32)
    policy = prune.PrunePolicy(tolerance=0.05)
    got, want = (policy.apply(cfg, acts, X=X, y=y, device=d) for d in (dev, "cpu"))
    assert np.array_equal(got.actions, want.actions)
    assert (got.weights is None) == (want.weights is None)
    if got.weights is not None:
        assert np.array_equal(got.weights, want.weights)
    assert got.report == want.report


@pytest.mark.parametrize("engine", ["interp", "plan", "sharded"])
def test_engines_on_the_card_serve_the_cpu_sums(dev, engine):
    from repro_torch.accel import Accelerator

    rng = np.random.default_rng(4)
    cfg = TMConfig(5, 10, 30)
    a = compress.encode(cfg, rng.random((5, 10, 60)) < 0.08)
    b = compress.encode(cfg, rng.random((5, 10, 60)) < 0.1, rng.integers(1, 6, (5, 10)))
    x = rng.integers(0, 2, (70, 30), dtype=np.uint8)
    accs = [Accelerator.for_models([a, b], batch_words=3, engine=e, device=d)
            for e, d in ((engine, dev), ("popcount", "cpu"))]
    for model in (a, b, a):
        sums = []
        for acc in accs:
            acc.load("s", acc.compile(model))
            sums.append(acc.class_sums("s", x))
        np.testing.assert_array_equal(*sums)
    assert accs[0].compile_cache_size() == 1


def _pack_block(rng, b, f, kind):
    """uint8 [b, f]: "random" is half zeros and half bytes in [1, 256)."""
    if kind == "zeros":
        return np.zeros((b, f), np.uint8)
    if kind == "ones":
        return np.ones((b, f), np.uint8)
    nonzero = rng.integers(1, 256, (b, f), dtype=np.uint8)
    return np.where(rng.random((b, f)) < 0.5, 0, nonzero).astype(np.uint8)


# F off the 16-byte grain (1, 15, 17, 1,122: byte loads) and on it (16,
# 784: 16-byte loads, 784 a chunk of 16 at the end); W = 1 and 3 leave a
# block's words mostly empty, 256 and 1,024 are the served batches
@pytest.mark.parametrize("kind", ["random", "zeros", "ones"])
@pytest.mark.parametrize("w", [1, 3, 256, 1024])
@pytest.mark.parametrize("f", [1, 15, 16, 17, 784, 1122])
def test_pack_literals_kernel_matches_plain_twin(dev, f, w, kind):
    x = torch.from_numpy(_pack_block(np.random.default_rng(f * 31 + w), 32 * w, f,
                                     kind)).to(dev)
    before = pl_kernel.launches
    got = pl_kernel.pack_literals(x)
    assert pl_kernel.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (2 * f, w)
    assert torch.equal(got, pl_kernel.pack_literals_plain(x))


@pytest.mark.parametrize("f,w", [(784, 256), (16, 3), (1122, 5)])
def test_pack_literals_kernel_on_blocks_off_the_16_byte_grain(dev, f, w):
    """A block that starts one byte past an aligned address: byte loads at
    any F."""
    x = torch.from_numpy(_pack_block(np.random.default_rng(f), 32 * w, f, "random"))
    buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)
    shifted = buf[1:].view(32 * w, f)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    want = pl_kernel.pack_literals_plain(x.to(dev))
    assert torch.equal(pl_kernel.pack_literals(shifted), want)


def test_pack_literals_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros((64, 32), dtype=torch.uint8, device=dev)
    before = pl_kernel.launches
    with pytest.raises(ValueError, match="multiple of 32"):
        pl_kernel.pack_literals(x[:40])
    with pytest.raises(TypeError, match="uint8"):
        pl_kernel.pack_literals(x.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        pl_kernel.pack_literals(x[:, ::2])
    assert pl_kernel.launches == before


@pytest.mark.parametrize("engine", ["popcount", "sharded"])
def test_packing_engines_on_the_card_launch_pack_literals(dev, engine):
    """The engines that pack the staging block serve the CPU's sums, one
    ``pack_literals`` launch per batch."""
    from repro_torch.accel import Accelerator

    rng = np.random.default_rng(6)
    cfg = TMConfig(5, 10, 30)
    a = compress.encode(cfg, rng.random((5, 10, 60)) < 0.08)
    b = compress.encode(cfg, rng.random((5, 10, 60)) < 0.1, rng.integers(1, 6, (5, 10)))
    x = rng.integers(0, 2, (70, 30), dtype=np.uint8)
    card, cpu = (Accelerator.for_models([a, b], batch_words=3, engine=e, device=d)
                 for e, d in ((engine, dev), ("popcount", "cpu")))
    for model in (a, b, a):
        card.load("s", card.compile(model))
        cpu.load("s", cpu.compile(model))
        before = pl_kernel.launches
        got = card.class_sums("s", x)
        torch.cuda.synchronize()
        assert pl_kernel.launches == before + 1
        np.testing.assert_array_equal(got, cpu.class_sums("s", x))
        assert pl_kernel.launches == before + 1
    assert card.compile_cache_size() == 1


def _clause_table_case(dev, M, C, lc, l2, w, seed, kind="random"):
    """A class-major table of random literal rows (weighted polarities up
    to +-7, some padding rows of polarity 0, pads on the all-ones row,
    an out-of-range and a negative index) over random packed words with
    an all-ones row; the literal words are dense in ones so that clauses
    fire.  ``kind`` changes one thing:

    * ``runs``: slots repeat the slot before them in runs, pads stand
      among the includes, and two runs cross slots 32 and 64;
    * ``pad row``: the pads' row (the last) is random, not all ones;
    * ``ones``: every literal word is all ones, so every row walks every
      slot and fires;
    * ``wrap``: ``-1`` stands beside ``n_rows - 1`` (the pads' row, random
      here) in one row, and across slots 31 and 32 in another;
    * ``offset``: packed1 starts 4 bytes into its buffer, so its rows are
      not 16-byte aligned.
    """
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, l2, (M, C, lc)).astype(np.int32)
    n_inc = rng.integers(0, lc + 1, (M, C))
    idx[np.arange(lc)[None, None] >= n_inc[..., None]] = l2  # pads -> ones row
    if kind == "runs":
        idx[rng.random((M, C, lc)) < 0.2] = l2
        repeat = rng.random((M, C, lc)) < 0.75
        for j in range(1, lc):
            idx[..., j] = np.where(repeat[..., j], idx[..., j - 1], idx[..., j])
        idx[:, :, 28:36] = idx[:, :, 28:29]
        idx[:, :, 60:70] = idx[:, :, 60:61]
    if kind == "wrap":
        idx[0, 0, 1:5] = (-1, l2, -1, l2)
        idx[-1, 0, 31:33] = (l2, -1)
    elif lc:
        idx[0, 0, 0], idx[-1, -1, -1] = -1, l2 + 5
    pol = rng.integers(-7, 8, (M, C)).astype(np.int32)
    pol[:, -1] = 0
    if kind == "wrap":
        pol[0, 0], pol[-1, 0] = 3, -5
    words = _u32(rng, (l2, w)) | _u32(rng, (l2, w)) | _u32(rng, (l2, w))
    last = np.full((1, w), 0xFFFFFFFF, np.uint32)
    if kind in ("pad row", "wrap"):
        last = _u32(rng, (1, w)) | _u32(rng, (1, w))
    packed1 = np.concatenate([words, last])
    if kind == "ones":
        packed1[:] = 0xFFFFFFFF
    p1 = from_u32(packed1, dev)
    if kind == "offset":
        buf = torch.empty(p1.numel() + 1, dtype=torch.int32, device=dev)
        buf[1:] = p1.reshape(-1)
        p1 = buf[1:].view(p1.shape)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(pol).to(dev), p1


def _random(*shape):  # a case of random tables, under its earlier id
    return pytest.param(*shape, "random", id="-".join(map(str, shape)))


@pytest.mark.parametrize("M,C,lc,l2,w,kind", [
    _random(3, 5, 7, 40, 1), _random(4, 33, 40, 60, 37), _random(2, 17, 0, 10, 3),
    _random(10, 128, 160, 1568, 256),  # tm-paper's tile at one device
    _random(5, 64, 160, 1568, 128),  # one tile of tm-paper on a (2, 2) mesh
    (3, 40, 100, 60, 5, "runs"), (10, 128, 160, 1568, 256, "runs"),
    (4, 33, 40, 60, 37, "pad row"),
    (10, 200, 20, 1568, 256, "pad row"),  # the served plan's table
    (3, 50, 70, 40, 9, "ones"), (10, 128, 160, 1568, 256, "ones"),
    (2, 5, 40, 30, 2, "wrap"), (10, 200, 40, 1568, 256, "wrap"),
    (10, 200, 20, 1568, 256, "offset"),  # one word per lane, not four
    # the launch shape and its edges (kernel.clause_table_shape): 8
    # blocks on one tile; splits of 7 and 8 that do not divide C; the
    # last tile count that splits 8 ways and the first that splits 7; 2
    # blocks where the rows allow no more; tiles that fill the card (no
    # split); four words per lane with a ragged last tile, and with one
    # lane of a tile live
    (1, 1000, 7, 40, 1, "random"), (2, 101, 40, 60, 3, "random"),
    (1, 129, 3, 10, 33, "random"), (28, 200, 5, 30, 1, "random"),
    (29, 200, 5, 30, 1, "random"), (33, 17, 5, 30, 1, "random"),
    (224, 3, 4, 10, 1, "random"), (20, 50, 30, 60, 132, "random"),
    (40, 64, 9, 30, 4, "random"),
])
def test_clause_table_kernel_matches_plain_twin(dev, M, C, lc, l2, w, kind):
    from repro_torch.kernels.clause_table import kernel as ct_kernel
    from repro_torch.kernels.clause_table.ref import clause_table_plain

    args = _clause_table_case(dev, M, C, lc, l2, w, seed=M * C + lc, kind=kind)
    before = ct_kernel.launches
    got = ct_kernel.clause_table(*args)
    torch.cuda.synchronize()
    assert ct_kernel.launches == before + 1
    want = clause_table_plain(*args)
    assert want.abs().sum() > 0 or lc == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got.cpu(), clause_table_plain(*(a.cpu() for a in args)),
                               rtol=0, atol=0)


def test_clause_table_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.clause_table import kernel as ct_kernel

    idx, pol, p1 = _clause_table_case(dev, 2, 3, 4, 10, 2, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        ct_kernel.clause_table(idx.transpose(0, 1), pol.T, p1)
    with pytest.raises(ValueError, match="packed1 on"):
        ct_kernel.clause_table(idx.cpu(), pol.cpu(), p1)
    with pytest.raises(ValueError, match="65535"):
        ct_kernel.clause_table(
            torch.zeros((65536, 1, 1), dtype=torch.int32, device=dev),
            torch.zeros((65536, 1), dtype=torch.int32, device=dev), p1)


def test_sharded_executor_on_logical_meshes_of_the_card(dev):
    """``build_tm_sharded`` on (1, 1), (1, 2), (2, 1), (2, 2) and (1, 3)
    meshes of one card: one clause_table launch per tile, the sums equal
    to the CPU mesh's."""
    from repro_torch.dist import make_mesh
    from repro_torch.dist import tm_sharded as tms
    from repro_torch.kernels.clause_table import kernel as ct_kernel

    rng = np.random.default_rng(7)
    cfg = TMConfig(5, 12, 40)
    acts = rng.random((5, 12, 80)) < 0.05
    plan = compress.decode_to_plan(compress.encode(cfg, acts, rng.integers(1, 8, (5, 12))))
    X = rng.integers(0, 2, (128, 40)).astype(np.uint8)
    scfg = tms.TMShardedConfig("t", 5, 12, 40, batch=128,
                               include_cap=int(plan.includes_per_clause().max()))
    for shape in [(1, 1), (1, 2), (2, 1), (2, 2), (1, 3)]:
        cpu = make_mesh(shape, devices="cpu")
        fn_c, _ = tms.build_tm_sharded(scfg, cpu)
        want = fn_c(*tms.operands_from_plan(scfg, plan, X, cpu))
        mesh = make_mesh(shape, devices=dev)
        fn, _ = tms.build_tm_sharded(scfg, mesh)
        ops = tms.operands_from_plan(scfg, plan, X, mesh)
        before = ct_kernel.launches
        got = fn(*ops)
        torch.cuda.synchronize()
        n_batch = len(fn.shards)
        assert ct_kernel.launches == before + n_batch * fn.n_model, shape
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
