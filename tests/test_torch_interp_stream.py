"""The stream interpreter's decode (``kernels.interp_stream.
decode_stream_plain``, the twin of the CUDA kernel's first launch) against
the host walk ``_decode``, and the whole interpreter on the CPU against
the JAX reference ``repro.core.interp.interpret_stream``, on the same
numpy streams, exactly (integer tables and sums: tolerance 0): model
streams, malformed ones, a pointer that wraps past int32, and streams
drawn by hypothesis with random E/CC/P/L bits and runs of EXTEND."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import interp as jinterp
from repro_torch.core.bits import from_u32
from repro_torch.core.compress import EXTEND, encode
from repro_torch.core.tm import TMConfig
from repro_torch.kernels.interp_stream import kernel as isk


def _from_walk(imem, n_inst, f_cap, m_cap, wmem):
    """The tables of ``decode_stream_plain``'s contract, from the host
    walk: includes, clauses in emission order and each row's first
    clause among those a boundary finalized."""
    weights = None if wmem is None else wmem.astype(np.int64)
    rows, flips, clauses = isk._decode(imem.astype(np.int64), n_inst, f_cap, m_cap,
                                       weights)
    clause_of = np.zeros(len(rows), np.int64)
    for k, (start, end, _, _) in enumerate(clauses):
        clause_of[start:end] = k
    # the class of each clause, walked again: the class only advances, so a
    # clause's class is the toggle count at its first include
    n = max(0, min(n_inst, imem.size))
    ins = imem[:n].astype(np.int64) & 0xFFFF
    e = (ins >> 15) & 1
    cls = np.cumsum(e != np.concatenate([[0], e[:-1]])) - 1
    off = ins & 0x0FFF
    inc_at = np.flatnonzero(off != EXTEND)
    c_cls = np.array([cls[inc_at[s]] for s, *_ in clauses], np.int64)
    seg = np.cumsum((e != np.concatenate([[0], e[:-1]]))
                    | (((ins >> 14) & 1) != np.concatenate([[0], ((ins >> 14) & 1)[:-1]])))
    final = bool(clauses) and seg[inc_at[-1]] == seg[-1]
    n_mid = len(clauses) - int(final)
    row_first = np.searchsorted(c_cls[:n_mid], np.arange(m_cap + 1), side="left")
    return {
        "include_row": np.array(rows, np.int64),
        "include_mask": np.array(flips, np.int64),
        "include_clause": clause_of,
        "clause_start": np.array([c[0] for c in clauses], np.int64),
        "clause_end": np.array([c[1] for c in clauses], np.int64),
        "clause_row": np.array([-1 if c[2] is None else c[2] for c in clauses], np.int64),
        "clause_vote": np.array([c[3] for c in clauses], np.int64),
        "row_first": row_first.astype(np.int64),
        "n_mid": n_mid,
    }


def _assert_tables_equal(imem, n_inst, f_cap, m_cap, wmem):
    got = isk.decode_stream_plain(
        torch.from_numpy(imem.astype(np.int32)), n_inst, f_cap, m_cap,
        None if wmem is None else torch.from_numpy(wmem))
    want = _from_walk(imem, n_inst, f_cap, m_cap, wmem)
    assert got.n_mid == want["n_mid"]
    for name, t in got._asdict().items():
        if name == "n_mid":
            continue
        assert t.dtype == torch.int32, name
        assert np.array_equal(t.numpy(), want[name]), name
    # the same tables through the entry point (the CPU runs the twin)
    again = isk.decode_stream(
        torch.from_numpy(imem.astype(np.int32)), n_inst, f_cap, m_cap,
        None if wmem is None else torch.from_numpy(wmem))
    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(again, got))
    return got


def _assert_sums_equal(imem, n_inst, feats, wmem, m_cap):
    want = np.asarray(jinterp.interpret_stream(
        jnp.asarray(imem.astype(np.uint16)), jnp.int32(n_inst), jnp.asarray(feats),
        jnp.int32(0), None if wmem is None else jnp.asarray(wmem), m_cap=m_cap,
    ))
    got = isk.interp_stream(
        torch.from_numpy(imem.astype(np.int32)), n_inst, from_u32(feats),
        None if wmem is None else torch.from_numpy(wmem), m_cap=m_cap)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    return want


def _model_stream(case, seed=0):
    """(imem, n_inst, f_cap, m_cap, wmem or None) of a model's stream, or
    of one made malformed."""
    rng = np.random.default_rng(seed)
    M, C, F, m_cap = 4, 6, 20, 4
    if case == "EXTENDs":
        M, C, F = 2, 3, 2100
    acts = rng.random((M, C, 2 * F)) < (0.002 if case == "EXTENDs" else 0.08)
    if case == "EXTENDs":
        acts[0, 0, 4150] = acts[1, 2, [4101, 4198]] = True
    if case == "empty classes":
        acts[[0, 2]] = False
    weights = rng.integers(1, 9, (M, C)) if case == "weighted" else None
    model = encode(TMConfig(M, C, F), acts, weights)
    ins = model.instructions.astype(np.int64)
    if case == "no opening toggle":
        ins ^= (1 << 15) | (1 << 14)
    m_cap = {"classes past m_cap": 2, "m_cap above classes": 9}.get(case, m_cap)
    imem = np.zeros(ins.size + 5, np.int64)
    imem[: ins.size] = ins
    wmem = None
    if weights is not None:
        wmem = np.ones(imem.size, np.int32)
        wmem[: model.n_weights] = model.clause_weights
    return imem, ins.size, F + 3, m_cap, wmem


MODEL_CASES = ["weightless", "weighted", "EXTENDs", "empty classes",
               "no opening toggle", "classes past m_cap", "m_cap above classes"]


@pytest.mark.parametrize("case", MODEL_CASES)
@pytest.mark.parametrize("cut", ["all", "a third", "none", "past the memory"])
def test_decode_tables_equal_the_host_walk(case, cut):
    imem, n_inst, f_cap, m_cap, wmem = _model_stream(case)
    n_inst = {"all": n_inst, "a third": n_inst // 3, "none": 0,
              "past the memory": imem.size + 100}[cut]
    t = _assert_tables_equal(imem, n_inst, f_cap, m_cap, wmem)
    if cut == "all" and case == "no opening toggle":
        # the clauses before the first toggle are class -1: on the last row
        assert int(t.row_first[0]) > 0 and int(t.clause_row[0]) == m_cap - 1
    if cut == "none":
        assert t.clause_row.numel() == 0 and not t.row_first.any()


@pytest.mark.parametrize("case", MODEL_CASES)
def test_interp_stream_on_the_cpu_matches_reference(case):
    imem, n_inst, f_cap, m_cap, wmem = _model_stream(case, seed=1)
    rng = np.random.default_rng(2)
    feats = rng.integers(0, 2**32, (f_cap, 2), dtype=np.uint64).astype(np.uint32)
    feats |= rng.integers(0, 2**32, (f_cap, 2), dtype=np.uint64).astype(np.uint32)
    want = _assert_sums_equal(imem, n_inst, feats, wmem, m_cap)
    assert want.any()


def test_pointer_wraps_as_int32():
    """524,417 EXTENDs in one clause carry the pointer past 2**31: it wraps
    negative, and the next include reads feature row 0 where an unbounded
    pointer would clip to the last row."""
    n_ext = (1 << 31) // EXTEND + 2
    head = 0x8000 | 0x4000 | 0x2000 | 3  # E, CC, P: opens class 0, offset 3
    imem = np.concatenate([[head], np.full(n_ext, EXTEND | 0xC000), [0x8000 | 0x4000 | 5],
                           [0x4000 | 0x2000 | 1]]).astype(np.int64)
    f_cap, m_cap = 6, 2
    t = _assert_tables_equal(imem, imem.size, f_cap, m_cap, None)
    assert t.include_row.tolist() == [1, 0, 0]
    feats = np.zeros((f_cap, 1), np.uint32)
    feats[0], feats[1], feats[f_cap - 1] = 0xF0F0F0F0, 0xFF00FF00, 0x0F0F0F0F
    want = _assert_sums_equal(imem, imem.size, feats, None, m_cap)
    assert want[0].any()


def _stream(draw):
    """A random instruction stream: runs of instructions with random E, CC,
    P, L bits and offsets, and runs of EXTEND."""
    out = []
    for _ in range(draw(st.integers(0, 12))):
        if draw(st.booleans()):
            out += [EXTEND | draw(st.sampled_from([0, 0x4000, 0x8000, 0xC000]))] * draw(
                st.integers(1, 4))
        else:
            out += draw(st.lists(st.integers(0, 0xFFFF), min_size=1, max_size=8))
    return np.array(out + [0] * 3, np.int64)


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_decode_and_sums_match_reference_on_drawn_streams(data):
    imem = _stream(data.draw)
    n_inst = data.draw(st.sampled_from([0, imem.size - 3, imem.size + 50,
                                        max(0, imem.size // 2)]))
    m_cap = data.draw(st.sampled_from([1, 2, 3, 6]))
    f_cap = 9
    wmem = None
    if data.draw(st.booleans()):
        wmem = np.array(data.draw(st.lists(st.integers(-2**31, 2**31 - 1), min_size=1,
                                           max_size=5)), np.int32)
    _assert_tables_equal(imem, n_inst, f_cap, m_cap, wmem)
    seed = data.draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 2**32, (f_cap, 1), dtype=np.uint64).astype(np.uint32)
    feats |= rng.integers(0, 2**32, (f_cap, 1), dtype=np.uint64).astype(np.uint32)
    _assert_sums_equal(imem, n_inst, feats, wmem, m_cap)
