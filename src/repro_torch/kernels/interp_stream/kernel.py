"""The paper's stream interpreter: the CUDA kernel's wrapper and its
plain PyTorch twin.

The function is ``repro.core.interp.interpret_stream`` (a ``lax.scan``
over the instruction memory): from ``imem`` (uint16 instructions held as
int32), the count of live instructions, the packed feature memory
``int32[F_cap, W]`` (uint32 bit patterns, ``core.bits``) and an optional
weight memory, the class sums ``int32[m_cap, W*32]``.  Its rules, on
malformed streams too:

  * a boundary is an instruction whose E or CC bit differs from the
    previous live one's (the first live one compares against 0, 0); it
    finalizes the open clause if any literal was ANDed into it, advances
    the class iff E toggled, resets the literal pointer and sets the
    polarity from its P bit;
  * every live instruction adds its offset field to the pointer (EXTEND,
    0x0FFF, is its own 4095 slots) and, unless it is an EXTEND, ANDs the
    feature word of row ``clip(ptr >> 1, 0, F_cap - 1)``, complemented
    when its L bit is set, into the clause word;
  * a finalize adds ``pol * wmem[clip(ordinal)]`` (``pol`` without a
    weight memory) to each datapoint whose bit is set, in class row
    ``cls`` when ``0 <= cls < m_cap``, row ``cls + m_cap`` when
    ``-m_cap <= cls < 0`` (the scatter wraps the class -1 of a stream
    that does not open with a toggle onto the last row) and nowhere
    otherwise, then advances the ordinal;
  * after the last live instruction the open clause is finalized into row
    ``clip(cls, 0, m_cap - 1)``.

Columns past the caller's datapoint count are computed like the others
and sliced off by the caller.

The work splits in two, as the CUDA kernel splits it.  The decode
(``decode_stream_plain``; launch A on the card) depends on the stream
alone: per include its feature row, complement mask and clause, per
non-empty clause in emission order its includes, class row and vote,
and per class row ``r`` the first clause whose class is at least ``r``
(classes only advance, so each row's clauses form at most three ranges:
its own class, the wrapped class -1 on the last row, and the clipped
last clause).  The evaluation (launch B) ANDs each clause's feature
words and adds its vote to its row.

``interp_stream`` is the one entry point.  On CPU tensors it runs
``interpret_stream_plain``; on CUDA tensors it launches the Hopper
kernels of ``csrc/interp_stream.cu`` (decode, then evaluate) or raises;
there is no fallback between the two.  ``launches`` counts the CUDA
launches and nothing else: 2 per call.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...core.compress import CC_BIT, E_BIT, EXTEND, L_BIT, OFF_MASK, P_BIT
from ...core.tm import unpack_bits
from .. import _build

# CUDA kernel launches made by interp_stream (the plain twin never counts)
launches = 0

# the evaluation grid: batch-word tiles x class rows (grid.y), and the
# feature words addressed by 32-bit byte offsets
MAX_M_CAP = 65535
MAX_FEATURE_WORDS = 1 << 30


def _i32(v: int) -> int:
    """``v`` wrapped to int32, as the reference's int32 carry wraps."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _decode(imem: np.ndarray, n_inst: int, f_cap: int, m_cap: int, weights):
    """Walk the live instructions once on the host, one at a time ->
    (feature row and complement mask of every include, finalized clauses
    as (first include, end include, class row or None, vote)).  The
    tests' oracle of ``decode_stream_plain``."""
    rows, flips, clauses = [], [], []
    ptr, cls, pol, wi, start = 0, -1, 1, 0, 0
    nonempty, prev_e, prev_cc = False, 0, 0

    def vote(pol, wi):
        if weights is None:
            return pol
        return _i32(pol * int(weights[min(max(wi, 0), weights.size - 1)]))

    for ins in imem[: max(0, min(n_inst, imem.size))].tolist():
        ins &= 0xFFFF
        e, cc = (ins >> E_BIT) & 1, (ins >> CC_BIT) & 1
        off = ins & OFF_MASK
        if e != prev_e or cc != prev_cc:
            if nonempty:
                row = cls % m_cap if -m_cap <= cls < m_cap else None
                clauses.append((start, len(rows), row, vote(pol, wi)))
                wi += 1
            cls += e != prev_e
            ptr, nonempty, start = 0, False, len(rows)
            pol = 1 if (ins >> P_BIT) & 1 else -1
        prev_e, prev_cc = e, cc
        ptr = _i32(ptr + off)
        if off != EXTEND:
            rows.append(min(max(ptr >> 1, 0), f_cap - 1))
            flips.append(-1 if (ins >> L_BIT) & 1 else 0)
            nonempty = True
    if nonempty:
        clauses.append((start, len(rows), min(max(cls, 0), m_cap - 1),
                        vote(pol, wi)))
    return rows, flips, clauses


class StreamTables(NamedTuple):
    """The decoded stream (int32 tensors), as launch A writes it.

    ``include_row``, ``include_mask`` (0, or -1 for a complemented
    literal) and ``include_clause`` hold one entry per include;
    ``clause_start``/``clause_end`` (a clause's includes), ``clause_row``
    (-1: it lands nowhere) and ``clause_vote`` one per non-empty clause in
    emission order; ``row_first[r]`` (``r`` in [0, m_cap]) is the number
    of the first ``n_mid`` clauses whose class is below ``r``.  The first
    ``n_mid`` clauses are the ones a boundary finalized; a last clause
    past them is the one the end of the stream finalized."""

    include_row: torch.Tensor
    include_mask: torch.Tensor
    include_clause: torch.Tensor
    clause_start: torch.Tensor
    clause_end: torch.Tensor
    clause_row: torch.Tensor
    clause_vote: torch.Tensor
    row_first: torch.Tensor
    n_mid: int


def _wrap32(t: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32, wrapped as the reference's int32 wraps."""
    return ((t + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def decode_stream_plain(
    imem: torch.Tensor,
    n_inst: int,
    f_cap: int,
    m_cap: int,
    wmem: Optional[torch.Tensor],
) -> StreamTables:
    """Decode the live instructions with whole-stream scans, on
    ``imem``'s device: the class is a count of E toggles, the segment (the
    span from one boundary to the next) a count of boundaries, the pointer
    a sum of offsets that restarts at each boundary, the polarity the P
    bit of the segment's boundary, and a clause's ordinal the count of
    non-empty segments before it."""
    dev = imem.device
    n = max(0, min(operator.index(n_inst), imem.numel()))
    ins = imem[:n].to(torch.int64) & 0xFFFF
    e, cc = (ins >> E_BIT) & 1, (ins >> CC_BIT) & 1
    off = ins & OFF_MASK
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    # the first live instruction compares against E = 0, CC = 0
    toggle = e != torch.cat([zero, e[:-1]])
    boundary = toggle | (cc != torch.cat([zero, cc[:-1]]))
    cls = torch.cumsum(toggle, 0) - 1
    seg = torch.cumsum(boundary, 0)  # 0: the segment before any boundary
    idx = torch.arange(n, device=dev)
    head = torch.where(boundary, idx, -1)
    if n:
        head = torch.cummax(head, 0).values
    opened = head >= 0
    at_head = head.clamp(min=0)
    total = torch.cumsum(off, 0)
    ptr = _wrap32(total - torch.where(opened, (total - off)[at_head], 0)).to(torch.int64)
    pol = torch.where(opened & (((ins >> P_BIT) & 1)[at_head] == 0), -1, 1)
    inc = torch.nonzero(off != EXTEND).flatten()
    inc_seg = seg[inc]
    first = torch.ones_like(inc, dtype=torch.bool)
    first[1:] = inc_seg[1:] != inc_seg[:-1]
    include_clause = torch.cumsum(first, 0) - 1
    starts = torch.nonzero(first).flatten()
    n_cl = starts.numel()
    at = inc[starts]  # the instruction of each clause's first include
    c_cls = cls[at]
    final = n_cl > 0 and bool(inc_seg[-1] == seg[-1])
    n_mid = n_cl - int(final)
    row = torch.where((c_cls >= 0) & (c_cls < m_cap), c_cls,
                      torch.where((c_cls >= -m_cap) & (c_cls < 0), c_cls + m_cap, -1))
    if final:
        row[-1] = c_cls[-1].clamp(0, m_cap - 1)
    vote = pol[at]
    if wmem is not None:
        ordinal = torch.arange(n_cl, device=dev).clamp(0, wmem.numel() - 1)
        vote = vote * wmem.to(dev, torch.int64)[ordinal]
    row_first = torch.searchsorted(
        c_cls[:n_mid].contiguous(), torch.arange(m_cap + 1, device=dev)
    )
    i32 = torch.int32
    return StreamTables(
        include_row=(ptr[inc] >> 1).clamp(0, f_cap - 1).to(i32),
        include_mask=-((ins[inc] >> L_BIT) & 1).to(i32),
        include_clause=include_clause.to(i32),
        clause_start=starts.to(i32),
        clause_end=torch.cat([starts[1:], starts.new_tensor([inc.numel()])])[:n_cl].to(i32),
        clause_row=row.to(i32),
        clause_vote=_wrap32(vote),
        row_first=row_first.to(i32),
        n_mid=n_mid,
    )


def interpret_stream_plain(
    imem: torch.Tensor,
    n_inst: int,
    packed_features: torch.Tensor,
    wmem: Optional[torch.Tensor],
    m_cap: int,
) -> torch.Tensor:
    """The interpreter in plain PyTorch -> int32[m_cap, W*32], on any
    device: ``decode_stream_plain``, then the complemented feature words of
    every include gathered at once and a loop over the clauses that ANDs
    each clause word with whole-``W`` tensor ops and adds its unpacked
    bits times its vote to its class row."""
    f_cap, w = packed_features.shape
    dev = packed_features.device
    t = decode_stream_plain(imem.to(dev), n_inst, f_cap, m_cap, wmem)
    sums = torch.zeros((m_cap, w * 32), dtype=torch.int32, device=dev)
    if not t.clause_row.numel():
        return sums
    sel = packed_features[t.include_row] ^ t.include_mask[:, None]  # [includes, W]
    for start, end, row, vote in zip(t.clause_start.tolist(), t.clause_end.tolist(),
                                     t.clause_row.tolist(), t.clause_vote.tolist()):
        if row < 0:
            continue
        acc = sel[start]
        for j in range(start + 1, end):
            acc = acc & sel[j]
        sums[row] += vote * unpack_bits(acc)
    return sums


def _check_operands(imem, wmem, m_cap, packed_features=None):
    dev = imem.device if packed_features is None else packed_features.device
    for name, t in (("imem", imem), ("packed_features", packed_features),
                    ("wmem", wmem)):
        if t is None:
            continue
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device} but the operands on {dev}")
    for name, t in (("imem", imem), ("wmem", wmem)):
        if t is not None and (t.dim() != 1 or t.numel() == 0):
            raise ValueError(
                f"{name} must be a non-empty vector, got {tuple(t.shape)}"
            )
    if packed_features is not None and (
        packed_features.dim() != 2 or 0 in packed_features.shape
    ):
        raise ValueError(
            f"packed_features must be a non-empty [F_cap, W], got "
            f"{tuple(packed_features.shape)}"
        )
    if m_cap < 1:
        raise ValueError(f"m_cap must be positive, got {m_cap}")


def interp_stream(
    imem: torch.Tensor,
    n_inst: int,
    packed_features: torch.Tensor,
    wmem: Optional[torch.Tensor] = None,
    *,
    m_cap: int,
) -> torch.Tensor:
    """Stream interpretation -> int32[m_cap, W*32] class sums.

    ``imem`` int32[I_cap] holds uint16 instructions (bits above 16 are
    ignored); instructions at or past ``n_inst`` are not live.  ``wmem``
    int32[>= 1] is the weight memory, indexed by the finalize ordinal
    (clipped into it); ``None`` votes the polarity alone.  CPU tensors run
    the plain twin; CUDA tensors launch the kernel or raise."""
    n_inst = operator.index(n_inst)
    _check_operands(imem, wmem, m_cap, packed_features)
    dev = packed_features.device
    if dev.type == "cpu":
        return interpret_stream_plain(imem, n_inst, packed_features, wmem, m_cap)
    if dev.type != "cuda":
        raise ValueError(
            f"interp_stream runs on 'cpu' or 'cuda' tensors, got {dev}"
        )
    return _interp_stream_cuda(imem, n_inst, packed_features, wmem, m_cap)


def decode_stream(
    imem: torch.Tensor,
    n_inst: int,
    f_cap: int,
    m_cap: int,
    wmem: Optional[torch.Tensor] = None,
) -> StreamTables:
    """The decode alone -> ``StreamTables``.  CPU tensors run
    ``decode_stream_plain``; CUDA tensors run launch A of the kernel and
    read the tables back to their counts (a sync): the card's tables
    beside the twin's, for the checks."""
    n_inst = operator.index(n_inst)
    _check_operands(imem, wmem, m_cap)
    if f_cap < 1:
        raise ValueError(f"f_cap must be positive, got {f_cap}")
    if imem.device.type == "cpu":
        return decode_stream_plain(imem, n_inst, f_cap, m_cap, wmem)
    if imem.device.type != "cuda":
        raise ValueError(f"decode_stream runs on 'cpu' or 'cuda' tensors, got {imem.device}")
    n_active, scratch = _decode_cuda(imem, n_inst, f_cap, m_cap, wmem)
    n_inc, n_cl, n_mid = scratch[:3].tolist()
    n = max(n_active, 1)
    at = 4 + m_cap + 1
    part = [scratch[at + k * n: at + (k + 1) * n] for k in range(7)]
    return StreamTables(
        *(t[:n_inc] for t in part[:3]), *(t[:n_cl] for t in part[3:]),
        row_first=scratch[4:at], n_mid=n_mid,
    )


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("interp_stream")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.interp_stream_decode.argtypes = [p, i, i, i, p, i, p, p]
    lib.interp_stream_decode.restype = i
    lib.interp_stream_launch.argtypes = [p, i, p, i, i, p, i, i, p, p, p]
    lib.interp_stream_launch.restype = i
    lib.interp_stream_scratch_words.argtypes = [i, i]
    lib.interp_stream_scratch_words.restype = ctypes.c_longlong
    return lib


def _operands(imem, wmem):
    tensors = [imem] + ([] if wmem is None else [wmem])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("interp_stream operands must be contiguous")
    return (None if wmem is None else wmem.data_ptr(),
            0 if wmem is None else wmem.numel())


def _scratch(n_active, m_cap, dev):
    """Launch A's tables: 4 header words (includes, clauses, clauses a
    boundary finalized, 0), ``row_first`` [m_cap + 1], seven vectors of
    max(n_active, 1) words (include row, mask and clause, clause start,
    end, row and vote), then the decode's look-back words."""
    words = _lib().interp_stream_scratch_words(n_active, m_cap)
    return torch.empty(words, dtype=torch.int32, device=dev)


def _decode_cuda(imem, n_inst, f_cap, m_cap, wmem):
    if m_cap > MAX_M_CAP:
        raise ValueError(f"the interp_stream kernel takes m_cap <= {MAX_M_CAP}, got {m_cap}")
    w_ptr, n_weights = _operands(imem, wmem)
    n_active = max(0, min(n_inst, imem.numel()))
    scratch = _scratch(n_active, m_cap, imem.device)
    err = _lib().interp_stream_decode(
        imem.data_ptr(), n_active, f_cap, m_cap, w_ptr, n_weights,
        scratch.data_ptr(), _build.stream(imem.device),
    )
    _build.raise_on("interp_stream", err, "interp_stream decode")
    _build.count_launches(__name__, 1)
    return n_active, scratch


def _interp_stream_cuda(imem, n_inst, packed_features, wmem, m_cap):
    f_cap, w = packed_features.shape
    if m_cap > MAX_M_CAP or f_cap * w >= MAX_FEATURE_WORDS:
        raise ValueError(
            f"the interp_stream kernel takes m_cap <= {MAX_M_CAP} and F_cap * W "
            f"< {MAX_FEATURE_WORDS}, got m_cap={m_cap}, F_cap={f_cap}, W={w}"
        )
    w_ptr, n_weights = _operands(imem, wmem)
    if not packed_features.is_contiguous():
        raise ValueError("interp_stream operands must be contiguous")
    n_active = max(0, min(n_inst, imem.numel()))
    dev = packed_features.device
    scratch = _scratch(n_active, m_cap, dev)
    # the evaluation stores every element, zeros in rows no clause reaches
    out = torch.empty((m_cap, 32 * w), dtype=torch.int32, device=dev)
    err = _lib().interp_stream_launch(
        imem.data_ptr(), n_active, packed_features.data_ptr(), f_cap, w,
        w_ptr, n_weights, m_cap, scratch.data_ptr(), out.data_ptr(),
        _build.stream(dev),
    )
    _build.raise_on("interp_stream", err, "interp_stream")
    _build.count_launches(__name__, 2)
    return out
