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

``interp_stream`` is the one entry point.  On CPU tensors it runs
``interpret_stream_plain``; on CUDA tensors it launches the Hopper kernel
of ``csrc/interp_stream.cu`` or raises; there is no fallback between the
two.  ``launches`` counts the CUDA launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import Optional

import numpy as np
import torch

from ...core.compress import CC_BIT, E_BIT, EXTEND, L_BIT, OFF_MASK, P_BIT
from ...core.tm import unpack_bits
from .. import _build

# CUDA kernel launches made by interp_stream (the plain twin never counts)
launches = 0

# the kernel stages a word's feature column and its class-sum bank in
# shared memory: 4 * (F_cap + 32 * m_cap) bytes of a block's 227 KB
MAX_SHARED_WORDS = 232448 // 4


def _i32(v: int) -> int:
    """``v`` wrapped to int32, as the reference's int32 carry wraps."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _decode(imem: np.ndarray, n_inst: int, f_cap: int, m_cap: int, weights):
    """Walk the live instructions once on the host -> (feature row and
    complement mask of every include, finalized clauses as (first
    include, end include, class row or None, vote))."""
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


def interpret_stream_plain(
    imem: torch.Tensor,
    n_inst: int,
    packed_features: torch.Tensor,
    wmem: Optional[torch.Tensor],
    m_cap: int,
) -> torch.Tensor:
    """The interpreter in plain PyTorch -> int32[m_cap, W*32], on any
    device: the instruction fields are decoded once on the host, the
    complemented feature words of every include gathered at once, then a
    loop over the includes ANDs each clause word with whole-``W`` tensor
    ops and adds its unpacked bits times its vote to its class row."""
    f_cap, w = packed_features.shape
    dev = packed_features.device
    weights = None if wmem is None else wmem.cpu().numpy().astype(np.int64)
    rows, flips, clauses = _decode(
        imem.cpu().numpy().astype(np.int64), n_inst, f_cap, m_cap, weights
    )
    sums = torch.zeros((m_cap, w * 32), dtype=torch.int32, device=dev)
    if not clauses:
        return sums
    sel = packed_features[torch.tensor(rows, device=dev)] ^ torch.tensor(
        flips, dtype=torch.int32, device=dev
    )[:, None]  # [includes, W]
    for start, end, row, vote in clauses:
        if row is None:
            continue
        acc = sel[start]
        for j in range(start + 1, end):
            acc = acc & sel[j]
        sums[row] += vote * unpack_bits(acc)
    return sums


def _check_operands(imem, packed_features, wmem, m_cap):
    for name, t in (("imem", imem), ("packed_features", packed_features),
                    ("wmem", wmem)):
        if t is None:
            continue
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != packed_features.device:
            raise ValueError(
                f"{name} is on {t.device} but packed_features on "
                f"{packed_features.device}"
            )
    for name, t in (("imem", imem), ("wmem", wmem)):
        if t is not None and (t.dim() != 1 or t.numel() == 0):
            raise ValueError(
                f"{name} must be a non-empty vector, got {tuple(t.shape)}"
            )
    if packed_features.dim() != 2 or 0 in packed_features.shape:
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
    _check_operands(imem, packed_features, wmem, m_cap)
    dev = packed_features.device
    if dev.type == "cpu":
        return interpret_stream_plain(imem, n_inst, packed_features, wmem, m_cap)
    if dev.type != "cuda":
        raise ValueError(
            f"interp_stream runs on 'cpu' or 'cuda' tensors, got {dev}"
        )
    return _interp_stream_cuda(imem, n_inst, packed_features, wmem, m_cap)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("interp_stream")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.interp_stream_launch.argtypes = [p, i, p, i, i, p, i, i, p, p]
    lib.interp_stream_launch.restype = i
    return lib


def _interp_stream_cuda(imem, n_inst, packed_features, wmem, m_cap):
    global launches
    f_cap, w = packed_features.shape
    if f_cap + 32 * m_cap > MAX_SHARED_WORDS:
        raise ValueError(
            f"the interp_stream kernel takes F_cap + 32 * m_cap <= "
            f"{MAX_SHARED_WORDS}, got F_cap={f_cap} and m_cap={m_cap}"
        )
    tensors = [imem, packed_features] + ([] if wmem is None else [wmem])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("interp_stream operands must be contiguous")
    n_active = max(0, min(n_inst, imem.numel()))
    # the kernel stores every element, zeros in rows no clause reaches
    out = torch.empty((m_cap, 32 * w), dtype=torch.int32,
                      device=packed_features.device)
    err = _lib().interp_stream_launch(
        imem.data_ptr(), n_active, packed_features.data_ptr(), f_cap, w,
        None if wmem is None else wmem.data_ptr(),
        0 if wmem is None else wmem.numel(), m_cap, out.data_ptr(),
        _build.stream(packed_features.device),
    )
    _build.raise_on("interp_stream", err, "interp_stream")
    launches += 1
    return out
