"""Step-by-step oracle of the stream interpreter, the scan of
``repro.core.interp.interpret_stream`` written out one instruction at a
time over numpy words, with none of the twin's or the kernel's tricks.
For the tests only."""

from __future__ import annotations

import numpy as np
import torch

from ...core.compress import CC_BIT, E_BIT, L_BIT, OFF_MASK, P_BIT


def _i32(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def interpret_stream_ref(
    imem: torch.Tensor,  # int32[I_cap] holding uint16 instructions
    n_inst: int,
    packed_features: torch.Tensor,  # int32[F_cap, W]
    wmem: "torch.Tensor | None",  # int32[>= 1] or None (weight 1)
    m_cap: int,
) -> torch.Tensor:
    """-> int32[m_cap, W*32] class sums, as the reference's scan."""
    ins_all = imem.cpu().numpy().astype(np.int64) & 0xFFFF
    feats = packed_features.cpu().numpy().view(np.uint32)
    weights = None if wmem is None else wmem.cpu().numpy().astype(np.int64)
    f_cap, w = feats.shape
    sums = np.zeros((m_cap, w * 32), np.int64)
    bits = np.arange(32, dtype=np.uint32)

    def finalize(cls, pol, acc, wi):
        vote = pol if weights is None else _i32(
            pol * int(weights[min(max(wi, 0), weights.size - 1)])
        )
        if -m_cap <= cls < m_cap:  # a scatter wraps -1 and drops the rest
            sums[cls] += vote * ((acc[:, None] >> bits) & 1).reshape(-1).astype(np.int64)

    ptr, cls, pol, wi = 0, -1, 1, 0
    acc = np.full(w, 0xFFFFFFFF, np.uint32)
    nonempty, prev_e, prev_cc = False, 0, 0
    for i in range(ins_all.size):
        if i >= n_inst:
            break  # an inactive step changes nothing
        ins = int(ins_all[i])
        e, cc = (ins >> E_BIT) & 1, (ins >> CC_BIT) & 1
        p, lbit, off = (ins >> P_BIT) & 1, (ins >> L_BIT) & 1, ins & OFF_MASK
        if e != prev_e or cc != prev_cc:
            if nonempty:
                finalize(cls, pol, acc, wi)
                wi += 1
            cls += e != prev_e
            ptr, nonempty = 0, False
            acc = np.full(w, 0xFFFFFFFF, np.uint32)
            pol = 1 if p == 1 else -1
        prev_e, prev_cc = e, cc
        ptr = _i32(ptr + off)  # EXTEND's offset field is its 4095 slots
        if off != OFF_MASK:
            word = feats[min(max(ptr >> 1, 0), f_cap - 1)]
            acc = acc & (~word if lbit else word)
            nonempty = True
    if nonempty:
        finalize(min(max(cls, 0), m_cap - 1), pol, acc, wi)
    out = ((sums + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    return torch.from_numpy(out).to(packed_features.device)
