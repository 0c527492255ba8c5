"""Sequential oracle of the plan interpreter, the twin of
``repro.kernels.tm_interp.ref``: one instruction per Python step, none
of the kernel's tricks.  For the tests only."""

from __future__ import annotations

import torch

from ...core.tm import unpack_bits


def tm_interp_ref(
    lit_idx: torch.Tensor,  # int32[I]  literal slot per include
    last_flag: torch.Tensor,  # int32[I] 1 = last include of its clause
    pol: torch.Tensor,  # int32[I]  clause polarity (+1/-1), read when last
    cls: torch.Tensor,  # int32[I]  class id, read when last
    packed_lits: torch.Tensor,  # int32[L2, W]
    m_cap: int,
) -> torch.Tensor:
    """Sequential oracle -> int32[m_cap, W*32] class sums.

    Padded instruction slots must have last_flag == 0 and follow all real
    instructions (their ANDs can only corrupt a clause that never emits).
    """
    l2, w = packed_lits.shape
    acc = torch.full((w,), -1, dtype=torch.int32)  # all ones
    sums = torch.zeros((m_cap, w * 32), dtype=torch.int32)
    for t in range(lit_idx.shape[0]):
        acc = acc & packed_lits[min(max(int(lit_idx[t]), 0), l2 - 1)].cpu()
        if int(last_flag[t]) == 1:
            row = min(max(int(cls[t]), 0), m_cap - 1)
            sums[row] += int(pol[t]) * unpack_bits(acc)
            acc = torch.full_like(acc, -1)
    return sums.to(packed_lits.device)
