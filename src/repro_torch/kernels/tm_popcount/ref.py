"""Sequential PyTorch oracle for the popcount bitplane kernel.

Deliberately naive, like ``repro.kernels.tm_popcount.ref``: one
instruction per Python step, reading the class routing straight out of
the packed polarity-bank bitplanes (bit j of mask chunk ``t // 32``
selects instruction t), expanding the clause word and adding it — none
of the kernel's tricks.  Also takes 3-D weight-plane masks (plane b
counts ``<< b``), which the reference oracle does not.
"""

from __future__ import annotations

import torch

from ...core.tm import unpack_bits


def tm_popcount_ref(
    lit_idx: torch.Tensor,  # int32[I]  literal slot per include
    last_flag: torch.Tensor,  # int32[I] 1 = last include of its clause
    mask_pos: torch.Tensor,  # int32[(P,) m_cap, ceil(I/32)]
    mask_neg: torch.Tensor,
    packed_lits: torch.Tensor,  # int32[L2, W]
) -> torch.Tensor:
    """Sequential oracle -> int32[m_cap, W*32] class sums."""
    pos = mask_pos[None] if mask_pos.dim() == 2 else mask_pos
    neg = mask_neg[None] if mask_neg.dim() == 2 else mask_neg
    scale = torch.tensor(
        [1 << b for b in range(pos.shape[0])], dtype=torch.int32,
        device=pos.device,
    )[:, None]
    acc = torch.full_like(packed_lits[0], -1)  # all ones
    sums = torch.zeros(
        (pos.shape[1], packed_lits.shape[1] * 32), dtype=torch.int32,
        device=packed_lits.device,
    )
    for t in range(lit_idx.shape[0]):
        acc = acc & packed_lits[int(lit_idx[t])]
        if int(last_flag[t]) != 1:
            continue
        chunk, bit = t // 32, t % 32
        if chunk < pos.shape[2]:  # chunks past the masks select nothing
            sel = ((pos[:, :, chunk] >> bit) & 1) - ((neg[:, :, chunk] >> bit) & 1)
            gate = (sel * scale).sum(dim=0)  # int32[m_cap]
            sums += gate[:, None] * unpack_bits(acc)[None, :]
        acc = torch.full_like(acc, -1)
    return sums
