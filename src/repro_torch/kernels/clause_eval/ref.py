"""Plain oracles of the dense clause path, the twins of
``repro.kernels.clause_eval.ref``.

``clause_eval_ref`` evaluates clauses one bit at a time (unpack, ``all``,
repack), none of the kernel's word-wise tricks; ``class_sums_from_clause_words``
is the polarity sum that ``ops.tm_dense_class_sums`` applies to the
kernel's words.
"""

from __future__ import annotations

import torch

from ...core.bits import wrap_i32
from ...core.tm import unpack_bits


def clause_eval_ref(actions: torch.Tensor, packed_lits: torch.Tensor) -> torch.Tensor:
    """Dense bitpacked clause evaluation.

    actions:     {0,1}[NC, L2]   include mask (NC = flattened class*clause)
    packed_lits: int32[L2, W]    batch-bitpacked literals
    returns:     int32[NC, W]    clause output words; empty clause -> 0
                                 (inference semantics)
    """
    include = actions.to(torch.bool)
    bits = unpack_bits(packed_lits).to(torch.bool)  # [L2, 32W]
    fired = torch.stack([bits[row].all(dim=0) for row in include])  # [NC, 32W]
    fired &= include.any(dim=1, keepdim=True)
    nc, w = fired.shape[0], packed_lits.shape[1]
    shifts = torch.arange(32, dtype=torch.int64, device=fired.device)
    words = (fired.reshape(nc, w, 32).to(torch.int64) << shifts).sum(dim=-1)
    return wrap_i32(words)


def class_sums_from_clause_words(
    clause_words: torch.Tensor, pol: torch.Tensor, n_classes: int
) -> torch.Tensor:
    """int32[M*C, W], int32[M*C] -> int32[M, W*32]."""
    mc, w = clause_words.shape
    contrib = unpack_bits(clause_words) * pol[:, None].to(torch.int32)
    return contrib.reshape(n_classes, mc // n_classes, w * 32).sum(
        dim=1, dtype=torch.int32
    )
