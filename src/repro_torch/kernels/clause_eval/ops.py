"""Public wrapper of the dense clause path: full class sums through the
``clause_eval`` kernel (the twin of ``repro.kernels.clause_eval.ops``)."""

from __future__ import annotations

import torch

from .kernel import clause_eval
from .ref import class_sums_from_clause_words


def tm_dense_class_sums(
    actions: torch.Tensor,  # {0,1}[M, C, 2F]
    packed_lits: torch.Tensor,  # int32[2F, W]
    *,
    n_classes: int,
) -> torch.Tensor:
    """Full dense bitpacked TM inference -> int32[M, W*32] class sums.

    Clause evaluation runs in the kernel (its plain twin on the CPU); the
    polarity sum is plain PyTorch on the kernel's words."""
    m, c, l2 = actions.shape
    clause_words = clause_eval(actions.reshape(m * c, l2), packed_lits)
    idx = torch.arange(c, device=actions.device)
    pol = torch.where(idx % 2 == 0, 1, -1).to(torch.int32).repeat(m)
    return class_sums_from_clause_words(clause_words, pol, n_classes)
