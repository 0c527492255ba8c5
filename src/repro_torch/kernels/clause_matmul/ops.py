"""Public wrapper of the matrix-product clause path: full class sums
through the ``clause_matmul`` kernel (the twin of
``repro.kernels.clause_matmul.ops``)."""

from __future__ import annotations

import torch

from .kernel import clause_matmul


def tm_matmul_class_sums(
    actions: torch.Tensor,  # {0,1}[M, C, 2F]
    lits: torch.Tensor,  # {0,1}[2F, B], interleaved literal rows, unpacked
    *,
    n_classes: int,
) -> torch.Tensor:
    """-> int32[M, B] class sums (matrix-product formulation)."""
    m, c, l2 = actions.shape
    fired = clause_matmul(actions.reshape(m * c, l2), lits)
    idx = torch.arange(c, device=actions.device)
    pol = torch.where(idx % 2 == 0, 1, -1).to(torch.int32).repeat(m)
    contrib = fired * pol[:, None]
    return contrib.reshape(m, c, -1).sum(dim=1, dtype=torch.int32)
