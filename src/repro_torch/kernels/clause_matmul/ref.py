"""Integer oracle of the matrix-product clause evaluation, the twin of
``repro.kernels.clause_matmul.ref``.

A clause fires iff NO included literal is 0, i.e.

    violations[c, b] = sum_k A[c, k] * (1 - lits[k, b])
    clause_out[c, b] = (violations == 0) & nonempty[c]

here in int64 on the CPU's integer matmul, with no float rounding to
argue about.
"""

from __future__ import annotations

import torch


def clause_matmul_ref(actions: torch.Tensor, lits: torch.Tensor) -> torch.Tensor:
    """actions: {0,1}[NC, L2] ; lits: {0,1}[L2, B] -> bool[NC, B]."""
    a = actions.to(torch.int64).cpu()
    viol = a @ (1 - lits.to(torch.int64).cpu())
    nonempty = a.sum(dim=1, keepdim=True) > 0
    return ((viol == 0) & nonempty).to(actions.device)
