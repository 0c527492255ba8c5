"""Public wrappers of the plan interpreter (the twin of
``repro.kernels.tm_interp.ops``): ``DecodedPlan`` -> per-instruction
operand vectors (``plan_to_operands``, which the popcount program build
reuses) -> the operands and clause table on the device in one copy
(``compressed_operands``) -> class sums through the ``tm_interp`` kernel
(``tm_compressed_class_sums``), and the literal packing it takes."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.compress import DecodedPlan
from ...core.tm import pack_literals
from .kernel import tm_interp


def plan_to_operands(
    plan: DecodedPlan, i_cap: int, m_cap: int | None = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flatten the plan into per-instruction operand vectors
    ``(lit_idx, last, pol, cls)``, each int32[i_cap].

    Padded slots AND literal row 0 forever and never emit (last=0).
    When ``m_cap`` is given, class ids are validated against the class-sum
    bank depth here, at program-build time, and a bad id raises
    ``ValueError`` naming the offending instruction.
    """
    n_inc = plan.n_includes
    if n_inc > i_cap:
        raise ValueError(
            f"plan has {n_inc} includes; instruction capacity {i_cap}"
        )
    lit_idx = np.zeros(i_cap, np.int32)
    last = np.zeros(i_cap, np.int32)
    pol = np.zeros(i_cap, np.int32)
    cls = np.zeros(i_cap, np.int32)
    lit_idx[:n_inc] = plan.lit_idx
    # last include of each clause = where clause_id changes (or stream ends)
    if n_inc > 0:
        boundary = np.ones(n_inc, bool)
        boundary[:-1] = plan.clause_id[1:] != plan.clause_id[:-1]
        last[:n_inc] = boundary.astype(np.int32)
        pol[:n_inc] = plan.clause_pol[plan.clause_id]
        cls[:n_inc] = plan.clause_class[plan.clause_id]
        if m_cap is not None:
            bad = np.flatnonzero(
                (cls[:n_inc] < 0) | (cls[:n_inc] >= m_cap)
            )
            if bad.size:
                t = int(bad[0])
                raise ValueError(
                    f"instruction {t}: class id {int(cls[t])} out of range "
                    f"for class capacity m_cap={m_cap}; refusing to build a "
                    f"program that would corrupt the class-sum bank"
                )
    return lit_idx, last, pol, cls


def clause_ends(last: np.ndarray) -> np.ndarray:
    """int32 indices of the emitting instructions: clause k covers the
    includes ``(ends[k-1], ends[k]]`` (from 0 for k = 0)."""
    return np.flatnonzero(np.asarray(last) == 1).astype(np.int32)


def compressed_operands(
    plan: DecodedPlan, i_cap: int, m_cap: int, device: torch.device
) -> Tuple[torch.Tensor, ...]:
    """The interpreter's operands and clause table on ``device``:
    ``(lit_idx, last, pol, cls, clause_end)``, int32 vectors built on the
    host (``plan_to_operands``, ``clause_ends``) into one buffer and moved
    with one copy; each is a contiguous view of it."""
    lit_idx, last, pol, cls = plan_to_operands(plan, i_cap, m_cap=m_cap)
    parts = (lit_idx, last, pol, cls, clause_ends(last))
    buf = torch.from_numpy(np.concatenate(parts)).to(device)
    return buf.split([a.size for a in parts])


def tm_compressed_class_sums(
    plan: DecodedPlan,
    packed_lits: torch.Tensor,  # int32[2F, W] (interleaved literal rows)
    *,
    m_cap: int,
    i_cap: int,
) -> torch.Tensor:
    """Compressed inference via the interpreter -> int32[m_cap, B], on the
    device of ``packed_lits`` (the kernel on CUDA, its plain twin on the
    CPU).  The operands and the clause table are built here, on the host,
    and reach the device in one copy."""
    *ops, ends = compressed_operands(plan, i_cap, m_cap, packed_lits.device)
    return tm_interp(*ops, packed_lits, m_cap=m_cap, clause_end=ends)


def pack_interleaved_literals(x: torch.Tensor) -> torch.Tensor:
    """{0,1}[B, F] -> int32[2F, W] with complement rows interleaved; the
    batch is padded with zero rows to a whole number of words."""
    return pack_literals(F.pad(x, (0, 0, 0, -x.shape[0] % 32)))
