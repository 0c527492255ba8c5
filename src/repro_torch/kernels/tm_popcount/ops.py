"""Host-side program build for the popcount bitplane path.

``DecodedPlan -> (lit_idx, last, mask_pos, mask_neg)``: the per-include
operand vectors of the interpreter path plus the per-class polarity-bank
selection bitplanes the popcount reduction keys on (numpy, bit-identical
to ``repro.kernels.tm_popcount.ops``); ``build_program`` turns them into
the kernel's ``PopcountProgram`` on a device.  A malformed program is rejected
here: a class id outside the accumulator bank or a literal slot outside
the feature memory raises ``ValueError`` naming the instruction.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...core.bits import from_u32
from ...core.compress import DecodedPlan
from ..tm_interp.ops import clause_ends, plan_to_operands
from .kernel import PopcountProgram, popcount_program, tm_popcount


def pack_class_masks(
    last: np.ndarray,  # int32[I_cap] 1 = clause boundary (emit)
    pol: np.ndarray,  # int32[I_cap] +1/-1, read where last == 1
    cls: np.ndarray,  # int32[I_cap] class id, read where last == 1
    m_cap: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Emit metadata -> packed polarity banks uint32[m_cap, ceil(I/32)].

    Bit j of chunk c in ``mask_pos[m]`` selects instruction ``32c + j``
    iff it emits a positive clause of class m (``mask_neg`` likewise for
    negative clauses).  Raises on class ids outside ``[0, m_cap)`` at an
    emitting instruction.
    """
    last = np.asarray(last)
    i_cap = last.shape[0]
    emitting = np.flatnonzero(last == 1)
    bad = emitting[(cls[emitting] < 0) | (cls[emitting] >= m_cap)]
    if bad.size:
        t = int(bad[0])
        raise ValueError(
            f"instruction {t}: class id {int(cls[t])} out of range for "
            f"class capacity m_cap={m_cap}; refusing to build a program "
            f"that would corrupt the class-sum bank"
        )
    n_chunks = -(-i_cap // 32)
    mask_pos = np.zeros((m_cap, n_chunks), np.uint32)
    mask_neg = np.zeros((m_cap, n_chunks), np.uint32)
    bit = np.uint32(1) << (emitting % 32).astype(np.uint32)
    chunk = emitting // 32
    for bank, sign in ((mask_pos, 1), (mask_neg, -1)):
        sel = pol[emitting] == sign
        np.bitwise_or.at(bank, (cls[emitting][sel], chunk[sel]), bit[sel])
    return mask_pos, mask_neg


def pack_class_masks_weighted(
    last: np.ndarray,  # int32[I_cap] 1 = clause boundary (emit)
    pol: np.ndarray,  # int32[I_cap] +1/-1, read where last == 1
    cls: np.ndarray,  # int32[I_cap] class id, read where last == 1
    weights: np.ndarray,  # int32[I_cap] clause weight, read where last == 1
    m_cap: int,
    weight_planes: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted emit metadata -> bitplane-decomposed polarity banks
    ``uint32[weight_planes, m_cap, ceil(I/32)]``.

    Plane ``b`` selects instruction ``32c + j`` iff it emits a clause of
    that class AND bit ``b`` of the clause's weight is set, so the
    reduction recovers ``weight * clause_output`` as ``sum_b (popcount <<
    b)``.  Raises when a weight needs more planes than provisioned."""
    weights = np.asarray(weights)
    emitting = np.flatnonzero(np.asarray(last) == 1)
    w_emit = weights[emitting]
    if emitting.size:
        need = int(w_emit.max()).bit_length()
        if need > weight_planes:
            t = int(emitting[int(np.argmax(w_emit))])
            raise ValueError(
                f"instruction {t}: clause weight {int(weights[t])} needs "
                f"{need} bitplanes but the plan provisions "
                f"weight_planes={weight_planes}; re-negotiate the envelope"
            )
    planes = []
    for b in range(weight_planes):
        sel = np.zeros_like(np.asarray(last))
        sel[emitting] = (w_emit >> b) & 1
        planes.append(pack_class_masks(last * sel, pol, cls, m_cap))
    mask_pos = np.stack([p for p, _ in planes])
    mask_neg = np.stack([n for _, n in planes])
    return mask_pos, mask_neg


def plan_to_popcount_operands(
    plan: DecodedPlan,
    i_cap: int,
    m_cap: int,
    *,
    l2_cap: int | None = None,
    weight_planes: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flatten and validate the plan into popcount operands.

    Literal slots are bounds-checked against ``l2_cap`` when given;
    ``pack_class_masks`` owns the class-capacity check.  ``weight_planes``
    sets the mask layout: ``None`` keeps 2-D banks for weightless plans
    (and sizes 3-D banks for weighted ones); an int always builds 3-D
    ``[P, m_cap, chunks]`` banks at exactly that depth — what the popcount
    engine pins so weighted/weightless swaps keep one operand shape.
    """
    lit_idx, last, pol, cls = plan_to_operands(plan, i_cap)
    if l2_cap is not None and plan.n_includes > 0:
        bad = np.flatnonzero(
            (lit_idx[: plan.n_includes] < 0)
            | (lit_idx[: plan.n_includes] >= l2_cap)
        )
        if bad.size:
            t = int(bad[0])
            raise ValueError(
                f"instruction {t}: literal slot {int(lit_idx[t])} out of "
                f"range for feature memory depth {l2_cap}"
            )
    if weight_planes is None and plan.clause_weight is None:
        mask_pos, mask_neg = pack_class_masks(last, pol, cls, m_cap)
        return lit_idx, last, mask_pos, mask_neg
    planes = plan.weight_planes if weight_planes is None else weight_planes
    wts = np.ones(i_cap, np.int32)
    if plan.n_includes > 0:
        wts[: plan.n_includes] = plan.weights[plan.clause_id]
    mask_pos, mask_neg = pack_class_masks_weighted(
        last, pol, cls, wts, m_cap, planes
    )
    return lit_idx, last, mask_pos, mask_neg


def build_program(
    plan: DecodedPlan,
    i_cap: int,
    m_cap: int,
    *,
    l2_cap: int | None,
    weight_planes: int | None,
    device: torch.device,
) -> PopcountProgram:
    """``plan_to_popcount_operands`` + ``popcount_program``, built on the
    host; each tensor reaches ``device`` with one copy."""
    lit_idx, last, mask_pos, mask_neg = plan_to_popcount_operands(
        plan, i_cap, m_cap, l2_cap=l2_cap, weight_planes=weight_planes
    )
    return popcount_program(
        torch.from_numpy(lit_idx), torch.from_numpy(last),
        from_u32(mask_pos), from_u32(mask_neg),
    ).to(device)


def tm_popcount_class_sums(
    plan: DecodedPlan,
    packed_lits: torch.Tensor,  # int32[2F, W] (interleaved literal rows)
    *,
    m_cap: int,
    i_cap: int,
) -> torch.Tensor:
    """Compressed inference via the popcount path -> int32[m_cap, B], on
    the device of ``packed_lits`` (the kernel on CUDA, its plain twin on
    the CPU)."""
    program = build_program(
        plan, i_cap, m_cap, l2_cap=int(packed_lits.shape[0]),
        weight_planes=None, device=packed_lits.device,
    )
    return tm_popcount(program, packed_lits)
