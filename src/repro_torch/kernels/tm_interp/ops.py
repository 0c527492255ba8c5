"""Host-side operand flattening shared by the interpreter and popcount
paths.  The ``tm_interp`` kernel itself is not ported yet; only
``plan_to_operands`` is, because the popcount program build reuses it."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ...core.compress import DecodedPlan


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
