"""Compressed-domain TM inference engines, the port of
``repro.core.interp``.

Two execution strategies over the SAME instruction stream (compress.py):

1. ``interpret_stream`` — the paper-faithful interpreter: the stream is
   walked like the eFPGA's fetch/decode/select/accumulate pipeline (Fig
   4.4-4.6, Fig 5) with a literal pointer, a clause accumulator of ``W``
   bit-packed words (32 datapoints per word), class-sum accumulators and
   toggle-bit boundary detection.  On CUDA tensors it is the hand-written
   kernel ``kernels.interp_stream`` (``csrc/interp_stream.cu``); on CPU
   tensors its plain twin.  Buffers are fixed capacity with dynamic
   counts, so a new model, task or input dimensionality never changes an
   operand shape.

2. ``plan_class_sums`` — the decoded-plan executor: the offset chains are
   prefix-summed once at program time (``compress.decode_to_plan``);
   inference is then a literal gather, a segmented AND (min) and a
   segmented polarity sum, in plain PyTorch on either device (the
   reference computes it in XLA, not in a kernel).

Both match dense inference (``tm.batch_class_sums``) bit-exactly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.interp_stream.kernel import interp_stream
from .bits import wrap_i32


def pack_features(x, n_feature_cap: int, n_word_cap: int) -> torch.Tensor:
    """{0,1}[B, F] -> int32[F_cap, W_cap] feature memory (bit b of word w =
    datapoint w*32+b; uint32 bit patterns), on the device of ``x``.  B must
    be <= 32*W_cap; F <= F_cap."""
    x = torch.as_tensor(x)
    B, nf = x.shape
    if nf > n_feature_cap:
        raise ValueError(
            f"input dimensionality F={nf} exceeds feature capacity "
            f"{n_feature_cap}; resynthesize with a larger feature_capacity"
        )
    if B > 32 * n_word_cap:
        raise ValueError(
            f"batch B={B} exceeds the {32 * n_word_cap} datapoints of "
            f"batch_words={n_word_cap}; stream in chunks or resynthesize "
            f"with more batch_words"
        )
    W = (B + 31) // 32
    xp = F.pad(x.to(torch.int64), (0, n_feature_cap - nf, 0, W * 32 - B))
    xp = xp.T.reshape(n_feature_cap, W, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    words = wrap_i32((xp << shifts).sum(dim=-1) & 0xFFFFFFFF)
    return F.pad(words, (0, n_word_cap - W))


# ---------------------------------------------------------------------------
# 1. Paper-faithful stream interpreter
# ---------------------------------------------------------------------------

def interpret_stream(
    instructions: torch.Tensor,  # int32[I_cap] holding uint16 instructions
    n_instructions: int,  # Instruction Header field
    packed_features: torch.Tensor,  # int32[F_cap, W] feature memory
    n_datapoints: int,  # Feature Header field
    clause_weights: "torch.Tensor | None" = None,  # int32[>=Ncl'] emission order
    *,
    m_cap: int,  # class-sum accumulator depth ("synthesis-time" choice)
) -> torch.Tensor:
    """Execute the compressed model -> int32[m_cap, W*32] class sums.

    Rows >= the stream's class count stay 0; datapoint columns >=
    n_datapoints are garbage (caller slices).  ``clause_weights`` holds
    one vote weight per non-empty clause in stream emission order, the
    order the interpreter finalizes clauses in; ``None`` votes ``pol``.
    The rules on malformed streams are ``kernels.interp_stream``'s."""
    del n_datapoints  # columns beyond the count are sliced by the caller
    return interp_stream(
        instructions, int(n_instructions), packed_features, clause_weights,
        m_cap=m_cap,
    )


def interpret_predict(
    instructions: torch.Tensor,
    n_instructions: int,
    packed_features: torch.Tensor,
    n_datapoints: int,
    n_classes: int,
    *,
    m_cap: int,
) -> torch.Tensor:
    """argmax over valid class rows -> int32[W*32] predictions."""
    sums = interpret_stream(
        instructions, n_instructions, packed_features, n_datapoints, m_cap=m_cap
    )
    valid = torch.arange(m_cap, device=sums.device) < int(n_classes)
    masked = torch.where(valid[:, None], sums, torch.iinfo(torch.int32).min)
    return masked.argmax(dim=0).to(torch.int32)


# ---------------------------------------------------------------------------
# 2. Decoded-plan executor (beyond-paper, parallel)
# ---------------------------------------------------------------------------

def plan_class_sums(
    lit_idx: torch.Tensor,  # int32[I_cap] absolute literal slot (padded)
    clause_id: torch.Tensor,  # int32[I_cap] global clause id; padded -> n_clause_cap
    clause_class: torch.Tensor,  # int32[Ncl_cap]
    clause_pol: torch.Tensor,  # int32[Ncl_cap] +1/-1 (weighted: w*pol; padded 0)
    lits: torch.Tensor,  # bool[B, 2F] literal matrix
    *,
    n_clause_cap: int,
    m_cap: int,
) -> torch.Tensor:
    """Gather + segmented reduction form -> int32[B, m_cap] class sums."""
    B = lits.shape[0]
    sel = lits[:, lit_idx.long()].to(torch.int32)  # [B, I]
    # segmented AND == segmented min over {0,1}; padded instructions (and
    # ids outside [0, n_clause_cap), which the reference's segment ops
    # drop) land in an extra sink segment that is cut off
    cid = clause_id.long()
    cid = torch.where((cid >= 0) & (cid < n_clause_cap), cid, n_clause_cap)
    clause_out = torch.zeros(
        (n_clause_cap + 1, B), dtype=torch.int32, device=lits.device
    ).scatter_reduce_(
        0, cid[:, None].expand(-1, B), sel.T, "amin", include_self=False
    )[:n_clause_cap]
    has_content = torch.bincount(cid, minlength=n_clause_cap + 1)[:n_clause_cap] > 0
    clause_out = torch.where(has_content[:, None], clause_out, 0)
    contrib = clause_out * clause_pol[:, None]  # [Ncl_cap, B]
    sums = torch.zeros((m_cap, B), dtype=torch.int32, device=lits.device)
    sums.index_add_(0, clause_class.long().clamp(0, m_cap - 1), contrib)
    return sums.T


def pad_plan(plan, i_cap: int, n_clause_cap: int):
    """Host-side: pad a DecodedPlan to fixed capacities (numpy int32).

    Clause weights fold straight into the polarity operand (``cp = weight
    * pol``): the segmented reduction is already a multiply-accumulate
    against ``cp``, so weighted execution is the same operand signature."""
    li = np.zeros(i_cap, dtype=np.int32)
    ci = np.full(i_cap, n_clause_cap, dtype=np.int32)  # sink segment
    li[: plan.n_includes] = plan.lit_idx
    ci[: plan.n_includes] = plan.clause_id
    cc = np.zeros(n_clause_cap, dtype=np.int32)
    cp = np.zeros(n_clause_cap, dtype=np.int32)
    cc[: plan.n_clauses_total] = plan.clause_class
    cp[: plan.n_clauses_total] = plan.weighted_pol
    return li, ci, cc, cp
