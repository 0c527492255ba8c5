"""Include-only instruction compression (paper §2, Fig 3.4).

Numpy throughout; the stream and plan it builds are byte-identical to
``repro.core.compress`` (held by tests/test_torch_compress.py).

A trained TM is ~99% Excludes; only Include TAs matter for inference.  The
model is compressed to a stream of 16-bit *Include Instructions*:

      bit 15 : E   — toggles when the class changes
      bit 14 : CC  — toggles when the clause changes
      bit 13 : P   — polarity of the clause this include belongs to (1 = +)
      bit 12 : L   — literal is the complement (f̄) iff 1
      bits 11..0 : O — offset (literal slots to advance), 0..4094

Traversal order (Fig 3.3): class-major, then clause, then interleaved literal
slot k (= 2*feature + is_complement), so offsets within a clause are strictly
positive after the first include.  The offset counts *within-clause* slots;
the literal pointer resets to 0 at each clause boundary (the Literal Select
step of Fig 4.5 indexes Feature Memory with the accumulated pointer).

Escape: O == 0xFFF is EXTEND — advance the literal pointer by 4095 slots
without consuming a literal.  An EXTEND may also carry the CC/E boundary
toggles; a clause whose stream consists only of EXTENDs has no content and
contributes nothing (inference semantics: empty clause -> 0).  Encoding a
class with zero includes therefore emits a single boundary EXTEND so the
E-toggle class counter stays aligned (the paper's E bit, generalized).

Interpreter contract (shared by every engine and the tm_popcount kernel):
  * boundary  := (CC != prev_CC) or (E != prev_E)
  * on boundary: finalize previous clause (add pol * acc to class sums iff
    any include executed in it), advance class iff E toggled, reset the
    literal pointer and the clause accumulator
  * EXTEND: ptr += 4095, no other effect
  * include: ptr += O; literal = (L ? NOT feature[ptr>>1] : feature[ptr>>1]);
    acc &= literal   (ptr's LSB must equal L — interleaved order)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .tm import TMConfig

E_BIT = 15
CC_BIT = 14
P_BIT = 13
L_BIT = 12
OFF_MASK = 0x0FFF
EXTEND = 0x0FFF  # offset escape: advance 4095 slots, consume nothing
MAX_OFF = OFF_MASK - 1  # 4094


@dataclasses.dataclass(frozen=True)
class CompressedModel:
    """The programmable artifact: what the Fig-8 training node ships.

    ``clause_weights`` (repro.prune, ETHEREAL-style weighted clauses) is an
    optional int vector with ONE entry per non-empty clause in stream
    emission order: the clause's vote is ``weight * pol`` instead of
    ``pol``.  ``None`` is the classic weightless model — every pre-prune
    artifact and every v1 wire blob stays exactly what it was."""

    instructions: np.ndarray  # uint16[I]
    n_classes: int
    n_clauses: int  # clauses per class (accumulator bound, Fig 4.6)
    n_features: int  # Boolean features (feature-memory depth)
    clause_weights: Optional[np.ndarray] = None  # uint16[Ncl'] emission order

    def __post_init__(self):
        if self.clause_weights is not None:
            w = np.asarray(self.clause_weights)
            if w.ndim != 1:
                raise ValueError(
                    f"clause_weights must be a 1-D per-clause vector, got "
                    f"shape {w.shape}"
                )
            if w.size and (w.min() < 1 or w.max() > 0xFFFF):
                raise ValueError(
                    "clause_weights must be integers in [1, 65535] (a zero "
                    "weight is a pruned clause — drop it from the stream "
                    "instead)"
                )
            object.__setattr__(
                self, "clause_weights", w.astype(np.uint16)
            )

    @property
    def n_instructions(self) -> int:
        return int(self.instructions.shape[0])

    @property
    def weighted(self) -> bool:
        return self.clause_weights is not None

    @property
    def n_weights(self) -> int:
        return 0 if self.clause_weights is None else int(
            self.clause_weights.shape[0]
        )

    @property
    def weight_planes(self) -> int:
        """Bitplanes the popcount engine needs for this model's weights
        (``max_weight.bit_length()``); 1 for weightless models — weight 1
        is the implicit plane-0-only case, so the weightless and
        all-weights-1 programs cost the same."""
        if self.clause_weights is None or self.clause_weights.size == 0:
            return 1
        return int(self.clause_weights.max()).bit_length()

    @property
    def n_bytes(self) -> int:
        return (self.n_instructions + self.n_weights) * 2

    def compression_ratio(self, cfg: TMConfig) -> float:
        """Fraction of the dense 1-bit-per-TA model eliminated (paper: ~99%)."""
        dense_bits = cfg.n_tas
        return 1.0 - (self.n_bytes * 8) / dense_bits


def _emit(e: int, cc: int, p: int, lbit: int, off: int) -> int:
    return (e << E_BIT) | (cc << CC_BIT) | (p << P_BIT) | (lbit << L_BIT) | off


def encode(
    cfg: TMConfig,
    actions: np.ndarray,
    clause_weights: Optional[np.ndarray] = None,
) -> CompressedModel:
    """Dense include actions bool[M, C, 2F] -> compressed instruction stream.

    ``clause_weights`` (optional int[M, C], the repro.prune weighted-clause
    output) rides along per NON-EMPTY clause in emission order.  An
    all-ones weight matrix normalizes back to a weightless model, so the
    prune pipeline never inflates an artifact that gained nothing from
    weighting (and the v1 wire format keeps covering it)."""
    actions = np.asarray(actions, dtype=bool)
    M, C, L2 = actions.shape
    assert (M, C, L2) == (cfg.n_classes, cfg.n_clauses, cfg.n_literals)
    if clause_weights is not None:
        clause_weights = np.asarray(clause_weights)
        if clause_weights.shape != (M, C):
            raise ValueError(
                f"clause_weights must be int[{M}, {C}] (one weight per "
                f"clause slot), got shape {clause_weights.shape}"
            )

    out: List[int] = []
    weights: List[int] = []
    e_tog, cc_tog = 0, 0  # current toggle levels
    for m in range(M):
        new_class = True
        if not actions[m].any():
            # class with zero includes: lone boundary EXTEND advances E
            e_tog ^= 1
            cc_tog ^= 1
            out.append(_emit(e_tog, cc_tog, 0, 0, EXTEND))
            continue
        for j in range(C):
            ks = np.flatnonzero(actions[m, j])
            if ks.size == 0:
                continue  # empty clause: contributes 0 at inference; skip
            pol = 1 if j % 2 == 0 else 0
            cc_tog ^= 1
            if new_class:
                e_tog ^= 1
                new_class = False
            if clause_weights is not None:
                weights.append(int(clause_weights[m, j]))
            ptr = 0
            for k in ks.tolist():
                delta = int(k) - ptr
                while delta > MAX_OFF:
                    out.append(_emit(e_tog, cc_tog, pol, 0, EXTEND))
                    delta -= EXTEND
                out.append(_emit(e_tog, cc_tog, pol, int(k) & 1, delta))
                ptr = int(k)
    wvec = None
    if clause_weights is not None and any(w != 1 for w in weights):
        wvec = np.asarray(weights, dtype=np.uint16)
    return CompressedModel(
        instructions=np.asarray(out, dtype=np.uint16),
        n_classes=M,
        n_clauses=C,
        n_features=cfg.n_features,
        clause_weights=wvec,
    )


def validate_roundtrip(
    cfg: TMConfig,
    actions: np.ndarray,
    model: CompressedModel,
    X: np.ndarray,
    clause_weights: Optional[np.ndarray] = None,
) -> None:
    """Publication gate for the Fig-8 loop: the compressed stream must
    reproduce dense inference BIT-EXACTLY on the probe inputs before it may
    be shipped to a live accelerator.  Decodes ``model`` back to an action
    mask (plus per-slot weights for weighted streams) and compares
    ``batch_class_sums`` against the original ``actions`` (ordinal equality
    is too strict — empty clauses are legitimately dropped at encode time).
    ``clause_weights`` (int[M, C]) is the weight matrix the reference side
    votes with; ``None`` means unit weights.  Raises ``ValueError`` on any
    mismatch.

    Degenerate streams fail CLEANLY: a stream that is structurally
    inconsistent with the model dims (e.g. a prune pass dropped every
    clause of a class without leaving the boundary EXTEND, so class
    alignment slipped past ``n_classes``) is a structured publication
    refusal, not an ``IndexError`` from deep inside the decoder.  A
    well-formed stream whose class has zero clauses (the lone boundary
    EXTEND) is a legitimate model and PASSES.
    """
    import torch

    from .tm import batch_class_sums_weighted, state_from_actions

    try:
        decoded, dec_w = decode_weights(model)
    except ValueError as err:
        raise ValueError(
            f"compressed stream failed to decode against its own dims "
            f"(n_classes={model.n_classes}, n_clauses={model.n_clauses}, "
            f"n_features={model.n_features}): {err} — refusing to publish "
            f"the model"
        ) from err
    ref_w = None
    if clause_weights is not None:
        ref_w = torch.as_tensor(np.asarray(clause_weights, np.int32))
    x = torch.as_tensor(np.asarray(X))
    s_dense = batch_class_sums_weighted(
        cfg, state_from_actions(cfg, actions), x, weights=ref_w
    )
    s_stream = batch_class_sums_weighted(
        cfg, state_from_actions(cfg, decoded), x,
        weights=torch.as_tensor(dec_w),
    )
    if not torch.equal(s_dense, s_stream):
        bad = int((s_dense != s_stream).any(dim=1).sum())
        raise ValueError(
            f"compressed stream is not bit-exact against the dense oracle: "
            f"{bad}/{X.shape[0]} probe datapoints disagree — refusing to "
            f"publish the model"
        )


def _decode_walk(model: CompressedModel) -> Tuple[np.ndarray, np.ndarray]:
    """Shared stream walk -> (actions bool[M, C, 2F], weights int32[M, C]).

    Validates the stream against the model dims as it walks — every
    structural inconsistency is a ``ValueError`` naming the offending
    instruction (a degenerate stream must be a clean publication
    refusal, never an ``IndexError``):

      * more class boundaries (E toggles) than ``n_classes``
      * an include before the first class boundary
      * a class accumulating more +/- clauses than ``n_clauses`` slots
      * a literal pointer outside the ``2 * n_features`` slots
      * a weight vector whose length disagrees with the non-empty clause
        count
    """
    M, C, F = model.n_classes, model.n_clauses, model.n_features
    acts = np.zeros((M, C, 2 * F), dtype=bool)
    weights = np.ones((M, C), dtype=np.int32)
    wvec = model.clause_weights
    next_even = np.zeros(M, dtype=np.int64)
    next_odd = np.ones(M, dtype=np.int64)

    cls = -1
    slot = -1
    content = False
    n_emitted = 0
    ptr = 0
    prev_e, prev_cc = 0, 0
    for t, ins in enumerate(model.instructions.tolist()):
        e = (ins >> E_BIT) & 1
        cc = (ins >> CC_BIT) & 1
        p = (ins >> P_BIT) & 1
        off = ins & OFF_MASK
        if cc != prev_cc or e != prev_e:  # boundary
            if e != prev_e:
                cls += 1
                if cls >= M:
                    raise ValueError(
                        f"instruction {t}: stream advances to class {cls} "
                        f"but the model declares n_classes={M} (class "
                        f"alignment slipped — a pruned-away class must "
                        f"still emit its boundary EXTEND)"
                    )
            prev_e, prev_cc = e, cc
            ptr = 0
            content = False
            slot = -1
        if off == EXTEND:
            ptr += EXTEND
            continue
        if cls < 0:
            raise ValueError(
                f"instruction {t}: include before the first class boundary "
                f"(the stream must open with an E/CC toggle)"
            )
        if not content:
            if p == 1:
                slot = int(next_even[cls])
                next_even[cls] += 2
            else:
                slot = int(next_odd[cls])
                next_odd[cls] += 2
            if slot >= C:
                pol_name = "positive" if p == 1 else "negative"
                raise ValueError(
                    f"instruction {t}: class {cls} holds more {pol_name} "
                    f"clauses than the declared n_clauses={C} provides "
                    f"slots for"
                )
            if wvec is not None:
                if n_emitted >= wvec.shape[0]:
                    raise ValueError(
                        f"instruction {t}: stream emits more non-empty "
                        f"clauses than the {wvec.shape[0]}-entry weight "
                        f"vector covers"
                    )
                weights[cls, slot] = int(wvec[n_emitted])
            n_emitted += 1
            content = True
        ptr = ptr + off
        if ptr >= 2 * F:
            raise ValueError(
                f"instruction {t}: literal slot {ptr} out of range for "
                f"n_features={F} ({2 * F} interleaved slots)"
            )
        acts[cls, slot, ptr] = True
    if wvec is not None and n_emitted != wvec.shape[0]:
        raise ValueError(
            f"weight vector carries {wvec.shape[0]} entries but the stream "
            f"emits {n_emitted} non-empty clauses"
        )
    return acts, weights


def decode(model: CompressedModel) -> np.ndarray:
    """Instruction stream -> dense include actions bool[M, C, 2F].

    Clause ordinals are re-assigned densely per class (empty clauses were
    skipped at encode time): + clauses to even slots, - clauses to odd slots,
    restoring polarity semantics exactly (verified by property tests).
    """
    acts, _ = _decode_walk(model)
    return acts


def decode_weights(model: CompressedModel) -> Tuple[np.ndarray, np.ndarray]:
    """Stream -> (actions bool[M, C, 2F], clause weights int32[M, C]).

    The weights land in the same re-assigned clause slots as ``decode``
    places the includes in; weightless models (and empty slots) get 1."""
    return _decode_walk(model)


# ---------------------------------------------------------------------------
# Decoded execution plan (beyond-paper optimized path; see interp.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodedPlan:
    """Offset chains prefix-summed into absolute indices (done ONCE at
    program time).  Inference then becomes gather + segmented reduction —
    fully parallel, unlike the paper's 4-cycle/instruction pipeline."""

    lit_idx: np.ndarray  # int32[I']  absolute literal slot in [0, 2F)
    clause_id: np.ndarray  # int32[I'] global clause id (dense numbering)
    clause_class: np.ndarray  # int32[Ncl] class of each global clause
    clause_pol: np.ndarray  # int32[Ncl] +1 / -1
    n_classes: int
    n_features: int
    clause_weight: Optional[np.ndarray] = None  # int32[Ncl]; None = all 1

    @property
    def n_includes(self) -> int:
        return int(self.lit_idx.shape[0])

    @property
    def n_clauses_total(self) -> int:
        return int(self.clause_pol.shape[0])

    @property
    def weights(self) -> np.ndarray:
        """int32[Ncl] per-clause vote weights (ones when weightless)."""
        if self.clause_weight is not None:
            return self.clause_weight
        return np.ones(self.n_clauses_total, dtype=np.int32)

    @property
    def weighted_pol(self) -> np.ndarray:
        """int32[Ncl] ``weight * pol`` — what the multiply-capable engines
        (plan / sharded) fold straight into their polarity operand, so
        weighted execution is the SAME kernel at weight 1."""
        return (self.clause_pol * self.weights).astype(np.int32)

    @property
    def weight_planes(self) -> int:
        """Bitplanes the popcount reduction needs (1 when weightless)."""
        if self.clause_weight is None or self.clause_weight.size == 0:
            return 1
        return int(self.clause_weight.max()).bit_length()

    def clauses_per_class(self, n_classes: int | None = None) -> np.ndarray:
        """int64[M] non-empty clauses per class — the clause-table depth a
        deployment must provision (capacity negotiation reads its max)."""
        m = self.n_classes if n_classes is None else n_classes
        return np.bincount(self.clause_class, minlength=m)

    def includes_per_clause(self) -> np.ndarray:
        """int64[Ncl] includes per (non-empty) clause — the include-slot
        width a clause-major layout must provision."""
        if self.n_clauses_total == 0:
            return np.zeros(0, dtype=np.int64)
        return np.bincount(self.clause_id, minlength=self.n_clauses_total)


def decode_to_plan(model: CompressedModel) -> DecodedPlan:
    """Walk the stream once on the host, materializing absolute indices."""
    lit_idx: List[int] = []
    clause_id: List[int] = []
    clause_class: List[int] = []
    clause_pol: List[int] = []
    wvec = model.clause_weights

    cls = -1
    cur_clause = -1
    content = False
    ptr = 0
    prev_e, prev_cc = 0, 0
    for ins in model.instructions.tolist():
        e = (ins >> E_BIT) & 1
        cc = (ins >> CC_BIT) & 1
        p = (ins >> P_BIT) & 1
        off = ins & OFF_MASK
        if cc != prev_cc or e != prev_e:  # boundary
            if e != prev_e:
                cls += 1
            prev_e, prev_cc = e, cc
            ptr = 0
            content = False
        if off == EXTEND:
            ptr += EXTEND
            continue
        if not content:
            cur_clause += 1
            clause_class.append(cls)
            clause_pol.append(1 if p == 1 else -1)
            content = True
        ptr = ptr + off
        lit_idx.append(ptr)
        clause_id.append(cur_clause)
    n_emitted = len(clause_pol)
    if wvec is not None and n_emitted != wvec.shape[0]:
        raise ValueError(
            f"weight vector carries {wvec.shape[0]} entries but the stream "
            f"emits {n_emitted} non-empty clauses"
        )
    return DecodedPlan(
        lit_idx=np.asarray(lit_idx, dtype=np.int32),
        clause_id=np.asarray(clause_id, dtype=np.int32),
        clause_class=np.asarray(clause_class, dtype=np.int32),
        clause_pol=np.asarray(clause_pol, dtype=np.int32),
        n_classes=model.n_classes,
        n_features=model.n_features,
        clause_weight=(
            None if wvec is None else wvec.astype(np.int32)
        ),
    )
