"""Capacity negotiation: the "synthesis-time" envelope as a first-class API.

The paper's Fig-6 argument is that memory depths — instruction memory,
feature memory, the class-sum bank, clause tables — are fixed when the
accelerator is synthesized, and everything *inside* them is runtime
state.  ``CapacityPlan`` is that envelope.  Instead of hand-picking
numbers, ``CapacityPlan.for_models`` derives the minimal word-quantized
plan that fits a model population (plus optional headroom for the models
recalibration will grow), and ``fits`` / ``violations`` / ``widen_to``
answer the deployment questions directly.

Exceeding the envelope is no longer a free-text ``ValueError``:
``CapacityExceeded`` carries the offending knob, the required depth and
the provisioned depth, so callers (and the recal publication gate) can
react programmatically — e.g. re-negotiate with ``widen_to``.

Quantization: depths are rounded up to the hardware word grain —
instruction memory to 32 (the popcount selection bitplanes pack 32
instructions per ``uint32`` chunk), feature memory to 16 (the uint16
stream protocol ships features 16 per word and the 2F interleaved
literal rows pack into whole ``uint32`` words), batch in 32-datapoint
bit-packed words by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core.compress import CompressedModel, decode_to_plan

# knob -> rounding grain (the word-quantization rules above)
QUANTA: Dict[str, int] = {
    "instruction_capacity": 32,
    "feature_capacity": 16,
    "class_capacity": 1,
    "clause_capacity": 1,
    "include_capacity": 1,
    "batch_words": 1,
    "weight_planes": 1,
}

# the knobs recalibration can grow (include streams get denser, clauses
# fill in); class count and input dimensionality are pinned by the task,
# so headroom never inflates them — they only pick up quantization slack
HEADROOM_KNOBS = frozenset(
    {"instruction_capacity", "clause_capacity", "include_capacity"}
)


class CapacityExceeded(ValueError):
    """A model needs more of one synthesis-time buffer than the plan
    provides.  ``knob`` names the ``CapacityPlan`` field, ``required`` the
    depth the model needs, ``capacity`` the depth provisioned — enough for
    a caller to re-negotiate (``plan.widen_to(model)``) instead of parsing
    an error string.  Subclasses ``ValueError`` so legacy guards keep
    working."""

    def __init__(self, knob: str, required: int, capacity: int, what: str = ""):
        self.knob = knob
        self.required = int(required)
        self.capacity = int(capacity)
        self.what = what or knob
        super().__init__(
            f"model {self.what} needs {knob} >= {self.required} but the "
            f"negotiated plan provides {self.capacity}; re-negotiate the "
            f"envelope (CapacityPlan.widen_to / for_models) — the eFPGA "
            f"analogue is resynthesizing with a deeper {self.what}"
        )


def _quantize(knob: str, value: int) -> int:
    q = QUANTA[knob]
    return max(q, ((int(value) + q - 1) // q) * q)


def model_requirements(
    model: CompressedModel,
    knobs: Optional[Iterable[str]] = None,
    decoded=None,
) -> Dict[str, int]:
    """Per-knob minimal depths for one compressed model.

    Instruction memory must hold the full stream (covers the include
    count, which can only be smaller); the clause-table extents come from
    the decoded plan — the clause tables must hold the densest class, the
    include slots the widest clause.  Decoding only happens when a
    clause-table knob is actually requested (``knobs``); pass an
    already-``decoded`` plan to avoid a second stream walk.
    """
    wanted = set(CapacityPlan.KNOBS if knobs is None else knobs)
    req: Dict[str, int] = {}
    if "instruction_capacity" in wanted:
        req["instruction_capacity"] = model.n_instructions
    if "feature_capacity" in wanted:
        req["feature_capacity"] = model.n_features
    if "class_capacity" in wanted:
        req["class_capacity"] = model.n_classes
    if wanted & {"clause_capacity", "include_capacity"}:
        if decoded is None:
            decoded = decode_to_plan(model)
        if "clause_capacity" in wanted:
            cpc = decoded.clauses_per_class(model.n_classes)
            req["clause_capacity"] = int(cpc.max()) if cpc.size else 0
        if "include_capacity" in wanted:
            ipc = decoded.includes_per_clause()
            req["include_capacity"] = int(ipc.max()) if ipc.size else 0
    if "weight_planes" in wanted:
        # bitplanes of the largest clause weight (repro.prune); 1 for
        # weightless models, so legacy populations negotiate exactly the
        # envelope they always did
        req["weight_planes"] = model.weight_planes
    return req


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """The serving deployment's synthesis-time capacity envelope (Fig 6
    memory-depth customization, extended with the clause-table dims the
    plan/sharded layouts need).  Everything inside these bounds is runtime
    state; exceeding them raises ``CapacityExceeded``."""

    instruction_capacity: int = 4096   # instruction memory / include-list depth
    feature_capacity: int = 256        # Boolean features per datapoint
    class_capacity: int = 16           # class-sum accumulator bank depth
    clause_capacity: int = 64          # clauses per class (clause tables)
    include_capacity: int = 32         # includes per clause (clause-major)
    batch_words: int = 4               # 32 datapoints per bit-packed word
    weight_planes: int = 1             # clause-weight bitplanes (repro.prune)

    KNOBS = (
        "instruction_capacity", "feature_capacity", "class_capacity",
        "clause_capacity", "include_capacity", "batch_words",
        "weight_planes",
    )

    def __post_init__(self):
        for knob in self.KNOBS:
            v = getattr(self, knob)
            if not isinstance(v, (int, np.integer)) or v < 1:
                raise ValueError(
                    f"CapacityPlan.{knob} must be a positive integer, "
                    f"got {v!r}"
                )

    @property
    def batch_capacity(self) -> int:
        return self.batch_words * 32

    @property
    def clause_total_capacity(self) -> int:
        return self.class_capacity * self.clause_capacity

    def as_dict(self) -> Dict[str, int]:
        return {k: int(getattr(self, k)) for k in self.KNOBS}

    # -- negotiation ---------------------------------------------------------

    @classmethod
    def for_models(
        cls,
        models: Iterable[CompressedModel],
        *,
        headroom: float = 0.0,
        batch_words: int = 4,
    ) -> "CapacityPlan":
        """The minimal word-quantized plan fitting every model in
        ``models``.  ``headroom`` is fractional slack applied BEFORE
        quantization to the knobs recalibration can grow
        (``HEADROOM_KNOBS``: instruction/clause/include depths; 0.5 =
        provision 50% above today's population).  Task-pinned dims
        (classes, features) take only quantization slack — inflating a
        fixed compiled shape the task can never use would cost every
        engine call.  ``batch_words`` is traffic-, not model-shaped, so
        it is passed through (in whole 32-datapoint words)."""
        models = list(models)
        if not models:
            raise ValueError(
                "CapacityPlan.for_models needs at least one model to "
                "negotiate an envelope from"
            )
        if headroom < 0:
            raise ValueError(f"headroom must be >= 0, got {headroom}")
        need: Dict[str, int] = {}
        for model in models:
            for knob, req in model_requirements(model).items():
                need[knob] = max(need.get(knob, 0), req)
        knobs = {
            knob: _quantize(
                knob,
                int(np.ceil(req * (1.0 + headroom)))
                if knob in HEADROOM_KNOBS else req,
            )
            for knob, req in need.items()
        }
        return cls(batch_words=int(batch_words), **knobs)

    def violations(
        self,
        model: CompressedModel,
        knobs: Optional[Iterable[str]] = None,
        decoded=None,
    ) -> List[Tuple[str, int, int]]:
        """``(knob, required, provided)`` for every knob ``model`` blows
        through (empty = fits), in ``KNOBS`` order.  ``knobs`` restricts
        the check to a subset — engines validate only the buffers their
        layout actually has (``Engine.validated_knobs``); the default is
        the full envelope (what ``for_models`` negotiates, sufficient for
        every engine).  ``decoded`` forwards an already-decoded plan so
        callers that decode anyway don't pay a second stream walk."""
        req = model_requirements(model, knobs, decoded)
        return [
            (knob, req[knob], getattr(self, knob))
            for knob in self.KNOBS
            if knob in req and req[knob] > getattr(self, knob)
        ]

    def fits(
        self,
        model: CompressedModel,
        knobs: Optional[Iterable[str]] = None,
    ) -> bool:
        return not self.violations(model, knobs)

    def validate(
        self,
        model: CompressedModel,
        knobs: Optional[Iterable[str]] = None,
        decoded=None,
    ) -> None:
        """Raise ``CapacityExceeded`` for the first violated knob (in
        ``KNOBS`` order, so the report is deterministic)."""
        bad = self.violations(model, knobs, decoded)
        if bad:
            knob, req, cap = bad[0]
            raise CapacityExceeded(knob, req, cap)

    def widen_to(self, model: CompressedModel) -> "CapacityPlan":
        """The smallest quantized plan >= self that also fits ``model``
        (the re-negotiation diagnostic a ``CapacityExceeded`` points at)."""
        knobs = self.as_dict()
        for knob, req in model_requirements(model).items():
            knobs[knob] = max(knobs[knob], _quantize(knob, req))
        return CapacityPlan(**knobs)

    def shrink_to(self, model: CompressedModel, decoded=None) -> "CapacityPlan":
        """``widen_to``'s mirror for the prune pass: the smallest quantized
        plan <= self that still fits ``model`` — what a pruned artifact's
        envelope re-negotiates DOWN to (the eFPGA analogue: resynthesize
        with shallower memories and reclaim the BRAM).  ``batch_words`` is
        traffic-shaped and passes through unchanged; no knob ever grows
        (shrink_to of a model that doesn't fit keeps the current depth —
        use ``widen_to`` for that direction)."""
        knobs = self.as_dict()
        for knob, req in model_requirements(model, decoded=decoded).items():
            knobs[knob] = min(knobs[knob], _quantize(knob, req))
        return CapacityPlan(**knobs)

    def shrink_diagnostics(
        self, model: CompressedModel, decoded=None
    ) -> List[Tuple[str, int, int]]:
        """``(knob, provisioned, reclaimable_depth)`` for every knob a
        pruned ``model`` lets the deployment shrink (quantized; empty =
        the envelope is already minimal for this model).  The read-only
        companion of ``shrink_to`` — what the recal controller logs when
        a prune pass makes the published program smaller than the
        envelope it ships into."""
        shrunk = self.shrink_to(model, decoded)
        return [
            (knob, getattr(self, knob), getattr(shrunk, knob))
            for knob in self.KNOBS
            if getattr(shrunk, knob) < getattr(self, knob)
        ]
