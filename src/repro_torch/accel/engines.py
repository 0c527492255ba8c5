"""The built-in engine plugin of the port: ``popcount``.

``PopcountEngine`` is the popcount bitplane path (``kernels.tm_popcount``):
clause outputs stay packed 32-bit words until a clause boundary; class
sums come from popcounts against per-class polarity-bank bitplanes.  On
CUDA it launches the hand-written Hopper kernel, on the CPU (only when
asked for with ``device="cpu"``) its plain PyTorch twin.

The program (operand vectors, the clause-end table and the class masks,
in instruction space for the plain twin and in clause space for the
kernel) moves to the device once, at ``program()``.  Each call copies the
pinned staging block into a preallocated device buffer without blocking
(the counterpart of the reference engine donating its feature buffer),
packs the literals on the device and runs the kernel.  The ``interp``,
``plan`` and ``sharded`` engines of the reference are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.bits import from_u32
from ..core.compress import CompressedModel, decode_to_plan
from ..core.tm import pack_literals
from ..kernels.tm_popcount.kernel import clause_space_masks, tm_popcount
from ..kernels.tm_popcount.ops import clause_ends, plan_to_popcount_operands
from .capacity import CapacityPlan
from .engine import EngineBase, register_engine


@register_engine("popcount", priority=30)
class PopcountEngine(EngineBase):
    """Popcount bitplane engine: packed clause words end to end, class
    sums from popcounts against the program's polarity-bank bitplanes."""

    validated_knobs = (
        "instruction_capacity", "feature_capacity", "class_capacity",
        "weight_planes",  # the selection-bank depth is an operand shape
    )
    instruction_metric = "includes"  # operand vectors hold includes only
    needs_decoded_plan = True

    def __init__(self, plan: CapacityPlan, device=None):
        super().__init__(plan, device)
        self._x_dev = None  # device copy of the staging block

    def _program(self, model: CompressedModel, decoded=None) -> Dict[str, Any]:
        p = self.plan
        plan = decoded if decoded is not None else decode_to_plan(model)
        # masks are built at the PLAN's plane depth (not the model's), so
        # the mask shape is a capacity constant: weighted and weightless
        # models swap through one operand signature
        lit_idx, last, mask_pos, mask_neg = plan_to_popcount_operands(
            plan, p.instruction_capacity, p.class_capacity,
            l2_cap=2 * p.feature_capacity,
            weight_planes=p.weight_planes,
        )
        # the clause table the kernel walks and the masks in clause space,
        # both padded to capacity shapes
        ends = clause_ends(last)
        clause_end = np.zeros(p.instruction_capacity, np.int32)
        clause_end[: ends.size] = ends
        cmasks = clause_space_masks(
            from_u32(mask_pos), from_u32(mask_neg), torch.from_numpy(ends),
            n_chunks=-(-p.instruction_capacity // 32),
        )
        dev = self.device
        return {
            "lit_idx": torch.from_numpy(lit_idx).to(dev),
            "last": torch.from_numpy(last).to(dev),
            "clause_end": torch.from_numpy(clause_end).to(dev),
            "n_clauses": int(ends.size),
            "clause_masks": tuple(m.to(dev) for m in cmasks),
            "mask_pos": from_u32(mask_pos, dev),
            "mask_neg": from_u32(mask_neg, dev),
            "n_classes": model.n_classes,
            "n_features": model.n_features,
        }

    def class_sums(self, prog: Dict[str, Any], x: np.ndarray) -> np.ndarray:
        B = x.shape[0]
        self._pad_x(x)
        with self.on_device():
            staged = self.staging_tensor
            if self.device.type == "cuda":
                if self._x_dev is None:
                    self._x_dev = torch.empty_like(staged, device=self.device)
                staged = self._x_dev.copy_(staged, non_blocking=True)
            packed = pack_literals(staged)
            operands = (
                prog["lit_idx"], prog["last"], prog["mask_pos"],
                prog["mask_neg"], packed,
            )
            self._record_signature(
                *operands, prog["clause_end"], *prog["clause_masks"]
            )
            sums = tm_popcount(
                *operands, clause_end=prog["clause_end"],
                n_clauses=prog["n_clauses"], clause_masks=prog["clause_masks"],
            )
            # the device-to-host copy waits for the kernel, so the staging
            # block is free for the next batch when this returns
            return sums[: prog["n_classes"], :B].T.cpu().numpy()
