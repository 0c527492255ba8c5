"""The built-in engine plugins of the port: interp / plan / sharded /
popcount.

One ``CompressedModel`` contract, four realizations, all bit-exact
against the ``core.tm.batch_class_sums`` oracle:

  * ``interp``   — the paper-faithful stream interpreter
    (``core.interp.interpret_stream``): the hand-written ``interp_stream``
    kernel walks the fixed-depth instruction memory.
  * ``plan``     — the decoded-plan path (``core.interp.plan_class_sums``):
    gather + segmented reduction in plain PyTorch, parallel across
    includes and datapoints.
  * ``sharded``  — the ``dist.tm_sharded`` clause-major executor on a
    (data, model) mesh (classes over ``model``, batch over the data
    axes), each tile one launch of the hand-written ``clause_table``
    kernel; on a (1, 1) mesh the single-device realization of the Fig-7
    multi-core split.  Takes the mesh as an option (``needs_mesh``).
  * ``popcount`` — the popcount bitplane path (``kernels.tm_popcount``)
    over the staging block packed by ``kernels.pack_literals``: clause
    outputs stay packed 32-bit words until a clause boundary; class
    sums come from popcounts against per-class polarity-bank bitplanes.

On CUDA the kernels are the hand-written Hopper ones; on the CPU (only
when asked for with ``device="cpu"``) their plain PyTorch twins.  Every
engine moves its decoded program to its device once, at ``program()``,
and counts the operand signatures it runs with
(``compile_cache_size()``); each call copies the pinned staging block
into a preallocated device buffer without blocking (the counterpart of
the reference engine donating its feature buffer) and builds its operand
there.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.compress import CompressedModel, decode_to_plan
from ..core.interp import interpret_stream, pack_features, pad_plan, plan_class_sums
from ..core.tm import literals
from ..device import resolve_device
from ..dist.sharding import make_mesh
from ..dist.tm_sharded import TMShardedConfig, build_tm_sharded, fill_clause_tables
from ..kernels.pack_literals.kernel import pack_literals
from ..kernels.tm_popcount.kernel import tm_popcount
from ..kernels.tm_popcount.ops import build_program
from .capacity import CapacityExceeded
from .engine import EngineBase, register_engine


@register_engine("interp", priority=10)
class InterpEngine(EngineBase):
    """Paper-faithful fixed-capacity stream interpreter (Fig 4.4-4.6)."""

    validated_knobs = (
        "instruction_capacity", "feature_capacity", "class_capacity",
    )

    def _program(self, model: CompressedModel, decoded=None) -> Dict[str, Any]:
        p = self.plan
        imem = np.zeros(p.instruction_capacity, np.int32)
        imem[: model.n_instructions] = model.instructions
        # per-clause weight memory, indexed by the interpreter's finalize
        # ordinal (non-empty clauses in emission order).  Always present at
        # instruction-capacity depth (a clause needs >= 1 instruction, so
        # it can never be too small) and all ones for weightless models:
        # one operand signature across weighted and weightless swaps.
        wmem = np.ones(p.instruction_capacity, np.int32)
        if model.clause_weights is not None:
            wmem[: model.n_weights] = model.clause_weights
        return {
            "imem": torch.from_numpy(imem).to(self.device),
            "wmem": torch.from_numpy(wmem).to(self.device),
            "n_inst": model.n_instructions,
            "n_classes": model.n_classes,
            "n_features": model.n_features,
        }

    def class_sums(self, prog: Dict[str, Any], x: np.ndarray) -> np.ndarray:
        p = self.plan
        B = x.shape[0]
        self._pad_x(x)
        with self.on_device():
            packed = pack_features(
                self.staged_on_device(), p.feature_capacity, p.batch_words
            )
            self._record_signature(prog["imem"], prog["wmem"], packed)
            sums = interpret_stream(
                prog["imem"], prog["n_inst"], packed, B, prog["wmem"],
                m_cap=p.class_capacity,
            )
            return self._to_host(sums[: prog["n_classes"], :B].T)


@register_engine("plan", priority=20)
class PlanEngine(EngineBase):
    """Decoded-plan engine: gather + segmented min/sum (beyond-paper)."""

    # clause_capacity bounds the segment table: per-class max clauses <=
    # clause_capacity (with n_classes <= class_capacity) implies
    # n_clauses_total <= clause_total_capacity.  instruction_capacity
    # bounds the include operand vectors only: boundary EXTENDs never
    # materialize in the decoded plan
    validated_knobs = (
        "instruction_capacity", "feature_capacity", "class_capacity",
        "clause_capacity",
    )
    instruction_metric = "includes"
    needs_decoded_plan = True

    def _program(self, model: CompressedModel, decoded=None) -> Dict[str, Any]:
        p = self.plan
        plan = decoded if decoded is not None else decode_to_plan(model)
        if plan.n_clauses_total > p.clause_total_capacity:
            # unreachable after validation; kept as a corruption guard on
            # the class_cap*clause_cap-deep segment table
            raise CapacityExceeded(
                "clause_capacity",
                -(-plan.n_clauses_total // p.class_capacity),
                p.clause_capacity,
                "total clauses",
            )
        names = ("li", "ci", "cc", "cp")
        operands = pad_plan(plan, p.instruction_capacity, p.clause_total_capacity)
        prog = {k: torch.from_numpy(a).to(self.device)
                for k, a in zip(names, operands)}
        prog.update(n_classes=model.n_classes, n_features=model.n_features)
        return prog

    def class_sums(self, prog: Dict[str, Any], x: np.ndarray) -> np.ndarray:
        p = self.plan
        B = x.shape[0]
        self._pad_x(x)
        with self.on_device():
            lits = literals(self.staged_on_device())  # [B_cap, 2*F_cap]
            operands = (prog["li"], prog["ci"], prog["cc"], prog["cp"], lits)
            self._record_signature(*operands)
            sums = plan_class_sums(
                *operands, n_clause_cap=p.clause_total_capacity,
                m_cap=p.class_capacity,
            )
            return self._to_host(sums[:B, : prog["n_classes"]])


@register_engine("sharded", needs_mesh=True, priority=5)
class ShardedEngine(EngineBase):
    """``dist.tm_sharded`` clause-major engine on a (data, model) mesh.

    Built once at CAPACITY shape (classes padded to the model axis, clause
    tables at clause/include capacity); programming a model fills the
    fixed-shape tables and puts each class slice on its tiles' devices
    once, so swaps never change an operand shape.  Each call packs the
    staging block's literals on the device (no int8 ``[B, 2F+1]`` copy)
    and runs the executor's packed route.  The default mesh is (1, 1) on
    ``device``."""

    validated_knobs = (
        "feature_capacity", "class_capacity",
        "clause_capacity", "include_capacity",
    )
    needs_decoded_plan = True

    def __init__(self, plan, mesh=None, device=None):
        if mesh is None:
            mesh = make_mesh((1, 1), devices=resolve_device(device))
        elif device is not None and resolve_device(device) != mesh.first_device:
            raise ValueError(
                f"device {device} is not the mesh's first device "
                f"{mesh.first_device}; a mesh engine runs where its mesh is"
            )
        super().__init__(plan, device=mesh.first_device)
        self.mesh = mesh
        cfg = TMShardedConfig(
            name="serve", n_classes=plan.class_capacity,
            n_clauses=plan.clause_capacity,
            n_features=plan.feature_capacity,
            batch=plan.batch_capacity,
            include_cap=plan.include_capacity,
        )
        self._fn, _ = build_tm_sharded(cfg, mesh)
        # the all-ones literal row the tables' pad slots point at
        self._ones = torch.full(
            (1, plan.batch_words), -1, dtype=torch.int32, device=self.device
        )

    def _program(self, model: CompressedModel, decoded=None) -> Dict[str, Any]:
        p = self.plan
        plan = decoded if decoded is not None else decode_to_plan(model)
        # plan.validate already bounded clauses/includes per class; the
        # table fill re-checks as a corruption guard
        idx, pol = fill_clause_tables(
            plan, self._fn.Mp, p.clause_capacity, p.include_capacity,
            2 * p.feature_capacity,
        )
        return {
            "tables": self._fn.place(torch.from_numpy(idx), torch.from_numpy(pol)),
            "n_classes": model.n_classes,
            "n_features": model.n_features,
        }

    def class_sums(self, prog: Dict[str, Any], x: np.ndarray) -> np.ndarray:
        B = x.shape[0]
        self._pad_x(x)
        with self.on_device():
            packed1 = torch.cat([pack_literals(self.staged_on_device()), self._ones])
            tables = prog["tables"]
            self._record_signature(
                *(t for pair in tables.values() for t in pair), packed1
            )
            sums = self._fn.packed(tables, packed1)
            return self._to_host(sums[:B, : prog["n_classes"]])


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

    def _program(self, model: CompressedModel, decoded=None) -> Dict[str, Any]:
        """The kernel's ``PopcountProgram`` on the device and
        ``plane_chunks``: the plan's weight planes x its 32-clause
        chunks."""
        p = self.plan
        plan = decoded if decoded is not None else decode_to_plan(model)
        # masks are built at the PLAN's plane depth (not the model's), so
        # the mask shape is a capacity constant: weighted and weightless
        # models swap through one operand signature
        program = build_program(
            plan, p.instruction_capacity, p.class_capacity,
            l2_cap=2 * p.feature_capacity, weight_planes=p.weight_planes,
            device=self.device,
        )
        return {
            "popcount": program,
            "plane_chunks": p.weight_planes * -(-program.n_clauses // 32),
            "n_classes": model.n_classes,
            "n_features": model.n_features,
        }

    def class_sums(self, prog: Dict[str, Any], x: np.ndarray) -> np.ndarray:
        B = x.shape[0]
        self._pad_x(x)
        with self.on_device():
            packed = pack_literals(self.staged_on_device())
            program = prog["popcount"]
            self._record_signature(*program.tensors(), packed)
            sums = tm_popcount(program, packed)
            # the device-to-host copy waits for the kernel, so the staging
            # block is free for the next batch when this returns
            return self._to_host(sums[: prog["n_classes"], :B].T)
