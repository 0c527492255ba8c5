"""The plan interpreter: host operand flattening and entry points (ops),
the CUDA kernel's wrapper and plain twin (kernel) and a sequential
oracle (ref)."""

from .kernel import tm_interp, tm_interp_plain
from .ops import (
    clause_ends,
    compressed_operands,
    pack_interleaved_literals,
    plan_to_operands,
    tm_compressed_class_sums,
)
from .ref import tm_interp_ref

__all__ = [
    "clause_ends",
    "compressed_operands",
    "pack_interleaved_literals",
    "plan_to_operands",
    "tm_compressed_class_sums",
    "tm_interp",
    "tm_interp_plain",
    "tm_interp_ref",
]
