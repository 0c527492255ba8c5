"""Popcount-bitplane inference: host program build (ops), the CUDA
kernel's wrapper and plain twin (kernel), and a sequential oracle (ref)."""

from .kernel import (
    PopcountProgram,
    bit_transpose32,
    class_chunk_ranges,
    clause_space_masks,
    popcount_program,
    popcount_reduce,
    tm_popcount,
    tm_popcount_plain,
)
from .ops import (
    build_program,
    clause_ends,
    pack_class_masks,
    pack_class_masks_weighted,
    plan_to_popcount_operands,
    tm_popcount_class_sums,
)
from .ref import tm_popcount_ref

__all__ = [
    "PopcountProgram",
    "bit_transpose32",
    "build_program",
    "class_chunk_ranges",
    "clause_ends",
    "clause_space_masks",
    "pack_class_masks",
    "pack_class_masks_weighted",
    "plan_to_popcount_operands",
    "popcount_program",
    "popcount_reduce",
    "tm_popcount",
    "tm_popcount_class_sums",
    "tm_popcount_plain",
    "tm_popcount_ref",
]
