"""Clause evaluation as a matrix product: the CUDA kernel's wrapper and
plain twin (kernel), the class-sum entry point (ops) and an integer
oracle (ref)."""

from .kernel import clause_matmul, clause_matmul_plain
from .ops import tm_matmul_class_sums
from .ref import clause_matmul_ref

__all__ = [
    "clause_matmul",
    "clause_matmul_plain",
    "clause_matmul_ref",
    "tm_matmul_class_sums",
]
