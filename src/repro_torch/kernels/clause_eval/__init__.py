"""Dense bitpacked clause evaluation: the CUDA kernel's wrapper and plain
twin (kernel), the class-sum entry point (ops) and oracles (ref)."""

from .kernel import clause_eval, clause_eval_plain
from .ops import tm_dense_class_sums
from .ref import class_sums_from_clause_words, clause_eval_ref

__all__ = [
    "class_sums_from_clause_words",
    "clause_eval",
    "clause_eval_plain",
    "clause_eval_ref",
    "tm_dense_class_sums",
]
