"""Class sums of a clause-major include table (the sharded executor's
tile): the CUDA kernel's wrapper (kernel) and its plain twin with the
general clause-major executor (ref)."""

from .kernel import clause_table
from .ref import clause_major_sums, clause_table_plain, scatter_classes_

__all__ = [
    "clause_major_sums",
    "clause_table",
    "clause_table_plain",
    "scatter_classes_",
]
