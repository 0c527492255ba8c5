"""tm_train: fused packed-TA training (clause eval + Type I/II feedback +
TA update over packed literal words, int8 state).

``kernel.py`` holds the CUDA kernel's wrapper (``tm_train``), its plain
twin and the fused step; ``ops.py`` the packed int8 ``(clauses, literals,
2)`` layout; ``ref.py`` the unpack -> reference -> repack oracle;
``repro_torch.recal.train_engine`` the 'packed' train engine over it."""

from .kernel import (
    fused_fit_step,
    fused_train_batch,
    fused_train_batch_plain,
    packed_clause_words,
    tm_train,
    tm_train_plain,
)
from .ops import (
    MAX_PACKED_STATES,
    check_packable,
    pack_ta_state,
    packed_include_actions,
    supports_packed_states,
    unpack_ta_state,
)
from .ref import fused_train_batch_ref

__all__ = [
    "MAX_PACKED_STATES",
    "check_packable",
    "fused_fit_step",
    "fused_train_batch",
    "fused_train_batch_plain",
    "fused_train_batch_ref",
    "pack_ta_state",
    "packed_clause_words",
    "packed_include_actions",
    "supports_packed_states",
    "tm_train",
    "tm_train_plain",
    "unpack_ta_state",
]
