"""Carry TA state and compressed models across from the reference package.

Both packages speak numpy at their boundary: a reference TA state is an
int32[M, C, 2F] array, a reference ``CompressedModel`` is a uint16
instruction stream plus its dims and optional uint16 clause weights.
A reference PRNG key crosses as its two uint32 words
(``jax.random.key_data``).  These functions take exactly those numpy
fields (so this module imports nothing of the reference) and build the
port's objects.  A ``TMProgram`` needs no conversion: its bytes load in
either package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.compress import CompressedModel
from .core.tm import TMConfig
from .device import resolve_device


def state_from_numpy(cfg: TMConfig, state, device=None) -> torch.Tensor:
    """TA states int32[M, C, 2F] (numpy, e.g. ``np.asarray`` of a
    reference state) -> an int32 tensor on ``device`` (the CUDA card
    unless ``device="cpu"``)."""
    state = np.asarray(state)
    want = (cfg.n_classes, cfg.n_clauses, cfg.n_literals)
    if state.shape != want:
        raise ValueError(f"TA state must have shape {want}, got {state.shape}")
    if not np.issubdtype(state.dtype, np.integer):
        raise TypeError(f"TA state must be integer, got {state.dtype}")
    if state.size and (state.min() < 1 or state.max() > 2 * cfg.n_states):
        raise ValueError(
            f"TA states must lie in [1, {2 * cfg.n_states}] for "
            f"n_states={cfg.n_states}"
        )
    return torch.from_numpy(state.astype(np.int32)).to(resolve_device(device))


def key_from_numpy(words) -> torch.Tensor:
    """A reference key's words (numpy ``uint32[2]``, as
    ``jax.random.key_data`` gives them) -> a ``core.prng`` key on the
    host; ``core.prng.key_data`` is the way back."""
    words = np.asarray(words)
    if words.shape != (2,) or words.dtype != np.uint32:
        raise ValueError(
            f"a key is two uint32 words, got {words.dtype} {words.shape}"
        )
    return torch.from_numpy(words.astype(np.int64))


def model_from_numpy(
    instructions,
    n_classes: int,
    n_clauses: int,
    n_features: int,
    clause_weights: Optional[np.ndarray] = None,
) -> CompressedModel:
    """The fields of a reference ``CompressedModel`` -> the port's."""
    ins = np.asarray(instructions)
    if ins.ndim != 1:
        raise ValueError(f"instructions must be 1-D, got shape {ins.shape}")
    if ins.dtype != np.uint16:
        raise TypeError(f"instructions must be uint16, got {ins.dtype}")
    return CompressedModel(
        instructions=ins.copy(),
        n_classes=int(n_classes),
        n_clauses=int(n_clauses),
        n_features=int(n_features),
        clause_weights=(
            None if clause_weights is None else np.array(clause_weights)
        ),
    )
