"""Carry TA state and compressed models across from the reference package.

Both packages speak numpy at their boundary: a reference TA state is an
int32[M, C, 2F] array, a reference ``CompressedModel`` is a uint16
instruction stream plus its dims and optional uint16 clause weights.
A reference PRNG key crosses as its two uint32 words
(``jax.random.key_data``).  An LM's parameters cross as the reference's
parameter tree of numpy arrays (nested dicts, ``np.asarray`` of each
leaf), and an ``AdamWState`` as its ``(step, m, v)`` in the same form.
These functions take exactly those numpy fields (so this module imports
nothing of the reference) and build the port's objects.  A ``TMProgram`` needs no conversion: its bytes load in
either package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.compress import CompressedModel
from .core.tm import TMConfig
from .device import resolve_device
from .models.api import abstract_params
from .models.common import LMParams
from .optim.adamw import AdamWState
from .tree import as_tree, flatten, tree_map, unflatten


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


def _tensor(arr, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: widen exactly first
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a copy: the array may be read-only
    return t.to(device=device, dtype=dtype or t.dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def lm_params_from_numpy(cfg: ArchConfig, tree, device=None, dtype=None) -> LMParams:
    """A reference parameter tree (nested dicts of numpy arrays) of any
    LM family -> an ``LMParams`` on ``device`` (the CUDA card unless
    ``device="cpu"``), each leaf in ``dtype`` if given, else in its own.
    The paths and shapes must be ``api.abstract_params(cfg)``'s."""
    dev = resolve_device(device)
    want = {p: tuple(s.shape) for p, s in flatten(abstract_params(cfg))}
    got = {p: tuple(np.shape(a)) for p, a in flatten(tree)}
    if got != want:
        raise ValueError(
            f"parameter tree does not match {cfg.name}: "
            f"{sorted(set(got.items()) ^ set(want.items()))[:4]}"
        )
    return LMParams(cfg, unflatten(
        (p, _tensor(a, dev, dtype)) for p, a in flatten(tree)
    ))


def lm_params_to_numpy(params):
    """An ``LMParams`` (or its tree), of any family -> the reference's
    tree of numpy arrays (bf16 leaves widened to float32, exactly)."""
    return tree_map(_numpy, as_tree(params))


def adamw_state_from_numpy(state, device=None) -> AdamWState:
    """A reference ``AdamWState`` (``step``, ``m``, ``v`` as numpy) -> the
    port's on ``device`` (the CUDA card unless ``device="cpu"``)."""
    step, m, v = state
    dev = resolve_device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
        m=tree_map(lambda a: _tensor(a, dev, None), m),
        v=tree_map(lambda a: _tensor(a, dev, None), v),
    )


def adamw_state_to_numpy(state: AdamWState):
    """-> (step int32 array, m, v) as numpy trees."""
    return (np.asarray(int(state.step), np.int32),
            tree_map(_numpy, state.m), tree_map(_numpy, state.v))
