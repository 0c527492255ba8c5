"""Packed int8 TA-state representation of the fused training path, the
port of ``repro.kernels.tm_train.ops``.

The canonical TA tensor is ``int32[M, C, 2F]`` with states in ``[1, 2N]``
and the interleaved literal order of ``core.tm`` (slot ``2k`` = feature
k, ``2k+1`` = NOT k).  The fused trainer keeps

    ``int8[M, C, F, 2]``   with   packed = state - (N + 1)  in  [-N, N-1]

whose last axis is (literal, negated literal): the canonical ``2F`` axis
reshaped, never permuted.  The Include action is a sign test: ``state >
N  <=>  packed >= 0``.  int8 holds the whole state range iff ``2N <=
256`` (``n_states <= 128``, the default); ``check_packable`` refuses the
rest instead of wrapping.
"""

from __future__ import annotations

import torch

from ...core.tm import TMConfig

# packed = state - (n_states + 1); int8 range [-128, 127] holds
# [1 - (N+1), 2N - (N+1)] = [-N, N-1] exactly when N <= 128
MAX_PACKED_STATES = 128


def supports_packed_states(cfg: TMConfig) -> bool:
    """True when the config's TA range fits the int8 packed layout."""
    return cfg.n_states <= MAX_PACKED_STATES


def check_packable(cfg: TMConfig) -> None:
    if not supports_packed_states(cfg):
        raise ValueError(
            f"packed int8 TA states hold at most 2*{MAX_PACKED_STATES} "
            f"levels, but n_states={cfg.n_states} needs {2 * cfg.n_states}; "
            f"use the 'reference' train engine for this config"
        )


def pack_ta_state(cfg: TMConfig, state) -> torch.Tensor:
    """Canonical ``int32[M, C, 2F]`` -> packed ``int8[M, C, F, 2]`` (on the
    state's device)."""
    check_packable(cfg)
    state = torch.as_tensor(state)
    packed = (state.to(torch.int32) - (cfg.n_states + 1)).to(torch.int8)
    return packed.reshape(cfg.n_classes, cfg.n_clauses, cfg.n_features, 2)


def unpack_ta_state(cfg: TMConfig, packed: torch.Tensor) -> torch.Tensor:
    """Packed ``int8[M, C, F, 2]`` -> canonical ``int32[M, C, 2F]``."""
    flat = packed.reshape(cfg.n_classes, cfg.n_clauses, cfg.n_literals)
    return flat.to(torch.int32) + (cfg.n_states + 1)


def packed_include_actions(packed: torch.Tensor) -> torch.Tensor:
    """bool include mask straight off the packed representation."""
    return packed >= 0
