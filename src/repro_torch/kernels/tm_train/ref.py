"""Naive oracle of the fused packed trainer: round-trip through the
canonical representation and the summed-delta trainer (``core.train``),
with dense clause evaluation and no packed words, so a test comparing
``fused_train_batch`` with it compares two differently structured
computations that must agree bit for bit."""

from __future__ import annotations

import torch

from ...core.tm import TMConfig
from ...core.train import train_batch_parallel
from .ops import pack_ta_state, unpack_ta_state


def fused_train_batch_ref(
    cfg: TMConfig, packed: torch.Tensor, key: torch.Tensor,
    xb: torch.Tensor, yb: torch.Tensor,
) -> torch.Tensor:
    """unpack -> ``train_batch_parallel`` -> repack (the slow truth)."""
    state = unpack_ta_state(cfg, packed)
    return pack_ta_state(cfg, train_batch_parallel(cfg, state, key, xb, yb))
