"""Class sums of a Tsetlin Machine, weightless or with integer clause
weights, straight from its include actions, in plain PyTorch.

Literals are interleaved: slot 2k is feature k, slot 2k+1 its negation.
At inference a clause with at least one include fires when none of its
included literals is 0, and a clause with no includes outputs 0.  Class
m adds its even (positive) clauses and subtracts its odd (negative)
ones, each firing clause by its weight (1 where the machine is
weightless).  The prediction is the first class of largest sum.

The count of included literals that are 0 is one float32 product of
Booleans, exact for any count below 2^24; TF32 is switched off around it
all the same, so that the reference never rests on a rounding mode.
"""

from __future__ import annotations

import numpy as np
import torch


def zero_literals(x: torch.Tensor) -> torch.Tensor:
    """{0,1}[R, F] -> float32[R, 2F]: 1 where a literal is 0."""
    x = x.to(torch.float32)
    return torch.stack([1.0 - x, x], dim=-1).reshape(x.shape[0], -1)


def class_sums(
    actions: torch.Tensor, x: torch.Tensor, block_rows: int = 16384,
    dtype: torch.dtype = torch.int32, weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """actions bool[M, C, 2F], x {0,1}[R, F] (on one device) and optional
    clause weights int[M, C] -> int32[R, M] class sums, ``block_rows``
    rows at a time, each firing clause adding ``weight * pol`` in
    ``dtype`` (a narrower integer for the benchmark's control, whose
    weights then wrap as that integer's do).  In int32 the sums are exact
    while ceil(C/2) times the largest weight is below 2^31, which is
    checked."""
    M, C, L2 = actions.shape
    if x.shape[1] * 2 != L2:
        raise ValueError(f"{x.shape[1]} features do not match {L2} literals")
    inc = actions.reshape(M * C, L2).to(torch.float32, copy=True).to(x.device)
    nonempty = inc.sum(dim=1) > 0
    pol = torch.where(
        torch.arange(C, device=x.device) % 2 == 0, 1, -1
    ).to(dtype)
    if weights is not None:
        if tuple(weights.shape) != (M, C):
            raise ValueError(f"weights of shape {tuple(weights.shape)}, not {(M, C)}")
        if -(-C // 2) * int(weights.abs().max()) >= 2**31:
            raise ValueError("class sums of these weights can exceed int32")
    vote = pol if weights is None else weights.to(x.device, torch.int64).to(dtype) * pol
    out = torch.empty((x.shape[0], M), dtype=torch.int32, device=x.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, x.shape[0], block_rows):
            z = zero_literals(x[lo:lo + block_rows])
            fires = (z @ inc.T == 0) & nonempty  # [b, M*C]
            out[lo:lo + z.shape[0]] = (
                fires.to(dtype).reshape(-1, M, C) * vote
            ).sum(dim=-1, dtype=dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def predictions(sums: np.ndarray) -> np.ndarray:
    """int32[R]: the first class of largest sum in each row."""
    return np.argmax(sums, axis=1).astype(np.int32)
