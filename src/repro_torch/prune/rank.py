"""Per-clause vote-contribution ranking + exact dead-clause detection, the
port of ``repro.prune.rank``.

The ranking signal is the ablation class-sum delta: removing clause
``(m, j)`` changes row ``m`` of the class-sum matrix by exactly
``-pol * weight * fires(j, x)`` on every datapoint ``x``, so the total
absolute inference impact of a clause over a traffic sample ``X`` is

    contribution(m, j) = weight(m, j) * |{x in X : clause (m, j) fires}|

— one batched sweep over the replay-buffer/holdout sample scores every
clause at once.  Here the sweep packs the sample into literal words on the
device and runs ``clause_eval`` (the Hopper kernel on the card, its plain
twin on the CPU); the counts are popcounts of its words.

Dead-clause detection is structural (traffic-independent), numpy on the
host, and PROVABLY zero-impact on all inputs:

  * empty clauses           no includes -> output 0 at inference;
  * contradictory clauses   include both literal ``2f`` and its complement
                            ``2f+1`` -> can never fire;
  * cancelled groups        clauses of one class with IDENTICAL include
                            sets fire identically, so their net vote is
                            ``sum(+w for even slots) - sum(w for odd)``;
                            a group whose net is 0 contributes nothing.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.bits import popcount
from ..core.tm import TMConfig, literals, pack_literals
from ..device import resolve_device
from ..kernels.clause_eval.kernel import clause_eval


def _as_actions(cfg: TMConfig, actions: np.ndarray) -> np.ndarray:
    actions = np.asarray(actions, dtype=bool)
    expect = (cfg.n_classes, cfg.n_clauses, cfg.n_literals)
    if actions.shape != expect:
        raise ValueError(
            f"actions must be bool{list(expect)}, got {actions.shape}"
        )
    return actions


def _weights_or_ones(cfg: TMConfig, weights) -> np.ndarray:
    if weights is None:
        return np.ones((cfg.n_classes, cfg.n_clauses), np.int64)
    w = np.asarray(weights)
    if w.shape != (cfg.n_classes, cfg.n_clauses):
        raise ValueError(
            f"weights must be int[{cfg.n_classes}, {cfg.n_clauses}], got "
            f"shape {w.shape}"
        )
    return w.astype(np.int64)


def pack_traffic(X: np.ndarray, device) -> Tuple[torch.Tensor, int]:
    """{0,1}[B, F] -> (int32[2F, ceil(B/32)] literal words on ``device``,
    B).  ``pack_literals`` needs whole words, so the batch is padded with
    zero rows: their bits are NOT traffic (a clause of negated literals
    fires on them) and ``valid_bits`` masks them off."""
    x = torch.as_tensor(np.asarray(X, np.uint8)).to(device)
    B = x.shape[0]
    return pack_literals(F.pad(x, (0, 0, 0, -B % 32))), B


def valid_bits(words: torch.Tensor, B: int) -> torch.Tensor:
    """Clause words [..., W] with the bits of the padded rows past ``B``
    cleared."""
    if B % 32 == 0:
        return words
    last = words[..., -1:] & ((1 << (B % 32)) - 1)
    return torch.cat([words[..., :-1], last], dim=-1)


def clause_words(cfg: TMConfig, actions: np.ndarray, packed: torch.Tensor) -> torch.Tensor:
    """int32[M*C, W] inference clause words (empty clauses -> 0) of the
    packed literals, by ``clause_eval`` on their device."""
    a = torch.from_numpy(
        actions.reshape(-1, cfg.n_literals).astype(np.int32)
    ).to(packed.device)
    return clause_eval(a, packed)


def clause_fire_counts(
    cfg: TMConfig, actions: np.ndarray, X: np.ndarray, device=None
) -> np.ndarray:
    """int64[M, C]: rows of ``X`` each clause fires on (inference
    semantics: empty clauses never fire), computed on ``device`` (the card
    unless ``device="cpu"``)."""
    actions = _as_actions(cfg, actions)
    dev = resolve_device(device)
    packed, B = pack_traffic(X, dev)
    if B == 0:
        return np.zeros((cfg.n_classes, cfg.n_clauses), np.int64)
    words = valid_bits(clause_words(cfg, actions, packed), B)
    counts = popcount(words).sum(dim=1, dtype=torch.int64)
    return counts.reshape(cfg.n_classes, cfg.n_clauses).cpu().numpy()


def clause_fire_counts_plain(
    cfg: TMConfig, actions: np.ndarray, X: np.ndarray, device=None
) -> np.ndarray:
    """``clause_fire_counts`` as the reference computes it, in plain
    PyTorch on ``device``: a clause fires iff its hit count (included
    literals that are 1) reaches its include count.  The plain version the
    kernel path is held to."""
    actions = _as_actions(cfg, actions)
    dev = resolve_device(device)
    a = torch.from_numpy(actions.reshape(-1, cfg.n_literals)).to(dev, torch.float64)
    lits = literals(torch.as_tensor(np.asarray(X)).to(dev)).to(torch.float64)
    includes = a.sum(dim=1)
    hits = lits @ a.T  # [B, M*C], exact: counts below 2^53
    fires = (hits == includes) & (includes > 0)
    counts = fires.sum(dim=0, dtype=torch.int64)
    return counts.reshape(cfg.n_classes, cfg.n_clauses).cpu().numpy()


def vote_contribution(
    cfg: TMConfig,
    actions: np.ndarray,
    X: np.ndarray,
    weights: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """int64[M, C]: total |class-sum delta| over ``X`` if the clause were
    ablated — ``weight * fire_count``.  THE ranking key of
    ``prune_ranked``; zero-contribution clauses are free to drop on this
    traffic (though only ``dead_clause_mask`` proves them dead on ALL
    traffic)."""
    w = _weights_or_ones(cfg, weights)
    return clause_fire_counts(cfg, actions, X, device) * w


def contradictory_clauses(cfg: TMConfig, actions: np.ndarray) -> np.ndarray:
    """bool[M, C]: clauses including some feature AND its complement —
    structurally unsatisfiable, they can never fire on any input."""
    actions = _as_actions(cfg, actions)
    a = actions.reshape(cfg.n_classes, cfg.n_clauses, cfg.n_features, 2)
    return np.any(a[..., 0] & a[..., 1], axis=-1)


def duplicate_groups(
    cfg: TMConfig, actions: np.ndarray
) -> Dict[Tuple[int, bytes], List[int]]:
    """Group non-empty clauses of each class by their exact include set.

    -> ``{(class, include-set key): [clause slots]}``, only groups with
    >= 2 members.  Clauses in one group fire identically on EVERY input,
    which is what makes cancellation (rank) and weighted merging (passes)
    exact rather than approximate."""
    actions = _as_actions(cfg, actions)
    groups: Dict[Tuple[int, bytes], List[int]] = defaultdict(list)
    for m in range(cfg.n_classes):
        for j in range(cfg.n_clauses):
            row = actions[m, j]
            if row.any():
                groups[(m, row.tobytes())].append(j)
    return {k: v for k, v in groups.items() if len(v) >= 2}


def dead_clause_mask(
    cfg: TMConfig,
    actions: np.ndarray,
    weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """bool[M, C]: provably-zero contributors on ALL inputs.

    Union of: empty clauses, contradictory clauses, and duplicate groups
    whose net weighted vote cancels to zero (equal positive and negative
    weight over identical firing behaviour).  ``prune_exact`` drops
    exactly this set — bit-exactness follows by construction."""
    actions = _as_actions(cfg, actions)
    w = _weights_or_ones(cfg, weights)
    dead = ~actions.any(axis=-1)  # empty
    dead |= contradictory_clauses(cfg, actions)
    for (m, _), slots in duplicate_groups(cfg, actions).items():
        live = [j for j in slots if not dead[m, j]]
        net = sum(int(w[m, j]) * (1 if j % 2 == 0 else -1) for j in live)
        if live and net == 0:
            dead[m, live] = True
    return dead
