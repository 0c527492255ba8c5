"""The three pruning passes and the policy that composes them, the port
of ``repro.prune.passes``.

All passes are shape-preserving: a pruned clause is a ZEROED action row.
``encode`` already skips empty clauses, so the compressed stream (and the
artifact, and every engine's working set) shrinks automatically — no
index remapping, no dims change, no capacity invalidation.

  * ``prune_exact``    provably dead clauses only — bit-exact on every
                       input, no traffic needed;
  * ``merge_weighted`` duplicate clauses -> one weighted clause — also
                       bit-exact (identical firing behaviour is what
                       makes the weighted collapse lossless);
  * ``prune_ranked``   lossy: drops the lowest-vote-contribution tail,
                       gated by a holdout accuracy tolerance with a
                       binary-searched cut point.

The structural passes are numpy on the host.  The ranked pass packs its
holdout once on its device (the card unless ``device="cpu"``) and scores
every cut there: clause words by ``clause_eval`` (the Hopper kernel on the
card, its plain twin on the CPU), then a weighted polarity sum and the
argmax.  ``PrunePolicy.apply`` chains exact -> merge -> ranked, skipping
ranked when no labelled holdout is available (the
``RecalController.deploy`` path) and recording what ran in the
``PruneReport``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.compress import encode
from ..core.tm import TMConfig, clause_polarities, unpack_bits
from ..device import resolve_device
from .rank import (
    _as_actions,
    _weights_or_ones,
    clause_words,
    dead_clause_mask,
    duplicate_groups,
    pack_traffic,
    vote_contribution,
)

_MAX_WEIGHT = 65535  # uint16 wire format (program.py packs weights '<u2')


@dataclasses.dataclass(frozen=True)
class PruneReport:
    """What a pass (or a whole policy run) did, in clause counts."""

    stages: Tuple[str, ...]
    n_clauses_before: int
    n_clauses_after: int
    n_dead: int = 0
    n_merged: int = 0
    n_ranked: int = 0
    baseline_accuracy: Optional[float] = None
    pruned_accuracy: Optional[float] = None
    tolerance: Optional[float] = None

    @property
    def n_removed(self) -> int:
        return self.n_clauses_before - self.n_clauses_after


@dataclasses.dataclass(frozen=True)
class PruneResult:
    """Pruned model: zeroed-row action mask + (optionally) clause weights.

    ``weights`` is ``None`` whenever every surviving clause has weight 1 —
    the weightless wire format (v1) keeps covering exact-only pruning.
    Feed ``actions``/``weights`` straight to ``encode`` /
    ``Compressor.compress``.
    """

    actions: np.ndarray  # bool[M, C, 2F]
    weights: Optional[np.ndarray]  # uint16[M, C] or None (all unit)
    report: PruneReport


def _nonempty_count(actions: np.ndarray) -> int:
    return int(actions.any(axis=-1).sum())


def _normalize_weights(
    actions: np.ndarray, weights: Optional[np.ndarray]
) -> Optional[np.ndarray]:
    """Unit weights everywhere that matters -> ``None`` (weightless wire);
    otherwise a uint16[M, C] with empty rows pinned to the neutral 1."""
    if weights is None:
        return None
    w = np.asarray(weights).astype(np.int64).copy()
    nonempty = actions.any(axis=-1)
    w[~nonempty] = 1
    if bool((w == 1).all()):
        return None
    return w.astype(np.uint16)


class _Holdout:
    """A labelled holdout packed once on a device, scored per cut."""

    def __init__(self, X: np.ndarray, y: np.ndarray, device):
        self.packed, self.B = pack_traffic(X, device)
        self.y = np.asarray(y)

    def accuracy(
        self, cfg: TMConfig, actions: np.ndarray, weights: Optional[np.ndarray]
    ) -> float:
        """Holdout accuracy of the weighted prediction (the argmax of the
        weighted class sums, the first class on ties) of ``actions``."""
        dev = self.packed.device
        bits = unpack_bits(clause_words(cfg, actions, self.packed))[:, : self.B]
        pol = clause_polarities(cfg, dev)[None, :]
        vote = pol if weights is None else pol * torch.from_numpy(
            np.asarray(weights).astype(np.int32)
        ).to(dev)
        sums = (bits.reshape(cfg.n_classes, cfg.n_clauses, self.B)
                * vote[..., None]).sum(dim=1)  # [M, B]
        pred = sums.argmax(dim=0).cpu().numpy()
        return float((pred == self.y).mean())


def prune_exact(
    cfg: TMConfig,
    actions: np.ndarray,
    weights: Optional[np.ndarray] = None,
) -> PruneResult:
    """Drop only provably-dead clauses — bit-exact class sums on EVERY
    input by construction (dead = zero contribution always)."""
    actions = _as_actions(cfg, actions)
    before = _nonempty_count(actions)
    dead = dead_clause_mask(cfg, actions, weights)
    out = actions.copy()
    out[dead] = False
    after = _nonempty_count(out)
    return PruneResult(
        actions=out,
        weights=_normalize_weights(out, weights),
        report=PruneReport(
            stages=("exact",),
            n_clauses_before=before,
            n_clauses_after=after,
            n_dead=before - after,
        ),
    )


def merge_weighted(
    cfg: TMConfig,
    actions: np.ndarray,
    weights: Optional[np.ndarray] = None,
) -> PruneResult:
    """Collapse each duplicate-clause group into ONE weighted clause.

    Clauses of a class with identical include sets fire identically, so
    the group's aggregate vote on any input is its net signed weight
    ``net = sum(+w even slots) - sum(w odd slots)``.  Keep a single
    survivor on a slot whose parity matches ``sign(net)`` with weight
    ``|net|`` (zero the rest); a fully-cancelled group (net 0) is zeroed
    outright.  Bit-exact by construction.  Groups whose ``|net|``
    overflows the uint16 weight format are left untouched rather than
    merged lossily."""
    actions = _as_actions(cfg, actions)
    w = _weights_or_ones(cfg, weights)
    before = _nonempty_count(actions)
    out = actions.copy()
    new_w = w.copy()
    for (m, _), slots in duplicate_groups(cfg, actions).items():
        net = sum(int(w[m, j]) * (1 if j % 2 == 0 else -1) for j in slots)
        if abs(net) > _MAX_WEIGHT:
            continue
        # net > 0 implies an even (positive) slot exists in the group, and
        # net < 0 an odd one — a parity-matched survivor always exists.
        want_parity = 0 if net > 0 else 1
        keep = next((j for j in slots if j % 2 == want_parity), None)
        for j in slots:
            if net != 0 and j == keep:
                new_w[m, j] = abs(net)
            else:
                out[m, j] = False
                new_w[m, j] = 1
    after = _nonempty_count(out)
    return PruneResult(
        actions=out,
        weights=_normalize_weights(out, new_w),
        report=PruneReport(
            stages=("merge",),
            n_clauses_before=before,
            n_clauses_after=after,
            n_merged=before - after,
        ),
    )


def prune_ranked(
    cfg: TMConfig,
    actions: np.ndarray,
    X: np.ndarray,
    y: np.ndarray,
    *,
    tolerance: float,
    weights: Optional[np.ndarray] = None,
    device=None,
) -> PruneResult:
    """Lossy tail drop, gated by holdout accuracy.

    Ranks every surviving clause by its vote contribution over ``X``
    (ablation class-sum delta = weight * fire count), then binary-searches
    the largest ascending-contribution prefix that can be zeroed while
    holdout accuracy stays within ``tolerance`` of the unpruned baseline.
    Cost: O(log n_clauses) holdout predictions, on ``device`` (the card
    unless ``device="cpu"``)."""
    if tolerance < 0:
        raise ValueError(f"tolerance must be >= 0, got {tolerance}")
    actions = _as_actions(cfg, actions)
    dev = resolve_device(device)
    w = _weights_or_ones(cfg, weights)
    before = _nonempty_count(actions)
    holdout = _Holdout(X, y, dev)
    baseline = holdout.accuracy(cfg, actions, weights)
    floor = baseline - tolerance

    contrib = vote_contribution(cfg, actions, X, w, dev)
    nonempty = actions.any(axis=-1)
    cand = np.argwhere(nonempty)  # [n, 2] (class, clause), all droppable
    order = np.argsort(contrib[nonempty], kind="stable")
    cand = cand[order]  # ascending contribution

    def drop(k: int) -> np.ndarray:
        out = actions.copy()
        if k:
            out[cand[:k, 0], cand[:k, 1]] = False
        return out

    lo, hi = 0, len(cand)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if holdout.accuracy(cfg, drop(mid), weights) >= floor:
            lo = mid
        else:
            hi = mid - 1
    out = drop(lo)
    after = _nonempty_count(out)
    return PruneResult(
        actions=out,
        weights=_normalize_weights(out, w),
        report=PruneReport(
            stages=("ranked",),
            n_clauses_before=before,
            n_clauses_after=after,
            n_ranked=before - after,
            baseline_accuracy=baseline,
            pruned_accuracy=holdout.accuracy(cfg, out, weights),
            tolerance=float(tolerance),
        ),
    )


@dataclasses.dataclass(frozen=True)
class PrunePolicy:
    """Which passes to run before publication, composed in the only order
    that makes sense: exact (free) -> merge (free, may create weights) ->
    ranked (lossy, needs a labelled holdout).

    ``tolerance=None`` disables the ranked pass entirely; with a tolerance
    set, the pass still auto-skips when ``apply`` gets no ``X``/``y`` —
    the controller's deploy path has traffic but no labels."""

    exact: bool = True
    merge: bool = True
    tolerance: Optional[float] = None

    def apply(
        self,
        cfg: TMConfig,
        actions: np.ndarray,
        X: Optional[np.ndarray] = None,
        y: Optional[np.ndarray] = None,
        weights: Optional[np.ndarray] = None,
        device=None,
    ) -> PruneResult:
        """Run the passes; the ranked one on ``device`` (the card unless
        ``device="cpu"``)."""
        actions = _as_actions(cfg, actions)
        before = _nonempty_count(actions)
        stages: List[str] = []
        n_dead = n_merged = n_ranked = 0
        baseline = pruned_acc = None
        cur_a, cur_w = actions, weights

        if self.exact:
            r = prune_exact(cfg, cur_a, cur_w)
            cur_a, cur_w = r.actions, r.weights
            stages.append("exact")
            n_dead = r.report.n_dead
        if self.merge:
            r = merge_weighted(cfg, cur_a, cur_w)
            # size-gate: the weight vector costs 2 bytes for EVERY
            # non-empty clause once any weight exceeds 1, which can
            # outweigh the instructions the merge saved.  A compression
            # pass must never grow the artifact, so keep the merge only
            # when the encoded stream actually shrinks (ties go to the
            # merge — fewer clauses at equal bytes).
            if (
                r.report.n_merged == 0
                or encode(cfg, r.actions, clause_weights=r.weights).n_bytes
                <= encode(cfg, cur_a, clause_weights=cur_w).n_bytes
            ):
                cur_a, cur_w = r.actions, r.weights
                stages.append("merge")
                n_merged = r.report.n_merged
            else:
                stages.append("merge:skipped-grows-bytes")
        if self.tolerance is not None and X is not None and y is not None:
            r = prune_ranked(
                cfg, cur_a, X, y, tolerance=self.tolerance, weights=cur_w,
                device=device,
            )
            cur_a, cur_w = r.actions, r.weights
            stages.append("ranked")
            n_ranked = r.report.n_ranked
            baseline = r.report.baseline_accuracy
            pruned_acc = r.report.pruned_accuracy
        elif self.tolerance is not None:
            stages.append("ranked:skipped-no-labels")

        return PruneResult(
            actions=cur_a,
            weights=_normalize_weights(cur_a, cur_w),
            report=PruneReport(
                stages=tuple(stages),
                n_clauses_before=before,
                n_clauses_after=_nonempty_count(cur_a),
                n_dead=n_dead,
                n_merged=n_merged,
                n_ranked=n_ranked,
                baseline_accuracy=baseline,
                pruned_accuracy=pruned_acc,
                tolerance=self.tolerance,
            ),
        )
