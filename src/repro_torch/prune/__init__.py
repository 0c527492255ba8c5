"""repro_torch.prune — ETHEREAL-style clause pruning + weighted clauses,
the port of ``repro.prune``.

The model-compression pass of the Fig-8 loop: it sits between the
``RecalWorker`` (which grows clauses) and the ``Compressor`` (which ships
them), shrinking the compressed program before publication.

Three passes over the dense action mask (all shape-preserving — a pruned
clause is a ZEROED clause row, which ``encode`` already skips, so the
instruction stream shrinks automatically and every downstream engine,
capacity and artifact path keeps working unchanged):

  * ``prune_exact``    drops only provably-dead clauses (empty,
                       contradictory, polarity-cancelled groups) —
                       bit-exact by construction;
  * ``merge_weighted`` collapses duplicate clauses into one weighted
                       clause (vote = weight * polarity) — bit-exact by
                       construction;
  * ``prune_ranked``   drops the low-vote-contribution tail subject to a
                       holdout accuracy tolerance (binary-searched cut),
                       scored on the card by the ``clause_eval`` kernel.

``PrunePolicy`` composes them into the gated pipeline the
``RecalController`` runs before every publication.
"""

from .rank import (
    clause_fire_counts,
    contradictory_clauses,
    dead_clause_mask,
    duplicate_groups,
    vote_contribution,
)
from .passes import (
    PrunePolicy,
    PruneReport,
    PruneResult,
    merge_weighted,
    prune_exact,
    prune_ranked,
)

__all__ = [
    "PrunePolicy",
    "PruneReport",
    "PruneResult",
    "clause_fire_counts",
    "contradictory_clauses",
    "dead_clause_mask",
    "duplicate_groups",
    "merge_weighted",
    "prune_exact",
    "prune_ranked",
    "vote_contribution",
]
