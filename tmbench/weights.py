"""Include actions and clause weights of a configuration's machine, made
from a seed.

Clauses alternate polarity (even positive, odd negative).  Each clause
takes its includes among the literals that are true on one seeded
datapoint: of its own class for a positive clause, of another class for
a negative one, so that clauses fire on rows like that datapoint and
class sums vary.  The machine has exactly ``work.n_includes(config)``
includes on every seed, spread as evenly as whole numbers allow (each
clause holds ``n // (M C)`` or one more), so the work per row is the
same whatever the seed.

A weighted configuration (the weighted Tsetlin Machine, arXiv:1911.12607;
the weighted merge of ETHEREAL, arXiv:2502.05640) declares
``"weighted": true`` and ``"clause_weights": {"dist": "log_uniform",
"min": a, "max": W}`` with 1 <= a <= W <= 65535 (the wire's uint16):
log-uniform over [a, W + 1), floored to whole weights.  A weightless one declares ``"weighted": false`` (or nothing)
and no ``clause_weights``.  Each clause votes ``weight * pol``.  The
weights come from a stream of their own, ``generator(dev, seed,
"clause_weights")``, so the data, the include actions and the requests
of a seed are the same with and without weights, and a weightless
configuration draws nothing more.  One seeded clause holds ``max`` on
every seed, so the served program has ``W.bit_length()`` weight planes
whatever the seed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .reference.data import DataSource, generator
from .work import n_includes

MAX_WEIGHT = 0xFFFF  # the program's wire carries each weight as a uint16
WEIGHT_DISTS = ("log_uniform",)


def weight_spec(config: dict) -> Optional[dict]:
    """The configuration's ``clause_weights`` entry, or None where it is
    weightless; raises ``ValueError`` where ``weighted`` and
    ``clause_weights`` disagree or the entry is out of range."""
    weighted = config.get("weighted", False)
    spec = config.get("clause_weights")
    if not isinstance(weighted, bool):
        raise ValueError(f"weighted must be true or false, not {weighted!r}")
    if weighted != (spec is not None):
        raise ValueError(
            f"weighted is {str(weighted).lower()} but clause_weights is "
            f"{'absent' if spec is None else 'given'}: a weighted configuration "
            "declares both, a weightless one neither")
    if spec is None:
        return None
    if spec.get("dist") not in WEIGHT_DISTS:
        raise ValueError(f"clause_weights dist must be one of {WEIGHT_DISTS}")
    lo, hi = int(spec["min"]), int(spec["max"])
    if not 1 <= lo <= hi <= MAX_WEIGHT:
        raise ValueError(f"clause_weights needs 1 <= min <= max <= {MAX_WEIGHT}")
    return spec


def clause_weights(config: dict, seed: int, device="cpu") -> Optional[torch.Tensor]:
    """int32[M, C] on ``device``, or None for a weightless configuration."""
    spec = weight_spec(config)
    if spec is None:
        return None
    M, C = int(config["n_classes"]), int(config["n_clauses"])
    lo, hi = int(spec["min"]), int(spec["max"])
    g = generator(device, seed, "clause_weights")
    u = torch.rand((M * C,), generator=g, device=device, dtype=torch.float64)
    w = torch.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    w = w.floor().clamp(lo, hi).to(torch.int32)
    w[torch.randint(0, M * C, (1,), generator=g, device=device)] = hi
    return w.reshape(M, C)


def include_actions(config: dict, source: DataSource, seed: int) -> torch.Tensor:
    """bool[M, C, 2F] on the source's device."""
    M, C, F = (int(config[k]) for k in ("n_classes", "n_clauses", "n_features"))
    dev = source.device
    g = generator(dev, seed, "weights")
    n_cl = M * C
    cls = torch.arange(M, device=dev).repeat_interleave(C)
    negative = (torch.arange(n_cl, device=dev) % C) % 2 == 1
    other = (cls + torch.randint(1, M, (n_cl,), generator=g, device=dev)) % M
    exemplar = source.rows_of(torch.where(negative, other, cls), "exemplars")
    total = n_includes(config)
    per = torch.full((n_cl,), total // n_cl, dtype=torch.int64, device=dev)
    per[torch.randperm(n_cl, generator=g, device=dev)[: total % n_cl]] += 1
    kmax = int(per.max())
    if kmax > F:
        raise ValueError(f"{kmax} includes per clause exceed {F} features")
    order = torch.rand((n_cl, F), generator=g, device=dev).argsort(dim=1)[:, :kmax]
    keep = torch.arange(kmax, device=dev)[None, :] < per[:, None]
    # literal 2j is feature j, 2j + 1 its negation: take the true one
    lit = 2 * order + 1 - exemplar.gather(1, order).to(torch.int64)
    actions = torch.zeros((n_cl, 2 * F), dtype=torch.bool, device=dev)
    rows = torch.arange(n_cl, device=dev)[:, None].expand(-1, kmax)
    actions[rows[keep], lit[keep]] = True
    return actions.reshape(M, C, 2 * F)
