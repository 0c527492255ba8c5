"""Include actions of a configuration's machine, made from a seed.

Clauses alternate polarity (even positive, odd negative).  Each clause
takes its includes among the literals that are true on one seeded
datapoint: of its own class for a positive clause, of another class for
a negative one, so that clauses fire on rows like that datapoint and
class sums vary.  The machine has exactly ``work.n_includes(config)``
includes on every seed, spread as evenly as whole numbers allow (each
clause holds ``n // (M C)`` or one more), so the work per row is the
same whatever the seed.
"""

from __future__ import annotations

import torch

from .reference.data import DataSource, generator
from .work import n_includes


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
