"""Elastic scaling: reshard a training state onto a different mesh, the
port of ``repro.runtime_ft.elastic``.

When the supervisor evicts a straggler/dead host (or capacity grows), the
job restarts on a new mesh.  The checkpoint is mesh-agnostic (full logical
arrays, see checkpoint/manager.py); this module recomputes shardings for
the new mesh and re-places state.  ``plan_new_mesh`` picks the largest
axis-consistent mesh that fits the surviving chip count.

``reshard_state`` takes the reference's parameter checkpoint (``like``
the params) and also the train state ``launch.train`` writes (``like`` a
dict with ``"params"``, optionally ``"opt"``, and other leaves such as
the data position): params by ``param_shardings``, the optimizer state by
``opt_shardings``, every other leaf replicated.  The reference passes the
params' shardings whatever ``like`` is, so it restores only the former.
"""

from __future__ import annotations

from typing import Any, Tuple

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ArchConfig
from ..dist import sharding as shd


def plan_new_mesh(n_chips: int, *, model_parallel: int = 16) -> Tuple[int, int]:
    """-> (data, model) shape using as many surviving chips as possible while
    keeping the model axis intact (TP degree is a property of the weights'
    layout; shrinking it would change per-op shapes)."""
    if n_chips < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with {n_chips} chips"
        )
    data = n_chips // model_parallel
    return data, model_parallel


def reshard_state(
    cfg: ArchConfig,
    ckpt: CheckpointManager,
    step: int,
    like: Any,
    new_mesh,
) -> Any:
    """Restore checkpoint ``step`` placed for ``new_mesh``."""
    from ..models.api import family_for

    p_sh = shd.param_shardings(cfg, new_mesh, family_for(cfg).param_specs(cfg))
    if isinstance(like, dict) and "params" in like:
        shardings = {k: shd.map_leaves(lambda _: shd.replicated(new_mesh), v)
                     for k, v in like.items()}
        shardings["params"] = p_sh
        if "opt" in like:
            shardings["opt"] = shd.opt_shardings(cfg, new_mesh, None, p_sh)
    else:
        shardings = p_sh
    return ckpt.restore(step, like=like, shardings=shardings)
