"""DEPRECATED shim — the executor layer moved to ``repro_torch.accel``, the
port of ``repro.serve_tm.executors``.

The serving engines are formal plugins (``repro_torch.accel.engines``)
behind the ``Engine`` protocol, capacity is the negotiated
``CapacityPlan``, and deployment goes through the ``Accelerator`` façade
(``repro_torch.accel.facade``).  The old names stay importable here:

    ServeCapacity      -> accel.capacity.CapacityPlan  (same knobs,
                          same defaults; capacity errors are the
                          structured CapacityExceeded, still a ValueError)
    InterpExecutor     -> accel.engines.InterpEngine
    PlanExecutor       -> accel.engines.PlanEngine
    ShardedExecutor    -> accel.engines.ShardedEngine
    PopcountExecutor   -> accel.engines.PopcountEngine
    BACKENDS           -> accel.engine.ENGINES (the live plugin registry)
    make_executor(...) -> accel.engine.make_engine(...)

Importing this module emits a ``DeprecationWarning`` once per process (the
module body runs only on first import); ``make_executor`` warns too.
"""

from __future__ import annotations

import warnings

from ..accel.capacity import CapacityExceeded, CapacityPlan
from ..accel.engine import ENGINES, EngineBase, make_engine
from ..accel.engines import InterpEngine, PlanEngine, PopcountEngine, ShardedEngine

warnings.warn(
    "repro_torch.serve_tm.executors is deprecated: the executor layer moved "
    "to repro_torch.accel (ServeCapacity -> CapacityPlan, make_executor -> "
    "make_engine, BACKENDS -> ENGINES, *Executor -> accel.engines.*Engine)",
    DeprecationWarning,
    stacklevel=2,
)

# legacy spellings
ServeCapacity = CapacityPlan
InterpExecutor = InterpEngine
PlanExecutor = PlanEngine
ShardedExecutor = ShardedEngine
PopcountExecutor = PopcountEngine
_ExecutorBase = EngineBase
BACKENDS = ENGINES


def make_executor(
    backend: "str | EngineBase", capacity: CapacityPlan, mesh=None, *,
    device=None,
) -> EngineBase:
    """Deprecated: use ``repro_torch.accel.make_engine`` (on ``device``,
    the card unless ``device="cpu"``; the mesh goes to mesh engines)."""
    warnings.warn(
        "make_executor is deprecated; use repro_torch.accel.make_engine",
        DeprecationWarning,
        stacklevel=2,
    )
    return make_engine(backend, capacity, mesh=mesh, device=device)


__all__ = [
    "BACKENDS",
    "CapacityExceeded",
    "InterpExecutor",
    "PlanExecutor",
    "PopcountExecutor",
    "ServeCapacity",
    "ShardedExecutor",
    "make_executor",
]
