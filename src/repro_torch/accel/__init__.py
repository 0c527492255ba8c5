"""repro_torch.accel — the Accelerator façade of the port.

  capacity.py   CapacityPlan (the word-quantized synthesis-time envelope,
                derived from a model population) + CapacityExceeded
  engine.py     the Engine plugin protocol: @register_engine, needs_mesh,
                priority, make_engine (with ``mesh=``, ``device=``),
                select_engine (with ``mesh=``)
  engines.py    the built-in plugins: interp (the interp_stream kernel),
                plan (plain PyTorch), sharded (dist.tm_sharded on a mesh,
                the clause_table kernel), popcount (the tm_popcount kernel)
  program.py    TMProgram — the versioned, checksummed, wire-portable
                artifact, byte-identical to the reference package's
  facade.py     Accelerator — negotiate, compile, ship, load, serve
"""

from .capacity import (
    HEADROOM_KNOBS,
    QUANTA,
    CapacityExceeded,
    CapacityPlan,
    model_requirements,
)
from .engine import (
    ENGINES,
    Engine,
    EngineBase,
    engine_names,
    make_engine,
    register_engine,
    select_engine,
)
from .engines import InterpEngine, PlanEngine, PopcountEngine, ShardedEngine
from .program import FORMAT_VERSION, TMProgram
from .facade import Accelerator

# the structured serving exceptions and the ServingNode boundary are
# public on both packages (submodule imports only, safe against either
# package initializing first)
from ..serve_tm.batching import DeadlineExceeded
from ..serve_tm.node import NodeDown, ServingNode
from ..serve_tm.scheduler import EngineFault, Overloaded

__all__ = [
    "Accelerator",
    "CapacityExceeded",
    "CapacityPlan",
    "DeadlineExceeded",
    "ENGINES",
    "Engine",
    "EngineBase",
    "EngineFault",
    "FORMAT_VERSION",
    "HEADROOM_KNOBS",
    "InterpEngine",
    "NodeDown",
    "Overloaded",
    "PlanEngine",
    "PopcountEngine",
    "QUANTA",
    "ServingNode",
    "ShardedEngine",
    "TMProgram",
    "engine_names",
    "make_engine",
    "model_requirements",
    "register_engine",
    "select_engine",
]
