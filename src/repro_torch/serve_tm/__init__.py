"""Multi-tenant batched serving over the port's accelerator engines.

  batching.py    priority-lane request queues, EDF batch formation,
                 deadline shedding, 32-datapoint-word coalescing, demux
  scheduler.py   the continuous-batching flush loop + admission control
  registry.py    named model slots with hot-swap + bounded history
  metrics.py     latency/throughput instrumentation
  server.py      TMServer — submit/flush/infer plus start/stop/async_submit
  node.py        ServingNode — the node boundary
  schema.py      the ServeMetrics.summary() key schema

Copies of ``repro.serve_tm`` (numpy, asyncio, threads); only the engine
underneath is the port's.
"""

from ..accel.capacity import CapacityExceeded
from .batching import Batcher, DeadlineExceeded, PRIORITIES, RequestHandle
from .metrics import ServeMetrics
from .node import NodeDown, ServingNode
from .registry import ModelRegistry, SlotEntry
from .scheduler import EngineFault, Overloaded, Scheduler
from .server import TMServer

__all__ = [
    "Batcher",
    "CapacityExceeded",
    "DeadlineExceeded",
    "EngineFault",
    "ModelRegistry",
    "NodeDown",
    "Overloaded",
    "PRIORITIES",
    "RequestHandle",
    "Scheduler",
    "ServeMetrics",
    "ServingNode",
    "SlotEntry",
    "TMServer",
]
