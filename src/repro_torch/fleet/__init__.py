"""repro_torch.fleet — routed replica pools with canary artifact rollouts,
a copy of ``repro.fleet`` over the port's serving nodes.

The fleet layer stacks on the ``ServingNode`` boundary (serve_tm/node.py):
anything that satisfies the protocol — a ``TMServer``, the
``repro_torch.accel.Accelerator`` façade, a remote proxy — can join a pool,
and the fleet machinery never reaches past the boundary into a node's
registry, engine or scheduler.

  pool.py      FleetPool — named membership, whole-fleet lifecycle
               (dead-node tolerant teardown), capacity-validated slot
               deploys, aggregate metrics rollup
  router.py    Router — capacity-fit + least-queue-depth routing with
               the serving lanes' priority/deadline semantics,
               health-gated candidates, retry/backoff failover on
               Overloaded / engine exceptions / NodeDown, hot-slot
               replication; structured NoEligibleNode
  health.py    FleetHealth — per-node circuit breaker (healthy →
               degraded → quarantined → half-open probe → healthy) over
               runtime_ft.supervisor's heartbeat/straggler trackers;
               RetryPolicy — bounded attempts, exponential backoff,
               hard deadline budget
  chaos.py     ChaosNode — deterministic seeded fault injection at the
               ServingNode boundary (errors, latency, Overloaded storms,
               hung handles, NodeDown, corrupted artifacts)
  rollout.py   RolloutManager — canary → wave → fleet-wide TMProgram
               shipping, gated per stage on installed checksum, served
               bit-exactness and holdout accuracy, with fleet-wide
               rollback (structured RolloutAborted carrying the
               RolloutReport); mid-wave node death is a gate failure,
               rollback completes on the reachable nodes

The structured exceptions ``NodeDown`` and ``EngineFault`` are stable
exports here and on ``repro_torch.serve_tm`` (same objects).
"""

from ..serve_tm.node import NodeDown, ServingNode
from ..serve_tm.scheduler import EngineFault
from .chaos import ChaosNode
from .health import FleetHealth, RetryPolicy
from .pool import FleetPool
from .rollout import (
    RolloutAborted,
    RolloutManager,
    RolloutReport,
    StageReport,
    plan_stages,
)
from .router import NoEligibleNode, Router

__all__ = [
    "ChaosNode",
    "EngineFault",
    "FleetHealth",
    "FleetPool",
    "NoEligibleNode",
    "NodeDown",
    "RetryPolicy",
    "RolloutAborted",
    "RolloutManager",
    "RolloutReport",
    "Router",
    "ServingNode",
    "StageReport",
    "plan_stages",
]
