"""The ``ServingNode`` boundary — the minimal contract one serving node
exposes to everything that operates ON nodes rather than inside them.

``TMServer`` and the ``repro_torch.accel.Accelerator`` façade both satisfy
it; fleets (pools, the router, canary rollouts) and recalibration
controllers are written against THIS surface only,
so anything that speaks it — a local server, the façade, a proxy for a
remote accelerator — can join a fleet or host a recal loop.

The protocol deliberately stays at the node boundary:

  * traffic:      ``submit`` / ``async_submit`` (priority lanes,
                  deadlines, admission control live behind them),
                  ``infer`` (sync convenience), ``class_sums`` (the
                  direct oracle hook bit-exactness gates use),
                  ``flush`` and the ``start``/``stop`` loop lifecycle;
  * programming:  ``register`` / ``rollback`` — the drain-then-swap
                  discipline and provenance chains are the NODE's job,
                  callers just name the slot;
  * introspection: ``capacity`` (the negotiated ``CapacityPlan`` a
                  router filters on), ``validate_model`` (the exact
                  will-it-fit check this node's engine applies),
                  ``queue_depth`` (the router's load signal),
                  ``metrics_snapshot`` (the per-lane ``summary()``
                  dict — see serve_tm/schema.py), ``slots`` and the
                  per-slot installed-artifact ``installed_checksum`` /
                  ``installed_artifact`` (what rollout gating audits).

Engine objects, registries and schedulers are implementation details a
node keeps to itself; nothing above this boundary may reach for them.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, runtime_checkable

import numpy as np


class NodeDown(RuntimeError):
    """A node stopped responding entirely — every boundary call fails.

    The structured fleet-level failure: raised by a dead node's proxy (or
    the chaos wrapper standing in for one) on ANY boundary operation, and
    by the fleet health layer when it fails the pending handles of a node
    declared dead.  Carries ``node`` (the name, when known) and ``op``
    (the boundary call that hit the corpse) so routers and rollouts can
    quarantine without string parsing."""

    def __init__(self, node: str = "?", op: str = ""):
        self.node = node
        self.op = op
        where = f" (during {op!r})" if op else ""
        super().__init__(
            f"node {node!r} is not responding{where} — it has stopped "
            f"serving; quarantine it and route around"
        )


@runtime_checkable
class ServingNode(Protocol):
    """One deployed accelerator, seen from the outside."""

    # -- traffic -------------------------------------------------------------

    def submit(
        self,
        slot: str,
        x: np.ndarray,
        *,
        priority: str = "normal",
        timeout_ms: Optional[float] = None,
    ): ...

    async def async_submit(
        self,
        slot: str,
        x: np.ndarray,
        *,
        priority: str = "normal",
        timeout_ms: Optional[float] = None,
    ): ...

    def flush(self) -> None: ...

    def infer(self, slot: str, x: np.ndarray) -> np.ndarray: ...

    def class_sums(self, slot: str, x: np.ndarray) -> np.ndarray: ...

    def start(self) -> None: ...

    def stop(self, drain: bool = True) -> None: ...

    @property
    def scheduler_running(self) -> bool: ...

    # -- programming (drain-then-swap is the node's responsibility) ----------

    def register(self, slot: str, model, provenance: str = "install"): ...

    def rollback(self, slot: str): ...

    # -- introspection (what routers / rollouts / recal loops key on) --------

    @property
    def capacity(self): ...

    def validate_model(self, model) -> None: ...

    def queue_depth(
        self, slot: Optional[str] = None, priority: Optional[str] = None
    ) -> int: ...

    def metrics_snapshot(self) -> dict: ...

    def slots(self) -> List[str]: ...

    def installed_checksum(self, slot: str) -> Optional[int]: ...

    def installed_artifact(self, slot: str): ...

    def compile_cache_size(self) -> int: ...
