"""A pool of heterogeneous ``ServingNode``s — the fleet's membership and
lifecycle layer.

Nodes are named, joined and left at runtime, and may be ANY object that
satisfies the ``ServingNode`` boundary (a ``TMServer``, the
``repro_torch.accel.Accelerator`` façade, or a proxy for a remote box); each
brings its own negotiated ``CapacityPlan`` and engine, so a pool can mix
interp/plan/popcount nodes freely — the bit-exactness contract
makes them interchangeable for routing.

The pool answers the fleet-level questions the router and rollout
manager ask: which nodes exist, which host a slot, how deep is each
node's queue, and what does the fleet's aggregate traffic look like
(``metrics_summary`` collects each node's per-lane snapshot and rolls
them up via ``ServeMetrics.aggregate``).  It also owns whole-fleet
lifecycle (``start_all``/``stop_all``) and the initial slot deploy
(``install`` validates the artifact against every target node's OWN
capacity check first, so a heterogeneous fleet fails fast on the
misfitting node instead of half-deploying).
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Tuple

from ..accel.capacity import CapacityExceeded
from ..serve_tm.metrics import ServeMetrics
from ..serve_tm.node import ServingNode

logger = logging.getLogger(__name__)


def _validate_for_node(node, model, name: str, action: str) -> None:
    """Run ``node``'s own capacity check, re-raising with the node named
    (structured ``CapacityExceeded`` fields preserved)."""
    try:
        node.validate_model(model)
    except CapacityExceeded as e:
        raise CapacityExceeded(
            e.knob, e.required, e.capacity,
            what=f"{e.what} [node {name!r}, refusing {action}]",
        ) from e
    except ValueError as e:
        raise ValueError(
            f"{action} refused: node {name!r} cannot fit the model ({e})"
        ) from e


class FleetPool:
    """name -> ``ServingNode``, plus fleet-level lifecycle and rollups."""

    def __init__(
        self,
        nodes: Optional[Dict[str, ServingNode]] = None,
        *,
        max_warnings: int = 256,
    ):
        if max_warnings < 1:
            raise ValueError(
                f"max_warnings must be >= 1, got {max_warnings}"
            )
        self._nodes: Dict[str, ServingNode] = {}
        # drain/stop failures on dead nodes downgrade to entries here —
        # teardown always completes, operators read what it swallowed.
        # Ring-buffered: a long-lived pool with a flapping node keeps the
        # newest ``max_warnings`` entries instead of growing unboundedly.
        self.warnings: Deque[str] = deque(maxlen=max_warnings)
        for name, node in (nodes or {}).items():
            self.add(name, node)

    def clear_warnings(self) -> List[str]:
        """Drain the warning ring: returns what was recorded (oldest
        first) and empties the buffer — the operator's ack."""
        drained = list(self.warnings)
        self.warnings.clear()
        return drained

    # -- membership ----------------------------------------------------------

    def add(self, name: str, node: ServingNode) -> ServingNode:
        """Join ``node`` under ``name``.  The node must satisfy the
        ``ServingNode`` boundary — checked structurally up front so a
        misshapen node fails at join time, not mid-rollout."""
        if name in self._nodes:
            raise ValueError(f"node {name!r} already in the pool")
        if not isinstance(node, ServingNode):
            raise TypeError(
                f"node {name!r} ({type(node).__name__}) does not satisfy "
                f"the ServingNode protocol"
            )
        self._nodes[name] = node
        return node

    def remove(self, name: str, *, drain: bool = True) -> ServingNode:
        """Leave the pool; by default the node's loop is stopped and its
        queued traffic drained first so nothing admitted is stranded.
        A DEAD node (stop raises) is still removed: the failure becomes
        a recorded warning, never a stuck membership entry."""
        node = self.node(name)
        if drain:
            try:
                node.stop(drain=True)
            except Exception as e:
                self._warn(
                    f"removing node {name!r}: drain/stop failed "
                    f"({type(e).__name__}: {e}); detaching it anyway"
                )
        del self._nodes[name]
        return node

    def _warn(self, message: str) -> None:
        self.warnings.append(message)
        logger.warning("%s", message)

    def node(self, name: str) -> ServingNode:
        if name not in self._nodes:
            raise KeyError(
                f"no node {name!r} in the pool "
                f"(members: {self.names() or 'none'})"
            )
        return self._nodes[name]

    def names(self) -> List[str]:
        """Member names in join order (the rollout's stage order)."""
        return list(self._nodes)

    def items(self) -> List[Tuple[str, ServingNode]]:
        return list(self._nodes.items())

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    def __iter__(self) -> Iterator[str]:
        return iter(self._nodes)

    # -- fleet lifecycle -----------------------------------------------------

    def start_all(self) -> None:
        """Start every node's continuous-batching loop (idempotent)."""
        for node in self._nodes.values():
            node.start()

    def stop_all(self, drain: bool = True) -> None:
        """Stop every node; dead nodes downgrade to recorded warnings so
        fleet teardown always completes."""
        for name, node in self._nodes.items():
            try:
                node.stop(drain=drain)
            except Exception as e:
                self._warn(
                    f"stop_all: node {name!r} failed to stop "
                    f"({type(e).__name__}: {e}); continuing teardown"
                )

    # -- slot placement ------------------------------------------------------

    def nodes_with_slot(self, slot: str) -> List[Tuple[str, ServingNode]]:
        """Members currently hosting ``slot`` (the router's candidates),
        in join order; nodes that cannot answer (dead) are skipped."""
        hosting = []
        for name, node in self._nodes.items():
            try:
                if slot in node.slots():
                    hosting.append((name, node))
            except Exception:
                continue  # unreachable — it can't serve the slot anyway
        return hosting

    def install(
        self,
        slot: str,
        artifact,
        nodes: Optional[List[str]] = None,
        provenance: str = "fleet:install",
    ) -> Dict[str, object]:
        """Deploy ``artifact`` into ``slot`` on ``nodes`` (default: every
        member).  All targets are capacity-validated FIRST — a
        heterogeneous fleet raises the misfitting node's
        ``CapacityExceeded`` before any node is touched, so a failed
        deploy never leaves the fleet half-programmed."""
        from ..accel.program import TMProgram

        targets = [(n, self.node(n)) for n in (nodes or self.names())]
        model = (
            artifact.model if isinstance(artifact, TMProgram)
            else TMProgram.from_bytes(artifact).model
            if isinstance(artifact, (bytes, bytearray, memoryview))
            else artifact
        )
        for name, node in targets:
            _validate_for_node(node, model, name,
                               f"fleet install of slot {slot!r}")
        return {
            name: node.register(slot, artifact, provenance=provenance)
            for name, node in targets
        }

    # -- fleet introspection -------------------------------------------------

    def queue_depths(self, slot: Optional[str] = None) -> Dict[str, int]:
        """Per-node pending rows (the router's load signal); nodes that
        cannot answer (dead) are omitted."""
        depths = {}
        for name, node in self._nodes.items():
            try:
                depths[name] = node.queue_depth(slot)
            except Exception:
                continue
        return depths

    def metrics_summary(self) -> Dict:
        """``{"aggregate": <fleet rollup>, "nodes": {name: snapshot},
        "unreachable": [names]}`` — per-node ``metrics_snapshot()`` dicts
        plus the ``ServeMetrics.aggregate`` rollup (schema:
        serve_tm/schema.py); the rollup covers the nodes that answered."""
        snaps: Dict[str, Dict] = {}
        unreachable: List[str] = []
        for name, node in self._nodes.items():
            try:
                snaps[name] = node.metrics_snapshot()
            except Exception:
                unreachable.append(name)
        return {
            "aggregate": ServeMetrics.aggregate(list(snaps.values())),
            "nodes": snaps,
            "unreachable": unreachable,
        }

    def __repr__(self) -> str:
        return f"FleetPool({self.names()})"
