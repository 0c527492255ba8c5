"""Fleet routing: capacity-fit filtering + least-queue-depth dispatch
over a ``FleetPool``, speaking the same priority/deadline semantics as a
single node — now health-gated and retrying.

A request names a SLOT, not a node.  The router's job:

  * eligibility — only nodes hosting the slot are candidates (placement
    itself is capacity-fit filtered: ``replicate``/``FleetPool.install``
    run each target node's own ``validate_model`` before programming),
    and the ``FleetHealth`` circuit breaker prunes them further:
    quarantined nodes are skipped until their probe cooldown elapses,
    at which point exactly ONE request is let through half-open;
  * load balancing — among candidates, the node with the fewest pending
    rows wins (ties break by pool join order, so routing is
    deterministic for a given load picture);
  * retry/failover — ``submit``, ``async_submit`` and ``infer`` all run
    the same ``RetryPolicy`` loop: candidates are swept least-loaded
    first, a node that raises (``Overloaded``, an engine exception,
    ``NodeDown``) is failed over within the sweep, and between sweeps
    the router backs off exponentially — but NEVER past the request's
    remaining ``timeout_ms`` deadline budget; when the budget (or the
    attempt bound) is exhausted the LAST structured error propagates.
    Every outcome is recorded into the health tracker: successes beat
    the heartbeat, failures drive the breaker, ``Overloaded`` counts as
    backpressure only;
  * the serving lanes' semantics ride through untouched — ``priority=``
    picks the lane and ``timeout_ms=`` stamps the deadline ON THE CHOSEN NODE
    (the *remaining* budget, not the original, after any backoff),
    whose scheduler applies EDF/shedding/admission exactly as if the
    caller had spoken to it directly;
  * hot-slot replication — ``replicate`` re-ships the slot's installed
    ``TMProgram`` artifact to more nodes (least-loaded, capacity-fit
    first), widening the candidate set under load.

Every handle the router returns is tagged ``handle.routed_to`` with the
chosen node's name, and the serving node's own ``ServeMetrics`` gains
``retries``/``failovers`` counts, so callers (and the fleet bench) can
audit placement and the retry path without reaching past the boundary.
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional, Tuple

from ..accel.capacity import CapacityExceeded
from ..serve_tm.node import ServingNode
from ..serve_tm.scheduler import Overloaded
from .health import FleetHealth, HALF_OPEN, QUARANTINED, RetryPolicy
from .pool import FleetPool


class NoEligibleNode(RuntimeError):
    """No pool member can serve the request.

    Structured fields (``slot``, ``reason``, ``candidates``) so callers
    can distinguish "slot deployed nowhere" from "no node fits" from
    "every host quarantined"."""

    def __init__(self, slot: str, reason: str, candidates: List[str]):
        self.slot = slot
        self.reason = reason
        self.candidates = candidates
        super().__init__(
            f"no eligible node for slot {slot!r}: {reason} "
            f"(pool members: {candidates or 'none'})"
        )


class Router:
    def __init__(
        self,
        pool: FleetPool,
        *,
        health: Optional[FleetHealth] = None,
        retry: Optional[RetryPolicy] = None,
    ):
        self.pool = pool
        self.health = health if health is not None else FleetHealth(pool=pool)
        self.retry = retry if retry is not None else RetryPolicy()

    # -- candidate selection -------------------------------------------------

    def candidates(self, slot: str) -> List[Tuple[str, ServingNode]]:
        """Healthy nodes hosting ``slot``, least-loaded first (pending
        rows across all slots — the engine is shared per node, so the
        whole backlog delays a new request, not just the slot's share).
        Ties break by pool join order.  Quarantined nodes are skipped
        unless their probe cooldown elapsed, in which case the node is
        offered FIRST so the next request probes it half-open; a node
        whose introspection raises (dead mid-listing) is recorded as a
        failure and skipped."""
        order = {name: i for i, name in enumerate(self.pool.names())}
        hosting: List[Tuple[int, int, str, ServingNode]] = []
        probes: List[Tuple[str, ServingNode]] = []
        skipped = 0
        for name, node in self.pool.items():
            state = self.health.state(name)
            if state == HALF_OPEN:
                skipped += 1  # a probe is already in flight
                continue
            if state == QUARANTINED and not self.health.probe_due(name):
                skipped += 1
                continue
            try:
                if slot not in node.slots():
                    continue
                depth = node.queue_depth()
            except Exception as e:
                self.health.record_failure(name, e)
                skipped += 1
                continue
            if state == QUARANTINED:
                probes.append((name, node))
            else:
                hosting.append((depth, order[name], name, node))
        hosting.sort()
        result = probes + [(name, node) for _, _, name, node in hosting]
        if not result:
            if skipped:
                raise NoEligibleNode(
                    slot, f"{skipped} node(s) quarantined or unreachable "
                    f"and no healthy node hosts this slot",
                    self.pool.names(),
                )
            raise NoEligibleNode(
                slot, "no node hosts this slot — deploy or replicate it "
                "first", self.pool.names(),
            )
        return result

    def route(self, slot: str) -> Tuple[str, ServingNode]:
        """The node the next request for ``slot`` should land on."""
        return self.candidates(slot)[0]

    # -- the shared retry/failover loop --------------------------------------

    def _record_ok(self, name, node, latency_s, retried, failed_over):
        self.health.record_success(name, latency_s)
        if retried:
            self.health.record_retry(name)
            self._bump(node, "record_retry")
        if failed_over:
            self.health.record_failover(name)
            self._bump(node, "record_failover")

    @staticmethod
    def _bump(node, method: str) -> None:
        """Best-effort mirror into the serving node's own ServeMetrics."""
        try:
            metrics = getattr(node, "metrics", None)
            if metrics is not None:
                getattr(metrics, method)()
        except Exception:
            pass

    # -- traffic -------------------------------------------------------------

    def submit(
        self,
        slot: str,
        x,
        *,
        priority: str = "normal",
        timeout_ms: Optional[float] = None,
    ):
        """Queue the request on the least-loaded healthy hosting node;
        fails over on engine exceptions / ``NodeDown`` / ``Overloaded``
        and retries with backoff inside the deadline budget.  Returns
        the serving node's ``RequestHandle`` tagged ``.routed_to``."""
        retry = self.retry
        deadline = retry.deadline_for(timeout_ms)
        attempts = sweeps = 0
        retried = failed_over = False
        last: Optional[BaseException] = None
        while attempts < retry.max_attempts:
            try:
                cands = self.candidates(slot)
            except NoEligibleNode as e:
                if last is not None:
                    raise last
                raise e
            for name, node in cands:
                if attempts >= retry.max_attempts:
                    break
                remaining = retry.remaining_ms(deadline)
                if remaining is not None and remaining <= 0:
                    raise last if last is not None else TimeoutError(
                        f"slot {slot!r}: deadline budget exhausted "
                        f"before any node accepted the request"
                    )
                attempts += 1
                if self.health.state(name) == QUARANTINED:
                    self.health.begin_probe(name)
                t0 = retry.clock()
                try:
                    handle = node.submit(
                        slot, x, priority=priority, timeout_ms=remaining
                    )
                except Overloaded as e:
                    self.health.record_overload(name)
                    last = e
                    failed_over = True
                    continue
                except Exception as e:
                    self.health.record_failure(name, e)
                    last = e
                    failed_over = True
                    continue
                self._record_ok(
                    name, node, retry.clock() - t0, retried,
                    failed_over and attempts > 1,
                )
                handle.routed_to = name
                return handle
            if attempts >= retry.max_attempts:
                break
            delay = retry.backoff_s(sweeps)
            sweeps += 1
            if not retry.budget_allows(deadline, delay):
                break  # never sleep past the remaining deadline budget
            retry.sleep(delay)
            retried = True
        assert last is not None
        raise last

    async def async_submit(
        self,
        slot: str,
        x,
        *,
        priority: str = "normal",
        timeout_ms: Optional[float] = None,
    ):
        """``submit`` with the node's admission-controlled async front
        door; the same retry/failover/deadline-budget loop, with async
        backoff sleeps (unless an injected policy ``sleep`` overrides)."""
        retry = self.retry
        deadline = retry.deadline_for(timeout_ms)
        attempts = sweeps = 0
        retried = failed_over = False
        last: Optional[BaseException] = None
        while attempts < retry.max_attempts:
            try:
                cands = self.candidates(slot)
            except NoEligibleNode as e:
                if last is not None:
                    raise last
                raise e
            for name, node in cands:
                if attempts >= retry.max_attempts:
                    break
                remaining = retry.remaining_ms(deadline)
                if remaining is not None and remaining <= 0:
                    raise last if last is not None else TimeoutError(
                        f"slot {slot!r}: deadline budget exhausted "
                        f"before any node accepted the request"
                    )
                attempts += 1
                if self.health.state(name) == QUARANTINED:
                    self.health.begin_probe(name)
                t0 = retry.clock()
                try:
                    handle = await node.async_submit(
                        slot, x, priority=priority, timeout_ms=remaining
                    )
                except Overloaded as e:
                    self.health.record_overload(name)
                    last = e
                    failed_over = True
                    continue
                except Exception as e:
                    self.health.record_failure(name, e)
                    last = e
                    failed_over = True
                    continue
                self._record_ok(
                    name, node, retry.clock() - t0, retried,
                    failed_over and attempts > 1,
                )
                handle.routed_to = name
                return handle
            if attempts >= retry.max_attempts:
                break
            delay = retry.backoff_s(sweeps)
            sweeps += 1
            if not retry.budget_allows(deadline, delay):
                break  # never sleep past the remaining deadline budget
            if retry.sleep is time.sleep:
                await asyncio.sleep(delay)
            else:
                retry.sleep(delay)  # injected (tests drive fake time)
            retried = True
        assert last is not None
        raise last

    def infer(self, slot: str, x):
        """Synchronous convenience: route + the node's submit/drain,
        with the same failover/backoff loop (no deadline — ``infer``
        carries no timeout)."""
        retry = self.retry
        attempts = sweeps = 0
        retried = failed_over = False
        last: Optional[BaseException] = None
        while attempts < retry.max_attempts:
            try:
                cands = self.candidates(slot)
            except NoEligibleNode as e:
                if last is not None:
                    raise last
                raise e
            for name, node in cands:
                if attempts >= retry.max_attempts:
                    break
                attempts += 1
                if self.health.state(name) == QUARANTINED:
                    self.health.begin_probe(name)
                t0 = retry.clock()
                try:
                    preds = node.infer(slot, x)
                except Overloaded as e:
                    self.health.record_overload(name)
                    last = e
                    failed_over = True
                    continue
                except Exception as e:
                    self.health.record_failure(name, e)
                    last = e
                    failed_over = True
                    continue
                self._record_ok(
                    name, node, retry.clock() - t0, retried,
                    failed_over and attempts > 1,
                )
                return preds
            if attempts >= retry.max_attempts:
                break
            delay = retry.backoff_s(sweeps)
            sweeps += 1
            retry.sleep(delay)
            retried = True
        assert last is not None
        raise last

    # -- hot-slot replication ------------------------------------------------

    def replicate(
        self,
        slot: str,
        n: int = 1,
        *,
        artifact=None,
        provenance: Optional[str] = None,
    ) -> List[str]:
        """Install ``slot`` on up to ``n`` more nodes (hot-slot scaling).

        The artifact re-shipped is the one a hosting node records for the
        slot (``installed_checksum``'s subject), unless ``artifact``
        overrides it.  Targets are the non-hosting nodes whose OWN
        capacity check accepts the model — capacity-fit filtering, the
        per-node half of routing — least-loaded first; nodes that raise
        mid-check (dead) are recorded as failures and skipped.  Returns
        the node names that received the slot (may be shorter than ``n``
        when the fleet runs out of fitting nodes)."""
        hosting = self.pool.nodes_with_slot(slot)
        if artifact is None:
            if not hosting:
                raise NoEligibleNode(
                    slot, "no node hosts this slot and no artifact was "
                    "given to replicate from", self.pool.names(),
                )
            src_name, src = hosting[0]
            artifact = src.installed_artifact(slot)
            if artifact is None:
                raise ValueError(
                    f"slot {slot!r} on node {src_name!r} was programmed "
                    f"from a bare model, not a TMProgram artifact — "
                    f"pass artifact= to replicate it"
                )
            if provenance is None:
                provenance = f"replicate:{src_name}"
        if provenance is None:
            provenance = "replicate"
        hosting_names = {name for name, _ in hosting}
        order = {name: i for i, name in enumerate(self.pool.names())}
        targets = []
        for name, node in self.pool.items():
            if name in hosting_names:
                continue
            if self.health.state(name) in (QUARANTINED, HALF_OPEN):
                continue  # don't widen onto a node the breaker distrusts
            try:
                node.validate_model(artifact.model)
                depth = node.queue_depth()
            except CapacityExceeded:
                continue  # capacity-fit filtering: this node can't host it
            except Exception as e:
                self.health.record_failure(name, e)
                continue
            targets.append((depth, order[name], name, node))
        targets.sort()
        installed = []
        for _, _, name, node in targets[: max(0, n)]:
            node.register(slot, artifact, provenance=provenance)
            installed.append(name)
        return installed
