"""``ChaosNode`` — deterministic fault injection at the ServingNode
boundary.

Wraps any ``ServingNode`` and injects the fleet's whole fault taxonomy
from a SEEDED schedule: same seed + same call sequence → the identical
fault sequence (``fault_log``), replayable in tests and benchmarks.  No
wall-clock anywhere — latency faults go through an injectable ``sleep``
and the schedule is driven by operation COUNT, not time.

Faults, per boundary operation (one RNG draw per op, always, so the
schedule stays aligned even when every rate is zero):

  * ``error``    — the op raises (models an engine/transport exception);
  * ``latency``  — the op is served, ``latency_s`` late;
  * ``overload`` — submit raises the structured ``Overloaded`` (storms);
  * ``hang``     — submit returns a handle that will NEVER complete
                   (the pathology retry/timeout budgets exist for);
  * ``down``     — the node dies: THIS op and every later one raise
                   ``NodeDown`` and all pending handles it issued are
                   failed (``down_after_ops`` schedules the same thing
                   deterministically; ``kill()``/``revive()`` script it);
  * ``corrupt``  — install-path only: the shipped ``TMProgram`` bytes
                   get one bit flipped before reaching the inner node,
                   whose CRC-32 integrity check MUST reject them.

Because ``ChaosNode`` satisfies ``ServingNode`` itself, pools, routers
and rollouts exercise their failure handling against the exact surface
a real flaky transport proxy would present.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..accel.program import TMProgram
from ..serve_tm.batching import RequestHandle
from ..serve_tm.node import NodeDown
from ..serve_tm.scheduler import Overloaded

# traffic ops draw from these; "corrupt" only applies to register()
TRAFFIC_FAULTS = ("error", "latency", "overload", "hang", "down")

_hung_ids = itertools.count(-1, -1)  # negative rids: never clash with real


class ChaosNode:
    """A ``ServingNode`` that misbehaves on a deterministic schedule."""

    def __init__(
        self,
        inner,
        *,
        name: str = "chaos",
        seed: int = 0,
        error_rate: float = 0.0,
        latency_rate: float = 0.0,
        latency_s: float = 0.002,
        overload_rate: float = 0.0,
        hang_rate: float = 0.0,
        down_rate: float = 0.0,
        corrupt_rate: float = 0.0,
        down_after_ops: Optional[int] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        rates = {
            "error": error_rate, "latency": latency_rate,
            "overload": overload_rate, "hang": hang_rate,
            "down": down_rate, "corrupt": corrupt_rate,
        }
        for kind, rate in rates.items():
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{kind}_rate must be in [0, 1], got {rate}")
        self.inner = inner
        self.name = name
        self.seed = seed
        self.rates = rates
        self.latency_s = latency_s
        self.down_after_ops = down_after_ops
        self.sleep = sleep
        self._rng = np.random.default_rng(seed)
        self._ops = 0
        self._down = False
        # (op index, op name, fault-or-"ok") — the replayable schedule
        self.fault_log: List[Tuple[int, str, str]] = []
        self._issued: List[RequestHandle] = []

    # -- the schedule --------------------------------------------------------

    def _draw(self, op: str, kinds: Tuple[str, ...]) -> Optional[str]:
        """One op: check liveness, advance the schedule, pick the fault.

        Exactly one RNG draw happens per op regardless of rates or the
        kinds eligible for this op — determinism must not depend on
        which faults a particular call site can express."""
        if self._down:
            raise NodeDown(self.name, op)
        self._ops += 1
        if (
            self.down_after_ops is not None
            and self._ops > self.down_after_ops
        ):
            self.fault_log.append((self._ops, op, "down"))
            self.kill()
            raise NodeDown(self.name, op)
        u = float(self._rng.random())
        fault = None
        edge = 0.0
        for kind in kinds:
            edge += self.rates[kind]
            if u < edge:
                fault = kind
                break
        self.fault_log.append((self._ops, op, fault or "ok"))
        if fault == "down":
            self.kill()
            raise NodeDown(self.name, op)
        if fault == "error":
            raise RuntimeError(
                f"chaos[{self.name}]: injected fault during {op}"
            )
        if fault == "latency":
            self.sleep(self.latency_s)
        return fault

    def _alive(self, op: str) -> None:
        if self._down:
            raise NodeDown(self.name, op)

    def _track(self, handle: RequestHandle) -> RequestHandle:
        self._issued = [
            h for h in self._issued
            if not (h.done or h.expired or h.failed)
        ]
        self._issued.append(handle)
        return handle

    def _hung_handle(
        self, slot: str, x: np.ndarray, priority: str
    ) -> RequestHandle:
        # a handle nobody will ever fill or shed: deliberately carries NO
        # deadline (the node "accepted" the request, then went silent) —
        # only the caller's own wait timeout or a kill() resolves it
        return self._track(RequestHandle(
            next(_hung_ids), slot, int(np.asarray(x).shape[0]), priority
        ))

    # -- scripted lifecycle --------------------------------------------------

    def kill(self, fail_pending: bool = True) -> None:
        """Stop responding entirely.  Pending handles this node issued
        are failed with ``NodeDown`` (a monitor noticing the corpse would
        do the same) so no caller blocks past its own timeout."""
        self._down = True
        if fail_pending:
            exc = NodeDown(self.name, "kill")
            for h in self._issued:
                if not (h.done or h.expired or h.failed):
                    h._fail(exc)
        self._issued.clear()

    def revive(self) -> None:
        """Bring the node back (its inner loop never stopped)."""
        self._down = False
        self.down_after_ops = None  # a revived node stays up until rekilled

    @property
    def down(self) -> bool:
        return self._down

    # -- traffic -------------------------------------------------------------

    def submit(self, slot, x, *, priority="normal", timeout_ms=None):
        fault = self._draw(
            "submit", ("error", "latency", "overload", "hang", "down")
        )
        if fault == "overload":
            raise Overloaded(slot, priority, 0, 0)
        if fault == "hang":
            return self._hung_handle(slot, x, priority)
        return self._track(self.inner.submit(
            slot, x, priority=priority, timeout_ms=timeout_ms
        ))

    async def async_submit(self, slot, x, *, priority="normal",
                           timeout_ms=None):
        fault = self._draw(
            "async_submit", ("error", "latency", "overload", "hang", "down")
        )
        if fault == "overload":
            raise Overloaded(slot, priority, 0, 0)
        if fault == "hang":
            return self._hung_handle(slot, x, priority)
        return self._track(await self.inner.async_submit(
            slot, x, priority=priority, timeout_ms=timeout_ms
        ))

    def flush(self) -> None:
        self._draw("flush", ("error", "latency", "down"))
        self.inner.flush()

    def infer(self, slot, x):
        self._draw("infer", ("error", "latency", "down"))
        return self.inner.infer(slot, x)

    def class_sums(self, slot, x):
        self._alive("class_sums")  # the oracle hook is not chaos-injected
        return self.inner.class_sums(slot, x)

    def start(self) -> None:
        self._alive("start")
        self.inner.start()

    def stop(self, drain: bool = True) -> None:
        self._alive("stop")
        self.inner.stop(drain=drain)

    @property
    def scheduler_running(self) -> bool:
        return (not self._down) and self.inner.scheduler_running

    # -- programming ---------------------------------------------------------

    def register(self, slot, model, provenance="install"):
        fault = self._draw("register", ("corrupt", "down"))
        if fault == "corrupt" and isinstance(model, TMProgram):
            blob = bytearray(model.to_bytes())
            blob[-1] ^= 0x01  # one bit, in the payload: CRC must catch it
            # hand the corrupted wire bytes to the inner node — its
            # TMProgram.from_bytes integrity check raises ValueError
            return self.inner.register(
                slot, bytes(blob), provenance=provenance
            )
        return self.inner.register(slot, model, provenance=provenance)

    def rollback(self, slot):
        self._alive("rollback")
        return self.inner.rollback(slot)

    # -- introspection -------------------------------------------------------

    @property
    def capacity(self):
        return self.inner.capacity

    def validate_model(self, model) -> None:
        self._alive("validate_model")
        self.inner.validate_model(model)

    def queue_depth(self, slot=None, priority=None) -> int:
        self._alive("queue_depth")
        return self.inner.queue_depth(slot, priority)

    def metrics_snapshot(self) -> dict:
        self._alive("metrics_snapshot")
        return self.inner.metrics_snapshot()

    def slots(self):
        self._alive("slots")
        return self.inner.slots()

    def installed_checksum(self, slot):
        self._alive("installed_checksum")
        return self.inner.installed_checksum(slot)

    def installed_artifact(self, slot):
        self._alive("installed_artifact")
        return self.inner.installed_artifact(slot)

    def compile_cache_size(self) -> int:
        self._alive("compile_cache_size")
        return self.inner.compile_cache_size()

    # -- passthroughs the fleet uses best-effort -----------------------------

    @property
    def metrics(self):
        # local observability convenience, NOT a boundary member; kept
        # reachable even when down so post-mortem rollups still work
        return self.inner.metrics

    @property
    def registry(self):
        if self._down:
            # AttributeError (not NodeDown) so hasattr() degrades cleanly
            raise AttributeError("registry unreachable: node is down")
        return self.inner.registry
