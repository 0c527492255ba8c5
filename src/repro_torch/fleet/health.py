"""Per-node circuit breakers + the retry/backoff policy the router runs.

The fleet's failure model (the reference's docs/fleet.md "failure model")
in two parts:

``RetryPolicy`` — how hard ONE request tries: bounded attempts across
the candidate set, exponential backoff between sweeps (injectable
``sleep``/``clock`` so tests never touch wall-clock), and the retry
budget rule: a retry never sleeps past the request's remaining
``timeout_ms`` deadline budget — better to surface the structured error
while the caller can still act on it than to return late.

``FleetHealth`` — what the fleet believes about EACH node, as a
circuit breaker:

    healthy ──failure──► degraded ──thresholds──► quarantined
       ▲                                        │
       │                              probe_after_s cooldown
       │                                        ▼
       └────probe succeeds──── half_open ◄──next request probes
                                  │
                                  └──probe fails──► quarantined (restamped)

Transitions are driven by the outcomes the router records
(``record_success`` / ``record_failure`` / ``record_overload``) against
two thresholds: ``consecutive_failures`` and a windowed error rate.
``Overloaded`` is deliberately NOT a health failure — a full lane is
backpressure, not sickness; it only counts toward the ``overloads``
telemetry.

Liveness reuses ``runtime_ft.supervisor`` instead of duplicating it:
every success beats a ``HeartbeatTracker`` (same injectable-clock
pattern), and ``sweep()`` quarantines its ``dead_hosts()``; service
latencies feed a ``StragglerMonitor`` whose ``evict`` verdict also
quarantines — a node that is technically answering but 3x slower than
the fleet median is routed around just like a dead one.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional

from ..runtime_ft.supervisor import HeartbeatTracker, StragglerMonitor
from ..serve_tm.schema import HEALTH_NODE_KEYS, HEALTH_STATES

logger = logging.getLogger(__name__)

HEALTHY, DEGRADED, QUARANTINED, HALF_OPEN = HEALTH_STATES


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-attempt exponential backoff with a hard deadline budget.

    ``max_attempts`` bounds TOTAL per-node tries for one request (across
    failover sweeps, not per node).  Between sweeps the router sleeps
    ``backoff_s(sweep)`` = min(base * multiplier**sweep, max).  Both
    ``sleep`` and ``clock`` are injectable so property tests drive the
    policy through simulated time."""

    max_attempts: int = 4
    backoff_base_s: float = 0.005
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 0.25
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff durations must be >= 0")
        if self.backoff_multiplier < 1.0:
            raise ValueError(
                f"backoff_multiplier must be >= 1 (got "
                f"{self.backoff_multiplier}); a shrinking backoff hammers "
                f"a struggling node harder each sweep"
            )

    def backoff_s(self, sweep: int) -> float:
        """Backoff before re-sweeping the candidates (0-indexed sweep)."""
        return min(
            self.backoff_base_s * self.backoff_multiplier ** sweep,
            self.backoff_max_s,
        )

    def deadline_for(self, timeout_ms: Optional[float]) -> Optional[float]:
        """Absolute clock() stamp the whole retry loop must finish by."""
        if timeout_ms is None:
            return None
        return self.clock() + timeout_ms / 1e3

    def remaining_ms(self, deadline: Optional[float]) -> Optional[float]:
        """Budget left (ms); None when the request carried no timeout."""
        if deadline is None:
            return None
        return (deadline - self.clock()) * 1e3

    def budget_allows(
        self, deadline: Optional[float], sleep_s: float
    ) -> bool:
        """The retry-budget rule: never sleep past the remaining
        deadline budget — surface the last error instead."""
        if deadline is None:
            return True
        return self.clock() + sleep_s < deadline


class _NodeStats:
    __slots__ = (
        "state", "successes", "failures", "consecutive_failures",
        "retries", "failovers", "overloads", "quarantines", "probes",
        "window", "quarantined_at",
    )

    def __init__(self):
        self.state = HEALTHY
        self.successes = 0
        self.failures = 0
        self.consecutive_failures = 0
        self.retries = 0
        self.failovers = 0
        self.overloads = 0
        self.quarantines = 0
        self.probes = 0
        self.window: List[bool] = []  # True = success, most recent last
        self.quarantined_at: Optional[float] = None


class FleetHealth:
    """Circuit-breaker state for every node in a pool.

    Purely reactive: the router (and rollout manager) push outcomes in;
    ``state()``/``probe_due()`` answer routing questions; ``sweep()``
    applies the heartbeat timeout.  ``pool`` is optional and only used
    to best-effort mirror quarantine/probe events into the affected
    node's own ``ServeMetrics`` (unreachable nodes are skipped)."""

    def __init__(
        self,
        *,
        pool=None,
        consecutive_failures: int = 3,
        error_rate_threshold: float = 0.5,
        window: int = 16,
        min_window: int = 4,
        probe_after_s: float = 1.0,
        heartbeat_timeout_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        straggler: Optional[StragglerMonitor] = None,
    ):
        if consecutive_failures < 1:
            raise ValueError("consecutive_failures must be >= 1")
        if not 0.0 < error_rate_threshold <= 1.0:
            raise ValueError("error_rate_threshold must be in (0, 1]")
        self.pool = pool
        self.consecutive_failures = consecutive_failures
        self.error_rate_threshold = error_rate_threshold
        self.window = window
        self.min_window = min_window
        self.probe_after_s = probe_after_s
        self.clock = clock
        # one injectable clock drives the breaker, the heartbeat timeout
        # and (via the caller-measured latencies) the straggler monitor
        self.heartbeats = HeartbeatTracker(
            timeout_s=heartbeat_timeout_s, clock=clock
        )
        self.straggler = (
            straggler if straggler is not None else StragglerMonitor()
        )
        self._stats: Dict[str, _NodeStats] = {}

    def _ensure(self, name: str) -> _NodeStats:
        return self._stats.setdefault(name, _NodeStats())

    # -- routing questions ---------------------------------------------------

    def state(self, name: str) -> str:
        s = self._stats.get(name)
        return HEALTHY if s is None else s.state

    def error_rate(self, name: str) -> float:
        s = self._stats.get(name)
        if s is None or not s.window:
            return 0.0
        return s.window.count(False) / len(s.window)

    def probe_due(self, name: str) -> bool:
        """Quarantine cooldown elapsed: the next request may probe."""
        s = self._stats.get(name)
        return (
            s is not None
            and s.state == QUARANTINED
            and s.quarantined_at is not None
            and self.clock() - s.quarantined_at >= self.probe_after_s
        )

    # -- outcome recording (the router's side) -------------------------------

    def record_success(
        self, name: str, latency_s: Optional[float] = None
    ) -> None:
        s = self._ensure(name)
        s.successes += 1
        s.consecutive_failures = 0
        self._push(s, True)
        self.heartbeats.beat(name)
        if s.state != HEALTHY:
            # degraded recovers, and a half-open probe success CLOSES
            # the breaker (quarantined-with-success likewise: a rollout
            # gate may exercise a node the router never probed)
            s.state = HEALTHY
            s.quarantined_at = None
        if latency_s is not None:
            verdict = self.straggler.observe(name, latency_s)
            if verdict == "evict":
                self.quarantine(name, reason="straggler evicted")
            elif verdict == "suspect" and s.state == HEALTHY:
                s.state = DEGRADED

    def record_failure(self, name: str, exc: Optional[BaseException] = None):
        s = self._ensure(name)
        s.failures += 1
        s.consecutive_failures += 1
        self._push(s, False)
        if s.state == HALF_OPEN:
            # the probe failed: back to quarantine, cooldown restarts
            self.quarantine(name, reason=f"half-open probe failed: {exc!r}")
        elif s.state == QUARANTINED:
            s.quarantined_at = self.clock()  # still down; restamp cooldown
        elif (
            s.consecutive_failures >= self.consecutive_failures
            or (
                len(s.window) >= self.min_window
                and self.error_rate(name) >= self.error_rate_threshold
            )
        ):
            self.quarantine(name, reason=f"thresholds tripped: {exc!r}")
        else:
            s.state = DEGRADED

    def record_overload(self, name: str) -> None:
        """``Overloaded`` is backpressure, not sickness — telemetry only."""
        self._ensure(name).overloads += 1

    def record_retry(self, name: str) -> None:
        self._ensure(name).retries += 1

    def record_failover(self, name: str) -> None:
        self._ensure(name).failovers += 1

    # -- breaker transitions -------------------------------------------------

    def quarantine(self, name: str, reason: str = "") -> None:
        s = self._ensure(name)
        s.state = QUARANTINED
        s.quarantined_at = self.clock()
        s.quarantines += 1
        logger.warning("node %r quarantined: %s", name, reason or "(manual)")
        self._mirror(name, "record_quarantine")

    def begin_probe(self, name: str) -> None:
        """The router is about to send ONE request to a quarantined node
        whose cooldown elapsed; until its outcome lands the node is
        half-open and receives no other traffic."""
        s = self._ensure(name)
        s.state = HALF_OPEN
        s.probes += 1
        self._mirror(name, "record_probe")

    def sweep(self) -> List[str]:
        """Quarantine every node whose heartbeat timed out; returns the
        names newly quarantined."""
        newly = []
        for host in self.heartbeats.dead_hosts():
            if self.state(host) not in (QUARANTINED, HALF_OPEN):
                self.quarantine(host, reason="missed heartbeats")
                newly.append(host)
        return newly

    # -- rendering -----------------------------------------------------------

    def summary(self) -> Dict[str, Dict]:
        """Per-node dicts, keys pinned by ``schema.HEALTH_NODE_KEYS``."""
        out: Dict[str, Dict] = {}
        for name, s in sorted(self._stats.items()):
            d = {
                "state": s.state,
                "successes": s.successes,
                "failures": s.failures,
                "consecutive_failures": s.consecutive_failures,
                "error_rate": self.error_rate(name),
                "retries": s.retries,
                "failovers": s.failovers,
                "overloads": s.overloads,
                "quarantines": s.quarantines,
                "probes": s.probes,
            }
            assert tuple(d.keys()) == HEALTH_NODE_KEYS
            out[name] = d
        return out

    # -- internals -----------------------------------------------------------

    def _push(self, s: _NodeStats, ok: bool) -> None:
        s.window.append(ok)
        del s.window[: -self.window]

    def _mirror(self, name: str, method: str) -> None:
        """Best-effort: count the event on the node's own ServeMetrics
        too, so pool metric rollups show it (dead nodes are skipped)."""
        if self.pool is None:
            return
        try:
            metrics = getattr(self.pool.node(name), "metrics", None)
            if metrics is not None:
                getattr(metrics, method)()
        except Exception:
            pass
