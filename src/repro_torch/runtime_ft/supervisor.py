"""Fault-tolerant training supervisor: checkpoint/restart + straggler policy.

A copy of ``repro.runtime_ft.supervisor`` over the port's
``checkpoint.manager``.  Control-plane logic, unit-testable in-process.
On a real cluster each ingredient maps 1:1:

  * ``run_with_restarts``    — the per-job restart wrapper (k8s/borg restarts
    the process; we restart the loop) restoring from the latest atomic
    checkpoint;
  * ``StragglerMonitor``     — per-step deadline tracking; a step exceeding
    ``deadline_factor`` x the trailing-median step time marks its host
    suspect, and after ``max_strikes`` the supervisor requests a re-shard
    without the suspect host (the reference's elastic.py computes the new
    layout; the port's comes with the LM scaffolding, whose parameter
    rules it needs);
  * ``HeartbeatTracker``     — dead-node detection by missed heartbeats.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

from ..checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class RestartStats:
    restarts: int = 0
    completed_steps: int = 0
    restored_from: Optional[int] = None


def run_with_restarts(
    *,
    total_steps: int,
    make_state: Callable[[], Any],
    step_fn: Callable[[Any, int], Any],
    ckpt: CheckpointManager,
    save_every: int = 10,
    max_restarts: int = 5,
    fault_injector: Optional[Callable[[int], None]] = None,
) -> tuple[Any, RestartStats]:
    """Run ``total_steps`` of ``step_fn`` with checkpoint/restart.

    ``fault_injector(step)`` may raise to simulate node failure (tests)."""
    stats = RestartStats()
    attempts = 0
    while True:
        try:
            latest = ckpt.latest_step()
            if latest is None:
                state, start = make_state(), 0
            else:
                state = ckpt.restore(latest, like=make_state())
                start = latest
                stats.restored_from = latest
            for step in range(start, total_steps):
                if fault_injector is not None:
                    fault_injector(step)
                state = step_fn(state, step)
                stats.completed_steps = step + 1
                if (step + 1) % save_every == 0 or step + 1 == total_steps:
                    ckpt.save(step + 1, state)
            return state, stats
        except KeyboardInterrupt:
            raise
        except Exception:
            attempts += 1
            stats.restarts += 1
            if attempts > max_restarts:
                raise


class StragglerMonitor:
    """Deadline-based straggler detection over per-host step times."""

    def __init__(self, deadline_factor: float = 3.0, max_strikes: int = 3,
                 window: int = 32):
        self.deadline_factor = deadline_factor
        self.max_strikes = max_strikes
        self.window = window
        self.history: List[float] = []
        self.strikes: Dict[str, int] = {}

    def observe(self, host: str, step_time: float) -> str:
        """-> 'ok' | 'suspect' | 'evict'."""
        self.history.append(step_time)
        self.history = self.history[-self.window :]
        if len(self.history) < 5:
            return "ok"
        med = statistics.median(self.history)
        if step_time > self.deadline_factor * med:
            self.strikes[host] = self.strikes.get(host, 0) + 1
            if self.strikes[host] >= self.max_strikes:
                return "evict"
            return "suspect"
        self.strikes.pop(host, None)
        return "ok"


class HeartbeatTracker:
    def __init__(self, timeout_s: float = 60.0, clock=time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last: Dict[str, float] = {}

    def beat(self, host: str):
        self.last[host] = self.clock()

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last.items() if now - t > self.timeout]
