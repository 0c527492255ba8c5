"""What the host did in each second of the window.

One more coroutine of the clients' event loop reads, once a second, the
program's batch counters and the CPU time (``getrusage``) of the whole
process and of the clients' thread, on which it runs; the rest of the
process's CPU time is, all but a little, the program's scheduler thread.
It prints on standard error, so that a slow stretch of a run can be told
apart: the scheduler on its CPU all along but slower per batch (the host
slower for everyone), or off its CPU (blocked: the interpreter's lock,
the queue or the device).  No metric reads it.
"""

from __future__ import annotations

import asyncio
import resource
import time
from typing import List

ROWS = ("batches", "engine_ms", "clients_cpu_ms", "others_cpu_ms")


def cpu_seconds(who: int) -> float:
    """User and system seconds of ``who``."""
    r = resource.getrusage(who)
    return r.ru_utime + r.ru_stime


class Pulse:
    """Samples once a second; ``lines()`` gives the differences."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.samples: List[tuple] = []

    def sample(self) -> tuple:
        engine_s = self.metrics.engine_s
        n = len(engine_s)
        return (n, sum(engine_s[:n]), cpu_seconds(resource.RUSAGE_SELF),
                cpu_seconds(resource.RUSAGE_THREAD))

    async def watch(self, start: float, end: float) -> None:
        self.samples = [self.sample()]
        tick = start
        while tick < end:
            tick = min(tick + 1.0, end)
            await asyncio.sleep(max(0.0, tick - time.perf_counter()))
            self.samples.append(self.sample())

    def lines(self) -> List[str]:
        """One line per quantity, a number for each second."""
        d = [[b - a for a, b in zip(s0, s1)]
             for s0, s1 in zip(self.samples, self.samples[1:])]
        cols = {
            "batches": [x[0] for x in d],
            "engine_ms": [1e3 * x[1] / max(x[0], 1) for x in d],
            "clients_cpu_ms": [1e3 * x[3] for x in d],
            "others_cpu_ms": [1e3 * (x[2] - x[3]) for x in d],
        }
        return [f"{k} " + " ".join(f"{v:.1f}" for v in cols[k]) for k in ROWS]
