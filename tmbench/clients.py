"""The one traffic generator: closed-loop clients whose parameters are a
traffic file's.

A closed loop: each client sends its next request when the previous one
has returned (callers that each wait for their answers).  Keys of a
traffic file:

  clients        number of callers
  rows           {"dist": "log_uniform" | "uniform", "min", "max"}: rows
                 per request
  batch_words    the served engine batch, in words of 32 rows
  warmup         requests each client sends in set-up, before the window
  check_share    share of the requests whose answers are kept for the
                 check, drawn from the seed; the others are dropped as
                 they return, as a caller would drop them (keeping every
                 answer of a bulk window would page-fault gigabytes into
                 the program's own allocations while it is timed)

and, read by no code, ``users`` (who sends such traffic), ``source``
(what a public description gives) and ``assumed`` (every number that
none gives, with how ``rows_per_s`` moved when it was changed).

Every seed gets the same sizes in another order: the sizes of a list are
fixed quantiles of ``rows`` (log-uniform: evenly spaced in log), which the
seed shuffles per client; the seed also draws each request's pool offset.
So the work of a window does not depend on the seed, and only the data do.
"""

from __future__ import annotations

import asyncio
import time
import zlib
from typing import List, NamedTuple, Optional

import numpy as np

WAIT_S = 60.0  # how long a client waits for an answer past the close
SCHEDULE = 4096  # requests in each client's list before it repeats


def request_sizes(rows: dict, n: int) -> np.ndarray:
    """int64[n]: the fixed multiset of request sizes of a traffic file."""
    lo, hi = int(rows["min"]), int(rows["max"])
    q = (np.arange(n) + 0.5) / n
    if rows["dist"] == "log_uniform":
        sizes = np.exp(np.log(lo) + (np.log(hi) - np.log(lo)) * q)
    elif rows["dist"] == "uniform":
        sizes = lo + np.floor(q * (hi - lo + 1))
    else:
        raise ValueError(f"unknown rows distribution {rows['dist']!r}")
    return np.clip(np.rint(sizes), lo, hi).astype(np.int64)


def schedule(traffic: dict, pool_rows: int, seed: int, client: int, tag: str, n: int):
    """(sizes, offsets, kept for the check) of one client's ``n`` requests."""
    if int(traffic["rows"]["max"]) > pool_rows:
        raise ValueError("requests are larger than the pool")
    rng = np.random.default_rng([int(seed), client, zlib.crc32(tag.encode())])
    sizes = rng.permutation(request_sizes(traffic["rows"], n))
    offsets = rng.integers(0, pool_rows - sizes + 1)
    kept = rng.random(sizes.size) < float(traffic["check_share"])
    return sizes, offsets, kept


class Request(NamedTuple):
    """What one request asked and what came back (``ok`` false: it failed,
    expired, never returned, or ``submit`` raised)."""

    off: int
    n: int
    ok: bool
    completed_at: float
    latency_s: float
    sums: Optional[np.ndarray]  # None where the answer was not kept
    preds: Optional[np.ndarray]


class Clients:
    """The closed-loop callers of one run: coroutines of one event loop
    on the calling thread, each ``submit`` then ``await
    handle.async_result()``, again and again.  One thread drives them all,
    so the run's load comes from two threads (the clients' and the
    program's scheduler), not from one thread per caller."""

    def __init__(self, acc, slot, pool, traffic, seed):
        self.acc, self.slot, self.pool = acc, slot, pool
        n = int(traffic["clients"])
        rows = pool.shape[0]
        warm = int(traffic["warmup"])
        self.warm = [schedule(traffic, rows, seed, i, "warmup", warm) for i in range(n)]
        self.plans = [schedule(traffic, rows, seed, i, "schedule", SCHEDULE)
                      for i in range(n)]
        self.sent: List[tuple] = []

    async def _send(self, off: int, n: int, keep: bool = False) -> tuple:
        """Send one request; -> the fields of its ``Request``, as a plain
        tuple of numbers and arrays: the collector does not track it, so
        keeping answers for the check adds nothing to the program's
        garbage collections (the handle itself is dropped)."""
        try:
            handle = self.acc.submit(self.slot, self.pool[off:off + n])
        except Exception:  # counted as failed by the harness
            return (off, n, False, 0.0, 0.0, None, None)
        try:
            await handle.async_result(timeout=WAIT_S)
        except Exception:  # failed, expired or late: the handle says which
            pass
        if handle.status != "done" or handle.class_sums is None:
            return (off, n, False, 0.0, 0.0, None, None)
        answer = (handle.class_sums, handle.predictions) if keep else (None, None)
        return (off, n, True, handle.completed_at, handle.latency_s, *answer)

    async def _warm(self, i: int) -> None:
        for n, off, _ in zip(*self.warm[i]):
            await self._send(int(off), int(n))

    async def _loop(self, i: int, end: float) -> None:
        sizes, offsets, kept = self.plans[i]
        k = 0
        while time.perf_counter() < end:
            j = k % sizes.size
            self.sent.append(
                await self._send(int(offsets[j]), int(sizes[j]), bool(kept[j])))
            k += 1

    async def _all(self, fn, *args) -> None:
        await asyncio.gather(*(fn(i, *args) for i in range(len(self.plans))))

    def warm_up(self) -> None:
        """Each client sends its warm-up requests (set-up, no window)."""
        asyncio.run(self._all(self._warm))

    def run(self, end: float, *also) -> List[Request]:
        """Send until the host clock reaches ``end``; returns every request
        sent, once each has returned or waited ``WAIT_S``.  ``also``:
        coroutines that run beside the clients on their loop."""

        async def main():
            await asyncio.gather(self._all(self._loop, end), *also)

        asyncio.run(main())
        return [Request(*t) for t in self.sent]
