"""Request queue + priority-lane dynamic batcher for the TM serving
subsystem.

Independent inference requests (each a {0,1}[b, F] block of datapoints for
one model slot) are coalesced into engine batches of at most
``batch_capacity`` rows — the 32-datapoint bit-packed words the engine
natively consumes.  A partial trailing word is padded inside the engine
(``pack_features``); here we only track the fill ratio.  Large requests
transparently span multiple engine batches; predictions are demultiplexed
back into each request's ``RequestHandle`` row by row.

Requests carry a *priority* (one of ``PRIORITIES``: critical > high >
normal > low) and an optional absolute *deadline*.  Each slot keeps one
lane per priority; batch formation walks the lanes strictly in priority
order and, within a lane, earliest-deadline-first (deadline-less requests
are FIFO behind every deadlined one with an earlier stamp).  A request
whose deadline has already passed is never placed into a batch — it is
*shed*: moved to the ``expired`` terminal state and reported through
``drain_shed`` so the scheduler can count it.

``RequestHandle`` completion is observable three ways: the non-blocking
``result()`` (raises while pending), the blocking ``wait(timeout=)``, and
the awaitable ``async_result()`` — the scheduler loop completes handles
from its own thread and signals waiters on whatever event loop they
registered from.
"""

from __future__ import annotations

import asyncio
import heapq
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

WORD = 32  # datapoints per bit-packed word (paper batching)

# service order: batch formation drains lanes left to right (the lane
# list itself lives in schema.py — the summary()-schema source of truth)
from .schema import LANES as PRIORITIES  # noqa: E402

PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}


class DeadlineExceeded(RuntimeError):
    """A request expired (deadline passed) before its rows were served.

    Carries the request id, slot, priority and the deadline that was
    missed, so callers can log/shed without string parsing."""

    def __init__(self, rid: int, slot: str, priority: str, deadline: float):
        self.rid = rid
        self.slot = slot
        self.priority = priority
        self.deadline = deadline
        super().__init__(
            f"request {rid} (slot {slot!r}, {priority} lane) expired: "
            f"deadline passed before its rows were served"
        )


class RequestHandle:
    """Per-request future: filled row-by-row as engine batches complete.

    Terminal states: ``done`` (all rows served), ``expired`` (the
    scheduler shed it past its deadline) or ``failed`` (the batch body
    raised, or the node serving it died — ``error`` carries the
    structured exception and ``result()``/``wait()``/``async_result()``
    re-raise it).  ``driver`` records who owns
    completion — ``"flush"`` (the caller-driven sync path) or
    ``"scheduler"`` (a running continuous-batching loop) — so the
    pending-result error can say what to actually do.
    """

    def __init__(
        self,
        rid: int,
        slot: str,
        n_rows: int,
        priority: str = "normal",
        deadline: Optional[float] = None,
    ):
        if priority not in PRIORITY_RANK:
            raise ValueError(
                f"unknown priority {priority!r}; expected one of {PRIORITIES}"
            )
        self.rid = rid
        self.slot = slot
        self.n_rows = n_rows
        self.priority = priority
        self.deadline = deadline  # absolute time.perf_counter() stamp
        self.driver = "flush"
        self.predictions = np.full(n_rows, -1, np.int32)
        self.class_sums: Optional[np.ndarray] = None  # int32[n_rows, M]
        self.enqueued_at = time.perf_counter()
        self.dequeued_at: Optional[float] = None  # first rows entered a batch
        self.completed_at: Optional[float] = None
        self.expired_at: Optional[float] = None
        self.failed_at: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._filled = 0
        self._lock = threading.Lock()
        self._terminal_evt = threading.Event()
        self._async_waiters: List[Tuple[asyncio.AbstractEventLoop,
                                        asyncio.Event]] = []

    @property
    def done(self) -> bool:
        return self._filled >= self.n_rows

    @property
    def expired(self) -> bool:
        return self.expired_at is not None

    @property
    def failed(self) -> bool:
        return self.error is not None

    @property
    def status(self) -> str:
        if self.failed:
            return "failed"
        if self.expired:
            return "expired"
        return "done" if self.done else "pending"

    @property
    def latency_s(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.enqueued_at

    @property
    def queue_delay_s(self) -> Optional[float]:
        """Enqueue -> first rows placed into an engine batch."""
        if self.dequeued_at is None:
            return None
        return self.dequeued_at - self.enqueued_at

    @property
    def missed_deadline(self) -> bool:
        """Completed, but after the deadline (served-late SLO miss)."""
        return (
            self.deadline is not None
            and self.completed_at is not None
            and self.completed_at > self.deadline
        )

    def result(self) -> np.ndarray:
        if self.failed:
            raise self.error
        if self.expired:
            raise DeadlineExceeded(
                self.rid, self.slot, self.priority, self.deadline
            )
        if not self.done:
            if self.driver == "scheduler":
                remedy = (
                    "the scheduler loop owns it — await async_result() "
                    "or block on wait()"
                )
            else:
                remedy = "call TMServer.flush() to run the sync driver"
            raise RuntimeError(
                f"request {self.rid} for slot {self.slot!r} has "
                f"{self.n_rows - self._filled} rows pending; {remedy}"
            )
        return self.predictions

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until terminal (a running scheduler completes or sheds
        the request from its own thread), then return ``result()``."""
        if not self._terminal_evt.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} (slot {self.slot!r}) still pending "
                f"after {timeout}s"
            )
        return self.result()

    async def async_result(
        self, timeout: Optional[float] = None
    ) -> np.ndarray:
        """Await completion; raises ``DeadlineExceeded`` if shed."""
        with self._lock:
            if not self._terminal_evt.is_set():
                loop = asyncio.get_running_loop()
                evt = asyncio.Event()
                self._async_waiters.append((loop, evt))
            else:
                evt = None
        if evt is not None:
            if timeout is None:
                await evt.wait()
            else:
                await asyncio.wait_for(evt.wait(), timeout)
        return self.result()

    def _signal_terminal(self) -> None:
        with self._lock:
            self._terminal_evt.set()
            waiters, self._async_waiters = self._async_waiters, []
        for loop, evt in waiters:
            try:
                loop.call_soon_threadsafe(evt.set)
            except RuntimeError:
                pass  # waiter's loop already closed; nothing to notify

    def _fill(
        self, lo: int, preds: np.ndarray, sums: Optional[np.ndarray] = None
    ) -> None:
        self.predictions[lo : lo + preds.shape[0]] = preds
        if sums is not None:
            if self.class_sums is None:
                self.class_sums = np.zeros(
                    (self.n_rows, sums.shape[1]), sums.dtype
                )
            self.class_sums[lo : lo + sums.shape[0]] = sums
        self._filled += preds.shape[0]
        if self.done:
            self.completed_at = time.perf_counter()
            self._signal_terminal()

    def _expire(self, now: float) -> None:
        self.expired_at = now
        self._signal_terminal()

    def _fail(self, exc: BaseException, now: Optional[float] = None) -> None:
        """Terminal failure: the batch body raised or the serving node
        died.  Waiters unblock and re-raise ``exc`` from ``result()``."""
        if self._terminal_evt.is_set():
            return  # already terminal — never overwrite a served result
        self.error = exc
        self.failed_at = time.perf_counter() if now is None else now
        self._signal_terminal()


class _Pending:
    """A queued request plus its consumption offset (requests larger than
    one engine batch are drained incrementally)."""

    __slots__ = ("handle", "x", "offset")

    def __init__(self, handle: RequestHandle, x: np.ndarray):
        self.handle = handle
        self.x = x
        self.offset = 0

    @property
    def remaining(self) -> int:
        return self.x.shape[0] - self.offset


# (handle, batch_lo, batch_hi, request_lo): rows [lo, hi) of the engine
# batch belong to rows [request_lo, ...) of the request.
Span = Tuple[RequestHandle, int, int, int]

# heap entry: (deadline-or-inf, arrival seq, pending) — EDF within a lane,
# FIFO among deadline-less requests
_LaneEntry = Tuple[float, int, _Pending]


class Batcher:
    """Per-slot priority lanes + greedy coalescing into engine batches.

    Lanes are drained strictly in ``PRIORITIES`` order; within a lane the
    earliest deadline wins (FIFO for deadline-less requests).  Expired
    requests are shed at formation time, never batched.

    ``lock`` serializes every heap read/mutation: submit-side enqueues
    run on caller threads while the scheduler loop forms batches on its
    own thread, and heapq's peek-then-pop is not atomic — without the
    lock a concurrent push can re-order the heap root mid-formation and
    the wrong request gets popped (silently dropped, its handle never
    terminal).  The lock is re-entrant so the scheduler can compose
    multi-step atomic sections (admission check + enqueue) on top of the
    self-locking public methods.
    """

    def __init__(self, batch_capacity: int):
        if batch_capacity % WORD != 0:
            raise ValueError(
                f"batch_capacity {batch_capacity} must be a multiple of "
                f"{WORD} (bit-packed words)"
            )
        self.batch_capacity = batch_capacity
        self.lock = threading.RLock()
        # slot -> priority -> EDF heap of pending requests
        self._lanes: Dict[str, Dict[str, List[_LaneEntry]]] = {}
        self._seq = 0
        self._shed: List[RequestHandle] = []

    def _slot_lanes(self, slot: str) -> Dict[str, List[_LaneEntry]]:
        return self._lanes.setdefault(
            slot, {p: [] for p in PRIORITIES}
        )

    def enqueue(self, handle: RequestHandle, x: np.ndarray) -> None:
        key = math.inf if handle.deadline is None else handle.deadline
        with self.lock:
            self._seq += 1
            heapq.heappush(
                self._slot_lanes(handle.slot)[handle.priority],
                (key, self._seq, _Pending(handle, x)),
            )

    def pending_slots(self) -> List[str]:
        with self.lock:
            return [
                s for s, lanes in self._lanes.items()
                if any(lanes[p] for p in PRIORITIES)
            ]

    def pending_rows(self, slot: str, priority: Optional[str] = None) -> int:
        with self.lock:
            lanes = self._lanes.get(slot)
            if not lanes:
                return 0
            sel = (priority,) if priority is not None else PRIORITIES
            return sum(
                e[2].remaining for p in sel for e in lanes.get(p, ())
            )

    def oldest_enqueued_at(self, slot: str) -> Optional[float]:
        """Enqueue stamp of the oldest pending request (batching-window
        age the scheduler's max_wait timer is measured against)."""
        with self.lock:
            lanes = self._lanes.get(slot)
            if not lanes:
                return None
            stamps = [
                e[2].handle.enqueued_at
                for p in PRIORITIES for e in lanes.get(p, ())
            ]
            return min(stamps) if stamps else None

    def earliest_deadline(self, slot: str) -> Optional[float]:
        with self.lock:
            lanes = self._lanes.get(slot)
            if not lanes:
                return None
            best = math.inf
            for p in PRIORITIES:
                if lanes[p]:
                    best = min(best, lanes[p][0][0])
            return None if best is math.inf else best

    def next_batch(
        self,
        slot: str,
        out: Optional[np.ndarray] = None,
        now: Optional[float] = None,
        marks: Optional[list] = None,
    ) -> Tuple[np.ndarray, List[Span]]:
        """Pop up to ``batch_capacity`` rows off the slot's lanes.

        Lanes are consumed in strict priority order; within a lane,
        earliest deadline first.  Requests whose deadline has passed (vs
        ``now``, injectable for tests) are shed — marked expired,
        reported via ``drain_shed`` — and NEVER included.  Returns the
        coalesced feature block plus the spans needed to demux
        predictions back per-request; raises on an empty queue (a batch
        where every queued request expired returns an empty block and no
        spans).

        With ``out`` (an engine staging array of at least
        ``[batch_capacity, F]``), request rows are packed straight into it
        — no per-batch concatenate/allocation — the remainder of ``out``
        is zeroed (the engines consume one fixed zero-padded operand
        shape), and the returned block is the view ``out[:rows, :F]``.

        With ``marks`` (a list), the host and thread-CPU stamp at which
        the lock was taken is appended to it: the wait ends, the fill
        begins.
        """
        with self.lock:
            if marks is not None:
                marks.append((time.perf_counter_ns(), time.thread_time_ns()))
            lanes = self._lanes.get(slot)
            if not lanes or not any(lanes[p] for p in PRIORITIES):
                raise ValueError(f"no pending requests for slot {slot!r}")
            if now is None:
                now = time.perf_counter()
            n_features = 0
            for p in PRIORITIES:
                if lanes[p]:
                    n_features = lanes[p][0][2].x.shape[1]
                    break
            if out is not None:
                if (out.shape[0] < self.batch_capacity
                        or out.shape[1] < n_features):
                    raise ValueError(
                        f"staging array {out.shape} too small for "
                        f"{self.batch_capacity} rows x {n_features} features"
                    )
                out.fill(0)
            parts: List[np.ndarray] = []
            spans: List[Span] = []
            rows = 0
            for priority in PRIORITIES:
                lane = lanes[priority]
                while lane and rows < self.batch_capacity:
                    key, seq, p = lane[0]
                    if key <= now:  # deadline passed: shed, never batch
                        heapq.heappop(lane)
                        p.handle._expire(now)
                        self._shed.append(p.handle)
                        continue
                    take = min(p.remaining, self.batch_capacity - rows)
                    block = p.x[p.offset : p.offset + take]
                    if out is None:
                        parts.append(block)
                    else:
                        out[rows : rows + take, :n_features] = block
                    if p.handle.dequeued_at is None:
                        p.handle.dequeued_at = now
                    spans.append((p.handle, rows, rows + take, p.offset))
                    rows += take
                    p.offset += take
                    if p.remaining == 0:
                        heapq.heappop(lane)
                if rows >= self.batch_capacity:
                    break
            if not spans:  # everything queued had expired
                empty = np.empty((0, n_features), np.uint8)
                return (
                    out[:0, :n_features] if out is not None else empty
                ), []
            if out is not None:
                return out[:rows, :n_features], spans
            return np.concatenate(parts, axis=0), spans

    def drain_shed(self) -> List[RequestHandle]:
        """Handles shed (expired) since the last call — the scheduler
        feeds these into the per-lane shed counters."""
        with self.lock:
            shed, self._shed = self._shed, []
        return shed

    @staticmethod
    def demux(
        spans: List[Span],
        preds: np.ndarray,
        sums: Optional[np.ndarray] = None,
    ) -> int:
        """Scatter engine predictions (and, when given, the class-sum rows
        the drift monitor taps) back into the request handles.  Returns how
        many requests COMPLETED with this batch."""
        completed = 0
        for handle, lo, hi, req_lo in spans:
            handle._fill(
                req_lo, preds[lo:hi], None if sums is None else sums[lo:hi]
            )
            if handle.done:
                completed += 1
        return completed
