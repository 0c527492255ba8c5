"""The scheduler-owned continuous-batching flush loop.

Historically ``TMServer`` was caller-driven: ``submit()`` queued rows and
nothing ran until someone called ``flush()``.  The ``Scheduler`` inverts
that: one asyncio task per server (run on a dedicated daemon-thread event
loop so synchronous callers never need a loop of their own) wakes on
every submit — or after ``max_wait_ms`` of batching window — forms the
best batch under ``batch_capacity`` per slot (strict priority order, EDF
within a lane, expired requests shed), runs the engine, demuxes, and
asserts the engine never recompiled.  The same batch-formation/execution
body backs the synchronous ``flush()`` path, so the sync API is now a
*delegate* of the scheduler rather than a separate driver.

Admission control: each (slot, lane) has a bounded queue depth in rows;
``admit`` raises the structured ``Overloaded`` error when a submit would
exceed it.  Default depths shrink with priority (critical gets 8x the
low-lane budget), so under sustained overload low-priority traffic is
rejected first while critical keeps being admitted — the edge-SLO shape
of MATADOR-style real-time deployments.

Thread discipline: two locks at two granularities.  The *batcher* owns a
fine-grained re-entrant lock serializing every lane-heap read/mutation
(submit-side enqueues race the loop's batch formation otherwise — see
``Batcher``); admission control composes on it so the depth check and
the enqueue are one atomic section.  The *scheduler* lock serializes the
batch body (formation + engine run + demux) between the loop thread and
synchronous callers (flush, hot-swap drains, rollback).  Hot-swap holds
the scheduler lock across drain + install, so the drain-under-the-old-
program guarantee holds with the loop running.  The loop body itself is
exception-tolerant: an unexpected error is logged and the loop keeps
running rather than silently stranding every pending request.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Dict, Optional

import numpy as np

from .batching import Batcher, PRIORITIES, PRIORITY_RANK
from .metrics import Span, stamp, torch_profiler

logger = logging.getLogger(__name__)

# default per-lane queue-depth budget, in multiples of batch_capacity rows
# (critical admits 8x what low does: overload rejects the low lanes first)
DEFAULT_LANE_DEPTH_BATCHES = {
    "critical": 32, "high": 16, "normal": 8, "low": 4,
}


class Overloaded(RuntimeError):
    """Admission control rejected a submit: the lane's queue is full.

    Structured fields (``slot``, ``priority``, ``pending_rows``,
    ``limit_rows``) let callers implement backoff/retry policies without
    parsing the message."""

    def __init__(
        self, slot: str, priority: str, pending_rows: int, limit_rows: int
    ):
        self.slot = slot
        self.priority = priority
        self.pending_rows = pending_rows
        self.limit_rows = limit_rows
        super().__init__(
            f"slot {slot!r} {priority} lane overloaded: {pending_rows} rows "
            f"queued >= depth limit {limit_rows} — request rejected "
            f"(shed load or retry with backoff)"
        )


class EngineFault(RuntimeError):
    """The batch body raised mid-execution: the engine (or demux) failed
    the whole batch, and every request in it was failed with THIS error
    instead of being left to block until its own timeout.

    Structured fields: ``slot`` (which model slot's batch died) and
    ``cause`` (the original exception).  The scheduler loop itself
    survives — only the batch's requests fail."""

    def __init__(self, slot: str, cause: BaseException):
        self.slot = slot
        self.cause = cause
        super().__init__(
            f"engine batch for slot {slot!r} failed: "
            f"{type(cause).__name__}: {cause} — the batch's requests were "
            f"failed with this error; the serving loop keeps running"
        )


class Scheduler:
    """Continuous-batching driver for one ``TMServer``.

    Constructed unconditionally by the server; until ``start()`` is
    called no loop exists and the sync ``flush()`` path drives the exact
    same ``run_slot_batch`` body (so behavior is identical, minus the
    wake timer)."""

    def __init__(
        self,
        server,
        *,
        max_wait_ms: float = 2.0,
        lane_depth_rows: Optional[Dict[str, int]] = None,
    ):
        self.server = server
        self.max_wait_ms = float(max_wait_ms)
        cap = server.batcher.batch_capacity
        depths = {
            p: DEFAULT_LANE_DEPTH_BATCHES[p] * cap for p in PRIORITIES
        }
        if lane_depth_rows:
            unknown = set(lane_depth_rows) - set(PRIORITIES)
            if unknown:
                raise ValueError(
                    f"unknown lanes in lane_depth_rows: {sorted(unknown)}; "
                    f"expected {PRIORITIES}"
                )
            depths.update(lane_depth_rows)
        self.lane_depth_rows = depths
        # one lock serializes batcher+engine access between the loop
        # thread and sync callers (flush / hot-swap drain / rollback)
        self.lock = threading.RLock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._wake: Optional[asyncio.Event] = None
        self._stop = False
        self._started_evt = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        """Start the continuous-batching loop (idempotent).

        The loop is an asyncio task on a dedicated daemon thread:
        synchronous callers keep their blocking API, async callers
        ``await handle.async_result()``, and submit-side wakes cross the
        thread boundary via ``call_soon_threadsafe``."""
        if self.running:
            return
        self._stop = False
        self._started_evt.clear()
        self._thread = threading.Thread(
            target=self._thread_main, name="tm-scheduler", daemon=True
        )
        self._thread.start()
        self._started_evt.wait()

    def stop(self, drain: bool = True) -> None:
        """Stop the loop; by default drain whatever is still queued
        through the sync path first so no admitted request is stranded."""
        if self.running:
            self._stop = True
            self.wake()
            self._thread.join()
        self._thread = None
        self._loop = None
        self._wake = None
        if drain:
            self.drain_all()

    def _thread_main(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self._wake = asyncio.Event()
        self._started_evt.set()
        try:
            loop.run_until_complete(self._run())
        finally:
            asyncio.set_event_loop(None)
            loop.close()

    def wake(self) -> None:
        """Submit-side kick: schedule the wake event on the loop thread."""
        loop, wake = self._loop, self._wake
        if loop is None or wake is None:
            return
        try:
            loop.call_soon_threadsafe(wake.set)
        except RuntimeError:
            pass  # loop already closed (stop raced a late submit)

    # -- admission control ---------------------------------------------------

    def admit(self, slot: str, priority: str, rows: int) -> None:
        """Raise ``Overloaded`` when ``rows`` more rows would blow the
        (slot, lane) queue-depth budget."""
        if priority not in PRIORITY_RANK:
            raise ValueError(
                f"unknown priority {priority!r}; expected one of {PRIORITIES}"
            )
        limit = self.lane_depth_rows[priority]
        pending = self.server.batcher.pending_rows(slot, priority)
        if pending + rows > limit:
            self.server.metrics.record_admission_reject(priority)
            raise Overloaded(slot, priority, pending, limit)

    def admit_and_enqueue(self, handle, x: np.ndarray) -> None:
        """Atomic admission + enqueue: depth check and heap push happen
        under the batcher lock, so N concurrent submits cannot all pass
        the same check and collectively blow the lane budget."""
        batcher = self.server.batcher
        with batcher.lock:
            self.admit(handle.slot, handle.priority, x.shape[0])
            batcher.enqueue(handle, x)

    # -- the batch body (shared by the loop and the sync flush path) ---------

    def run_slot_batch(self, slot: str) -> int:
        """Form + execute + demux ONE engine batch for ``slot``; returns
        the number of rows served.  Asserts zero recompilation after the
        batch — the no-resynthesis invariant holds per scheduler-formed
        batch, not just per sync flush.

        While a profile runs, a served batch logs its span and the five
        that tile it (``_record_spans``)."""
        server = self.server
        marks = [stamp()] if torch_profiler._is_profiler_enabled else None
        with self.lock:
            if not server.batcher.pending_rows(slot):
                return 0
            entry = server.registry.get(slot)
            X, spans = server.batcher.next_batch(
                slot, out=server.executor.staging, marks=marks
            )
            self._record_shed()
            if not spans:  # everything queued had already expired
                return 0
            if marks is not None:
                marks.append(stamp())
                server.executor.sync_marks = marks
            t0 = time.perf_counter()
            try:
                sums = server.executor.class_sums(entry.program, X)
                dt = time.perf_counter() - t0
                if marks is not None:
                    server.executor.sync_marks = None
                    marks.append(stamp())
                preds = np.argmax(sums, axis=1).astype(np.int32)
            except Exception as cause:
                server.executor.sync_marks = None
                # a raising batch body must not strand its requests until
                # their own timeouts: fail every handle in the batch with
                # a structured error (slot + cause) and keep the loop —
                # and the other slots' traffic — alive.
                fault = EngineFault(slot, cause)
                now = time.perf_counter()
                for handle, _, _, _ in spans:
                    handle._fail(fault, now)
                logger.exception(
                    "engine batch for slot %r failed; %d request(s) "
                    "failed with EngineFault", slot, len(spans),
                )
                return X.shape[0]
            completed = Batcher.demux(spans, preds, sums)
            plane_chunks = entry.program.get("plane_chunks", 0)
            server.metrics.record_batch(
                X.shape[0], server.capacity.batch_capacity, dt, completed
            )
            for handle, _, _, _ in spans:
                if handle.failed:
                    continue  # a prior batch already failed this request
                if handle.done and handle.latency_s is not None:
                    server.metrics.record_lane_completion(
                        handle.priority,
                        handle.queue_delay_s or 0.0,
                        handle.latency_s,
                        missed=handle.missed_deadline,
                    )
            server._check_no_recompile()
            if marks is not None:
                marks.append(stamp())
                self._record_spans(marks, X, spans, plane_chunks)
            return X.shape[0]

    def _record_spans(
        self, marks, X: np.ndarray, spans, plane_chunks: int
    ) -> None:
        """Log a served batch: ``marks`` holds its stamps at entry, when
        the batcher's lock was taken, at the engine call, when the
        device wait began, after it and at the end.  The batch's children
        tile it; ``batch.fill`` carries the bytes written, ``batch.launch``
        the program's weight planes x clause chunks.  Each request it
        completed gets its own span (enqueue to completion, on the
        handle's stamps), child of the batch."""
        metrics = self.server.metrics
        # an engine that never called ``_to_host`` left no wait to time
        waits = marks[3] if len(marks) > 5 else marks[-2]
        bounds = (marks[0], marks[1], marks[2], waits, marks[-2], marks[-1])
        seq = metrics.batches
        batch = metrics.record_span(
            Span.BATCH, bounds[0], bounds[-1], tag=seq, arg=X.shape[0]
        )
        args = {Span.FILL: self.server.executor.staging.nbytes + X.nbytes,
                Span.LAUNCH: plane_chunks}
        for name, a, b in zip(
            (Span.LOCK_WAIT, Span.FILL, Span.LAUNCH, Span.SYNC, Span.DEMUX),
            bounds, bounds[1:],
        ):
            metrics.record_span(
                name, a, b, parent=batch, tag=seq, arg=args.get(name, 0),
            )
        for handle, _, _, _ in spans:
            if handle.completed_at is not None and not handle.failed:
                metrics.record_span(
                    Span.REQUEST, (int(handle.enqueued_at * 1e9), 0),
                    (int(handle.completed_at * 1e9), 0), parent=batch,
                    tag=handle.rid, arg=handle.n_rows,
                )

    def drain_slot(self, slot: str) -> None:
        """Serve every queued row for ``slot`` (the sync flush body and
        the hot-swap drain discipline)."""
        while self.server.batcher.pending_rows(slot):
            self.run_slot_batch(slot)

    def drain_all(self) -> None:
        for slot in self.server.batcher.pending_slots():
            self.drain_slot(slot)

    def _record_shed(self) -> None:
        for handle in self.server.batcher.drain_shed():
            self.server.metrics.record_shed(handle.priority)

    # -- the loop ------------------------------------------------------------

    def _slot_due(self, slot: str, now: float) -> bool:
        """A slot is due when a full batch is waiting, the batching
        window expired, or the earliest queued deadline is at risk."""
        batcher = self.server.batcher
        if batcher.pending_rows(slot) >= batcher.batch_capacity:
            return True
        oldest = batcher.oldest_enqueued_at(slot)
        if oldest is not None and now - oldest >= self.max_wait_ms / 1e3:
            return True
        dl = batcher.earliest_deadline(slot)
        # serve deadlined work a window early rather than shed it late
        return dl is not None and dl - now <= self.max_wait_ms / 1e3

    def _next_due_in(self, now: float) -> float:
        """Seconds until some slot becomes due (sleep bound).

        Bounded by both the batching window of the oldest enqueue AND
        the earliest queued deadline minus a window — ``_slot_due``
        promises to serve deadline-at-risk work a window early, so the
        sleep must wake in time to honor it (a deadline landing just
        after a sleep starts must not be served/shed a window late)."""
        batcher = self.server.batcher
        window = self.max_wait_ms / 1e3
        due_in = window
        for slot in batcher.pending_slots():
            oldest = batcher.oldest_enqueued_at(slot)
            if oldest is not None:
                due_in = min(due_in, max(0.0, oldest + window - now))
            dl = batcher.earliest_deadline(slot)
            if dl is not None:
                due_in = min(due_in, max(0.0, dl - window - now))
        return max(due_in, 1e-4)

    async def _run(self) -> None:
        while not self._stop:
            try:
                now = time.perf_counter()
                served = 0
                for slot in self.server.batcher.pending_slots():
                    if self._slot_due(slot, now):
                        served += self.run_slot_batch(slot)
                if served:
                    # keep draining back-to-back under load, but yield
                    # so cross-thread wakes/cancellations get a turn
                    yielded = (
                        stamp() if torch_profiler._is_profiler_enabled
                        else None
                    )
                    await asyncio.sleep(0)
                    if yielded is not None:
                        self.server.metrics.record_span(
                            Span.LOOP_YIELD, yielded, stamp()
                        )
                    continue
                waited = (
                    stamp() if torch_profiler._is_profiler_enabled else None
                )
                try:
                    await asyncio.wait_for(
                        self._wake.wait(), self._next_due_in(now)
                    )
                except (asyncio.TimeoutError, TimeoutError):
                    pass
                if waited is not None:
                    self.server.metrics.record_span(
                        Span.LOOP_WAIT, waited, stamp()
                    )
                self._wake.clear()
            except Exception:
                # a dead loop thread strands every pending request, so
                # never let one bad iteration kill it: log loudly and
                # keep serving (the recompile assertion included — the
                # invariant violation is reported, traffic still moves)
                logger.exception(
                    "tm-scheduler loop iteration failed; continuing"
                )
                await asyncio.sleep(self.max_wait_ms / 1e3)
