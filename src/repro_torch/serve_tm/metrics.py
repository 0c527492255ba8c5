"""Latency/throughput instrumentation for the serving subsystem.

Counters are recorded per engine batch (rows served, capacity fill,
engine wall time), per completed request (queue-to-done latency), per
model swap, and — since the scheduler-owned continuous-batching runtime —
per priority LANE: queue-delay and end-to-end latency percentiles,
deadline misses (completed late), sheds (expired before service) and
admission rejects, plus SLO attainment.  ``summary()`` renders a
JSON-friendly dict whose keys are pinned by serve_tm/schema.py, the
same keys as the reference package's:

  batches, rows, requests_completed, swaps      int counters
  fill_ratio                                    rows / padded engine rows
  throughput_dps                                rows / engine seconds
  engine_us / request_latency_us / swap_us      {p50, p95, p99}
  recals, rollbacks, recal_*_s                  Fig-8 loop counters
  sheds, admission_rejects, deadline_misses     totals across lanes
  retries, failovers, quarantines, probes       fleet health/retry path
                                                (a router records them on
                                                the node that finally
                                                served the request)
  lanes.<lane>.completed|shed|rejected|deadline_miss    int counters
  lanes.<lane>.queue_delay_us|latency_us        {p50, p99}
  lanes.<lane>.slo_attainment                   completed-in-deadline /
                                                (completed + shed); 1.0
                                                when nothing carried a
                                                deadline

Latencies are kept for the most recent ``LATENCY_WINDOW`` completions of
each lane, so a long-lived server holds a bounded history;
``request_latency_us`` is taken over all lanes' windows.

The span log.  While a ``torch.profiler`` session runs anywhere in the
process, the served path records spans into a fixed ring (``SPAN_NAMES``:
the front door, each request, each batch and the five steps that tile
it, the loop's idle wait and its yield between batches), each with its
start and end on the ``time.perf_counter_ns()`` clock, the thread's CPU
nanoseconds over it, its id and its parent's id; ``spans()`` returns
them and ``profiler_offset_ns()`` maps them onto the profiler's clock.
With no profiler running the served path reads one module flag per
submit, batch and loop turn, and records nothing; the ring is allocated
the first time a span is recorded.
"""

from __future__ import annotations

import enum
import itertools
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
# ``torch_profiler._is_profiler_enabled`` is the served path's switch: the
# module flag that every thread sees while a profile runs (the C++ check,
# ``torch.autograd._profiler_enabled()``, is false on threads other than
# the one that started the profiler, such as the scheduler's)
from torch.autograd import profiler as torch_profiler  # noqa: F401

from .batching import PRIORITIES

LATENCY_WINDOW = 65536  # completions kept per lane for the percentiles


class Span(enum.IntEnum):
    """What a span times (``SPAN_NAMES[span]`` is its name)."""

    FRONT_DOOR = 0  # submit, entry to return: checks, handle, enqueue, wake
    REQUEST = 1     # a request, enqueue to completion; parent: its batch
    BATCH = 2       # Scheduler.run_slot_batch, the whole body
    LOCK_WAIT = 3   # the scheduler's lock, then the batcher's in next_batch
    FILL = 4        # next_batch's zero-fill and row copies into staging
    LAUNCH = 5      # the engine call up to its device-to-host copy
    SYNC = 6        # the device-to-host copy of the sums: the device wait
    DEMUX = 7       # argmax, demux, the lanes' bookkeeping, recompile check
    LOOP_WAIT = 8   # the loop waiting for a wake or its window, no batch due
    LOOP_YIELD = 9  # the loop's yield between back-to-back batches: the
                    # submitters' wake callbacks and the interpreter's lock


SPAN_NAMES = (
    "front_door", "request", "batch", "batch.lock_wait", "batch.fill",
    "batch.launch", "batch.sync", "batch.demux", "loop.wait", "loop.yield",
)
SPAN_CAPACITY = 1 << 20  # ring entries: 7 int64 columns, 56 MiB
# one ring row: name, start_ns, end_ns, cpu_ns, parent, tag, arg; a span's
# id is the count of spans recorded before it, so it needs no column
SPAN_DTYPE = np.dtype([
    ("id", np.int64), ("name", "U15"), ("start_ns", np.int64),
    ("end_ns", np.int64), ("cpu_ns", np.int64), ("parent", np.int64),
    ("tag", np.int64), ("arg", np.int64),
])

Stamp = Tuple[int, int]  # (perf_counter_ns, thread_time_ns)


def stamp() -> Stamp:
    """Now, on the host clock and on this thread's CPU clock: one end of
    a span."""
    return time.perf_counter_ns(), time.thread_time_ns()


def _pcts(xs: Sequence[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    a = np.asarray(xs)
    return {
        "p50": float(np.percentile(a, 50)),
        "p95": float(np.percentile(a, 95)),
        "p99": float(np.percentile(a, 99)),
    }


def _pcts2(xs: Sequence[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p99": 0.0}
    a = np.asarray(xs)
    return {
        "p50": float(np.percentile(a, 50)),
        "p99": float(np.percentile(a, 99)),
    }


class ServeMetrics:
    def __init__(self):
        self.batches = 0
        self.rows = 0            # real datapoints served
        self.padded_rows = 0     # engine rows incl. capacity padding
        self.requests_completed = 0
        self.swaps = 0
        self.recals = 0          # completed recalibration pipeline runs
        self.rollbacks = 0       # post-swap validation failures
        # fleet health/retry path (recorded by a fleet.Router, on the
        # node that finally served the request)
        self.retries = 0         # requests served only after backoff
        self.failovers = 0       # requests served after another node failed
        self.quarantines = 0     # circuit-breaker opened on this node
        self.probes = 0          # half-open probes admitted to this node
        # a list, not a bounded window: the benchmark reads it by index
        self.engine_s: List[float] = []
        self.swap_s: List[float] = []
        self.recal_train_s: List[float] = []
        self.recal_compress_s: List[float] = []
        # per-priority-lane accounting (the async front door)
        self.lane_completed = {p: 0 for p in PRIORITIES}
        self.lane_shed = {p: 0 for p in PRIORITIES}
        self.lane_rejected = {p: 0 for p in PRIORITIES}
        self.lane_deadline_miss = {p: 0 for p in PRIORITIES}
        self.lane_in_slo = {p: 0 for p in PRIORITIES}
        self.lane_queue_delay_s: Dict[str, Deque[float]] = {
            p: deque(maxlen=LATENCY_WINDOW) for p in PRIORITIES
        }
        self.lane_latency_s: Dict[str, Deque[float]] = {
            p: deque(maxlen=LATENCY_WINDOW) for p in PRIORITIES
        }
        # the span log (see the module docstring)
        self.span_capacity = SPAN_CAPACITY
        self._ring: Optional[np.ndarray] = None
        self._spans_written = 0
        self._span_lock = threading.Lock()
        self.spans_dropped_until_ns = -1  # latest end among overwritten spans
        # (perf_counter_ns, profiler_offset_ns()) of each reading: the
        # first when the first span was recorded, then one per read
        self.span_offsets_ns: List[Tuple[int, int]] = []

    def record_batch(
        self, rows: int, capacity: int, elapsed_s: float, completed: int
    ) -> None:
        """One engine batch of ``capacity`` rows, ``rows`` of them served."""
        self.batches += 1
        self.rows += rows
        self.padded_rows += capacity
        self.engine_s.append(elapsed_s)
        self.requests_completed += completed

    def record_lane_completion(
        self,
        lane: str,
        queue_delay_s: float,
        latency_s: float,
        missed: bool = False,
    ) -> None:
        """One request finished in ``lane``; ``missed`` marks a request
        that completed but AFTER its deadline (served-late SLO miss, as
        opposed to a shed, which never got served at all)."""
        self.lane_completed[lane] += 1
        self.lane_queue_delay_s[lane].append(queue_delay_s)
        self.lane_latency_s[lane].append(latency_s)
        if missed:
            self.lane_deadline_miss[lane] += 1
        else:
            self.lane_in_slo[lane] += 1

    def record_shed(self, lane: str) -> None:
        """A queued request expired (deadline passed) before service."""
        self.lane_shed[lane] += 1

    def record_admission_reject(self, lane: str) -> None:
        """Admission control refused a submit (lane queue depth full)."""
        self.lane_rejected[lane] += 1

    def record_swap(self, elapsed_s: float) -> None:
        self.swaps += 1
        self.swap_s.append(elapsed_s)

    def record_recal(self, train_s: float, compress_s: float) -> None:
        """One completed recalibration (train + compress + publish)."""
        self.recals += 1
        self.recal_train_s.append(train_s)
        self.recal_compress_s.append(compress_s)

    def record_rollback(self) -> None:
        self.rollbacks += 1

    def record_retry(self) -> None:
        """A request landed here only after at least one backoff sweep."""
        self.retries += 1

    def record_failover(self) -> None:
        """A request landed here after another node failed it first."""
        self.failovers += 1

    def record_quarantine(self) -> None:
        """The fleet circuit breaker quarantined this node."""
        self.quarantines += 1

    def record_probe(self) -> None:
        """A half-open probe request was admitted to this node."""
        self.probes += 1

    # -- the span log --------------------------------------------------------

    def record_span(
        self, name: Span, a: Stamp, b: Stamp, parent: int = -1,
        tag: int = -1, arg: int = 0,
    ) -> int:
        """Log span ``name`` from stamp ``a`` to stamp ``b`` (``stamp()``;
        a span that crosses threads passes CPU stamps of 0); returns its
        id.  ``tag`` is the request's rid or the batch's sequence number,
        ``arg`` a count the span carries (rows, bytes written).  Past
        ``span_capacity`` spans the oldest is overwritten and counted in
        ``spans_dropped``."""
        with self._span_lock:
            ring = self._ring
            if ring is None:
                ring = self._ring = np.empty(
                    (self.span_capacity, len(SPAN_DTYPE) - 1), np.int64
                )
                self.profiler_offset_ns()
            i = self._spans_written
            self._spans_written = i + 1
            j = i % len(ring)
            if i >= len(ring):
                self.spans_dropped_until_ns = max(
                    self.spans_dropped_until_ns, int(ring[j, 2])
                )
            ring[j] = (name, a[0], b[0], b[1] - a[1], parent, tag, arg)
        return i

    @property
    def spans_dropped(self) -> int:
        """Spans overwritten by newer ones since the ring was allocated."""
        if self._ring is None:
            return 0
        return max(0, self._spans_written - len(self._ring))

    def spans(
        self, lo_ns: Optional[int] = None, hi_ns: Optional[int] = None
    ) -> np.ndarray:
        """The logged spans that start in ``[lo_ns, hi_ns]`` (host clock,
        ``time.perf_counter_ns()``; None: unbounded), by id, as a
        ``SPAN_DTYPE`` array."""
        with self._span_lock:
            n = self._spans_written
            if self._ring is None or n == 0:
                return np.empty(0, SPAN_DTYPE)
            ids = np.arange(max(0, n - len(self._ring)), n)
            rows = self._ring[ids % len(self._ring)]
        out = np.empty(ids.size, SPAN_DTYPE)
        out["id"] = ids
        out["name"] = np.asarray(SPAN_NAMES)[rows[:, 0]]
        for j, field in enumerate(SPAN_DTYPE.names[2:], start=1):
            out[field] = rows[:, j]
        keep = np.ones(ids.size, bool)
        if lo_ns is not None:
            keep &= out["start_ns"] >= lo_ns
        if hi_ns is not None:
            keep &= out["start_ns"] <= hi_ns
        return out[keep]

    def profiler_offset_ns(self) -> int:
        """``time.time_ns() - time.perf_counter_ns()``: subtract it from a
        ``torch.profiler`` event's ``start_ns()`` (wall-clock nanoseconds)
        to put the event on the spans' clock.  The closest of a few paired
        readings; each is appended to ``span_offsets_ns`` with the host
        clock it was read at, after the one read when the first span was
        recorded, so that a reader can follow the wall clock's drift."""
        best = None
        for _ in range(5):
            p0 = time.perf_counter_ns()
            wall = time.time_ns()
            p1 = time.perf_counter_ns()
            if best is None or p1 - p0 < best[0]:
                best = (p1 - p0, (p0 + p1) // 2, wall - (p0 + p1) // 2)
        self.span_offsets_ns.append(best[1:])
        return best[2]

    def _lane_summary(self, lane: str) -> Dict:
        completed = self.lane_completed[lane]
        shed = self.lane_shed[lane]
        terminal = completed + shed
        return {
            "completed": completed,
            "shed": shed,
            "rejected": self.lane_rejected[lane],
            "deadline_miss": self.lane_deadline_miss[lane],
            "queue_delay_us": {
                k: v * 1e6
                for k, v in _pcts2(self.lane_queue_delay_s[lane]).items()
            },
            "latency_us": {
                k: v * 1e6
                for k, v in _pcts2(self.lane_latency_s[lane]).items()
            },
            # served within deadline (no deadline counts as attained)
            # over everything that reached a terminal state
            "slo_attainment": (
                self.lane_in_slo[lane] / terminal if terminal else 1.0
            ),
        }

    @classmethod
    def aggregate(cls, snapshots: "List[Dict]") -> Dict:
        """Fleet-level rollup of per-node ``summary()`` snapshots (the
        ``ServingNode.metrics_snapshot()`` dicts a pool collects).

        Counters sum across nodes.  ``throughput_dps`` is the fleet's
        aggregate serving capacity: nodes execute in PARALLEL (each is
        its own accelerator), so the fleet rate is the SUM of per-node
        rates (rows_i / engine_seconds_i), not total-rows over
        total-engine-seconds — the latter would model nodes taking
        turns.  Per-node engine seconds are recovered from each
        snapshot's own rows/throughput ratio.  Percentiles are NOT
        merged (they can't be, from summaries); read them per node.
        Schema pinned as ``AGGREGATE_KEYS`` in serve_tm/schema.py."""
        agg: Dict = {"nodes": len(snapshots)}
        for key in ("batches", "rows", "requests_completed", "swaps",
                    "sheds", "admission_rejects", "deadline_misses",
                    "retries", "failovers", "quarantines", "probes",
                    "recals", "rollbacks"):
            agg[key] = sum(int(s[key]) for s in snapshots)
        agg["throughput_dps"] = float(sum(
            s["throughput_dps"] for s in snapshots
        ))
        padded = sum(
            s["rows"] / s["fill_ratio"] for s in snapshots
            if s["fill_ratio"] > 0
        )
        agg["fill_ratio"] = agg["rows"] / padded if padded else 0.0
        lanes: Dict = {}
        for lane in PRIORITIES:
            stats = [s["lanes"][lane] for s in snapshots]
            completed = sum(t["completed"] for t in stats)
            shed = sum(t["shed"] for t in stats)
            in_slo = sum(
                round(t["slo_attainment"] * (t["completed"] + t["shed"]))
                for t in stats
            )
            lanes[lane] = {
                "completed": completed,
                "shed": shed,
                "rejected": sum(t["rejected"] for t in stats),
                "deadline_miss": sum(t["deadline_miss"] for t in stats),
                "slo_attainment": (
                    in_slo / (completed + shed) if completed + shed else 1.0
                ),
            }
        agg["lanes"] = lanes
        return agg

    def summary(self) -> Dict:
        engine_total = sum(self.engine_s)
        return {
            "batches": self.batches,
            "rows": self.rows,
            "requests_completed": self.requests_completed,
            "swaps": self.swaps,
            "fill_ratio": (
                self.rows / self.padded_rows if self.padded_rows else 0.0
            ),
            "throughput_dps": (
                self.rows / engine_total if engine_total > 0 else 0.0
            ),
            "engine_us": {
                k: v * 1e6 for k, v in _pcts(self.engine_s).items()
            },
            "request_latency_us": {
                k: v * 1e6 for k, v in _pcts(list(itertools.chain(
                    *self.lane_latency_s.values()
                ))).items()
            },
            "swap_us": {k: v * 1e6 for k, v in _pcts(self.swap_s).items()},
            "recals": self.recals,
            "rollbacks": self.rollbacks,
            "recal_train_s": {
                k: float(v) for k, v in _pcts(self.recal_train_s).items()
            },
            "recal_compress_s": {
                k: float(v) for k, v in _pcts(self.recal_compress_s).items()
            },
            "sheds": sum(self.lane_shed.values()),
            "admission_rejects": sum(self.lane_rejected.values()),
            "deadline_misses": sum(self.lane_deadline_miss.values()),
            "retries": self.retries,
            "failovers": self.failovers,
            "quarantines": self.quarantines,
            "probes": self.probes,
            "lanes": {p: self._lane_summary(p) for p in PRIORITIES},
        }
