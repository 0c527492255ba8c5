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
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .batching import PRIORITIES


def _pcts(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    a = np.asarray(xs)
    return {
        "p50": float(np.percentile(a, 50)),
        "p95": float(np.percentile(a, 95)),
        "p99": float(np.percentile(a, 99)),
    }


def _pcts2(xs: List[float]) -> Dict[str, float]:
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
        self.engine_s: List[float] = []
        self.request_latency_s: List[float] = []
        self.swap_s: List[float] = []
        self.recal_train_s: List[float] = []
        self.recal_compress_s: List[float] = []
        # per-priority-lane accounting (the async front door)
        self.lane_completed = {p: 0 for p in PRIORITIES}
        self.lane_shed = {p: 0 for p in PRIORITIES}
        self.lane_rejected = {p: 0 for p in PRIORITIES}
        self.lane_deadline_miss = {p: 0 for p in PRIORITIES}
        self.lane_in_slo = {p: 0 for p in PRIORITIES}
        self.lane_queue_delay_s = {p: [] for p in PRIORITIES}
        self.lane_latency_s = {p: [] for p in PRIORITIES}

    def record_batch(
        self, rows: int, capacity: int, elapsed_s: float, completed: int
    ) -> None:
        self.batches += 1
        self.rows += rows
        self.padded_rows += capacity
        self.engine_s.append(elapsed_s)
        self.requests_completed += completed

    def record_request_latency(self, latency_s: float) -> None:
        self.request_latency_s.append(latency_s)

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
                k: v * 1e6 for k, v in _pcts(self.request_latency_s).items()
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
