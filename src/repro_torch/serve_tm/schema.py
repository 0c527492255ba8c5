"""The ``ServeMetrics.summary()`` key schema of the port.

A copy of ``repro/serve_tm/schema.py``: the port's serving metrics must
render exactly the reference's keys, so dashboards and regression gates
read either package.  tests/test_torch_accel.py holds the two equal and
holds ``summary()`` to these keys.  Pure data, no imports.
"""

# priority lanes, in service order (batching.PRIORITIES re-exports this)
LANES = ("critical", "high", "normal", "low")

# top-level summary() keys
SUMMARY_KEYS = (
    "batches",
    "rows",
    "requests_completed",
    "swaps",
    "fill_ratio",
    "throughput_dps",
    "engine_us",
    "request_latency_us",
    "swap_us",
    "recals",
    "rollbacks",
    "recal_train_s",
    "recal_compress_s",
    "sheds",
    "admission_rejects",
    "deadline_misses",
    "retries",
    "failovers",
    "quarantines",
    "probes",
    "lanes",
)

# keys of each lanes.<lane> sub-dict
LANE_KEYS = (
    "completed",
    "shed",
    "rejected",
    "deadline_miss",
    "queue_delay_us",
    "latency_us",
    "slo_attainment",
)

# percentile sub-dicts: which keys carry {p50, p95, p99} vs {p50, p99}
PCT3_KEYS = ("engine_us", "request_latency_us", "swap_us",
             "recal_train_s", "recal_compress_s")
PCT2_KEYS = ("queue_delay_us", "latency_us")  # inside each lane

# keys of the fleet-level ServeMetrics.aggregate() dict (fleet
# pools render this for BENCH_tm_fleet.json; validated the same way)
AGGREGATE_KEYS = (
    "nodes",
    "batches",
    "rows",
    "requests_completed",
    "swaps",
    "sheds",
    "admission_rejects",
    "deadline_misses",
    "retries",
    "failovers",
    "quarantines",
    "probes",
    "recals",
    "rollbacks",
    "throughput_dps",
    "fill_ratio",
    "lanes",
)

# keys of each aggregate lanes.<lane> sub-dict (counters only: node
# snapshots carry percentiles, which cannot be merged after the fact)
AGGREGATE_LANE_KEYS = (
    "completed",
    "shed",
    "rejected",
    "deadline_miss",
    "slo_attainment",
)

# fleet health: circuit-breaker states and the per-node dict
# fleet.FleetHealth.summary() renders (validated inside the chaos
# scenario of BENCH_tm_fleet.json; pinned by the golden-schema test)
HEALTH_STATES = ("healthy", "degraded", "quarantined", "half_open")

HEALTH_NODE_KEYS = (
    "state",
    "successes",
    "failures",
    "consecutive_failures",
    "error_rate",
    "retries",
    "failovers",
    "overloads",
    "quarantines",
    "probes",
)
