"""The least time of the TM inference work of served rows on one H100.

Counted from the configuration and the number of rows alone, never from
a kernel's operands, so that fusing or splitting the program's kernels
cannot move the count.  Each row's features are read once at one bit
each, and its class sums written once at the fewest whole bytes that
hold their range: a class of C clauses whose weights are at most W (1
weightless) sums into [-floor(C/2) W, ceil(C/2) W], C W + 1 values.  The
weight planes a kernel walks are never counted.
Each include ANDs one literal word into a clause word for 32 rows: one
32-bit operation per include per 32 rows, at the fp32 rate outside the
tensor cores (no int32 rate is published beside it; the highest
candidate keeps the time a lower bound).  The clause popcounts and the
class additions are left out, so the count stays a lower bound.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense, at 700 W.
"""

from __future__ import annotations

import math

HBM_BW = 3.35e12  # bytes/s
PEAK_FP32_FLOPS = 67e12  # fp32 operations/s outside the tensor cores


def n_includes(config: dict) -> int:
    """Includes of the configuration's machine: its density over every
    automaton (classes x clauses x 2 features)."""
    n_tas = (
        int(config["n_classes"]) * int(config["n_clauses"])
        * 2 * int(config["n_features"])
    )
    return round(float(config["include_density"]) * n_tas)


def max_weight(config: dict) -> int:
    """The largest clause weight the configuration states (1 weightless)."""
    return int(config["clause_weights"]["max"]) if config.get("weighted") else 1


def inference_work(config: dict, rows: float) -> dict:
    """Bytes, operations and the least seconds of ``rows`` inferences."""
    M, C, F = (int(config[k]) for k in ("n_classes", "n_clauses", "n_features"))
    sum_bytes = math.ceil((C * max_weight(config)).bit_length() / 8)
    n_bytes = rows * (math.ceil(F / 8) + M * sum_bytes)
    n_ops = rows * n_includes(config) / 32
    t_bytes, t_ops = n_bytes / HBM_BW, n_ops / PEAK_FP32_FLOPS
    return {
        "bytes": n_bytes,
        "ops": n_ops,
        "seconds": max(t_bytes, t_ops),
        "bound": "bytes" if t_bytes >= t_ops else "operations",
    }
