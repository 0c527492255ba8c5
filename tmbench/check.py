"""The comparison that decides ``correct``: every answer the served path
returned against the plain reference, exactly.

Each request is a slice ``[off, off + n)`` of the seeded pool; the
reference has the class sums and predictions of every pool row.  A
request that never completed, or failed, is lost.  Each number compared
has the limit 0: TM inference is integer arithmetic, and an answer is
right or wrong.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

LIMITS = {"requests_lost": 0, "rows_wrong_sums": 0, "rows_wrong_class": 0}
CHUNK_ROWS = 1 << 20

# (pool offset, rows, int32[rows, M] class sums, int32[rows] predictions)
Answer = Tuple[int, int, np.ndarray, np.ndarray]


def _compare_chunk(chunk, ref_sums, ref_preds):
    offs = np.array([a[0] for a in chunk], np.int64)
    ns = np.array([a[1] for a in chunk], np.int64)
    starts = np.cumsum(ns) - ns
    idx = np.arange(int(ns.sum())) + np.repeat(offs - starts, ns)
    sums = np.concatenate([a[2] for a in chunk])
    preds = np.concatenate([a[3] for a in chunk])
    wrong_sums = int((sums != ref_sums[idx]).any(axis=1).sum())
    wrong_class = int((preds != ref_preds[idx]).sum())
    return wrong_sums, wrong_class, idx.size


def compare(
    answers: Iterable[Answer], lost: int, ref_sums: np.ndarray, ref_preds: np.ndarray
) -> dict:
    """-> {"checks": {name: {"value", "limit"}}, "rows_checked", "correct"}."""
    chunks, chunk, rows = [], [], 0
    for a in answers:
        chunk.append(a)
        rows += a[1]
        if rows >= CHUNK_ROWS:
            chunks.append(chunk)
            chunk, rows = [], 0
    if chunk:
        chunks.append(chunk)
    counts = [_compare_chunk(c, ref_sums, ref_preds) for c in chunks]
    wrong_sums, wrong_class, checked = (sum(c[i] for c in counts) for i in range(3))
    values = {
        "requests_lost": lost,
        "rows_wrong_sums": wrong_sums,
        "rows_wrong_class": wrong_class,
    }
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}
    ok = checked > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return {"checks": checks, "rows_checked": checked, "correct": ok}
