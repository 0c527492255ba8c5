"""The program's span log, read over the window and beside the device
trace.

While a ``torch.profiler`` session runs, the program's ``ServeMetrics``
logs spans of the served path (``front_door``, ``request``, ``batch`` and
its children ``batch.lock_wait`` / ``fill`` / ``launch`` / ``sync`` /
``demux``, ``loop.wait``) on the ``time.perf_counter_ns()`` clock, and
``profiler_offset_ns()`` puts them on the profiler's (wall-clock) one.
The harness drops ``run.acc`` once the window closes; the clients keep the
accelerator, so the log is read through ``run.clients.acc.metrics``.

Every function returns None where there is nothing to read: a program
without a span log, no span in the window, or spans of the window
overwritten in the log's ring (a partial window is never read).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from tmbench import trace


def program_metrics(run):
    """The program's ``ServeMetrics`` with a span log, or None."""
    acc = getattr(getattr(run, "clients", None), "acc", None)
    metrics = getattr(acc, "metrics", None)
    return metrics if hasattr(metrics, "spans") else None


def window(run) -> Optional[np.ndarray]:
    """The spans that start inside ``[run.start, run.end]``, or None."""
    metrics = program_metrics(run)
    if metrics is None:
        return None
    lo, hi = int(run.start * 1e9), int(run.end * 1e9)
    if metrics.spans_dropped and metrics.spans_dropped_until_ns >= lo:
        return None
    spans = metrics.spans(lo, hi)
    return spans if spans.size else None


def named(spans: np.ndarray, name: str) -> np.ndarray:
    return spans[spans["name"] == name]


def mean_ms(run, name: str) -> Optional[float]:
    """Mean length in ms of the window's spans called ``name``."""
    spans = window(run)
    if spans is None:
        return None
    sel = named(spans, name)
    if not sel.size:
        return None
    return float((sel["end_ns"] - sel["start_ns"]).mean()) / 1e6


def on_profiler_clock(run, spans: np.ndarray):
    """float64[n, 2] of the spans' [start, end] in the device events'
    seconds (``trace.DeviceEvent``): the offset between the clocks is
    drawn straight between the log's first reading and one taken now."""
    metrics = program_metrics(run)
    metrics.profiler_offset_ns()
    (p0, o0), (p1, o1) = metrics.span_offsets_ns[0], metrics.span_offsets_ns[-1]
    t = np.stack([spans["start_ns"], spans["end_ns"]], axis=1).astype(np.float64)
    offset = o0 + (o1 - o0) * (t - p0) / (p1 - p0) if p1 > p0 else float(o0)
    return t / 1e9 + offset / 1e9


def merged(intervals) -> List[List[float]]:
    """The union of ``[start, end]`` pairs, by start."""
    out: List[List[float]] = []
    for s, t in sorted(map(tuple, intervals)):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        elif t > s:
            out.append([s, t])
    return out


def overlap(a, b) -> float:
    """Seconds that two unions of intervals (``merged``) share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def steady_idle(run):
    """(the steady slice of the trace, the device's idle intervals in it),
    or None."""
    span = trace.steady_slice(run.events or [])
    if span is None:
        return None
    lo, hi = span
    idle, t = [], lo
    for s, e in trace.busy_intervals(run.events, lo, hi):
        if s > t:
            idle.append([t, s])
        t = e
    if hi > t:
        idle.append([t, hi])
    return span, idle


def idle_under(run, names) -> Optional[float]:
    """Share of the device's idle time in the steady slice that lies
    under the window's spans called one of ``names``, or None."""
    spans = window(run)
    steady = steady_idle(run)
    if spans is None or steady is None:
        return None
    _, idle = steady
    idle_s = sum(t - s for s, t in idle)
    if idle_s <= 0:
        return None
    sel = spans[np.isin(spans["name"], names)]
    return overlap(idle, merged(on_profiler_clock(run, sel))) / idle_s


def report(run) -> Optional[dict]:
    """What the spans say of a traced window beside its device trace:

      clocks_agree    share of the steady slice's device operations that
                      start at or after the start of the latest
                      ``batch.launch`` before them and end at or before
                      the end of that batch's ``batch.sync``, plus 50 us
      idle_under      share of the steady slice's device idle under each
                      kind of span; under neither ``batch`` nor
                      ``loop.wait``: ``unattributed``; under none of the
                      scheduler's spans (those and ``loop.yield``):
                      ``unspanned``
      ms, oncpu       per kind of span: mean length, and the thread's CPU
                      time over its wall time summed over the window
    """
    spans = window(run)
    steady = steady_idle(run)
    if spans is None or steady is None:
        return None
    (lo, hi), idle = steady
    idle_s = sum(t - s for s, t in idle)
    out = {"idle_s": idle_s, "slice_s": hi - lo, "ms": {}, "oncpu": {}, "idle_under": {}}
    for name in np.unique(spans["name"]):
        sel = named(spans, name)
        wall = sel["end_ns"] - sel["start_ns"]
        out["ms"][str(name)] = float(wall.mean()) / 1e6
        if name != "request":  # a request crosses threads: no CPU time
            out["oncpu"][str(name)] = float(sel["cpu_ns"].sum() / max(wall.sum(), 1))
        out["idle_under"][str(name)] = (
            overlap(idle, merged(on_profiler_clock(run, sel))) / idle_s if idle_s else None)
    for key, names in (("unattributed", ("batch", "loop.wait")),
                       ("unspanned", ("batch", "loop.wait", "loop.yield"))):
        sel = spans[np.isin(spans["name"], names)]
        covered = overlap(idle, merged(on_profiler_clock(run, sel)))
        out["idle_under"][key] = 1.0 - covered / idle_s if idle_s else None
    launch = named(spans, "batch.launch")
    launch = launch[np.argsort(launch["start_ns"])]
    sync_end = {int(t): e for t, e in zip(named(spans, "batch.sync")["tag"],
                                          on_profiler_clock(run, named(spans, "batch.sync"))[:, 1])}
    starts = on_profiler_clock(run, launch)[:, 0]
    ops = [e for e in run.events if lo <= e.start <= hi]
    good = 0
    for e in ops:
        k = np.searchsorted(starts, e.start, side="right") - 1
        if k >= 0 and e.end <= sync_end.get(int(launch["tag"][k]), -np.inf) + 50e-6:
            good += 1
    out["clocks_agree"] = good / len(ops) if ops else None
    out["ops"] = len(ops)
    return out
