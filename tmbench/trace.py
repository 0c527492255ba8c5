"""Device activity from a ``torch.profiler`` trace of the window.

The events are read raw from the profiler's results
(``prof.profiler.kineto_results.events()``, as the port's
``chip_smoke.py`` ``_device_events`` reads them): ``key_averages()``
takes minutes over a long window, and summing it would count each
kernel twice, once as itself and once as the operator that launched it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

MEMORY_OPS = ("Memcpy", "Memset")


class DeviceEvent(NamedTuple):
    """One operation that ran on the device (times in seconds)."""

    name: str
    start: float
    end: float

    @property
    def is_memory(self) -> bool:
        return self.name.startswith(MEMORY_OPS)


def device_events(prof) -> List[DeviceEvent]:
    """Every device operation of a finished profile, by start."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = [
        DeviceEvent(ev.name(), ev.start_ns() / 1e9, ev.end_ns() / 1e9)
        for ev in prof.profiler.kineto_results.events()
        if ev.device_type() == cuda
    ]
    return sorted(out, key=lambda e: e.start)


def busy_intervals(events, lo: float = float("-inf"), hi: float = float("inf")):
    """The union of the events' intervals, clipped to [lo, hi]."""
    merged: List[List[float]] = []
    for e in events:
        s, t = max(e.start, lo), min(e.end, hi)
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def busy_seconds(events, lo: float = float("-inf"), hi: float = float("inf")) -> float:
    return sum(t - s for s, t in busy_intervals(events, lo, hi))


def steady_slice(events, trim: float = 0.1) -> Optional[Tuple[float, float]]:
    """The device span of the events with ``trim`` of it cut at each end
    (the clients' start and the drain at the close), or None."""
    if not events:
        return None
    first = events[0].start
    last = max(e.end for e in events)
    cut = (last - first) * trim
    return first + cut, last - cut


def top_ops(events, n: int = 10) -> List[list]:
    """[[name, seconds]] of the ``n`` device operations that took most
    time, summed by name."""
    total: dict = {}
    for e in events:
        total[e.name] = total.get(e.name, 0.0) + (e.end - e.start)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], sec] for name, sec in ranked]


def idle_gaps(events, n: int = 10) -> List[list]:
    """[[name, seconds]] of the ``n`` kinds of idle gap that took most
    time, a gap named by the operations on either side of it: what the
    device finished, then what the host launched next."""
    total: dict = {}
    end, prev = None, None
    for e in events:
        if end is not None and e.start > end:
            key = f"after {prev[:60]} | before {e.name[:60]}"
            total[key] = total.get(key, 0.0) + (e.start - end)
        if end is None or e.end > end:
            end, prev = e.end, e.name
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, sec] for name, sec in ranked]
