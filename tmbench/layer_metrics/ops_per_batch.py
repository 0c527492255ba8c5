"""Device operations per engine batch: the operations that start in the
steady slice of the trace (``trace.steady_slice``) over the program's
``batch`` spans that start in it, on the profiler's clock."""

import numpy as np

from tmbench import spans, trace


def read(run):
    window = spans.window(run)
    steady = trace.steady_slice(run.events or [])
    if window is None or steady is None:
        return None
    lo, hi = steady
    starts = spans.on_profiler_clock(run, spans.named(window, "batch"))[:, 0]
    batches = int(np.count_nonzero((starts >= lo) & (starts <= hi)))
    ops = sum(lo <= e.start <= hi for e in run.events)
    return ops / batches if batches else None
