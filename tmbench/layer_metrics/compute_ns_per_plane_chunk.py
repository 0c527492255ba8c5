"""The card's compute time per unit of the popcount reduce's work, in ns:
the summed device time of the compute operations (copies and memsets
left out) that start in the steady slice of the trace
(``trace.steady_slice``), over the program's ``batch`` spans that start
in that slice, times the batch's words (``batch_words``) and the weight
planes x clause chunks of a batch (``plane_chunks_per_batch``).  It
compares one plane over few chunks with many planes over many."""

import numpy as np

from tmbench import harness, spans, trace


def read(run):
    per_batch = harness.reader("layer_metrics", "plane_chunks_per_batch")(run)
    steady = trace.steady_slice(run.events or [])
    if per_batch is None or steady is None:
        return None
    lo, hi = steady
    starts = spans.on_profiler_clock(run, spans.named(spans.window(run), "batch"))[:, 0]
    batches = int(np.count_nonzero((starts >= lo) & (starts <= hi)))
    compute = sum(e.end - e.start for e in run.events
                  if lo <= e.start <= hi and not e.is_memory)
    if not batches or compute <= 0:
        return None
    units = batches * int(run.traffic["batch_words"]) * per_batch
    return compute * 1e9 / units
