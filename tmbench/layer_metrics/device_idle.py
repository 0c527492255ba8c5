"""Share of a steady slice of the traced window in which no operation
(copies included) ran on the device: the device span of the trace with
a tenth cut at each end."""

from tmbench import trace


def read(run):
    span = trace.steady_slice(run.events or [])
    if span is None:
        return None
    lo, hi = span
    return 1.0 - trace.busy_seconds(run.events, lo, hi) / (hi - lo)
