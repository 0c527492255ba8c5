"""Milliseconds of the card's compute per million rows served: the summed
device time of the window's compute operations (copies and memsets left
out, from the profiler's trace) over the rows that the engine served in
it.  It is what the card's kernels cost per row, and it does not wait on
the host: a kernel or packing gain shows here where the host paces
``rows_per_s``.  Copies are left out because their time follows the
host's memory traffic: on two H100 hosts mnist-bulk read 54.5 and
57.6-58.1 ms/Mrow of copies and compute together, its compute alike."""


def read(run):
    rows = run.served["rows"]
    if not run.events or not rows:
        return None
    compute = sum(e.end - e.start for e in run.events if not e.is_memory)
    return compute * 1e3 / (rows / 1e6) if compute > 0 else None
