"""The scheduler thread's CPU time over its wall time, summed over the
program's ``batch`` spans that start in the window.  Below 1 where the
thread waits inside a batch: for the interpreter's lock, a lock of the
program, or the device."""

from tmbench import spans


def read(run):
    window = spans.window(run)
    if window is None:
        return None
    batch = spans.named(window, "batch")
    wall = int((batch["end_ns"] - batch["start_ns"]).sum())
    return int(batch["cpu_ns"].sum()) / wall if wall > 0 else None
