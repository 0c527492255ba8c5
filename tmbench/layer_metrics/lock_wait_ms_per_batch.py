"""Mean length in ms of the program's ``batch.lock_wait`` spans that start in
the window: the wait for the scheduler's lock, then for the batcher's in
``next_batch``."""

from tmbench import spans


def read(run):
    return spans.mean_ms(run, "batch.lock_wait")
