"""Mean length in ms of the program's ``batch.fill`` spans that start in
the window: ``next_batch``'s zero-fill of the staging block and its row
copies."""

from tmbench import spans


def read(run):
    return spans.mean_ms(run, "batch.fill")
