"""Mean length in ms of the program's ``batch.launch`` spans that start in
the window: the engine call up to the copy of its sums to the host (the
staging copy, ``pack_literals`` and the kernel's launches, on the host)."""

from tmbench import spans


def read(run):
    return spans.mean_ms(run, "batch.launch")
