"""Mean host time of one submit in microseconds: the program's
``front_door`` spans (entry to return of ``TMServer.submit``: the checks,
the handle and the enqueue, the batcher's lock wait included) that start
in the window."""

from tmbench import spans


def read(run):
    ms = spans.mean_ms(run, "front_door")
    return None if ms is None else ms * 1e3
