"""Share of the device's idle time in the steady slice of the trace
during which the scheduler's thread was inside a ``batch`` span: idle
that the host's serving path causes, as against ``loop.wait``, where no
batch was due."""

from tmbench import spans


def read(run):
    return spans.idle_under(run, ("batch",))
