"""Weight planes x 32-clause chunks that the engine's reduce walked per
batch: the mean ``arg`` of the program's ``batch.launch`` spans that
start in the window.  It says at what depth and width each cell served
(1 x 63 for the weightless MNIST machine).  None where the program
records no such product (every ``arg`` 0)."""

from tmbench import spans


def read(run):
    window = spans.window(run)
    if window is None:
        return None
    launch = spans.named(window, "batch.launch")
    if not launch.size or not launch["arg"].any():
        return None
    return float(launch["arg"].mean())
