"""Seconds from the start of the process to the first timed submit:
import, CUDA start-up, the kernels' load (and build, on a checkout's
first run), data and model, ``load``, and the clients' warm-up."""


def read(run):
    return run.setup_s
