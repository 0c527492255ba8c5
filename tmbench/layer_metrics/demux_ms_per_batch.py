"""Mean length in ms of the program's ``batch.demux`` spans that start in
the window: after the engine call: argmax, ``Batcher.demux``, the lanes'
bookkeeping and the recompile check."""

from tmbench import spans


def read(run):
    return spans.mean_ms(run, "batch.demux")
