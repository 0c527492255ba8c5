"""Datapoints classified and returned per second: the rows of every
request completed inside the window, over the window's length."""


def read(run):
    return sum(r.n for r in run.done) / run.seconds
