"""Mean host time of one engine call (``ServeMetrics.engine_s``: the
host clock around ``class_sums``, which ends in a synchronising copy of
the sums to the host) over the window's batches."""


def read(run):
    engine_s = run.served["engine_s"]
    return sum(engine_s) / len(engine_s) * 1e3 if engine_s else None
