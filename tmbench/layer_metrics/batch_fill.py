"""Rows served over engine rows run (capacity padding included), from
the program's ``ServeMetrics`` counters over the window."""


def read(run):
    padded = run.served["padded_rows"]
    return run.served["rows"] / padded if padded else None
