"""95th percentile of the requests' latency (submit to last row, the
program's host-clock stamps on the handle) over the requests completed in the window."""

import numpy as np


def read(run):
    lat = [r.latency_s for r in run.done]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
