"""pair_latency_p95_ms (ms, host clock): the 95th percentile of the
latency over every pair of the window, timed as for the median."""

import numpy as np


def read(rec):
    lat = np.repeat(rec["latencies_s"], rec["batch"])
    return float(np.percentile(lat, 95)) * 1e3
