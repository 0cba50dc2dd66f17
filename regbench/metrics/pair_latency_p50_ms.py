"""pair_latency_p50_ms (ms, host clock): the median latency over every
pair of the window, a pair timed from the hand-over of its raw clouds to
the copy until its transform and status are on the host."""

import numpy as np


def read(rec):
    lat = np.repeat(rec["latencies_s"], rec["batch"])
    return float(np.percentile(lat, 50)) * 1e3
