"""90th percentile of the latency of every pair registered in the window,
in milliseconds; a pair's latency is its call's."""

import numpy as np


def read(r):
    if not r.pair_latency_s:
        return None
    return 1e3 * float(np.percentile(r.pair_latency_s, 90))
