"""Percent of its roofline the match kernel (csrc/knn.cu match_scan and
match_finish) reaches: the least time of C queries against the movable
cloud, times each profiled pair's iterations, over the kernel's device time
(H100 SXM peaks at 700 W)."""

from icpbench.rooflines import bound_ms


def read(r):
    ms = r.device_ms("match_scan", "match_finish")
    if ms <= 0 or not r.traced_iterations:
        return None
    one, _ = bound_ms("match_transform", r.icp["correspondences"], r.n_mov)
    return 100.0 * one * sum(r.traced_iterations) / ms
