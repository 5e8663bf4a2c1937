"""Percent of its roofline the normals' k-NN kernel (csrc/knn.cu knn_scan and
knn_merge) reaches: the least time of C queries against the fixed cloud,
times the profiled pairs, over the kernel's device time (H100 SXM peaks at
700 W)."""

from icpbench.rooflines import bound_ms


def read(r):
    ms = r.device_ms("knn_scan", "knn_merge")
    if ms <= 0 or r.traced_pairs == 0:
        return None
    one, _ = bound_ms("knn_search", r.icp["correspondences"], r.n_fix, k=r.icp["neighbors"])
    return 100.0 * one * r.traced_pairs / ms
