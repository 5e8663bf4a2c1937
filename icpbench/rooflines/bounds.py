"""The least time one call of a nearest-neighbour kernel could take on an
NVIDIA H100 SXM: the larger of the bytes it must move over the memory's
bandwidth and its operations over the peak rate outside the tensor cores
(NVIDIA's data sheet, at the card's full 700 W).

Operations: 8 per (query, ref) pair (3 subtractions, 3 multiplications, 2
additions), plus 18 per ref where the kernel moves the refs by a rigid
transform first. Bytes: each input read once, each output written once: the
coordinates of queries and refs, the 12 transform entries, and per query
one (d2, int32 index) pair per neighbour kept (the match keeps the index).
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}  # float32, float64, outside the tensor cores


def bound_ms(kernel: str, n_q: int, n_r: int, dtype_bytes: int = 4, k: int = 1
             ) -> Tuple[float, str]:
    """(least milliseconds of one call, "operations" or "bytes": which of the
    two bounds it). ``kernel`` is "match_transform" (1-NN among refs moved
    by a transform, index out) or "knn_search" (k nearest, d2 and index
    out); n_q queries, n_r refs."""
    ops = 8.0 * n_q * n_r
    nbytes = 3 * dtype_bytes * (n_q + n_r)
    if kernel == "match_transform":
        ops += 18.0 * n_r
        nbytes += 12 * dtype_bytes + n_q * (dtype_bytes + 4)
    elif kernel == "knn_search":
        nbytes += n_q * k * (dtype_bytes + 4)
    else:
        raise ValueError(f"no bound for kernel {kernel!r}")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype_bytes]
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")
