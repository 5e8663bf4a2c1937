"""Wall milliseconds per pair of the dilate gate's slab-join plan (the
program's ``icp.gate_slab_plan`` span: the sorts, the read of the sorted
coordinates, the cost model on the host, the blocks' bounds and their read)
in the profiled calls; the card waits through its host part."""

from icpbench.spans import of_traced_calls, wall_s


def read(r):
    spans = of_traced_calls(r)
    ms = 1e3 * wall_s(spans, "icp.gate_slab_plan") if spans else 0.0
    if ms <= 0:
        return None
    return ms / r.traced_pairs
