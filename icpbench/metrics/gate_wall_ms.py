"""Wall milliseconds per pair of the overlap gate (the program's ``icp.gate``
span: the gate's planning, its kernels and its survivors' count read) in the
profiled calls; less ``gate_kernel_ms``, its host planning and waits."""

from icpbench.spans import of_traced_calls, wall_s


def read(r):
    spans = of_traced_calls(r)
    ms = 1e3 * wall_s(spans, "icp.gate") if spans else 0.0
    if ms <= 0:
        return None
    return ms / r.traced_pairs
