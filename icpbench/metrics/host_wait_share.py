"""Share of the registrations' wall the host sat blocked on the card (the
program's ``icp.host_read`` spans, its counted reads back to the host, over
its ``icp.register`` spans) in the profiled calls."""

from icpbench.spans import of_traced_calls, wall_s


def read(r):
    spans = of_traced_calls(r)
    reg = wall_s(spans, "icp.register") if spans else 0.0
    if reg <= 0:
        return None
    return wall_s(spans, "icp.host_read") / reg
