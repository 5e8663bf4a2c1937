"""Share of the registrations' wall in the solver (the program's
``icp.solve`` spans over its ``icp.register`` spans) in the profiled calls:
the most a faster solver can save."""

from icpbench.spans import of_traced_calls, wall_s


def read(r):
    spans = of_traced_calls(r)
    reg = wall_s(spans, "icp.register") if spans else 0.0
    if reg <= 0:
        return None
    return wall_s(spans, "icp.solve") / reg
