"""Host milliseconds per pair of the registration's planning (the program's
``icp.plan`` span: input conversion, engine resolution, the dispatch plan)
in the profiled calls."""

from icpbench.spans import of_traced_calls, wall_s


def read(r):
    spans = of_traced_calls(r)
    if not spans:
        return None
    return 1e3 * wall_s(spans, "icp.plan") / r.traced_pairs
