"""Share of the ICP loop's iterations that ran as a replay of a cached CUDA
graph in the profiled calls: the program's ``icp.loop_graph`` counters
(iterations by how they ran: ``replays``, ``eager``), replays over all.
None where the program keeps no such counter."""

from icpbench.counters import of_traced


def read(r):
    counts = of_traced(r, "icp.loop_graph")
    if not counts:
        return None
    total = sum(c["replays"] + c["eager"] for c in counts)
    return sum(c["replays"] for c in counts) / total if total else None
