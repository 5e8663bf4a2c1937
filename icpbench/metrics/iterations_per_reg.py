"""ICP loop iterations per pair registered in the window: each pair's own
count, or, where a call registers a group, the iterations its loop ran
(its slowest pair's) over the pairs of the call."""


def read(r):
    if r.window_pairs == 0:
        return None
    if r.pairs_per_call == 1:
        return sum(r.window_iterations) / r.window_pairs
    return sum(r.window_loop_iterations) / r.window_pairs
