"""Milliseconds of the window per pair registered: the window's seconds
over the pairs its calls registered (a batch call counts its pairs)."""


def read(r):
    if r.window_pairs == 0:
        return None
    return 1e3 * r.window_seconds / r.window_pairs
