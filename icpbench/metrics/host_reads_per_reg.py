"""The program's counted reads back to the host (utils/sync.py) in the
window, per pair registered."""


def read(r):
    if r.window_pairs == 0:
        return None
    return r.window_host_reads / r.window_pairs
