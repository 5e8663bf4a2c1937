"""Seconds from the start of the run's process to its first timed call."""


def read(r):
    return r.setup_s if r.setup_s > 0 else None
