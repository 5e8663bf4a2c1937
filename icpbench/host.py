"""The host's side of a run: what the harness does to keep the window's
host time steady, and what it reads to tell the host's noise apart.

A registration here is mostly host time (the program launches thousands
of small device operations), so the host is what moves a run.
Before the window the harness collects and freezes the set-up's objects
(``gc.freeze``: later collections skip the imports' hundreds of thousands
of objects) and pins the calling thread to the CPU it runs on. Around the
window it reads the thread's CPU time and the machine's steal time, and
after it the time a pair took in each half of the window. They are printed
on standard error, not reported as metrics.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict


def _current_cpu() -> int:
    with open("/proc/self/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[36])


def steady() -> None:
    """Collect and freeze the set-up's objects; pin this thread to its CPU."""
    gc.collect()
    gc.freeze()
    try:
        os.sched_setaffinity(0, {_current_cpu()})
    except (OSError, ValueError, IndexError, AttributeError):
        pass


def _steal() -> tuple:
    """(steal, total) jiffies of the machine, or (0, 0)."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:9]]
        return v[7], sum(v)
    except (OSError, ValueError, IndexError):
        return 0, 0


class Watch:
    """The thread's CPU time and the machine's steal time over a span."""

    def __enter__(self):
        self.t, self.cpu, self.steal = time.perf_counter(), time.thread_time(), _steal()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.t
        s1 = _steal()
        total = s1[1] - self.steal[1]
        self.read = {"thread_cpu_share": (time.thread_time() - self.cpu) / wall if wall else 0.0,
                     "steal_share": (s1[0] - self.steal[0]) / total if total else 0.0}
        return False


def halves_ms(latency_s, pairs) -> Dict[str, float]:
    """Milliseconds per pair over the first and the second half of the
    window's calls (drift inside one run)."""
    h = len(latency_s) // 2
    if h == 0:
        return {}
    ms = lambda lat, n: 1e3 * sum(lat) / sum(n)
    return {"first_half_ms": ms(latency_s[:h], pairs[:h]),
            "second_half_ms": ms(latency_s[h:], pairs[h:])}
