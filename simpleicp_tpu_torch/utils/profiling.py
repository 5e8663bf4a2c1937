"""Profiling and per-stage timing hooks.

  * ``trace(logdir)``: a context manager around ``torch.profiler`` (the
    host's operators, and the card's kernels, copies and fills where a card
    is present) that writes one Chrome trace file under ``logdir``, viewable
    in Perfetto or ``chrome://tracing``;
  * ``StageTimer``: coarse host wall-clock timers around pipeline stages,
    reported through the package logger with the JAX package's lines. The
    card runs asynchronously, so a stage that must include its device work
    ends in a synchronize (or a host read); kernel-level attribution comes
    from the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

from .log import get_logger

_log = get_logger(__name__)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the context; yields the path of the Chrome
    trace that is written there when the context exits."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    _log.info(f"torch profiler trace written to {path}")


class StageTimer:
    """Accumulates named wall-clock stage timings.

    Usage:
        timer = StageTimer()
        with timer.stage("load"):
            ...
        timer.report()
    """

    def __init__(self) -> None:
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = (
                self.timings.get(name, 0.0) + time.perf_counter() - t0
            )

    def report(self, logger: Optional[object] = None) -> Dict[str, float]:
        log = logger or _log
        total = sum(self.timings.values())
        for name, t in self.timings.items():
            log.info(f"stage {name:>14s}: {t:8.3f} s ({100 * t / max(total, 1e-12):5.1f}%)")
        log.info(f"stage {'total':>14s}: {total:8.3f} s")
        return dict(self.timings)
