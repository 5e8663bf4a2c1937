"""Profiling and per-stage timing hooks.

  * ``span(name)``: a named range inside the program. While a
    ``torch.profiler`` records, it lands in the profiler's own event list
    (and in the Chrome trace ``trace`` writes) as a host operation, on the
    clock of the host's ``aten::`` operations, the runtime's launch calls
    and the card's kernels, so that each idle gap of the card can be put
    down to the stage open at the time; it is also kept, on the host's
    clock, for ``recorded_spans``. Otherwise it is one shared no-op
    context: no torch call, no allocation, no clock read. The profiler is
    the only switch. The registration's spans are named in ``SPANS``;
  * ``record_counters(name, values)``: one call's counts of a stage (the
    dilate gate's band, kept refs, sweeps and plan; the loop's iterations
    by how they ran, ``icp.loop_graph``; whether the finish's uncertainties
    ran as the kernel or the plain version, ``icp.finish``), kept whether
    or not a profiler records, with the time they were kept, for
    ``recorded_counters``;
  * ``trace(logdir)``: a context manager around ``torch.profiler`` (the
    host's operators, and the card's kernels, copies and fills where a card
    is present) that writes one Chrome trace file under ``logdir``, viewable
    in Perfetto or ``chrome://tracing``;
  * ``StageTimer``: host wall-clock timers around pipeline stages, reported
    through the package logger with the JAX package's lines. Each stage is
    a ``span`` and, where a CUDA context is initialised, ends in a
    synchronize, so that its time includes its device work.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

from .log import get_logger

_log = get_logger(__name__)

# The spans of a registration (models/icp.py, models/solver.py, utils/sync.py):
#   icp.register   icp_register's body, and icp_register_batch's; one a call
#   icp.plan       input conversion, engine resolution, a warm start's
#                  coarse pass, the grid matcher's cell list, the dispatch
#                  plan and the stall check's estimate
#   icp.gate       the overlap gate, up to its survivors' count read
#   icp.gate_plan  inside icp.gate: the gate's method and dilate plan, with
#                  its bounding-box read
#   icp.gate_classify  inside icp.gate, the dilate gate (ops/dilate_gate.py):
#                  the occupancy's pack, the IN and POSS dilations, the
#                  classify and the band's read
#   icp.gate_compact   the band-ref compaction with its read of the kept refs
#   icp.gate_slab_plan the slab join's plan: the sorts on the card, the read
#                  of the sorted coordinates, the cost model on the host, the
#                  blocks' bounds and their read
#   icp.gate_sweep     the band's exact sweeps, direct or by slab blocks
#   icp.select     the fixed-count selection
#   icp.normals    the selected points and their normals (or a
#                  preparation's, unpacked)
#   icp.loop       the ICP loop from its initial state (every chunk)
#   icp.iteration  one iteration with its stop-flag read; inside it, where
#                  the iteration runs eagerly (a replay of its CUDA graph,
#                  models/loop_graph.py, runs no Python inside it)
#   icp.match        the transform and the match
#   icp.reject       the distances, the planarity gate, median/MAD, the mask
#                    and its count, iteration 0's statistics and weight
#   icp.solve        the Gauss-Newton or linearized solve, up to the new H
#   icp.converge     the statistics, the convergence test, the state update
#                    and the buffers' rows
#   icp.finish     the uncertainties and the result
#   icp.host_read  one counted read back to the host (utils/sync.py)
SPANS = ("icp.register", "icp.plan", "icp.gate", "icp.gate_plan", "icp.gate_classify",
         "icp.gate_compact", "icp.gate_slab_plan", "icp.gate_sweep", "icp.select",
         "icp.normals", "icp.loop", "icp.iteration", "icp.match", "icp.reject",
         "icp.solve", "icp.converge", "icp.finish", "icp.host_read")

_NOOP = contextlib.nullcontext()
# Spans closed while a profiler recorded: (name, start_ns, end_ns) on the
# host's perf_counter clock, the newest 2^16.
_recorded: collections.deque = collections.deque(maxlen=1 << 16)


class _Span:
    """A span under a recording profiler: a host operation of its event
    list (no device-side mirror, unlike ``record_function``'s annotations)
    and an entry of ``recorded_spans``."""

    __slots__ = ("name", "op", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.op = torch._C._profiler._RecordFunctionFast(self.name)
        self.op.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.op.__exit__(*exc)
        _recorded.append((self.name, self.t0, t1))
        return False


def recording() -> bool:
    """Whether a profiler records."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context manager naming the work inside it, while a profiler
    records; the shared no-op otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _NOOP


def recorded_spans() -> List[Tuple[str, float, float]]:
    """The spans closed while a profiler recorded, since the process started
    or ``clear_recorded_spans``: (name, start_s, end_s) on the host's
    ``time.perf_counter`` clock, in the order they closed."""
    return [(n, s / 1e9, e / 1e9) for n, s, e in _recorded]


def clear_recorded_spans() -> None:
    _recorded.clear()


# Counters kept per call of a stage, profiler or not: (name, time_ns on the
# host's perf_counter clock, {counter: value}), the newest 2^12.
_counters: collections.deque = collections.deque(maxlen=1 << 12)


def record_counters(name: str, values: Dict[str, int]) -> None:
    """Keep one call's counts of the stage ``name`` (host values the stage
    already holds: keeping them reads nothing back from the device)."""
    _counters.append((name, time.perf_counter_ns(), dict(values)))


def recorded_counters(name: Optional[str] = None) -> List[Tuple[str, float, Dict[str, int]]]:
    """The counts kept by ``record_counters`` (of the stage ``name``, or of
    every stage), oldest first: (name, time_s on the host's
    ``time.perf_counter`` clock, {counter: value})."""
    return [(n, t / 1e9, dict(v)) for n, t, v in _counters if name in (None, n)]


def clear_recorded_counters() -> None:
    _counters.clear()


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
            with span(name):
                yield
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
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
