"""The program's spans (``simpleicp_tpu_torch/utils/profiling.py``): what the
per-layer metrics of source ``program_span`` read.

While the profiler records, the program keeps its spans on the host's clock
(``profiling.recorded_spans``). A traced run profiles a few calls after its
window and nothing else, so the spans of those calls are the last
``icp.register`` spans the program kept, one a call, and the spans within
them. A program without spans reads None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .trace import _union

Span = Tuple[str, float, float]


def wall_s(spans: List[Span], name: str) -> float:
    """Seconds covered by the spans named ``name`` (nested ones once)."""
    u = _union(np.array([[s, e] for n, s, e in spans if n == name],
                        dtype=np.float64).reshape(-1, 2))
    return float((u[:, 1] - u[:, 0]).sum()) if len(u) else 0.0


def outermost(spans: List[Span], name: str) -> List[Span]:
    """The spans named ``name`` that no other of that name holds, by start
    (a warm start's coarse pass nests an ``icp.register``)."""
    out: List[Span] = []
    for sp in sorted((x for x in spans if x[0] == name), key=lambda x: (x[1], -x[2])):
        if not out or sp[1] >= out[-1][2]:
            out.append(sp)
    return out


def of_traced_calls(r) -> Optional[List[Span]]:
    """The program's spans of the traced run's profiled calls (``r`` a
    ``Readings``), or None where the program kept none."""
    from simpleicp_tpu_torch.utils import profiling

    read = getattr(profiling, "recorded_spans", None)
    calls = r.traced_pairs // max(r.pairs_per_call, 1)
    if read is None or calls == 0:
        return None
    spans = read()
    regs = outermost(spans, "icp.register")
    if len(regs) < calls:
        return None
    lo, hi = regs[-calls][1], regs[-1][2]
    return [x for x in spans if x[1] >= lo and x[2] <= hi]
