"""The program's counters (``simpleicp_tpu_torch/utils/profiling.py``
``record_counters``): what the per-layer metrics that count a stage's work
read, such as the dilate gate's band, kept refs, sweeps and plan.

The program keeps one set of counts a call of the stage, with the time it
kept them on the host's clock. The traced run's calls are those of its
profiled ``icp.register`` spans (``spans.of_traced_calls``), so their
counts are the ones kept between the first of those spans' start and the
last one's end. A program without counters, or without spans, reads None.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .spans import of_traced_calls, outermost


def of_traced(r, name: str) -> Optional[List[Dict[str, int]]]:
    """The counts of the stage ``name`` kept in the traced run's profiled
    calls (``r`` a ``Readings``), oldest first, or None where the program
    keeps no counters or no spans."""
    from simpleicp_tpu_torch.utils import profiling

    read = getattr(profiling, "recorded_counters", None)
    spans = of_traced_calls(r)
    if read is None or not spans:
        return None
    regs = outermost(spans, "icp.register")
    lo, hi = regs[0][1], regs[-1][2]
    return [v for n, t, v in read(name) if n == name and lo <= t <= hi]
