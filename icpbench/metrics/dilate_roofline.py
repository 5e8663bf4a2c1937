"""Percent of its roofline the dilation kernel (csrc/dilate.cu
``dilate_kernel``) reaches: the least time of the dilations the profiled
calls' plans ask for (the program's counters; ``rooflines/gate.py``), over
the kernel's device time (H100 SXM at 700 W)."""

from icpbench.counters import of_traced
from icpbench.rooflines.gate import gate_bounds_ms


def read(r):
    counts = of_traced(r, "icp.gate")
    ms = r.device_ms("dilate_kernel")
    if not counts or ms <= 0:
        return None
    _, least = gate_bounds_ms(counts)
    return 100.0 * least / ms if least > 0 else None
