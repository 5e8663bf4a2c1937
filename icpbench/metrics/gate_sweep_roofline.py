"""Percent of its roofline the dilate gate's exact sweeps reach: the least
time of the (query, ref) pairs they swept in the profiled calls (the
program's counters; ``rooflines/gate.py``), over the device time of the
1-NN kernel's launches (csrc/knn.cu ``nn1_*``; H100 SXM peaks at 700 W)."""

from icpbench.counters import of_traced
from icpbench.rooflines.gate import gate_bounds_ms


def read(r):
    counts = of_traced(r, "icp.gate")
    ms = r.device_ms("nn1_")
    if not counts or ms <= 0:
        return None
    least, _ = gate_bounds_ms(counts)
    return 100.0 * least / ms if least > 0 else None
