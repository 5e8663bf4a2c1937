"""Launches of the uncertainty kernel (``csrc/solver.cu``
``uncertainty_kernel``) in the device trace of the profiled calls, over
the finishes those calls ran (the a-posteriori uncertainties of
``models/icp.py`` ``_uncertainties``, one set of ``icp.finish`` counters a
finish): 1 where every finish ran as one launch of the kernel. None where
the program keeps no such counter."""

from icpbench.counters import of_traced


def read(r):
    counts = of_traced(r, "icp.finish")
    if not counts:
        return None
    finishes = sum(c["kernel"] + c["plain"] for c in counts)
    launches = sum("uncertainty_kernel" in name for name in r.device_names)
    return launches / finishes if finishes else None
