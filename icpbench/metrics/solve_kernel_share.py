"""Share of the profiled calls' wall span in which the card ran the
Gauss-Newton solve kernel (``csrc/solver.cu`` ``gn_solve_kernel``; its
device time in the trace): the solver's share of a registration, whether
an iteration ran eagerly or as a replay of its CUDA graph. None where no
such kernel ran."""


def read(r):
    ms = r.device_ms("gn_solve_kernel")
    if r.traced_s <= 0 or ms <= 0:
        return None
    return ms / 1e3 / r.traced_s
