"""Share of the profiled calls' wall span in which no kernel, copy or fill
ran on the card (torch.profiler); the profiler's host time is inside it."""


def read(r):
    if r.traced_s <= 0 or r.device_ops == 0:
        return None
    return 1.0 - r.busy_s / r.traced_s
