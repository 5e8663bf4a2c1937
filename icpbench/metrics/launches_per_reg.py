"""Device operations (kernels, copies, fills) in the profile per pair
registered in the profiled calls."""


def read(r):
    if r.traced_pairs == 0 or r.device_ops == 0:
        return None
    return r.device_ops / r.traced_pairs
