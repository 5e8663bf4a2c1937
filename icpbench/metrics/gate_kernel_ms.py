"""Device milliseconds per registration of the overlap gate's kernels: the
dilation (csrc/dilate.cu) and the 1-NN's sweeps (csrc/knn.cu nn1_*)."""


def read(r):
    ms = r.device_ms("dilate_kernel", "nn1_")
    if r.traced_pairs == 0 or ms <= 0:
        return None
    return ms / r.traced_pairs
