"""Counted device-to-host reads.

The ICP loop and the Gauss-Newton inner loop each read one boolean flag
back to the host per step to decide whether to go on, and the overlap gate
reads back how many fixed points survive it (the dilate gate also its
grid's bounding box and its band). Every such read goes through
``read_flag``, ``read_nonzero`` or ``read_array``, so a run can report how
many it made; under a recording profiler each is an ``icp.host_read`` span,
the time the host sat blocked on the device.
"""

from __future__ import annotations

import torch

from .profiling import span

_reads = 0


def read_flag(flag: torch.Tensor) -> bool:
    """bool(flag), counted (on a CUDA tensor this waits for the device)."""
    global _reads
    _reads += 1
    with span("icp.host_read"):
        return bool(flag)


def read_nonzero(mask: torch.Tensor) -> torch.Tensor:
    """The ascending indices of the True entries of a 1-D mask, counted:
    their number is read back to the host (on a CUDA tensor this waits for
    the device)."""
    global _reads
    _reads += 1
    with span("icp.host_read"):
        return torch.nonzero(mask)[:, 0]


def read_array(t: torch.Tensor):
    """A tensor's values as a numpy array, counted (on a CUDA tensor this
    waits for the device). A CUDA tensor is copied into page-locked host
    memory (PyTorch's caching host allocator), which the card writes at
    several times the rate of pageable memory: the slab join reads back
    hundreds of MB of coordinates."""
    global _reads
    _reads += 1
    with span("icp.host_read"):
        if t.device.type != "cuda":
            return t.cpu().numpy()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return host.numpy()


def host_reads() -> int:
    return _reads


def reset_host_reads() -> None:
    global _reads
    _reads = 0
