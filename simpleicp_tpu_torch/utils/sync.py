"""Counted device-to-host reads.

The ICP loop and the Gauss-Newton inner loop each read one boolean flag
back to the host per step to decide whether to go on, and the overlap gate
reads back how many fixed points survive it. Every such read goes through
``read_flag`` or ``read_nonzero``, so a run can report how many it made.
"""

from __future__ import annotations

import torch

_reads = 0


def read_flag(flag: torch.Tensor) -> bool:
    """bool(flag), counted (on a CUDA tensor this waits for the device)."""
    global _reads
    _reads += 1
    return bool(flag)


def read_nonzero(mask: torch.Tensor) -> torch.Tensor:
    """The ascending indices of the True entries of a 1-D mask, counted:
    their number is read back to the host (on a CUDA tensor this waits for
    the device)."""
    global _reads
    _reads += 1
    return torch.nonzero(mask)[:, 0]


def host_reads() -> int:
    return _reads


def reset_host_reads() -> None:
    global _reads
    _reads = 0
