"""Counted device-to-host reads of loop flags.

The ICP loop and the Gauss-Newton inner loop each read one boolean flag
back to the host per step to decide whether to go on. Every such read goes
through ``read_flag``, so a run can report how many it made.
"""

from __future__ import annotations

import torch

_reads = 0


def read_flag(flag: torch.Tensor) -> bool:
    """bool(flag), counted (on a CUDA tensor this waits for the device)."""
    global _reads
    _reads += 1
    return bool(flag)


def host_reads() -> int:
    return _reads


def reset_host_reads() -> None:
    global _reads
    _reads = 0
