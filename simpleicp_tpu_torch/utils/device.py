"""Where and in which dtype an entry point computes.

Every entry point of the port runs on the card unless its caller asks for
the CPU, and in float32 unless its caller asks for float64: the
counterpart of the JAX package's platform and x64 switches. There is no
quiet fallback to the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike, dtype: Optional[torch.dtype]
            ) -> Tuple[torch.device, torch.dtype]:
    """(``device`` or the card, ``dtype`` or float32). Raises when a card is
    asked for and none is found, and for a dtype other than float32 or
    float64."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found: simpleicp_tpu_torch runs on the card by "
            "default; pass device='cpu' to run the plain versions on the CPU"
        )
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    return dev, dtype
