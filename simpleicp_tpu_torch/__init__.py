"""simpleicp_tpu_torch: point-to-plane ICP registration in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

A port of the JAX package ``simpleicp_tpu``, which stays the reference it is
tested against. Entry points run on the card unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version instead.
Importing this package imports no JAX and builds nothing: the kernels are
compiled from ``csrc/`` at their first call on the card.
"""

from .config import IcpConfig
from .convert import config_from_dict, result_to_numpy
from .models.icp import IcpResult, icp_register

__all__ = [
    "IcpConfig",
    "IcpResult",
    "config_from_dict",
    "icp_register",
    "result_to_numpy",
]
