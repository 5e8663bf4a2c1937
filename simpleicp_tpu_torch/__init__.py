"""simpleicp_tpu_torch: point-to-plane ICP registration in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

A port of the JAX package ``simpleicp_tpu``, which stays the reference it is
tested against. Entry points run on the card unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version instead.
Importing this package imports no JAX and builds nothing: the kernels are
compiled from ``csrc/`` at their first call on the card.
"""

__version__ = "0.1.0"

import logging

# Never emit logs unless the application opts in.
logging.getLogger(__name__).addHandler(logging.NullHandler())

from .config import IcpConfig  # noqa: E402
from .convert import (  # noqa: E402
    config_from_dict,
    fixed_prep_from_jax,
    fixed_prep_to_numpy,
    result_to_numpy,
)
from .corrpts import CorrPts, CorrPtsException  # noqa: E402
from .models.icp import (  # noqa: E402
    ERR_NO_OVERLAP,
    ERR_OK,
    ERR_TOO_FEW_CORRESPONDENCES,
    FixedPrep,
    IcpResult,
    icp_register,
    icp_register_batch,
    load_fixed_prep,
    prepare_fixed,
)
from .models.solver import Parameter, RigidBodyParameters  # noqa: E402
from .api import PointCloud, PointCloudException, SimpleICP, SimpleICPException  # noqa: E402

__all__ = [
    "CorrPts",
    "CorrPtsException",
    "ERR_NO_OVERLAP",
    "ERR_OK",
    "ERR_TOO_FEW_CORRESPONDENCES",
    "FixedPrep",
    "IcpConfig",
    "IcpResult",
    "Parameter",
    "PointCloud",
    "PointCloudException",
    "RigidBodyParameters",
    "SimpleICP",
    "SimpleICPException",
    "__version__",
    "config_from_dict",
    "fixed_prep_from_jax",
    "fixed_prep_to_numpy",
    "icp_register",
    "icp_register_batch",
    "load_fixed_prep",
    "prepare_fixed",
    "result_to_numpy",
]
