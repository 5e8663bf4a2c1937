"""The ICP driver and its solvers."""

from .solver import Parameter, RigidBodyParameters
from .icp import (FixedPrep, IcpResult, icp_register, load_fixed_prep,
                  prepare_fixed)

__all__ = ["FixedPrep", "Parameter", "RigidBodyParameters", "IcpResult",
           "icp_register", "load_fixed_prep", "prepare_fixed"]
