"""Carry a configuration and a result across the package boundary.

ICP has no weights: its state is the configuration and the observation
vectors. ``config_from_dict`` builds this package's ``IcpConfig`` from the
JAX package's, given as ``dataclasses.asdict(...)``; ``result_to_numpy``
turns an ``IcpResult`` of tensors into one of numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from .config import IcpConfig
from .models.icp import IcpResult


def config_from_dict(d: Mapping[str, Any]) -> IcpConfig:
    """IcpConfig with the fields of ``d``; an unknown field raises."""
    names = {f.name for f in dataclasses.fields(IcpConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown IcpConfig fields: {unknown}")
    return IcpConfig(**dict(d))


def result_to_numpy(res: IcpResult) -> IcpResult:
    """The same result with every field as a numpy array on the host."""
    return IcpResult(*(t.detach().cpu().numpy() for t in res))
