"""Carry a configuration, a fixed-cloud preparation and a result across the
package boundary.

ICP has no weights: its state is the configuration, the observation vectors
and, when serving, the fixed cloud's preparation. ``config_from_dict``
builds this package's ``IcpConfig`` from the JAX package's, given as
``dataclasses.asdict(...)``; ``fixed_prep_from_jax`` and
``fixed_prep_to_numpy`` carry a ``FixedPrep`` into this package and back;
``result_to_numpy`` turns an ``IcpResult`` of tensors into one of numpy
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .config import IcpConfig
from .models.icp import FixedPrep, IcpResult


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


def fixed_prep_from_jax(prep, *, device) -> FixedPrep:
    """This package's FixedPrep from the JAX package's (its five arrays as
    anything ``np.asarray`` takes, numpy arrays included), with every array
    bit for bit and in its dtype, on ``device``."""
    arrays = [torch.tensor(np.asarray(a), device=device) for a in prep[:5]]
    n_fix, correspondences, neighbors, approx_knn = prep[5:]
    return FixedPrep(*arrays, int(n_fix), int(correspondences), int(neighbors),
                     bool(approx_knn))


def fixed_prep_to_numpy(prep: FixedPrep) -> FixedPrep:
    """The same preparation with its arrays as numpy arrays on the host: the
    JAX package's ``FixedPrep(*fixed_prep_to_numpy(prep))`` takes it."""
    return prep._replace(**{f: getattr(prep, f).detach().cpu().numpy()
                            for f in prep._fields[:5]})
