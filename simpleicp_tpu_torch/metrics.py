"""Registration-quality metrics, independent of any implementation's own
residual statistics. The nearest-neighbour distances run the 1-NN kernel's
d2-only mode on the card (``device``, ``dtype``: the card and float32 by
default)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .utils.device import DeviceLike, resolve


def _nn_d2(X_from, X_to, device, dtype) -> np.ndarray:
    from .ops.knn import min_dist_sq

    dev, dtype = resolve(device, dtype)
    d2 = min_dist_sq(
        torch.as_tensor(np.ascontiguousarray(X_from), dtype=dtype, device=dev),
        torch.as_tensor(np.ascontiguousarray(X_to), dtype=dtype, device=dev),
    )
    return d2.cpu().numpy()


def nn_rmse(X_from, X_to, *, step: int = 1, device: DeviceLike = None,
            dtype: Optional[torch.dtype] = None) -> float:
    """Root-mean-square nearest-neighbour distance from X_from (optionally
    subsampled by `step`) to X_to: how well the clouds overlap after a
    registration."""
    d2 = _nn_d2(np.asarray(X_from)[::step], np.asarray(X_to), device, dtype)
    return float(np.sqrt(np.mean(d2)))


def chamfer_distance(X_a, X_b, *, step: int = 1, device: DeviceLike = None,
                     dtype: Optional[torch.dtype] = None) -> float:
    """Symmetric mean squared nearest-neighbour distance (Chamfer-L2)."""
    Xa = np.asarray(X_a)[::step]
    Xb = np.asarray(X_b)[::step]
    return float(np.mean(_nn_d2(Xa, Xb, device, dtype))
                 + np.mean(_nn_d2(Xb, Xa, device, dtype)))


def rotation_angle_deg(R_a, R_b) -> float:
    """Geodesic angle (degrees) between two rotation matrices."""
    R_a = np.asarray(R_a)[:3, :3]
    R_b = np.asarray(R_b)[:3, :3]
    cos = (np.trace(R_a.T @ R_b) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
