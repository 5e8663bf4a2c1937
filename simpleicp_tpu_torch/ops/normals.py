"""Normal estimation: covariance of k-NN neighbourhoods and a closed-form
symmetric 3x3 eigensolver.

Convention: normal = eigenvector of the smallest eigenvalue, planarity =
(lambda_mid - lambda_min) / lambda_max, unbiased (n-1) covariance. The
eigenvector's sign comes from the row cross product chosen below, exactly as
in the JAX package: the sign changes the rejection band and every
per-iteration statistic, so it is part of the contract.
"""

from __future__ import annotations

import math

import torch


def eigh3x3(C: torch.Tensor):
    """Eigenvalues (descending) and the smallest-eigenvalue eigenvector of
    symmetric 3x3 matrices.

    Args:
        C: (..., 3, 3) symmetric matrices.

    Returns:
        (eigvals, v_min): (..., 3) eigenvalues sorted descending and (..., 3)
        unit eigenvector of the smallest eigenvalue.
    """
    eps = 1e-30 if C.dtype == torch.float64 else 1e-18

    a00 = C[..., 0, 0]
    a11 = C[..., 1, 1]
    a22 = C[..., 2, 2]
    a01 = C[..., 0, 1]
    a02 = C[..., 0, 2]
    a12 = C[..., 1, 2]

    # Trigonometric eigenvalue formula for symmetric 3x3 (Smith, 1961).
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    p_safe = torch.clamp(p, min=eps)

    # r = det(B) / 2 with B = (C - qI) / p
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) / (p_safe * p_safe * p_safe)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)

    phi = torch.arccos(r) / 3.0
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    eigvals = torch.stack([lam_max, lam_mid, lam_min], dim=-1)

    # Null space of A = C - lam_min I via the largest cross product of rows.
    d0, d1, d2 = a00 - lam_min, a11 - lam_min, a22 - lam_min
    r0 = torch.stack([d0, a01, a02], dim=-1)
    r1 = torch.stack([a01, d1, a12], dim=-1)
    r2 = torch.stack([a02, a12, d2], dim=-1)
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    crosses = torch.stack([c01, c02, c12], dim=-2)  # (..., 3, 3)
    norms2 = (crosses * crosses).sum(dim=-1)  # (..., 3)
    # argmax with ties to the first, written out so that no backend's
    # argmax tie rule can change the normal's sign
    best = torch.where(
        norms2[..., 1] > norms2[..., 0],
        torch.where(norms2[..., 2] > norms2[..., 1], 2, 1),
        torch.where(norms2[..., 2] > norms2[..., 0], 2, 0),
    )
    v = torch.take_along_dim(crosses, best[..., None, None], dim=-2)[..., 0, :]
    vnorm = torch.sqrt(torch.clamp((v * v).sum(dim=-1, keepdim=True), min=eps))
    v_min = v / vnorm

    # Fully degenerate (isotropic) neighbourhood: any direction works.
    degenerate = norms2.amax(dim=-1) < eps
    fallback = torch.zeros_like(v_min)
    fallback[..., 2] = 1.0
    v_min = torch.where(degenerate[..., None], fallback, v_min)
    return eigvals, v_min


def estimate_normals_from_neighborhoods(neigh: torch.Tensor):
    """Normals and planarity from gathered k-NN neighbourhoods.

    Args:
        neigh: (n, k, 3) coordinates of the k nearest neighbours of each of
            the n selected points (the point itself included).

    Returns:
        (normals, planarity, eigvals): (n, 3) unit normals, (n,) planarity in
        [0, 1], (n, 3) eigenvalues sorted descending.
    """
    k = neigh.shape[1]
    mean = neigh.mean(dim=1, keepdim=True)
    centered = neigh - mean
    # Unbiased covariance as sums of elementwise products (no matrix
    # product, so no TF32).
    C = (centered[:, :, :, None] * centered[:, :, None, :]).sum(dim=1) / (k - 1)
    eigvals, v_min = eigh3x3(C)
    lam_max = eigvals[..., 0]
    safe = torch.where(lam_max > 0, lam_max, torch.ones_like(lam_max))
    planarity = torch.where(
        lam_max > 0, (eigvals[..., 1] - eigvals[..., 2]) / safe,
        torch.zeros_like(lam_max),
    )
    return v_min, planarity, eigvals
