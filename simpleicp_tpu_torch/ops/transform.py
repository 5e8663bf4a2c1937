"""Rigid-body math: Euler-angle rotations, homogeneous transforms.

The Euler convention is x->y->z composition: with c_i = cos(alpha_i),
s_i = sin(alpha_i),

    R = [[ c2 c3,            -c2 s3,             s2    ],
         [ c1 s3 + s1 s2 c3,  c1 c3 - s1 s2 s3, -s1 c2 ],
         [ s1 s3 - c1 s2 c3,  s1 c3 + c1 s2 s3,  c1 c2 ]]

Every function takes leading batch dimensions: angles of shape (...),
parameters (..., 6), transforms (..., 4, 4) and points (..., n, 3), one
transform per leading index. Every product here is an explicit multiply-add,
never a matrix product, so TF32 can never touch a coordinate whatever
PyTorch's matmul settings are.
"""

from __future__ import annotations

import torch


def euler_coord_to_homogeneous_coord(X: torch.Tensor) -> torch.Tensor:
    """(..., n, 3) -> (..., n, 4) homogeneous coordinates."""
    ones = torch.ones((*X.shape[:-1], 1), dtype=X.dtype, device=X.device)
    return torch.cat([X, ones], dim=-1)


def homogeneous_coord_to_euler_coord(Xh: torch.Tensor) -> torch.Tensor:
    """(..., n, 4) -> (..., n, 3) Euclidean coordinates, dividing by w."""
    return Xh[..., :3] / Xh[..., 3:4]


def matrix_from_rows(rows) -> torch.Tensor:
    """A (..., 3, 3) matrix from three rows of three (...) entries."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_angles_to_rotation_matrix(alpha1, alpha2, alpha3) -> torch.Tensor:
    """Exact rotation matrix from the three Euler angles (radians)."""
    c1, s1 = torch.cos(alpha1), torch.sin(alpha1)
    c2, s2 = torch.cos(alpha2), torch.sin(alpha2)
    c3, s3 = torch.cos(alpha3), torch.sin(alpha3)
    return matrix_from_rows([
        [c2 * c3, -c2 * s3, s2],
        [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2],
        [s1 * s3 - c1 * s2 * c3, s1 * c3 + c1 * s2 * s3, c1 * c2],
    ])


def euler_angles_to_linearized_rotation_matrix(alpha1, alpha2, alpha3) -> torch.Tensor:
    """Small-angle linearization R ~= I + skew(alpha)."""
    one = torch.ones_like(alpha1)
    return matrix_from_rows([
        [one, -alpha3, alpha2],
        [alpha3, one, -alpha1],
        [-alpha2, alpha1, one],
    ])


def rotation_matrix_to_euler_angles(R: torch.Tensor):
    """Recover (alpha1, alpha2, alpha3) from a rotation matrix."""
    alpha1 = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    alpha2 = torch.asin(R[..., 0, 2])
    alpha3 = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return alpha1, alpha2, alpha3


def make_H(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Homogeneous 4x4 transform [R t; 0 1]."""
    # One fresh identity per transform (expanding the one identity of an
    # unbatched or single transform copies nothing).
    H = torch.eye(4, dtype=R.dtype, device=R.device).expand(
        *R.shape[:-2], 4, 4).contiguous()
    H[..., :3, :3] = R
    H[..., :3, 3] = t
    return H


def rbp_to_H(p: torch.Tensor) -> torch.Tensor:
    """4x4 transform from the 6-vector (alpha1, alpha2, alpha3, tx, ty, tz)."""
    R = euler_angles_to_rotation_matrix(p[..., 0], p[..., 1], p[..., 2])
    return make_H(R, p[..., 3:6])


def invert_H(H: torch.Tensor) -> torch.Tensor:
    """Exact inverse of a rigid transform: [R^T, -R^T t; 0 1]."""
    Rt = H[..., :3, :3].mT
    t = H[..., :3, 3]
    mt = -(((Rt[..., :, 0] * t[..., 0:1]) + Rt[..., :, 1] * t[..., 1:2])
           + Rt[..., :, 2] * t[..., 2:3])
    return make_H(Rt.contiguous(), mt)


def compose_H(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for 4x4 transforms as explicit multiply-adds in index order."""
    acc = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, 4):
        acc = acc + A[..., :, k:k + 1] * B[..., k:k + 1, :]
    return acc


def apply_H(X: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform to points of shape (..., n, 3): X R^T + t,
    with H of shape (..., 4, 4) or (..., 3, 4).

    Each output coordinate is ``((h0*x + h1*y) + h2*z) + h3`` in separate,
    unfused operations: the order the fused match kernel uses
    (csrc/knn.cu), and bit-equal on the CPU to the JAX package's
    ``X @ R.T + t``.
    """
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    h = H[..., None]  # each entry (..., 1), against the (..., n) coordinates
    cols = [((h[..., i, 0, :] * x + h[..., i, 1, :] * y) + h[..., i, 2, :] * z)
            + h[..., i, 3, :] for i in range(3)]
    return torch.stack(cols, dim=-1)
