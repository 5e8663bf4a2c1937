"""Rigid-body parameter estimation: Gauss-Newton solvers.

* ``gn_solve`` — a self-certifying Gauss-Newton inner loop over the six
  absolute parameters with the exact Euler rotation: masked J^T W J / J^T W r
  6x6 normal equations, weighted parameter observations, inf-weight (frozen)
  parameter elimination, and an exit once the relative step falls below
  64*eps(float64).
* ``linearized_solve`` — one small-angle increment solve per iteration.
* ``estimate_uncertainties`` — a-posteriori sigmas and covariance.
* ``Parameter`` / ``RigidBodyParameters`` — the host-side (numpy) parameter
  containers of the class API.

All solver math runs in float64 whatever the coordinate dtype (the H100 has
native float64). The Jacobian of the point-to-plane residual is analytic:
the derivative of the Euler rotation matrix, written out below, in place of
forward-mode autodiff. Rejected correspondences take part with weight zero,
so every shape is static. The solvers take leading dimensions, one problem
per leading index: the batch registers its pairs in one call of each.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..ops.transform import (
    apply_H,
    euler_angles_to_linearized_rotation_matrix,
    euler_angles_to_rotation_matrix,
    make_H,
    matrix_from_rows,
)
from ..utils.sync import read_flag

F64 = torch.float64


def _rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) [R | t]."""
    return torch.cat([R, t[..., None]], dim=-1)


def point_to_plane_residuals(p: torch.Tensor, xm: torch.Tensor, xf: torch.Tensor,
                             n: torch.Tensor) -> torch.Tensor:
    """Signed point-to-plane distances d_i = (R(p) xm_i + t - xf_i) . n_i."""
    R = euler_angles_to_rotation_matrix(p[..., 0], p[..., 1], p[..., 2])
    xt = apply_H(xm, _rigid(R, p[..., 3:6]))
    return ((xt - xf) * n).sum(dim=-1)


def _rotation_derivatives(p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3, 3): d R / d alpha_k for k = 1, 2, 3."""
    c1, s1 = torch.cos(p[..., 0]), torch.sin(p[..., 0])
    c2, s2 = torch.cos(p[..., 1]), torch.sin(p[..., 1])
    c3, s3 = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    z = torch.zeros_like(c1)
    dR1 = matrix_from_rows([
        [z, z, z],
        [-s1 * s3 + c1 * s2 * c3, -s1 * c3 - c1 * s2 * s3, -c1 * c2],
        [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2],
    ])
    dR2 = matrix_from_rows([
        [-s2 * c3, s2 * s3, c2],
        [s1 * c2 * c3, -s1 * c2 * s3, s1 * s2],
        [-c1 * c2 * c3, c1 * c2 * s3, -c1 * s2],
    ])
    dR3 = matrix_from_rows([
        [-c2 * s3, -c2 * c3, z],
        [c1 * c3 - s1 * s2 * s3, -c1 * s3 - s1 * s2 * c3, z],
        [s1 * c3 + c1 * s2 * s3, -s1 * s3 + c1 * s2 * c3, z],
    ])
    return torch.stack([dR1, dR2, dR3], dim=-3)


def residual_jacobian(p: torch.Tensor, xm: torch.Tensor,
                      n: torch.Tensor) -> torch.Tensor:
    """(..., C, 6) analytic Jacobian of ``point_to_plane_residuals`` in p:
    column k < 3 is n . (dR/dalpha_k xm), columns 3..5 are n."""
    dR = _rotation_derivatives(p)[..., :, None, :, :]  # (..., 3, 1, 3, 3) [k, -, i, j]
    xm = xm[..., None, :, None, :]                     # (..., 1, C, 1, 3) [-, c, -, j]
    # rot[..., k, c, i] = sum_j dR[..., k, i, j] xm[..., c, j], in index order
    rot = (dR[..., 0] * xm[..., 0] + dR[..., 1] * xm[..., 1]) + dR[..., 2] * xm[..., 2]
    cols = (rot * n[..., None, :, :]).sum(dim=-1)  # (..., 3, C)
    return torch.cat([cols.mT, n], dim=-1)


def _masked_normal_equations(J, r, row_w2):
    """N = J^T diag(w2) J (..., 6, 6), b = J^T diag(w2) r (..., 6): batched
    float64 products (TF32 applies to float32 only)."""
    Jw = J * row_w2[..., None]
    N = J.mT @ Jw
    b = (Jw.mT @ r[..., None])[..., 0]
    return N, b


def _cholesky6(A: torch.Tensor):
    """Unrolled Cholesky factor of 6x6 SPD matrices A (..., 6, 6): a list of
    lists of (...) tensors."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    return L


def _cholesky6_solve(L, y: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = y for y of shape (..., 6, m), unrolled."""
    n = 6
    L = [[None if v is None else v[..., None] for v in row] for row in L]
    z = [None] * n
    for i in range(n):
        s = y[..., i, :]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = z[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-2)


def solve_spd6(N: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the 6x6 SPD systems N x = b (N (..., 6, 6), b (..., 6)) in
    float64 by an unrolled Cholesky factorization. Returns x in N's dtype."""
    dtype = N.dtype
    x = _cholesky6_solve(_cholesky6(N.to(F64)), b.to(F64)[..., None])
    return x[..., 0].to(dtype)


def inv_spd6(N: torch.Tensor) -> torch.Tensor:
    """Inverse of 6x6 SPD matrices: one unrolled Cholesky factorization and
    six column solves in float64 (each column's arithmetic is that of
    ``solve_spd6`` on a unit vector)."""
    L = _cholesky6(N.to(F64))
    eye = torch.eye(6, dtype=F64, device=N.device).expand(N.shape)
    return _cholesky6_solve(L, eye).to(N.dtype)


def _restrict_to_varying(N, b, vary_f):
    """Eliminate frozen parameters: zero their rows/cols, unit diagonal,
    zero rhs — their Gauss-Newton update is exactly zero."""
    N = N * vary_f[..., :, None] * vary_f[..., None, :] + torch.diag_embed(1.0 - vary_f)
    b = b * vary_f
    return N, b


def _damp(N: torch.Tensor) -> torch.Tensor:
    """Diagonal-relative damping: N + diag(N) * 1e-9 + 1e-30. Degenerate
    geometry (a perfect plane leaves in-plane motion unobservable) makes N
    rank-deficient; relative to each diagonal entry, so rotation and
    translation columns, which differ by |coords|^2, are each damped in
    their own scale."""
    return N + torch.diag_embed(torch.diagonal(N, dim1=-2, dim2=-1) * 1e-9 + 1e-30)


def gn_solve(p0: torch.Tensor, xm: torch.Tensor, xf: torch.Tensor, n: torch.Tensor,
             mask: torch.Tensor, distance_weight: torch.Tensor,
             obs_vals: torch.Tensor, obs_w: torch.Tensor, *, n_steps: int = 24,
             active: Optional[torch.Tensor] = None):
    """Gauss-Newton estimate of the six absolute rigid-body parameters.

    Args:
        p0: (..., 6) warm-start parameters (previous ICP iteration's
            estimate); every argument may carry the same leading dimensions,
            one problem per leading index.
        xm: (..., C, 3) movable points of the correspondences, untransformed.
        xf, n: (..., C, 3) fixed points and unit normals of the
            correspondences.
        mask: (..., C) validity after outlier rejection (zero weight if
            False).
        distance_weight: (...) weight of the distance residuals.
        obs_vals: (..., 6) observed parameter values (radians for the
            angles).
        obs_w: (..., 6) observation weights; 0 = unobserved, finite > 0 =
            weighted observation row, +inf = frozen at the observed value.
        n_steps: most inner steps. A problem stops once its relative step
            ||delta|| / (1 + ||p||) is at or below 64*eps(float64); one flag
            is read back to the host per step to decide whether any goes on.
        active: with leading dimensions, (...) bool: the problems that step
            at all (None: every one). A problem that has stopped keeps its
            p and its last relative step, as under the JAX package's
            vmapped while_loop; without it the loop simply ends when its one
            problem stops.

    Returns:
        (p, residuals, gn_rel_step) in xm's dtype: (..., 6) estimates,
        (..., C) unweighted signed point-to-plane distances at the optimum,
        and the last step's relative magnitude (...).
    """
    dtype = xm.dtype
    xm64, xf64, n64 = xm.to(F64), xf.to(F64), n.to(F64)
    obs_vals64 = obs_vals.to(F64)
    obs_w64 = obs_w.to(F64)
    vary = torch.isfinite(obs_w64)
    vary_f = vary.to(F64)
    is_obs = (obs_w64 > 0) & vary
    obs_w2 = torch.where(is_obs, obs_w64, torch.zeros_like(obs_w64)) ** 2
    p = torch.where(vary, p0.to(F64), obs_vals64)
    dw2 = (distance_weight * distance_weight).to(F64)
    w2 = torch.where(mask, dw2[..., None], torch.zeros((), dtype=F64, device=xm.device))

    def gn_step(p):
        r = point_to_plane_residuals(p, xm64, xf64, n64)
        J = residual_jacobian(p, xm64, n64)
        N, b = _masked_normal_equations(J, r, w2)
        N = N + torch.diag_embed(obs_w2)
        b = b + obs_w2 * (p - obs_vals64)
        N, b = _restrict_to_varying(N, b, vary_f)
        return solve_spd6(_damp(N), b)

    tol = 64.0 * torch.finfo(F64).eps
    rel = torch.full(p.shape[:-1], float("inf"), dtype=F64, device=xm.device)
    go = active
    for it in range(n_steps):
        delta = gn_step(p)
        p_new = p - delta
        rel_new = (torch.linalg.vector_norm(delta, dim=-1)
                   / (1.0 + torch.linalg.vector_norm(p_new, dim=-1)))
        if go is None:
            p, rel = p_new, rel_new
            more = rel > tol
        else:
            p = torch.where(go[..., None], p_new, p)
            rel = torch.where(go, rel_new, rel)
            go = go & (rel > tol)
            more = go.any()
        if it + 1 < n_steps and not read_flag(more):
            break
    residuals = point_to_plane_residuals(p, xm64, xf64, n64)
    return p.to(dtype), residuals.to(dtype), rel.to(dtype)


def linearized_solve(xm_t: torch.Tensor, xf: torch.Tensor, n: torch.Tensor,
                     mask: torch.Tensor):
    """Single small-angle increment solve on already-transformed points
    (..., C, 3), one problem per leading index.

    Rows: A_i = [-z ny + y nz, z nx - x nz, -y nx + x ny, nx, ny, nz],
    l_i = n_i . (xf_i - xm_t_i).

    Returns:
        (dH, residuals, sol): the (..., 4, 4) increment (composed as
        dH @ H), the post-solve linear residuals A x - l, and the (..., 6)
        solution.
    """
    dtype = xm_t.dtype
    xm64, xf64, n64 = xm_t.to(F64), xf.to(F64), n.to(F64)
    x, y, z = xm64[..., 0], xm64[..., 1], xm64[..., 2]
    nx, ny, nz = n64[..., 0], n64[..., 1], n64[..., 2]
    A = torch.stack(
        [-z * ny + y * nz, z * nx - x * nz, -y * nx + x * ny, nx, ny, nz], dim=-1
    )
    l = (n64 * (xf64 - xm64)).sum(dim=-1)
    w = mask.to(F64)
    N, b = _masked_normal_equations(A, l, w)
    sol = solve_spd6(_damp(N), b)
    residuals = ((A @ sol[..., None])[..., 0] - l).to(dtype)
    sol = sol.to(dtype)
    dR = euler_angles_to_linearized_rotation_matrix(sol[..., 0], sol[..., 1],
                                                    sol[..., 2])
    dH = make_H(dR, sol[..., 3:6])
    return dH, residuals, sol


def estimate_uncertainties(p: torch.Tensor, xm: torch.Tensor, xf: torch.Tensor,
                           n: torch.Tensor, mask: torch.Tensor,
                           distance_weight: torch.Tensor, obs_vals: torch.Tensor,
                           obs_w: torch.Tensor):
    """A-posteriori standard deviations of the varying parameters, with the
    weight multipliers (not their squares) as the weight matrix P:

        N   = A^T P A over varying columns, P = diag([w_d ..., obs_w ...])
        vPv = sum(P r_unweighted^2)
        s0  = sqrt(vPv / (num_obs - num_prm)),  Cxx = s0^2 N^-1

    Shapes as in ``gn_solve``. Returns (sigma, Cxx): (..., 6) uncertainties
    with NaN at frozen parameters, and the (..., 6, 6) covariance with
    frozen rows/columns zeroed.
    """
    dtype = xm.dtype
    xm64, xf64, n64 = xm.to(F64), xf.to(F64), n.to(F64)
    p64 = p.to(F64)
    obs_vals64 = obs_vals.to(F64)
    obs_w64 = obs_w.to(F64)
    vary = torch.isfinite(obs_w64)
    vary_f = vary.to(F64)
    is_obs = (obs_w64 > 0) & vary
    zero = torch.zeros((), dtype=F64, device=xm.device)

    r = point_to_plane_residuals(p64, xm64, xf64, n64)
    J = residual_jacobian(p64, xm64, n64)
    w_rows = torch.where(mask, distance_weight.to(F64)[..., None], zero)
    N = J.mT @ (J * w_rows[..., None])
    N = N + torch.diag_embed(torch.where(is_obs, obs_w64, zero))
    N = N * vary_f[..., :, None] * vary_f[..., None, :] + torch.diag_embed(1.0 - vary_f)
    Qxx = inv_spd6(_damp(N))

    vPv = (w_rows * r * r).sum(dim=-1) + torch.where(
        is_obs, obs_w64 * (p64 - obs_vals64) ** 2, zero
    ).sum(dim=-1)
    num_obs = mask.sum(dim=-1) + is_obs.sum(dim=-1)
    num_prm = vary.sum(dim=-1)
    s0_sq = (vPv / torch.clamp(num_obs - num_prm, min=1))[..., None]
    sigma = torch.sqrt(s0_sq * torch.diagonal(Qxx, dim1=-2, dim2=-1)).to(dtype)
    Cxx = (s0_sq[..., None] * Qxx * vary_f[..., :, None] * vary_f[..., None, :]).to(dtype)
    nan = torch.full_like(sigma, float("nan"))
    return torch.where(vary, sigma, nan), Cxx


# ---------------------------------------------------------------------------
# Host-side parameter containers (the reference simpleICP Python's
# dataclasses, with the same fields and scaling).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Parameter:
    """A single rigid-body transformation parameter."""

    initial_value: float = np.nan
    observed_value: float = np.nan
    observation_weight: float = np.nan
    estimated_value: float = np.nan
    estimated_uncertainty: float = np.nan
    scale_for_logging: float = 1.0

    @property
    def initial_value_scaled(self):
        return self.initial_value * self.scale_for_logging

    @property
    def observed_value_scaled(self):
        return self.observed_value * self.scale_for_logging

    @property
    def estimated_value_scaled(self):
        return self.estimated_value * self.scale_for_logging

    @property
    def estimated_uncertainty_scaled(self):
        return self.estimated_uncertainty * self.scale_for_logging


def _angle_param():
    return Parameter(scale_for_logging=180.0 / np.pi)


@dataclasses.dataclass
class RigidBodyParameters:
    """The six rigid-body transformation parameters (angles stored in
    radians; logged in degrees via scale_for_logging)."""

    alpha1: Parameter = dataclasses.field(default_factory=_angle_param)
    alpha2: Parameter = dataclasses.field(default_factory=_angle_param)
    alpha3: Parameter = dataclasses.field(default_factory=_angle_param)
    tx: Parameter = dataclasses.field(default_factory=Parameter)
    ty: Parameter = dataclasses.field(default_factory=Parameter)
    tz: Parameter = dataclasses.field(default_factory=Parameter)

    @property
    def H(self) -> np.ndarray:
        """4x4 homogeneous transform built from the estimated values
        (host-side float64, whatever the run's dtype)."""
        a1, a2, a3, tx, ty, tz = self.get_parameter_attributes_as_list(
            "estimated_value"
        )
        H = np.eye(4)
        H[:3, :3] = host_rotation(a1, a2, a3)
        H[:3, 3] = [tx, ty, tz]
        return H

    def _params(self):
        return (self.alpha1, self.alpha2, self.alpha3, self.tx, self.ty, self.tz)

    def set_parameter_attributes_from_list(self, attribute_name: str, array) -> None:
        for param, value in zip(self._params(), array):
            setattr(param, attribute_name, float(value))

    def get_parameter_attributes_as_list(self, attribute_name: str) -> List[float]:
        return [getattr(param, attribute_name) for param in self._params()]


def host_rotation(a1, a2, a3) -> np.ndarray:
    """The x->y->z Euler rotation on the host in float64 (complex angles
    work too, for complex-step derivatives)."""
    c1, s1 = np.cos(a1), np.sin(a1)
    c2, s2 = np.cos(a2), np.sin(a2)
    c3, s3 = np.cos(a3), np.sin(a3)
    return np.array([
        [c2 * c3, -c2 * s3, s2],
        [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2],
        [s1 * s3 - c1 * s2 * c3, s1 * c3 + c1 * s2 * s3, c1 * c2],
    ])
