"""Plain reference of one registration: point-to-plane ICP as pglira/simpleICP
defines it, written in plain PyTorch from the inputs alone.

It shares no code with the program and takes nothing the program made.
It follows the numeric contract the configuration states: coordinates in
float32 with distances from exact per-coordinate differences
(``((dx*dx) + dy*dy) + dz*dz``, ties to the lower index), the parameters
carried in float32 between iterations, and each iteration's least-squares
adjustment solved in float64. Steps:

1. overlap gate (a finite ``max_overlap_distance``): a fixed point
   survives when its nearest movable point, under the initial transform,
   lies within the radius (radius cast to float32, then squared); found
   exactly through a grid of (x, y) columns one radius wide;
2. selection: ``round(linspace(0, n - 1, C))`` among the survivors
   (numpy's rounding), every point when there are at most C;
3. normals: the k nearest fixed points of each selected point, their
   unbiased covariance, the eigenvector of its smallest eigenvalue (the
   closed trigonometric form) from the largest cross product of two rows
   of ``C - lambda_min I`` (ties to the first), which fixes its sign;
   planarity ``(l_mid - l_min) / l_max``;
4. loop: match each selected point to its nearest moved movable point,
   signed point-to-plane distances, reject below ``min_planarity`` and
   beyond three robust sigmas (1.4826 MAD) of the median, solve the six
   parameters by Gauss-Newton on the untransformed matches, stop when the
   residual mean and std change by less than ``min_change`` percent (or
   by no more than 32 float32 epsilons of the largest coordinate).

``tf32=True`` is the control: the same registration with the inputs of
every product of coordinates that a plain implementation writes as a
matrix product (the rigid transform of a cloud, the neighbourhood
covariance) rounded to TF32's ten mantissa bits, as a float32 matrix
product with TF32 allowed computes them on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

F32, F64 = torch.float32, torch.float64
ERR_OK, ERR_NO_OVERLAP, ERR_TOO_FEW = 0, 1, 2


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(F32)


def _maybe_tf32(x: torch.Tensor, on: bool) -> torch.Tensor:
    return tf32(x) if on else x


def rotation(p: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation of the angles p[:3] in p's dtype, x -> y -> z order."""
    c1, s1 = torch.cos(p[0]), torch.sin(p[0])
    c2, s2 = torch.cos(p[1]), torch.sin(p[1])
    c3, s3 = torch.cos(p[2]), torch.sin(p[2])
    rows = [
        [c2 * c3, -c2 * s3, s2],
        [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2],
        [s1 * s3 - c1 * s2 * c3, s1 * c3 + c1 * s2 * s3, c1 * c2],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def transform_of(p: torch.Tensor) -> torch.Tensor:
    """(4, 4) homogeneous transform of the six parameters p."""
    H = torch.eye(4, dtype=p.dtype, device=p.device)
    H[:3, :3] = rotation(p)
    H[:3, 3] = p[3:6]
    return H


def moved(X: torch.Tensor, H: torch.Tensor, tf: bool = False) -> torch.Tensor:
    """X R^T + t, each coordinate summed in index order."""
    X, H = _maybe_tf32(X, tf), _maybe_tf32(H, tf)
    cols = [((H[i, 0] * X[:, 0] + H[i, 1] * X[:, 1]) + H[i, 2] * X[:, 2]) + H[i, 3]
            for i in range(3)]
    return torch.stack(cols, dim=-1)


def _d2(Q: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Exact squared distances of queries Q (..., 3) to points P (..., 3)
    broadcast against them."""
    d = Q[..., 0] - P[..., 0]
    out = d * d
    d = Q[..., 1] - P[..., 1]
    out = out + d * d
    d = Q[..., 2] - P[..., 2]
    return out + d * d


def _row_block(n_ref: int, budget: int = 1 << 25) -> int:
    return max(1, budget // max(n_ref, 1))


def nearest(Q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Index of each query's nearest point of X (first on ties)."""
    out = torch.empty(Q.shape[0], dtype=torch.int64, device=Q.device)
    step = _row_block(X.shape[0])
    for lo in range(0, Q.shape[0], step):
        d2 = _d2(Q[lo:lo + step, None, :], X[None, :, :])
        out[lo:lo + step] = torch.argmin(d2, dim=1)
    return out


def k_nearest(Q: torch.Tensor, X: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest points of X to each query, in ascending order of
    (d2, index)."""
    out = torch.empty((Q.shape[0], k), dtype=torch.int64, device=Q.device)
    step = _row_block(X.shape[0])
    for lo in range(0, Q.shape[0], step):
        d2 = _d2(Q[lo:lo + step, None, :], X[None, :, :])
        vals, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        by_idx = torch.argsort(idx, dim=1)
        vals, idx = vals.gather(1, by_idx), idx.gather(1, by_idx)
        by_val = torch.argsort(vals, dim=1, stable=True)
        out[lo:lo + step] = idx.gather(1, by_val)
    return out


def overlap_mask(Xf: torch.Tensor, Xm0: torch.Tensor, radius: float) -> torch.Tensor:
    """Fixed points whose nearest point of Xm0 lies within ``radius``.

    Every movable point within the radius of a fixed point lies in its
    (x, y) column of the grid or in one of the eight around it, since the
    columns are 1 % wider than the radius; only those are searched."""
    r32 = torch.tensor(radius, dtype=F32, device=Xf.device)
    r2 = r32 * r32
    s = 1.01 * radius
    lo = Xm0[:, :2].to(F64).amin(dim=0) - s
    cm = torch.floor((Xm0[:, :2].to(F64) - lo) / s).long()
    nx, ny = (int(v) + 2 for v in cm.amax(dim=0))
    key = cm[:, 0] * ny + cm[:, 1]
    order = torch.argsort(key, stable=True)
    pts = Xm0[order]
    counts = torch.bincount(key, minlength=nx * ny)
    starts = torch.cumsum(counts, 0) - counts
    cf = torch.floor((Xf[:, :2].to(F64) - lo) / s).long()
    best = torch.full((Xf.shape[0],), float("inf"), dtype=F32, device=Xf.device)
    width = 16
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cx, cy = cf[:, 0] + dx, cf[:, 1] + dy
            ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
            col = torch.where(ok, cx * ny + cy, 0)
            st = starts[col]
            cnt = torch.where(ok, counts[col], 0)
            most = int(cnt.max()) if cnt.numel() else 0
            for j0 in range(0, most, width):
                j = torch.arange(j0, min(j0 + width, most), device=Xf.device)
                valid = j[None, :] < cnt[:, None]
                idx = torch.where(valid, st[:, None] + j[None, :], 0)
                d2 = torch.where(valid, _d2(Xf[:, None, :], pts[idx]),
                                 torch.tensor(float("inf"), dtype=F32, device=Xf.device))
                best = torch.minimum(best, d2.amin(dim=1))
    return best <= r2


def select(mask: Optional[torch.Tensor], nf: int, C: int):
    """(indices (C,) int64, valid (C,) bool, error) of the selection: all
    of ``nf`` points without a gate, else the survivors of ``mask``."""
    dev = mask.device if mask is not None else torch.device("cpu")
    if mask is None:
        if nf > C:
            idx = np.round(np.linspace(0, nf - 1, C)).astype(np.int64)
            return torch.as_tensor(idx), torch.ones(C, dtype=torch.bool), ERR_OK
        idx = np.minimum(np.arange(C), nf - 1)
        return torch.as_tensor(idx), torch.as_tensor(np.arange(C) < nf), ERR_OK
    survivors = torch.nonzero(mask)[:, 0].cpu().numpy()
    error = ERR_OK
    if survivors.size == 0:
        survivors, error = np.arange(nf), ERR_NO_OVERLAP
    n = survivors.size
    pos = np.round(np.linspace(0, max(n, C) - 1, C)).astype(np.int64)
    padded = np.zeros(nf, np.int64)
    padded[:n] = survivors
    idx = padded[np.minimum(pos, nf - 1)]
    valid = np.arange(C) < min(n, C)
    return (torch.as_tensor(idx, device=dev), torch.as_tensor(valid, device=dev), error)


def eig_smallest(Cv: torch.Tensor):
    """Eigenvalues (descending) and the unit eigenvector of the smallest
    eigenvalue of symmetric 3x3 matrices Cv (n, 3, 3), closed form."""
    eps = 1e-18 if Cv.dtype == F32 else 1e-30
    a00, a11, a22 = Cv[:, 0, 0], Cv[:, 1, 1], Cv[:, 2, 2]
    a01, a02, a12 = Cv[:, 0, 1], Cv[:, 0, 2], Cv[:, 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    ps = torch.clamp(p, min=eps)
    det = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02)
           + a02 * (a01 * a12 - b11 * a02)) / (ps * ps * ps)
    phi = torch.arccos(torch.clamp(det / 2.0, -1.0, 1.0)) / 3.0
    l_max = q + 2.0 * p * torch.cos(phi)
    l_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l_mid = 3.0 * q - l_max - l_min
    r0 = torch.stack([a00 - l_min, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - l_min, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - l_min], dim=-1)
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=1)
    n2 = (cands * cands).sum(dim=-1)
    best = torch.zeros(n2.shape[0], dtype=torch.int64, device=Cv.device)
    for j in (1, 2):
        best = torch.where(n2[:, j] > n2.gather(1, best[:, None])[:, 0], j, best)
    v = cands[torch.arange(cands.shape[0], device=Cv.device), best]
    v = v / torch.sqrt(torch.clamp((v * v).sum(dim=-1, keepdim=True), min=eps))
    degenerate = n2.amax(dim=-1) < eps
    v = torch.where(degenerate[:, None], torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype,
                                                      device=v.device), v)
    return torch.stack([l_max, l_mid, l_min], dim=-1), v


def normals_at(neigh: torch.Tensor, tf: bool = False):
    """(normals (n, 3), planarity (n,)) of neighbourhoods (n, k, 3)."""
    k = neigh.shape[1]
    c = neigh - neigh.mean(dim=1, keepdim=True)
    c = _maybe_tf32(c, tf)
    Cv = (c[:, :, :, None] * c[:, :, None, :]).sum(dim=1) / (k - 1)
    lam, v = eig_smallest(Cv)
    lmax = lam[:, 0]
    safe = torch.where(lmax > 0, lmax, torch.ones_like(lmax))
    planarity = torch.where(lmax > 0, (lam[:, 1] - lam[:, 2]) / safe, torch.zeros_like(lmax))
    return v, planarity


def _median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """numpy's median of x[mask] (mean of the two middles), over the last
    axis."""
    n = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1)
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=-1).values
    return 0.5 * (s.gather(-1, (n - 1) // 2)[..., 0] + s.gather(-1, n // 2)[..., 0])


def _mean(x, mask):
    return torch.where(mask, x, torch.zeros_like(x)).sum(dim=-1) / torch.clamp(mask.sum(dim=-1), min=1)


def _std(x, mask, ddof):
    dev = (x - _mean(x, mask)[..., None]) ** 2
    n = mask.sum(dim=-1)
    return torch.sqrt(torch.where(mask, dev, torch.zeros_like(dev)).sum(dim=-1)
                      / torch.clamp(n - ddof, min=1))


def _pct(new, old):
    both = (old == 0) & (new == 0)
    only_old = (old == 0) & (new != 0)
    ch = torch.abs((new - old) / torch.where(old == 0, torch.ones_like(old), old) * 100.0)
    return torch.where(both, torch.zeros_like(ch),
                       torch.where(only_old, torch.full_like(ch, float("inf")), ch))


def _residuals64(p, xm, xf, n):
    R = rotation(p)
    return ((xm @ R.T + p[3:6] - xf) * n).sum(dim=-1)


def gauss_newton(p0: torch.Tensor, xm, xf, n, w, steps: int = 24) -> torch.Tensor:
    """Weighted least-squares parameters (float64) of the point-to-plane
    residuals from p0, by Gauss-Newton with exact Jacobians."""
    p = p0.to(F64)
    tol = 64.0 * torch.finfo(F64).eps
    for _ in range(steps):
        r = _residuals64(p, xm, xf, n)
        J = torch.func.jacfwd(_residuals64)(p, xm, xf, n)
        Jw = J * w[:, None]
        delta = torch.linalg.solve(J.T @ Jw, Jw.T @ r)
        p = p - delta
        if float(torch.linalg.vector_norm(delta) / (1.0 + torch.linalg.vector_norm(p))) <= tol:
            break
    return p


def register(X_fix: torch.Tensor, X_mov: torch.Tensor, icp: Dict, *,
             tf: bool = False, run_to: int = 0) -> Dict:
    """One registration of X_mov onto X_fix (float32 (n, 3) tensors) under
    the configuration's ``icp`` fields. The loop stops by its own test and
    then, where ``run_to`` asks for more, goes on to that many iterations,
    so that ``H_at(n)`` is the transform after n iterations for any n a
    program reports. Returns ``n_iterations``, ``converged``, ``error``,
    ``sel_idx``, ``sel_valid``, ``normals``, ``H`` (at the loop's own stop),
    ``H_at`` and ``iter_stds`` (the residual std of each iteration run)."""
    dev = X_fix.device
    C, k, T = icp["correspondences"], icp["neighbors"], icp["max_iterations"]
    Xf, Xm = X_fix.to(F32), X_mov.to(F32)
    nf = Xf.shape[0]
    p = torch.zeros(6, dtype=F32, device=dev)
    H0 = transform_of(p)
    radius = icp.get("max_overlap_distance")
    gated = radius is not None and math.isfinite(radius)
    mask = overlap_mask(Xf, moved(Xm, H0, tf), radius) if gated else None
    sel_idx, sel_valid, error = select(mask, nf, C)
    sel_idx, sel_valid = sel_idx.to(dev), sel_valid.to(dev)
    Q = Xf[sel_idx]
    normals, planarity = normals_at(Xf[k_nearest(Q, Xf, k)], tf)

    floor = 32.0 * torch.finfo(F32).eps * torch.abs(Q).amax()
    min_planarity = torch.tensor(icp["min_planarity"], dtype=F32, device=dev)
    prev_mean = prev_std = torch.tensor(float("inf"), dtype=F32, device=dev)
    Hs: List[torch.Tensor] = [H0]
    stds: List[torch.Tensor] = []
    it, stop_at, converged = 0, None, False
    if error != ERR_OK:
        stop_at = 0
    while it < T and (stop_at is None or it < run_to):
        H = transform_of(p)
        m_idx = nearest(Q, moved(Xm, H, tf))
        m_orig = Xm[m_idx]
        d = ((moved(m_orig, H, tf) - Q) * normals).sum(dim=-1)
        mask_p = sel_valid & (planarity >= min_planarity)
        med = _median(d[None], mask_p[None])[0]
        mad = icp["mad_scale"] * _median(torch.abs(d - med)[None], mask_p[None])[0]
        keep = mask_p & (torch.abs(d - med) <= 3.0 * mad)
        if int(keep.sum()) < 6:
            error = ERR_TOO_FEW
            stop_at = it + 1 if stop_at is None else stop_at
            it += 1
            Hs.append(Hs[-1])
            stds.append(torch.zeros((), dtype=F32, device=dev))
            continue
        w = keep.to(F64) * float(icp["distance_weights"]) ** 2
        p64 = gauss_newton(p, m_orig.to(F64), Q.to(F64), normals.to(F64), w,
                           icp["gn_iterations"])
        p = p64.to(F32)
        res = _residuals64(p64, m_orig.to(F64), Q.to(F64), normals.to(F64)).to(F32)
        mean = _mean(res[None], keep[None])[0]
        std = _std(res[None], keep[None], icp["std_ddof"])[0]
        ok_mean = (_pct(mean, prev_mean) < icp["min_change"]) | (torch.abs(mean - prev_mean) <= floor)
        ok_std = (_pct(std, prev_std) < icp["min_change"]) | (torch.abs(std - prev_std) <= floor)
        prev_mean, prev_std = mean, std
        Hs.append(transform_of(p))
        stds.append(std)
        it += 1
        if stop_at is None and it > 1 and bool(ok_mean & ok_std):
            stop_at, converged = it, True
    n_it = it if stop_at is None else stop_at
    return {
        "n_iterations": n_it, "converged": converged, "error": error,
        "sel_idx": sel_idx, "sel_valid": sel_valid, "normals": normals,
        "H": Hs[n_it], "H_at": Hs,
        "iter_stds": torch.stack(stds) if stds else torch.zeros(0, dtype=F32, device=dev),
    }
