"""The ICP pipeline: the monolithic main path, with or without the gate.

Pipeline of ``icp_register``:
  1. initial H from the observed rigid-body parameters;
  2. overlap gate (finite ``max_overlap_distance``): the 1-NN of every fixed
     point among the movable cloud moved by the initial H (the 1-NN kernel
     on the card); the fixed points within the radius survive;
  3. fixed-count selection: round(linspace) over the indices of the fixed
     points (of the survivors when gated);
  4. normals: the user's, gathered at the selection, or k-NN neighbourhoods
     (the k-NN kernel on the card) and the closed-form 3x3 eigensolver;
  5. iterate: fused transform + 1-NN match (the match kernel on the card,
     over the untransformed movable cloud) -> planarity gate (both clouds
     when the movable cloud carries planarity) -> median/MAD rejection ->
     Gauss-Newton solve -> convergence on the mean/std change;
  6. a-posteriori uncertainties.

The loop runs on the host and keeps its state on the device; it reads one
flag back per ICP iteration (converged or failed) and one per Gauss-Newton
step, and the gate reads back the number of survivors (``utils/sync.py``
counts them). Its results equal those of the JAX package's
``lax.while_loop`` field for field: the state it keeps on an error, the
iteration it stops at, the buffers it fills.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..config import IcpConfig
from ..ops.knn import knn_search, match_transform, nn_search_auto
from ..ops.normals import estimate_normals_from_neighborhoods
from ..ops.stats import masked_mad, masked_mean, masked_median, masked_std, pct_change
from ..ops.transform import (
    apply_H,
    compose_H,
    rbp_to_H,
    rotation_matrix_to_euler_angles,
)
from ..utils.device import resolve
from ..utils.sync import read_flag, read_nonzero
from .solver import estimate_uncertainties, gn_solve, linearized_solve

# Error codes of IcpResult.error_code.
ERR_OK = 0
ERR_NO_OVERLAP = 1
ERR_TOO_FEW_CORRESPONDENCES = 2

# Largest gate (nf x nm pairs) that gate_method="auto" sends to the brute
# gate, as in the JAX package; above it that package plans the dilate gate.
GATE_AUTO_BRUTE_PAIRS = 2**40
# match_method="auto" picks the grid matcher above this many pairs per
# iteration when a radius is available, as in the JAX package.
MATCH_AUTO_PAIR_BUDGET = 2**38


class IcpResult(NamedTuple):
    """Result of one registration run (tensors on the run's device)."""

    H: torch.Tensor                  # (4,4) final homogeneous transform
    p: torch.Tensor                  # (6,) alpha1..3 [rad], tx, ty, tz
    uncertainties: torch.Tensor      # (6,) a-posteriori sigmas (NaN if frozen)
    covariance: torch.Tensor         # (6,6) a-posteriori covariance (frozen
                                     # rows/cols zeroed)
    n_iterations: torch.Tensor       # scalar int32: executed ICP iterations
    converged: torch.Tensor          # scalar bool
    error_code: torch.Tensor         # scalar int32 (ERR_*)
    iter_counts: torch.Tensor        # (max_iterations,) int32 valid-corr counts
    iter_means: torch.Tensor         # (max_iterations,) residual means
    iter_stds: torch.Tensor          # (max_iterations,) residual stds
    orig_count: torch.Tensor         # scalar int32: the "orig:0" row
    orig_mean: torch.Tensor
    orig_std: torch.Tensor
    residuals: torch.Tensor          # (C,) final signed p2plane residuals
    residual_mask: torch.Tensor      # (C,) validity of `residuals`
    distance_weight: torch.Tensor    # resolved scalar distance weight
    sel_idx: torch.Tensor            # (C,) indices of selected fixed points
    sel_valid: torch.Tensor          # (C,) validity of sel_idx
    normals: torch.Tensor            # (C,3) normals at the selected points
    planarity: torch.Tensor          # (C,) planarity at the selected points
    iter_ps: torch.Tensor            # (R,6) parameters per iteration
    iter_midx: torch.Tensor          # (R,C) matched movable indices
    iter_masks: torch.Tensor         # (R,C) post-rejection validity
    iter_dists: torch.Tensor         # (R,C) pre-optim p2plane distances
                                     # (R = max_iterations when recording
                                     # the trajectory, else 1: iteration 0)
    iter_gn_rel_steps: torch.Tensor  # (max_iterations,) last inner-GN
                                     # relative step per iteration (0 for the
                                     # linearized solver)


class _Carry(NamedTuple):
    it: int
    p: torch.Tensor
    H: torch.Tensor
    dist_w: torch.Tensor
    converged: torch.Tensor
    error: torch.Tensor
    prev_mean: torch.Tensor
    prev_std: torch.Tensor
    iter_counts: torch.Tensor
    iter_means: torch.Tensor
    iter_stds: torch.Tensor
    orig_count: torch.Tensor
    orig_mean: torch.Tensor
    orig_std: torch.Tensor
    residuals: torch.Tensor
    residual_mask: torch.Tensor
    m_idx: torch.Tensor
    iter_ps: torch.Tensor
    iter_midx: torch.Tensor
    iter_masks: torch.Tensor
    iter_dists: torch.Tensor
    iter_gn: torch.Tensor


def _check_round_linspace_domain(correspondences: int, nf: int) -> None:
    """Refuse a selection outside the proven bit-exactness envelope of the
    reference selection formula ((nf-1)*(C-1) < 2^51 once C > 2^20+1)."""
    C = int(correspondences)
    if C > 2**20 + 1 and (nf - 1) * (C - 1) >= 2**51:
        raise ValueError(
            f"correspondences={C} with a {nf}-point fixed cloud leaves the "
            "proven bit-exactness domain of the reference selection formula "
            "((n_points-1)*(correspondences-1) must stay below 2^51 when "
            "correspondences exceeds 2^20+1). Reduce `correspondences` or "
            "pre-select fewer fixed points."
        )


def round_linspace(n_sel: int, n: int, device=None) -> torch.Tensor:
    """np.round(np.linspace(0, n_sel - 1, n)) as an (n,) int64 tensor,
    computed as numpy computes it: in float64, step = span / div, y = i *
    step, y[-1] = span, rounded half to even. (The JAX package emulates
    these two float64 roundings in int32 limbs because the TPU has no
    float64; the card and the CPU have it.) n_sel is a host integer."""
    div = n - 1
    span = max(int(n_sel) - 1, 0)
    y = torch.arange(n, dtype=torch.float64, device=device) * (span / div)
    y[-1] = span
    return torch.round(y).to(torch.int64)


def _select_compacted(compacted: torch.Tensor, nf: int, n: int):
    """Fixed-count equidistant selection over the ascending indices
    ``compacted`` of the selected fixed points (of nf): round(linspace)
    positions when more than n are selected, else all of them, the slots
    past them invalid and holding what the JAX package's zero-padded
    compaction gives. Returns (sel_idx int32 (n,), valid bool (n,))."""
    dev = compacted.device
    n_sel = compacted.shape[0]
    if n_sel > n:
        return (compacted[round_linspace(n_sel, n, dev)].to(torch.int32),
                torch.ones(n, dtype=torch.bool, device=dev))
    seq = torch.arange(n, device=dev)
    padded = torch.zeros(nf, dtype=compacted.dtype, device=dev)
    padded[:n_sel] = compacted
    return (padded[torch.clamp(seq, max=nf - 1)].to(torch.int32),
            seq < n_sel)


def _select_n(sel_mask: torch.Tensor, n: int):
    """The gated selection of the reference's select_n_points over a (nf,)
    bool mask. Returns (sel_idx int32 (n,), valid bool (n,))."""
    return _select_compacted(read_nonzero(sel_mask), sel_mask.shape[0], n)


def _static_ungated_selection(nf: int, C: int):
    """Fixed-count selection without a gate, on the host: exact
    np.round(np.linspace(0, nf - 1, C)) when nf > C, else every point.

    Returns numpy (host_idx int32 (C,), valid bool (C,))."""
    if nf > C:
        host_idx = np.round(np.linspace(0, nf - 1, C)).astype(np.int32)
        valid = np.ones(C, bool)
    else:
        host_idx = np.minimum(np.arange(C, dtype=np.int32), nf - 1)
        valid = np.arange(C) < nf
    return host_idx, valid


def _gate_select_stages(Xf, Xm, H0, *, cfg: IcpConfig):
    """Overlap gate and fixed-count selection.

    Returns (sel_idx, sel_valid, error) with error a host int (ERR_OK or
    ERR_NO_OVERLAP)."""
    dev = Xf.device
    C = cfg.correspondences
    if not cfg.overlap_enabled:
        host_idx, valid_np = _static_ungated_selection(Xf.shape[0], C)
        return (torch.as_tensor(host_idx, device=dev),
                torch.as_tensor(valid_np, device=dev), ERR_OK)
    # The initial transform applies before the gate.
    d2, _ = nn_search_auto(Xf, apply_H(Xm, H0))
    # The radius is cast to the coordinate dtype before it is squared.
    r = torch.tensor(cfg.max_overlap_distance, dtype=Xf.dtype, device=dev)
    compacted = read_nonzero(d2 <= r ** 2)
    error = ERR_OK
    if compacted.shape[0] == 0:
        # No fixed point survives: the selection runs over all of them and
        # the loop runs no iteration.
        error = ERR_NO_OVERLAP
        compacted = torch.arange(Xf.shape[0], device=dev)
    sel_idx, sel_valid = _select_compacted(compacted, Xf.shape[0], C)
    return sel_idx, sel_valid, error


def _normals_stage(Q, Xf, sel_idx, normals_fix, planarity_fix, *,
                   cfg: IcpConfig):
    """Normals and planarity at the selected points: the user's, gathered
    at the selection, or estimated from their k-NN neighbourhoods in the
    fixed cloud."""
    if normals_fix is not None:
        idx = sel_idx.long()
        return normals_fix[idx], planarity_fix[idx]
    _, idxk = knn_search(Q, Xf, cfg.neighbors)
    neigh = Xf[idxk.long()]  # (C, k, 3)
    normals, planarity, _ = estimate_normals_from_neighborhoods(neigh)
    return normals, planarity


def _make_match_fn(Q, Xm):
    """The per-iteration matcher: match_fn(Ht) -> (m_idx, m_t, m_orig,
    m_valid). The match kernel takes the untransformed cloud and Ht, so the
    moved cloud is never materialized; only the C matched rows are moved."""
    def match_fn(Ht):
        _, m_idx = match_transform(Q, Xm, Ht)
        m_orig = Xm[m_idx.long()]
        m_valid = torch.ones(m_idx.shape, dtype=torch.bool, device=m_idx.device)
        return m_idx, apply_H(m_orig, Ht), m_orig, m_valid

    return match_fn


def make_carry_init(cfg: IcpConfig, dtype, obs_vals, H0, error0) -> _Carry:
    """The loop-entry state (iteration 0, nothing executed)."""
    C = cfg.correspondences
    T = cfg.max_iterations
    dev = H0.device

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=dev)

    auto_dw = cfg.distance_weights is None
    # Trajectory buffers hold max_iterations slots when recording, else one
    # (iteration 0 writes it, later writes fall outside and are dropped, as
    # the JAX package's scatter drops them).
    R = T if cfg.record_trajectory else 1
    return _Carry(
        it=0,
        p=obs_vals.to(dtype),
        H=H0,
        dist_w=full((), 1.0 if auto_dw else cfg.distance_weights),
        converged=full((), False, torch.bool),
        error=error0,
        prev_mean=full((), float("inf")),
        prev_std=full((), float("inf")),
        iter_counts=full((T,), 0, torch.int32),
        iter_means=full((T,), 0.0),
        iter_stds=full((T,), 0.0),
        orig_count=full((), 0, torch.int32),
        orig_mean=full((), 0.0),
        orig_std=full((), 0.0),
        residuals=full((C,), 0.0),
        residual_mask=full((C,), False, torch.bool),
        m_idx=full((C,), 0, torch.int32),
        iter_ps=full((R, 6), 0.0),
        iter_midx=full((R, C), 0, torch.int32),
        iter_masks=full((R, C), False, torch.bool),
        iter_dists=full((R, C), 0.0),
        iter_gn=full((T,), 0.0),
    )


def run_icp_loop(Q, normals, planarity, sel_valid, obs_vals, obs_w,
                 cfg: IcpConfig, dtype, error0: int, H0, match_fn, gather_fn,
                 mov_planarity_fn=None):
    """The match -> reject -> solve -> converge iteration.

    ``match_fn(Ht) -> (m_idx, m_t, m_orig, m_valid)`` matches against the
    movable cloud moved by Ht; ``gather_fn(m_idx) -> (C, 3)`` fetches
    original-frame movable points for the uncertainty estimate;
    ``mov_planarity_fn(m_idx) -> (C,)``, when given, is the matched movable
    points' planarity, gated like the fixed side's. ``error0`` is the host
    error code the loop starts from (ERR_NO_OVERLAP from the gate runs no
    iteration).

    Returns (final_carry, uncertainties, covariance).
    """
    T = cfg.max_iterations
    auto_dw = cfg.distance_weights is None
    nonlinear = cfg.solver == "nonlinear"
    min_planarity = torch.tensor(cfg.min_planarity, dtype=dtype, device=Q.device)

    # Numerical noise floor of the residual statistics: a mean/std change at
    # or below eps(dtype) * |coords| * scale counts as converged.
    noise_floor = (
        cfg.convergence_floor_scale * torch.finfo(dtype).eps
        * torch.abs(Q).max()
    )

    def crit_met(new, old):
        return (pct_change(new, old) < cfg.min_change) | (
            torch.abs(new - old) <= noise_floor
        )

    def body(c: _Carry) -> _Carry:
        Ht = rbp_to_H(c.p) if nonlinear else c.H
        m_idx, m_t, m_orig, m_valid = match_fn(Ht)
        d = ((m_t - Q) * normals).sum(dim=1)  # signed p2plane distances

        # "python": planarity gate first, median/MAD of the survivors;
        # "joint": median/MAD of all matches, both criteria jointly.
        matched = sel_valid & m_valid
        mask_p = matched & (planarity >= min_planarity)
        if mov_planarity_fn is not None:
            mask_p = mask_p & (mov_planarity_fn(m_idx) >= min_planarity)
        mad_base = matched if cfg.rejection_staging == "joint" else mask_p
        med = masked_median(d, mad_base)
        sigma = 3.0 * masked_mad(d, mad_base, scale=cfg.mad_scale)
        mask = mask_p & (torch.abs(d - med) <= sigma)

        count = mask.sum().to(torch.int32)
        err = torch.where(count < 6, torch.full_like(c.error, ERR_TOO_FEW_CORRESPONDENCES),
                          c.error)

        if c.it == 0:
            orig_count = count
            orig_mean = masked_mean(d, mask)
            orig_std = masked_std(d, mask, ddof=cfg.std_ddof)
        else:
            orig_count, orig_mean, orig_std = c.orig_count, c.orig_mean, c.orig_std

        if auto_dw and c.it == 0:
            # 1/std^2 of the matched distances, estimated in iteration 0
            dw = 1.0 / torch.clamp(masked_std(d, mask), min=1e-30) ** 2
        else:
            dw = c.dist_w

        if nonlinear:
            p_new, residuals, gn_rel = gn_solve(
                c.p, m_orig, Q, normals, mask, dw, obs_vals, obs_w,
                n_steps=cfg.gn_iterations,
            )
            H_new = rbp_to_H(p_new)
        else:
            gn_rel = torch.zeros((), dtype=dtype, device=Q.device)
            dH, residuals, _ = linearized_solve(m_t, Q, normals, mask)
            H_new = compose_H(dH, c.H)
            a1, a2, a3 = rotation_matrix_to_euler_angles(H_new)
            p_new = torch.cat([torch.stack([a1, a2, a3]), H_new[:3, 3]])

        mean = masked_mean(residuals, mask)
        std = masked_std(residuals, mask, ddof=cfg.std_ddof)
        converged = crit_met(mean, c.prev_mean) & crit_met(std, c.prev_std)
        if c.it == 0:
            converged = torch.zeros_like(converged)

        # On error keep the previous state.
        bad = err != ERR_OK
        p_new = torch.where(bad, c.p, p_new)
        H_new = torch.where(bad, c.H, H_new)

        # The buffers are this loop's own; they are updated in place.
        c.iter_counts[c.it] = count
        c.iter_means[c.it] = mean
        c.iter_stds[c.it] = std
        c.iter_gn[c.it] = gn_rel
        if c.it < c.iter_ps.shape[0]:
            c.iter_ps[c.it] = p_new
            c.iter_midx[c.it] = m_idx
            c.iter_masks[c.it] = mask
            c.iter_dists[c.it] = d
        return c._replace(
            it=c.it + 1,
            p=p_new,
            H=H_new,
            dist_w=dw,
            converged=converged & ~bad,
            error=err,
            prev_mean=mean,
            prev_std=std,
            orig_count=orig_count,
            orig_mean=orig_mean,
            orig_std=orig_std,
            residuals=torch.where(bad, c.residuals, residuals),
            residual_mask=torch.where(bad, c.residual_mask, mask),
            m_idx=torch.where(bad, c.m_idx, m_idx),
        )

    c = make_carry_init(cfg, dtype, obs_vals, H0,
                        torch.tensor(error0, dtype=torch.int32, device=Q.device))
    # The JAX loop tests (it < T) & ~converged & (error == OK) before every
    # iteration, the first included.
    go = error0 == ERR_OK
    while go and c.it < T:
        c = body(c)
        go = c.it < T and not read_flag(c.converged | (c.error != ERR_OK))

    uncertainties, covariance = estimate_uncertainties(
        c.p, gather_fn(c.m_idx), Q, normals, c.residual_mask,
        c.dist_w, obs_vals, obs_w,
    )
    return c, uncertainties, covariance


def _result_from_carry(c: _Carry, uncertainties, covariance, sel_idx,
                       sel_valid, normals, planarity) -> IcpResult:
    return IcpResult(
        H=c.H,
        p=c.p,
        uncertainties=uncertainties,
        covariance=covariance,
        n_iterations=torch.tensor(c.it, dtype=torch.int32, device=c.H.device),
        converged=c.converged,
        error_code=c.error,
        iter_counts=c.iter_counts,
        iter_means=c.iter_means,
        iter_stds=c.iter_stds,
        orig_count=c.orig_count,
        orig_mean=c.orig_mean,
        orig_std=c.orig_std,
        residuals=c.residuals,
        residual_mask=c.residual_mask,
        distance_weight=c.dist_w,
        sel_idx=sel_idx,
        sel_valid=sel_valid,
        normals=normals,
        planarity=planarity,
        iter_ps=c.iter_ps,
        iter_midx=c.iter_midx,
        iter_masks=c.iter_masks,
        iter_dists=c.iter_dists,
        iter_gn_rel_steps=c.iter_gn,
    )


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to simpleicp_tpu_torch yet: ROADMAP queue 1 {item}"
    )


ITEM_GRID = "item 11 (gridhash)"
ITEM_DILATE = "item 13 (dilate gate)"


def _resolve_engines(cfg: IcpConfig, nf: int, nm: int, *,
                     fixed_prep) -> IcpConfig:
    """The configuration with its matcher, gate and dispatch resolved as the
    JAX package resolves them off the TPU. Every setting this package does
    not run yet raises NotImplementedError naming the ROADMAP item that will
    port it; none is ignored."""
    for hit, what, item in (
        (cfg.dispatch == "chunked", "dispatch='chunked'",
         "item 12 (chunked dispatch)"),
        (cfg.warm_start, "warm_start=True", "item 10 (serving)"),
        (cfg.approx_knn, "approx_knn=True",
         "item 15 (approximate normal k-NN)"),
        (fixed_prep is not None, "the fixed_prep argument", "item 10 (serving)"),
    ):
        if hit:
            raise not_ported(what, item)
    match = cfg.match_method
    if match == "auto":
        has_radius = cfg.match_radius > 0 or cfg.overlap_enabled
        big = cfg.correspondences * nm > MATCH_AUTO_PAIR_BUDGET
        match = "grid" if (big and has_radius) else "brute"
        if match == "grid":
            raise not_ported(
                f"match_method='auto' at {cfg.correspondences} x {nm} pairs "
                "per iteration (the grid matcher)", ITEM_GRID)
    if match == "grid":
        raise not_ported("match_method='grid'", ITEM_GRID)
    gate = cfg.gate_method
    if cfg.overlap_enabled:
        if gate == "grid":
            raise not_ported("gate_method='grid'", ITEM_GRID)
        if gate == "dilate":
            raise not_ported("gate_method='dilate'", ITEM_DILATE)
        if gate == "auto" and nf * nm > GATE_AUTO_BRUTE_PAIRS:
            raise not_ported(
                f"gate_method='auto' at {nf} x {nm} pairs (above 2^40 the JAX "
                "package plans the dilate gate)", ITEM_DILATE)
        gate = "brute"
    return dataclasses.replace(cfg, match_method=match, gate_method=gate,
                               dispatch="monolithic")


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.array(x), dtype=dtype, device=device).contiguous()


def icp_register(
    X_fix,
    X_mov,
    cfg: IcpConfig = IcpConfig(),
    *,
    rbp_observed_values: Optional[np.ndarray] = None,
    rbp_observation_weights: Optional[np.ndarray] = None,
    normals_fix=None,
    planarity_fix=None,
    planarity_mov=None,
    fixed_prep=None,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
) -> IcpResult:
    """Register X_mov onto X_fix.

    Args:
        X_fix: (nf, 3) fixed cloud (numpy array or tensor).
        X_mov: (nm, 3) movable cloud.
        cfg: pipeline configuration. Settings this package does not run yet
            raise NotImplementedError; none is ignored.
        rbp_observed_values: (6,) observed parameter values, angles in
            radians; they also give the initial transform.
        rbp_observation_weights: (6,) weights; 0 free, finite > 0 observed,
            inf frozen.
        normals_fix / planarity_fix: optional (nf, 3) normals and (nf,)
            planarity of the fixed cloud; given normals skip the normal
            estimate (planarity then defaults to ones).
        planarity_mov: optional (nm,) planarity of the movable cloud; a
            correspondence whose movable point is below min_planarity is
            rejected too.
        fixed_prep: accepted for the JAX package's signature; not ported
            yet (must be None).
        device: "cuda" by default, which raises when no card is found;
            "cpu" runs the kernels' plain versions.
        dtype: coordinate dtype, float32 by default (solver math is float64
            whatever this is).

    Returns:
        IcpResult of tensors on ``device``. Check ``.error_code``.
    """
    return _icp_register(
        X_fix, X_mov, cfg, rbp_observed_values=rbp_observed_values,
        rbp_observation_weights=rbp_observation_weights,
        normals_fix=normals_fix, planarity_fix=planarity_fix,
        planarity_mov=planarity_mov, fixed_prep=fixed_prep, device=device,
        dtype=dtype,
    )[0]


def _icp_register(X_fix, X_mov, cfg: IcpConfig, *, rbp_observed_values,
                  rbp_observation_weights, normals_fix, planarity_fix,
                  planarity_mov, fixed_prep, device, dtype):
    """``icp_register``, also returning the loop's final state (whose
    ``m_idx`` holds the last iteration's matches)."""
    dev, dtype = resolve(device, dtype)
    Xf = _as_tensor(X_fix, dtype, dev)
    Xm = _as_tensor(X_mov, dtype, dev)
    if Xf.dim() != 2 or Xf.shape[1] != 3 or Xm.dim() != 2 or Xm.shape[1] != 3:
        raise ValueError("point clouds must have shape (n, 3)")
    _check_round_linspace_domain(cfg.correspondences, Xf.shape[0])
    cfg = _resolve_engines(cfg, Xf.shape[0], Xm.shape[0], fixed_prep=fixed_prep)

    zeros6 = torch.zeros(6, dtype=dtype, device=dev)
    obs_vals = (zeros6 if rbp_observed_values is None
                else _as_tensor(rbp_observed_values, dtype, dev))
    obs_w = (zeros6 if rbp_observation_weights is None
             else _as_tensor(rbp_observation_weights, dtype, dev))

    if normals_fix is not None:
        normals_fix = _as_tensor(normals_fix, dtype, dev)
        planarity_fix = (torch.ones(Xf.shape[0], dtype=dtype, device=dev)
                         if planarity_fix is None
                         else _as_tensor(planarity_fix, dtype, dev))
    mov_planarity_fn = None
    if planarity_mov is not None:
        planarity_mov = _as_tensor(planarity_mov, dtype, dev)

        def mov_planarity_fn(m_idx):
            return planarity_mov[m_idx.long()]

    H0 = rbp_to_H(obs_vals)
    sel_idx, sel_valid, error0 = _gate_select_stages(Xf, Xm, H0, cfg=cfg)
    Q = Xf[sel_idx.long()].contiguous()

    normals, planarity = _normals_stage(Q, Xf, sel_idx, normals_fix,
                                        planarity_fix, cfg=cfg)
    match_fn = _make_match_fn(Q, Xm)

    def gather_fn(m_idx):
        return Xm[m_idx.long()]

    final, uncertainties, covariance = run_icp_loop(
        Q, normals, planarity, sel_valid, obs_vals, obs_w, cfg, dtype,
        error0, H0, match_fn, gather_fn, mov_planarity_fn=mov_planarity_fn,
    )
    result = _result_from_carry(
        final, uncertainties, covariance, sel_idx, sel_valid, normals,
        planarity,
    )
    return result, final
