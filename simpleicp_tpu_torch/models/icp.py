"""The ICP pipeline: the monolithic main path, with or without the gate.

Pipeline of ``icp_register``:
  1. initial H from the observed rigid-body parameters;
  2. overlap gate (finite ``max_overlap_distance``): the fixed points within
     the radius of the movable cloud moved by the initial H survive. The
     brute gate takes the 1-NN of every fixed point (the 1-NN kernel on the
     card); the dilate gate (``gate_method="dilate"``, and ``"auto"`` above
     2^40 pairs) classifies them on a dilated occupancy grid (the dilate
     kernel on the card) and resolves only a thin band exactly; the grid
     gate (``gate_method="grid"``, and ``"auto"`` above 2^41 pairs without
     a dilate plan) scans the 27 hash cells around each fixed point
     (``ops/gridhash.py``); all three give the same mask;
  3. fixed-count selection: round(linspace) over the indices of the fixed
     points (of the survivors when gated);
  4. normals: the user's, gathered at the selection, or k-NN neighbourhoods
     (the k-NN kernel on the card) and the closed-form 3x3 eigensolver;
  5. iterate: fused transform + 1-NN match (the match kernel on the card,
     over the untransformed movable cloud; or the static-grid matcher,
     ``match_method="grid"``, and ``"auto"`` above 2^38 pairs per iteration
     with a radius: one cell list over the untransformed movable cloud,
     queried with the back-transformed fixed points) -> planarity gate (both clouds
     when the movable cloud carries planarity) -> median/MAD rejection ->
     Gauss-Newton solve -> convergence on the mean/std change;
  6. a-posteriori uncertainties.

Batch: ``icp_register_batch`` registers B pairs at once. Every stage and the
loop take a leading pair axis, and ``icp_register`` runs them on a batch of
one; the kernels take the pair axis too (one launch for the batch).

Serving: ``prepare_fixed`` runs stages 3-4 of an ungated configuration once
for a fixed cloud (a ``FixedPrep``, which ``FixedPrep.save`` and
``load_fixed_prep`` carry through an npz file), and ``icp_register(...,
fixed_prep=prep)`` starts at stage 5 for every movable cloud. Warm start
(``warm_start=True``): a coarse registration of stride-subsampled clouds
gives the full run its initial parameters (``plan_warm_start``).

The loop runs on the host and keeps its state on the device; it reads one
flag back per ICP iteration (converged or failed) and one per Gauss-Newton
step, for the whole batch, and the gate reads back each pair's number of
survivors (the dilate gate also its bounding box and band; a grid engine
resolving its cell cap on the device one occupancy; ``utils/sync.py``
counts them). Its results equal those of the JAX
package's ``lax.while_loop`` field for field: the state it keeps on an
error, the iteration it stops at, the buffers it fills.

Chunked dispatch (``dispatch="chunked"``, and "auto" when the card-priced
estimate exceeds ``program_budget_s``; ``_plan_dispatch``): the loop runs
K iterations a call, resuming from the carry on the device, with the
stall check of the JAX package at every chunk boundary; each chunk ends
on the flag the loop reads anyway, so chunking adds no host read. Over
budget, the normals k-NN runs as query blocks or through the certified
grid k-NN cascade (``_knn_grid_normals``). Every plan gives the monolithic
run's result bit for bit.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..config import IcpConfig
from ..ops.dilate_gate import bbox_of, overlap_mask_dilate, plan_dilate_gate
from ..ops.gridhash import (
    build_sorted_grid,
    grid_build_cap,
    grid_cell_cap,
    grid_query_sorted,
    knn_query_sorted,
)
from ..ops.knn import knn_search, match_transform, min_dist_sq
from ..ops.normals import estimate_normals_from_neighborhoods
from ..ops.stats import masked_mad, masked_mean, masked_median, masked_std, pct_change
from ..ops.transform import (
    apply_H,
    compose_H,
    rbp_to_H,
    rotation_matrix_to_euler_angles,
)
from ..utils import device_policy
from ..utils.device import resolve
from ..utils.profiling import span
from ..utils.sync import read_array, read_flag, read_nonzero
from .solver import estimate_uncertainties, gn_solve, host_rotation, linearized_solve

# Error codes of IcpResult.error_code.
ERR_OK = 0
ERR_NO_OVERLAP = 1
ERR_TOO_FEW_CORRESPONDENCES = 2

# Largest gate (nf x nm pairs) that gate_method="auto" sends to the brute
# gate, as in the JAX package; above it the dilate gate is planned.
GATE_AUTO_BRUTE_PAIRS = 2**40
# Without a dilate plan, "auto" stays the brute gate up to this many pairs;
# above it the grid gate, as in the JAX package.
GATE_AUTO_GRID_PAIRS = 2**41
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
    """The loop state of B pairs, each tensor with its leading pair axis."""
    it: int                         # iterations run by the batch (host)
    go: bool                        # some pair still passes the loop's
                                    # entry test, as last read (host)
    n_it: Optional[torch.Tensor]    # (B,) each pair's iterations; None at B=1
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


def round_linspace(n_sel, n: int, device=None) -> torch.Tensor:
    """np.round(np.linspace(0, n_sel - 1, n)) as an (n,) int64 tensor, or
    (B, n) for a sequence of B counts, computed as numpy computes it: in
    float64, step = span / div, y = i * step, y[-1] = span, rounded half to
    even. (The JAX package emulates these two float64 roundings in int32
    limbs because the TPU has no float64; the card and the CPU have it.)
    n_sel is a host integer or sequence of them."""
    span = np.maximum(np.asarray(n_sel, np.int64) - 1, 0)
    step = torch.as_tensor(span / (n - 1), dtype=torch.float64, device=device)
    y = torch.arange(n, dtype=torch.float64, device=device) * step[..., None]
    y[..., -1] = torch.as_tensor(span, dtype=torch.float64, device=device)
    return torch.round(y).to(torch.int64)


def _compacted(sel_mask: torch.Tensor) -> torch.Tensor:
    """The ascending indices of the True entries of an (..., nf) mask along
    its last axis, zero-padded to nf (the JAX package's compaction), without
    reading anything back to the host."""
    nf = sel_mask.shape[-1]
    slot = torch.where(sel_mask, torch.cumsum(sel_mask, dim=-1) - 1, nf)
    out = torch.zeros((*sel_mask.shape[:-1], nf + 1), dtype=torch.int64,
                      device=sel_mask.device)
    out.scatter_(-1, slot, torch.arange(nf, device=sel_mask.device).expand(sel_mask.shape))
    return out[..., :nf]


def _select_n(sel_mask: torch.Tensor, n: int, counts: Optional[np.ndarray] = None):
    """The gated selection of the reference's select_n_points over an (nf,)
    bool mask, or each row of a (B, nf) one: round(linspace) positions among
    a row's survivors when it has more than n, else all of them, the slots
    past them invalid and holding what the JAX package's zero-padded
    compaction gives. ``counts`` are the rows' survivor counts (numpy, () or
    (B,)) when the host already holds them; else they are read, the one host
    read. Returns (sel_idx int32 (..., n), valid bool (..., n))."""
    if counts is None:
        counts = read_array(sel_mask.sum(dim=-1))
    dev = sel_mask.device
    nf = sel_mask.shape[-1]
    # a row with at most n survivors takes positions 0..n-1 (round_linspace
    # of n is the identity), clipped to the cloud
    pos = torch.clamp(round_linspace(np.where(counts > n, counts, n), n, dev), max=nf - 1)
    valid = (torch.arange(n, device=dev)
             < torch.as_tensor(np.minimum(counts, n), device=dev)[..., None])
    return torch.gather(_compacted(sel_mask), -1, pos).to(torch.int32), valid


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


def _ungated_selection(nf: int, C: int, dev, lead=()):
    """``_static_ungated_selection`` as (sel_idx int32 (*lead, C), sel_valid
    bool (*lead, C)) tensors on ``dev``, the same row for every pair."""
    host_idx, valid_np = _static_ungated_selection(nf, C)
    return (torch.as_tensor(np.tile(host_idx, (*lead, 1)), device=dev),
            torch.as_tensor(np.tile(valid_np, (*lead, 1)), device=dev))


def _rows(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """X[b, idx[b, ...]] for each pair b: X (B, n) or (B, n, d), integer
    idx (B, ...) -> (B, ...) or (B, ..., d)."""
    flat = idx.reshape(idx.shape[0], -1).long()
    if X.dim() == 3:
        flat = flat[..., None].expand(-1, -1, X.shape[2])
    return torch.gather(X, 1, flat).reshape(*idx.shape, *X.shape[2:])


def _gate_select_stages(Xf, Xm, H0, *, cfg: IcpConfig, mov_host=None, obs_host=None):
    """Overlap gate and fixed-count selection of one pair (Xf (nf, 3), Xm
    (nm, 3), H0 (4, 4)) or of B pairs (Xf (B, nf, 3), Xm (B, nm, 3), H0 (B,
    4, 4); the brute gate only). ``mov_host`` is the movable cloud when it
    came as a numpy array and ``obs_host`` the observed values H0 comes
    from: the grid gate counts its cell cap on the host from them.

    Returns (sel_idx (..., C), sel_valid (..., C), error) with error a host
    int32 array, () or (B,), of ERR_OK or ERR_NO_OVERLAP."""
    dev = Xf.device
    lead, nf = Xf.shape[:-2], Xf.shape[-2]
    C = cfg.correspondences
    if not cfg.overlap_enabled:
        with span("icp.select"):
            return (*_ungated_selection(nf, C, dev, lead), np.full(lead, ERR_OK, np.int32))
    with span("icp.gate"):
        # The initial transform applies before the gate. One transformed cloud
        # serves the dilate gate's bounding box, its occupancy and its exact
        # sweeps, and the grid gate's cell list, so their masks are the brute
        # gate's bit for bit.
        Xm0 = apply_H(Xm, H0)
        with span("icp.gate_plan"):
            method, plan = _resolve_gate(cfg, nf, Xm.shape[-2],
                                         lambda: read_array(bbox_of(Xm0)))
        if method == "dilate":
            sel_mask = overlap_mask_dilate(Xf, Xm0, cfg.max_overlap_distance, plan)
        else:
            if method == "grid":
                X_host = (None if mov_host is None or cfg.grid_cell_cap
                          else _initial_moved_host(mov_host, obs_host))
                grid, cap = _grid_with_cap(Xm0, cfg.max_overlap_distance,
                                           cfg.grid_cell_cap, X_host)
                d2, _ = grid_query_sorted(Xf, grid[0], grid[1], grid[3],
                                          cfg.max_overlap_distance, cell_cap=cap,
                                          run_end=grid[4])
            else:
                d2 = min_dist_sq(Xf, Xm0)
            # The radius is cast to the coordinate dtype before it is squared.
            r = torch.tensor(cfg.max_overlap_distance, dtype=Xf.dtype, device=dev)
            sel_mask = d2 <= r ** 2
        # One host read for the whole batch: each pair's count of survivors.
        counts = read_array(sel_mask.sum(dim=-1))
    error = np.where(counts == 0, ERR_NO_OVERLAP, ERR_OK).astype(np.int32)
    with span("icp.select"):
        if not counts.all():
            # No fixed point of a pair survives: its selection runs over all of
            # them and the loop runs no iteration for it.
            sel_mask = sel_mask | torch.as_tensor(counts == 0, device=dev)[..., None]
            counts = np.where(counts == 0, nf, counts)
        sel_idx, sel_valid = _select_n(sel_mask, C, counts)
    return sel_idx, sel_valid, error


def _normals_stage(Q, Xf, sel_idx, normals_fix, planarity_fix, *,
                   cfg: IcpConfig):
    """Normals and planarity at the selected points of B pairs (Q (B, C,
    3), Xf (B, nf, 3)): the user's, gathered at the selection, or estimated
    from their k-NN neighbourhoods in the fixed cloud (one k-NN call for
    the batch)."""
    if normals_fix is not None:
        return _rows(normals_fix, sel_idx), _rows(planarity_fix, sel_idx)
    _, idxk = knn_search(Q, Xf, cfg.neighbors)
    neigh = _rows(Xf, idxk)  # (B, C, k, 3)
    normals, planarity, _ = estimate_normals_from_neighborhoods(neigh)
    return normals, planarity


def _initial_moved_host(X_mov: np.ndarray, obs) -> np.ndarray:
    """The movable cloud under the initial transform of the observed values
    ``obs`` (None: none), on the host in float64: the cloud the grid gate
    counts its cell cap on, as the JAX package does."""
    X = np.asarray(X_mov, np.float64)
    p = None if obs is None else _host_f64(obs)
    if p is None or not np.any(p):
        return X
    return X @ host_rotation(*p[:3]).T + p[3:6]


def _grid_with_cap(X: torch.Tensor, radius: float, cap: int, X_host=None):
    """The sorted grid of one cloud X (n, 3) at ``radius`` and its cell
    cap, resolved as the JAX package resolves it: ``cap`` when it is set;
    else, for a cloud that came as numpy (``X_host``, its points on the host),
    ``grid_cell_cap`` (counted in both dtypes, plus 4); else the occupancy
    counted on X's device, rounded up to a multiple of 8, in one host read.
    Returns (the ``build_sorted_grid`` 5-tuple, cap)."""
    if cap or X_host is not None:
        return (build_sorted_grid(X, radius),
                cap or grid_cell_cap(X_host, radius))
    grid, occupancy = grid_build_cap(X, radius)
    return grid, -(-int(read_array(occupancy)) // 8) * 8


def _match_grid(Xm: torch.Tensor, cfg: IcpConfig, mov_host=None):
    """The grid matcher's cell list over the untransformed movable cloud
    Xm (nm, 3) at the match radius (``match_radius``, else the gate's), and
    its cell cap (``_grid_with_cap``; ``mov_host``: the movable cloud when
    it came as numpy). Built once per registration; every iteration, and
    every chunk of a chunked run, queries it."""
    rm = cfg.match_radius if cfg.match_radius > 0 else cfg.max_overlap_distance
    X_host = None if cfg.match_cell_cap else mov_host
    return _grid_with_cap(Xm, rm, cfg.match_cell_cap, X_host)


def _make_match_fn(Q, Xm, cfg: IcpConfig, grid=None):
    """The per-iteration matcher of B pairs: match_fn(Ht (B, 4, 4)) ->
    (m_idx, m_t, m_orig, m_valid). The match kernel takes the untransformed
    clouds and Ht, one launch for the batch, so the moved clouds are never
    materialized; only the C matched rows of each are moved. The grid
    matcher (one pair; ``grid``: its ``_match_grid``, which the caller
    builds once) is ``_make_grid_match_fn``."""
    if cfg.match_method == "grid":
        return _make_grid_match_fn(Q, Xm, cfg, grid)

    def match_fn(Ht):
        _, m_idx = match_transform(Q, Xm, Ht)
        m_orig = _rows(Xm, m_idx)
        m_valid = torch.ones(m_idx.shape, dtype=torch.bool, device=m_idx.device)
        return m_idx, apply_H(m_orig, Ht), m_orig, m_valid

    return match_fn


def back_transform(q: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """R^T (q - t) of points q (n, 3) under a rigid H (4, 4): the query of
    the static-grid matcher, as explicit multiply-adds (no matrix product:
    TF32 never touches a coordinate)."""
    d = q - H[:3, 3]
    return torch.stack([(d[:, 0] * H[0, j] + d[:, 1] * H[1, j]) + d[:, 2] * H[2, j]
                        for j in range(3)], dim=-1)


def _make_grid_match_fn(Q, Xm, cfg: IcpConfig, grid):
    """The static-grid matcher of one pair (Q (1, C, 3), Xm (1, nm, 3)):
    ONE cell list over the untransformed movable cloud (``grid``, from
    ``_match_grid``) serves every iteration. Rigid motion preserves
    distances, so the nearest of the
    moved points H x to q is the nearest point x to H^-1 q = R^T (q - t).
    Exact within the match radius (``match_radius``, else the gate's):
    a row whose nearest point lies farther is dropped (``m_valid``) with
    index 0. With the linearized solver H is only nearly orthogonal, so
    near-ties can resolve otherwise than the brute matcher's."""
    rm = cfg.match_radius if cfg.match_radius > 0 else cfg.max_overlap_distance
    (g_pts, g_slots, g_order, g_origin, g_run_end), cap = grid
    r = torch.tensor(rm, dtype=Xm.dtype, device=Xm.device)
    q = Q[0]

    def match_fn(Ht):
        qb = back_transform(q, Ht[0])
        d2, pos = grid_query_sorted(qb, g_pts, g_slots, g_origin, r, cell_cap=cap,
                                    run_end=g_run_end)
        m_valid = d2 <= r * r
        m_idx = torch.where(m_valid, g_order[pos], 0).to(torch.int32)[None]
        m_orig = _rows(Xm, m_idx)
        return m_idx, apply_H(m_orig, Ht), m_orig, m_valid[None]

    return match_fn


def make_carry_init(cfg: IcpConfig, dtype, obs_vals, H0, error0) -> _Carry:
    """The loop-entry state of B pairs (iteration 0, nothing executed):
    obs_vals (B, 6), H0 (B, 4, 4), error0 the host int array (B,) of the
    error codes the pairs start from. The monolithic loop and
    ``_run_chunked`` start from it alike."""
    C = cfg.correspondences
    T = cfg.max_iterations
    dev = H0.device
    B = H0.shape[0]

    def full(shape, value, dt=dtype):
        return torch.full((B, *shape), value, dtype=dt, device=dev)

    auto_dw = cfg.distance_weights is None
    # Trajectory buffers hold max_iterations slots when recording, else one
    # (iteration 0 writes it, later writes fall outside and are dropped, as
    # the JAX package's scatter drops them).
    R = T if cfg.record_trajectory else 1
    return _Carry(
        it=0,
        go=bool(np.any(error0 == ERR_OK)),
        n_it=None if B == 1 else full((), 0, torch.int32),
        p=obs_vals.to(dtype),
        H=H0,
        dist_w=full((), 1.0 if auto_dw else cfg.distance_weights),
        converged=full((), False, torch.bool),
        error=torch.as_tensor(error0, dtype=torch.int32, device=dev),
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


def _keep_stopped(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """new where the pair is active, else old (active (B,) against (B, ...))."""
    return torch.where(active.view(-1, *[1] * (new.dim() - 1)), new, old)


def run_icp_loop(Q, normals, planarity, sel_valid, obs_vals, obs_w,
                 cfg: IcpConfig, dtype, error0, H0, match_fn,
                 mov_planarity_fn=None, carry_in=None, it_hi=None) -> _Carry:
    """The match -> reject -> solve -> converge iteration of B pairs at
    once: Q, normals (B, C, 3), planarity, sel_valid (B, C), obs_vals,
    obs_w (B, 6), H0 (B, 4, 4).

    ``match_fn(Ht) -> (m_idx, m_t, m_orig, m_valid)`` matches each pair
    against its movable cloud moved by its Ht; ``mov_planarity_fn(m_idx) ->
    (B, C)``, when given, is the
    matched movable points' planarity, gated like the fixed side's.
    ``error0`` is the host int array (B,) of error codes the pairs start
    from (ERR_NO_OVERLAP from the gate runs no iteration).

    The iterations run while any pair is active, as the JAX package's
    vmapped ``lax.while_loop`` does: a pair that has stopped (converged,
    failed, or never started) keeps its state bit for bit, its trajectory
    rows are not written, and its ``n_it`` is the step it stopped at. Every
    active pair is at the same iteration, so the iteration index and its
    ``it == 0`` branches stay host integers, and one flag is read per
    iteration for the whole batch. With one pair the loop ends when the
    pair stops, so nothing needs freezing and nothing is.

    Chunked dispatch: ``carry_in`` resumes from an earlier call's carry
    (``error0`` and ``H0`` are then unused), and ``it_hi`` stops after
    iteration it_hi - 1. The entry test stays the JAX package's, (it <
    min(it_hi, T)) & ~converged & (error == OK), read from the carry's
    ``go``: the flag read after a chunk's last iteration is the one the
    monolithic loop reads there, so K iterations a call compose to the
    monolithic loop bit for bit and with its host reads. The carry's
    buffers are updated in place: a caller keeps no reference to an
    earlier chunk's carry.

    Returns the final carry; the uncertainty estimate is the caller's
    (``_uncertainties`` of the final carry).
    """
    T = cfg.max_iterations
    B = Q.shape[0]
    auto_dw = cfg.distance_weights is None
    nonlinear = cfg.solver == "nonlinear"
    min_planarity = torch.tensor(cfg.min_planarity, dtype=dtype, device=Q.device)

    # Numerical noise floor of each pair's residual statistics: a mean/std
    # change at or below eps(dtype) * |coords| * scale counts as converged.
    noise_floor = (
        cfg.convergence_floor_scale * torch.finfo(dtype).eps
        * torch.abs(Q).amax(dim=(-2, -1))
    )

    def crit_met(new, old):
        return (pct_change(new, old) < cfg.min_change) | (
            torch.abs(new - old) <= noise_floor
        )

    def body(c: _Carry, active: Optional[torch.Tensor]) -> _Carry:
        with span("icp.match"):
            Ht = rbp_to_H(c.p) if nonlinear else c.H
            m_idx, m_t, m_orig, m_valid = match_fn(Ht)

        with span("icp.reject"):
            d = ((m_t - Q) * normals).sum(dim=-1)  # signed p2plane distances

            # "python": planarity gate first, median/MAD of the survivors;
            # "joint": median/MAD of all matches, both criteria jointly.
            matched = sel_valid & m_valid
            mask_p = matched & (planarity >= min_planarity)
            if mov_planarity_fn is not None:
                mask_p = mask_p & (mov_planarity_fn(m_idx) >= min_planarity)
            mad_base = matched if cfg.rejection_staging == "joint" else mask_p
            med = masked_median(d, mad_base)
            sigma = 3.0 * masked_mad(d, mad_base, scale=cfg.mad_scale)
            mask = mask_p & (torch.abs(d - med[:, None]) <= sigma[:, None])

            count = mask.sum(dim=-1).to(torch.int32)
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

        with span("icp.solve"):
            if nonlinear:
                p_new, residuals, gn_rel = gn_solve(
                    c.p, m_orig, Q, normals, mask, dw, obs_vals, obs_w,
                    n_steps=cfg.gn_iterations, active=active,
                )
                H_new = rbp_to_H(p_new)
            else:
                gn_rel = torch.zeros(B, dtype=dtype, device=Q.device)
                dH, residuals, _ = linearized_solve(m_t, Q, normals, mask)
                H_new = compose_H(dH, c.H)
                a1, a2, a3 = rotation_matrix_to_euler_angles(H_new)
                p_new = torch.cat([torch.stack([a1, a2, a3], dim=-1), H_new[:, :3, 3]], dim=-1)

        with span("icp.converge"):
            mean = masked_mean(residuals, mask)
            std = masked_std(residuals, mask, ddof=cfg.std_ddof)
            converged = crit_met(mean, c.prev_mean) & crit_met(std, c.prev_std)
            if c.it == 0:
                converged = torch.zeros_like(converged)

            # On error keep the previous state.
            bad = err != ERR_OK
            new = dict(
                p=torch.where(bad[:, None], c.p, p_new),
                H=torch.where(bad[:, None, None], c.H, H_new),
                dist_w=dw,
                converged=converged & ~bad,
                error=err,
                prev_mean=mean,
                prev_std=std,
                orig_count=orig_count,
                orig_mean=orig_mean,
                orig_std=orig_std,
                residuals=torch.where(bad[:, None], c.residuals, residuals),
                residual_mask=torch.where(bad[:, None], c.residual_mask, mask),
                m_idx=torch.where(bad[:, None], c.m_idx, m_idx),
            )
            rows = {"iter_counts": count, "iter_means": mean, "iter_stds": std,
                    "iter_gn": gn_rel}
            if c.it < c.iter_ps.shape[1]:
                rows.update(iter_ps=new["p"], iter_midx=m_idx, iter_masks=mask, iter_dists=d)
            if active is not None:
                # A pair that has stopped keeps its state and its buffers' rows.
                new = {k: _keep_stopped(active, v, getattr(c, k)) for k, v in new.items()}
                rows = {k: _keep_stopped(active, v, getattr(c, k)[:, c.it])
                        for k, v in rows.items()}
                new["n_it"] = c.n_it + active.to(torch.int32)
            # The buffers are this loop's own; they are updated in place.
            for k, v in rows.items():
                getattr(c, k)[:, c.it] = v
            return c._replace(it=c.it + 1, **new)

    if carry_in is None:
        c = make_carry_init(cfg, dtype, obs_vals, H0, error0)
        active = None if B == 1 else torch.as_tensor(error0 == ERR_OK, device=Q.device)
    else:
        c = carry_in
        active = None if B == 1 else ~c.converged & (c.error == ERR_OK)
    hi = T if it_hi is None else min(it_hi, T)
    # The JAX loop tests (it < hi) & ~converged & (error == OK) before every
    # iteration, the first included, for each pair.
    go = c.go
    while go and c.it < hi:
        with span("icp.iteration"):
            c = body(c, active)
            if c.it < T:
                stopped = c.converged | (c.error != ERR_OK)
                if active is not None:
                    active = ~stopped
                    stopped = stopped.all()
                go = not read_flag(stopped)
    return c._replace(go=go)


def _uncertainties(c: _Carry, Q, normals, obs_vals, obs_w, gather_fn):
    """The a-posteriori (uncertainties, covariance) of a final carry, on its
    last iteration's matches."""
    return estimate_uncertainties(
        c.p, gather_fn(c.m_idx), Q, normals, c.residual_mask,
        c.dist_w, obs_vals, obs_w,
    )


def _result_from_carry(c: _Carry, uncertainties, covariance, sel_idx,
                       sel_valid, normals, planarity) -> IcpResult:
    """The IcpResult of B pairs, each field with its leading pair axis."""
    n_it = (torch.tensor([c.it], dtype=torch.int32, device=c.H.device)
            if c.n_it is None else c.n_it)
    return IcpResult(
        H=c.H,
        p=c.p,
        uncertainties=uncertainties,
        covariance=covariance,
        n_iterations=n_it,
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


def _first(t):
    """The only pair of a one-pair batch: a tuple of tensors (IcpResult,
    _Carry) with each tensor's pair axis dropped."""
    return type(t)(*(v[0] if isinstance(v, torch.Tensor) else v for v in t))


def resolve_match_method(cfg: IcpConfig, n_queries: int, n_mov: int) -> IcpConfig:
    """The configuration with ``match_method="auto"`` resolved, as the JAX
    package resolves it: "grid" when the brute matcher's pairs an iteration
    (``n_queries * n_mov``) exceed ``MATCH_AUTO_PAIR_BUDGET`` and a radius
    is set (``match_radius`` or the overlap gate's), else "brute". An
    explicit method is kept."""
    if cfg.match_method != "auto":
        return cfg
    has_radius = cfg.match_radius > 0 or cfg.overlap_enabled
    big = n_queries * n_mov > MATCH_AUTO_PAIR_BUDGET
    return dataclasses.replace(cfg, match_method="grid" if (big and has_radius) else "brute")


def _resolve_engines(cfg: IcpConfig, nf: int, nm: int) -> IcpConfig:
    """The configuration with its matcher and gate resolved as the JAX
    package resolves them; the dispatch is the planner's
    (``_plan_dispatch``). (``approx_knn`` runs the exact k-NN, as the JAX
    package does off the TPU.)"""
    cfg = resolve_match_method(cfg, cfg.correspondences, nm)
    gate = cfg.gate_method
    if cfg.overlap_enabled and gate == "auto" and nf * nm <= GATE_AUTO_BRUTE_PAIRS:
        gate = "brute"
    # "dilate", and "auto" above 2^40 pairs, are resolved by the plan
    # (_resolve_gate), which needs the transformed cloud's bounding box.
    return dataclasses.replace(cfg, gate_method=gate)


def _resolve_gate(cfg: IcpConfig, nf: int, nm: int, bbox_fn):
    """(method, dilate plan or None) of an enabled gate whose method
    ``_resolve_engines`` resolved, as the JAX package resolves it: "brute"
    and "grid" stay; "dilate", and "auto" (above 2^40 pairs), plan the
    dilate gate over the bounding box ``bbox_fn()`` gives ((2, 3) lo/hi
    rows, read from the device once). Without a plan, "dilate" raises the
    JAX package's ValueError and "auto" becomes the brute gate up to 2^41
    pairs and the grid gate above."""
    gate = cfg.gate_method
    if gate in ("brute", "grid"):
        return gate, None
    lo, hi = bbox_fn()
    plan = plan_dilate_gate(None, None, cfg.max_overlap_distance, bbox=(lo, hi))
    if plan is not None:
        return "dilate", plan
    if gate == "dilate":
        raise ValueError(
            "gate_method='dilate' needs a dense cell grid over the "
            "joint bounding box; this cloud pair exceeds the cell "
            "budget — use 'grid' or 'auto'."
        )
    return ("grid" if nf * nm > GATE_AUTO_GRID_PAIRS else "brute"), None


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.array(x), dtype=dtype, device=device).contiguous()


def _host_f64(x) -> np.ndarray:
    """A parameter vector (numpy, sequence or tensor) as a float64 array on
    the host; a tensor's read is counted."""
    if isinstance(x, torch.Tensor):
        return read_array(x.detach()).astype(np.float64)
    return np.asarray(x, np.float64)


def _dtype_name(dtype) -> str:
    """A torch or numpy dtype by its numpy name ("float32"), as the JAX
    package's messages print it."""
    return str(dtype).removeprefix("torch.")


def _user_normals(normals_fix, planarity_fix, nf: int, dtype, dev):
    """The user's per-point normals and planarity (ones when not given) as
    tensors on ``dev``."""
    normals = _as_tensor(normals_fix, dtype, dev)
    planarity = (torch.ones(nf, dtype=dtype, device=dev) if planarity_fix is None
                 else _as_tensor(planarity_fix, dtype, dev))
    return normals, planarity


def plan_warm_start(
    X_fix,
    X_mov,
    cfg: IcpConfig,
    *,
    rbp_observed_values=None,
    rbp_observation_weights=None,
    normals_fix=None,
    planarity_fix=None,
    planarity_mov=None,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
):
    """Coarse-to-fine warm start, as in the JAX package.

    A cheap registration of stride-subsampled clouds (the same geometry)
    lands the parameters near the optimum, and its result becomes the full
    run's initial values (zero-weight observations, which also move the
    overlap gate's initial transform), so the full run spends its
    iterations on refinement. Clouds at or below ``warm_start_points`` skip
    the coarse pass. The strides are ceil(n / warm_start_points); the
    coarse pass selects min(correspondences, warm_start_correspondences)
    points, matches by brute force with no radius, resolves its gate with
    "auto", and widens the gate radius by sqrt(max stride), the growth of a
    subsampled surface's point spacing. Tensors are sliced where they lie:
    the coarse pass runs on strided views of the clouds (and of
    ``normals_fix``, ``planarity_fix`` and ``planarity_mov``), so nothing
    is copied to the host. Only a converged coarse result is adopted;
    frozen (inf-weight) parameters keep the user's values.

    Raises ValueError on finite-weight observations: the warm start
    replaces initial values, and such an observation is part of the
    objective.

    Returns (cfg with warm_start cleared, the possibly updated
    rbp_observed_values).
    """
    w_np = (np.zeros(6) if rbp_observation_weights is None
            else _host_f64(rbp_observation_weights))
    if np.any((w_np > 0) & np.isfinite(w_np)):
        raise ValueError(
            "warm_start cannot be combined with finite-weight rbp "
            "observations: the warm start replaces the parameters' "
            "INITIAL values, and a finite observation weight makes the "
            "observed value part of the objective. Freeze parameters "
            "with weight=inf, or disable warm_start."
        )
    cfg = dataclasses.replace(cfg, warm_start=False)

    def sliceable(x):
        return x if hasattr(x, "shape") else np.asarray(x)

    Xf_s, Xm_s = sliceable(X_fix), sliceable(X_mov)
    nf, nm = Xf_s.shape[0], Xm_s.shape[0]
    n_ws = cfg.warm_start_points
    if max(nf, nm) <= n_ws:
        return cfg, rbp_observed_values
    sf, sm = -(-nf // n_ws), -(-nm // n_ws)
    mod_ws = cfg.max_overlap_distance
    if math.isfinite(mod_ws) and mod_ws > 0:
        mod_ws = mod_ws * float(max(sf, sm)) ** 0.5
    ws_cfg = dataclasses.replace(
        cfg,
        correspondences=min(cfg.correspondences, cfg.warm_start_correspondences),
        match_method="brute", match_radius=0.0, match_cell_cap=0,
        ref_tile=0, grid_cell_cap=0, gate_method="auto",
        max_overlap_distance=mod_ws,
    )

    def strided(x, s):
        return None if x is None else sliceable(x)[::s]

    res = icp_register(
        Xf_s[::sf], Xm_s[::sm], ws_cfg,
        rbp_observed_values=rbp_observed_values,
        rbp_observation_weights=rbp_observation_weights,
        normals_fix=strided(normals_fix, sf),
        planarity_fix=strided(planarity_fix, sf),
        planarity_mov=strided(planarity_mov, sm),
        device=device, dtype=dtype,
    )
    # One host read: the flags the decision needs and the coarse parameters
    # (float64 holds both dtypes' values exactly).
    vals = read_array(torch.cat([
        torch.stack([res.error_code.double(), res.converged.double(),
                     res.n_iterations.double()]),
        res.p.double(),
    ]))
    error, converged, n_it = int(vals[0]), bool(vals[1]), int(vals[2])
    log = logging.getLogger(__name__)
    if error == ERR_OK and converged:
        obs_np = (np.zeros(6) if rbp_observed_values is None
                  else _host_f64(rbp_observed_values))
        rbp_observed_values = np.where(np.isinf(w_np), obs_np, vals[3:])
        log.info(
            "warm start: coarse registration on %d x %d subsampled "
            "points, %d iterations, converged=True",
            -(-nf // sf), -(-nm // sm), n_it,
        )
    elif error == ERR_OK:
        # A coarse pass still drifting at max_iterations can seed the full
        # run farther from the basin than a cold start.
        log.warning(
            "warm start: coarse registration did not converge in %d "
            "iterations — starting cold", n_it
        )
    else:
        log.warning(
            "warm start: coarse registration failed with error "
            "code %d — starting cold", error
        )
    return cfg, rbp_observed_values


# ---------------------------------------------------------------- dispatch

_log = logging.getLogger(__name__)


class DispatchPlan(NamedTuple):
    """How one registration runs: ``dispatch`` "monolithic" or "chunked",
    with ``chunk_iterations`` iterations a call; the normals k-NN in query
    blocks of ``knn_block`` rows (0: one call) and, with ``knn_grid``,
    through the grid k-NN cascade first. Every plan gives the same result
    bit for bit."""

    dispatch: str
    chunk_iterations: int
    knn_block: int = 0
    knn_grid: bool = False


def _knn_block_rows(budget: float, knn_s: float, C: int) -> int:
    """Rows of one k-NN query block of about half the budget, as the JAX
    package sizes them: a multiple of 2048, at least 2048, at most C
    rounded up to 2048."""
    rows_per_budget = (budget * 0.5) / max(knn_s, 1e-9) * C
    knn_block = max(2048, int(rows_per_budget) // 2048 * 2048)
    return min(knn_block, -(-C // 2048) * 2048)


def _plan_dispatch(cfg: IcpConfig, nf: int, nm: int, *, guarded: bool,
                   has_normals: bool, gate_pairs: float,
                   warm_requested: bool = False, obs=(None, None)) -> DispatchPlan:
    """The dispatch plan of one registration, the JAX package's planner
    with the card's rates (``device_policy.estimate_gpu_stage_seconds``).

    ``guarded`` (``program_budget_s`` > 0 and the clouds on the card):
    a registration estimated within the budget runs monolithic; above it,
    "auto" runs chunked, K iterations a call from half the budget, the
    normals k-NN in query blocks when the prologue would exceed 0.9 of the
    budget, and through the grid k-NN cascade when the k-NN alone exceeds
    half of it. A configuration whose largest indivisible step (the gate
    with the grid build, one iteration, one 2048-row k-NN block) exceeds
    0.9 of the budget raises ValueError, and so does an explicit
    "monolithic" over the budget. ``cfg`` carries the grid matcher's
    resolved cell cap; ``gate_pairs`` are the brute gate's pairs (0 for
    the dilate and grid gates, and for "auto" above 2^40 pairs, which
    resolves to one of them where a grid fits). Unguarded, "auto" is
    monolithic and an explicit "chunked" without K takes 8 iterations a
    call. ``obs`` (the observed values and weights) only silence the
    warm-start hint."""
    dispatch, chunk_k = cfg.dispatch, cfg.chunk_iterations
    if not guarded:
        return DispatchPlan("monolithic" if dispatch == "auto" else dispatch,
                            chunk_k or 8)
    budget = cfg.program_budget_s
    C = cfg.correspondences
    gate_s, knn_s, build_s, per_iter_s = device_policy.estimate_gpu_stage_seconds(
        nf, nm, correspondences=C, neighbors=cfg.neighbors, gate_pairs=gate_pairs,
        match_method=cfg.match_method, match_cell_cap=cfg.match_cell_cap,
        has_normals=has_normals,
    )
    # the monolithic run goes up to max_iterations; price the typical
    # converged count (healthy runs finish in about 10)
    est = gate_s + knn_s + build_s + min(10, cfg.max_iterations) * per_iter_s
    knn_atom_s = min(knn_s, knn_s * 2048.0 / max(C, 1))
    atom_s = max(gate_s + build_s, per_iter_s, knn_atom_s)
    if atom_s > budget * 0.9:
        raise ValueError(
            f"this configuration is estimated at ~{atom_s:.3g} s of card time "
            f"for its largest indivisible step (gate ~{gate_s:.3g} s, grid "
            f"build ~{build_s:.3g} s, ~{per_iter_s:.3g} s per iteration): even "
            f"chunked dispatch would exceed program_budget_s={budget:g}. "
            "Reduce `correspondences`, set a small `match_radius` (the grid "
            "matcher's cells shrink with it), run on device='cpu', or raise "
            "or disable (0) program_budget_s."
        )
    if dispatch == "monolithic" and est > budget:
        raise ValueError(
            f"this configuration is estimated at ~{est:.3g} s of card time in "
            f"one monolithic run, over program_budget_s={budget:g}. Use "
            "dispatch='auto' or 'chunked' (the same result in bounded "
            "chunks), reduce `correspondences`, or raise or disable (0) "
            "program_budget_s."
        )
    if dispatch == "auto":
        dispatch = "monolithic" if est <= budget else "chunked"
    knn_block, knn_grid = 0, False
    if dispatch == "chunked":
        if chunk_k == 0:
            # half the budget a chunk
            chunk_k = max(1, int((budget * 0.5) / max(per_iter_s, 1e-9)))
        if gate_s + build_s + knn_s > budget * 0.9:
            knn_block = _knn_block_rows(budget, knn_s, C)
            knn_grid = knn_s > budget * 0.5
    _log.info(
        "dispatch plan: %s (est %.1f s = gate %.1f + knn %.1f + build "
        "%.1f + %.2f s/iter%s%s; budget %g s)",
        dispatch, est, gate_s, knn_s, build_s, per_iter_s,
        f", K={chunk_k}" if dispatch == "chunked" else "",
        f", knn_block={knn_block}" if knn_block else "", budget,
    )
    if (dispatch == "chunked" and not warm_requested and per_iter_s > 1.0
            and all(v is None or not np.any(_host_f64(v)) for v in obs)):
        # Iterations dominate this run's cost; a coarse-to-fine seed
        # usually removes about half of them.
        _log.info(
            "hint: this registration runs ~%.1f s per full-resolution "
            "iteration; warm_start=True (coarse-to-fine) typically "
            "halves the iteration count at identical convergence "
            "basin.", per_iter_s,
        )
    return DispatchPlan(dispatch, chunk_k, knn_block, knn_grid)


# Certificate margin of the grid k-NN cascade (knn_query_sorted's default).
_KNN_CERT_MARGIN = 1e-3
# Queries of the cascade's radius sample, and the fewest queries the
# cascade takes on (below, the dense k-NN alone is cheap).
_KNN_SAMPLE = 1024
_KNN_GRID_MIN_QUERIES = 4096


def _knn_cascade_radius(d2_sample: np.ndarray, r_hi: float) -> float:
    """The round-1 radius of the cascaded grid k-NN, from the sampled k-th
    neighbour's squared distances.

    A radius sized by the sample's maximum certifies about every query in
    one pass, but every query then pays 27 * cap(r_hi) candidates, and the
    cap grows about with r^3, so one distant outlier inflates the cost of
    all. Round 1 runs at a quantile radius r_q instead, and only the
    uncertified tail runs again at r_hi; under the cap(r) ~ r^3 model the
    relative cost is

        cost(q) ~ (r_q / r_hi)^3 + fail(q)

    with fail(q) estimated from the same sample. Returns the radius of the
    least cost (r_hi when one round is already the cheapest, as for tight
    unimodal spacing)."""
    best_r, best_cost = r_hi, 1.0
    for q in (0.5, 0.75, 0.9):
        rq = 1.25 * float(np.sqrt(np.quantile(d2_sample, q)))
        if rq <= 0.0:
            continue
        fail = float(np.mean(d2_sample > ((1.0 - _KNN_CERT_MARGIN) * rq) ** 2))
        cost = (rq / r_hi) ** 3 + fail
        if cost < best_cost:
            best_r, best_cost = rq, cost
    return best_r


def _dense_knn_rows(Q: torch.Tensor, Xf: torch.Tensor, cfg: IcpConfig):
    """Normals (n, 3) and planarity (n,) of the queries Q (n, 3) from their
    dense k-NN in Xf (nf, 3): ``_normals_stage`` on a batch of one. Each
    row depends on its query alone, so any split of the queries gives the
    same rows bit for bit."""
    normals, planarity = _normals_stage(Q[None], Xf[None], None, None, None, cfg=cfg)
    return normals[0], planarity[0]


def _dense_knn_blocks(Q: torch.Tensor, Xf: torch.Tensor, cfg: IcpConfig,
                      knn_block: int):
    """The normals of the queries Q (C, 3) as dense k-NN query blocks of
    ``knn_block`` rows (0: one block), one k-NN launch each."""
    blk = knn_block or Q.shape[0]
    parts = [_dense_knn_rows(Q[s:s + blk], Xf, cfg) for s in range(0, Q.shape[0], blk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _grid_knn_rows(Q: torch.Tensor, Xf: torch.Tensor, grid, radius: float,
                   cfg: IcpConfig):
    """Normals, planarity and certificate of the queries Q (n, 3) from the
    grid k-NN (``knn_query_sorted``) of ``grid`` (``_grid_with_cap`` of Xf
    at ``radius``). A certified row's neighbours are the dense k-NN's, so
    its normal is the dense one bit for bit."""
    (pts, slots, order, origin, run_end), cap = grid
    _, ik, cert = knn_query_sorted(Q, pts, slots, order, origin, radius, cfg.neighbors,
                                   cell_cap=cap, run_end=run_end,
                                   cert_margin=_KNN_CERT_MARGIN)
    # A row with fewer than k candidates holds the padding index 2^31 - 1;
    # it is uncertified, and gathers the last point as the JAX package's
    # clamped gather does.
    ik = torch.clamp(ik, max=Xf.shape[0] - 1)
    normals, planarity, _ = estimate_normals_from_neighborhoods(_rows(Xf[None], ik[None]))
    return normals[0], planarity[0], cert


def _knn_grid_normals(Q: torch.Tensor, Xf: torch.Tensor, cfg: IcpConfig,
                      knn_block: int):
    """The normals of the queries Q (C, 3) through the certified grid k-NN
    cascade, the JAX package's, priced with the card's rates:

      1. the k-th neighbour's squared distance of 1024 strided queries (one
         k-NN launch, one host read) gives the guaranteed radius r_hi =
         1.25 * its maximum and a cheaper round-1 radius r
         (``_knn_cascade_radius``);
      2. the cell list over the fixed cloud at r and its exact cell cap
         (one host read);
      3. round 1: the grid k-NN of every query at r, with each row's
         exactness certificate (one host read: the uncertified rows);
      4. round 2: the uncertified rows again through a second grid at
         r_hi, when that is priced cheaper than the dense patch;
      5. rows still uncertified: the dense k-NN in blocks of ``knn_block``
         rows, patched in on the device.

    Every row equals the dense k-NN's normal bit for bit: certified rows
    by the certificate, patched rows by construction. Returns (normals,
    planarity), or (None, None) when the grid plan is uneconomical (fewer
    than 4096 queries, a degenerate radius, or candidates priced above
    the dense k-NN); the caller then runs dense blocks."""
    C = Q.shape[0]
    if C < _KNN_GRID_MIN_QUERIES:
        return None, None
    k = cfg.neighbors
    # C >= 4096: the strided sample holds 1024 queries
    Qs = Q[::max(1, C // _KNN_SAMPLE)][:_KNN_SAMPLE].contiguous()
    d2_last = read_array(knn_search(Qs, Xf, k)[0][:, -1])
    d2_ok = d2_last[np.isfinite(d2_last)]
    d2_max = float(np.max(d2_ok, initial=0.0))
    if d2_max <= 0.0:
        return None, None
    r_hi = 1.25 * float(np.sqrt(d2_max))
    r = _knn_cascade_radius(d2_ok, r_hi)
    grid = _grid_with_cap(Xf, r, 0)
    cap = grid[1]
    # economics: candidate gathers against the dense k-NN (the round-2 tail
    # priced by the cube-model cap at r_hi)
    gather_rate = device_policy.GPU_GATHER_ELEMS_PER_SEC
    knn_rate = device_policy.GPU_KNN10_PAIRS_PER_SEC * 10.0 / k
    exp_fail = (float(np.mean(d2_ok > ((1.0 - _KNN_CERT_MARGIN) * r) ** 2))
                if r < r_hi else 0.0)
    cap_hi_est = cap * (r_hi / r) ** 3
    grid_cost = C * 27.0 * (cap + exp_fail * cap_hi_est) * 3.0 / gather_rate
    dense_cost = float(C) * Xf.shape[0] / knn_rate
    if grid_cost > min(dense_cost, max(cfg.program_budget_s, 30.0) * 0.9):
        return None, None

    normals, planarity, cert = _grid_knn_rows(Q, Xf, grid, r, cfg)
    failed = read_nonzero(~cert)
    n_failed = failed.shape[0]
    _log.debug("grid-kNN prologue: r=%.6g, r_hi=%.6g, cap %d: %d/%d certified at r",
               r, r_hi, cap, C - n_failed, C)
    if n_failed and r < r_hi:
        # Round 2 against the dense patch, priced as the JAX package prices
        # both (its blocks padded to a power of two of at least 512 rows),
        # so that both packages take the same branch: the r_hi grid's cap
        # grows with the cell volume, so a long tail can be cheaper dense.
        blk2_est = max(512, 1 << (n_failed - 1).bit_length())
        regrid_est = (Xf.shape[0] / device_policy.GPU_SORT_ELEMS_PER_SEC
                      + blk2_est * 27.0 * cap_hi_est * 3.0 / gather_rate)
        blk_cap = knn_block if knn_block > 0 else C
        dense_rows = sum(max(512, 1 << (min(blk_cap, n_failed - s) - 1).bit_length())
                         for s in range(0, n_failed, blk_cap))
        dense_est = dense_rows * float(Xf.shape[0]) / knn_rate
        if dense_est < regrid_est:
            _log.info(
                "grid-kNN prologue: %d/%d uncertified at r=%.4g -> dense "
                "patch directly (priced %.1f s vs %.1f s regrid)",
                n_failed, C, r, dense_est, regrid_est,
            )
            r = r_hi  # the dense patch takes the tail
    if n_failed and r < r_hi:
        _log.info(
            "grid-kNN prologue: %d/%d uncertified at r=%.4g -> regrid at "
            "r_hi=%.4g", n_failed, C, r, r_hi,
        )
        nb, pb, cb = _grid_knn_rows(Q[failed], Xf, _grid_with_cap(Xf, r_hi, 0), r_hi, cfg)
        normals[failed] = torch.where(cb[:, None], nb, normals[failed])
        planarity[failed] = torch.where(cb, pb, planarity[failed])
        failed = failed[read_nonzero(~cb)]
        n_failed = failed.shape[0]
    if n_failed:
        _log.info(
            "grid-kNN prologue: %d/%d uncertified rows -> dense recompute",
            n_failed, C,
        )
        blk_cap = knn_block if knn_block > 0 else C
        for s in range(0, n_failed, blk_cap):
            rows = failed[s:s + blk_cap]
            normals[rows], planarity[rows] = _dense_knn_rows(Q[rows], Xf, cfg)
    return normals, planarity


def _synced(t: torch.Tensor) -> torch.Tensor:
    """t, after the device has finished it (for a timing line)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t


def _knn_normals(Q: torch.Tensor, Xf: torch.Tensor, cfg: IcpConfig,
                 knn_block: int = 0, knn_grid: bool = False):
    """The normals and planarity of one pair's selected points Q (1, C, 3)
    in its fixed cloud Xf (nf, 3), as the plan splits them: the grid k-NN
    cascade first with ``knn_grid``, else (or when it is uneconomical)
    dense blocks of ``knn_block`` rows; with neither, one k-NN call. Bit
    for bit the same every way."""
    if not (knn_block or knn_grid):
        return _normals_stage(Q, Xf[None], None, None, None, cfg=cfg)
    dbg = _log.isEnabledFor(logging.DEBUG)
    normals = planarity = None
    if knn_grid:
        t0 = time.perf_counter()
        normals, planarity = _knn_grid_normals(Q[0], Xf, cfg, knn_block)
        if dbg:
            if normals is not None:
                _synced(normals)
            _log.debug("timing: chunked prologue grid-kNN normals %.2f s%s",
                       time.perf_counter() - t0,
                       "" if normals is not None else " (uneconomical, fallback)")
    if normals is None:
        t0 = time.perf_counter()
        normals, planarity = _dense_knn_blocks(Q[0], Xf, cfg, knn_block)
        if dbg:
            _synced(normals)
            _log.debug("timing: chunked prologue dense-kNN blocks %.2f s",
                       time.perf_counter() - t0)
    return normals[None], planarity[None]


# Stall check of chunked dispatch: a chunk whose wall time exceeds
# _STALL_FACTOR times its estimate plus _STALL_SLACK_S (estimates above
# _STALL_MIN_EST_S only; shorter chunks are launch-bound) is reported as a
# degraded window (a throttled or shared card). stall_policy="wait" then
# holds the next chunk until a fresh-shape probe subprocess answers within
# _STALL_WAIT_PROBE_TIMEOUT_S, retrying every _STALL_WAIT_SLEEP_S for up to
# _STALL_WAIT_BUDGET_S before it proceeds into the window. The JAX
# package's values.
_STALL_FACTOR = 4.0
_STALL_SLACK_S = 5.0
_STALL_MIN_EST_S = 0.5
_STALL_WAIT_PROBE_TIMEOUT_S = 120.0
_STALL_WAIT_SLEEP_S = 30.0
_STALL_WAIT_BUDGET_S = 1800.0


def _chunk_per_iter_estimate(cfg: IcpConfig, nf: int, nm: int,
                             has_normals: bool, device: torch.device) -> float:
    """Estimated card seconds of one iteration, for the stall check: 0.0
    for a run on the CPU (no check there). Module-level, so that tests can
    monkeypatch an estimate and drive the stall paths on the CPU."""
    if device.type != "cuda":
        return 0.0
    return device_policy.estimate_gpu_stage_seconds(
        nf, nm, correspondences=cfg.correspondences, neighbors=cfg.neighbors,
        match_method=cfg.match_method, match_cell_cap=cfg.match_cell_cap,
        has_normals=has_normals,
    )[3]


def _wait_for_healthy_window(log) -> float:
    """stall_policy="wait": block until the card answers a fresh-shape
    probe (``device_policy.probe_default_backend``, a subprocess, so a hung
    card cannot hang this process), or until the wait budget runs out.
    Returns the seconds waited. The carry stays on the card untouched, so
    waiting changes no result."""
    t0 = time.monotonic()
    deadline = t0 + _STALL_WAIT_BUDGET_S
    attempt = 0
    while True:
        attempt += 1
        status, _backend, psec = device_policy.probe_default_backend(
            _STALL_WAIT_PROBE_TIMEOUT_S)
        log.info("stall probe %d: %s in %.1f s", attempt, status, psec)
        if status == "ok":
            return time.monotonic() - t0
        # the next attempt's sleep and probe must fit the budget too
        if time.monotonic() + _STALL_WAIT_SLEEP_S + _STALL_WAIT_PROBE_TIMEOUT_S >= deadline:
            log.warning(
                "stall_policy='wait': no healthy probe within the %.0f s "
                "budget; proceeding into the degraded window.",
                _STALL_WAIT_BUDGET_S,
            )
            return time.monotonic() - t0
        time.sleep(_STALL_WAIT_SLEEP_S)


def _run_chunked(c: _Carry, chunk_iters: int, run_chunk, *, cfg: IcpConfig,
                 per_iter_est: float) -> _Carry:
    """Chunked dispatch of the ICP loop: ``run_chunk(carry, it_hi)`` runs
    the loop from the carry up to iteration it_hi, K = ``chunk_iters`` at a
    time, until the loop's entry test fails or max_iterations is reached.
    The carry stays on the device; the chunk's end is read from the flag
    the loop reads anyway (no extra host read). After each chunk but the
    first, the stall check compares its wall time with ``per_iter_est``
    seconds an iteration (0: no check) and acts on ``cfg.stall_policy``.
    Returns the final carry."""
    T = cfg.max_iterations
    K = max(1, int(chunk_iters))
    stall_wait_total = 0.0
    first_chunk = True
    while True:
        it_before = c.it
        t0 = time.perf_counter()
        c = run_chunk(c, min(T, it_before + K))
        done = not c.go or c.it >= T
        chunk_wall = time.perf_counter() - t0
        n_ran = max(c.it - it_before, 1)
        _log.debug("timing: chunk iterations %d-%d %.2f s", it_before, c.it, chunk_wall)
        est = n_ran * per_iter_est
        if (per_iter_est > 0 and est > _STALL_MIN_EST_S and not first_chunk
                and chunk_wall > _STALL_FACTOR * est + _STALL_SLACK_S):
            # the first chunk is left out: it carries the process's first
            # launches and kernel loads
            if cfg.stall_policy == "wait":
                action = ("Holding the next chunk until a probe answers "
                          "healthy (stall_policy='wait')." if not done else
                          "Final chunk — nothing left to hold "
                          "(stall_policy='wait').")
            else:
                action = "The run continues and stays correct (stall_policy='warn')."
            _log.warning(
                "chunk of %d iterations took %.1f s against an estimate of "
                "%.1f s (%.0fx) — the card is likely throttled or shared (a "
                "degraded window). %s Wall times measured now are not "
                "representative.",
                n_ran, chunk_wall, est, chunk_wall / max(est, 1e-9), action,
            )
            if cfg.stall_policy == "wait" and not done:
                waited = _wait_for_healthy_window(_log)
                stall_wait_total += waited
                _log.warning(
                    "stall_policy='wait': held dispatch %.0f s (cumulative "
                    "stall-wait %.0f s this run); resuming at iteration %d "
                    "with the carry on the card.",
                    waited, stall_wait_total, c.it,
                )
        first_chunk = False
        if done:
            break
    if stall_wait_total > 0:
        _log.warning(
            "registration finished; total stall-wait %.0f s across degraded "
            "windows (stall_policy='wait').", stall_wait_total,
        )
    return c


class FixedPrep(NamedTuple):
    """The fixed cloud's share of an ungated registration, computed once
    (``prepare_fixed``) for any number of registrations against it
    (``icp_register(..., fixed_prep=prep)``): the serving path that
    localises many scans against one fixed map.

    Without an overlap gate the selection and the normals at the selected
    points depend only on the fixed cloud and the config. Pass the same
    fixed cloud, and a config with equal correspondences, neighbors and
    approx_knn and no gate, to the consuming calls, in the preparation's
    dtype and on its device: a mismatch raises. The fields and the npz
    format of ``save`` are the JAX package's, so a file written by either
    package loads in the other."""

    Q: torch.Tensor          # (C,3) selected fixed points
    normals: torch.Tensor    # (C,3) normals at Q
    planarity: torch.Tensor  # (C,) planarity at Q
    sel_idx: torch.Tensor    # (C,) int32 indices into the fixed cloud
    sel_valid: torch.Tensor  # (C,) bool validity (nf < C padding)
    n_fix: int               # fixed-cloud row count (consistency check)
    correspondences: int     # cfg fingerprint: selection count
    neighbors: int           # cfg fingerprint: k of the normals' k-NN
    approx_knn: bool         # cfg fingerprint

    def save(self, path) -> None:
        """Write an ``.npz`` with the keys, dtypes and layout of the JAX
        package's ``FixedPrep.save``, so that a deployment prepares once
        offline and loads the file with ``load_fixed_prep`` at start-up.
        Bit-exact."""
        def host(t):
            return t.detach().cpu().numpy()

        np.savez(
            path, Q=host(self.Q), normals=host(self.normals),
            planarity=host(self.planarity), sel_idx=host(self.sel_idx),
            sel_valid=host(self.sel_valid),
            meta=np.asarray([self.n_fix, self.correspondences,
                             self.neighbors, int(self.approx_knn)], np.int64),
        )


def load_fixed_prep(path, *, device: Union[str, torch.device, None] = None
                    ) -> FixedPrep:
    """Load a ``FixedPrep.save`` file (of either package) onto ``device``
    (the card by default, an error without one), in the file's dtype. A
    preparation is dtype-bound: a float64 file consumed by a float32
    registration raises there, it is never rounded."""
    dev = resolve(device, None)[0]
    with np.load(path) as z:
        arrays = [torch.as_tensor(z[k], device=dev)
                  for k in ("Q", "normals", "planarity", "sel_idx", "sel_valid")]
        meta = z["meta"]
    return FixedPrep(*arrays, int(meta[0]), int(meta[1]), int(meta[2]),
                     bool(meta[3]))


def prepare_fixed(
    X_fix,
    cfg: IcpConfig = IcpConfig(),
    *,
    normals_fix=None,
    planarity_fix=None,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
) -> FixedPrep:
    """Compute the movable-independent stages of an ungated registration
    once for a fixed cloud: the fixed-count selection and the normals and
    planarity at the selected points.

    The overlap gate must be off (``max_overlap_distance`` inf or
    negative): a gated selection depends on the movable cloud. The
    selection is the same host formula ``icp_register`` uses, and the
    normals come from the same stage (``_normals_stage``): one launch of
    the k-NN kernel over all ``correspondences`` queries on the card, or
    the user's normals gathered at the selection. So a registration with
    the preparation equals the self-contained one bit for bit. On the card
    the k-NN is priced against ``program_budget_s`` as the JAX package
    prices it (``device_policy`` card rates): above 0.9 of the budget it
    runs in query blocks, above half of it through the grid k-NN cascade
    first (``_knn_grid_normals``), and a single 2048-row block over 0.9 of
    the budget raises ValueError. Blocks and cascade are exact, so the
    preparation is the same bit for bit.

    Args:
        X_fix: (nf, 3) fixed cloud; the same cloud goes to the consuming
            ``icp_register`` calls.
        cfg: the config of the consuming registrations (correspondences,
            neighbors and approx_knn are fingerprinted and checked at use).
        normals_fix / planarity_fix: optional (nf, 3) normals and (nf,)
            planarity of the whole fixed cloud, gathered at the selection
            instead of the k-NN (planarity defaults to ones).
        device: "cuda" by default (raises without a card); "cpu" runs the
            plain versions.
        dtype: float32 by default; the consuming calls must use the same.

    Returns:
        FixedPrep of tensors on ``device``.
    """
    if cfg.overlap_enabled:
        raise ValueError(
            "prepare_fixed requires the overlap gate disabled "
            "(max_overlap_distance=inf/negative): a gated selection "
            "depends on the movable cloud and cannot be precomputed"
        )
    dev, dtype = resolve(device, dtype)
    Xf = _as_tensor(X_fix, dtype, dev)
    if Xf.dim() != 2 or Xf.shape[1] != 3:
        raise ValueError("point clouds must have shape (n, 3)")
    nf, C = Xf.shape[0], cfg.correspondences
    _check_round_linspace_domain(C, nf)
    # The stages of icp_register, on the same one-pair batch.
    sel_idx, sel_valid = _ungated_selection(nf, C, dev, (1,))
    Q = _rows(Xf[None], sel_idx)
    if normals_fix is not None:
        normals_fix, planarity_fix = (t[None] for t in _user_normals(
            normals_fix, planarity_fix, nf, dtype, dev))
        normals, planarity = _normals_stage(Q, Xf[None], sel_idx, normals_fix,
                                            planarity_fix, cfg=cfg)
    else:
        normals, planarity = _knn_normals(Q, Xf, cfg, *_plan_prepared_knn(cfg, nf, dev))
    return FixedPrep(Q[0], normals[0], planarity[0], sel_idx[0], sel_valid[0], nf, C,
                     cfg.neighbors, cfg.approx_knn)


def _plan_prepared_knn(cfg: IcpConfig, nf: int, dev: torch.device):
    """(knn_block, knn_grid) of ``prepare_fixed``'s k-NN, planned as the
    JAX package plans it with the card's rates when ``program_budget_s`` >
    0 and the cloud is on the card, else (0, False): one k-NN call."""
    budget = cfg.program_budget_s
    if budget <= 0 or dev.type != "cuda":
        return 0, False
    C = cfg.correspondences
    _, knn_s, _, _ = device_policy.estimate_gpu_stage_seconds(
        nf, 1, correspondences=C, neighbors=cfg.neighbors, has_normals=False)
    knn_atom_s = min(knn_s, knn_s * 2048.0 / max(C, 1))
    if knn_atom_s > budget * 0.9:
        raise ValueError(
            f"preparing this fixed cloud is estimated at ~{knn_atom_s:.3g} s "
            "of card time for ONE minimal k-NN query block, over "
            f"program_budget_s={budget:g}. Reduce `neighbors`, prepare on "
            "device='cpu', or raise or disable (0) program_budget_s."
        )
    if knn_s <= budget * 0.9:
        return 0, False
    return _knn_block_rows(budget, knn_s, C), knn_s > budget * 0.5


def _same_device(t: torch.Tensor, dev: torch.device) -> bool:
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return t.device == dev


def _validate_fixed_prep(fixed_prep: FixedPrep, nf: int, cfg: IcpConfig,
                         dtype, dev, normals_fix, caller: str) -> None:
    """The JAX package's checks of a preparation at use, in its order and
    with its messages (it must have been computed for this cloud, config
    and dtype, and replaces the normals), and one more: its tensors must
    lie on the call's device (they are never copied there silently)."""
    if cfg.overlap_enabled:
        raise ValueError(
            "fixed_prep cannot be combined with the overlap gate "
            "(max_overlap_distance): a gated selection depends on the "
            "movable cloud — prepare_fixed refuses such configs too"
        )
    if normals_fix is not None:
        raise ValueError(
            f"pass normals_fix to prepare_fixed, not to the consuming "
            f"{caller} call — the preparation already contains the "
            "selected normals"
        )
    stamp = (fixed_prep.n_fix, fixed_prep.correspondences,
             fixed_prep.neighbors, fixed_prep.approx_knn)
    want = (nf, cfg.correspondences, cfg.neighbors, cfg.approx_knn)
    if stamp != want:
        raise ValueError(
            f"fixed_prep was computed for (n_fix, correspondences, "
            f"neighbors, approx_knn)={stamp}, but this call needs "
            f"{want} — re-run prepare_fixed with the matching cloud "
            "and config"
        )
    if fixed_prep.Q.dtype != dtype:
        raise ValueError(
            f"fixed_prep dtype {_dtype_name(fixed_prep.Q.dtype)} does not "
            f"match this call's dtype {_dtype_name(dtype)}"
        )
    for t in fixed_prep[:5]:
        if not _same_device(t, dev):
            raise ValueError(
                f"fixed_prep lies on {t.device}, but this {caller} call runs "
                f"on {dev}: prepare or load it there "
                "(prepare_fixed(..., device=...), load_fixed_prep(path, "
                "device=...))"
            )


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
    fixed_prep: Optional[FixedPrep] = None,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
) -> IcpResult:
    """Register X_mov onto X_fix.

    Args:
        X_fix: (nf, 3) fixed cloud (numpy array or tensor).
        X_mov: (nm, 3) movable cloud.
        cfg: pipeline configuration. ``dispatch`` and ``program_budget_s``
            plan the run on the card (``_plan_dispatch``: monolithic, or
            chunked with the normals k-NN in blocks or through the grid
            k-NN cascade; the same result every way); on the CPU "auto" is
            monolithic. ``warm_start=True`` runs a coarse registration first
            (``plan_warm_start``). The grid engines count their cell caps
            on the host for a numpy movable cloud and on its device for a
            tensor (one host read each), as the JAX package does.
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
        fixed_prep: a ``prepare_fixed`` result for this fixed cloud and
            config, in this call's dtype and on its device: it replaces the
            selection and the normals, and the result equals the
            self-contained run's bit for bit.
        device: "cuda" by default, which raises when no card is found;
            "cpu" runs the kernels' plain versions.
        dtype: coordinate dtype, float32 by default (solver math is float64
            whatever this is).

    Returns:
        IcpResult of tensors on ``device``. Check ``.error_code``.
    """
    with span("icp.register"):
        return _icp_register(
            X_fix, X_mov, cfg, rbp_observed_values=rbp_observed_values,
            rbp_observation_weights=rbp_observation_weights,
            normals_fix=normals_fix, planarity_fix=planarity_fix,
            planarity_mov=planarity_mov, fixed_prep=fixed_prep, device=device,
            dtype=dtype,
        )[0]


def _icp_register(X_fix, X_mov, cfg: IcpConfig, *, rbp_observed_values,
                  rbp_observation_weights, normals_fix, planarity_fix,
                  planarity_mov, fixed_prep, device, dtype, plan=None):
    """``icp_register``, also returning the loop's final state (whose
    ``m_idx`` holds the last iteration's matches). ``plan`` (a
    ``DispatchPlan``) replaces the planner's, as a test forces a split
    prologue."""
    with span("icp.plan"):
        dev, dtype = resolve(device, dtype)
        # A movable cloud that came as numpy has the grid engines count their
        # cell caps on the host, as in the JAX package; a tensor, on its device.
        mov_host = X_mov if isinstance(X_mov, np.ndarray) else None
        Xf = _as_tensor(X_fix, dtype, dev)
        Xm = _as_tensor(X_mov, dtype, dev)
        if Xf.dim() != 2 or Xf.shape[1] != 3 or Xm.dim() != 2 or Xm.shape[1] != 3:
            raise ValueError("point clouds must have shape (n, 3)")
        _check_round_linspace_domain(cfg.correspondences, Xf.shape[0])
        if fixed_prep is not None:
            _validate_fixed_prep(fixed_prep, Xf.shape[0], cfg, dtype, dev,
                                 normals_fix, "icp_register")

        if normals_fix is not None:
            normals_fix, planarity_fix = _user_normals(normals_fix, planarity_fix,
                                                       Xf.shape[0], dtype, dev)
        if planarity_mov is not None:
            planarity_mov = _as_tensor(planarity_mov, dtype, dev)
        # The coarse pass of a warm start sets its own matcher and gate, so it
        # runs as from the unresolved config.
        cfg = _resolve_engines(cfg, Xf.shape[0], Xm.shape[0])
        warm_requested = cfg.warm_start
        if cfg.warm_start:
            cfg, rbp_observed_values = plan_warm_start(
                Xf, Xm, cfg, rbp_observed_values=rbp_observed_values,
                rbp_observation_weights=rbp_observation_weights,
                normals_fix=normals_fix, planarity_fix=planarity_fix,
                planarity_mov=planarity_mov, device=dev, dtype=dtype,
            )

        zeros6 = torch.zeros(6, dtype=dtype, device=dev)
        obs_vals = (zeros6 if rbp_observed_values is None
                    else _as_tensor(rbp_observed_values, dtype, dev))
        obs_w = (zeros6 if rbp_observation_weights is None
                 else _as_tensor(rbp_observation_weights, dtype, dev))

        H0 = rbp_to_H(obs_vals)
        nf, nm = Xf.shape[0], Xm.shape[0]
        has_normals = normals_fix is not None or fixed_prep is not None
        # The grid matcher's cell list is built once, before the planner
        # prices an iteration with its cap; every iteration and chunk queries it.
        match_grid = _match_grid(Xm, cfg, mov_host) if cfg.match_method == "grid" else None
        plan_cfg = (cfg if match_grid is None
                    else dataclasses.replace(cfg, match_cell_cap=match_grid[1]))
        if plan is None:
            plan = _plan_dispatch(
                plan_cfg, nf, nm, guarded=cfg.program_budget_s > 0 and dev.type == "cuda",
                has_normals=has_normals,
                gate_pairs=(float(nf) * nm
                            if cfg.overlap_enabled and cfg.gate_method == "brute" else 0.0),
                warm_requested=warm_requested,
                obs=(rbp_observed_values, rbp_observation_weights),
            )
        chunked = plan.dispatch == "chunked"
        per_iter_est = _chunk_per_iter_estimate(plan_cfg, nf, nm, has_normals, dev)
    # The gate sees the pair itself; the stages after it and the loop are
    # the batch's, on a batch of one.
    Xf1, Xm1 = Xf[None], Xm[None]
    if fixed_prep is None:
        t0 = time.perf_counter()
        sel_idx, sel_valid, error0 = (
            x[None] for x in _gate_select_stages(Xf, Xm, H0, cfg=cfg, mov_host=mov_host,
                                                 obs_host=rbp_observed_values))
        with span("icp.normals"):
            Q = _rows(Xf1, sel_idx)
            if chunked and _log.isEnabledFor(logging.DEBUG):
                _synced(Q)
                _log.debug("timing: chunked prologue gate/select %.2f s",
                           time.perf_counter() - t0)
            if normals_fix is not None:
                normals, planarity = _normals_stage(Q, Xf1, sel_idx, normals_fix[None],
                                                    planarity_fix[None], cfg=cfg)
            else:
                normals, planarity = _knn_normals(Q, Xf, cfg, plan.knn_block, plan.knn_grid)
    else:
        with span("icp.normals"):
            Q, normals, planarity, sel_idx, sel_valid = (t[None] for t in fixed_prep[:5])
            error0 = np.full(1, ERR_OK, np.int32)

    with span("icp.loop"):
        mov_planarity_fn = None
        if planarity_mov is not None:
            def mov_planarity_fn(m_idx):
                return _rows(planarity_mov[None], m_idx)

        loop_args = (Q, normals, planarity, sel_valid, obs_vals[None], obs_w[None], cfg,
                     dtype, error0, H0[None], _make_match_fn(Q, Xm1, cfg, grid=match_grid))
        # A monolithic run is one chunk of max_iterations: the same loop, reads
        # and launches, and no stall check (the first chunk is never checked).
        final = _run_chunked(
            make_carry_init(cfg, dtype, obs_vals[None], H0[None], error0),
            plan.chunk_iterations if chunked else cfg.max_iterations,
            lambda c, hi: run_icp_loop(*loop_args, mov_planarity_fn=mov_planarity_fn,
                                       carry_in=c, it_hi=hi),
            cfg=cfg, per_iter_est=per_iter_est,
        )
    with span("icp.finish"):
        uncertainties, covariance = _uncertainties(
            final, Q, normals, obs_vals[None], obs_w[None], lambda m_idx: _rows(Xm1, m_idx))
        result = _result_from_carry(
            final, uncertainties, covariance, sel_idx, sel_valid, normals,
            planarity,
        )
        return _first(result), _first(final)


def icp_register_batch(
    X_fix,
    X_mov,
    cfg: IcpConfig = IcpConfig(),
    *,
    rbp_observed_values=None,
    rbp_observation_weights=None,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
) -> IcpResult:
    """Register a batch of B cloud pairs at once, each pair's result that
    of its own ``icp_register``.

    One loop registers the whole batch, and every stage takes the pairs
    together: one gate launch, one k-NN launch, one match launch per
    iteration and one host read per iteration (and per Gauss-Newton step)
    for all B pairs, where B registrations would take B of each. The card's
    registrations are launch-bound, so a batch costs about one
    registration's launches. The loop runs while any pair is active; a
    pair that has stopped keeps its state, as under the JAX package's
    vmapped ``lax.while_loop``.

    As in the JAX package, batch mode runs the monolithic loop with no warm
    start: ``dispatch``, ``chunk_iterations``, ``warm_start`` and
    ``program_budget_s`` have no effect here. The JAX package's tile shrink
    (``query_tile``/``ref_tile`` and its "footprint" warning) guards a fault
    of its TPU worker that cannot happen on the card: the port's kernels
    hold no distance block, and its plain versions bound their block over
    the whole batch (``ops/knn.py`` ``_PLAIN_BLOCK_ELEMS``), so the tiles
    change nothing.

    Args:
        X_fix: (B, nf, 3) fixed clouds; X_mov: (B, nm, 3) movable clouds.
        cfg: the configuration shared by the pairs. The grid and dilate
            gates and the grid matcher are refused (their caps and plans
            are per cloud); "auto" resolves to the brute matcher and gate.
        rbp_observed_values / rbp_observation_weights: optional (B, 6)
            per-pair observations (angles in radians), zeros when not given.
        device: "cuda" by default (raises without a card); "cpu" runs the
            plain versions.
        dtype: coordinate dtype, float32 by default.

    Returns:
        IcpResult with a leading batch axis on every field: n_iterations,
        converged and error_code (B,), the trajectory buffers (B, R, C).
    """
    with span("icp.register"):
        with span("icp.plan"):
            if cfg.overlap_enabled and cfg.gate_method in ("grid", "dilate"):
                raise ValueError(
                    f"gate_method={cfg.gate_method!r} is not supported in batch mode"
                )
            if cfg.match_method == "auto":
                # batch pairs are serving-sized; the grid matcher is per-cloud
                # static, so auto always resolves to brute here
                cfg = dataclasses.replace(cfg, match_method="brute")
            if cfg.match_method != "brute":
                raise ValueError(
                    "match_method='grid' is not supported in batch mode (its cell "
                    "cap is per-cloud static)"
                )
            dev, dtype = resolve(device, dtype)
            Xf = _as_tensor(X_fix, dtype, dev)
            Xm = _as_tensor(X_mov, dtype, dev)
            if Xf.dim() != 3 or Xf.shape[2] != 3 or Xm.dim() != 3 or Xm.shape[2] != 3:
                raise ValueError("batched clouds must have shape (B, n, 3)")
            if Xf.shape[0] != Xm.shape[0]:
                raise ValueError("batch sizes of fixed and movable clouds differ")
            _check_round_linspace_domain(cfg.correspondences, Xf.shape[1])
            B = Xf.shape[0]
            if cfg.overlap_enabled and cfg.gate_method == "auto":
                cfg = dataclasses.replace(cfg, gate_method="brute")

            zeros = torch.zeros((B, 6), dtype=dtype, device=dev)
            obs_vals = (zeros if rbp_observed_values is None
                        else _as_tensor(rbp_observed_values, dtype, dev))
            obs_w = (zeros if rbp_observation_weights is None
                     else _as_tensor(rbp_observation_weights, dtype, dev))
            H0 = rbp_to_H(obs_vals)
        sel_idx, sel_valid, error0 = _gate_select_stages(Xf, Xm, H0, cfg=cfg)
        with span("icp.normals"):
            Q = _rows(Xf, sel_idx)
            normals, planarity = _normals_stage(Q, Xf, sel_idx, None, None, cfg=cfg)
        with span("icp.loop"):
            final = run_icp_loop(Q, normals, planarity, sel_valid, obs_vals, obs_w, cfg,
                                 dtype, error0, H0, _make_match_fn(Q, Xm, cfg))
        with span("icp.finish"):
            uncertainties, covariance = _uncertainties(
                final, Q, normals, obs_vals, obs_w, lambda m_idx: _rows(Xm, m_idx))
            return _result_from_carry(final, uncertainties, covariance, sel_idx,
                                      sel_valid, normals, planarity)
