"""Spatial-hash cell list: radius-bounded nearest neighbours at scale.

The port of the JAX package's ``ops/gridhash.py``, under the same names. The
grid engines answer "which reference lies within r of this query" without a
sweep over every reference:

  * cell size == radius, so any reference within the radius of a query lies
    in one of the query's 27 neighbouring cells: the scan is exact for the
    within-radius question;
  * cells are hashed into a 2^30 slot space that is never materialized: the
    references are sorted by slot (one stable argsort) and each probed slot
    is found by binary search (``torch.searchsorted``), its run's end by one
    gather (``run_end``);
  * each of the 27 probes contributes at most ``cell_cap`` candidates (the
    maximum slot occupancy: ``grid_cell_cap`` on the host, ``grid_build_cap``
    on the device), whose distances are computed exactly. Hash collisions
    only add candidates, never remove them.

Written in plain PyTorch operations: it runs on the device of its tensors,
and the same operations give the same bits on the card and on the CPU. What
each step must do to give the JAX package's results:

  * the hash multiplies int32 cells by three primes and wraps; here the
    products are taken in int64 and masked to the low 30 bits, which are the
    same;
  * cells are ``floor((p - origin) * inv)`` with ``inv = 1 / radius`` in the
    coordinate dtype (never a division by the radius);
  * the sort is stable, and a query's ties go to the first candidate in
    (offset, sorted position) order: the first of the 27 offsets whose
    minimum is the smallest, and within it the first minimum;
  * distances are separate elementwise operations in the order x, y, z (the
    plain 1-NN's ``_dist2_block``), so on the card the grid's d2 is bit-equal
    to the 1-NN kernel's.

The queries are taken in one pass while the candidate block (queries x 27 x
``cell_cap`` slots) stays within ``_BLOCK_SLOTS``, else in chunks of queries;
the chunking changes no result. No tensor leaves its device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# 2^30 hash slots: the sorted array makes the slot space free, so it is
# large enough that random collisions are negligible even at 50M points.
# Below 2^31: slots are non-negative int32 values.
_HASH_BITS = 30
_HASH_SIZE = 1 << _HASH_BITS
# Classic 3D spatial-hash primes (Teschner et al. 2003).
_PX, _PY, _PZ = 73856093, 19349663, 83492791
# Largest candidate block (queries x 27 x cell_cap slots) of one pass:
# about 30 bytes a slot of transient memory, 2 GB.
_BLOCK_SLOTS = 1 << 26
_INT32_MAX = 2**31 - 1


def _offsets(device) -> torch.Tensor:
    """The 27 neighbour offsets (27, 3) int64, dx slowest, dz fastest (the
    JAX package's order)."""
    r = torch.arange(-1, 2, device=device)
    return torch.cartesian_prod(r, r, r)


def _cell_of(points: torch.Tensor, origin: torch.Tensor,
             inv_cell: torch.Tensor) -> torch.Tensor:
    """The int32 cell of each point: floor((p - origin) * inv_cell)."""
    return torch.floor((points - origin) * inv_cell).to(torch.int32)


def _slot_of(cells: torch.Tensor) -> torch.Tensor:
    """The hash slot (int32, in [0, 2^30)) of integer cells (..., 3): the
    int32 products of the JAX package wrap; their low 30 bits are those of
    the int64 products taken here."""
    c = cells.to(torch.int64)
    h = (c[..., 0] * _PX) ^ (c[..., 1] * _PY) ^ (c[..., 2] * _PZ)
    return (h & (_HASH_SIZE - 1)).to(torch.int32)


def grid_cell_cap(refs: np.ndarray, radius: float) -> int:
    """Host-side: maximum occupancy of any hash slot for this cloud/radius —
    the static per-cell candidate bound of the queries.

    The device bins in its own dtype via (refs - origin) * (1/radius)
    (``_cell_of``); points on cell boundaries can bin differently between
    host and device arithmetic, so the occupancy is counted under BOTH f32
    and f64 device-matching arithmetic (max taken) and a small additive
    slack absorbs any residual boundary flips (e.g. when the device cloud
    went through an f32 initial-transform the host reproduced in f64). An
    over-estimate only costs scan time; an under-estimate would silently
    truncate candidates."""
    refs64 = np.asarray(refs, np.float64)
    if refs64.shape[0] == 0:
        return 1
    cap = 0
    for dt in (np.float32, np.float64):
        r = refs64.astype(dt)
        origin = r.min(axis=0)
        inv = dt(1.0) / dt(radius)
        cells = np.floor((r - origin) * inv).astype(np.int64)
        h = (
            cells[:, 0] * _PX ^ cells[:, 1] * _PY ^ cells[:, 2] * _PZ
        ).astype(np.int64) & (_HASH_SIZE - 1)
        _, counts = np.unique(h, return_counts=True)
        cap = max(cap, int(counts.max()))
    return cap + 4


def _radius(radius, like: torch.Tensor) -> torch.Tensor:
    """The radius as a 0-dim tensor in the coordinate dtype, on the
    coordinates' device."""
    return torch.as_tensor(radius, dtype=like.dtype, device=like.device)


def build_sorted_grid(refs: torch.Tensor, radius,
                      valid: Optional[torch.Tensor] = None,
                      origin: Optional[torch.Tensor] = None):
    """Sort references by hash slot for binary-search cell lookup.

    Invalid rows get slot _HASH_SIZE (beyond every query slot, sorted last,
    never matched). Returns (sorted_pts, sorted_slots, order, origin,
    run_end) where run_end[i] is the exclusive end of the equal-slot run
    containing sorted position i — it lets the query phase replace the
    second binary search (side="right") with a single gather. ``origin``
    pins the cell lattice explicitly (by default the minimum of the valid
    rows). ``order`` is int64, the slots and ``run_end`` int32.
    """
    r = _radius(radius, refs)
    if origin is None:
        if valid is not None:
            big = torch.tensor(1e30, dtype=refs.dtype, device=refs.device)
            origin = torch.where(valid[:, None], refs, big).amin(dim=0)
        else:
            origin = refs.amin(dim=0)
    slots = _slot_of(_cell_of(refs, origin, 1.0 / r))
    if valid is not None:
        slots = torch.where(valid, slots, torch.full_like(slots, _HASH_SIZE))
    order = torch.argsort(slots, stable=True)
    sorted_slots = slots[order]

    # run_end[i]: first j > i with sorted_slots[j] != sorted_slots[i]
    # (exclusive run end), via a reversed cummin over next-run starts.
    n = sorted_slots.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=refs.device)
    last = torch.ones(1, dtype=torch.bool, device=refs.device)
    starts_next = torch.where(
        torch.cat([sorted_slots[1:] != sorted_slots[:-1], last]),
        idx + 1, torch.full_like(idx, n),
    )
    run_end = torch.flip(torch.cummin(torch.flip(starts_next, [0]), 0).values, [0])
    return refs[order], sorted_slots, order, origin, run_end


def grid_build_cap(refs: torch.Tensor, radius):
    """The grid of ``build_sorted_grid(refs, radius)`` and its exact maximum
    slot occupancy, a 0-dim int32 tensor on the refs' device (binned by the
    same arithmetic as the grid, so no boundary slack is needed — unlike
    ``grid_cell_cap``). Reading the occupancy is the caller's one host read.
    """
    grid = build_sorted_grid(refs, radius)
    run_end = grid[4]
    idx = torch.arange(run_end.shape[0], dtype=torch.int32, device=refs.device)
    return grid, torch.max(run_end - idx)


def _query_chunks(n_q: int, cell_cap: int):
    """Query slices of one pass each: as many queries as keep the candidate
    block within _BLOCK_SLOTS."""
    step = max(1, _BLOCK_SLOTS // (27 * max(cell_cap, 1)))
    return [slice(lo, min(n_q, lo + step)) for lo in range(0, n_q, step)]


def _candidates(Q, sorted_pts, sorted_slots, origin, inv_cell, cell_cap,
                run_end, dedup):
    """The candidates of queries Q (q, 3): squared distances (q, 27 *
    cell_cap), their sorted positions clamped to the cloud (int64), and
    their validity, in (offset, position) order. With ``dedup`` a probe
    whose slot equals an earlier probe's of the same query (two neighbour
    cells hashed to one slot) contributes no candidate."""
    n_r = sorted_pts.shape[0]
    qcell = _cell_of(Q, origin, inv_cell).to(torch.int64)
    slots = _slot_of(qcell[:, None, :] + _offsets(Q.device))  # (q, 27)
    start = torch.searchsorted(sorted_slots, slots, side="left")
    if run_end is not None:
        start_c = torch.clamp(start, max=n_r - 1)
        # Absent slot: start points into the next run; gate it off so that
        # the probe has no candidate.
        end = torch.where(sorted_slots[start_c] == slots, run_end[start_c].long(), start)
    else:
        end = torch.searchsorted(sorted_slots, slots, side="right")
    if dedup:
        earlier = torch.ones(27, 27, dtype=torch.bool, device=Q.device).tril(-1)
        dup = ((slots[:, :, None] == slots[:, None, :]) & earlier).any(dim=-1)
        end = torch.where(dup, start, end)
    pos = start[:, :, None] + torch.arange(cell_cap, device=Q.device)  # (q, 27, cap)
    valid = (pos < end[:, :, None]).reshape(Q.shape[0], -1)
    pos = torch.clamp(pos, max=n_r - 1).reshape(Q.shape[0], -1)
    cand = sorted_pts[pos]  # (q, 27 * cap, 3)
    d = Q[:, None, 0] - cand[..., 0]
    d2 = d * d
    d = Q[:, None, 1] - cand[..., 1]
    d2 = d2 + d * d
    d = Q[:, None, 2] - cand[..., 2]
    d2 = d2 + d * d
    return d2, pos, valid


def grid_query_sorted(queries: torch.Tensor, sorted_pts: torch.Tensor,
                      sorted_slots: torch.Tensor, origin: torch.Tensor,
                      radius, *, cell_cap: int,
                      run_end: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min squared distance (and sorted-array position, int64) from each
    query to the 27-neighbour-cell candidates of a pre-built sorted grid.
    Exact for the within-``radius`` question; (+inf, 0) when no candidate
    exists. Ties go to the first offset, then the first position.

    With ``run_end`` (from build_sorted_grid) the per-offset segment end is
    a single gather instead of a second binary search. When the probed slot
    is absent, ``start`` lands in a different slot's run and its candidates
    are scanned anyway: false positives of the exact distance check, never
    false negatives.
    """
    inv_cell = 1.0 / _radius(radius, queries)
    d2_out = torch.full(queries.shape[:1], float("inf"), dtype=queries.dtype,
                        device=queries.device)
    pos_out = torch.zeros(queries.shape[:1], dtype=torch.int64, device=queries.device)
    for s in _query_chunks(queries.shape[0], cell_cap):
        d2, pos, valid = _candidates(queries[s], sorted_pts, sorted_slots, origin,
                                     inv_cell, cell_cap, run_end, dedup=False)
        d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
        # The first minimum of the flattened (offset, position) axis is the
        # JAX package's strict-< sweep over the offsets of first argmins.
        best = torch.argmin(d2, dim=1, keepdim=True)
        d2_min = torch.gather(d2, 1, best)[:, 0]
        d2_out[s] = d2_min
        pos_out[s] = torch.where(d2_min < float("inf"), torch.gather(pos, 1, best)[:, 0], 0)
    return d2_out, pos_out


def nn_within_radius_grid(queries: torch.Tensor, refs: torch.Tensor, radius, *,
                          cell_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest reference within ``radius`` of each query, via the cell list.

    Args:
        queries: (q, 3); refs: (r, 3).
        radius: scalar search radius (also the cell size).
        cell_cap: max slot occupancy from ``grid_cell_cap`` (an
            under-estimate risks missed candidates; over-estimates only
            cost time).

    Returns:
        (d2, idx int32): squared distance to and index of the nearest
        reference within the 27-cell neighbourhood — exact whenever the true
        NN is within ``radius``; +inf and the index at sorted position 0
        when no reference is that close.
    """
    sorted_pts, sorted_slots, order, origin, run_end = build_sorted_grid(refs, radius)
    d2, pos = grid_query_sorted(queries, sorted_pts, sorted_slots, origin, radius,
                                cell_cap=cell_cap, run_end=run_end)
    return d2, order[pos].to(torch.int32)


def knn_query_sorted(queries: torch.Tensor, sorted_pts: torch.Tensor,
                     sorted_slots: torch.Tensor, order: torch.Tensor,
                     origin: torch.Tensor, radius, k: int, *,
                     cell_cap: int, run_end: Optional[torch.Tensor] = None,
                     cert_margin: float = 1e-3):
    """k nearest neighbours among the 27-neighbour-cell candidates of a
    pre-built sorted grid, with a per-query exactness CERTIFICATE.

    The 27-cell neighbourhood contains every point within ``radius`` of the
    query, so when the k-th candidate distance satisfies d_k <= (1 -
    cert_margin) * radius, every point outside it is farther than d_k and
    the candidate top-k IS the true top-k: ``certified`` is True. The margin
    absorbs float cell-binning error. An uncertified query is not wrong,
    only unproven: the dense k-NN (``ops/knn.py`` ``knn_search``) is exact
    for it.

    Candidates are ordered by (d2, original index), the dense k-NN's tie
    order. A probe whose slot equals an earlier probe's of the same query
    adds no candidate (no duplicates); invalid candidates are (+inf,
    2^31 - 1) and sort last, and rows with fewer than k candidate slots
    (27 * cell_cap < k) are padded with them.

    Returns (d2 (q, k), idx (q, k) int32 original ref indices, certified
    (q,)).
    """
    r = _radius(radius, queries)
    inv_cell = 1.0 / r
    c = (1.0 - cert_margin) * r
    cert_d2 = c * c
    n_q, dev = queries.shape[0], queries.device
    d_out = torch.empty((n_q, k), dtype=queries.dtype, device=dev)
    i_out = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    for s in _query_chunks(n_q, cell_cap):
        d2, pos, valid = _candidates(queries[s], sorted_pts, sorted_slots, origin,
                                     inv_cell, cell_cap, run_end, dedup=True)
        d_all = torch.where(valid, d2, torch.full_like(d2, float("inf")))
        i_all = torch.where(valid, order[pos], _INT32_MAX)
        if d_all.shape[1] < k:  # degenerate tiny cap: pad so [:k] is valid
            padw = k - d_all.shape[1]
            d_all = torch.nn.functional.pad(d_all, (0, padw), value=float("inf"))
            i_all = torch.nn.functional.pad(i_all, (0, padw), value=_INT32_MAX)
        # Two-key ascending sort: by index, then stably by distance.
        i_all, perm = torch.sort(i_all, dim=1, stable=True)
        d_all = torch.gather(d_all, 1, perm)
        d_all, perm = torch.sort(d_all, dim=1, stable=True)
        d_out[s] = d_all[:, :k]
        i_out[s] = torch.gather(i_all, 1, perm[:, :k]).to(torch.int32)
    return d_out, i_out, d_out[:, k - 1] <= cert_d2


def knn_search_grid(queries: torch.Tensor, refs: torch.Tensor, radius, k: int, *,
                    cell_cap: int, cert_margin: float = 1e-3):
    """Grid-accelerated exact-when-certified k-NN: build + query, about
    27 * cell_cap candidates a query instead of every reference. Use the
    certificate to send the unproven queries through ``ops.knn.knn_search``."""
    sorted_pts, sorted_slots, order, origin, run_end = build_sorted_grid(refs, radius)
    return knn_query_sorted(queries, sorted_pts, sorted_slots, order, origin, radius, k,
                            cell_cap=cell_cap, run_end=run_end, cert_margin=cert_margin)


def min_dist_sq_grid(queries: torch.Tensor, refs: torch.Tensor, radius, *,
                     cell_cap: int) -> torch.Tensor:
    """Overlap-gate primitive: squared distance to the nearest reference if
    within ``radius``, else +inf. Drop-in for ``ops.knn.min_dist_sq`` when a
    gate radius is known."""
    return nn_within_radius_grid(queries, refs, radius, cell_cap=cell_cap)[0]
