"""Sharded ICP: the registration over a mesh of processes, one device each.

The port of the JAX package's ``parallel/sharded.py`` on ``torch.distributed``.
Both clouds are cut into contiguous row blocks of ceil(n / size) rows, block
r on rank r (the tail blocks short, possibly empty), so a global row index
is the block's first row plus the local one, and the original index of the
point. Everything per correspondence (C slots) is replicated: every rank
holds it and computes it alike. The heavy stages run on the local blocks,
through the same kernels as ``icp_register`` on the card, and combine with
collectives:

  * overlap gate: each rank's fixed block against every movable block,
    the movable blocks passed around the ring (send to rank + 1, receive
    from rank - 1; ``gate_collective="ring"``) or gathered once
    (``"allgather"``), keeping the running minimum distance; the grid gate
    passes each block's sorted cell list instead, binned on one global
    lattice (origin: the minimum over the ranks);
  * fixed-count selection: the ranks' survivor counts are gathered and read
    once; each slot's target rank among the survivors is served by the rank
    that holds it, and one sum assembles the replicated indices;
  * normals: each rank's k-NN of the C queries among its fixed block, the
    (C, k) lists gathered and merged by a stable sort (ties to the lower
    rank, then the lower index, as one k-NN over the whole cloud gives);
  * matching: each rank's match (or grid-matcher) winner among its movable
    block, gathered with its global index; the first minimum over the ranks
    wins (ties to the lowest rank, so to the lowest global index);
  * rows at global indices (``_gather_rows``): the owner contributes the
    row, the others zeros, one sum.

The loop, the solver and the convergence test are the single-card ones
(``models.icp.run_icp_loop`` and ``_run_chunked``) on the replicated state,
so every rank reads the same stop flag, and the result equals
``icp_register``'s bit for bit: every distance is the same per-pair
arithmetic, every minimum is exact and every tie goes to the lower index.

Backends: NCCL between cards (one card a rank), gloo between CPU processes.
gloo takes no CUDA tensor, so ranks on cards over gloo (two ranks sharing
one card, which NCCL refuses) stage every collective's tensors through host
memory; ``Mesh.counts`` counts the collectives and the staged bytes.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config import IcpConfig
from ..models.icp import (
    ERR_NO_OVERLAP,
    ERR_OK,
    GATE_AUTO_GRID_PAIRS,
    FixedPrep,
    IcpResult,
    _as_tensor,
    _check_round_linspace_domain,
    _compacted,
    _first,
    _initial_moved_host,
    _resolve_engines,
    _resolve_gate,
    _result_from_carry,
    _run_chunked,
    _static_ungated_selection,
    _uncertainties,
    _validate_fixed_prep,
    back_transform,
    make_carry_init,
    plan_warm_start,
    round_linspace,
    run_icp_loop,
)
from ..ops.dilate_gate import bbox_of, overlap_mask_dilate
from ..ops.gridhash import build_sorted_grid, grid_cell_cap, grid_query_sorted
from ..ops.knn import knn_search, match_transform, min_dist_sq
from ..ops.normals import estimate_normals_from_neighborhoods
from ..ops.transform import apply_H, rbp_to_H
from ..utils import device_policy
from ..utils.device import resolve
from ..utils.sync import read_array
from .mesh import Mesh, make_mesh

_log = logging.getLogger(__name__)

_SUM, _MIN, _MAX = dist.ReduceOp.SUM, dist.ReduceOp.MIN, dist.ReduceOp.MAX


class _Comm:
    """One rank's collectives over its mesh, on tensors of the run's device
    ``dev``. Each call adds one to ``mesh.counts[kind]`` and to
    ``mesh.counts[stage + "_collectives"]`` (``stage``: "prologue", "loop"
    or "uncertainty", set by ``_icp_register_sharded``). Over gloo with
    tensors on the card, each call stages its tensors through host memory
    and adds the bytes it copies (both ways) to
    ``mesh.counts["staged_bytes"]``."""

    def __init__(self, mesh: Mesh, dev: torch.device):
        self.n, self.rank, self.group = mesh.size, mesh.rank, mesh.group
        self.counts = mesh.counts
        self.dev = dev
        self.staged = mesh.backend == "gloo" and dev.type == "cuda"
        self.stage = "prologue"

    def _count(self, kind: str, *moved: torch.Tensor):
        for key in (kind, f"{self.stage}_collectives"):
            self.counts[key] = self.counts.get(key, 0) + 1
        if self.staged:
            self.counts["staged_bytes"] = self.counts.get("staged_bytes", 0) + sum(
                t.numel() * t.element_size() for t in moved)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.staged else t

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dev) if self.staged else t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, rank-major."""
        src = self._out(t)
        parts = [torch.empty_like(src) for _ in range(self.n)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.stack(parts)
        self._count("all_gather", t, out)
        return self._in(out)

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        buf = self._out(t).clone()
        dist.all_reduce(buf, op=op, group=self.group)
        self._count("all_reduce", t, buf)
        return self._in(buf)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        buf = self._out(t).clone()
        dist.broadcast(buf, src, group=self.group)
        self._count("broadcast", t, buf)
        return self._in(buf)

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """The ring step: t to rank + 1; returns rank - 1's t (same shape)."""
        src = self._out(t)
        recv = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, (self.rank + 1) % self.n, group=self.group),
               dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.n, group=self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self._count("shift", t, recv)
        return self._in(recv)


def _block(n: int, size: int, rank: int):
    """(lo, hi) of rank's row block of n rows in blocks of ceil(n / size)."""
    rows = -(-n // size)
    lo = min(n, rank * rows)
    return lo, min(n, lo + rows)


def _block_sizes(n: int, size: int) -> np.ndarray:
    return np.array([hi - lo for lo, hi in (_block(n, size, r) for r in range(size))])


def _pad_to(X: torch.Tensor, n_total: int, fill=0) -> torch.Tensor:
    """X with rows of ``fill`` appended up to n_total rows (for transport:
    collectives take equal shapes on every rank)."""
    n = X.shape[0]
    if n == n_total:
        return X
    pad = torch.full((n_total - n, *X.shape[1:]), fill, dtype=X.dtype, device=X.device)
    return torch.cat([X, pad])


# --------------------------------------------------------------------------
# collective building blocks
# --------------------------------------------------------------------------

def _gather_pairs(comm: _Comm, d2: torch.Tensor, gidx: torch.Tensor):
    """Every rank's (d2, global index) arrays in ONE all-gather: the indices
    travel as integers of d2's width beside d2's bits. Returns both
    (size, *d2.shape), rank-major."""
    it = torch.int32 if d2.element_size() == 4 else torch.int64
    packed = comm.all_gather(torch.stack([d2.contiguous().view(it), gidx.to(it)]))
    return packed[:, 0].contiguous().view(d2.dtype), packed[:, 1].long()


def _combine_nn(comm: _Comm, d2_local: torch.Tensor, gidx_local: torch.Tensor):
    """The global 1-NN winner of each query from the ranks' local winners
    (replicated): the first minimum over the ranks, so ties go to the lowest
    rank, the lowest global index (the blocks are contiguous)."""
    all_d2, all_idx = _gather_pairs(comm, d2_local, gidx_local)
    win = torch.argmin(all_d2, dim=0, keepdim=True)
    return all_d2.gather(0, win)[0], all_idx.gather(0, win)[0]


def _gather_rows(comm: _Comm, local_block: torch.Tensor, lo: int, gidx: torch.Tensor):
    """Rows of a row-sharded array (this rank's block starts at global row
    ``lo``) at global indices ``gidx`` (any shape), replicated: the owner
    contributes each row, the others zeros, one sum."""
    n_l = local_block.shape[0]
    local = gidx.long() - lo
    mine = (local >= 0) & (local < n_l)
    shape = (*gidx.shape, *local_block.shape[1:])
    if n_l == 0:
        contrib = torch.zeros(shape, dtype=local_block.dtype, device=local_block.device)
    else:
        rows = local_block[local.clamp(0, n_l - 1)]
        mask = mine.view(*mine.shape, *[1] * (local_block.dim() - 1))
        contrib = torch.where(mask, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return comm.all_reduce(contrib, _SUM)


def _ring_blocks(comm: _Comm, block: tuple, sizes: np.ndarray):
    """Yield, for each rank's block in ring order (this rank's first), its
    arrays: each step passes the held block's arrays (padded to the largest
    block) to rank + 1 and takes rank - 1's, cut to its owner's size."""
    rows = int(sizes.max())
    for s in range(comm.n):
        if s:
            n_src = int(sizes[(comm.rank - s) % comm.n])
            block = tuple(comm.shift(_pad_to(a, rows))[:n_src] for a in block)
        yield block


def _gathered_blocks(comm: _Comm, block: tuple, sizes: np.ndarray):
    """Every rank's block arrays, rank-major, from one all-gather each."""
    rows = int(sizes.max())
    stacked = [comm.all_gather(_pad_to(a, rows)) for a in block]
    return [tuple(s[r, :int(sizes[r])] for s in stacked) for r in range(comm.n)]


def _min_over_blocks(Qf_local: torch.Tensor, blocks, query_fn) -> torch.Tensor:
    best = torch.full(Qf_local.shape[:1], float("inf"), dtype=Qf_local.dtype,
                      device=Qf_local.device)
    for block in blocks:
        if Qf_local.shape[0] and block[0].shape[0]:
            best = torch.minimum(best, query_fn(block))
    return best


def _ring_min_dist2(comm: _Comm, Qf_local, Xm_local, m_sizes):
    """Min squared distance from each local fixed point to ANY movable point,
    streaming the movable blocks around the ring: the brute overlap gate
    (the 1-NN kernel's d2-only mode on each block)."""
    return _min_over_blocks(Qf_local, _ring_blocks(comm, (Xm_local,), m_sizes),
                            lambda b: min_dist_sq(Qf_local, b[0]))


def _allgather_min_dist2(comm: _Comm, Qf_local, Xm_local, m_sizes):
    """The brute gate with ONE all-gather of the movable blocks and one
    sweep of the whole movable cloud: the same minima as the ring."""
    full = torch.cat([b[0] for b in _gathered_blocks(comm, (Xm_local,), m_sizes)])
    if Qf_local.shape[0] == 0:
        return torch.empty(0, dtype=Qf_local.dtype, device=Qf_local.device)
    return min_dist_sq(Qf_local, full)


def _global_origin(comm: _Comm, X_local: torch.Tensor) -> torch.Tensor:
    """The minimum over every rank's rows: the origin of the one global
    lattice every rank bins its cell list on, so a whole-cloud cell cap
    bounds every block's slot occupancy (a per-block origin would shift the
    lattice and could truncate candidates)."""
    if X_local.shape[0]:
        local_min = X_local.amin(dim=0)
    else:
        local_min = torch.full((3,), 1e30, dtype=X_local.dtype, device=X_local.device)
    return comm.all_reduce(local_min, _MIN)


def _local_grid(X_local: torch.Tensor, radius, origin: torch.Tensor):
    """The block's sorted cell list on the global lattice (an empty block
    keeps empty arrays): (pts, slots, order, run_end)."""
    if X_local.shape[0] == 0:
        e = torch.empty(0, dtype=torch.int32, device=X_local.device)
        return X_local, e, e.long(), e
    pts, slots, order, _, run_end = build_sorted_grid(X_local, radius, origin=origin)
    return pts, slots, order, run_end


def _grid_cap(comm: _Comm, grid, cap: int, X_host, radius) -> int:
    """A grid engine's cell cap, as ``icp_register`` resolves it: ``cap``
    when set; the whole cloud's ``grid_cell_cap`` when it came as numpy
    (``X_host``); else the largest block occupancy on the devices (the
    maximum over the ranks, one host read), rounded up to a multiple of 8."""
    if cap:
        return cap
    if X_host is not None:
        return grid_cell_cap(X_host, radius)
    slots, run_end = grid[1], grid[3]
    occ = torch.zeros((), dtype=torch.int32, device=slots.device)
    if slots.shape[0]:
        idx = torch.arange(slots.shape[0], dtype=torch.int32, device=slots.device)
        occ = torch.max(run_end - idx)
    return -(-int(read_array(comm.all_reduce(occ, _MAX))) // 8) * 8


def _grid_gate_d2(comm: _Comm, Qf_local, grid, m_sizes, radius, cell_cap, ring: bool,
                  origin):
    """The grid gate (the JAX package's ``_ring_min_dist2_grid`` and
    ``_allgather_min_dist2_grid``): each block's sorted cell list on the
    global lattice (``_local_grid``: pts, slots, run_end) travels the ring
    or is gathered once; each local fixed point queries every block's 27
    neighbour cells."""
    pts, slots, _, run_end = grid
    blocks = (_ring_blocks if ring else _gathered_blocks)(comm, (pts, slots, run_end), m_sizes)
    return _min_over_blocks(
        Qf_local, blocks,
        lambda b: grid_query_sorted(Qf_local, b[0], b[1], origin, radius,
                                    cell_cap=cell_cap, run_end=b[2])[0])


def _sharded_select_n(comm: _Comm, sel_local, Xf_local, lo: int, C: int, nf: int,
                      counts: np.ndarray):
    """Distributed fixed-count selection over the ranks' survivor masks, with
    their survivor counts ``counts`` (host). Slot j's target is the survivor
    of global rank p_j = round(linspace(0, n_sel - 1, C))[j] when n_sel > C
    (``round_linspace``, numpy's float64 formula), else j, clipped to nf - 1;
    the rank holding that survivor serves it, one sum assembles the
    replicated indices. A slot whose target lies past the survivors holds
    index 0 and is invalid, as ``icp_register``'s zero-padded compaction
    gives. Returns (Q (C, 3), sel_idx int32 (C,), valid (C,), n_sel)."""
    dev = Xf_local.device
    n_sel = int(counts.sum())
    offset = int(counts[:comm.rank].sum())
    count_l = int(counts[comm.rank])
    p = torch.clamp(round_linspace(n_sel if n_sel > C else C, C, dev), max=nf - 1)
    valid = torch.arange(C, device=dev) < min(n_sel, C)
    lk = p - offset
    mine = (p < n_sel) & (lk >= 0) & (lk < count_l)
    gidx = torch.zeros(C, dtype=torch.int64, device=dev)
    if count_l:
        row = _compacted(sel_local)[lk.clamp(0, count_l - 1)]
        gidx = torch.where(mine, lo + row, gidx)
    sel_idx = comm.all_reduce(gidx, _SUM).to(torch.int32)
    return _gather_rows(comm, Xf_local, lo, sel_idx), sel_idx, valid, n_sel


def _sharded_knn(comm: _Comm, Q, Xf_local, lo: int, k: int):
    """k-NN of replicated queries Q (C, 3) among the row-sharded fixed cloud:
    each rank's k-NN kernel over its block, the (C, k) lists gathered and
    merged by a stable sort of the rank-major candidates (each list ascends
    in (d2, index), so ties go to the lower rank, then the lower index: the
    order of one k-NN over the whole cloud). A block of fewer than k rows
    pads its list with +inf. Returns global (d2, idx) (C, k)."""
    C, n_l = Q.shape[0], Xf_local.shape[0]
    kk = min(k, n_l)
    d2 = torch.full((C, k), float("inf"), dtype=Q.dtype, device=Q.device)
    idx = (lo + n_l + torch.arange(k, device=Q.device)).expand(C, k).clone()
    if kk:
        d2_l, idx_l = knn_search(Q, Xf_local, kk)
        d2[:, :kk], idx[:, :kk] = d2_l, idx_l.long() + lo
    all_d2, all_idx = _gather_pairs(comm, d2, idx)  # (size, C, k)
    cand_d = all_d2.permute(1, 0, 2).reshape(C, -1)
    cand_i = all_idx.permute(1, 0, 2).reshape(C, -1)
    order = torch.sort(cand_d, dim=1, stable=True).indices[:, :k]
    return cand_d.gather(1, order), cand_i.gather(1, order)


# --------------------------------------------------------------------------
# the sharded pipeline
# --------------------------------------------------------------------------


def _gate_select(comm: _Comm, cfg: IcpConfig, Xf_l, lo_f: int, nf: int, Xm_l, m_sizes,
                 H0, dilate_l, mov_host, obs_host):
    """Stages 2-3, the overlap gate and the fixed-count selection, over the
    blocks: (Q (C, 3), sel_idx int32 (C,), sel_valid (C,), error). The gate
    is the brute 1-NN or the grid engine over the moved movable blocks, or
    the dilate gate's mask (``dilate_l``, this rank's rows of the mask rank
    0 computed); its survivor counts are the one host read."""
    C = cfg.correspondences
    dev = Xf_l.device
    if not cfg.overlap_enabled:
        host_idx, valid = _static_ungated_selection(nf, C)
        sel_idx = torch.as_tensor(host_idx, device=dev)
        return (_gather_rows(comm, Xf_l, lo_f, sel_idx), sel_idx,
                torch.as_tensor(valid, device=dev), ERR_OK)
    if cfg.gate_method == "dilate":
        sel_l = dilate_l
    else:
        # The initial transform applies before the gate, block by block.
        Xm0_l = apply_H(Xm_l, H0)
        radius = cfg.max_overlap_distance
        ring = cfg.gate_collective == "ring"
        if cfg.gate_method == "grid":
            origin = _global_origin(comm, Xm0_l)
            grid = _local_grid(Xm0_l, radius, origin)
            X_host = (None if mov_host is None or cfg.grid_cell_cap
                      else _initial_moved_host(mov_host, obs_host))
            cap = _grid_cap(comm, grid, cfg.grid_cell_cap, X_host, radius)
            d2 = _grid_gate_d2(comm, Xf_l, grid, m_sizes, radius, cap, ring, origin)
        else:
            d2 = (_ring_min_dist2 if ring else _allgather_min_dist2)(comm, Xf_l, Xm0_l, m_sizes)
        # The radius is cast to the coordinate dtype before it is squared.
        r = torch.tensor(radius, dtype=Xf_l.dtype, device=dev)
        sel_l = d2 <= r ** 2
    counts = read_array(comm.all_gather(sel_l.sum().reshape(1)))[:, 0]
    error = ERR_OK
    if counts.sum() == 0:
        # No fixed point survives: the selection runs over all of them and
        # the loop runs no iteration.
        error = ERR_NO_OVERLAP
        sel_l = torch.ones_like(sel_l)
        counts = _block_sizes(nf, comm.n)
    Q, sel_idx, valid, _ = _sharded_select_n(comm, sel_l, Xf_l, lo_f, C, nf, counts)
    return Q, sel_idx, valid, error


def _normals(comm: _Comm, cfg: IcpConfig, Q, sel_idx, Xf_l, lo_f: int, user_l):
    """Stage 4: the user's normals and planarity (``user_l``: this rank's
    rows of both) gathered at the selection, or the merged k-NN
    neighbourhoods' normals. Returns (normals (1, C, 3), planarity (1, C))."""
    if user_l is not None:
        nrm_l, pla_l = user_l
        return (_gather_rows(comm, nrm_l, lo_f, sel_idx)[None],
                _gather_rows(comm, pla_l[:, None], lo_f, sel_idx)[None, :, 0])
    _, idxk = _sharded_knn(comm, Q, Xf_l, lo_f, cfg.neighbors)
    neigh = _gather_rows(comm, Xf_l, lo_f, idxk)  # (C, k, 3)
    normals, planarity, _ = estimate_normals_from_neighborhoods(neigh[None])
    return normals, planarity


def _match_grid(comm: _Comm, cfg: IcpConfig, Xm_l, mov_host):
    """The sharded static-grid matcher's one-time cell lists: each rank's
    block of the untransformed movable cloud on the global lattice, at the
    match radius, and the cell cap (``_grid_cap``). Rigid motion preserves
    distances, so one build serves every iteration and every chunk."""
    rm = cfg.match_radius if cfg.match_radius > 0 else cfg.max_overlap_distance
    origin = _global_origin(comm, Xm_l)
    grid = _local_grid(Xm_l, rm, origin)
    X_host = None if cfg.match_cell_cap else mov_host
    return grid, origin, _grid_cap(comm, grid, cfg.match_cell_cap, X_host, rm)


def _match_fns(comm: _Comm, cfg: IcpConfig, Q, Xm_l, lo_m: int, match_grid):
    """The per-iteration collective matcher of the shared loop (one pair:
    Q (1, C, 3), Ht (1, 4, 4)) and its row gather. Brute: the match kernel
    over this rank's block, one launch, then ``_combine_nn``. Grid: each
    rank queries its cell list with the back-transformed queries; a match
    farther than the match radius is dropped, with index 0."""
    def gather_fn(m_idx):
        return _gather_rows(comm, Xm_l, lo_m, m_idx)

    if cfg.match_method == "grid":
        (pts, slots, order, run_end), origin, cap = match_grid
        rm = cfg.match_radius if cfg.match_radius > 0 else cfg.max_overlap_distance
        r = torch.tensor(rm, dtype=Q.dtype, device=Q.device)

        def match_fn(Ht):
            qb = back_transform(Q[0], Ht[0])
            d2_l = torch.full(qb.shape[:1], float("inf"), dtype=qb.dtype, device=qb.device)
            gidx_l = torch.zeros(qb.shape[:1], dtype=torch.int64, device=qb.device)
            if pts.shape[0]:
                d2_l, pos = grid_query_sorted(qb, pts, slots, origin, r, cell_cap=cap,
                                              run_end=run_end)
                gidx_l = order[pos] + lo_m
            d2, idx = _combine_nn(comm, d2_l, gidx_l)
            m_valid = d2 <= r * r
            m_idx = torch.where(m_valid, idx, 0).to(torch.int32)[None]
            m_orig = gather_fn(m_idx)
            return m_idx, apply_H(m_orig, Ht), m_orig, m_valid[None]
    else:
        def match_fn(Ht):
            d2_l, idx_l = match_transform(Q, Xm_l[None], Ht)
            _, m_idx = _combine_nn(comm, d2_l, idx_l.long() + lo_m)
            m_idx = m_idx.to(torch.int32)
            m_orig = gather_fn(m_idx)
            m_valid = torch.ones(m_idx.shape, dtype=torch.bool, device=m_idx.device)
            return m_idx, apply_H(m_orig, Ht), m_orig, m_valid

    return match_fn, gather_fn


def _plan_sharded(cfg: IcpConfig, nf: int, nm: int, ndev: int, *, guarded: bool,
                  has_normals: bool, gate_pairs: float):
    """(dispatch, chunk iterations) of a sharded run: the JAX package's
    sharded planner with the card's rates (``estimate_gpu_stage_seconds``)
    per device. The k-NN and the grid build divide over the mesh, the brute
    matcher's sweep too (each rank sweeps its block), the grid matcher's
    per-iteration gathers do not (the queries are replicated);
    ``gate_pairs`` are the brute gate's pairs a device. Guarded
    (``program_budget_s`` > 0 on the card): a run over the budget runs
    chunked, K iterations a call from half the budget; a largest
    indivisible program (the prologue, or one iteration) over 0.9 of the
    budget raises ValueError, as does an explicit "monolithic" over it.
    Unguarded, "auto" is monolithic and "chunked" without K takes 8."""
    dispatch, chunk_k = cfg.dispatch, cfg.chunk_iterations
    if not guarded:
        return ("monolithic" if dispatch == "auto" else dispatch), chunk_k or 8
    budget = cfg.program_budget_s
    gate_s, knn_s, build_s, per_iter_s = device_policy.estimate_gpu_stage_seconds(
        nf, nm, correspondences=cfg.correspondences, neighbors=cfg.neighbors,
        gate_pairs=gate_pairs, match_method=cfg.match_method,
        match_cell_cap=cfg.match_cell_cap, has_normals=has_normals,
    )
    knn_s /= ndev
    build_s /= ndev
    if cfg.match_method != "grid":
        per_iter_s /= ndev
    prologue_s = gate_s + knn_s + build_s
    est = prologue_s + min(10, cfg.max_iterations) * per_iter_s
    atom_s = max(prologue_s, per_iter_s)
    if atom_s > budget * 0.9:
        raise ValueError(
            f"this sharded configuration is estimated at ~{atom_s:.3g} s of card "
            f"time a device for its largest indivisible step (prologue "
            f"~{prologue_s:.3g} s, ~{per_iter_s:.3g} s per iteration): even "
            f"chunked dispatch would exceed program_budget_s={budget:g}. Use "
            "more devices, reduce `correspondences`, set a small `match_radius`, "
            "or raise or disable (0) program_budget_s."
        )
    if dispatch == "monolithic" and est > budget:
        raise ValueError(
            f"this sharded configuration is estimated at ~{est:.3g} s of card "
            f"time a device in one monolithic run, over program_budget_s="
            f"{budget:g}. Use dispatch='auto' or 'chunked' (the same result in "
            "bounded chunks), more devices, or raise or disable (0) "
            "program_budget_s."
        )
    if dispatch == "auto":
        dispatch = "monolithic" if est <= budget else "chunked"
    if dispatch == "chunked" and chunk_k == 0:
        chunk_k = max(1, int((budget * 0.5) / max(per_iter_s, 1e-9)))
    _log.info(
        "sharded dispatch plan: %s over %d devices (est %.1f s/device = gate %.1f "
        "+ knn %.1f + build %.1f + %.2f s/iter%s; budget %g s)",
        dispatch, ndev, est, gate_s, knn_s, build_s, per_iter_s,
        f", K={chunk_k}" if dispatch == "chunked" else "", budget,
    )
    return dispatch, chunk_k


_GATE_CODES = ("brute", "grid", "dilate", "refused")


def _resolve_gate_sharded(comm: _Comm, cfg: IcpConfig, nf: int, nm: int, whole, H0,
                          multihost: bool, lo_f: int, hi_f: int):
    """The gate method of an enabled "auto" (above 2^40 pairs) or "dilate"
    gate, and this rank's rows of the dilate mask (else None). Where one
    process holds both whole clouds (``whole()``: them on this device),
    rank 0 plans the dilate gate over the moved cloud's bounding box and,
    with a plan, computes the mask (the dilate kernel); the method and the
    mask are broadcast. Multi-host runs keep the brute and grid engines,
    as the JAX package's do."""
    if multihost:
        if cfg.gate_method == "dilate":
            raise _dilate_refused()
        return ("grid" if nf * nm > GATE_AUTO_GRID_PAIRS else "brute"), None
    code = torch.zeros(1, dtype=torch.int64, device=H0.device)
    mask = None
    if comm.rank == 0:
        Xf, Xm = whole()
        Xm0 = apply_H(Xm, H0)
        try:
            method, plan = _resolve_gate(cfg, nf, nm, lambda: read_array(bbox_of(Xm0)))
        except ValueError:
            method, plan = "refused", None
        code[0] = _GATE_CODES.index(method)
        if plan is not None:
            mask = overlap_mask_dilate(Xf, Xm0, cfg.max_overlap_distance, plan)
    method = _GATE_CODES[int(read_array(comm.broadcast(code, 0))[0])]
    if method == "refused":
        raise _dilate_refused()
    if method != "dilate":
        return method, None
    if mask is None:
        mask = torch.empty(nf, dtype=torch.uint8, device=H0.device)
    return method, comm.broadcast(mask.to(torch.uint8), 0)[lo_f:hi_f].bool()


def _dilate_refused() -> ValueError:
    return ValueError(
        "gate_method='dilate' needs a single-process run and a dense cell grid "
        "over the movable bounding box — use 'grid' or 'auto'."
    )


def icp_register_sharded(
    X_fix,
    X_mov,
    cfg: IcpConfig = IcpConfig(),
    *,
    mesh: Optional[Mesh] = None,
    rbp_observed_values=None,
    rbp_observation_weights=None,
    normals_fix=None,
    planarity_fix=None,
    planarity_mov=None,
    fixed_prep: Optional[FixedPrep] = None,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
) -> IcpResult:
    """Multi-device registration: ``icp_register``'s contract and result,
    bit for bit, with both clouds sharded over ``mesh`` (by default the
    whole default process group, ``make_mesh()``).

    Every rank of the mesh calls it with the same arguments: the whole
    clouds (numpy arrays or tensors), of which each rank moves only its row
    block to its device. The result is replicated: every rank returns the
    same tensors, on its device. ``sel_idx`` and ``iter_midx`` index the
    original clouds (the blocks are contiguous).

    ``fixed_prep`` (``prepare_fixed``, on this rank's device) replaces the
    selection and the normals as in ``icp_register``; under sharding it also
    needs at least ``correspondences`` fixed points, as in the JAX package.
    The warm start and the dilate gate's mask run on rank 0 where one
    process holds both whole clouds (``SimpleICP.run(num_devices=n)``,
    ``parallel.launch``), and are refused under ``initialize_multihost``,
    where "auto" keeps the brute and grid gates. ``device`` is the card of
    this rank by default (an error without one); "cpu" runs the plain
    versions (a gloo mesh). ``query_tile`` and ``ref_tile`` change nothing
    here, as elsewhere in the port."""
    return _icp_register_sharded(
        X_fix, X_mov, cfg, mesh=mesh, rbp_observed_values=rbp_observed_values,
        rbp_observation_weights=rbp_observation_weights, normals_fix=normals_fix,
        planarity_fix=planarity_fix, planarity_mov=planarity_mov,
        fixed_prep=fixed_prep, device=device, dtype=dtype,
    )[0]


def _icp_register_sharded(X_fix, X_mov, cfg: IcpConfig, *, mesh, rbp_observed_values,
                          rbp_observation_weights, normals_fix, planarity_fix,
                          planarity_mov, fixed_prep, device, dtype):
    """``icp_register_sharded``, also returning the loop's final state (its
    ``m_idx``: the last iteration's matches)."""
    if mesh is None:
        mesh = make_mesh()
    if mesh.rank is None:
        raise ValueError("this process is not in the mesh: only the mesh's ranks "
                         "call icp_register_sharded")
    dev, dtype = resolve(device, dtype)
    if mesh.backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL mesh moves CUDA tensors only: run on the card, "
                         "or make the process group with the gloo backend")
    comm = _Comm(mesh, dev)
    n, me = mesh.size, mesh.rank
    # A movable cloud that came as numpy has the grid engines count their
    # cell caps on the host, as in icp_register; a tensor, on the devices.
    mov_host = X_mov if isinstance(X_mov, np.ndarray) else None
    X_fix = X_fix if isinstance(X_fix, torch.Tensor) else np.asarray(X_fix)
    X_mov = X_mov if isinstance(X_mov, torch.Tensor) else np.asarray(X_mov)
    if (X_fix.ndim != 2 or X_fix.shape[1] != 3 or X_mov.ndim != 2
            or X_mov.shape[1] != 3):
        raise ValueError("point clouds must have shape (n, 3)")
    nf, nm = int(X_fix.shape[0]), int(X_mov.shape[0])
    C = cfg.correspondences
    if fixed_prep is not None and nf < C:
        # below C the sharded and host selection engines fill the masked
        # padding slots differently in the JAX package
        raise ValueError(
            "fixed_prep under sharding requires at least `correspondences` "
            "fixed points (the sharded and host selection engines fill sub-C "
            "padding slots differently)"
        )
    _check_round_linspace_domain(C, nf)
    if fixed_prep is not None:
        _validate_fixed_prep(fixed_prep, nf, cfg, dtype, dev, normals_fix,
                             "icp_register_sharded")

    def whole():
        """Both whole clouds on this device (rank 0's single-process stages)."""
        return _as_tensor(X_fix, dtype, dev), _as_tensor(X_mov, dtype, dev)

    cfg = _resolve_engines(cfg, nf, nm)
    if cfg.warm_start:
        if mesh.multihost:
            raise ValueError(
                "warm_start is not supported multi-host (no process holds the "
                "whole cloud for the coarse pass); pass a coarse result as "
                "rbp_observed_values with zero weights instead."
            )
        # Rank 0 runs the coarse pass on the whole clouds and broadcasts the
        # six values the full run starts from.
        vals = torch.zeros(6, dtype=torch.float64, device=dev)
        if me == 0:
            Xf, Xm = whole()
            user = (None, None) if normals_fix is None else (
                _as_tensor(normals_fix, dtype, dev),
                None if planarity_fix is None else _as_tensor(planarity_fix, dtype, dev))
            _, obs = plan_warm_start(
                Xf, Xm, cfg, rbp_observed_values=rbp_observed_values,
                rbp_observation_weights=rbp_observation_weights,
                normals_fix=user[0], planarity_fix=user[1],
                planarity_mov=(None if planarity_mov is None
                               else _as_tensor(planarity_mov, dtype, dev)),
                device=dev, dtype=dtype,
            )
            if obs is not None:
                vals = _as_tensor(obs, torch.float64, dev)
        rbp_observed_values = read_array(comm.broadcast(vals, 0))
        cfg = dataclasses.replace(cfg, warm_start=False)

    zeros6 = torch.zeros(6, dtype=dtype, device=dev)
    obs_vals = (zeros6 if rbp_observed_values is None
                else _as_tensor(rbp_observed_values, dtype, dev))
    obs_w = (zeros6 if rbp_observation_weights is None
             else _as_tensor(rbp_observation_weights, dtype, dev))
    H0 = rbp_to_H(obs_vals)

    lo_f, hi_f = _block(nf, n, me)
    lo_m, hi_m = _block(nm, n, me)
    dilate_l = None
    if cfg.overlap_enabled and cfg.gate_method in ("auto", "dilate"):
        method, dilate_l = _resolve_gate_sharded(comm, cfg, nf, nm, whole, H0,
                                                 mesh.multihost, lo_f, hi_f)
        cfg = dataclasses.replace(cfg, gate_method=method)
    Xf_l = _as_tensor(X_fix[lo_f:hi_f], dtype, dev)
    Xm_l = _as_tensor(X_mov[lo_m:hi_m], dtype, dev)

    has_normals = normals_fix is not None or fixed_prep is not None
    match_grid = (_match_grid(comm, cfg, Xm_l, mov_host)
                  if cfg.match_method == "grid" else None)
    plan_cfg = (cfg if match_grid is None
                else dataclasses.replace(cfg, match_cell_cap=match_grid[2]))
    dispatch, chunk_k = _plan_sharded(
        plan_cfg, nf, nm, n,
        guarded=cfg.program_budget_s > 0 and dev.type == "cuda",
        has_normals=has_normals,
        gate_pairs=(float(nf) * nm / n
                    if cfg.overlap_enabled and cfg.gate_method == "brute" else 0.0),
    )

    if fixed_prep is None:
        Q, sel_idx, sel_valid, error = _gate_select(
            comm, cfg, Xf_l, lo_f, nf, Xm_l, _block_sizes(nm, n), H0, dilate_l,
            mov_host, rbp_observed_values)
        user_l = None
        if normals_fix is not None:
            user_l = (_as_tensor(normals_fix[lo_f:hi_f], dtype, dev),
                      torch.ones(hi_f - lo_f, dtype=dtype, device=dev)
                      if planarity_fix is None
                      else _as_tensor(planarity_fix[lo_f:hi_f], dtype, dev))
        normals, planarity = _normals(comm, cfg, Q, sel_idx, Xf_l, lo_f, user_l)
        Q, sel_idx, sel_valid = Q[None], sel_idx[None], sel_valid[None]
    else:
        Q, normals, planarity, sel_idx, sel_valid = (t[None] for t in fixed_prep[:5])
        error = ERR_OK
    error0 = np.full(1, error, np.int32)

    mov_planarity_fn = None
    if planarity_mov is not None:
        pmov_l = _as_tensor(planarity_mov[lo_m:hi_m], dtype, dev)

        def mov_planarity_fn(m_idx):
            return _gather_rows(comm, pmov_l[:, None], lo_m, m_idx)[..., 0]

    match_fn, gather_fn = _match_fns(comm, cfg, Q, Xm_l, lo_m, match_grid)
    loop_args = (Q, normals, planarity, sel_valid, obs_vals[None], obs_w[None], cfg,
                 dtype, error0, H0[None], match_fn)
    # A monolithic run is one chunk of max_iterations. Every rank reads the
    # same replicated stop flag at the same iteration.
    comm.stage = "loop"
    final = _run_chunked(
        make_carry_init(cfg, dtype, obs_vals[None], H0[None], error0),
        chunk_k if dispatch == "chunked" else cfg.max_iterations,
        lambda c, hi: run_icp_loop(*loop_args, mov_planarity_fn=mov_planarity_fn,
                                   carry_in=c, it_hi=hi),
        cfg=cfg, per_iter_est=0.0,
    )
    comm.stage = "uncertainty"
    uncertainties, covariance = _uncertainties(
        final, Q, normals, obs_vals[None], obs_w[None], gather_fn)
    result = _result_from_carry(final, uncertainties, covariance, sel_idx, sel_valid,
                                normals, planarity)
    return _first(result), _first(final)


def register_jobs(jobs: list) -> list:
    """``icp_register_sharded`` over the whole default process group for
    each job (a dict of its keyword arguments), every result's tensors moved
    to the CPU: the per-rank function that ``parallel.launch.run`` calls for
    ``SimpleICP.run(num_devices=n)``."""
    mesh = make_mesh()
    return [IcpResult(*(t.cpu() for t in icp_register_sharded(mesh=mesh, **job)))
            for job in jobs]


def register_sharded(X_fix, X_mov, cfg: IcpConfig, *, mesh: Optional[Mesh] = None,
                     num_devices: int = 0, **kwargs) -> IcpResult:
    """The sharded registration of ``SimpleICP.run(mesh=..., num_devices=...)``:
    over ``mesh``; else, in a process group, over ``make_mesh(num_devices)``
    (every rank calls it); else over ``num_devices`` new processes, one a
    device (``launch.run``), returning rank 0's result (on the CPU).
    ``kwargs`` are ``icp_register_sharded``'s."""
    if mesh is None and not dist.is_initialized():
        from .launch import run

        job = dict(X_fix=X_fix, X_mov=X_mov, cfg=cfg, **kwargs)
        return run(num_devices, register_jobs, [job], device=kwargs.get("device"))[0][0]
    if mesh is None:
        mesh = make_mesh(num_devices or None)
    return icp_register_sharded(X_fix, X_mov, cfg, mesh=mesh, **kwargs)
