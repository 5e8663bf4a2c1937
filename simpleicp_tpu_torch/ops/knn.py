"""Nearest-neighbour search: exact squared distances, first-minimum ties.

The contract of the JAX package's lax functions (``simpleicp_tpu/ops/knn.py``):

* distances are exact per-coordinate squared differences,
  ``((qx-rx)^2 + (qy-ry)^2) + (qz-rz)^2`` with each square written as
  ``d*d`` — never the |q|^2+|r|^2-2q.r identity, which cancels badly when
  the coordinates are large against the point spacing;
* masked references never win, and a query with no valid reference gets
  d2 = +inf;
* ties go to the lower reference index, and k results come in ascending
  order of (d2, index).

Each function dispatches on the device of its query tensor: on the CPU it
runs the plain PyTorch version defined here, on a CUDA tensor it launches
the hand-written kernel of ``knn_cuda`` (which raises if it cannot launch;
there is no fallback to the plain version). The plain versions are also the
reference the kernels are held against on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import knn_cuda
from .transform import apply_H

# Largest (queries x refs) distance block the plain versions materialize at
# once (2^24 elements = 128 MB in float64).
_PLAIN_BLOCK_ELEMS = 1 << 24


def _dist2_block(Q: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """(q, r) exact squared distances, as unfused elementwise operations in
    the order the kernels use."""
    d = Q[:, 0:1] - R[None, :, 0]
    d2 = d * d
    d = Q[:, 1:2] - R[None, :, 1]
    d2 = d2 + d * d
    d = Q[:, 2:3] - R[None, :, 2]
    d2 = d2 + d * d
    return d2


def _query_chunks(n_q: int, n_r: int):
    step = max(1, _PLAIN_BLOCK_ELEMS // max(n_r, 1))
    for lo in range(0, n_q, step):
        yield lo, min(n_q, lo + step)


def _check_points(name: str, X: torch.Tensor) -> None:
    if X.dim() != 2 or X.shape[1] != 3:
        raise ValueError(f"{name} must have shape (n, 3), got {tuple(X.shape)}")


def _no_refs(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 1-NN result of queries with no valid reference: +inf, index 0."""
    n_q = queries.shape[0]
    return (torch.full((n_q,), float("inf"), dtype=queries.dtype, device=queries.device),
            torch.zeros((n_q,), dtype=torch.int32, device=queries.device))


def nn_search_plain(queries: torch.Tensor, refs: torch.Tensor,
                    ref_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``nn_search``: query-chunked exact distances and
    ``torch.argmin`` (first minimum)."""
    n_q, n_r = queries.shape[0], refs.shape[0]
    d2_out, idx_out = _no_refs(queries)
    if n_r == 0:
        return d2_out, idx_out
    for lo, hi in _query_chunks(n_q, n_r):
        d2 = _dist2_block(queries[lo:hi], refs)
        if ref_mask is not None:
            d2 = torch.where(ref_mask[None, :], d2, torch.full_like(d2, float("inf")))
        idx = torch.argmin(d2, dim=1)
        d2_out[lo:hi] = torch.gather(d2, 1, idx[:, None])[:, 0]
        idx_out[lo:hi] = idx.to(torch.int32)
    return d2_out, idx_out


def knn_search_plain(queries: torch.Tensor, refs: torch.Tensor, k: int,
                     ref_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``knn_search``: query-chunked exact distances and a
    stable ascending sort cut to the first k (ties to the lower index)."""
    n_q, n_r = queries.shape[0], refs.shape[0]
    d2_out = torch.empty((n_q, k), dtype=queries.dtype, device=queries.device)
    idx_out = torch.empty((n_q, k), dtype=torch.int32, device=queries.device)
    for lo, hi in _query_chunks(n_q, n_r):
        d2 = _dist2_block(queries[lo:hi], refs)
        if ref_mask is not None:
            d2 = torch.where(ref_mask[None, :], d2, torch.full_like(d2, float("inf")))
        vals, idx = torch.sort(d2, dim=1, stable=True)
        d2_out[lo:hi] = vals[:, :k]
        idx_out[lo:hi] = idx[:, :k].to(torch.int32)
    return d2_out, idx_out


def match_transform_plain(queries: torch.Tensor, refs: torch.Tensor,
                          H: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``match_transform``: transform the whole cloud with
    ``apply_H`` (the kernel's arithmetic order), then ``nn_search_plain``."""
    return nn_search_plain(queries, apply_H(refs, H))


def _on_device(queries: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain)."""
    if queries.device.type == "cuda":
        return True
    if queries.device.type != "cpu":
        raise ValueError(f"unsupported device {queries.device}")
    return False


def nn_search(queries: torch.Tensor, refs: torch.Tensor, *,
              ref_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single nearest neighbour of each query among refs.

    Returns (dist2, idx) of shapes (q,), (q,) int32; dist2 is +inf and idx 0
    when no valid reference exists. On a CUDA tensor this is the 1-NN
    kernel of the overlap gate.
    """
    _check_points("queries", queries)
    _check_points("refs", refs)
    if refs.shape[0] == 0:
        return _no_refs(queries)
    if _on_device(queries):
        return knn_cuda.nn_search_cuda(queries, refs, ref_mask)
    return nn_search_plain(queries, refs, ref_mask)


def nn_search_auto(queries: torch.Tensor, refs: torch.Tensor, *,
                   ref_tile: int = 4096, query_tile: int = 2048,
                   ref_mask: Optional[torch.Tensor] = None,
                   use_pallas: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nn_search`` under the JAX package's signature of the gate's
    dispatcher. ``ref_tile``, ``query_tile`` and ``use_pallas`` choose TPU
    tiles and kernels there and change no result by contract, so they are
    accepted and ignored: this is always ``nn_search``."""
    del ref_tile, query_tile, use_pallas
    return nn_search(queries, refs, ref_mask=ref_mask)


def knn_search(queries: torch.Tensor, refs: torch.Tensor, k: int, *,
               ref_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each query among refs, ascending.

    Returns (dist2, idx) of shapes (q, k), (q, k) int32. Slots past the
    valid references hold d2 = +inf (and the lowest masked indices).
    """
    _check_points("queries", queries)
    _check_points("refs", refs)
    n_r = refs.shape[0]
    if k > n_r:
        raise ValueError(f"k={k} exceeds number of reference points {n_r}")
    if _on_device(queries):
        return knn_cuda.knn_search_cuda(queries, refs, k, ref_mask)
    return knn_search_plain(queries, refs, k, ref_mask)


def match_transform(queries: torch.Tensor, refs: torch.Tensor,
                    H: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each query among ``apply_H(refs, H)``.

    On the card the transform is fused into the kernel, so the moved cloud
    never reaches device memory. Args: queries (q, 3), refs (n, 3) the
    untransformed cloud, H (4, 4) or (3, 4). Returns (dist2, idx) of shapes
    (q,), (q,) int32.
    """
    _check_points("queries", queries)
    _check_points("refs", refs)
    if refs.shape[0] == 0:
        return _no_refs(queries)
    if _on_device(queries):
        return knn_cuda.match_transform_cuda(queries, refs, H)
    return match_transform_plain(queries, refs, H)


def min_dist_sq(queries: torch.Tensor, refs: torch.Tensor, **kw) -> torch.Tensor:
    """Squared distance from each query to its nearest reference point."""
    d2, _ = nn_search(queries, refs, **kw)
    return d2
