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

Each function takes one cloud pair (queries (q, 3), refs (n, 3)) or a batch
of pairs with a leading pair axis (queries (B, q, 3), refs (B, n, 3), one
answer per pair, each pair's the same as alone), and dispatches on the
device of its query tensor: on the CPU it
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

# Largest (pairs x queries x refs) distance block the plain versions
# materialize at once (2^24 elements = 128 MB in float64), whatever the
# batch.
_PLAIN_BLOCK_ELEMS = 1 << 24


def as_pairs(queries: torch.Tensor, refs: torch.Tensor,
             ref_mask: Optional[torch.Tensor] = None):
    """(queries, refs, ref_mask, unbatched): the arguments with a leading
    pair axis, (B, q, 3), (B, n, 3), (B, n), and whether they came as one
    pair, (q, 3), (n, 3), (n,) (then B is 1). Raises ValueError on any other
    shape of the clouds (a mask's shape is the callee's to check)."""
    for name, X in (("queries", queries), ("refs", refs)):
        if X.dim() not in (2, 3) or X.shape[-1] != 3:
            raise ValueError(f"{name} must have shape (n, 3) or (B, n, 3), "
                             f"got {tuple(X.shape)}")
    if queries.dim() != refs.dim() or queries.shape[:-2] != refs.shape[:-2]:
        raise ValueError(f"queries {tuple(queries.shape)} and refs "
                         f"{tuple(refs.shape)} must have the same pair axis")
    if queries.dim() == 3:
        return queries, refs, ref_mask, False
    return queries[None], refs[None], None if ref_mask is None else ref_mask[None], True


def unpair(one: bool, *outs):
    """The outputs of a call on ``as_pairs``' arguments, without the pair
    axis when the call came as one pair."""
    return tuple(o[0] if one and o is not None else o for o in outs)


def _dist2_block(Q: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """(b, q, r) exact squared distances of (b, q, 3) queries to (b, r, 3)
    refs, as unfused elementwise operations in the order the kernels use."""
    d = Q[..., :, 0:1] - R[..., None, :, 0]
    d2 = d * d
    d = Q[..., :, 1:2] - R[..., None, :, 1]
    d2 = d2 + d * d
    d = Q[..., :, 2:3] - R[..., None, :, 2]
    d2 = d2 + d * d
    return d2


def _blocks(n_pairs: int, n_q: int, n_r: int):
    """(pair slice, query slice) blocks whose distance blocks stay within
    _PLAIN_BLOCK_ELEMS: whole pairs when one fits, else query chunks of one
    pair (at least one query)."""
    per_pair = n_q * max(n_r, 1)
    if per_pair <= _PLAIN_BLOCK_ELEMS:
        step = max(1, _PLAIN_BLOCK_ELEMS // max(per_pair, 1))
        for b in range(0, n_pairs, step):
            yield slice(b, min(n_pairs, b + step)), slice(0, n_q)
        return
    step = max(1, _PLAIN_BLOCK_ELEMS // max(n_r, 1))
    for b in range(n_pairs):
        for lo in range(0, n_q, step):
            yield slice(b, b + 1), slice(lo, min(n_q, lo + step))


def _masked(d2: torch.Tensor, ref_mask: Optional[torch.Tensor], pairs: slice):
    if ref_mask is None:
        return d2
    return torch.where(ref_mask[pairs, None, :], d2, torch.full_like(d2, float("inf")))


def _no_refs(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 1-NN result of queries (..., q, 3) with no valid reference:
    +inf, index 0."""
    shape = queries.shape[:-1]
    return (torch.full(shape, float("inf"), dtype=queries.dtype, device=queries.device),
            torch.zeros(shape, dtype=torch.int32, device=queries.device))


def nn_search_plain(queries: torch.Tensor, refs: torch.Tensor,
                    ref_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``nn_search``: blocked exact distances and
    ``torch.argmin`` (first minimum)."""
    queries, refs, ref_mask, one = as_pairs(queries, refs, ref_mask)
    (n_pairs, n_q), n_r = queries.shape[:2], refs.shape[1]
    d2_out, idx_out = _no_refs(queries)
    if n_r > 0:
        for b, q in _blocks(n_pairs, n_q, n_r):
            d2 = _masked(_dist2_block(queries[b, q], refs[b]), ref_mask, b)
            idx = torch.argmin(d2, dim=-1)
            d2_out[b, q] = torch.gather(d2, -1, idx[..., None])[..., 0]
            idx_out[b, q] = idx.to(torch.int32)
    return unpair(one, d2_out, idx_out)


def knn_search_plain(queries: torch.Tensor, refs: torch.Tensor, k: int,
                     ref_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``knn_search``: blocked exact distances and a stable
    ascending sort cut to the first k (ties to the lower index)."""
    queries, refs, ref_mask, one = as_pairs(queries, refs, ref_mask)
    (n_pairs, n_q), n_r = queries.shape[:2], refs.shape[1]
    d2_out = torch.empty((n_pairs, n_q, k), dtype=queries.dtype, device=queries.device)
    idx_out = torch.empty((n_pairs, n_q, k), dtype=torch.int32, device=queries.device)
    for b, q in _blocks(n_pairs, n_q, n_r):
        d2 = _masked(_dist2_block(queries[b, q], refs[b]), ref_mask, b)
        vals, idx = torch.sort(d2, dim=-1, stable=True)
        d2_out[b, q] = vals[..., :k]
        idx_out[b, q] = idx[..., :k].to(torch.int32)
    return unpair(one, d2_out, idx_out)


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

    Returns (dist2, idx) of shapes (q,), (q,) int32 (with the pair axis:
    (B, q)); dist2 is +inf and idx 0 when no valid reference exists. On a
    CUDA tensor this is the 1-NN kernel of the overlap gate.
    """
    queries, refs, ref_mask, one = as_pairs(queries, refs, ref_mask)
    if refs.shape[1] == 0:
        return unpair(one, *_no_refs(queries))
    if _on_device(queries):
        return unpair(one, *knn_cuda.nn_search_cuda(queries, refs, ref_mask))
    return unpair(one, *nn_search_plain(queries, refs, ref_mask))


def knn_search(queries: torch.Tensor, refs: torch.Tensor, k: int, *,
               ref_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each query among refs, ascending.

    Returns (dist2, idx) of shapes (q, k), (q, k) int32 (with the pair
    axis: (B, q, k)). Slots past the valid references hold d2 = +inf (and
    the lowest masked indices).
    """
    queries, refs, ref_mask, one = as_pairs(queries, refs, ref_mask)
    n_r = refs.shape[1]
    if k > n_r:
        raise ValueError(f"k={k} exceeds number of reference points {n_r}")
    if _on_device(queries):
        return unpair(one, *knn_cuda.knn_search_cuda(queries, refs, k, ref_mask))
    return unpair(one, *knn_search_plain(queries, refs, k, ref_mask))


def match_transform(queries: torch.Tensor, refs: torch.Tensor,
                    H: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each query among ``apply_H(refs, H)``.

    On the card the transform is fused into the kernel, so the moved cloud
    never reaches device memory. Args: queries (q, 3), refs (n, 3) the
    untransformed cloud, H (4, 4) or (3, 4); with the pair axis (B, q, 3),
    (B, n, 3) and one H per pair, (B, 4, 4) or (B, 3, 4). Returns (dist2,
    idx) of shapes (q,), (q,) int32, or (B, q).
    """
    queries, refs, _, one = as_pairs(queries, refs)
    if one:
        H = H[None]
    if refs.shape[1] == 0:
        return unpair(one, *_no_refs(queries))
    if _on_device(queries):
        return unpair(one, *knn_cuda.match_transform_cuda(queries, refs, H))
    return unpair(one, *match_transform_plain(queries, refs, H))


def min_dist_sq(queries: torch.Tensor, refs: torch.Tensor, *,
                ref_tile: int = 4096, query_tile: int = 2048,
                layout: str = "qt",
                ref_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared distance from each query to its nearest reference point,
    under the JAX package's signature: ``nn_search``'s d2 (+inf where no
    reference is valid) without its index, (q,) or with the pair axis
    (B, q). On a CUDA tensor this is the 1-NN kernel's d2-only mode.
    ``ref_tile``, ``query_tile`` and ``layout`` choose TPU tiles there and
    change no result, so they are accepted and ignored."""
    del ref_tile, query_tile, layout
    queries, refs, ref_mask, one = as_pairs(queries, refs, ref_mask)
    if refs.shape[1] == 0:
        d2 = _no_refs(queries)[0]
    elif _on_device(queries):
        d2 = knn_cuda.nn_d2_cuda(queries, refs, ref_mask)
    else:
        d2 = nn_search_plain(queries, refs, ref_mask)[0]
    return unpair(one, d2)[0]
