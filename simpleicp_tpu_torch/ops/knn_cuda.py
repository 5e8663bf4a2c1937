"""ctypes wrappers of the three nearest-neighbour kernels in ``csrc/knn.cu``.

Each wrapper checks its tensors, allocates the outputs and the partials
scratch with ``torch.empty``, launches the kernel's two passes on PyTorch's
current stream and raises if ``cudaGetLastError`` reports a failure. It
never synchronizes and never falls back to a plain version. Each launch
adds one to its kernel's entry in ``LAUNCHES``; nothing else touches the
counts but ``reset_launch_counts``. A launch's grid holds at most
``_MAX_QUERIES`` queries: the 1-NN wrapper launches once per slice of that
many, the other two raise above it.

The library is built by ``_build.build`` at the first call, not at
import, so importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from .. import _build

# Launches per kernel since the last reset_launch_counts().
LAUNCHES = {"match_transform": 0, "knn_search": 0, "nn_search": 0}

MAX_K = 64          # csrc/knn.cu kMaxK
_THREADS = 256      # csrc/knn.cu kThreads: queries per block
_SM_COUNT_H100 = 132
# Blocks the first pass aims for: two waves of 8 resident 256-thread blocks
# on each of the H100's SMs.
_TARGET_BLOCKS = 2 * 8 * _SM_COUNT_H100
_MIN_CHUNK = 32     # fewest references a block scans
_MAX_QUERIES = 65535 * _THREADS  # queries per launch (grid rows of blocks)

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build("knn")))
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"simpleicp_match_transform_{suffix}")
                # q, nq, refs, n, h, chunk_len, n_chunks, part_d, part_i,
                # out_d, out_i, stream
                fn.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P]
                fn.restype = _I
                fn = getattr(lib, f"simpleicp_nn_{suffix}")
                # q, nq, refs, n, mask, chunk_len, n_chunks, part_d, part_i,
                # out_d, out_i, stream
                fn.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P]
                fn.restype = _I
                fn = getattr(lib, f"simpleicp_knn_{suffix}")
                # q, nq, refs, n, mask, k, chunk_len, n_chunks, part_d,
                # part_i, out_d, out_i, stream
                fn.argtypes = [_P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P]
                fn.restype = _I
            _lib = lib
        return _lib


def _suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"the kernels take float32 or float64, got {dtype}")


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtype: torch.dtype, shape: Tuple[Optional[int], ...]) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != ts for s, ts in zip(shape, t.shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _plan_chunks(n_q: int, n_r: int) -> Tuple[int, int]:
    """(chunk_len, n_chunks) of the reference axis: enough blocks to fill
    the card even when there are few queries, and no chunk under
    _MIN_CHUNK references."""
    q_blocks = -(-n_q // _THREADS)
    want = max(1, min(-(-n_r // _MIN_CHUNK), -(-_TARGET_BLOCKS // q_blocks)))
    chunk_len = -(-n_r // want)
    return chunk_len, -(-n_r // chunk_len)


def _common(queries: torch.Tensor, refs: torch.Tensor):
    if queries.device.type != "cuda":
        raise ValueError(f"queries must be a CUDA tensor, got {queries.device}")
    dev, dtype = queries.device, queries.dtype
    suffix = _suffix(dtype)
    _check("queries", queries, dev, dtype, (None, 3))
    _check("refs", refs, dev, dtype, (None, 3))
    n_q, n_r = queries.shape[0], refs.shape[0]
    if n_r < 1:
        raise ValueError("refs must hold at least one point")
    if n_q >= 2**31 or n_r >= 2**31 // 3:
        raise ValueError("too many points for int32 indexing")
    return dev, dtype, suffix, n_q, n_r


def _one_launch(n_q: int) -> None:
    if n_q > _MAX_QUERIES:
        raise ValueError(f"at most {_MAX_QUERIES} queries per launch")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def match_transform_cuda(queries: torch.Tensor, refs: torch.Tensor,
                         H: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel of ``knn.match_transform``: 1-NN of each query among the refs
    moved by H's [R | t], read by the kernel from device memory."""
    dev, dtype, suffix, n_q, n_r = _common(queries, refs)
    _one_launch(n_q)
    if H.shape == (4, 4):
        H = H[:3]
    _check("H", H, dev, dtype, (3, 4))
    out_d = torch.empty((n_q,), dtype=dtype, device=dev)
    out_i = torch.empty((n_q,), dtype=torch.int32, device=dev)
    if n_q == 0:
        return out_d, out_i
    chunk_len, n_chunks = _plan_chunks(n_q, n_r)
    part_d = torch.empty((n_chunks, n_q), dtype=dtype, device=dev)
    part_i = torch.empty((n_chunks, n_q), dtype=torch.int32, device=dev)
    fn = getattr(_library(), f"simpleicp_match_transform_{suffix}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(queries.data_ptr(), n_q, refs.data_ptr(), n_r, H.data_ptr(),
                 chunk_len, n_chunks, part_d.data_ptr(), part_i.data_ptr(),
                 out_d.data_ptr(), out_i.data_ptr(), stream)
    _raise_on(err, "match_transform")
    LAUNCHES["match_transform"] += 1
    return out_d, out_i


def knn_search_cuda(queries: torch.Tensor, refs: torch.Tensor, k: int,
                    ref_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel of ``knn.knn_search``: the k smallest (d2, index) pairs per
    query in lexicographic order; masked refs count as d2 = +inf."""
    dev, dtype, suffix, n_q, n_r = _common(queries, refs)
    _one_launch(n_q)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the k-NN kernel takes 1 <= k <= {MAX_K}, got {k}")
    if k > n_r:
        raise ValueError(f"k={k} exceeds number of reference points {n_r}")
    if ref_mask is not None:
        _check("ref_mask", ref_mask, dev, torch.bool, (n_r,))
    out_d = torch.empty((n_q, k), dtype=dtype, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    if n_q == 0:
        return out_d, out_i
    chunk_len, n_chunks = _plan_chunks(n_q, n_r)
    part_d = torch.empty((n_chunks, k, n_q), dtype=dtype, device=dev)
    part_i = torch.empty((n_chunks, k, n_q), dtype=torch.int32, device=dev)
    fn = getattr(_library(), f"simpleicp_knn_{suffix}")
    mask_ptr = None if ref_mask is None else ref_mask.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(queries.data_ptr(), n_q, refs.data_ptr(), n_r, mask_ptr, k,
                 chunk_len, n_chunks, part_d.data_ptr(), part_i.data_ptr(),
                 out_d.data_ptr(), out_i.data_ptr(), stream)
    _raise_on(err, "knn_search")
    LAUNCHES["knn_search"] += 1
    return out_d, out_i


def nn_search_cuda(queries: torch.Tensor, refs: torch.Tensor,
                   ref_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel of ``knn.nn_search``: the first-minimum 1-NN of each query;
    masked refs never win, and a query with no valid ref gets d2 = +inf and
    index 0. Queries beyond one launch's grid go in slices of
    ``_MAX_QUERIES``, one launch each; no query's result depends on
    another's."""
    dev, dtype, suffix, n_q, n_r = _common(queries, refs)
    if ref_mask is not None:
        _check("ref_mask", ref_mask, dev, torch.bool, (n_r,))
    out_d = torch.empty((n_q,), dtype=dtype, device=dev)
    out_i = torch.empty((n_q,), dtype=torch.int32, device=dev)
    if n_q == 0:
        return out_d, out_i
    fn = getattr(_library(), f"simpleicp_nn_{suffix}")
    mask_ptr = None if ref_mask is None else ref_mask.data_ptr()
    for s in range(0, n_q, _MAX_QUERIES):
        n = min(_MAX_QUERIES, n_q - s)
        chunk_len, n_chunks = _plan_chunks(n, n_r)
        part_d = torch.empty((n_chunks, n), dtype=dtype, device=dev)
        part_i = torch.empty((n_chunks, n), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(queries[s:].data_ptr(), n, refs.data_ptr(), n_r, mask_ptr,
                     chunk_len, n_chunks, part_d.data_ptr(), part_i.data_ptr(),
                     out_d[s:].data_ptr(), out_i[s:].data_ptr(), stream)
        _raise_on(err, "nn_search")
        LAUNCHES["nn_search"] += 1
    return out_d, out_i
