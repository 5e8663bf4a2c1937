"""ctypes wrappers of the nearest-neighbour kernels in ``csrc/knn.cu``.

Each wrapper checks its tensors, allocates the outputs and the partials
scratch with ``torch.empty``, launches the kernel's two passes on PyTorch's
current stream and raises if ``cudaGetLastError`` reports a failure. It
never synchronizes and never falls back to a plain version. Each launch
adds one to its entry in ``LAUNCHES``; nothing else touches the counts but
``reset_launch_counts``. The 1-NN kernel has two entries, one per mode:
``nn_search`` (index mode) and ``nn_search_d2`` (d2-only mode). A launch's
grid holds at most ``_MAX_QUERIES`` queries for the match and k-NN
kernels, which raise above it, and ``_NN_MAX_QUERIES`` for the 1-NN, whose
wrappers launch once per slice of that many.

The library is built by ``_build.build`` at the first call, not at
import, so importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from .. import _build

# Launches per kernel (and per 1-NN mode) since the last reset_launch_counts().
LAUNCHES = {"match_transform": 0, "knn_search": 0, "nn_search": 0, "nn_search_d2": 0}

MAX_K = 64          # csrc/knn.cu kMaxK
_THREADS = 256      # csrc/knn.cu kThreads: queries per block
_SM_COUNT_H100 = 132
# Blocks the first pass aims for: two waves of 8 resident 256-thread blocks
# on each of the H100's SMs.
_TARGET_BLOCKS = 2 * 8 * _SM_COUNT_H100
_MIN_CHUNK = 32     # fewest references a block scans
_MAX_QUERIES = 65535 * _THREADS  # queries per launch (grid rows of blocks)

# The 1-NN (csrc/knn.cu kNnQ, kNnSub): a block holds _NN_BLOCK queries.
_NN_BLOCK = 4 * _THREADS
_NN_SUB = 32
_NN_MAX_QUERIES = 65535 * _NN_BLOCK  # queries per 1-NN launch
_NN_MIN_CHUNK = 256    # fewest references a 1-NN block scans
# The chunk plan's cost of a wave beyond its scan, in references. A block's
# own fixed cost (its queries, the first tile, the writes and its share of
# the reduce pass) is only 6.6 references (chip_smoke.py nn_block_cost; H100
# 80GB HBM3, 700 W); 512 keeps the plans to few, long chunks, and so the
# partials small: with 8 the timed shapes would split into 52-101 chunks for
# 1.0-3.4 % less work on the busiest SM.
_NN_WAVE_COST = 512
_NN_MAX_CHUNKS = 1024  # the most chunks a plan considers

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
                # q, nq, refs, n, mask, chunk_len, n_chunks, part_d, part_b,
                # out_d, out_i, stream
                fn.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P]
                fn.restype = _I
                fn = getattr(lib, f"simpleicp_nn_d2_{suffix}")
                # q, nq, refs, n, mask, chunk_len, n_chunks, part_d, out_d,
                # stream
                fn.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P]
                fn.restype = _I
                fn = getattr(lib, f"simpleicp_knn_{suffix}")
                # q, nq, refs, n, mask, k, chunk_len, n_chunks, part_d,
                # part_i, out_d, out_i, stream
                fn.argtypes = [_P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P]
                fn.restype = _I
            # f64, index, out
            lib.simpleicp_nn_resident.argtypes = [_I, _I, ctypes.POINTER(_I)]
            lib.simpleicp_nn_resident.restype = _I
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


@functools.lru_cache(maxsize=256)
def _plan_nn_chunks(n_q: int, n_r: int, resident: int) -> Tuple[int, int]:
    """(chunk_len, n_chunks) of the 1-NN's reference axis. Blocks of equal
    work run in waves of ``resident`` (the card's SMs times the scan's
    blocks per SM), and whole waves leave no SM with more blocks than
    another: pick the split whose waves times (chunk + _NN_WAVE_COST) is
    least, with no chunk under _NN_MIN_CHUNK references; ties go to fewer
    chunks. Against the uniform plan of the other kernels (about two
    waves; chip_smoke.py nn_plans, H100 80GB HBM3, 700 W) the d2-only scan
    ran 2.1 % faster at 100k x 100k and 7.4 % at the dilate gate's band
    sweep (71 551 x 1.2M), as the blocks on the busiest SM predict; at 1M x
    1M both pick the same plan."""
    q_blocks = -(-n_q // _NN_BLOCK)
    best = None
    for want in range(1, max(1, min(n_r // _NN_MIN_CHUNK, _NN_MAX_CHUNKS)) + 1):
        chunk_len = -(-n_r // want)
        n_chunks = -(-n_r // chunk_len)
        waves = -(-q_blocks * n_chunks // resident)
        scanned = -(-chunk_len // _NN_SUB) * _NN_SUB
        cost = waves * (scanned + _NN_WAVE_COST)
        if best is None or cost < best[0]:
            best = (cost, chunk_len, n_chunks)
    return best[1], best[2]


_resident_cache = {}


def _nn_resident(dev: torch.device, dtype: torch.dtype, index: bool) -> int:
    """Resident 1-NN scan blocks on ``dev`` (the occupancy API's blocks per
    SM times the SM count), once per device, dtype and mode."""
    key = (dev.index, dtype, index)
    if key not in _resident_cache:
        out = _I(0)
        with torch.cuda.device(dev):
            err = _library().simpleicp_nn_resident(int(dtype == torch.float64),
                                                   int(index), ctypes.byref(out))
        _raise_on(err, "nn_search occupancy")
        if out.value < 1:
            raise RuntimeError("the 1-NN kernel fits no block on this device")
        _resident_cache[key] = out.value
    return _resident_cache[key]


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


def _nn(queries: torch.Tensor, refs: torch.Tensor,
        ref_mask: Optional[torch.Tensor], index: bool):
    """Both 1-NN modes: one launch per slice of _NN_MAX_QUERIES queries (no
    query's result depends on another's). Returns (d2, idx or None)."""
    dev, dtype, suffix, n_q, n_r = _common(queries, refs)
    if ref_mask is not None:
        _check("ref_mask", ref_mask, dev, torch.bool, (n_r,))
    out_d = torch.empty((n_q,), dtype=dtype, device=dev)
    out_i = torch.empty((n_q,), dtype=torch.int32, device=dev) if index else None
    if n_q == 0:
        return out_d, out_i
    name = "nn_search" if index else "nn_search_d2"
    fn = getattr(_library(), f"simpleicp_nn_{suffix}" if index else f"simpleicp_nn_d2_{suffix}")
    resident = _nn_resident(dev, dtype, index)
    mask_ptr = None if ref_mask is None else ref_mask.data_ptr()
    for s in range(0, n_q, _NN_MAX_QUERIES):
        n = min(_NN_MAX_QUERIES, n_q - s)
        chunk_len, n_chunks = _plan_nn_chunks(n, n_r, resident)
        part_d = (torch.empty((n_chunks, n), dtype=dtype, device=dev)
                  if index or n_chunks > 1 else None)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            head = (queries[s:].data_ptr(), n, refs.data_ptr(), n_r, mask_ptr,
                    chunk_len, n_chunks, None if part_d is None else part_d.data_ptr())
            if index:
                part_b = torch.empty((n_chunks, n), dtype=torch.int32, device=dev)
                err = fn(*head, part_b.data_ptr(), out_d[s:].data_ptr(),
                         out_i[s:].data_ptr(), stream)
            else:
                err = fn(*head, out_d[s:].data_ptr(), stream)
        _raise_on(err, name)
        LAUNCHES[name] += 1
    return out_d, out_i


def nn_search_cuda(queries: torch.Tensor, refs: torch.Tensor,
                   ref_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel of ``knn.nn_search`` (index mode): the first-minimum 1-NN of
    each query; masked refs never win, and a query with no valid ref gets
    d2 = +inf and index 0."""
    return _nn(queries, refs, ref_mask, index=True)


def nn_d2_cuda(queries: torch.Tensor, refs: torch.Tensor,
               ref_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel of ``knn.min_dist_sq`` (the 1-NN's d2-only mode): each query's
    least squared distance to a valid ref, +inf with none."""
    return _nn(queries, refs, ref_mask, index=False)[0]
