"""ctypes wrappers of the nearest-neighbour kernels in ``csrc/knn.cu``.

Each wrapper checks its tensors, allocates the outputs and the partials
scratch with ``torch.empty``, launches the kernel's two passes on PyTorch's
current stream and raises if ``cudaGetLastError`` reports a failure. It
never synchronizes and never falls back to a plain version. Each launch
adds one to its entry in ``LAUNCHES``; nothing else touches the counts but
``reset_launch_counts``. The 1-NN kernel has two entries, one per mode:
``nn_search`` (index mode) and ``nn_search_d2`` (d2-only mode); the match
is the index mode's scan with the transform fused in, under its own entry.
The 1-NN and match wrappers launch once per slice of ``_NN_MAX_QUERIES``
queries (a launch's grid rows of query blocks); the k-NN puts its query
blocks on the grid's first axis and takes any count in one launch.

Every wrapper takes a batch of cloud pairs with a leading pair axis,
queries (B, q, 3) and refs (B, n, 3) (one pair is B = 1; ``knn`` adds and
drops the axis): a batch of up to ``_MAX_PAIRS`` pairs is one launch (the
kernels' grid takes the pair as one more dimension), so a batch costs a
single pair's launches, and each pair's answer is bit-equal to its own
launch's.

Each kernel's reference axis is cut into chunks by a plan that fills the
card's resident blocks (the occupancy API's blocks per SM times the SM
count, ``_resident``) in whole waves, counting the query blocks of every
pair of the launch: ``_plan_nn_chunks`` for the 1-NN and
the match, ``_plan_knn_chunks`` for the k-NN.

The library is built by ``_build.build`` at the first call, not at
import, so importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch

from .. import _build

# Launches per kernel (and per 1-NN mode) since the last reset_launch_counts().
LAUNCHES = {"match_transform": 0, "knn_search": 0, "nn_search": 0, "nn_search_d2": 0}

MAX_K = 64          # csrc/knn.cu kMaxK
_THREADS = 256      # csrc/knn.cu kThreads: threads per block

# The 1-NN and the match (csrc/knn.cu kNnQ, kNnSub): a block holds _NN_BLOCK
# queries.
_NN_BLOCK = 4 * _THREADS
_NN_SUB = 32
_NN_MAX_QUERIES = 65535 * _NN_BLOCK  # queries per 1-NN launch
_MAX_PAIRS = 65535  # pairs per launch (the grid's z and y limits)
_NN_MIN_CHUNK = 256    # fewest references a 1-NN block scans
# The chunk plan's cost of a wave beyond its scan, in references. A block's
# own fixed cost (its queries, the first tile, the writes and its share of
# the reduce pass) is only 6.6 references (chip_smoke.py nn_block_cost; H100
# 80GB HBM3, 700 W); 512 keeps the plans to few, long chunks, and so the
# partials small: with 8 the timed shapes would split into 52-101 chunks for
# 1.0-3.4 % less work on the busiest SM.
_NN_WAVE_COST = 512
_NN_MAX_CHUNKS = 1024  # the most chunks a plan considers

# The k-NN (csrc/knn.cu kKnnBlock): 4 queries a warp, 32 a block; lists of
# up to 32 pairs (one slot a lane) or 64 (two). Against 8 queries a warp
# (chip_smoke.py knn_plans; H100 80GB HBM3, 700 W) 4 was 6 % faster at
# 1000 x 100k in float32 and 27 % in float64, 9 % slower at 100k x 100k:
# half the lists per resident warp, so the plan's chunks are twice as long.
_KNN_BLOCK = 32
_KNN_MIN_CHUNK = 512   # fewest references a k-NN block scans (one tile)
# One insertion into a warp's list, in references scanned: about 20 warp
# instructions (the candidate's broadcast, compare, two shifts, selects and
# the k-th's re-read) against 11 a query per step of 32 refs, so
# 20 * 32 / 11 = 58 refs whatever the queries per warp.
_KNN_INSERT_REFS = 58
# Blocks per SM at which the k-NN's scan saturates the SM's issue: more
# resident blocks only cut the chunks shorter (at 1000 x 100k, float32, one
# wave: 16 chunks at 4 blocks per SM 0.119 ms, 20 chunks at 5 per SM
# 0.128; chip_smoke.py knn_plans, H100 80GB HBM3, 700 W).
_KNN_SM_BLOCKS = 4

# Scan kernels of simpleicp_resident (csrc/knn.cu).
_RESIDENT_KERNELS = {"nn_d2": 0, "nn": 1, "match": 2, "knn32": 3, "knn64": 4}

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
                # q, nq, refs, n, h, chunk_len, n_chunks, part_d, part_b,
                # out_d, out_i, q_pair, h_pair, n_pairs, stream
                fn.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P]
                fn.restype = _I
                fn = getattr(lib, f"simpleicp_nn_{suffix}")
                # q, nq, refs, n, mask, chunk_len, n_chunks, part_d, part_b,
                # out_d, out_i, q_pair, n_pairs, stream
                fn.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P]
                fn.restype = _I
                fn = getattr(lib, f"simpleicp_nn_d2_{suffix}")
                # q, nq, refs, n, mask, chunk_len, n_chunks, part_d, out_d,
                # q_pair, n_pairs, stream
                fn.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P, _P, _I, _I, _P]
                fn.restype = _I
                fn = getattr(lib, f"simpleicp_knn_{suffix}")
                # q, nq, refs, n, mask, k, chunk_len, n_chunks, part_d,
                # part_i, out_d, out_i, n_pairs, stream
                fn.argtypes = [_P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P]
                fn.restype = _I
            # kernel, f64, out
            lib.simpleicp_resident.argtypes = [_I, _I, ctypes.POINTER(_I)]
            lib.simpleicp_resident.restype = _I
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


def _whole_waves(q_blocks: int, n_r: int, resident: int, min_chunk: int,
                 max_chunks: int, block_cost) -> Tuple[int, int]:
    """(chunk_len, n_chunks) of a reference axis of n_r refs. Blocks of
    equal work run in waves of ``resident``, and whole waves leave no SM
    with more blocks than another: pick the split whose waves times
    ``block_cost(chunk_len)`` is least, with no chunk under ``min_chunk``
    references and at most ``max_chunks`` chunks; ties go to fewer chunks."""
    best = None
    for want in range(1, max(1, min(n_r // min_chunk, max_chunks)) + 1):
        chunk_len = -(-n_r // want)
        n_chunks = -(-n_r // chunk_len)
        waves = -(-q_blocks * n_chunks // resident)
        cost = waves * block_cost(chunk_len)
        if best is None or cost < best[0]:
            best = (cost, chunk_len, n_chunks)
    return best[1], best[2]


@functools.lru_cache(maxsize=256)
def _plan_nn_chunks(n_q: int, n_r: int, resident: int,
                    n_pairs: int = 1) -> Tuple[int, int]:
    """(chunk_len, n_chunks) of the 1-NN's and the match's reference axis
    for ``n_pairs`` pairs of n_q queries and n_r refs each, in whole waves
    of ``resident`` blocks (the card's SMs times the scan's blocks per SM;
    the pairs' query blocks all count); a block costs its chunk, in whole
    sub-tiles, plus
    _NN_WAVE_COST. Against the uniform plan of about two waves
    (chip_smoke.py nn_plans, H100 80GB HBM3, 700 W) the d2-only scan ran
    2.1 % faster at 100k x 100k and 7.4 % at the dilate gate's band sweep
    (71 551 x 1.2M), as the blocks on the busiest SM predict; at 1M x 1M
    both pick the same plan. At the match's 1000 queries (one query block)
    it spreads the reference axis over every resident block, and a batch of
    such matches over resident / B blocks a pair."""
    return _whole_waves(n_pairs * -(-n_q // _NN_BLOCK), n_r, resident, _NN_MIN_CHUNK,
                        _NN_MAX_CHUNKS,
                        lambda c: -(-c // _NN_SUB) * _NN_SUB + _NN_WAVE_COST)


# The k-NN's partials hold at most this many (query, chunk) lists.
_KNN_MAX_LISTS = 1 << 22
# The most refs, over all its pairs, one k-NN launch takes: its scan
# indexes them with int32.
_KNN_MAX_REFS = 2**31 - 1


@functools.lru_cache(maxsize=256)
def _plan_knn_chunks(n_q: int, n_r: int, k: int, resident: int,
                     n_pairs: int = 1) -> Tuple[int, int]:
    """(chunk_len, n_chunks) of the k-NN's reference axis for ``n_pairs``
    pairs of n_q queries, in whole waves of ``resident`` blocks. A block
    costs its chunk plus the insertions of
    lists that start empty: a list over c refs in random order takes about
    k (1 + ln(c / k)) of them (c when c <= k), each worth _KNN_INSERT_REFS
    refs, so the plan prefers few long chunks. At the main path's 1000
    queries (16 query blocks) that is one wave of a few dozen chunks of
    thousands of refs; at estimate_normals' 100k x 100k, one chunk."""
    def block_cost(c):
        return c + _KNN_INSERT_REFS * min(c, k) * (1.0 + math.log(max(c / k, 1.0)))

    max_chunks = max(1, min(_NN_MAX_CHUNKS, _KNN_MAX_LISTS // max(n_pairs * n_q, 1)))
    return _whole_waves(n_pairs * -(-n_q // _KNN_BLOCK), n_r, resident, _KNN_MIN_CHUNK,
                        max_chunks, block_cost)


_resident_cache = {}


def _resident(dev: torch.device, dtype: torch.dtype, kernel: str) -> int:
    """Resident blocks of one scan kernel (``_RESIDENT_KERNELS``) on
    ``dev``: the occupancy API's blocks per SM times the SM count, once per
    device, dtype and kernel."""
    key = (dev.index, dtype, kernel)
    if key not in _resident_cache:
        out = _I(0)
        with torch.cuda.device(dev):
            err = _library().simpleicp_resident(_RESIDENT_KERNELS[kernel],
                                                int(dtype == torch.float64),
                                                ctypes.byref(out))
        _raise_on(err, f"{kernel} occupancy")
        if out.value < 1:
            raise RuntimeError(f"the {kernel} kernel fits no block on this device")
        _resident_cache[key] = out.value
    return _resident_cache[key]


def _knn_waves(dev: torch.device, dtype: torch.dtype, k: int) -> int:
    """Blocks of the k-NN's scan a wave of its plan holds: the resident
    blocks, at most _KNN_SM_BLOCKS a SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(_resident(dev, dtype, "knn32" if k <= 32 else "knn64"),
               _KNN_SM_BLOCKS * sms)


def _common(queries: torch.Tensor, refs: torch.Tensor):
    """The checks of every wrapper on (B, q, 3) queries and (B, n, 3) refs:
    (device, dtype, suffix, B, q, n)."""
    if queries.device.type != "cuda":
        raise ValueError(f"queries must be a CUDA tensor, got {queries.device}")
    dev, dtype = queries.device, queries.dtype
    suffix = _suffix(dtype)
    _check("queries", queries, dev, dtype, (None, None, 3))
    n_pairs, n_q = queries.shape[:2]
    _check("refs", refs, dev, dtype, (n_pairs, None, 3))
    n_r = refs.shape[1]
    if n_r < 1:
        raise ValueError("refs must hold at least one point")
    if n_q >= 2**31 or n_r >= 2**31 // 3:
        raise ValueError("too many points for int32 indexing")
    return dev, dtype, suffix, n_pairs, n_q, n_r


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def match_transform_cuda(queries: torch.Tensor, refs: torch.Tensor,
                         H: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel of ``knn.match_transform``: 1-NN of each query among the refs
    moved by H's [R | t], read by the kernel from device memory (the 1-NN's
    index mode with the transform fused into its staging). H holds one
    (4, 4) or (3, 4) transform per pair. Returns (d2 (B, q), idx (B, q))."""
    dev, dtype, _, n_pairs, _, _ = _common(queries, refs)
    if H.dim() != 3 or tuple(H.shape[1:]) not in ((4, 4), (3, 4)):
        raise ValueError(f"H has shape {tuple(H.shape)}, expected (4, 4) or (3, 4) a pair")
    _check("H", H, dev, dtype, (n_pairs, None, 4))
    return _nn(queries, refs, None, index=True, H=H)


def knn_search_cuda(queries: torch.Tensor, refs: torch.Tensor, k: int,
                    ref_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel of ``knn.knn_search``: the k smallest (d2, index) pairs per
    query in lexicographic order; masked refs (ref_mask (B, n)) count as
    d2 = +inf. Returns (d2 (B, q, k), idx (B, q, k)). One launch for a batch
    of up to _MAX_PAIRS pairs and _KNN_MAX_REFS refs in all."""
    dev, dtype, suffix, n_pairs, n_q, n_r = _common(queries, refs)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the k-NN kernel takes 1 <= k <= {MAX_K}, got {k}")
    if k > n_r:
        raise ValueError(f"k={k} exceeds number of reference points {n_r}")
    if ref_mask is not None:
        _check("ref_mask", ref_mask, dev, torch.bool, (n_pairs, n_r))
    out_d = torch.empty((n_pairs, n_q, k), dtype=dtype, device=dev)
    out_i = torch.empty((n_pairs, n_q, k), dtype=torch.int32, device=dev)
    fn = getattr(_library(), f"simpleicp_knn_{suffix}") if n_q and n_pairs else None
    max_pairs = min(_MAX_PAIRS, _KNN_MAX_REFS // n_r)
    for p0 in range(0, n_pairs if n_q else 0, max_pairs):
        n_p = min(max_pairs, n_pairs - p0)
        chunk_len, n_chunks = _plan_knn_chunks(n_q, n_r, k, _knn_waves(dev, dtype, k), n_p)
        part_d = part_i = None
        if n_chunks > 1:
            part_d = torch.empty((n_p, n_q, n_chunks, k), dtype=dtype, device=dev)
            part_i = torch.empty((n_p, n_q, n_chunks, k), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(queries[p0].data_ptr(), n_q, refs[p0].data_ptr(), n_r,
                     None if ref_mask is None else ref_mask[p0].data_ptr(), k,
                     chunk_len, n_chunks, _ptr(part_d), _ptr(part_i),
                     out_d[p0].data_ptr(), out_i[p0].data_ptr(), n_p, stream)
        _raise_on(err, "knn_search")
        LAUNCHES["knn_search"] += 1
    return out_d, out_i


def _nn(queries: torch.Tensor, refs: torch.Tensor,
        ref_mask: Optional[torch.Tensor], index: bool,
        H: Optional[torch.Tensor] = None):
    """Both 1-NN modes, and the match (the index mode with H), on (B, q, 3)
    queries: one launch per slice of up to _MAX_PAIRS pairs and
    _NN_MAX_QUERIES queries of each (no query's result depends on
    another's). Returns (d2 (B, q), idx (B, q) or None)."""
    dev, dtype, suffix, n_pairs, n_q, n_r = _common(queries, refs)
    if ref_mask is not None:
        _check("ref_mask", ref_mask, dev, torch.bool, (n_pairs, n_r))
    out_d = torch.empty((n_pairs, n_q), dtype=dtype, device=dev)
    out_i = torch.empty((n_pairs, n_q), dtype=torch.int32, device=dev) if index else None
    if n_q == 0 or n_pairs == 0:
        return out_d, out_i
    if H is not None:
        name, kernel, fn_name = "match_transform", "match", "simpleicp_match_transform"
    elif index:
        name, kernel, fn_name = "nn_search", "nn", "simpleicp_nn"
    else:
        name, kernel, fn_name = "nn_search_d2", "nn_d2", "simpleicp_nn_d2"
    fn = getattr(_library(), f"{fn_name}_{suffix}")
    resident = _resident(dev, dtype, kernel)
    for p0 in range(0, n_pairs, _MAX_PAIRS):
        n_p = min(_MAX_PAIRS, n_pairs - p0)
        # the match's fifth argument is H where the 1-NN's is the mask, and
        # it passes H's pair stride (12 or 16 scalars) after the query stride
        if H is not None:
            fifth, strides = H[p0].data_ptr(), (n_q, H.shape[1] * 4)
        else:
            fifth, strides = (None if ref_mask is None else ref_mask[p0].data_ptr()), (n_q,)
        for s in range(0, n_q, _NN_MAX_QUERIES):
            n = min(_NN_MAX_QUERIES, n_q - s)
            chunk_len, n_chunks = _plan_nn_chunks(n, n_r, resident, n_p)
            part_d = (torch.empty((n_p, n_chunks, n), dtype=dtype, device=dev)
                      if index or n_chunks > 1 else None)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                head = (queries[p0, s:].data_ptr(), n, refs[p0].data_ptr(), n_r, fifth,
                        chunk_len, n_chunks, _ptr(part_d))
                if index:
                    part_b = torch.empty((n_p, n_chunks, n), dtype=torch.int32, device=dev)
                    err = fn(*head, part_b.data_ptr(), out_d[p0, s:].data_ptr(),
                             out_i[p0, s:].data_ptr(), *strides, n_p, stream)
                else:
                    err = fn(*head, out_d[p0, s:].data_ptr(), *strides, n_p, stream)
            _raise_on(err, name)
            LAUNCHES[name] += 1
    return out_d, out_i


def nn_search_cuda(queries: torch.Tensor, refs: torch.Tensor,
                   ref_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel of ``knn.nn_search`` (index mode): the first-minimum 1-NN of
    each query; masked refs never win, and a query with no valid ref gets
    d2 = +inf and index 0. Returns (d2 (B, q), idx (B, q))."""
    return _nn(queries, refs, ref_mask, index=True)


def nn_d2_cuda(queries: torch.Tensor, refs: torch.Tensor,
               ref_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel of ``knn.min_dist_sq`` (the 1-NN's d2-only mode): each query's
    least squared distance to a valid ref, +inf with none; (B, q)."""
    return _nn(queries, refs, ref_mask, index=False)[0]
