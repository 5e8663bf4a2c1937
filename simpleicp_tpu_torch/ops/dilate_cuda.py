"""ctypes wrapper of the stencil dilation kernel in ``csrc/dilate.cu``.

``dilate_cuda`` checks the grid, builds the kernel's tables once per plan
(cached: the entries of each z level regrouped into runs of consecutive dx
at one dy, as word offsets into the kernel's halo'd tile), allocates the
outputs with ``torch.empty``, launches the kernel on PyTorch's current
stream and raises if ``cudaGetLastError`` reports a failure. It never
synchronizes and never falls back to the plain version. Each launch adds
one to ``LAUNCHES["dilate"]``; nothing else touches the count but
``reset_launch_counts``.

The library is built by ``_build.build`` at the first call, not at import.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Tuple

import torch

from .. import _build

# Launches since the last reset_launch_counts().
LAUNCHES = {"dilate": 0}

_LANES = 32             # csrc/dilate.cu kLanes: output columns (y) per block
_LMAX = 8               # csrc/dilate.cu kLMax: longest run of one step
_LEVEL_INTS = 2 + 2 * (_LMAX + 1)   # csrc/dilate.cu kLevelInts
_TILE_X = 128           # csrc/dilate.cu kTileX: output rows (x) per block
_SMEM_MAX = 232_448     # dynamic shared memory a block may use on the H100

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int

Stencils = Tuple[Tuple[Tuple[int, int, int], ...], ...]


def reset_launch_counts() -> None:
    LAUNCHES["dilate"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build("dilate")))
            # occ, wz, nx, ny, table, table_len, n_levels, n_st, P, TH, out0,
            # out1, stream
            lib.simpleicp_dilate.argtypes = [_P, _I, _I, _I, _P, _I, _I, _I, _I,
                                             _I, _P, _P, _P]
            lib.simpleicp_dilate.restype = _I
            _lib = lib
        return _lib


def _runs(pairs) -> List[Tuple[int, int, int]]:
    """(dy, a, L) runs of consecutive dx = a .. a + L - 1 at one dy, at most
    _LMAX long, covering the distinct (dx, dy) of ``pairs``."""
    by_dy = {}
    for dx, dy in set(pairs):
        by_dy.setdefault(dy, []).append(dx)
    out = []
    for dy in sorted(by_dy):
        xs = sorted(by_dy[dy])
        i = 0
        while i < len(xs):
            j = i
            while j + 1 < len(xs) and xs[j + 1] == xs[j] + 1 and j + 1 - i < _LMAX:
                j += 1
            out.append((dy, xs[i], j - i + 1))
            i = j + 1
    return out


@functools.lru_cache(maxsize=16)
def _tables(stencils: Stencils):
    """The kernel's table of one or two non-empty stencils: (table,
    n_levels, reach P, row stride TH).

    ``table`` is a list of int32: one record per z level that holds an
    entry (ascending z): z, the reach of that level and every later one
    (the halo oz must grow over), and for each of two stencils _LMAX + 1
    offsets into the runs (runs of length L are [s[L - 1], s[L])); then one
    word offset per run, -dy * TH - (a + L - 1): from a thread's output
    position to the first of the kRows + L - 1 words the run reads."""
    reach = max(max(abs(dx), abs(dy)) for st in stencils for dx, dy, _ in st)
    th = (_TILE_X + 2 * reach) | 1
    head, runs = [], []
    for z in sorted({z for st in stencils for _, _, z in st}):
        head += [z, max(max(abs(dx), abs(dy)) for st in stencils
                        for dx, dy, zz in st if zz >= z)]
        for s in range(2):
            level = _runs((dx, dy) for dx, dy, zz in
                          (stencils[s] if s < len(stencils) else ()) if zz == z)
            head.append(len(runs))
            for L in range(1, _LMAX + 1):
                runs += [-dy * th - (a + L - 1) for dy, a, n in level if n == L]
                head.append(len(runs))
    return head + runs, len(head) // _LEVEL_INTS, reach, th


def _smem_bytes(table_len: int, reach: int, th: int) -> int:
    """Dynamic shared memory of one block: the table, then the prev, cur,
    next and two oz arrays of the halo'd tile."""
    return 4 * (((table_len + 3) & ~3) + 5 * th * (_LANES + 2 * reach))


def _plan(stencils: Stencils):
    """(table, n_levels, reach, TH) of the stencils; raises ValueError if
    the halo'd tile and the table do not fit a block's shared memory (reach
    above 18; every plan of the dilate gate has reach at most 17)."""
    table, n_levels, reach, th = _tables(stencils)
    if _smem_bytes(len(table), reach, th) > _SMEM_MAX:
        raise ValueError(f"stencil reach {reach} needs more shared memory than a "
                         "block has (the kernel takes reach up to 18)")
    return table, n_levels, reach, th


@functools.lru_cache(maxsize=16)
def _device_table(stencils: Stencils, device: str) -> torch.Tensor:
    return torch.tensor(_tables(stencils)[0], dtype=torch.int32, device=device)


def dilate_cuda(occ: torch.Tensor, offsets_list) -> List[torch.Tensor]:
    """Kernel of ``dilate_gate.dilate_packed_multi``: one output grid per
    stencil of ``offsets_list``; at most two of them non-empty (an empty
    stencil's grid is zeros, and with no non-empty stencil nothing is
    launched), of reach (largest |dx|, |dy|) up to 18."""
    if occ.device.type != "cuda":
        raise ValueError(f"occ must be a CUDA tensor, got {occ.device}")
    if occ.dtype != torch.int32:
        raise TypeError(f"occ must hold int32 words, got {occ.dtype}")
    if occ.dim() != 3 or min(occ.shape) < 1:
        raise ValueError(f"occ must have shape (wz, nx, ny), got {tuple(occ.shape)}")
    if not occ.is_contiguous():
        raise ValueError("occ must be contiguous")
    stencils = [tuple(tuple(int(v) for v in e) for e in o) for o in offsets_list]
    for st in stencils:
        for e in st:
            if len(e) != 3 or not 0 <= e[2] < 32:
                raise ValueError(f"stencil entry {e}: expected (dx, dy, z) with 0 <= z < 32")
    live = [i for i, st in enumerate(stencils) if st]
    if len(live) > 2:
        raise ValueError("the dilate kernel takes at most two non-empty stencils")
    outs = [torch.zeros_like(occ) if not st else torch.empty_like(occ)
            for st in stencils]
    if not live:
        return outs
    key = tuple(stencils[i] for i in live)
    table, n_levels, reach, th = _plan(key)
    wz, nx, ny = occ.shape
    if wz > 65535 or -(-nx // _TILE_X) > 65535:
        raise ValueError(f"grid {tuple(occ.shape)} too large for one launch")
    dev_table = _device_table(key, str(occ.device))
    out0 = outs[live[0]]
    out1 = outs[live[1]] if len(live) == 2 else None
    lib = _library()
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        err = lib.simpleicp_dilate(
            occ.data_ptr(), wz, nx, ny, dev_table.data_ptr(), len(table), n_levels,
            len(live), reach, th, out0.data_ptr(),
            None if out1 is None else out1.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dilate kernel launch failed: CUDA error {err}")
    LAUNCHES["dilate"] += 1
    return outs
