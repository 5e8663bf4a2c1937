"""ctypes wrapper of the stencil dilation kernel in ``csrc/dilate.cu``.

``dilate_cuda`` checks the grid, builds the stencil tables on the device
once per plan (cached), allocates the outputs with ``torch.empty``,
launches the kernel on PyTorch's current stream and raises if
``cudaGetLastError`` reports a failure. It never synchronizes and never
falls back to the plain version. Each launch adds one to
``LAUNCHES["dilate"]``; nothing else touches the count but
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

_TILE = 32              # csrc/dilate.cu kTileX, kTileY
_SMEM_MAX = 232_448     # dynamic shared memory a block may use on the H100

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    LAUNCHES["dilate"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build("dilate")))
            # occ, wz, nx, ny, pairs, starts, n_st, z_max, P, out0, out1, stream
            lib.simpleicp_dilate.argtypes = [_P, _I, _I, _I, _P, _P, _I, _I, _I,
                                             _P, _P, _P]
            lib.simpleicp_dilate.restype = _I
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=16)
def _tables(stencils: Tuple[Tuple[Tuple[int, int, int], ...], ...], device: str):
    """The kernel's tables of one or two non-empty stencils: (dx, dy) pairs
    of each stencil sorted by z, the per-level start offsets (one row of
    z_max + 2 per stencil), z_max and the reach P."""
    z_max = max(z for st in stencils for _, _, z in st)
    reach = max(max(abs(dx), abs(dy)) for st in stencils for dx, dy, _ in st)
    pairs, starts = [], []
    for st in stencils:
        for z in range(z_max + 1):
            starts.append(len(pairs))
            pairs.extend((dx, dy) for dx, dy, zz in st if zz == z)
        starts.append(len(pairs))
    return (torch.tensor(pairs, dtype=torch.int32, device=device),
            torch.tensor(starts, dtype=torch.int32, device=device), z_max, reach)


def dilate_cuda(occ: torch.Tensor, offsets_list) -> List[torch.Tensor]:
    """Kernel of ``dilate_gate.dilate_packed_multi``: one output grid per
    stencil of ``offsets_list``; at most two of them non-empty (an empty
    stencil's grid is zeros, and with no non-empty stencil nothing is
    launched)."""
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
    wz, nx, ny = occ.shape
    if wz > 65535 or -(-nx // _TILE) > 65535:
        raise ValueError(f"grid {tuple(occ.shape)} too large for one launch")
    pairs, starts, z_max, reach = _tables(tuple(stencils[i] for i in live),
                                          str(occ.device))
    if 16 * (_TILE + 2 * reach) ** 2 > _SMEM_MAX:
        raise ValueError(f"stencil reach {reach} needs more shared memory than a block has")
    out0 = outs[live[0]]
    out1 = outs[live[1]] if len(live) == 2 else None
    lib = _library()
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        err = lib.simpleicp_dilate(
            occ.data_ptr(), wz, nx, ny, pairs.data_ptr(), starts.data_ptr(),
            len(live), z_max, reach, out0.data_ptr(),
            None if out1 is None else out1.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dilate kernel launch failed: CUDA error {err}")
    LAUNCHES["dilate"] += 1
    return outs
