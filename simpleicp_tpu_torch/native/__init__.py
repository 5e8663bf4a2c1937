"""The xyz reader and writer in C++ (``xyz_parser.cpp``, ``xyz_writer.cpp``),
loaded with ctypes.

The library is built by ``_build.build(_build.NATIVE)`` with the host
compiler at the first call, not at import; a missing or failing compiler
raises RuntimeError with its output. ``utils/xyz_io.py`` reads and writes
through it. The reader is bit-equal to ``np.loadtxt(path, comments="//",
ndmin=2)`` wherever numpy accepts the file; the writer is byte-equal to
``np.savetxt`` with ``fmt="%.<decimals>f"`` under the header.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import _build
from ..utils.xyz_io import XyzIOError

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build(_build.NATIVE)))
            lib.xyz_count_and_parse.restype = ctypes.c_int64
            lib.xyz_count_and_parse.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int64,
            ]
            lib.xyz_write.restype = ctypes.c_int64
            lib.xyz_write.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ]
            _lib = lib
        return _lib


def read_xyz_native(path: str, dtype=np.float64) -> np.ndarray:
    """The (n, 3) points of an xyz file: two passes over a memory map (count,
    then fill), in line-aligned chunks on several threads above 4 MB.
    Raises XyzIOError naming the first malformed line."""
    lib = _load()
    errbuf = ctypes.create_string_buffer(256)
    path_b = os.fspath(path).encode()
    n = lib.xyz_count_and_parse(path_b, None, 0, errbuf, len(errbuf))
    if n < 0:
        raise XyzIOError(f"{path}: {errbuf.value.decode()}")
    out = np.empty((n, 3), dtype=np.float64)
    got = lib.xyz_count_and_parse(path_b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                                  n, errbuf, len(errbuf))
    if got != n:
        msg = errbuf.value.decode() if got < 0 else f"{got} points, {n} counted"
        raise XyzIOError(f"{path}: {msg}")
    return out.astype(dtype, copy=False)


def write_xyz_native(path: str, X: np.ndarray, decimals: int = 6,
                     header: str = "//X Y Z\n") -> None:
    """Write the first three columns of X, each value as ``%.<decimals>f``,
    under ``header``, rows formatted on several threads from 2^18 rows."""
    lib = _load()
    if decimals < 0:
        raise ValueError(f"decimals must be >= 0, got {decimals}")
    X = np.ascontiguousarray(np.asarray(X)[:, :3], np.float64)
    if X.ndim != 2 or X.shape[1] != 3:
        raise ValueError(f"expected (n, 3) points, got shape {X.shape}")
    errbuf = ctypes.create_string_buffer(256)
    rc = lib.xyz_write(os.fspath(path).encode(),
                       X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), X.shape[0],
                       int(decimals), header.encode(), errbuf, len(errbuf))
    if rc != 0:
        raise XyzIOError(f"{path}: {errbuf.value.decode()}")
