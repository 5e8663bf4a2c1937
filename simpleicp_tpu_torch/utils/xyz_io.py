"""xyz point-cloud file I/O.

Plain text, one ``x y z`` triple per line, whitespace separated, exactly
three columns; ``//`` starts a comment header. Writers emit the
CloudCompare-style header ``//X Y Z``. The same contract as the JAX
package's ``utils/xyz_io.py``.

``read_xyz`` and every plain ``%.Nf`` ``write_xyz`` run through the C++
reader and writer of ``native/``, built at the first call; other formats
go to ``np.savetxt``. ``read_xyz_plain`` and ``write_xyz_plain`` are the
numpy versions they are tested against.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Union

import numpy as np


class XyzIOError(Exception):
    """Raised for malformed xyz input (wrong column count, non-numeric data)."""


def read_xyz(path: Union[str, Path], dtype=np.float64) -> np.ndarray:
    """Read an xyz file into an (n, 3) array, bit-equal to ``read_xyz_plain``.

    Skips blank lines and ``//`` comment headers; enforces exactly three
    numeric columns.
    """
    from ..native import read_xyz_native

    path = os.fspath(path)
    if not os.path.exists(path):
        raise XyzIOError(f"file does not exist: {path}")
    return read_xyz_native(path, dtype=dtype)


def read_xyz_plain(path: Union[str, Path], dtype=np.float64) -> np.ndarray:
    """``read_xyz`` through ``np.loadtxt``."""
    path = os.fspath(path)
    if not os.path.exists(path):
        raise XyzIOError(f"file does not exist: {path}")
    try:
        arr = np.loadtxt(path, comments="//", ndmin=2, dtype=np.float64)
    except ValueError as e:
        raise XyzIOError(f"failed to parse {path}: {e}") from e
    if arr.size == 0:
        arr = arr.reshape(0, 3)
    if arr.shape[1] != 3:
        raise XyzIOError(
            f"{path}: expected exactly 3 columns per line, found {arr.shape[1]}"
        )
    return np.ascontiguousarray(arr, dtype=dtype)


def write_xyz(path: Union[str, Path], X: np.ndarray, fmt: str = "%.3f") -> None:
    """Write (n, 3) points with the CloudCompare header ``//X Y Z``,
    byte-equal to ``write_xyz_plain``."""
    m = re.fullmatch(r"%\.(\d+)f", fmt)
    if m is None:
        write_xyz_plain(path, X, fmt)
        return
    from ..native import write_xyz_native

    write_xyz_native(os.fspath(path), X, decimals=int(m.group(1)))


def write_xyz_plain(path: Union[str, Path], X: np.ndarray, fmt: str = "%.3f") -> None:
    """``write_xyz`` through ``np.savetxt``."""
    X = np.asarray(X)
    with open(os.fspath(path), "w") as f:
        f.write("//X Y Z\n")
        np.savetxt(f, X[:, :3], fmt=fmt, delimiter=" ")


def write_correspondences_xyz(path: Union[str, Path], X1: np.ndarray,
                              X2: np.ndarray, distances: np.ndarray) -> None:
    """Write one debug row per correspondence: both points and their
    point-to-plane distance."""
    data = np.column_stack([X1, X2, distances])
    with open(os.fspath(path), "w") as f:
        f.write("//X1 Y1 Z1 X2 Y2 Z2 point_to_plane_distance\n")
        np.savetxt(f, data, delimiter=" ")
