"""Build the CUDA sources in ``csrc/`` into shared libraries, at first use.

Each ``csrc/<name>.cu`` holds kernels behind a plain C interface and becomes
``_build/lib<name>-<hash>.so``, loaded with ctypes by its wrapper module.
The hash covers the source and the flags, so an edited source is rebuilt
and a stale library is never loaded. nvcc is looked up in ``$CUDA_HOME``,
then on ``PATH``, then in the toolkit's default prefix ``/usr/local/cuda``.
Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# nvcc's output (with the -Xptxas -v register and shared-memory lines) of
# each library built or found in this process.
BUILD_LOGS: Dict[str, str] = {}

_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from csrc/ at their first use"
    )


def _target(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Path of the built library of ``csrc/<name>.cu``, compiling it first
    if this source and these flags were never built. Distinct sources
    build concurrently; a second caller of one source waits for the first."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        out = _target(name)
        log_path = out.with_suffix(".log")
        if out.exists():
            if name not in BUILD_LOGS and log_path.exists():
                BUILD_LOGS[name] = log_path.read_text()
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        os.replace(tmp, out)
        log_path.write_text(log)
        BUILD_LOGS[name] = log
        return out


def build_all(names: Iterable[str] = None) -> Dict[str, Path]:
    """Build every source in ``csrc/`` (or the given ones), one nvcc per
    source, all started together."""
    names = sorted(p.stem for p in SRC_DIR.glob("*.cu")) if names is None else list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))
