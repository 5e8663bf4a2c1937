"""Build the native sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` holds kernels behind a plain C interface and becomes
``_build/lib<name>-<hash>.so``, loaded with ctypes by its wrapper module.
The host C++ of ``native/*.cpp`` (the xyz reader and writer) becomes one
``_build/libnative-<hash>.so``. The hash covers the sources, the compiler
and the flags, so an edited source is rebuilt and a stale library is never
loaded. nvcc is looked up in ``$CUDA_HOME``, then on ``PATH``, then in the
toolkit's default prefix ``/usr/local/cuda``; the host compiler is ``$CXX``,
else ``g++``. A library is compiled to a file of its process's own and
moved into place, so processes that build it at once do not collide.
The sources are package data (``pyproject.toml``), so an installed package
builds into its own ``_build/`` as a checkout does; one that lacks a
source raises RuntimeError naming it. Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

SRC_DIR = Path(__file__).resolve().parent / "csrc"
NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NATIVE = "native"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# No -march=native: a built library may be copied with the checkout to a
# host of another CPU.
CXX_FLAGS = ("-std=c++17", "-O3", "-Wall", "-Wextra", "-shared", "-fPIC", "-pthread")

# nvcc's output (with the -Xptxas -v register and shared-memory lines) of
# each library built or found in this process.
BUILD_LOGS: Dict[str, str] = {}
# Compiler wall seconds of each library this process built (not of one it
# found built).
BUILD_SECONDS: Dict[str, float] = {}

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


def cxx_path() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(
            f"host C++ compiler {cxx!r} not found (set CXX or put g++ on PATH): "
            "the xyz reader and writer are built from native/ at their first use"
        )
    return found


def _sources(name: str):
    """The sources of ``name``, checked before any compiler is looked up:
    a missing one (or no ``native/*.cpp`` at all) raises RuntimeError
    naming its path."""
    if name == NATIVE:
        srcs = sorted(NATIVE_DIR.glob("*.cpp"))
        missing = [] if srcs else [NATIVE_DIR / "*.cpp"]
    else:
        srcs = [SRC_DIR / f"{name}.cu"]
        missing = [s for s in srcs if not s.is_file()]
    if missing:
        raise RuntimeError(
            f"missing source {', '.join(map(str, missing))}: this install of "
            "simpleicp_tpu_torch lacks the package's sources (csrc/*.cu and "
            "native/*.cpp are package data, built at first use)"
        )
    return srcs


def _job(name: str):
    """(target, compile command without its output path, sources) of
    ``name``: a ``csrc/`` source, or ``NATIVE``."""
    srcs = _sources(name)
    tool, flags = (cxx_path(), CXX_FLAGS) if name == NATIVE else (nvcc_path(), NVCC_FLAGS)
    h = hashlib.sha256(" ".join((os.path.basename(tool), *flags)).encode())
    for src in srcs:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so", [tool, *flags], srcs


def build(name: str) -> Path:
    """Path of the built library of ``csrc/<name>.cu`` (or of ``native/``
    for ``NATIVE``), compiling it first if these sources and flags were
    never built. Distinct libraries build concurrently; a second caller of
    one waits for the first. A missing source or a failed compile raises
    RuntimeError, with the source's path or the compiler's output."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        out, cmd, srcs = _job(name)
        log_path = out.with_suffix(".log")
        if out.exists():
            if name not in BUILD_LOGS and log_path.exists():
                BUILD_LOGS[name] = log_path.read_text()
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([*cmd, "-o", str(tmp), *map(str, srcs)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed on "
                               f"{', '.join(s.name for s in srcs)}:\n{log}")
        os.replace(tmp, out)
        log_path.write_text(log)
        BUILD_LOGS[name] = log
        BUILD_SECONDS[name] = seconds
        return out


def build_all(names: Iterable[str] = None) -> Dict[str, Path]:
    """Build every source in ``csrc/`` and the native library (or the given
    names), one compiler per library, all started together."""
    if names is None:
        names = sorted(p.stem for p in SRC_DIR.glob("*.cu")) + [NATIVE]
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))
