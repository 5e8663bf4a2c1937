"""ctypes wrappers of the kernels in ``csrc/solver.cu``: the Gauss-Newton
solve and the a-posteriori uncertainties.

``gn_solve_cuda`` and ``uncertainties_cuda`` check their tensors, allocate
the outputs with ``torch.empty``, launch their kernel on PyTorch's current
stream (one block per problem) and raise if ``cudaGetLastError`` reports a
failure. They never synchronize and never fall back to the plain versions
(``models/solver.py`` ``gn_solve_plain``, ``estimate_uncertainties_plain``).
Each launch adds one to ``LAUNCHES["gn_solve"]`` or
``LAUNCHES["uncertainties"]``; nothing else touches the counts but
``reset_launch_counts``.

The library is built by ``_build.build`` at the first call, not at import,
so importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from .. import _build

# Launches since the last reset_launch_counts().
LAUNCHES = {"gn_solve": 0, "uncertainties": 0}

_MAX_THREADS = 256       # csrc/solver.cu kMaxThreads
_ROWS_PER_THREAD = 4     # the most correspondences a thread takes below _MAX_THREADS

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
            lib = ctypes.CDLL(str(_build.build("solver")))
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"simpleicp_gn_solve_{suffix}")
                # p0, xm, xf, n, mask, dw, obs_vals, obs_w, active, B, C,
                # n_steps, threads, p_out, res_out, rel_out, stream
                fn.argtypes = [_P] * 9 + [_I] * 4 + [_P] * 4
                fn.restype = _I
                fn = getattr(lib, f"simpleicp_uncertainties_{suffix}")
                # p, xm, xf, n, mask, dw, obs_vals, obs_w, B, C, threads,
                # sigma_out, cxx_out, stream
                fn.argtypes = [_P] * 8 + [_I] * 3 + [_P] * 3
                fn.restype = _I
            _lib = lib
        return _lib


def block_threads(C: int) -> int:
    """Threads of a problem's block for C correspondences: the least power
    of two from 32 that gives each thread at most _ROWS_PER_THREAD of them,
    and at most _MAX_THREADS (256 from the main path's C = 1000 up, as at a
    prepared big-C registration's 100 000; 32 for a handful)."""
    threads = 32
    while threads < _MAX_THREADS and _ROWS_PER_THREAD * threads < C:
        threads *= 2
    return threads


def _check(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype,
           shape: Tuple[int, ...]) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_problems(p, xm, xf, n, mask, distance_weight, obs_vals, obs_w,
                    p_name: str) -> Tuple[int, int]:
    """Checks the tensors both kernels take (the device last, apart); returns
    (B, C)."""
    if xm.dim() != 3 or xm.shape[-1] != 3:
        raise ValueError(f"xm has shape {tuple(xm.shape)}, expected (B, C, 3)")
    dev, dtype = xm.device, xm.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the solver kernel takes float32 or float64, got {dtype}")
    B, C = xm.shape[:2]
    _check("xm", xm, dev, dtype, (B, C, 3))
    for name, t in (("xf", xf), ("n", n)):
        _check(name, t, dev, dtype, (B, C, 3))
    for name, t in ((p_name, p), ("obs_vals", obs_vals), ("obs_w", obs_w)):
        _check(name, t, dev, dtype, (B, 6))
    _check("distance_weight", distance_weight, dev, dtype, (B,))
    _check("mask", mask, dev, torch.bool, (B, C))
    if B >= 2**31 or C >= 2**31:
        raise ValueError("too many problems or correspondences for int32 counts")
    return B, C


def _check_device(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the solver kernel takes CUDA tensors, got {dev}")


def gn_solve_cuda(p0: torch.Tensor, xm: torch.Tensor, xf: torch.Tensor, n: torch.Tensor,
                  mask: torch.Tensor, distance_weight: torch.Tensor,
                  obs_vals: torch.Tensor, obs_w: torch.Tensor, n_steps: int,
                  active: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel of ``solver.gn_solve`` on B problems of C correspondences:
    p0, obs_vals, obs_w (B, 6), xm, xf, n (B, C, 3), mask (B, C) bool,
    distance_weight (B,), active (B,) bool or None (every problem steps),
    all contiguous and on one CUDA device, float32 or float64 but the
    masks. Returns (p (B, 6), residuals (B, C), rel (B,)) in xm's dtype.
    The device is checked last, so that a CPU tensor of the wrong type or
    shape is refused as on the card."""
    B, C = _check_problems(p0, xm, xf, n, mask, distance_weight, obs_vals, obs_w, "p0")
    dev, dtype = xm.device, xm.dtype
    if active is not None:
        _check("active", active, dev, torch.bool, (B,))
    if not 0 <= n_steps < 2**31:
        raise ValueError(f"n_steps must be in [0, 2**31), got {n_steps}")
    _check_device(dev)
    p = torch.empty((B, 6), dtype=dtype, device=dev)
    res = torch.empty((B, C), dtype=dtype, device=dev)
    rel = torch.empty((B,), dtype=dtype, device=dev)
    if B == 0:
        return p, res, rel
    fn = getattr(_library(), "simpleicp_gn_solve_f32" if dtype == torch.float32
                 else "simpleicp_gn_solve_f64")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p0.data_ptr(), xm.data_ptr(), xf.data_ptr(), n.data_ptr(), mask.data_ptr(),
                 distance_weight.data_ptr(), obs_vals.data_ptr(), obs_w.data_ptr(),
                 None if active is None else active.data_ptr(), B, C, n_steps,
                 block_threads(C), p.data_ptr(), res.data_ptr(), rel.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gn_solve kernel launch failed: CUDA error {err}")
    LAUNCHES["gn_solve"] += 1
    return p, res, rel


def uncertainties_cuda(p: torch.Tensor, xm: torch.Tensor, xf: torch.Tensor, n: torch.Tensor,
                       mask: torch.Tensor, distance_weight: torch.Tensor,
                       obs_vals: torch.Tensor, obs_w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel of ``solver.estimate_uncertainties`` on B problems of C
    correspondences at their final p (B, 6); the other tensors as
    ``gn_solve_cuda``'s. Returns (sigma (B, 6), Cxx (B, 6, 6)) in xm's
    dtype. The device is checked last, as there."""
    B, C = _check_problems(p, xm, xf, n, mask, distance_weight, obs_vals, obs_w, "p")
    dev, dtype = xm.device, xm.dtype
    _check_device(dev)
    sigma = torch.empty((B, 6), dtype=dtype, device=dev)
    cxx = torch.empty((B, 6, 6), dtype=dtype, device=dev)
    if B == 0:
        return sigma, cxx
    fn = getattr(_library(), "simpleicp_uncertainties_f32" if dtype == torch.float32
                 else "simpleicp_uncertainties_f64")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p.data_ptr(), xm.data_ptr(), xf.data_ptr(), n.data_ptr(), mask.data_ptr(),
                 distance_weight.data_ptr(), obs_vals.data_ptr(), obs_w.data_ptr(), B, C,
                 block_threads(C), sigma.data_ptr(), cxx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"uncertainty kernel launch failed: CUDA error {err}")
    LAUNCHES["uncertainties"] += 1
    return sigma, cxx
