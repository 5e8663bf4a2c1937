#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON object on a line of its own:
  device   the card (and nvidia-smi's name and power limit line), TF32 off;
  build    nvcc of every csrc/*.cu, with its -Xptxas -v register and
           shared-memory lines;
  kernels  each kernel against its plain PyTorch version on the card, float32
           and float64: main-path shapes, odd shapes, a ref mask, a lattice
           of exact ties. Tolerance: none, indices equal and d2 bit-equal;
  main     icp_register at 100 000 x 100 000 (default config): float32 on the
           card recovers the known motion; float64 on the card equals float64
           on the CPU (plain versions) in iterations, selection, last
           matches and H (1e-9); the launch counts prove both kernels ran;
  scale    icp_register at 1 340 000 x 1 340 000, float32, on the card;
  times    kernel times (CUDA events, warm L2) beside their bounds and the
           plain versions' times; registration times; host reads; memory;
  profile  one registration at each size under torch.profiler: device busy
           and idle share, kernel launches, device time by kernel.
Then the kernels line and, last, {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero without its last
line. It imports no JAX: the port alone runs here.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

PHASES = ("device", "build", "kernels", "main", "scale", "times", "profile")
SOURCE = "simpleicp_tpu_torch/csrc/knn.cu"
REPLACES = {
    "match_transform": "simpleicp_tpu/ops/knn_pallas.py:197",
    "knn_search": "simpleicp_tpu/ops/knn_pallas.py:69",
}
# Surface-sample sizes: the main path at the 100k scale of the repo's
# default registrations, and the 1.34M airborne scale.
N_MAIN = 100_000
N_SCALE = 1_340_000
SEED = 20261016


T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- data


def surface(rng, n, half=2.0):
    import numpy as np

    xy = rng.uniform(-half, half, size=(n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z])


def known_motion():
    import numpy as np

    a = np.array([0.02, -0.015, 0.03])
    t = np.array([0.05, -0.04, 0.03])
    c1, s1, c2, s2, c3, s3 = (
        np.cos(a[0]), np.sin(a[0]), np.cos(a[1]), np.sin(a[1]),
        np.cos(a[2]), np.sin(a[2]),
    )
    R = np.array(
        [
            [c2 * c3, -c2 * s3, s2],
            [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2],
            [s1 * s3 - c1 * s2 * c3, s1 * c3 + c1 * s2 * s3, c1 * c2],
        ]
    )
    return R, t


def cloud_pair(n, seed, area_scale=1.0):
    """Fixed cloud and an independent sample of the same surface moved by
    the known motion; area_scale widens the domain at constant density."""
    import numpy as np

    rng = np.random.default_rng(seed)
    half = 2.0 * math.sqrt(area_scale)
    R, t = known_motion()
    X_fix = surface(rng, n, half)
    X_mov = (surface(rng, n, half) - t) @ R
    return X_fix, X_mov, t


# ---------------------------------------------------------------- phases


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "phase": "device",
        "nvidia_smi": line,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
    }
    emit(info)
    return line


def phase_build():
    from simpleicp_tpu_torch import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = []
    for name in paths:
        for ln in _build.BUILD_LOGS.get(name, "").splitlines():
            if any(w in ln for w in ("registers", "Compiling entry", "spill", "smem")):
                ptxas.append(ln.strip())
    emit({"phase": "build", "seconds": seconds, "sources": sorted(paths),
          "ptxas": ptxas})


class Compare:
    """Kernel-versus-plain comparisons; max abs d2 error per kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.err = {"match_transform": 0.0, "knn_search": 0.0}
        self.cases = []

    def record(self, kernel, case, d_k, i_k, d_p, i_p):
        torch = self.torch
        same_i = torch.equal(i_k, i_p)
        same_d = torch.equal(d_k, d_p)
        fin = torch.isfinite(d_p)
        err = float((d_k[fin] - d_p[fin]).abs().max()) if bool(fin.any()) else 0.0
        self.err[kernel] = max(self.err[kernel], err)
        self.cases.append({"kernel": kernel, "case": case, "idx_equal": same_i,
                           "d2_bit_equal": same_d, "max_abs_err": err})
        check(same_i and same_d,
              f"{kernel} {case}: kernel and plain version differ "
              f"(idx equal {same_i}, d2 bit-equal {same_d}, err {err})")


def random_rigid(torch, rng, dtype, dev):
    from simpleicp_tpu_torch.ops.transform import rbp_to_H

    p = rng.uniform([-0.2, -0.2, -0.2, -1, -1, -1], [0.2, 0.2, 0.2, 1, 1, 1])
    return rbp_to_H(torch.tensor(p, dtype=dtype, device=dev))


def phase_kernels(torch):
    import numpy as np

    from simpleicp_tpu_torch.ops import knn

    dev = torch.device("cuda")
    cmp = Compare(torch)
    rng = np.random.default_rng(SEED)
    X_fix, X_mov, _ = cloud_pair(N_MAIN, SEED)
    sel = np.round(np.linspace(0, N_MAIN - 1, 1000)).astype(np.int64)
    lattice = np.stack(np.meshgrid(*[np.arange(12.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lat_q = lattice[rng.choice(len(lattice), 300, replace=False)] + 0.5 * rng.integers(0, 2, (300, 3))

    def run(kernel, case, fn_k, fn_p):
        d_k, i_k = fn_k()
        torch.cuda.synchronize()
        d_p, i_p = fn_p()
        torch.cuda.synchronize()
        cmp.record(kernel, case, d_k, i_k, d_p, i_p)

    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).replace("torch.", "")

        def T(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

        Xf, Xm = T(X_fix), T(X_mov)
        Q = T(X_fix[sel])
        H = random_rigid(torch, rng, dtype, dev)
        run("match_transform", f"{tag} main 1000x{N_MAIN}",
            lambda: knn.match_transform(Q, Xm, H),
            lambda: knn.match_transform_plain(Q, Xm, H))
        for k in (10, 40):
            run("knn_search", f"{tag} main 1000x{N_MAIN} k={k}",
                lambda: knn.knn_search(Q, Xf, k),
                lambda: knn.knn_search_plain(Q, Xf, k))
        for nq, nr in ((1, 1), (7, 130), (512, 2048)):
            q = T(rng.uniform(0, 1, (nq, 3)))
            r = T(rng.uniform(0, 1, (nr, 3)))
            Hs = random_rigid(torch, rng, dtype, dev)
            run("match_transform", f"{tag} odd {nq}x{nr}",
                lambda: knn.match_transform(q, r, Hs),
                lambda: knn.match_transform_plain(q, r, Hs))
            kk = min(10, nr)
            run("knn_search", f"{tag} odd {nq}x{nr} k={kk}",
                lambda: knn.knn_search(q, r, kk),
                lambda: knn.knn_search_plain(q, r, kk))
        q = T(rng.uniform(0, 1, (130, 3)))
        r = T(rng.uniform(0, 1, (3000, 3)))
        mask = torch.as_tensor(rng.random(3000) < 0.3, device=dev)
        run("knn_search", f"{tag} masked 130x3000 k=5",
            lambda: knn.knn_search(q, r, 5, ref_mask=mask),
            lambda: knn.knn_search_plain(q, r, 5, ref_mask=mask))
        few = torch.zeros(3000, dtype=torch.bool, device=dev)
        few[[5, 900, 2999]] = True
        run("knn_search", f"{tag} masked, fewer valid than k=8",
            lambda: knn.knn_search(q, r, 8, ref_mask=few),
            lambda: knn.knn_search_plain(q, r, 8, ref_mask=few))
        lq, lr = T(lat_q), T(lattice)
        eye = torch.eye(4, dtype=dtype, device=dev)
        run("match_transform", f"{tag} tie lattice 300x{len(lattice)}",
            lambda: knn.match_transform(lq, lr, eye),
            lambda: knn.match_transform_plain(lq, lr, eye))
        run("knn_search", f"{tag} tie lattice 300x{len(lattice)} k=26",
            lambda: knn.knn_search(lq, lr, 26),
            lambda: knn.knn_search_plain(lq, lr, 26))
    emit({"phase": "kernels", "tolerance": "indices equal, d2 bit-equal",
          "cases": cmp.cases, "max_abs_err": cmp.err})
    return cmp.err


def _register(torch, X_fix, X_mov, dtype, device):
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models.icp import _icp_register

    return _icp_register(
        X_fix, X_mov, IcpConfig(), rbp_observed_values=None,
        rbp_observation_weights=None, normals_fix=None, planarity_fix=None,
        planarity_mov=None, fixed_prep=None, device=device, dtype=dtype,
    )


def counted_run(torch, X_fix, X_mov, dtype):
    """One registration on the card with every count set to 0 just before
    and read just after."""
    from simpleicp_tpu_torch.ops import knn_cuda
    from simpleicp_tpu_torch.utils import sync

    torch.cuda.synchronize()
    knn_cuda.reset_launch_counts()
    sync.reset_host_reads()
    t0 = time.perf_counter()
    res, carry = _register(torch, X_fix, X_mov, dtype, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    reads = sync.host_reads()
    n_it = int(res.n_iterations)
    check(launches["knn_search"] == 1,
          f"k-NN kernel launched {launches['knn_search']} times, expected 1")
    check(launches["match_transform"] == n_it,
          f"match kernel launched {launches['match_transform']} times in "
          f"{n_it} iterations")
    return res, carry, launches, reads, seconds


def check_recovery(res, t, what, converge=True):
    """The known translation recovered to 2e-3, no error, and (unless
    converge is False) convergence. float64 runs use converge=False: the
    convergence noise floor is ~1e-14 there, so on independent samples the
    purely relative 1% criterion may never fire before max_iterations."""
    import numpy as np

    H = res.H.double().cpu().numpy()
    err = float(np.abs(H[:3, 3] - t).max())
    if converge:
        check(bool(res.converged), f"{what}: not converged")
    check(int(res.error_code) == 0, f"{what}: error_code {int(res.error_code)}")
    check(bool(np.isfinite(H).all()), f"{what}: H not finite")
    check(err < 2e-3, f"{what}: translation error {err} >= 2e-3")
    return err


def phase_main(torch):
    import numpy as np

    X_fix, X_mov, t = cloud_pair(N_MAIN, SEED + 1)
    res, _, launches, reads, seconds = counted_run(torch, X_fix, X_mov, torch.float32)
    err = check_recovery(res, t, "float32 100k")
    out = {"phase": "main", "n_fix": N_MAIN, "n_mov": N_MAIN,
           "float32": {"n_iterations": int(res.n_iterations),
                       "translation_err": err, "launches": launches,
                       "host_reads": reads, "first_run_s": seconds}}

    res_g, carry_g, launches_g, _, card_s = counted_run(torch, X_fix, X_mov, torch.float64)
    t0 = time.perf_counter()
    res_c, carry_c = _register(torch, X_fix, X_mov, torch.float64, "cpu")
    cpu_s = time.perf_counter() - t0
    n_g, n_c = int(res_g.n_iterations), int(res_c.n_iterations)
    check(n_g == n_c, f"float64 iterations: card {n_g}, CPU {n_c}")
    check(torch.equal(res_g.sel_idx.cpu(), res_c.sel_idx), "float64 sel_idx differ")
    check(torch.equal(carry_g.m_idx.cpu(), carry_c.m_idx), "float64 last m_idx differ")
    dH = float((res_g.H.cpu() - res_c.H).abs().max())
    check(dH <= 1e-9, f"float64 H differs by {dH} > 1e-9")
    err_g = check_recovery(res_g, t, "float64 100k card", converge=False)
    out["float64_card_vs_cpu"] = {
        "n_iterations": n_g, "converged": bool(res_g.converged),
        "translation_err": err_g, "sel_idx_equal": True,
        "last_m_idx_equal": True, "H_max_abs_diff": dH,
        "launches": launches_g, "card_run_s": card_s, "cpu_run_s": cpu_s,
    }
    emit(out)
    return launches, int(res.n_iterations), reads


def phase_scale(torch):
    X_fix, X_mov, t = cloud_pair(N_SCALE, SEED + 2, area_scale=N_SCALE / N_MAIN)
    torch.cuda.reset_peak_memory_stats()
    res, _, launches, reads, seconds = counted_run(torch, X_fix, X_mov, torch.float32)
    err = check_recovery(res, t, "float32 1.34M")
    emit({"phase": "scale", "n_fix": N_SCALE, "n_mov": N_SCALE,
          "n_iterations": int(res.n_iterations), "translation_err": err,
          "launches": launches, "host_reads": reads, "first_run_s": seconds,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    return X_fix, X_mov


def cuda_ms(torch, fn, reps):
    """Mean ms per call over reps calls between two CUDA events, after two
    warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(kernel, n_q, n_r, dtype_bytes, k=1):
    """Least time (ms) an H100 SXM could take for one call: the larger of
    the bytes it must move (each input read once, each output written once)
    over 3.35 TB/s and its operations over the type's peak outside the
    tensor cores (67 TFLOP/s float32, 34 TFLOP/s float64; NVIDIA data sheet,
    700 W). Operations: 8 per (query, ref) pair (3 subtractions, 3
    multiplications, 2 additions), plus 18 per ref for the fused transform."""
    peak = 67e12 if dtype_bytes == 4 else 34e12
    ops = 8.0 * n_q * n_r
    nbytes = 3 * dtype_bytes * (n_q + n_r)
    if kernel == "match_transform":
        ops += 18.0 * n_r
        nbytes += 12 * dtype_bytes + n_q * (dtype_bytes + 4)
    else:
        nbytes += n_q * k * (dtype_bytes + 4)
    t_bytes, t_ops = nbytes / 3.35e12, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def phase_times(torch, scale_clouds):
    import numpy as np

    from simpleicp_tpu_torch.ops import knn
    from simpleicp_tpu_torch.utils import sync

    dev = torch.device("cuda")
    X_fix, X_mov, _ = cloud_pair(N_MAIN, SEED + 1)
    sel = np.round(np.linspace(0, N_MAIN - 1, 1000)).astype(np.int64)
    kernels = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).replace("torch.", "")
        size = 4 if dtype == torch.float32 else 8
        Xf = torch.as_tensor(X_fix, dtype=dtype, device=dev)
        Xm = torch.as_tensor(X_mov, dtype=dtype, device=dev)
        Q = Xf[torch.as_tensor(sel, device=dev)].contiguous()
        H = random_rigid(torch, np.random.default_rng(SEED), dtype, dev)
        row = {}
        b, by = bound_ms("match_transform", 1000, N_MAIN, size)
        row["match_transform"] = {
            "ms": cuda_ms(torch, lambda: knn.match_transform(Q, Xm, H), 50),
            "plain_ms": cuda_ms(torch, lambda: knn.match_transform_plain(Q, Xm, H), 5),
            "bound_ms": b, "bound_by": by, "library_ms": None,
        }
        b, by = bound_ms("knn_search", 1000, N_MAIN, size, k=10)
        row["knn_search"] = {
            "ms": cuda_ms(torch, lambda: knn.knn_search(Q, Xf, 10), 20),
            "plain_ms": cuda_ms(torch, lambda: knn.knn_search_plain(Q, Xf, 10), 3),
            "bound_ms": b, "bound_by": by, "library_ms": None,
        }
        kernels[tag] = row
    emit({"phase": "times", "what": f"kernels at 1000 x {N_MAIN} (k=10), warm L2",
          "kernels": kernels})

    reg = {}
    clouds = {"100k": (X_fix, X_mov, 5)}
    if scale_clouds is not None:
        clouds["1.34M"] = (*scale_clouds, 3)
    for label, (A, B, reps) in clouds.items():
        Af = torch.as_tensor(A, dtype=torch.float32, device=dev)
        Bf = torch.as_tensor(B, dtype=torch.float32, device=dev)
        _register(torch, Af, Bf, torch.float32, "cuda")  # warm-up
        times, reads, iters = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(reps):
            torch.cuda.synchronize()
            sync.reset_host_reads()
            t0 = time.perf_counter()
            res, _ = _register(torch, Af, Bf, torch.float32, "cuda")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            reads.append(sync.host_reads())
            iters.append(int(res.n_iterations))
        reg[label] = {"median_s": statistics.median(times), "runs_s": times,
                      "n_iterations": iters, "host_reads": reads,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "input": "float32 tensors already on the card"}
    emit({"phase": "times", "what": "icp_register, default config, float32",
          "registration": reg})
    return kernels["float32"]


KERNEL_NAMES = {"match_transform_scan": "match_transform", "nn_reduce": "match_transform",
                "knn_scan": "knn_search", "knn_merge": "knn_search"}


def phase_profile(torch, scale_clouds):
    """Where the time of one float32 registration goes: host wall time,
    the device's busy time (sum of kernel durations; one stream, so they
    do not overlap) and idle share, the number of kernel launches, and the
    device time of the port's two kernels against everything else."""
    from torch.profiler import ProfilerActivity, profile

    from simpleicp_tpu_torch.utils import sync

    dev = torch.device("cuda")
    X_fix, X_mov, _ = cloud_pair(N_MAIN, SEED + 1)
    clouds = {"100k": (X_fix, X_mov)}
    if scale_clouds is not None:
        clouds["1.34M"] = scale_clouds
    out = {}
    for label, (A, B) in clouds.items():
        Af = torch.as_tensor(A, dtype=torch.float32, device=dev)
        Bf = torch.as_tensor(B, dtype=torch.float32, device=dev)
        _register(torch, Af, Bf, torch.float32, "cuda")  # warm-up
        torch.cuda.synchronize()
        sync.reset_host_reads()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res, _ = _register(torch, Af, Bf, torch.float32, "cuda")
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name, port = {}, {"match_transform": 0.0, "knn_search": 0.0}
        for e in kernels:
            short = next((k for k in KERNEL_NAMES if k in e.name), e.name[:70])
            ms = e.time_range.elapsed_us() / 1e3
            tot, cnt = by_name.get(short, (0.0, 0))
            by_name[short] = (tot + ms, cnt + 1)
            if short in KERNEL_NAMES:
                port[KERNEL_NAMES[short]] += ms
        busy_ms = sum(v[0] for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        out[label] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "kernel_launches": len(kernels), "host_reads": sync.host_reads(),
            "n_iterations": int(res.n_iterations),
            "port_kernels_ms": port,
            "top_device_ms": [[k, v[0], v[1]] for k, v in top],
        }
    emit({"phase": "profile", "what": "one float32 registration, default config",
          "cells": out})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import simpleicp_tpu_torch  # noqa: F401  (fails outside the repository)

    check("jax" not in sys.modules and "simpleicp_tpu" not in sys.modules,
          "the port imported JAX or the JAX package")

    phase_device(torch)
    if "build" in phases:
        phase_build()
    errs = phase_kernels(torch) if "kernels" in phases else None
    main_info = phase_main(torch) if "main" in phases else None
    scale_clouds = phase_scale(torch) if "scale" in phases else None
    times = phase_times(torch, scale_clouds) if "times" in phases else None
    if "profile" in phases:
        phase_profile(torch, scale_clouds)

    if errs is not None and main_info is not None and times is not None:
        launches = main_info[0]
        emit({"kernels": [
            {"name": name, "route": "cuda", "source": SOURCE,
             "replaces": REPLACES[name], "launches": launches[name],
             "max_abs_err": errs[name], **times[name]}
            for name in ("match_transform", "knn_search")
        ]})
    check("jax" not in sys.modules, "JAX was imported during the run")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
