#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON object on a line of its own:
  device   the card (and nvidia-smi's name and power limit line), TF32 off;
  build    nvcc of every csrc/*.cu, with its -Xptxas -v register and
           shared-memory lines;
  kernels  each kernel against its plain PyTorch version on the card, float32
           and float64: main-path and gate shapes, odd shapes, a ref mask,
           no valid ref, a lattice of exact ties. Tolerance: none, indices
           equal and d2 bit-equal;
  main     icp_register at 100 000 x 100 000 (default config): float32 on the
           card recovers the known motion; float64 on the card equals float64
           on the CPU (plain versions) in iterations, selection, last
           matches and H (1e-9); the launch counts prove both kernels ran;
  scale    icp_register at 1 340 000 x 1 340 000, float32, on the card; the
           match and k-NN kernels bit-equal to their plain versions on that
           run's selection and final H;
  gated    icp_register with the overlap gate on a partial-overlap pair (the
           fixed cloud over x in [-2, 2], the movable over [-1, 3], scaled
           at constant density): float32 at 100 000 x 100 000 recovers the
           motion and selects only points of the overlap, with one gate
           (1-NN kernel) launch; float64 on the card equals the CPU at
           20 000 x 20 000; float32 at 1 000 000 x 1 000 000 (gate_method
           "auto" resolves to the brute gate: 1e12 < 2^40 pairs), where the
           gate kernel is bit-equal to its plain version on all 1M rows, and
           on refs of exact ties;
  cli      python3 -m simpleicp_tpu_torch on a gated 100 000-point xyz pair,
           as a subprocess on the card: its lines and its exported cloud;
  times    kernel times (CUDA events, warm L2) beside their bounds and the
           plain versions' times; registration times; host reads; memory;
  profile  one registration of each cell under torch.profiler: device busy
           and idle share, kernel launches, device time by kernel.
Then the kernels line and, last, {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero without its last
line. It imports no JAX: the port alone runs here.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PHASES = ("device", "build", "kernels", "main", "scale", "gated", "cli",
          "times", "profile")
KERNELS = ("match_transform", "knn_search", "nn_search")
SOURCE = "simpleicp_tpu_torch/csrc/knn.cu"
REPLACES = {
    "match_transform": "simpleicp_tpu/ops/knn_pallas.py:197",
    "knn_search": "simpleicp_tpu/ops/knn_pallas.py:69",
    "nn_search": "simpleicp_tpu/ops/knn_pallas.py:41",
}
# Surface-sample sizes: the main path at the 100k scale of the repo's
# default registrations, and the 1.34M airborne scale; the gated cells at
# 100k and at 1M x 1M, the largest size whose gate "auto" sends to the
# brute 1-NN; the float64 card-versus-CPU check of the gate at 20k (a CPU
# brute gate at 100k takes minutes).
N_MAIN = 100_000
N_SCALE = 1_340_000
N_GATE_BIG = 1_000_000
N_GATE_F64 = 20_000
# Gate radius: about 8 point spacings at the density of every cloud here
# (100 000 points over 16 square units).
GATE_RADIUS = 0.1
SEED = 20261016
ROOT = Path(__file__).resolve().parent


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


def partial_pair(n, seed, area_scale=1.0):
    """A partial-overlap pair at constant density: the fixed cloud over
    x in [-half, half], the movable sample over x in [-half/2, 3 half/2]
    moved by the known motion (half = 2 at area_scale 1). Returns
    (X_fix, X_mov, t, x where the overlap starts)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    half = 2.0 * math.sqrt(area_scale)
    R, t = known_motion()
    X_fix = surface(rng, n, half)
    S = surface(rng, n, half)
    S[:, 0] += half / 2
    S[:, 2] = 0.3 * np.sin(2 * S[:, 0]) + 0.2 * np.cos(3 * S[:, 1])
    return X_fix, (S - t) @ R, t, -half / 2


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
        self.err = {name: 0.0 for name in KERNELS}
        self.cases = []

    def run(self, kernel, case, fn_k, fn_p):
        """Call the kernel, then its plain version, and record the case."""
        d_k, i_k = fn_k()
        self.torch.cuda.synchronize()
        d_p, i_p = fn_p()
        self.torch.cuda.synchronize()
        self.record(kernel, case, d_k, i_k, d_p, i_p)

    def since(self, n):
        """The cases recorded after the first n."""
        return self.cases[n:]

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


def phase_kernels(torch, cmp):
    import numpy as np

    from simpleicp_tpu_torch.ops import knn

    dev = torch.device("cuda")
    n0 = len(cmp.cases)
    run = cmp.run
    rng = np.random.default_rng(SEED)
    X_fix, X_mov, _ = cloud_pair(N_MAIN, SEED)
    sel = np.round(np.linspace(0, N_MAIN - 1, 1000)).astype(np.int64)
    lattice = np.stack(np.meshgrid(*[np.arange(12.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lat_q = lattice[rng.choice(len(lattice), 300, replace=False)] + 0.5 * rng.integers(0, 2, (300, 3))

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

        # the 1-NN of the overlap gate: every fixed point a query
        run("nn_search", f"{tag} gate {N_MAIN}x{N_MAIN}",
            lambda: knn.nn_search(Xf, Xm), lambda: knn.nn_search_plain(Xf, Xm))
        for nq, nr in ((1, 1), (7, 130), (512, 2048), (4099, 3001)):
            q = T(rng.uniform(0, 1, (nq, 3)))
            r = T(rng.uniform(0, 1, (nr, 3)))
            run("nn_search", f"{tag} odd {nq}x{nr}",
                lambda: knn.nn_search(q, r), lambda: knn.nn_search_plain(q, r))
        q = T(rng.uniform(0, 1, (20_000, 3)))
        r = T(rng.uniform(0, 1, (30_000, 3)))
        mask = torch.as_tensor(rng.random(30_000) < 0.3, device=dev)
        run("nn_search", f"{tag} masked 20000x30000",
            lambda: knn.nn_search(q, r, ref_mask=mask),
            lambda: knn.nn_search_plain(q, r, ref_mask=mask))
        none = torch.zeros(30_000, dtype=torch.bool, device=dev)
        run("nn_search", f"{tag} no valid ref",
            lambda: knn.nn_search(q, r, ref_mask=none),
            lambda: knn.nn_search_plain(q, r, ref_mask=none))
        d_none, i_none = knn.nn_search(q, r, ref_mask=none)
        check(bool(torch.isinf(d_none).all()) and not bool(i_none.any()),
              "nn_search without a valid ref: expected +inf and index 0")
        lat_mask = torch.as_tensor(rng.random(len(lattice)) < 0.5, device=dev)
        run("nn_search", f"{tag} tie lattice 300x{len(lattice)}",
            lambda: knn.nn_search(lq, lr), lambda: knn.nn_search_plain(lq, lr))
        run("nn_search", f"{tag} tie lattice, masked",
            lambda: knn.nn_search(lq, lr, ref_mask=lat_mask),
            lambda: knn.nn_search_plain(lq, lr, ref_mask=lat_mask))
    emit({"phase": "kernels", "tolerance": "indices equal, d2 bit-equal",
          "cases": cmp.since(n0), "max_abs_err": cmp.err})


def _register(torch, X_fix, X_mov, dtype, device, gate=None):
    """icp_register with the default config, or with the overlap gate of
    radius ``gate``; returns (result, final loop state)."""
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models.icp import _icp_register

    cfg = IcpConfig() if gate is None else IcpConfig(max_overlap_distance=gate)
    return _icp_register(
        X_fix, X_mov, cfg, rbp_observed_values=None,
        rbp_observation_weights=None, normals_fix=None, planarity_fix=None,
        planarity_mov=None, fixed_prep=None, device=device, dtype=dtype,
    )


def counted_run(torch, X_fix, X_mov, dtype, gate=None):
    """One registration on the card with every count set to 0 just before
    and read just after: one k-NN launch, one match launch per iteration,
    and one gate (1-NN) launch when gated, none otherwise."""
    from simpleicp_tpu_torch.ops import knn_cuda
    from simpleicp_tpu_torch.utils import sync

    torch.cuda.synchronize()
    knn_cuda.reset_launch_counts()
    sync.reset_host_reads()
    t0 = time.perf_counter()
    res, carry = _register(torch, X_fix, X_mov, dtype, "cuda", gate)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    reads = sync.host_reads()
    n_it = int(res.n_iterations)
    want = {"match_transform": n_it, "knn_search": 1,
            "nn_search": 0 if gate is None else 1}
    check(launches == want, f"kernel launches {launches}, expected {want}")
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


def phase_scale(torch, cmp):
    """icp_register at 1.34M; then the match and k-NN kernels against their
    plain versions on that run's inputs: its C selected fixed points against
    the whole movable cloud under its final H, and against the fixed cloud."""
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.ops import knn

    X_fix, X_mov, t = cloud_pair(N_SCALE, SEED + 2, area_scale=N_SCALE / N_MAIN)
    torch.cuda.reset_peak_memory_stats()
    res, _, launches, reads, seconds = counted_run(torch, X_fix, X_mov, torch.float32)
    err = check_recovery(res, t, "float32 1.34M")
    peak = torch.cuda.max_memory_allocated()

    n0 = len(cmp.cases)
    Xf = torch.as_tensor(X_fix, dtype=torch.float32, device="cuda")
    Xm = torch.as_tensor(X_mov, dtype=torch.float32, device="cuda")
    Q = Xf[res.sel_idx.long()].contiguous()
    H, k = res.H.to(torch.float32), IcpConfig().neighbors
    shape = f"{Q.shape[0]}x{N_SCALE}"
    cmp.run("match_transform", f"float32 scale {shape}, final H",
            lambda: knn.match_transform(Q, Xm, H),
            lambda: knn.match_transform_plain(Q, Xm, H))
    cmp.run("knn_search", f"float32 scale {shape} k={k}",
            lambda: knn.knn_search(Q, Xf, k),
            lambda: knn.knn_search_plain(Q, Xf, k))
    emit({"phase": "scale", "n_fix": N_SCALE, "n_mov": N_SCALE,
          "n_iterations": int(res.n_iterations), "translation_err": err,
          "launches": launches, "host_reads": reads, "first_run_s": seconds,
          "max_memory_allocated": peak, "kernel_vs_plain": cmp.since(n0)})
    return X_fix, X_mov


def check_overlap(res, X_fix, x_overlap, what):
    """The selection lies in the overlap (x >= its start, less the gate
    radius and the initial misalignment of at most 0.15), and the gate cut
    a real part of the fixed cloud away."""
    import numpy as np

    sel = res.sel_idx.cpu().numpy()[res.sel_valid.cpu().numpy()]
    x_min = float(X_fix[sel, 0].min())
    cut = float(np.mean(X_fix[:, 0] < x_overlap - GATE_RADIUS - 0.15))
    check(x_min >= x_overlap - GATE_RADIUS - 0.15,
          f"{what}: a selected point at x={x_min} lies outside the overlap")
    check(cut > 0.05, f"{what}: only {cut} of the fixed cloud lies outside")
    return x_min


def check_gate_1m(torch, cmp, X_fix, X_mov):
    """The 1-NN kernel against its plain version at the gate's 1M x 1M
    layout: every fixed point against the movable cloud under the initial
    transform (identity), all rows; then against a reference cloud whose
    second half repeats its first, so that every answer is an exact tie
    across tiles far apart: all 1M winners must lie in the first copy, and
    a seeded sample of rows (the last block's rows among them) must equal
    the plain version. Each row's answer depends on no other row, so the
    plain version on a subset of queries is the reference for those rows."""
    import numpy as np

    from simpleicp_tpu_torch.ops import knn
    from simpleicp_tpu_torch.ops.transform import apply_H, rbp_to_H

    n0 = len(cmp.cases)
    Xf = torch.as_tensor(X_fix, dtype=torch.float32, device="cuda")
    Xm = torch.as_tensor(X_mov, dtype=torch.float32, device="cuda")
    Xm0 = apply_H(Xm, rbp_to_H(torch.zeros(6, dtype=torch.float32, device="cuda")))
    n_f, n_m = Xf.shape[0], Xm0.shape[0]
    cmp.run("nn_search", f"float32 gate {n_f}x{n_m}, all rows",
            lambda: knn.nn_search(Xf, Xm0), lambda: knn.nn_search_plain(Xf, Xm0))

    half = n_m // 2
    Xt = torch.cat([Xm0[:half], Xm0[:half]]).contiguous()
    d_k, i_k = knn.nn_search(Xf, Xt)
    torch.cuda.synchronize()
    check(int(i_k.max()) < half,
          f"gate ties {n_f}x{2 * half}: a winner lies in the second copy")
    rows = np.random.default_rng(SEED + 7).choice(n_f - 256, 20_000, replace=False)
    rows = torch.as_tensor(np.concatenate([rows, np.arange(n_f - 256, n_f)]),
                           device="cuda")
    d_p, i_p = knn.nn_search_plain(Xf[rows].contiguous(), Xt)
    torch.cuda.synchronize()
    cmp.record("nn_search", f"float32 gate ties {n_f}x{2 * half}, "
               f"{rows.shape[0]} rows", d_k[rows], i_k[rows], d_p, i_p)
    return cmp.since(n0)


def phase_gated(torch, cmp):
    """The gated path: float32 at 100k (launches, recovery, overlap),
    float64 card versus CPU at 20k, float32 at 1M x 1M with the gate
    kernel held against its plain version on that cell's inputs."""
    X_fix, X_mov, t, x0 = partial_pair(N_MAIN, SEED + 3)
    res, _, launches, reads, seconds = counted_run(torch, X_fix, X_mov,
                                                   torch.float32, GATE_RADIUS)
    out = {"phase": "gated", "radius": GATE_RADIUS, "overlap_starts_at_x": x0,
           "float32_100k": {
               "n_iterations": int(res.n_iterations),
               "translation_err": check_recovery(res, t, "gated float32 100k"),
               "selected_x_min": check_overlap(res, X_fix, x0, "gated 100k"),
               "launches": launches, "host_reads": reads, "first_run_s": seconds}}

    A, B, t20, x20 = partial_pair(N_GATE_F64, SEED + 4, N_GATE_F64 / N_MAIN)
    res_g, carry_g, launches_g, _, card_s = counted_run(torch, A, B, torch.float64,
                                                        GATE_RADIUS)
    t0 = time.perf_counter()
    res_c, carry_c = _register(torch, A, B, torch.float64, "cpu", GATE_RADIUS)
    cpu_s = time.perf_counter() - t0
    n_g, n_c = int(res_g.n_iterations), int(res_c.n_iterations)
    check(n_g == n_c, f"gated float64 iterations: card {n_g}, CPU {n_c}")
    check(torch.equal(res_g.sel_idx.cpu(), res_c.sel_idx), "gated float64 sel_idx differ")
    check(torch.equal(res_g.sel_valid.cpu(), res_c.sel_valid),
          "gated float64 sel_valid differ")
    check(torch.equal(carry_g.m_idx.cpu(), carry_c.m_idx), "gated float64 last m_idx differ")
    dH = float((res_g.H.cpu() - res_c.H).abs().max())
    check(dH <= 1e-9, f"gated float64 H differs by {dH} > 1e-9")
    out["float64_20k_card_vs_cpu"] = {
        "n_iterations": n_g, "converged": bool(res_g.converged),
        "selected_x_min": check_overlap(res_g, A, x20, "gated float64 20k"),
        "sel_idx_equal": True, "last_m_idx_equal": True, "H_max_abs_diff": dH,
        "launches": launches_g, "card_run_s": card_s, "cpu_run_s": cpu_s}

    big = partial_pair(N_GATE_BIG, SEED + 5, N_GATE_BIG / N_MAIN)
    torch.cuda.reset_peak_memory_stats()
    res, _, launches, reads, seconds = counted_run(torch, big[0], big[1],
                                                   torch.float32, GATE_RADIUS)
    out["float32_1M"] = {
        "n_iterations": int(res.n_iterations),
        "translation_err": check_recovery(res, big[2], "gated float32 1M"),
        "selected_x_min": check_overlap(res, big[0], big[3], "gated 1M"),
        "launches": launches, "host_reads": reads, "first_run_s": seconds,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "kernel_vs_plain": check_gate_1m(torch, cmp, big[0], big[1])}
    emit(out)
    return out["float32_100k"]["launches"], big


def phase_cli(torch):
    """The CLI as a user starts it, in a subprocess on the card: a gated
    100k pair written as xyz files, exported cloud read back."""
    import numpy as np

    from simpleicp_tpu_torch.utils.xyz_io import read_xyz, write_xyz

    X_fix, X_mov, t, _ = partial_pair(N_MAIN, SEED + 6)
    with tempfile.TemporaryDirectory() as d:
        f1, f2, out = (os.path.join(d, n) for n in ("fix.xyz", "mov.xyz", "out.xyz"))
        write_xyz(f1, X_fix, fmt="%.6f")
        write_xyz(f2, X_mov, fmt="%.6f")
        env = {**os.environ,
               "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
        cmd = [sys.executable, "-m", "simpleicp_tpu_torch", "-f", f1, "-m", f2,
               "-o", str(GATE_RADIUS), "--export", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        check(proc.returncode == 0, f"CLI exited {proc.returncode}: {log[-3000:]}")
        for line in ("orig:0", "Convergence criteria fulfilled -> stop iteration!",
                     "Finished in "):
            check(line in log, f"CLI output lacks {line!r}")
        X_out = read_xyz(out)
        X_in = read_xyz(f2)
    check(X_out.shape == (N_MAIN, 3) and bool(np.isfinite(X_out).all()),
          f"exported cloud has shape {X_out.shape} or is not finite")
    # The exported cloud is the movable cloud moved back: compare with the
    # known motion at every point (three decimals in the file).
    R, tt = known_motion()
    err = float(np.abs(X_out - (X_in @ R.T + tt)).max())
    check(err < 5e-3, f"exported cloud is {err} from the known motion")
    finished = [ln for ln in log.splitlines() if ln.startswith("Finished in ")]
    emit({"phase": "cli", "command": "python3 -m simpleicp_tpu_torch -f fix.xyz "
          f"-m mov.xyz -o {GATE_RADIUS} --export out.xyz", "n_points": N_MAIN,
          "exit_code": proc.returncode, "wall_s": seconds,
          "finished_line": finished[-1] if finished else None,
          "export_max_abs_err": err})


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
    multiplications, 2 additions), plus 18 per ref for the fused transform.
    The 1-NN of the gate writes one (d2, index) pair per query, as k=1."""
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


def phase_times(torch, scale_clouds, gated_big, cells):
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
        # the gate: every fixed point against the movable cloud
        b, by = bound_ms("nn_search", N_MAIN, N_MAIN, size)
        row["nn_search"] = {
            "ms": cuda_ms(torch, lambda: knn.nn_search(Xf, Xm), 10),
            "plain_ms": cuda_ms(torch, lambda: knn.nn_search_plain(Xf, Xm), 2),
            "bound_ms": b, "bound_by": by, "library_ms": None,
        }
        kernels[tag] = row
    emit({"phase": "times", "what": f"kernels at 1000 x {N_MAIN} (k=10), the gate "
          f"at {N_MAIN} x {N_MAIN}; warm L2", "kernels": kernels})

    if gated_big is not None:
        Xf = torch.as_tensor(gated_big[0], dtype=torch.float32, device=dev)
        Xm = torch.as_tensor(gated_big[1], dtype=torch.float32, device=dev)
        b, by = bound_ms("nn_search", N_GATE_BIG, N_GATE_BIG, 4)
        emit({"phase": "times", "what": f"gate kernel at {N_GATE_BIG} x {N_GATE_BIG}, "
              "float32", "nn_search": {"ms": cuda_ms(torch, lambda: knn.nn_search(Xf, Xm), 3),
                                       "bound_ms": b, "bound_by": by}})

    reg = {}
    clouds = {"100k": (X_fix, X_mov, None, 5)}
    if scale_clouds is not None:
        clouds["1.34M"] = (*scale_clouds, None, 3)
    if "gated" in cells:
        G = partial_pair(N_MAIN, SEED + 3)
        clouds["gated 100k"] = (G[0], G[1], GATE_RADIUS, 5)
    if gated_big is not None:
        clouds["gated 1M"] = (gated_big[0], gated_big[1], GATE_RADIUS, 3)
    for label, (A, B, gate, reps) in clouds.items():
        Af = torch.as_tensor(A, dtype=torch.float32, device=dev)
        Bf = torch.as_tensor(B, dtype=torch.float32, device=dev)
        _register(torch, Af, Bf, torch.float32, "cuda", gate)  # warm-up
        times, reads, iters = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(reps):
            torch.cuda.synchronize()
            sync.reset_host_reads()
            t0 = time.perf_counter()
            res, _ = _register(torch, Af, Bf, torch.float32, "cuda", gate)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            reads.append(sync.host_reads())
            iters.append(int(res.n_iterations))
        reg[label] = {"median_s": statistics.median(times), "runs_s": times,
                      "n_iterations": iters, "host_reads": reads,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "gate_radius": gate,
                      "input": "float32 tensors already on the card"}
    emit({"phase": "times", "what": "icp_register, default config (gated: "
          f"max_overlap_distance={GATE_RADIUS}), float32", "registration": reg})
    return kernels["float32"]


# Device-kernel names of each port kernel's two passes (no name is a
# substring of another).
KERNEL_NAMES = {"match_transform_scan": "match_transform", "nn_reduce": "match_transform",
                "knn_scan": "knn_search", "knn_merge": "knn_search",
                "nn_search_scan": "nn_search", "nn_search_reduce": "nn_search"}


def phase_profile(torch, scale_clouds, gated_big, cells):
    """Where the time of one float32 registration goes: host wall time,
    the device's busy time (sum of kernel durations; one stream, so they
    do not overlap) and idle share, the number of kernel launches, and the
    device time of the port's kernels against everything else."""
    from torch.profiler import ProfilerActivity, profile

    from simpleicp_tpu_torch.utils import sync

    dev = torch.device("cuda")
    X_fix, X_mov, _ = cloud_pair(N_MAIN, SEED + 1)
    clouds = {"100k": (X_fix, X_mov, None)}
    if scale_clouds is not None:
        clouds["1.34M"] = (*scale_clouds, None)
    if "gated" in cells:
        G = partial_pair(N_MAIN, SEED + 3)
        clouds["gated 100k"] = (G[0], G[1], GATE_RADIUS)
    if gated_big is not None:
        clouds["gated 1M"] = (gated_big[0], gated_big[1], GATE_RADIUS)
    out = {}
    for label, (A, B, gate) in clouds.items():
        Af = torch.as_tensor(A, dtype=torch.float32, device=dev)
        Bf = torch.as_tensor(B, dtype=torch.float32, device=dev)
        _register(torch, Af, Bf, torch.float32, "cuda", gate)  # warm-up
        torch.cuda.synchronize()
        sync.reset_host_reads()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res, _ = _register(torch, Af, Bf, torch.float32, "cuda", gate)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name, port = {}, {name: 0.0 for name in KERNELS}
        for e in kernels:
            short = next((k for k in KERNEL_NAMES if k in e.name), e.name[:70])
            ms = e.time_range.elapsed_us() / 1e3
            tot, cnt = by_name.get(short, (0.0, 0))
            by_name[short] = (tot + ms, cnt + 1)
            if short in KERNEL_NAMES:
                port[KERNEL_NAMES[short]] += ms
        busy_ms = sum(v[0] for v in by_name.values())
        check(busy_ms > 0, f"profile {label}: no device time was traced")
        if gate is not None:
            check(port["nn_search"] > 0, f"profile {label}: no gate kernel traced")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        out[label] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "kernel_launches": len(kernels), "host_reads": sync.host_reads(),
            "n_iterations": int(res.n_iterations),
            "port_kernels_ms": port,
            "top_device_ms": [[k, v[0], v[1]] for k, v in top],
        }
    emit({"phase": "profile", "what": "one float32 registration, default config "
          f"(gated: max_overlap_distance={GATE_RADIUS})", "cells": out})


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
    cmp = Compare(torch)
    if "kernels" in phases:
        phase_kernels(torch, cmp)
    main_info = phase_main(torch) if "main" in phases else None
    scale_clouds = phase_scale(torch, cmp) if "scale" in phases else None
    gated_launches, gated_big = (phase_gated(torch, cmp) if "gated" in phases
                                 else (None, None))
    errs = cmp.err if "kernels" in phases else None
    if "cli" in phases:
        phase_cli(torch)
    times = (phase_times(torch, scale_clouds, gated_big, phases)
             if "times" in phases else None)
    if "profile" in phases:
        phase_profile(torch, scale_clouds, gated_big, phases)

    if None not in (errs, main_info, gated_launches, times):
        # Launches of each kernel in the run of its path: the ungated main
        # path for the match and k-NN kernels, the gated path for the gate.
        launches = {**main_info[0], "nn_search": gated_launches["nn_search"]}
        emit({"kernels": [
            {"name": name, "route": "cuda", "source": SOURCE,
             "replaces": REPLACES[name], "launches": launches[name],
             "max_abs_err": errs[name], **times[name]}
            for name in KERNELS
        ]})
    check("jax" not in sys.modules, "JAX was imported during the run")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
