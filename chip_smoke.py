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
           no valid ref, a lattice of exact ties; the 1-NN in both modes
           (d2-only and index), also on ties across tiles, reference chunks
           and query blocks, a ragged query count, a tile minimum equal to
           the running best, NaN distances and refs by decreasing distance;
           the dilation up to the largest reach it takes (18). Tolerance:
           none, indices equal and d2 bit-equal;
  main     icp_register at 100 000 x 100 000 (default config): float32 on the
           card recovers the known motion; at 100 000 x 100 000 float64 on
           the card equals float64 on the CPU (plain versions) in
           iterations, selection, last matches and H (1e-9); the launch
           counts prove the match, the k-NN and the solve kernels ran;
  scale    icp_register at 1 340 000 x 1 340 000, float32, on the card; the
           match and k-NN kernels bit-equal to their plain versions on that
           run's selection and final H;
  gated    icp_register with the brute overlap gate on a partial-overlap pair (the
           fixed cloud over x in [-2, 2], the movable over [-1, 3], scaled
           at constant density): float32 at 100 000 x 100 000 recovers the
           motion and selects only points of the overlap, with one gate
           (1-NN kernel) launch; float64 on the card equals the CPU at
           20 000 x 20 000; float32 at 1 000 000 x 1 000 000 (gate_method
           "auto" resolves to the brute gate: 1e12 < 2^40 pairs), where the
           gate kernel (the 1-NN's d2-only mode, as the gate runs it) is
           bit-equal to its plain version on all 1M rows, and both modes on
           refs of exact ties; the launch counts name the mode that ran;
  dilate   the dilate overlap gate: a 1 200 000 x 1 200 000 float32 registration
           with gate_method "auto" (1.44e12 > 2^40 pairs, so it plans the
           dilate gate), whose mask, selection, iterations and H equal the
           brute gate's, with the dilate kernel bit-equal to its plain
           version on that pair's own grid; the gate alone at 10M x 10M
           (mask equal to the brute 1-NN mask over 1e14 pairs); a 200 000
           pair with the thresholds lowered so that the band-ref compaction
           and the blocked slab join run, masks equal to brute;
  grid     the grid engines (ops/gridhash.py, PyTorch operations), float32:
           (a) C=100 000 against a 12.5M-point cloud, match_radius 0.05,
           near-aligned (the JAX package's grid_tight_radius config):
           "auto" resolves to the grid matcher; the same iterations as the
           brute matcher (the match kernel at 1.25e12 pairs a call), H
           within 1e-6, both recovering the motion to 2e-3; the share of
           differing last matches, wall times (medians of 3 in turns),
           the grid build and cap, ms per iteration of each matcher,
           launches, host reads, device busy (torch.profiler); the k-NN
           kernel bit-equal to its plain version at 100 000 x 12.5M on
           1024 sampled rows; (b) gate_method "grid" on the dilate 1.2M
           pair, every result field equal to the dilate-gated run's, and
           the grid gate alone at 10M x 10M, mask equal to the dilate
           gate's; (c) select_in_range at 1.5M x 1.5M (2.25e12 > 2^41
           pairs, the grid cell list) keeps the brute 1-NN's set; (d)
           float64 grid matcher (C=2000, radius 0.1) and grid gate at 20k:
           the card equals the CPU in iterations, selection and last
           matches, H within 1e-9;
  chunked  chunked dispatch, float32, every run equal in every result field
           and its last matches to the same registration run monolithically:
           100k (default config) at K = 1, 3 and max_iterations, the gated
           100k pair and the dilate 1.2M pair at K = 2, with launches and
           host reads against the monolithic run; big-C (the grid phase's
           C=100 000 x 12.5M pair) under a program_budget_s computed from
           the ported card rates so that the planner chooses chunked
           dispatch, query blocks and the grid k-NN cascade, K = 1: the plan,
           the cascade's radii, cap and rows certified, regridded and
           patched, its normals bit-equal to the dense k-NN's and timed
           against it (CUDA events, medians of 3 in turns), the wall time
           against the monolithic run (medians of 3); prepare_fixed at
           big-C under that budget equal to the dense preparation;
  policy   the rates of utils/device_policy.py measured again (the card's
           sweep, k-NN, gather and sort rates at 100 000 x 5M, the host
           CPU's plain 1-NN, k-NN and match at 2000 x 200 000, the card's
           one-time cost in a fresh process), each constant within a factor
           of 2 of its measurement; the CLI with --device auto routing a
           5 000-point pair to the CPU and a 1M pair to the card;
  cli      python3 -m simpleicp_tpu_torch as a subprocess on the card: a
           gated 100 000-point xyz pair, its lines and its exported cloud;
           the dilate 1.2M pair written at the CLI's default %.3f with the
           port's writer, -o 0.1 --export (gate_method "auto" plans the
           dilate gate: the dilation, the band's d2-only 1-NN, the k-NN
           and the match all launch, counted in the CLI's process), to
           convergence, the export within 5e-3 of the known motion, and the
           CLI's timing lines (parse, register, write); then read_xyz
           against read_xyz_plain and write_xyz against write_xyz_plain on
           that 1.2M file (in turns: plain, native, native, plain),
           bit-equal arrays and byte-equal files;
  install  the installed program: a wheel of the checkout (pip, from a copy
           of the tree, no network) installed into a fresh venv; its
           simpleicp-tpu-torch console script, started from outside the
           checkout with no checkout on its path, on the cli phase's dilate
           1.2M pair: it imports the installed package, builds libknn,
           libdilate, libsolver and libnative from the installed sources
           into the installed package's empty _build/, launches all five
           kernels, and exports a file byte-equal to the checkout CLI's; the wheel
           build, install, wall, build and timing-line seconds;
  serve    the serving path, float32 on the card: prepare_fixed once on a
           1.34M fixed cloud and 4 movable clouds (each under its own rigid
           motion from the seed) registered against it, prepared and
           self-contained, bit-equal (every result field and the last
           matches), at C=1000 and at C=100 000; the preparation through an
           npz file and back; the coarse-to-fine warm start against a cold
           start at C=100 000 on the 1.34M pair, and gated on the dilate
           1.2M pair (a brute-gated coarse pass, a dilate-gated full pass);
           wall times (medians of 3), the preparation's time, launches of
           each kernel (a prepared registration launches no k-NN), all
           launches (torch.profiler) and host reads;
  batch    icp_register_batch, float32 on the card: 100k pairs, each under
           its own rigid motion from the seed, in ungated batches of 8 and
           32 and a brute-gated batch of 8 (C=1000): every pair converged
           with its motion recovered to 2e-3; one launch of each kernel per
           batch call (the match once an iteration); the match, the k-NN
           and the d2-only 1-NN bit-equal to their plain versions and to
           their single-pair launches at each batch's own shapes (8 and
           32 x 1000 x 100k, 8 x 100k x 100k); float64 batches equal to each pair's own
           icp_register (iterations, error codes, selection, matches; H to
           1e-9); the batch's wall time against B sequential registrations
           (medians of 3, in turns), registrations per second, launches,
           host reads, and all launches and device busy time
           (torch.profiler) of the batch and of one of its registrations;
  sharded  the sharded registration (parallel/), float32 on the card, each
           run against icp_register on the card (iterations, error code,
           selection and last matches equal, H within 1e-6, 0 expected):
           world 1 in this process over NCCL (launch.run(1, ...)) on the
           1.34M pair, the gated 1M pair with the ring and the all-gather
           gate, the dilate 1.2M pair (gate "auto": rank 0 computes the
           dilate mask), the 1.34M map prepared (prepare_fixed, C=1000) and
           the gated 100k pair monolithic and chunked at K=2 (equal, with
           the same host reads); world 2 as two processes sharing the card
           (initialize_multihost over gloo, which stages every collective
           through host memory) on the 1.34M pair, the gated 1M pair (ring)
           and the gated 100k pair with the grid gate and the grid matcher,
           the two ranks bit-equal. Wall times (medians of 3) beside the
           single-card run's, per rank kernel launches (the match, k-NN and
           d2-only 1-NN on every rank, the dilation on rank 0), host reads,
           collectives by kind and per iteration, staged bytes. World 2
           shares one card: its times measure correctness and overhead, not
           scaling;
  times    kernel times (CUDA events, warm L2; the match and the k-NN as
           CUDA-graph replays, so that the wrappers' host work does not set
           the pace) beside their bounds and the plain versions' times; the
           match and the k-NN at 1000 x 100k (the k-NN at k=10, 32, 64 and
           under other chunk counts) and at the 1.34M cell's selection, the
           k-NN at 100k x 100k (every point a query, as estimate_normals
           calls it); the 1-NN in both modes at 100k x 100k, at
           the gated 1M pair and at the 1.2M band sweep's shape, its index
           mode's worst order, beside the unfused floor (9 issues a pair);
           the d2-only mode under its whole-wave chunk plan and under the
           uniform plan of the other kernels, and a block's fixed cost;
           the dilation; the dilate gate's stages
           at 1.2M and 10M; the slab join's cost model (pair rate,
           per-launch and host-sort costs); registration times; host reads;
           memory;
  profile  one registration of each cell under torch.profiler: device busy
           and idle share, kernel launches, device time by kernel; and one
           100k registration under utils.profiling.trace, whose Chrome
           trace must name the match and k-NN kernels.
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

PHASES = ("device", "build", "kernels", "main", "scale", "gated", "dilate",
          "grid", "chunked", "policy", "cli", "install", "serve", "batch", "sharded",
          "times", "profile")
KERNELS = ("match_transform", "knn_search", "nn_search", "dilate")
SOURCES = {
    "match_transform": "simpleicp_tpu_torch/csrc/knn.cu",
    "knn_search": "simpleicp_tpu_torch/csrc/knn.cu",
    "nn_search": "simpleicp_tpu_torch/csrc/knn.cu",
    "dilate": "simpleicp_tpu_torch/csrc/dilate.cu",
}
REPLACES = {
    "match_transform": "simpleicp_tpu/ops/knn_pallas.py:197",
    "knn_search": "simpleicp_tpu/ops/knn_pallas.py:69",
    "nn_search": "simpleicp_tpu/ops/knn_pallas.py:41",
    "dilate": "simpleicp_tpu/ops/dilate_pallas.py:154",
}
# Surface-sample sizes: the main path at the 100k scale of the repo's
# default registrations, and the 1.34M airborne scale; the gated cells at
# 100k and at 1M x 1M, the largest size whose gate "auto" sends to the
# brute 1-NN; the float64 card-versus-CPU check of the gate at 20k (a CPU
# brute gate at 100k takes minutes).
N_MAIN = 100_000
# The float64 card-versus-CPU check of the main path, at the main path's
# size. Float64 does not meet the relative criterion on these independent
# samples, so both runs take 100 iterations: ~200 s of plain float64 on the
# host of an H100 80GB HBM3 machine, and the whole script ~680 s of its
# 1200 s limit with it (the card's runs take a solve kernel launch an
# iteration, not ~1 500 launches).
N_MAIN_F64 = 100_000
N_SCALE = 1_340_000
N_GATE_BIG = 1_000_000
N_GATE_F64 = 20_000
# The dilate gate: a 1.2M x 1.2M pair (1.44e12 pairs, above the 2^40 where
# "auto" plans the dilate gate: an airborne or tiled-scan registration with
# -o R), the gate alone at 10M x 10M, the scale it exists for, and a 200k
# pair on which the band-ref compaction and the slab join are forced.
N_DILATE = 1_200_000
N_DILATE_BIG = 10_000_000
N_DILATE_FORCED = 200_000
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

    return rotation(np.array([0.02, -0.015, 0.03])), np.array([0.05, -0.04, 0.03])


def rotation(a):
    """The rotation of the three parameter angles a (rbp_to_H's order)."""
    import numpy as np

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
    return R


def cloud_pair(n, seed, area_scale=1.0, motion=None):
    """Fixed cloud and an independent sample of the same surface moved by
    ``motion`` ((R, t), by default the known motion); area_scale widens the
    domain at constant density."""
    import numpy as np

    rng = np.random.default_rng(seed)
    half = 2.0 * math.sqrt(area_scale)
    R, t = motion or known_motion()
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


def ptxas_table(log):
    """Per entry function of one nvcc -Xptxas -v log: registers, stack
    frame and spill bytes, names demangled by c++filt where it exists."""
    import re

    table, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            current = m.group(1)
            table.setdefault(current, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and current:
            table[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                  spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and current:
            table[current]["registers"] = int(m.group(1))
    names = list(table)
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) != len(names):
            out = names
    except (OSError, subprocess.SubprocessError):
        out = names
    short = (re.sub(r"\(.*", "", d.replace("(anonymous namespace)::", "")).replace("void ", "")
             for d in out)
    return {sn: table[n] for n, sn in zip(names, short)}


def sass_hot_loops(lib_path):
    """Per 1-NN and match scan kernel of a built library (cuobjdump -sass,
    where the toolkit has it): the opcode counts of its hot loop, the
    loop (a backward branch) that holds the most floating-point adds, and
    its adds, so that instructions per pair = instructions / (adds / 5)
    (each pair: three subtractions and two additions). The k-NN's scan is
    left out: its step loop holds the insertion path inline, so a static
    count is not what a step issues. None without cuobjdump."""
    import collections
    import re
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        if not any(w in name for w in ("match_scan", "nn1_scan")):
            continue
        ops, addr_at, label_at, targets = [], {}, {}, []
        for ln in part.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", ln)
            if m:
                label_at[m.group(1)] = len(ops)
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
            if not m:
                continue
            addr_at[int(m.group(1), 16)] = len(ops)
            words = [w for w in m.group(2).split() if not w.startswith("@")]
            op = words[0].split(".")[0] if words else "?"
            t = re.search(r"`\((\.L_x_\d+)\)", m.group(2)) or re.search(r"\b0x([0-9a-f]+)", m.group(2))
            ops.append(op)
            targets.append(t.group(1) if t and op == "BRA" else None)
        loops = []
        for i, t in enumerate(targets):
            j = label_at.get(t) if t and t.startswith(".L") else (
                addr_at.get(int(t, 16)) if t else None)
            if j is not None and j <= i:
                body = ops[j:i + 1]
                adds = sum(o in ("FADD", "DADD") for o in body)
                loops.append((adds, -len(body), body))
        if not loops:
            continue
        adds, _, body = max(loops)
        out[name] = {"instructions": len(body), "fp_adds": adds,
                     "per_pair": len(body) / (adds / 5) if adds else None,
                     "opcodes": dict(collections.Counter(body).most_common())}
    names = list(out)
    try:
        dem = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        dem = names
    if len(dem) != len(names):
        dem = names
    return {re.sub(r"\(.*", "", d.replace("(anonymous namespace)::", "")).replace("void ", ""):
            out[n] for n, d in zip(names, dem)}


def phase_build():
    from simpleicp_tpu_torch import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_table(_build.BUILD_LOGS.get(name, "")) for name in paths}
    # every nearest-neighbour kernel keeps its lists and queries in
    # registers: no stack frame, no spills; the Gauss-Newton kernel keeps
    # its running sums and its 6 x 6 system in registers: no spills (its
    # 40-byte stack frame is float64 sin/cos's argument reduction for huge
    # angles, which CUDA's math library keeps in local memory)
    for lib, keys in (("knn", ("stack", "spill_stores", "spill_loads")),
                      ("solver", ("spill_stores", "spill_loads"))):
        bad = {f: v for f, v in ptxas.get(lib, {}).items() if any(v.get(k, 0) for k in keys)}
        check(bool(ptxas.get(lib)), f"no -Xptxas -v lines for {lib}.cu")
        check(not bad, f"{lib}.cu kernels with {' or '.join(keys)}: {bad}")
    emit({"phase": "build", "seconds": seconds, "sources": sorted(paths),
          "ptxas": ptxas, "sass_hot_loops": sass_hot_loops(paths["knn"])})


class Compare:
    """Kernel-versus-plain comparisons; max abs error per kernel (d2 for
    the nearest-neighbour kernels, word value for the dilate kernel)."""

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

    def nn_modes(self, case, q, r, mask=None, ref_mask="same"):
        """The 1-NN kernel in its index mode (nn_search) and its d2-only
        mode (min_dist_sq), each against the plain version under
        ``ref_mask`` (by default the kernel's mask)."""
        from simpleicp_tpu_torch.ops import knn

        ref_mask = mask if isinstance(ref_mask, str) else ref_mask
        self.run("nn_search", f"{case}, index mode",
                 lambda: knn.nn_search(q, r, ref_mask=mask),
                 lambda: knn.nn_search_plain(q, r, ref_mask))
        self.run("nn_search", f"{case}, d2-only mode",
                 lambda: (knn.min_dist_sq(q, r, ref_mask=mask), None),
                 lambda: knn.nn_search_plain(q, r, ref_mask))

    def since(self, n):
        """The cases recorded after the first n."""
        return self.cases[n:]

    def record(self, kernel, case, d_k, i_k, d_p, i_p):
        torch = self.torch
        same_i = True if i_k is None else torch.equal(i_k, i_p)  # d2-only: no index
        same_d = torch.equal(d_k, d_p)
        fin = torch.isfinite(d_p)
        err = float((d_k[fin] - d_p[fin]).abs().max()) if bool(fin.any()) else 0.0
        self.err[kernel] = max(self.err[kernel], err)
        self.cases.append({"kernel": kernel, "case": case,
                           "idx_equal": None if i_k is None else same_i,
                           "d2_bit_equal": same_d, "max_abs_err": err})
        check(same_i and same_d,
              f"{kernel} {case}: kernel and plain version differ "
              f"(idx equal {same_i}, d2 bit-equal {same_d}, err {err})")

    def grids(self, case, occ, stencils):
        """The dilate kernel, then its plain version, on one grid: the
        number of differing words must be 0."""
        from simpleicp_tpu_torch.ops.dilate_gate import (
            dilate_packed_multi,
            dilate_packed_multi_plain,
        )

        torch = self.torch
        got = dilate_packed_multi(occ, stencils)
        torch.cuda.synchronize()
        want = dilate_packed_multi_plain(occ, stencils)
        torch.cuda.synchronize()
        differ, err = 0, 0.0
        for g, w in zip(got, want):
            ne = g != w
            differ += int(ne.sum())
            if bool(ne.any()):
                u = (g[ne].long() & 0xFFFFFFFF) - (w[ne].long() & 0xFFFFFFFF)
                err = max(err, float(u.abs().max()))
        self.err["dilate"] = max(self.err["dilate"], err)
        self.cases.append({"kernel": "dilate", "case": case,
                           "grid": list(occ.shape), "entries": [len(st) for st in stencils],
                           "differing_words": differ, "max_abs_err": err})
        check(differ == 0, f"dilate {case}: {differ} words differ from the plain version")
        return got


def random_rigid(torch, rng, dtype, dev):
    from simpleicp_tpu_torch.ops.transform import rbp_to_H

    p = rng.uniform([-0.2, -0.2, -0.2, -1, -1, -1], [0.2, 0.2, 0.2, 1, 1, 1])
    return rbp_to_H(torch.tensor(p, dtype=dtype, device=dev))


def sliced(fn, limit):
    """fn() with the 1-NN wrappers' queries per launch lowered to `limit`,
    so that they launch once per slice of that many queries."""
    from simpleicp_tpu_torch.ops import knn_cuda

    saved = knn_cuda._NN_MAX_QUERIES
    knn_cuda._NN_MAX_QUERIES = limit
    try:
        return fn()
    finally:
        knn_cuda._NN_MAX_QUERIES = saved


def nn_edge_cases(torch, T, rng):
    """(case, queries, refs, kernel mask, reference mask) of the 1-NN's
    ties and edges. A NaN distance never wins in the kernel, where the
    plain argmin takes the first NaN, so for refs with NaN coordinates the
    reference is the plain version with those refs masked."""
    import numpy as np

    dev = "cuda"
    g = np.arange(10.0)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    # 2 500 queries (three blocks of 1 024 queries, the last ragged) against
    # 40 copies of the lattice: every answer an exact tie across sub-tiles,
    # tiles and reference chunks
    lq = T(lat[rng.choice(len(lat), 2500)] + 0.5 * rng.integers(0, 2, (2500, 3)))
    lr = T(np.concatenate([lat] * 40))
    m = torch.as_tensor(rng.random(len(lr)) < 0.5, device=dev)
    out = [("ties across tiles, chunks and query blocks, 2500x40000", lq, lr, None, None),
           ("the same ties, masked", lq, lr, m, m)]
    # one query's nearest ref at the start of every 512-ref tile: each later
    # tile's minimum equals the running best and must keep the first index
    q = T(rng.uniform(0, 1, (1500, 3)))
    r = rng.uniform(5, 6, (8192, 3))
    r[::512] = np.asarray(q[0].cpu())
    out.append(("a tile minimum equal to the running best", q, T(r), None, None))
    none = torch.zeros(8192, dtype=torch.bool, device=dev)
    out.append(("all refs masked", q, T(r), none, none))
    rn = rng.uniform(0, 1, (5000, 3))
    rn[1024:2048] = np.nan
    rn[3000, 1] = np.nan
    rn = T(rn)
    finite = ~torch.isnan(rn).any(1)
    out.append(("a tile of NaN distances (reference: NaN refs masked)", q, rn, None, finite))
    out.append(("a tile of NaN distances, masked", q, rn, finite, finite))
    r = rng.uniform(-1, 1, (20000, 3))
    out.append(("refs by decreasing distance (every sub-tile improves)",
                T(rng.uniform(-0.1, 0.1, (3000, 3))),
                T(r[np.argsort(-(r ** 2).sum(1))]), None, None))
    return out


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
        for k in (10, 32, 33, 40, 64):
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

        # the 1-NN of the overlap gate, both modes: every fixed point a query
        cmp.nn_modes(f"{tag} gate {N_MAIN}x{N_MAIN}", Xf, Xm)
        for nq, nr in ((1, 1), (7, 130), (512, 2048), (4099, 3001)):
            q = T(rng.uniform(0, 1, (nq, 3)))
            r = T(rng.uniform(0, 1, (nr, 3)))
            cmp.nn_modes(f"{tag} odd {nq}x{nr}", q, r)
        q = T(rng.uniform(0, 1, (20_000, 3)))
        r = T(rng.uniform(0, 1, (30_000, 3)))
        mask = torch.as_tensor(rng.random(30_000) < 0.3, device=dev)
        cmp.nn_modes(f"{tag} masked 20000x30000", q, r, mask)
        run("nn_search", f"{tag} masked 20000x30000 in 5 launches of <= 4096 queries",
            lambda: sliced(lambda: knn.nn_search(q, r, ref_mask=mask), 4096),
            lambda: knn.nn_search_plain(q, r, ref_mask=mask))
        run("nn_search", f"{tag} the same, d2-only mode",
            lambda: (sliced(lambda: knn.min_dist_sq(q, r, ref_mask=mask), 4096), None),
            lambda: knn.nn_search_plain(q, r, ref_mask=mask))
        none = torch.zeros(30_000, dtype=torch.bool, device=dev)
        cmp.nn_modes(f"{tag} no valid ref", q, r, none)
        d_none, i_none = knn.nn_search(q, r, ref_mask=none)
        check(bool(torch.isinf(d_none).all()) and not bool(i_none.any())
              and bool(torch.isinf(knn.min_dist_sq(q, r, ref_mask=none)).all()),
              "nn_search without a valid ref: expected +inf and index 0")
        lat_mask = torch.as_tensor(rng.random(len(lattice)) < 0.5, device=dev)
        cmp.nn_modes(f"{tag} tie lattice 300x{len(lattice)}", lq, lr)
        cmp.nn_modes(f"{tag} tie lattice, masked", lq, lr, lat_mask)
        for case, q, r, m, ref_m in nn_edge_cases(torch, T, rng):
            cmp.nn_modes(f"{tag} {case}", q, r, m, ref_m)
    kernels_dilate(torch, cmp)
    emit({"phase": "kernels", "tolerance": "indices equal, d2 bit-equal; "
          "dilate: 0 differing words", "cases": cmp.since(n0), "max_abs_err": cmp.err})


def kernels_dilate(torch, cmp):
    """The dilate kernel against its plain version: the CPU tests' cases
    (synthetic stencils, one stencil, an empty one, carries across words,
    an unstructured stencil), a grid with every bit set, and the real
    stencils of plans at cell_div 16, 8, 4 and 2."""
    import numpy as np

    from simpleicp_tpu_torch.ops.dilate_gate import _pack_occupancy_device, plan_dilate_gate

    rng = np.random.default_rng(SEED + 20)

    def T(words):
        return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to("cuda")

    def occ(wz, nx, ny, density=0.02):
        words = rng.random((wz, nx, ny)) < density
        return np.where(words, rng.integers(0, 2**32, (wz, nx, ny), dtype=np.uint32),
                        np.uint32(0))

    a = tuple((dx, dy, 4 - max(abs(dx), abs(dy)))
              for dx in range(-2, 3) for dy in range(-2, 3))
    b = ((0, 0, 3), (1, -1, 0), (-2, 0, 1))
    for shape in ((2, 40, 48), (3, 17, 33), (1, 64, 130), (9, 300, 257)):
        cmp.grids(f"synthetic {shape}", T(occ(*shape)), [a, b])
    cmp.grids("one stencil", T(occ(3, 70, 45)), [b])
    cmp.grids("an empty stencil", T(occ(2, 20, 20)), [(), a])
    carry = np.zeros((3, 9, 10), np.uint32)
    carry[0, 0, 0] = carry[2, 8, 9] = 1 | (1 << 31)
    carry[1, 4, 5], carry[2, 4, 5], carry[0, 8, 0] = 1 << 31, 1, 1 << 31
    for z in (1, 17, 31):
        cmp.grids(f"carries z={z}", T(carry), [((0, 0, z), (1, 0, 0), (0, -1, 0)),
                                               ((0, 0, z), (-1, 1, z // 2))])
    odd = tuple((int(dx), int(dy), int(z)) for dx, dy, z in
                zip(rng.integers(-6, 7, 40), rng.integers(-6, 7, 40), rng.integers(0, 32, 40)))
    cmp.grids("unstructured stencil", T(occ(4, 50, 61, 0.05)), [odd, odd[:7]])
    cmp.grids("every bit set", T(np.full((3, 100, 90), 0xFFFFFFFF, np.uint32)), [a, b])
    pts = torch.as_tensor(rng.random((20_000, 3)) * np.array([8.0, 6.0, 4.0]),
                          dtype=torch.float32, device="cuda")
    for div in (16, 8, 4, 2):
        plan = plan_dilate_gate(None, pts.cpu().numpy(), 1.0, cell_div=div)
        words = _pack_occupancy_device(pts, plan=plan).reshape(plan.wz, *plan.dims[:2])
        cmp.grids(f"plan cell_div {div}", words, [plan.in_offsets, plan.poss_offsets])
        full = torch.full_like(words, -1)
        cmp.grids(f"plan cell_div {div}, every bit set", full,
                  [plan.in_offsets, plan.poss_offsets])
    # the largest reach the kernel takes (every plan of the gate: at most 17)
    wide = tuple((int(dx), int(dy), int(z)) for dx, dy, z in
                 zip(rng.integers(-18, 19, 60), rng.integers(-18, 19, 60),
                     rng.integers(0, 32, 60))) + ((18, -18, 3), (-18, 18, 0))
    cmp.grids("reach 18", T(occ(5, 300, 100, 0.01)), [wide, wide[:11]])


def _register(torch, X_fix, X_mov, dtype, device, gate=None, method="auto"):
    """icp_register with the default config, or with the overlap gate of
    radius ``gate`` and gate_method ``method``; returns (result, final loop
    state)."""
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models.icp import _icp_register

    cfg = (IcpConfig() if gate is None
           else IcpConfig(max_overlap_distance=gate, gate_method=method))
    return _icp_register(
        X_fix, X_mov, cfg, rbp_observed_values=None,
        rbp_observation_weights=None, normals_fix=None, planarity_fix=None,
        planarity_mov=None, fixed_prep=None, device=device, dtype=dtype,
    )


def reset_counts():
    from simpleicp_tpu_torch.ops import dilate_cuda, knn_cuda, solver_cuda

    knn_cuda.reset_launch_counts()
    dilate_cuda.reset_launch_counts()
    solver_cuda.reset_launch_counts()


def read_counts():
    from simpleicp_tpu_torch.ops import dilate_cuda, knn_cuda

    return {**knn_cuda.LAUNCHES, **dilate_cuda.LAUNCHES}


def timed(torch, fn):
    """fn() with every count set to 0 just before and read just after:
    (its result, seconds ending in a synchronize, launches, host reads)."""
    from simpleicp_tpu_torch.utils import sync

    torch.cuda.synchronize()
    reset_counts()
    sync.reset_host_reads()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts(), sync.host_reads()


def timed_runs(torch, fns, reps):
    """Each fn of ``fns`` (label -> fn) ``reps`` times through ``timed``, in
    turns. Returns per label the median wall time, each run's seconds and
    host reads and the kernel launches of its last run; and per label the
    results of its runs."""
    rows = {label: {"runs_s": [], "host_reads": []} for label in fns}
    results = {label: [] for label in fns}
    for _ in range(reps):
        for label, fn in fns.items():
            out, seconds, launches, reads = timed(torch, fn)
            results[label].append(out)
            rows[label]["runs_s"].append(seconds)
            rows[label]["host_reads"].append(reads)
            rows[label]["launches"] = launches
    for row in rows.values():
        row["median_s"] = statistics.median(row["runs_s"])
    return rows, results


def traced(torch, fn):
    """One fn() under torch.profiler: its result, the host wall ms ending
    in a synchronize, and the device events (kernels, copies and fills)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, wall_ms, events


def counted_run(torch, X_fix, X_mov, dtype, gate=None, gate_launches=None):
    """One registration on the card with every count set to 0 just before
    and read just after: one k-NN launch, one match launch and one
    Gauss-Newton solve launch per iteration, one uncertainty launch, and the
    gate's launches
    (``gate_launches``; by default one 1-NN launch in the d2-only mode when
    gated, none otherwise; never the index mode)."""
    from simpleicp_tpu_torch.ops import solver_cuda

    (res, carry), seconds, launches, reads = timed(
        torch, lambda: _register(torch, X_fix, X_mov, dtype, "cuda", gate))
    n_it = int(res.n_iterations)
    check(solver_cuda.LAUNCHES["gn_solve"] == n_it,
          f"solve kernel launches {solver_cuda.LAUNCHES['gn_solve']}, expected {n_it}")
    check(solver_cuda.LAUNCHES["uncertainties"] == 1,
          f"uncertainty kernel launches {solver_cuda.LAUNCHES['uncertainties']}, expected 1")
    if gate_launches is None:
        gate_launches = {"nn_search": 0, "nn_search_d2": 0 if gate is None else 1,
                         "dilate": 0}
    want = {"match_transform": n_it, "knn_search": 1, **gate_launches}
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

    A, B, t64 = cloud_pair(N_MAIN_F64, SEED + 1, N_MAIN_F64 / N_MAIN)
    res_g, carry_g, launches_g, _, card_s = counted_run(torch, A, B, torch.float64)
    t0 = time.perf_counter()
    res_c, carry_c = _register(torch, A, B, torch.float64, "cpu")
    cpu_s = time.perf_counter() - t0
    n_g, n_c = int(res_g.n_iterations), int(res_c.n_iterations)
    check(n_g == n_c, f"float64 iterations: card {n_g}, CPU {n_c}")
    check(torch.equal(res_g.sel_idx.cpu(), res_c.sel_idx), "float64 sel_idx differ")
    check(torch.equal(carry_g.m_idx.cpu(), carry_c.m_idx), "float64 last m_idx differ")
    dH = float((res_g.H.cpu() - res_c.H).abs().max())
    check(dH <= 1e-9, f"float64 H differs by {dH} > 1e-9")
    err_g = check_recovery(res_g, t64, f"float64 {N_MAIN_F64} card", converge=False)
    out["float64_card_vs_cpu"] = {
        "n_fix": N_MAIN_F64, "n_mov": N_MAIN_F64, "n_iterations": n_g, "converged": bool(res_g.converged),
        "translation_err": err_g, "sel_idx_equal": True,
        "last_m_idx_equal": True, "H_max_abs_diff": dH,
        "launches": launches_g, "card_run_s": card_s, "cpu_run_s": cpu_s,
    }
    emit(out)
    return launches, int(res.n_iterations), reads


def phase_scale(torch, cmp):
    """icp_register at 1.34M; then the match and k-NN kernels against their
    plain versions on that run's inputs: its C selected fixed points against
    the whole movable cloud under its final H, and against the fixed cloud.
    Returns the clouds and the selection."""
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
    return X_fix, X_mov, res.sel_idx.cpu().numpy()


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
    transform (identity), all rows, in the d2-only mode the gate runs;
    then, in both modes, against a reference cloud whose second half
    repeats its first, so that every answer is an exact tie across tiles
    and chunks far apart: all 1M winners must lie in the first copy, and a
    seeded sample of rows (the last block's rows among them) must equal the
    plain version. Each row's answer depends on no other row, so the plain
    version on a subset of queries is the reference for those rows."""
    import numpy as np

    from simpleicp_tpu_torch.ops import knn
    from simpleicp_tpu_torch.ops.transform import apply_H, rbp_to_H

    n0 = len(cmp.cases)
    Xf = torch.as_tensor(X_fix, dtype=torch.float32, device="cuda")
    Xm = torch.as_tensor(X_mov, dtype=torch.float32, device="cuda")
    Xm0 = apply_H(Xm, rbp_to_H(torch.zeros(6, dtype=torch.float32, device="cuda")))
    n_f, n_m = Xf.shape[0], Xm0.shape[0]
    cmp.run("nn_search", f"float32 gate {n_f}x{n_m}, all rows, d2-only mode",
            lambda: (knn.min_dist_sq(Xf, Xm0), None), lambda: knn.nn_search_plain(Xf, Xm0))

    half = n_m // 2
    Xt = torch.cat([Xm0[:half], Xm0[:half]]).contiguous()
    d_k, i_k = knn.nn_search(Xf, Xt)
    d2_k = knn.min_dist_sq(Xf, Xt)
    torch.cuda.synchronize()
    check(int(i_k.max()) < half,
          f"gate ties {n_f}x{2 * half}: a winner lies in the second copy")
    rows = np.random.default_rng(SEED + 7).choice(n_f - 1024, 20_000, replace=False)
    rows = torch.as_tensor(np.concatenate([rows, np.arange(n_f - 1024, n_f)]),
                           device="cuda")
    d_p, i_p = knn.nn_search_plain(Xf[rows].contiguous(), Xt)
    torch.cuda.synchronize()
    cmp.record("nn_search", f"float32 gate ties {n_f}x{2 * half}, "
               f"{rows.shape[0]} rows, index mode", d_k[rows], i_k[rows], d_p, i_p)
    cmp.record("nn_search", f"float32 gate ties {n_f}x{2 * half}, "
               f"{rows.shape[0]} rows, d2-only mode", d2_k[rows], None, d_p, i_p)
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


def gate_inputs(torch, X_fix, X_mov):
    """The fixed cloud and the movable cloud under the initial transform
    (identity, as the registration applies it) on the card, float32."""
    from simpleicp_tpu_torch.ops.transform import apply_H, rbp_to_H

    Xf = torch.as_tensor(X_fix, dtype=torch.float32, device="cuda")
    Xm = torch.as_tensor(X_mov, dtype=torch.float32, device="cuda")
    return Xf, apply_H(Xm, rbp_to_H(torch.zeros(6, dtype=torch.float32, device="cuda")))


def plan_of(Xm0, radius=GATE_RADIUS):
    from simpleicp_tpu_torch.ops.dilate_gate import bbox_of, plan_dilate_gate

    lo, hi = bbox_of(Xm0).cpu().numpy()
    return plan_dilate_gate(None, None, radius, bbox=(lo, hi))


def plan_summary(plan, radius=GATE_RADIUS):
    return {"cell_div": round(radius * plan.inv_cell), "dims": list(plan.dims),
            "wz": plan.wz, "n_words": plan.n_words,
            "entries": [len(plan.in_offsets), len(plan.poss_offsets)],
            "z_rad_max": max(z for _, _, z in plan.poss_offsets)}


def gate_vs_brute(torch, Xf, Xm0, plan, what):
    """The dilate gate alone, with every count set to 0 just before and
    read just after, and the brute 1-NN mask on the same inputs: they must
    be equal bit for bit."""
    from simpleicp_tpu_torch.ops import knn
    from simpleicp_tpu_torch.ops.dilate_gate import overlap_mask_dilate

    torch.cuda.synchronize()
    reset_counts()
    stats = {}
    t0 = time.perf_counter()
    mask = overlap_mask_dilate(Xf, Xm0, GATE_RADIUS, plan, stats=stats)
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    launches = read_counts()
    t0 = time.perf_counter()
    d2, _ = knn.nn_search(Xf, Xm0)
    brute = d2 <= torch.tensor(GATE_RADIUS, dtype=Xf.dtype, device="cuda") ** 2
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    differ = int((mask != brute).sum())
    check(differ == 0, f"{what}: the dilate mask differs from the brute mask "
          f"at {differ} points")
    return {"n_fix": Xf.shape[0], "n_mov": Xm0.shape[0], "plan": plan_summary(plan),
            "branches": stats, "gate_launches": {k: v for k, v in launches.items() if v},
            "gate_s": gate_s, "brute_mask_s": brute_s, "kept": int(mask.sum()),
            "mask_differs_from_brute": differ}


def phase_dilate(torch, cmp):
    """The dilate gate: (a) a 1.2M x 1.2M registration with gate_method
    "auto", (b) the gate alone at 10M x 10M, (c) the band-ref compaction
    and the slab join forced at 200k; every mask against the brute one."""
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models import icp
    from simpleicp_tpu_torch.ops import dilate_gate as dg
    from simpleicp_tpu_torch.ops.dilate_gate import _pack_occupancy_device

    X_fix, X_mov, t, x0 = partial_pair(N_DILATE, SEED + 8, N_DILATE / N_MAIN)
    Xf, Xm0 = gate_inputs(torch, X_fix, X_mov)
    plan = plan_of(Xm0)
    cfg = icp._resolve_engines(IcpConfig(max_overlap_distance=GATE_RADIUS),
                               N_DILATE, N_DILATE)
    method, plan_r = icp._resolve_gate(cfg, N_DILATE, N_DILATE,
                                       lambda: dg.bbox_of(Xm0).cpu().numpy())
    check(method == "dilate" and plan_r == plan,
          f"gate_method 'auto' at {N_DILATE} x {N_DILATE} did not plan the dilate gate")
    alone = gate_vs_brute(torch, Xf, Xm0, plan, "dilate 1.2M")
    n0 = len(cmp.cases)
    occ = _pack_occupancy_device(Xm0, plan=plan).reshape(plan.wz, *plan.dims[:2])
    cmp.grids("the 1.2M pair's own grid", occ, [plan.in_offsets, plan.poss_offsets])
    cmp.grids("the 1.2M pair's own grid, POSS alone", occ, [plan.poss_offsets])
    del occ
    gl = {k: alone["gate_launches"].get(k, 0) for k in ("nn_search", "nn_search_d2", "dilate")}
    check(gl["nn_search"] == 0 and gl["nn_search_d2"] >= 1,
          f"dilate 1.2M: the band sweep did not run the d2-only mode alone ({gl})")
    torch.cuda.reset_peak_memory_stats()
    res, _, launches, reads, seconds = counted_run(torch, X_fix, X_mov, torch.float32,
                                                   GATE_RADIUS, gate_launches=gl)
    peak = torch.cuda.max_memory_allocated()
    res_b, _ = _register(torch, X_fix, X_mov, torch.float32, "cuda", GATE_RADIUS, "brute")
    for f in ("sel_idx", "sel_valid", "n_iterations", "H"):
        check(torch.equal(getattr(res, f), getattr(res_b, f)),
              f"dilate 1.2M: {f} differs from the brute-gated run")
    emit({"phase": "dilate", "part": "a", "radius": GATE_RADIUS, "float32_1.2M": {
        "resolved": "dilate", "gate_alone": alone, "n_iterations": int(res.n_iterations),
        "translation_err": check_recovery(res, t, "dilate 1.2M"),
        "selected_x_min": check_overlap(res, X_fix, x0, "dilate 1.2M"),
        "equals_brute_run": ["sel_idx", "sel_valid", "n_iterations", "H"],
        "launches": launches, "host_reads": reads, "first_run_s": seconds,
        "max_memory_allocated": peak, "kernel_vs_plain": cmp.since(n0)}})
    del Xf, Xm0

    A10, B10, _, _ = partial_pair(N_DILATE_BIG, SEED + 9, N_DILATE_BIG / N_MAIN)
    Xf, Xm0 = gate_inputs(torch, A10, B10)
    plan10 = plan_of(Xm0)
    check(plan10 is not None, "no dilate plan at 10M")
    torch.cuda.reset_peak_memory_stats()
    big = gate_vs_brute(torch, Xf, Xm0, plan10, "dilate 10M")
    big["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    n0 = len(cmp.cases)
    occ = _pack_occupancy_device(Xm0, plan=plan10).reshape(plan10.wz, *plan10.dims[:2])
    cmp.grids("the 10M pair's own grid", occ, [plan10.in_offsets, plan10.poss_offsets])
    big["kernel_vs_plain"] = cmp.since(n0)
    del Xf, Xm0, occ
    emit({"phase": "dilate", "part": "b", "float32_10M_gate": big})

    A, B, _, _ = partial_pair(N_DILATE_FORCED, SEED + 10, N_DILATE_FORCED / N_MAIN)
    Xf, Xm0 = gate_inputs(torch, A, B)
    planf = plan_of(Xm0)
    forced = {}
    for label, consts in (("compaction", {"_DIRECT_SWEEP_MAX": 0}),
                          ("slab join", {"_DIRECT_SWEEP_MAX": 0, "_SLAB_SWEEP_MIN": 0,
                                         "_SLAB_CHUNK_OPTS": (1024, 4096),
                                         "_SLAB1_MIN": 256})):
        saved = {k: getattr(dg, k) for k in consts}
        for k, v in consts.items():
            setattr(dg, k, v)
        try:
            forced[label] = gate_vs_brute(torch, Xf, Xm0, planf, f"dilate forced {label}")
        finally:
            for k, v in saved.items():
                setattr(dg, k, v)
        st = forced[label]["branches"]
        check(st["compaction"] and (label != "slab join" or
                                    (st["sweep"] == "slab join" and st["slab_blocks"] > 1)),
              f"forced {label}: the branch did not run ({st})")
    emit({"phase": "dilate", "part": "c", "float32_200k_forced": forced})
    return {"launches": launches, "clouds": (X_fix, X_mov), "clouds10M": (A10, B10),
            "brute_mask_10M_s": big["brute_mask_s"]}


# The grid engines. (a) The JAX package's big-C configuration
# (``grid_tight_radius`` of scripts/bench_bigc.py: C=100 000 against a
# 12.5M-point cloud, match_radius 0.05, the coarsely pre-aligned production
# scans of BENCHMARKS.md) on the wavy surface at the density of every other
# cloud here (12.5M points over 125 times the 100k cell's area), under the
# near alignment such scans arrive with; (b) the grid gate on the dilate
# cells' pairs; (c) select_in_range above 2^41 pairs; (d) float64 on the
# card against the CPU.
N_BIGC = 12_500_000
C_BIGC = 100_000
BIGC_RADIUS = 0.05
BIGC_T = (0.012, -0.008, 0.010)
BIGC_ANGLES = (1e-4, -1e-4, 2e-4)
N_SELECT = 1_500_000
BIGC_KNN_ROWS = 1024


def check_knn_rows(torch, cmp, Q, X, k, tag):
    """The k-NN kernel on all rows of Q against X; a seeded sample of
    BIGC_KNN_ROWS rows (the last 256 among them) held against the plain
    version, indices equal and d2 bit-equal. Returns (the cases, the
    kernel's ms and its bound at this shape)."""
    import numpy as np

    from simpleicp_tpu_torch.ops import knn

    n0 = len(cmp.cases)
    n_q = Q.shape[0]
    rows = np.random.default_rng(SEED + 13).choice(n_q - 256, BIGC_KNN_ROWS - 256,
                                                   replace=False)
    rows = torch.as_tensor(np.concatenate([rows, np.arange(n_q - 256, n_q)]), device=Q.device)
    d_k, i_k = knn.knn_search(Q, X, k)
    torch.cuda.synchronize()
    d_p, i_p = knn.knn_search_plain(Q[rows].contiguous(), X, k)
    torch.cuda.synchronize()
    cmp.record("knn_search", f"float32 {tag} {n_q}x{X.shape[0]}, {rows.shape[0]} rows, k={k}",
               d_k[rows], i_k[rows], d_p, i_p)
    b, by = bound_ms("knn_search", n_q, X.shape[0], 4, k=k)
    return cmp.since(n0), {"ms": cuda_ms(torch, lambda: knn.knn_search(Q, X, k), 2),
                           "bound_ms": b, "bound_by": by, "shape": [n_q, X.shape[0], k]}


def mean_occupancy(grid):
    """Points per occupied hash slot of a ``build_sorted_grid`` grid."""
    slots = grid[1]
    return slots.shape[0] / (int((slots[1:] != slots[:-1]).sum()) + 1)


def match_ms(torch, Q, Xm, cfg, H):
    """ms of one iteration's matcher (``_make_match_fn`` of the resolved
    ``cfg``, CUDA events over 5 calls) under the transform H, and for the
    grid matcher its one-time build (with its cap's count and host read)."""
    from simpleicp_tpu_torch.models import icp

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = icp._match_grid(Xm, cfg) if cfg.match_method == "grid" else None
    fn = icp._make_match_fn(Q[None], Xm[None], cfg, grid=grid)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    Ht = H[None].to(Q.dtype)
    return {"ms": cuda_ms(torch, lambda: fn(Ht), 5), "set_up_s": build_s}


def phase_grid(torch, cmp, dil=None):
    """The grid engines on the card, float32: (a) the big-C grid matcher
    against the brute matcher at C=100 000 x 12.5M, with the k-NN kernel
    held against its plain version at that shape; (b) the grid gate on the
    dilate 1.2M pair (a registration, against the dilate gate's) and alone
    at 10M x 10M (its mask against the dilate gate's); (c) select_in_range
    above 2^41 pairs against the brute mask; (d) float64 on the card
    against the CPU at 20k. Returns each kernel's launches in the
    grid-matched registration, and the big-C clouds on the card."""
    import dataclasses

    import numpy as np

    from simpleicp_tpu_torch import IcpConfig, PointCloud, api
    from simpleicp_tpu_torch.models import icp
    from simpleicp_tpu_torch.models.icp import _icp_register
    from simpleicp_tpu_torch.ops import gridhash, knn
    from simpleicp_tpu_torch.ops.dilate_gate import overlap_mask_dilate

    t_phase = time.perf_counter()
    dev, f32 = torch.device("cuda"), torch.float32
    none = {"match_transform": 0, "knn_search": 0, "nn_search": 0, "nn_search_d2": 0,
            "dilate": 0}

    def register(A, B, cfg, device=dev, dtype=f32):
        return _icp_register(
            A, B, cfg, rbp_observed_values=None, rbp_observation_weights=None,
            normals_fix=None, planarity_fix=None, planarity_mov=None,
            fixed_prep=None, device=device, dtype=dtype)

    # (a) the big-C grid matcher
    motion = (rotation(np.array(BIGC_ANGLES)), np.array(BIGC_T))
    X_fix, X_mov, t = cloud_pair(N_BIGC, SEED + 9, N_BIGC / N_MAIN, motion)
    Xf = torch.as_tensor(X_fix, dtype=f32, device=dev)
    Xm = torch.as_tensor(X_mov, dtype=f32, device=dev)
    del X_fix, X_mov
    cfg = IcpConfig(correspondences=C_BIGC, match_radius=BIGC_RADIUS)
    resolved = icp._resolve_engines(cfg, N_BIGC, N_BIGC)
    check(resolved.match_method == "grid",
          f"match_method 'auto' at {C_BIGC} x {N_BIGC} resolved to {resolved.match_method}")
    brute_cfg = dataclasses.replace(cfg, match_method="brute")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built, occupancy = gridhash.grid_build_cap(Xm, BIGC_RADIUS)
    occupancy = int(occupancy)
    build_s = time.perf_counter() - t0
    mean_occ = mean_occupancy(built)
    del built
    torch.cuda.reset_peak_memory_stats()
    (grid, grid_c), grid_s, grid_l, grid_reads = timed(torch, lambda: register(Xf, Xm, cfg))
    grid_peak = torch.cuda.max_memory_allocated()
    (brute, brute_c), brute_s, brute_l, brute_reads = timed(
        torch, lambda: register(Xf, Xm, brute_cfg))
    n_it = int(grid.n_iterations)
    check(grid_l == {**none, "knn_search": 1},
          f"big-C grid run launched {grid_l}, expected one k-NN and no match")
    check(brute_l == {**none, "knn_search": 1, "match_transform": int(brute.n_iterations)},
          f"big-C brute run launched {brute_l}")
    check(n_it == int(brute.n_iterations),
          f"big-C: {n_it} grid iterations against {int(brute.n_iterations)} brute")
    dH = float((grid.H - brute.H).abs().max())
    check(dH <= 1e-6, f"big-C: grid H is {dH} from the brute H (> 1e-6)")
    check(torch.equal(grid.sel_idx, brute.sel_idx), "big-C: the selections differ")
    differ = int((grid_c.m_idx != brute_c.m_idx).sum())
    Q = Xf[grid.sel_idx.long()].contiguous()
    part_a = {
        "n_fix": N_BIGC, "n_mov": N_BIGC, "correspondences": C_BIGC,
        "match_radius": BIGC_RADIUS, "motion": {"t": list(BIGC_T), "angles": list(BIGC_ANGLES)},
        "resolved": "grid", "n_iterations": n_it, "H_max_abs_diff": dH,
        "translation_err": {"grid": check_recovery(grid, t, "big-C grid"),
                            "brute": check_recovery(brute, t, "big-C brute")},
        "last_matches_differ": differ, "last_matches_differ_share": differ / C_BIGC,
        "grid_build": {"s": build_s, "occupancy": occupancy,
                       "cap": -(-occupancy // 8) * 8, "mean_occupancy": mean_occ},
        "first_run_s": {"grid": grid_s, "brute": brute_s},
        "host_reads": {"grid": grid_reads, "brute": brute_reads},
        "launches": {"grid": grid_l, "brute": brute_l},
        "grid_max_memory_allocated": grid_peak,
        "match_per_iteration": {
            "grid": match_ms(torch, Q, Xm, resolved, grid.H),
            "brute": match_ms(torch, Q, Xm, brute_cfg, grid.H)},
        "times": compare_runs(torch, {"grid": lambda: register(Xf, Xm, cfg),
                                      "brute": lambda: register(Xf, Xm, brute_cfg)}),
    }
    part_a["kernel_vs_plain"], part_a["knn_at_this_shape"] = check_knn_rows(
        torch, cmp, Q, Xf, cfg.neighbors, "big-C normals")
    bigc = (Xf, Xm)  # for the chunked phase
    del Xf, Xm, Q, grid, brute, grid_c, brute_c
    grid_launches = grid_l
    emit({"phase": "grid", "part": "a", "big_c": part_a})

    # (b) the grid gate: a 1.2M registration against the dilate gate's, and
    # the gate alone at 10M x 10M
    A, B = dil["clouds"] if dil else partial_pair(N_DILATE, SEED + 8, N_DILATE / N_MAIN)[:2]
    x0 = -math.sqrt(N_DILATE / N_MAIN)
    Af = torch.as_tensor(A, dtype=f32, device=dev)
    Bf = torch.as_tensor(B, dtype=f32, device=dev)
    gcfg = IcpConfig(max_overlap_distance=GATE_RADIUS, gate_method="grid")
    acfg = IcpConfig(max_overlap_distance=GATE_RADIUS)
    (g, _), _, g_l, g_reads = timed(torch, lambda: register(Af, Bf, gcfg))
    (d, _), _, d_l, _ = timed(torch, lambda: register(Af, Bf, acfg))
    check(d_l["dilate"] >= 1, f"grid 1.2M: 'auto' did not run the dilate gate ({d_l})")
    check(g_l == {**none, "knn_search": 1, "match_transform": int(g.n_iterations)},
          f"grid-gated 1.2M launched {g_l}")
    check_same_result(torch, g, d, "grid-gated 1.2M against the dilate-gated run")
    part_b = {"radius": GATE_RADIUS, "registration_1.2M": {
        "n_iterations": int(g.n_iterations),
        "translation_err": check_recovery(g, known_motion()[1], "grid-gated 1.2M"),
        "selected_x_min": check_overlap(g, A, x0, "grid-gated 1.2M"),
        "equals_dilate_run": "every field", "launches": {"grid": g_l, "dilate": d_l},
        "host_reads": g_reads,
        "times": compare_runs(torch, {"grid": lambda: register(Af, Bf, gcfg),
                                      "dilate": lambda: register(Af, Bf, acfg)})}}
    del Af, Bf, g, d
    A10, B10 = (dil["clouds10M"] if dil
                else partial_pair(N_DILATE_BIG, SEED + 9, N_DILATE_BIG / N_MAIN)[:2])
    Xf, Xm0 = gate_inputs(torch, A10, B10)
    plan10 = plan_of(Xm0)
    r = torch.tensor(GATE_RADIUS, dtype=f32, device=dev)
    stages = {"mean_occupancy": mean_occupancy(gridhash.build_sorted_grid(Xm0, GATE_RADIUS))}

    def grid_gate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid, cap = icp._grid_with_cap(Xm0, GATE_RADIUS, 0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d2, _ = gridhash.grid_query_sorted(Xf, grid[0], grid[1], grid[3], GATE_RADIUS,
                                           cell_cap=cap, run_end=grid[4])
        mask = d2 <= r ** 2
        torch.cuda.synchronize()
        stages.update(build_and_cap_s=t1 - t0, query_s=time.perf_counter() - t1, cap=cap)
        return mask

    torch.cuda.reset_peak_memory_stats()
    rows, masks = timed_runs(torch, {
        "grid": grid_gate,
        "dilate": lambda: overlap_mask_dilate(Xf, Xm0, GATE_RADIUS, plan10)}, 2)
    differ = int((masks["grid"][-1] != masks["dilate"][-1]).sum())
    check(differ == 0, f"grid gate 10M: the mask differs from the dilate mask at {differ} points")
    part_b["gate_alone_10M"] = {
        "n_fix": N_DILATE_BIG, "n_mov": N_DILATE_BIG, "kept": int(masks["grid"][-1].sum()),
        "mask_differs_from_dilate": differ, "grid_stages": stages, "times": rows,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "brute_mask_s_this_run": dil and dil["brute_mask_10M_s"]}
    del Xf, Xm0, masks
    emit({"phase": "grid", "part": "b", "grid_gate": part_b})

    # (c) select_in_range above 2^41 pairs (2.25e12)
    S_fix, S_mov, _, _ = partial_pair(N_SELECT, SEED + 11, N_SELECT / N_MAIN)
    check(N_SELECT * N_SELECT > api._SELECT_BRUTE_PAIRS,
          "select_in_range case at or below its brute limit (2^41 pairs)")
    pc = PointCloud(S_fix)
    t0 = time.perf_counter()
    pc.select_in_range(S_mov, GATE_RADIUS)
    select_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d2 = knn.min_dist_sq(torch.as_tensor(S_fix, dtype=f32, device=dev),
                         torch.as_tensor(S_mov, dtype=f32, device=dev))
    brute_keep = np.flatnonzero(d2.cpu().numpy() <= float(GATE_RADIUS) ** 2)
    brute_sel_s = time.perf_counter() - t0
    same = np.array_equal(pc.idx_selected, brute_keep)
    check(same, f"select_in_range above 2^41: {len(pc.idx_selected)} kept against "
          f"{len(brute_keep)} by the brute mask")
    part_c = {"n_selected": N_SELECT, "n_ref": N_SELECT, "pairs": N_SELECT * N_SELECT,
              "radius": GATE_RADIUS, "kept": int(len(brute_keep)), "equals_brute_mask": same,
              "grid_s": select_s, "brute_s": brute_sel_s}
    emit({"phase": "grid", "part": "c", "select_in_range": part_c})
    del pc, d2

    # (d) float64, the card against the CPU
    F_fix, F_mov, _ = cloud_pair(N_GATE_F64, SEED + 14, N_GATE_F64 / N_MAIN)
    P_fix, P_mov, _, _ = partial_pair(N_GATE_F64, SEED + 15, N_GATE_F64 / N_MAIN)
    part_d = {}
    for label, (A, B, c) in {
            "grid_matcher": (F_fix, F_mov, IcpConfig(correspondences=2000, match_radius=0.1,
                                                     match_method="grid")),
            "grid_gate": (P_fix, P_mov, IcpConfig(max_overlap_distance=GATE_RADIUS,
                                                  gate_method="grid"))}.items():
        (on, on_c), _, on_l, _ = timed(torch, lambda: register(A, B, c, dtype=torch.float64))
        off, off_c = register(A, B, c, device="cpu", dtype=torch.float64)
        what = f"float64 {label} 20k card vs CPU"
        engine_kernel = "match_transform" if label == "grid_matcher" else "nn_search_d2"
        check(on_l[engine_kernel] == 0 and on_l["knn_search"] == 1,
              f"{what}: launched {on_l}")
        check(int(on.n_iterations) == int(off.n_iterations), f"{what}: iterations differ")
        check(torch.equal(on.sel_idx.cpu(), off.sel_idx), f"{what}: selections differ")
        check(torch.equal(on_c.m_idx.cpu(), off_c.m_idx), f"{what}: last matches differ")
        dH = float((on.H.cpu() - off.H).abs().max())
        check(dH <= 1e-9, f"{what}: H differs by {dH} (> 1e-9)")
        part_d[label] = {"n_iterations": int(on.n_iterations), "H_max_abs_diff": dH,
                         "launches": on_l}
    emit({"phase": "grid", "part": "d", "float64_card_vs_cpu": part_d,
          "phase_s": time.perf_counter() - t_phase})
    return grid_launches, bigc




# Chunked dispatch: K iterations a call, each run against the same
# registration run monolithically; the big-C pair under a budget that
# makes the card-priced planner choose chunked, query blocks and the grid
# k-NN cascade.
CHUNK_KS = (1, 3)


class LogLines:
    """The messages ``models/icp.py``'s logger emits at ``level`` or above
    inside a ``with`` block (the plan and cascade lines)."""

    def __init__(self, level):
        import logging

        self.level, self.lines = level, []
        self.log = logging.getLogger("simpleicp_tpu_torch.models.icp")
        self.handler = logging.Handler(level)
        self.handler.emit = lambda rec: self.lines.append(rec.getMessage())

    def __enter__(self):
        self.old = self.log.level
        self.log.addHandler(self.handler)
        self.log.setLevel(self.level)
        return self.lines

    def __exit__(self, *exc):
        self.log.removeHandler(self.handler)
        self.log.setLevel(self.old)


def cascade_rows(lines):
    """The grid k-NN cascade's radii, cap and rows from its log lines:
    certified in round 1, sent to round 2 (regridded) and patched by the
    dense k-NN."""
    import re

    out = {"regridded": 0, "dense_patched": 0}
    for ln in lines:
        m = re.search(r"r=(\S+), r_hi=(\S+), cap (\d+): (\d+)/\d+ certified", ln)
        if m:
            out.update(r=float(m[1].rstrip(",")), r_hi=float(m[2].rstrip(",")),
                       cap=int(m[3]), certified_round1=int(m[4]))
        m = re.search(r"(\d+)/\d+ uncertified at r=\S+ -> regrid", ln)
        if m:
            out["regridded"] = int(m[1])
        m = re.search(r"(\d+)/\d+ uncertified rows -> dense recompute", ln)
        if m:
            out["dense_patched"] = int(m[1])
    return out


def chunk_budget(n, C, cap):
    """A program_budget_s under which the planner chooses chunked dispatch,
    query blocks and the grid k-NN cascade for a C x n grid-matched
    registration, and prepare_fixed query blocks and the cascade, from the
    ported card rates: 0.8 of the k-NN's estimate (below the whole run's).
    Returns (budget, the stage estimates)."""
    from simpleicp_tpu_torch.utils import device_policy as dp

    gate_s, knn_s, build_s, per_iter = dp.estimate_gpu_stage_seconds(
        n, n, correspondences=C, match_method="grid", match_cell_cap=cap)
    est = gate_s + knn_s + build_s + 10 * per_iter
    budget = 0.8 * min(est, knn_s)
    atom = max(gate_s + build_s, per_iter, knn_s * 2048 / C)
    check(atom < 0.9 * budget, f"big-C: no budget splits the run (atom {atom} s)")
    return budget, {"gate_s": gate_s, "knn_s": knn_s, "build_s": build_s,
                    "per_iteration_s": per_iter, "estimate_s": est}


def phase_chunked(torch, dil=None, bigc=None):
    """Chunked dispatch on the card, float32, each run bit-equal (every
    result field and the last matches) to the same registration run
    monolithically: (a) 100k, default config, K = 1, 3 and max_iterations;
    (b) the gated 100k pair, K = 2; (c) the dilate 1.2M pair, K = 2; (d)
    big-C (C=100 000 x 12.5M, match_radius 0.05) under a budget that makes
    the planner choose chunked, query blocks and the grid k-NN cascade, K
    = 1: its normals bit-equal to the dense k-NN's; (e) prepare_fixed at
    big-C under that budget, bit-equal to the dense preparation. Returns
    each kernel's launches over the chunked runs."""
    import dataclasses
    import logging

    import numpy as np

    from simpleicp_tpu_torch import IcpConfig, prepare_fixed
    from simpleicp_tpu_torch.models import icp

    t_phase = time.perf_counter()
    dev, f32 = torch.device("cuda"), torch.float32
    total = {}

    def register(A, B, cfg):
        return icp._icp_register(
            A, B, cfg, rbp_observed_values=None, rbp_observation_weights=None,
            normals_fix=None, planarity_fix=None, planarity_mov=None,
            fixed_prep=None, device=dev, dtype=f32)

    def against_mono(A, B, cfg, ks, what):
        """The monolithic run, then a chunked run for each K: bit-equal,
        their launches (added to the phase's) and host reads."""
        (mono, mono_c), mono_s, mono_l, mono_r = timed(torch, lambda: register(A, B, cfg))
        out = {"n_iterations": int(mono.n_iterations),
               "monolithic": {"launches": mono_l, "host_reads": mono_r, "first_run_s": mono_s}}
        for k in ks:
            ccfg = dataclasses.replace(cfg, dispatch="chunked", chunk_iterations=k)
            (res, res_c), s, launches, reads = timed(torch, lambda: register(A, B, ccfg))
            check_same_result(torch, res, mono, f"{what} chunked K={k}")
            check(torch.equal(res_c.m_idx, mono_c.m_idx), f"{what} K={k}: last matches differ")
            for name, n in launches.items():
                total[name] = total.get(name, 0) + n
            out[f"K={k}"] = {"chunks": -(-int(mono.n_iterations) // k), "launches": launches,
                             "host_reads": reads, "extra_host_reads": reads - mono_r,
                             "first_run_s": s, "equals_monolithic": "every field"}
        return out

    # (a) 100k, default config
    X_fix, X_mov, _ = cloud_pair(N_MAIN, SEED + 1)
    A = torch.as_tensor(X_fix, dtype=f32, device=dev)
    B = torch.as_tensor(X_mov, dtype=f32, device=dev)
    T = IcpConfig().max_iterations
    part = {"100k": against_mono(A, B, IcpConfig(), (*CHUNK_KS, T), "100k")}
    k1 = IcpConfig(dispatch="chunked", chunk_iterations=1)
    part["100k"]["times"] = compare_runs(torch, {"chunked K=1": lambda: register(A, B, k1),
                                                 "monolithic": lambda: register(A, B, IcpConfig())})
    # (b) the gated 100k pair (brute gate)
    G = partial_pair(N_MAIN, SEED + 3)
    A = torch.as_tensor(G[0], dtype=f32, device=dev)
    B = torch.as_tensor(G[1], dtype=f32, device=dev)
    part["gated 100k"] = against_mono(A, B, IcpConfig(max_overlap_distance=GATE_RADIUS),
                                      (2,), "gated 100k")
    # (c) the dilate 1.2M pair
    D = dil["clouds"] if dil else partial_pair(N_DILATE, SEED + 8, N_DILATE / N_MAIN)[:2]
    A = torch.as_tensor(D[0], dtype=f32, device=dev)
    B = torch.as_tensor(D[1], dtype=f32, device=dev)
    part["dilate 1.2M"] = against_mono(A, B, IcpConfig(max_overlap_distance=GATE_RADIUS),
                                       (2,), "dilate 1.2M")
    check(part["dilate 1.2M"]["K=2"]["launches"]["dilate"] >= 1,
          "chunked dilate 1.2M: the dilate gate did not run")
    del A, B
    emit({"phase": "chunked", "part": "a-c", "runs": part})

    # (d) big-C under a budget that splits it
    if bigc is None:
        motion = (rotation(np.array(BIGC_ANGLES)), np.array(BIGC_T))
        X_fix, X_mov, _ = cloud_pair(N_BIGC, SEED + 9, N_BIGC / N_MAIN, motion)
        bigc = (torch.as_tensor(X_fix, dtype=f32, device=dev),
                torch.as_tensor(X_mov, dtype=f32, device=dev))
        del X_fix, X_mov
    Xf, Xm = bigc
    cfg = IcpConfig(correspondences=C_BIGC, match_radius=BIGC_RADIUS)
    rcfg = icp._resolve_engines(cfg, N_BIGC, N_BIGC)
    _, cap = icp._match_grid(Xm, rcfg)
    budget, stages = chunk_budget(N_BIGC, C_BIGC, cap)
    ccfg = dataclasses.replace(cfg, program_budget_s=budget, chunk_iterations=1)
    plan = icp._plan_dispatch(dataclasses.replace(rcfg, program_budget_s=budget,
                                                  chunk_iterations=1),
                              N_BIGC, N_BIGC, device=dev, has_normals=False,
                              match_cell_cap=cap)
    check(plan.dispatch == "chunked" and plan.knn_block > 0 and plan.knn_grid,
          f"big-C at budget {budget}: plan {plan}")
    (mono, mono_c), mono_s, mono_l, mono_r = timed(torch, lambda: register(Xf, Xm, cfg))
    with LogLines(logging.DEBUG) as lines:
        (res, res_c), s, launches, reads = timed(torch, lambda: register(Xf, Xm, ccfg))
    check_same_result(torch, res, mono, "big-C chunked with the grid k-NN cascade")
    check(torch.equal(res_c.m_idx, mono_c.m_idx), "big-C chunked: last matches differ")
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    check(any(ln.startswith("dispatch plan: chunked") for ln in lines),
          f"big-C: no chunked plan logged: {lines}")
    cascade = [ln for ln in lines if ln.startswith("grid-kNN prologue")]
    check(bool(cascade), f"big-C: the grid k-NN cascade did not run: {lines}")

    # the cascade alone against the dense k-NN's normals (CUDA events and
    # medians of 3, in turns)
    Q = Xf[mono.sel_idx.long()].contiguous()
    dense_n, dense_p = icp._dense_knn_rows(Q, Xf, rcfg)
    casc_n, casc_p = icp._knn_grid_normals(Q, Xf, rcfg, plan.knn_block)
    check(casc_n is not None, "big-C: the cascade found its plan uneconomical")
    check(torch.equal(casc_n, dense_n) and torch.equal(casc_p, dense_p),
          "big-C: cascade normals differ from the dense k-NN's")
    check(torch.equal(mono.normals, dense_n) and torch.equal(mono.planarity, dense_p),
          "big-C: the monolithic normals differ from the dense k-NN's")

    def events_ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    normals_ms = {"cascade": [], "dense": []}
    for _ in range(3):
        normals_ms["cascade"].append(events_ms(
            lambda: icp._knn_grid_normals(Q, Xf, rcfg, plan.knn_block)))
        normals_ms["dense"].append(events_ms(lambda: icp._dense_knn_rows(Q, Xf, rcfg)))
    walls = compare_runs(torch, {"chunked": lambda: register(Xf, Xm, ccfg),
                                 "monolithic": lambda: register(Xf, Xm, cfg)})
    part_d = {
        "n_fix": N_BIGC, "n_mov": N_BIGC, "correspondences": C_BIGC,
        "match_radius": BIGC_RADIUS, "program_budget_s": budget, "stage_estimates": stages,
        "plan": plan._asdict(), "match_cell_cap": cap, "cascade": cascade_rows(cascade),
        "cascade_lines": cascade,
        "n_iterations": int(mono.n_iterations), "equals_monolithic": "every field",
        "normals_equal_dense_knn": True,
        "launches": {"chunked": launches, "monolithic": mono_l},
        "host_reads": {"chunked": reads, "monolithic": mono_r},
        "first_run_s": {"chunked": s, "monolithic": mono_s},
        "normals_ms": {k: {"runs": v, "median": statistics.median(v)}
                       for k, v in normals_ms.items()},
        "times": walls,
    }
    emit({"phase": "chunked", "part": "d", "big_c": part_d})

    # (e) prepare_fixed at big-C under the same budget
    pcfg = IcpConfig(correspondences=C_BIGC, program_budget_s=budget)
    check(icp._plan_prepared_knn(pcfg, N_BIGC, dev)[1],
          "big-C preparation: the planner did not choose the cascade")
    with LogLines(logging.INFO) as lines:
        prep, prep_s, prep_l, prep_r = timed(torch, lambda: prepare_fixed(Xf, pcfg, device=dev))
    dense, dense_s, dense_l, _ = timed(
        torch, lambda: prepare_fixed(Xf, IcpConfig(correspondences=C_BIGC), device=dev))
    for f, a, b in zip(prep._fields, prep, dense):
        check(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b,
              f"big-C preparation under the budget: {f} differs from the dense one")
    for name, n in prep_l.items():
        total[name] = total.get(name, 0) + n
    emit({"phase": "chunked", "part": "e", "prepare_fixed": {
        "program_budget_s": budget, "equals_dense_preparation": "every field",
        "launches": prep_l, "host_reads": prep_r, "s": prep_s, "cascade_lines": lines,
        "dense_preparation": {"s": dense_s, "launches": dense_l}},
        "chunked_launches": total, "phase_s": time.perf_counter() - t_phase})
    missing = [k for k in KERNELS if total.get(k, 0) + (
        total.get("nn_search_d2", 0) if k == "nn_search" else 0) == 0]
    check(not missing, f"chunked runs launched no {missing}")
    return total


# The policy phase: the rates of utils/device_policy.py measured again.
POLICY_CPU_SHAPE = (2000, 200_000)
POLICY_SMALL = 5_000
POLICY_BIG = 1_000_000


def card_fixed_cost_s():
    """The card's one-time cost in a fresh process: CUDA's start-up, the
    load of the built kernels and the first launches, as the seconds of
    its first 2000-point registration (C=100) on the card, CUDA's
    initialisation included, less those of a second one. Returns the
    median of 3 processes and each process's value."""
    code = ("import time\n"
            "import numpy as np, torch\n"
            "from simpleicp_tpu_torch import IcpConfig, icp_register\n"
            "X = np.random.default_rng(0).uniform(-1, 1, (2000, 3)) * [1, 1, 0.1]\n"
            "def run():\n"
            "    t0 = time.perf_counter()\n"
            "    r = icp_register(X, X + 0.01, IcpConfig(correspondences=100))\n"
            "    int(r.n_iterations)\n"
            "    return time.perf_counter() - t0\n"
            "t0 = time.perf_counter()\n"
            "torch.cuda.init()\n"
            "first = time.perf_counter() - t0 + run()\n"
            "print('FIXED', first - run())\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    runs = []
    for _ in range(3):
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"fresh card process failed: {proc.stderr[-2000:]}")
        runs.append(float(next(ln.split()[1] for ln in proc.stdout.splitlines()
                               if ln.startswith("FIXED"))))
    return statistics.median(runs), runs


def cli_auto(torch, n, seed, tmp):
    """The CLI with --device auto on an n-point pair (C=1000, ungated), as
    a subprocess: the route it logged and its wall time."""
    from simpleicp_tpu_torch.utils.xyz_io import write_xyz

    X_fix, X_mov, _ = cloud_pair(n, seed, n / N_MAIN)
    f1, f2 = (os.path.join(tmp, f"{n}_{x}.xyz") for x in ("fix", "mov"))
    write_xyz(f1, X_fix, fmt="%.6f")
    write_xyz(f2, X_mov, fmt="%.6f")
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "simpleicp_tpu_torch", "-f", f1, "-m", f2,
                           "--device", "auto"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"CLI --device auto at {n} exited {proc.returncode}: {log[-3000:]}")
    check("Finished in " in log, f"CLI --device auto at {n}: no 'Finished in' line")
    route = [ln for ln in log.splitlines() if ln.startswith("device auto: ")]
    check(len(route) == 1, f"CLI --device auto at {n}: route lines {route}")
    return {"n_points": n, "route_line": route[0], "routed": route[0].split()[2],
            "wall_s": seconds}


def phase_policy(torch):
    """The rates of utils/device_policy.py against this run's measurements
    (each constant within a factor of 2), the card's fixed cost in a fresh
    process with --device auto's health probe, and the CLI's --device auto
    routing a small pair to the CPU and a 1M pair to the card."""
    import numpy as np

    from simpleicp_tpu_torch.models import icp
    from simpleicp_tpu_torch.ops import gridhash, knn
    from simpleicp_tpu_torch.utils import device_policy as dp

    t_phase = time.perf_counter()
    dev, f32 = torch.device("cuda"), torch.float32
    n_big = 5_000_000
    X_fix, X_mov, _ = cloud_pair(n_big, SEED + 21, n_big / N_MAIN)
    Xf = torch.as_tensor(X_fix, dtype=f32, device=dev)
    Xm = torch.as_tensor(X_mov, dtype=f32, device=dev)
    del X_fix, X_mov
    Q = Xf[torch.as_tensor(np.linspace(0, n_big - 1, C_BIGC).astype(np.int64), device=dev)]
    card = {}
    sweep_ms = cuda_ms(torch, lambda: knn.min_dist_sq(Q, Xm), 3)
    card["GPU_SWEEP_PAIRS_PER_SEC"] = (C_BIGC * n_big / (sweep_ms / 1e3), dp.GPU_SWEEP_PAIRS_PER_SEC,
                                       f"1-NN d2-only, {C_BIGC} x {n_big}")
    knn_ms = cuda_ms(torch, lambda: knn.knn_search(Q, Xf, 10), 2)
    card["GPU_KNN10_PAIRS_PER_SEC"] = (C_BIGC * n_big / (knn_ms / 1e3), dp.GPU_KNN10_PAIRS_PER_SEC,
                                       f"k-NN k=10, {C_BIGC} x {n_big}")

    def build():
        return icp._grid_with_cap(Xm, BIGC_RADIUS, 0)

    build_ms = cuda_ms(torch, build, 3)
    card["GPU_SORT_ELEMS_PER_SEC"] = (n_big / (build_ms / 1e3), dp.GPU_SORT_ELEMS_PER_SEC,
                                      f"grid build and cap read, {n_big} points")
    (pts, slots, _, origin, run_end), cap = build()
    query_ms = cuda_ms(torch, lambda: gridhash.grid_query_sorted(
        Q, pts, slots, origin, BIGC_RADIUS, cell_cap=cap, run_end=run_end), 3)
    card["GPU_GATHER_ELEMS_PER_SEC"] = (C_BIGC * 27 * cap * 3 / (query_ms / 1e3),
                                        dp.GPU_GATHER_ELEMS_PER_SEC,
                                        f"grid query, {C_BIGC} queries x 27 x cap {cap} x 3")
    del Xf, Xm, Q, pts, slots, origin, run_end

    nq, nr = POLICY_CPU_SHAPE
    rng = np.random.default_rng(SEED + 22)
    Qc = torch.as_tensor(rng.uniform(-1, 1, (nq, 3)), dtype=f32)
    Rc = torch.as_tensor(rng.uniform(-1, 1, (nr, 3)), dtype=f32)
    Hc = torch.eye(4, dtype=f32)
    cpu = {}
    for const, fn, what in (
            ("CPU_GATE_PAIRS_PER_SEC", lambda q: knn.min_dist_sq(q, Rc), "1-NN d2-only"),
            ("CPU_KNN10_PAIRS_PER_SEC", lambda q: knn.knn_search(q, Rc, 10), "k-NN k=10"),
            ("CPU_LOOP_PAIRS_PER_SEC", lambda q: knn.match_transform(q, Rc, Hc), "match")):
        fn(Qc[:200])  # warm-up
        t0 = time.perf_counter()
        fn(Qc)
        cpu[const] = (nq * nr / (time.perf_counter() - t0), getattr(dp, const),
                      f"{what}, {nq} x {nr}, {torch.get_num_threads()} threads")
    fixed, fixed_runs = card_fixed_cost_s()
    probes = [dp.probe_default_backend(120.0) for _ in range(3)]
    check(all(st == "ok" and be == "cuda" for st, be, _ in probes),
          f"health probe of the card: {probes}")
    probe_s = statistics.median(sec for _, _, sec in probes)
    cpu["CPU_ROUTE_MAX_SEC"] = (fixed + probe_s, dp.CPU_ROUTE_MAX_SEC,
                                f"--device auto's health probe ({probe_s:.3f} s) and the "
                                f"card's one-time cost in a fresh process ({fixed:.3f} s), "
                                "medians of 3")
    rows = {}
    for name, (measured, const, what) in {**card, **cpu}.items():
        ratio = const / measured if measured > 0 else math.inf
        rows[name] = {"measured": measured, "constant": const, "constant_over_measured": ratio,
                      "what": what}
    emit({"phase": "policy", "part": "rates", "rates": rows, "card_fixed_cost_runs_s": fixed_runs,
          "probe_runs_s": [sec for _, _, sec in probes]})
    for name, row in rows.items():
        check(0.5 <= row["constant_over_measured"] <= 2.0,
              f"{name} = {row['constant']:.4g}, this run measured {row['measured']:.4g} "
              "(not within a factor of 2)")

    with tempfile.TemporaryDirectory() as tmp:
        small = cli_auto(torch, POLICY_SMALL, SEED + 23, tmp)
        big = cli_auto(torch, POLICY_BIG, SEED + 24, tmp)
    check(small["routed"] == "cpu", f"--device auto on {POLICY_SMALL} points: {small}")
    check(big["routed"] == "cuda", f"--device auto on {POLICY_BIG} points: {big}")
    emit({"phase": "policy", "part": "cli", "device_auto": [small, big],
          "phase_s": time.perf_counter() - t_phase})


CLI_ENV = {"SIMPLEICP_TPU_DEBUG_TIMING": "1"}  # the CLI's "timing:" lines
CLI_TIMINGS = ("parse both clouds", "register (to the host)", "write transformed cloud")


def run_cli(args, counted=False):
    """``python3 -m simpleicp_tpu_torch *args`` in a subprocess on the card:
    (exit code, its output, wall seconds, the kernel launches of its
    process or None). ``counted`` runs the module the way ``-m`` does
    (runpy) inside ``chip_smoke.py --cli-counted``, which sets every count
    to 0 before and prints them after."""
    env = {**os.environ, **CLI_ENV,
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    head = ([sys.executable, str(Path(__file__).resolve()), "--cli-counted"] if counted
            else [sys.executable, "-m", "simpleicp_tpu_torch"])
    t0 = time.perf_counter()
    proc = subprocess.run([*head, *args], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    launches = None
    if counted:
        lines = [ln for ln in proc.stderr.splitlines() if ln.startswith("CLI_LAUNCHES ")]
        launches = json.loads(lines[-1].split(" ", 1)[1]) if lines else None
    return proc.returncode, log, seconds, launches


def cli_counted(args) -> int:
    """The CLI's ``main`` as ``python3 -m simpleicp_tpu_torch`` runs it, with
    every launch count set to 0 just before and printed on standard error
    just after (``CLI_LAUNCHES {...}``)."""
    import runpy

    reset_counts()
    sys.argv = ["simpleicp_tpu_torch", *args]
    try:
        runpy.run_module("simpleicp_tpu_torch", run_name="__main__", alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    print("CLI_LAUNCHES " + json.dumps(read_counts()), file=sys.stderr, flush=True)
    return rc


def check_cli_run(rc, log, what):
    check(rc == 0, f"CLI {what} exited {rc}: {log[-3000:]}")
    for line in ("orig:0", "Convergence criteria fulfilled -> stop iteration!",
                 "Finished in "):
        check(line in log, f"CLI {what}: output lacks {line!r}")
    finished = [ln for ln in log.splitlines() if ln.startswith("Finished in ")]
    return finished[-1]


def export_err(X_out, X_in, n, what):
    """Largest distance of the exported cloud from the movable cloud moved
    back by the known motion (three decimals in the files)."""
    import numpy as np

    check(X_out.shape == (n, 3) and bool(np.isfinite(X_out).all()),
          f"CLI {what}: exported cloud has shape {X_out.shape} or is not finite")
    R, tt = known_motion()
    err = float(np.abs(X_out - (X_in @ R.T + tt)).max())
    check(err < 5e-3, f"CLI {what}: exported cloud is {err} from the known motion")
    return err


def io_times(X, path, d):
    """read_xyz against read_xyz_plain on ``path`` and write_xyz against
    write_xyz_plain of X, in turns (plain, native, native, plain): the
    seconds of each run, the arrays bit-equal and the files byte-equal."""
    import numpy as np

    from simpleicp_tpu_torch.utils import xyz_io

    runs = {k: [] for k in ("read_native", "read_plain", "write_native", "write_plain")}
    outs = {}
    for impl in ("plain", "native", "native", "plain"):
        read = xyz_io.read_xyz if impl == "native" else xyz_io.read_xyz_plain
        t0 = time.perf_counter()
        outs[impl] = read(path)
        runs[f"read_{impl}"].append(time.perf_counter() - t0)
    check(np.array_equal(outs["native"].view(np.uint64), outs["plain"].view(np.uint64)),
          "read_xyz is not bit-equal to read_xyz_plain on the 1.2M file")
    files = {}
    for impl in ("plain", "native", "native", "plain"):
        write = xyz_io.write_xyz if impl == "native" else xyz_io.write_xyz_plain
        files[impl] = os.path.join(d, f"write_{impl}.xyz")
        t0 = time.perf_counter()
        write(files[impl], X, fmt="%.3f")
        runs[f"write_{impl}"].append(time.perf_counter() - t0)
    with open(files["native"], "rb") as a, open(files["plain"], "rb") as b:
        check(a.read() == b.read(), "write_xyz is not byte-equal to write_xyz_plain")
    return {"runs_s": runs, "median_s": {k: statistics.median(v) for k, v in runs.items()},
            "file_bytes": os.path.getsize(path), "bit_equal": True, "byte_equal": True}


def phase_cli(torch, d):
    """The CLI as a user starts it, in a subprocess on the card: a gated
    100k pair, and the dilate 1.2M pair (its files in ``d``) with its
    launches counted; the exported clouds read back; then the native xyz
    I/O against numpy on the 1.2M file. Returns the 1.2M run
    (cli_dilate_run)."""
    from simpleicp_tpu_torch.utils.xyz_io import read_xyz, write_xyz

    X_fix, X_mov, t, _ = partial_pair(N_MAIN, SEED + 6)
    with tempfile.TemporaryDirectory() as g:
        f1, f2, out = (os.path.join(g, n) for n in ("fix.xyz", "mov.xyz", "out.xyz"))
        write_xyz(f1, X_fix, fmt="%.6f")
        write_xyz(f2, X_mov, fmt="%.6f")
        rc, log, seconds, _ = run_cli(["-f", f1, "-m", f2, "-o", str(GATE_RADIUS),
                                       "--export", out])
        finished = check_cli_run(rc, log, "gated 100k")
        err = export_err(read_xyz(out), read_xyz(f2), N_MAIN, "gated 100k")
    emit({"phase": "cli", "part": "gated 100k", "command": "python3 -m simpleicp_tpu_torch "
          f"-f fix.xyz -m mov.xyz -o {GATE_RADIUS} --export out.xyz", "n_points": N_MAIN,
          "exit_code": rc, "wall_s": seconds, "finished_line": finished,
          "export_max_abs_err": err})

    run = cli_dilate_run(d)
    emit({"phase": "cli", "part": "dilate 1.2M", "command": "python3 -m simpleicp_tpu_torch "
          f"-f fix.xyz -m mov.xyz -o {GATE_RADIUS} --export out.xyz (run as -m runs it, "
          "by runpy in chip_smoke.py --cli-counted, which counts the launches)",
          "n_points": N_DILATE, "input_format": "%.3f", "inputs_written_s": run["write_s"],
          "exit_code": run["exit_code"], "wall_s": run["wall_s"], "finished_line": run["finished"],
          "cli_timing_s": run["timing"], "launches": run["launches"],
          "export_max_abs_err": run["err"], "xyz_io": io_times(run.pop("X_mov"), run["mov"], d)})
    return run


def dilate_cli_args(f1, f2, out):
    return ["-f", str(f1), "-m", str(f2), "-o", str(GATE_RADIUS), "--export", str(out)]


def cli_timings(log, what):
    """The CLI's ``timing:`` lines (seconds by name); all of CLI_TIMINGS."""
    timing = {}
    for ln in log.splitlines():
        for name in CLI_TIMINGS:
            if ln.startswith(f"timing: {name} "):
                timing[name] = float(ln.split()[-2])
    check(set(timing) == set(CLI_TIMINGS), f"CLI {what}: timing lines {timing}")
    return timing


def check_dilate_launches(launches, what):
    # auto plans the dilate gate: one dilation run, the band sweep in the
    # 1-NN's d2-only mode, one k-NN, one match an iteration
    check(launches is not None, f"CLI {what} printed no launch counts")
    check(launches["dilate"] >= 1 and launches["nn_search_d2"] >= 1
          and launches["nn_search"] == 0 and launches["knn_search"] == 1
          and launches["match_transform"] >= 1, f"CLI {what}: kernel launches {launches}")


def cli_dilate_run(d):
    """The checkout's CLI on the dilate 1.2M pair, written into ``d`` at the
    CLI's default %.3f with the port's writer (``d``/fix.xyz, mov.xyz;
    export ``d``/out.xyz), its launches counted in its process: the run,
    its checks and its numbers."""
    from simpleicp_tpu_torch.utils.xyz_io import read_xyz, write_xyz

    X_fix, X_mov, t, _ = partial_pair(N_DILATE, SEED + 8, N_DILATE / N_MAIN)
    f1, f2, out = (os.path.join(d, n) for n in ("fix.xyz", "mov.xyz", "out.xyz"))
    t0 = time.perf_counter()
    write_xyz(f1, X_fix)  # the CLI's default %.3f
    write_xyz(f2, X_mov)
    write_s = time.perf_counter() - t0
    rc, log, seconds, launches = run_cli(dilate_cli_args(f1, f2, out), counted=True)
    finished = check_cli_run(rc, log, "dilate 1.2M")
    check_dilate_launches(launches, "dilate 1.2M")
    X_in = read_xyz(f2)
    return {"fix": f1, "mov": f2, "out": out, "log": log, "exit_code": rc, "write_s": write_s,
            "wall_s": seconds, "finished": finished, "launches": launches,
            "timing": cli_timings(log, "dilate 1.2M"), "X_mov": X_in,
            "err": export_err(read_xyz(out), X_in, N_DILATE, "dilate 1.2M")}


# The installed program: a wheel of the checkout, built by pip from a copy
# of the packaging files and both packages (so that the checkout gains no
# build/ and no egg-info), installed with no network into a fresh venv that
# sees this interpreter's site-packages (torch, numpy, pip, setuptools)
# through a .pth file and never the checkout. A second .pth file of that
# venv imports PORT_REPORT_MODULE, which prints on standard error, as the
# process exits, where simpleicp_tpu_torch was imported from, its kernel
# launches and the libraries it built (``PORT_REPORT {...}``): the console
# script itself runs unchanged.
WHEEL_FILES = ("pyproject.toml", "README.md")
WHEEL_PACKAGES = ("simpleicp_tpu", "simpleicp_tpu_torch")
WHEEL_IGNORE = ("_build", "__pycache__", "*.so", "build", "*.egg-info")
PORT_REPORT_MODULE = """\
import atexit
import json
import sys


def _report():
    pkg = sys.modules.get("simpleicp_tpu_torch")
    if pkg is None:
        return
    from simpleicp_tpu_torch import _build
    from simpleicp_tpu_torch.ops import dilate_cuda, knn_cuda

    print("PORT_REPORT " + json.dumps({
        "file": pkg.__file__, "sys_path": sys.path,
        "launches": {**knn_cuda.LAUNCHES, **dilate_cuda.LAUNCHES},
        "build_s": _build.BUILD_SECONDS,
        "foreign": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib", "simpleicp_tpu"))}),
        file=sys.stderr, flush=True)


atexit.register(_report)
"""


def copy_tree(dst):
    """The packaging files and both packages of the checkout, copied to
    ``dst`` without built files."""
    import shutil

    dst = Path(dst)
    dst.mkdir(parents=True)
    for name in WHEEL_FILES:
        shutil.copy2(ROOT / name, dst / name)
    for pkg in WHEEL_PACKAGES:
        shutil.copytree(ROOT / pkg, dst / pkg, ignore=shutil.ignore_patterns(*WHEEL_IGNORE))
    return dst


def build_wheel(src, out):
    """The wheel that ``pip wheel`` builds of the tree ``src`` into ``out``,
    with no network, no build isolation and no cache."""
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "--no-cache-dir", "--disable-pip-version-check", "-q",
         "-w", str(out), str(src)], capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"pip wheel failed ({proc.returncode}):\n"
          f"{(proc.stdout + proc.stderr)[-3000:]}")
    wheels = sorted(Path(out).glob("simpleicp_tpu-*.whl"))
    check(len(wheels) == 1, f"pip wheel made {wheels}")
    return wheels[0]


def install_wheel(wheel, prefix):
    """``wheel`` installed into a fresh venv at ``prefix`` (see above):
    (its bin directory, its site-packages)."""
    import site

    prefix = Path(prefix)
    proc = subprocess.run([sys.executable, "-m", "venv", "--without-pip", str(prefix)],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"python -m venv failed: {proc.stdout + proc.stderr}")
    bin_dir = prefix / "bin"
    sp = Path(subprocess.run(
        [str(bin_dir / "python"), "-c", "import sysconfig; print(sysconfig.get_paths()['purelib'])"],
        capture_output=True, text=True, timeout=120, check=True).stdout.strip())
    host = site.getsitepackages() + ([site.getusersitepackages()] if site.ENABLE_USER_SITE
                                     else [])
    host = [h for h in dict.fromkeys(os.path.realpath(h) for h in host)
            if os.path.isdir(h) and Path(ROOT) not in (Path(h), *Path(h).parents)]
    (sp / "_host_env.pth").write_text("".join(h + "\n" for h in host))
    (sp / "_port_report.py").write_text(PORT_REPORT_MODULE)
    (sp / "_port_report.pth").write_text("import _port_report\n")
    proc = subprocess.run(
        [str(bin_dir / "python"), "-m", "pip", "install", "--no-deps", "--no-index",
         "--no-build-isolation", "--no-cache-dir", "--disable-pip-version-check", "-q",
         str(wheel)], capture_output=True, text=True, timeout=600, env=isolated_env())
    check(proc.returncode == 0, f"pip install of {wheel.name} failed ({proc.returncode}):\n"
          f"{(proc.stdout + proc.stderr)[-3000:]}")
    return bin_dir, sp


def isolated_env(extra=None):
    """This process's environment without the variables that could put the
    checkout on a child's path."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "PYTHONHOME")}
    return {**env, **(extra or {})}


def run_installed(bin_dir, args, cwd):
    """The installed ``simpleicp-tpu-torch`` console script in a subprocess
    from ``cwd``: (exit code, its output without the report, wall seconds,
    the PORT_REPORT of its process or None)."""
    t0 = time.perf_counter()
    proc = subprocess.run([str(Path(bin_dir) / "simpleicp-tpu-torch"), *args], cwd=cwd,
                          env=isolated_env(CLI_ENV), capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    lines = proc.stderr.splitlines()
    reports = [ln for ln in lines if ln.startswith("PORT_REPORT ")]
    report = json.loads(reports[-1].split(" ", 1)[1]) if reports else None
    log = proc.stdout + "".join(ln + "\n" for ln in lines if not ln.startswith("PORT_REPORT "))
    return proc.returncode, log, seconds, report


def check_installed(report, site_dir, what):
    """The installed process imported the package from ``site_dir``, had
    no checkout on its path and imported no JAX."""
    check(report is not None, f"{what}: the installed process printed no PORT_REPORT")
    file = Path(report["file"]).resolve()
    check(Path(site_dir).resolve() in file.parents,
          f"{what}: simpleicp_tpu_torch came from {file}, not from {site_dir}")
    check(all(Path(ROOT) not in (Path(p).resolve(), *Path(p).resolve().parents)
              for p in report["sys_path"] if p),
          f"{what}: the checkout is on the installed process's path {report['sys_path']}")
    check(not report["foreign"], f"{what}: imported {report['foreign']}")


def h_rows(log):
    """The four rows under the CLI's ``Estimated transformation matrix H:``."""
    lines = log.splitlines()
    at = [i for i, ln in enumerate(lines) if "Estimated transformation matrix H:" in ln]
    return lines[at[-1] + 1:at[-1] + 5] if at else []


def phase_install(torch, d, run=None):
    """The installed program on the card: the console script, started from
    a directory outside the checkout with no checkout on its path, builds
    its four libraries from the installed sources into the installed
    package and registers the dilate 1.2M pair (all five kernels), its
    export byte-equal to the checkout CLI's (``run``, cli_dilate_run's
    result, made here into ``d`` when the cli phase did not run)."""
    t_phase = time.perf_counter()
    run = run or cli_dilate_run(d)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp).resolve()
        check(ROOT not in tmp.parents, f"{tmp} lies in the checkout")
        t0 = time.perf_counter()
        wheel = build_wheel(copy_tree(tmp / "src"), tmp / "wheel")
        wheel_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bin_dir, sp = install_wheel(wheel, tmp / "prefix")
        install_s = time.perf_counter() - t0
        build_dir = sp / "simpleicp_tpu_torch" / "_build"
        check(not build_dir.exists() or not any(build_dir.iterdir()),
              f"the installed package's {build_dir} is not empty before the run")
        work = tmp / "work"
        work.mkdir()
        out = work / "out.xyz"
        rc, log, seconds, report = run_installed(
            bin_dir, dilate_cli_args(run["fix"], run["mov"], out), work)
        what = "installed dilate 1.2M"
        finished = check_cli_run(rc, log, what)
        check_installed(report, sp, what)
        built = {lib: sorted(p.name for p in build_dir.glob(f"lib{lib}-*.so"))
                 for lib in ("knn", "dilate", "solver", "native")}
        check(all(len(v) == 1 for v in built.values()), f"{what}: built {built}")
        check(set(report["build_s"]) == set(built),
              f"{what}: libraries built in its process {report['build_s']}")
        launches = report["launches"]
        check_dilate_launches(launches, what)
        check(out.read_bytes() == Path(run["out"]).read_bytes(),
              f"{what}: the export is not byte-equal to the checkout CLI's")
        check(h_rows(log) == h_rows(run["log"]) and len(h_rows(log)) == 4,
              f"{what}: H rows {h_rows(log)} against the checkout's {h_rows(run['log'])}")
        timing = cli_timings(log, what)
        wheel_name, wheel_bytes = wheel.name, wheel.stat().st_size
    emit({"phase": "install", "part": "dilate 1.2M", "command": "simpleicp-tpu-torch "
          f"-f fix.xyz -m mov.xyz -o {GATE_RADIUS} --export out.xyz (the console script "
          "of a wheel of the checkout, installed into a fresh venv)", "wheel": wheel_name,
          "wheel_bytes": wheel_bytes, "wheel_build_s": wheel_s, "install_s": install_s,
          "exit_code": rc, "wall_s": seconds, "finished_line": finished,
          "build_s": report["build_s"], "built": built, "cli_timing_s": timing,
          "launches": launches, "export_byte_equal": True,
          "checkout_wall_s": run["wall_s"], "checkout_cli_timing_s": run["timing"],
          "checkout_launches": run["launches"], "phase_s": time.perf_counter() - t_phase})
    return launches


# Serving: the 1.34M cell's fixed cloud as the map, and four movable scans
# of its surface, each under its own rigid motion. Two correspondence
# counts: the default, and the big-correspondence shape a preparation
# saves the most for (its k-NN is C x nf: 100 000 x 1.34M).
SERVE_MOVABLES = 4
SERVE_CS = (1000, 100_000)


def serve_clouds():
    """The 1.34M fixed cloud and SERVE_MOVABLES independent samples of its
    surface, each moved by a rigid motion drawn from the seed (angles up to
    0.03 rad, shifts up to 0.06). Returns (X_fix, [(X_mov, t), ...])."""
    import numpy as np

    rng = np.random.default_rng(SEED + 11)
    half = 2.0 * math.sqrt(N_SCALE / N_MAIN)
    X_fix = surface(rng, N_SCALE, half)
    movs = []
    for _ in range(SERVE_MOVABLES):
        a, t = rng.uniform(-0.03, 0.03, 3), rng.uniform(-0.06, 0.06, 3)
        movs.append(((surface(rng, N_SCALE, half) - t) @ rotation(a), t))
    return X_fix, movs


def compare_runs(torch, fns, reps=3):
    """``timed_runs`` of ``fns``, and all device launches and busy ms of one
    more run of each under torch.profiler."""
    rows, _ = timed_runs(torch, fns, reps)
    for label, fn in fns.items():
        _, _, events = traced(torch, fn)
        rows[label]["all_launches"] = len(events)
        rows[label]["device_busy_ms"] = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return rows


def check_same_result(torch, a, b, what):
    for f in a._fields:
        check(torch.equal(getattr(a, f), getattr(b, f)), f"{what}: {f} differs")


def check_serve_kernels(torch, cmp, prep, Xf, Xm, H, k, tag):
    """The k-NN and the match kernels against their plain versions at the
    preparation's own shapes: its C queries against the fixed cloud (k
    neighbours) and against the movable cloud under H. The kernels run on
    all C rows; a seeded sample of rows (the last block's rows among them)
    is held against the plain version, indices equal and d2 bit-equal.
    Each row's answer depends on no other row, so the plain version on a
    subset of queries is the reference for those rows."""
    import numpy as np

    from simpleicp_tpu_torch.ops import knn

    n0 = len(cmp.cases)
    n_q = prep.Q.shape[0]
    rows = np.random.default_rng(SEED + 12).choice(n_q - 1024, 3072, replace=False)
    rows = torch.as_tensor(np.concatenate([rows, np.arange(n_q - 1024, n_q)]),
                           device=prep.Q.device)
    Qs = prep.Q[rows].contiguous()
    shape = f"{n_q}x{Xf.shape[0]}, {rows.shape[0]} rows"
    d_k, i_k = knn.knn_search(prep.Q, Xf, k)
    torch.cuda.synchronize()
    d_p, i_p = knn.knn_search_plain(Qs, Xf, k)
    torch.cuda.synchronize()
    cmp.record("knn_search", f"float32 {tag} {shape} k={k}", d_k[rows], i_k[rows], d_p, i_p)
    d_k, i_k = knn.match_transform(prep.Q, Xm, H)
    torch.cuda.synchronize()
    d_p, i_p = knn.match_transform_plain(Qs, Xm, H)
    torch.cuda.synchronize()
    cmp.record("match_transform", f"float32 {tag} {shape}, final H",
               d_k[rows], i_k[rows], d_p, i_p)
    return cmp.since(n0)


def phase_serve(torch, cmp):
    """Serving on the card, float32: (1-2) prepare_fixed once on the 1.34M
    fixed cloud and the movable clouds registered against it, prepared and
    self-contained, at C=1000 and C=100 000, with a preparation through an
    npz file, and at C=100 000 the k-NN and the match kernels held against
    their plain versions at the preparation's shapes; (3) the warm start at
    C=100 000 on the 1.34M pair; (4) the gated warm start on the dilate
    1.2M pair. Returns each kernel's launches on the serving path."""
    import dataclasses

    from simpleicp_tpu_torch import IcpConfig, load_fixed_prep, prepare_fixed
    from simpleicp_tpu_torch.models.icp import _icp_register

    t_phase = time.perf_counter()
    dev, f32 = torch.device("cuda"), torch.float32
    X_fix, movs = serve_clouds()
    Xf = torch.as_tensor(X_fix, dtype=f32, device=dev)
    Xms = [torch.as_tensor(X, dtype=f32, device=dev) for X, _ in movs]
    motions = [t for _, t in movs]
    del movs

    def register(A, B, cfg, prep=None):
        return _icp_register(
            A, B, cfg, rbp_observed_values=None, rbp_observation_weights=None,
            normals_fix=None, planarity_fix=None, planarity_mov=None,
            fixed_prep=prep, device=dev, dtype=f32)

    none = {"match_transform": 0, "knn_search": 0, "nn_search": 0, "nn_search_d2": 0,
            "dilate": 0}
    out = {"phase": "serve", "n_fix": N_SCALE, "n_mov": N_SCALE,
           "input": "float32 tensors already on the card"}
    serve_launches = {}
    for C in SERVE_CS:
        cfg = IcpConfig(correspondences=C)
        tag = f"C={C}"
        prep, prep_s, prep_l, prep_reads = timed(
            torch, lambda: prepare_fixed(Xf, cfg, device=dev, dtype=f32))
        check(prep_l == {**none, "knn_search": 1},
              f"{tag}: prepare_fixed launched {prep_l}, expected one k-NN")
        pairs, first_own = [], None
        for i, (Xm, t) in enumerate(zip(Xms, motions)):
            (own, own_c), own_s, own_l, _ = timed(torch, lambda: register(Xf, Xm, cfg))
            (served, served_c), served_s, served_l, served_reads = timed(
                torch, lambda: register(Xf, Xm, cfg, prep))
            what = f"{tag} movable {i}"
            check_same_result(torch, served, own, f"{what}: prepared vs self-contained")
            check(torch.equal(served_c.m_idx, own_c.m_idx),
                  f"{what}: the last matches differ")
            n_it = int(served.n_iterations)
            check(served_l == {**none, "match_transform": n_it},
                  f"{what}: the prepared run launched {served_l}")
            check(own_l == {**none, "match_transform": n_it, "knn_search": 1},
                  f"{what}: the self-contained run launched {own_l}")
            pairs.append({"n_iterations": n_it,
                          "translation_err": check_recovery(served, t, what),
                          "bit_equal": True, "first_run_s": [own_s, served_s],
                          "prepared_host_reads": served_reads})
            if i == 0:
                first_own, first_H = own, served.H.to(f32)
                if C == SERVE_CS[0]:
                    serve_launches.update(match_transform=served_l["match_transform"],
                                          knn_search=prep_l["knn_search"])
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "prep.npz")
            prep.save(path)
            loaded = load_fixed_prep(path)
        for f, a, b in zip(prep._fields, prep, loaded):
            check(a == b if f in prep._fields[5:] else torch.equal(a, b),
                  f"{tag}: {f} differs after save and load")
        check_same_result(torch, register(Xf, Xms[0], cfg, loaded)[0], first_own,
                          f"{tag}: from the loaded preparation vs self-contained")
        kernel_vs_plain = (check_serve_kernels(torch, cmp, prep, Xf, Xms[0], first_H,
                                               cfg.neighbors, tag)
                           if C == SERVE_CS[-1] else [])
        prep_runs = [prep_s] + [timed(torch, lambda: prepare_fixed(Xf, cfg))[1]
                                for _ in range(2)]
        out[tag] = {
            "prepare_fixed": {"median_s": statistics.median(prep_runs), "runs_s": prep_runs,
                              "launches": prep_l, "host_reads": prep_reads},
            "registrations": pairs, "npz_round_trip_bit_equal": True,
            "kernel_vs_plain": kernel_vs_plain,
            "movable_0": compare_runs(torch, {
                "self_contained": lambda: register(Xf, Xms[0], cfg),
                "prepared": lambda: register(Xf, Xms[0], cfg, prep)}),
        }
        del prep, loaded, first_own, first_H

    def warm_vs_cold(A, B, cfg, what, t, X_fix=None, x_overlap=None):
        """The cold and the warm registration: both recover the motion, the
        warm one adopts its coarse seed and lands within 2e-4 of the cold H;
        the warm start's extra launches are a registration's worth."""
        warm_cfg = dataclasses.replace(cfg, warm_start=True)
        cold, _, cold_l, _ = timed(torch, lambda: register(A, B, cfg)[0])
        warm, _, warm_l, _ = timed(torch, lambda: register(A, B, warm_cfg)[0])
        row = {"n_iterations": {"cold": int(cold.n_iterations),
                                "warm": int(warm.n_iterations)},
               "translation_err": {"cold": check_recovery(cold, t, f"{what} cold"),
                                   "warm": check_recovery(warm, t, f"{what} warm")}}
        if X_fix is not None:
            row["selected_x_min"] = {
                "cold": check_overlap(cold, X_fix, x_overlap, f"{what} cold"),
                "warm": check_overlap(warm, X_fix, x_overlap, f"{what} warm")}
        dH = float((warm.H - cold.H).abs().max())
        check(dH <= 2e-4, f"{what}: warm H is {dH} from cold H (> 2e-4)")
        check(not torch.equal(warm.iter_ps[0], cold.iter_ps[0]),
              f"{what}: the warm run's first iteration equals the cold one's "
              "(coarse seed not adopted)")
        check(warm_l["knn_search"] == cold_l["knn_search"] + 1
              and warm_l["match_transform"] > int(warm.n_iterations),
              f"{what}: warm launches {warm_l} against cold {cold_l}")
        row["H_max_abs_diff"] = dH
        row["times"] = compare_runs(torch, {"cold": lambda: register(A, B, cfg),
                                            "warm": lambda: register(A, B, warm_cfg)})
        return row, warm_l

    def coarse_points(n, cfg):
        stride = -(-n // cfg.warm_start_points)
        return -(-n // stride)

    cfg_big = IcpConfig(correspondences=SERVE_CS[1])
    tag = f"warm_start_C={SERVE_CS[1]}"
    out[tag], _ = warm_vs_cold(Xf, Xms[0], cfg_big, tag, motions[0])
    out[tag]["coarse_pass"] = {
        "points": coarse_points(N_SCALE, cfg_big),
        "correspondences": min(SERVE_CS[1], cfg_big.warm_start_correspondences)}
    del Xf, Xms

    A, B, t, x0 = partial_pair(N_DILATE, SEED + 8, N_DILATE / N_MAIN)
    Af = torch.as_tensor(A, dtype=f32, device=dev)
    Bf = torch.as_tensor(B, dtype=f32, device=dev)
    gcfg = IcpConfig(max_overlap_distance=GATE_RADIUS)
    row, warm_l = warm_vs_cold(Af, Bf, gcfg, "gated warm start 1.2M", t, A, x0)
    check(warm_l["dilate"] == 1 and warm_l["nn_search_d2"] >= 2,
          f"gated warm start 1.2M: expected a brute-gated coarse pass and a "
          f"dilate-gated full pass, launched {warm_l}")
    row["coarse_pass"] = {"points": coarse_points(N_DILATE, gcfg), "gate": "brute"}
    out["gated_warm_start_1.2M"] = row
    serve_launches.update(nn_search=warm_l["nn_search"] + warm_l["nn_search_d2"],
                          dilate=warm_l["dilate"])
    for name in KERNELS:
        check(serve_launches[name] > 0, f"serve: the {name} kernel was not launched")
    out["kernel_launches_on_the_serving_path"] = serve_launches
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return serve_launches


# Batch mode: pairs of the 100k cell's size, each under its own rigid
# motion; ungated batches of 8 and 32 and a brute-gated batch of 8
# (partial-overlap pairs, 1e10 gate pairs each), C=1000.
BATCH_SIZES = (8, 32)
BATCH_GATED = 8


def batch_pairs(n_pairs, seed, gated=False):
    """n_pairs pairs of N_MAIN points: a fixed surface and an independent
    sample of it (over x shifted by 1, as partial_pair, when gated), moved
    by the pair's own rigid motion from the seed (angles up to 0.03 rad,
    shifts up to 0.06). Returns float64 (X_fix (B, n, 3), X_mov (B, n, 3),
    t (B, 3), x where the overlap starts)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fix, mov, ts = [], [], []
    for _ in range(n_pairs):
        a, t = rng.uniform(-0.03, 0.03, 3), rng.uniform(-0.06, 0.06, 3)
        X_fix = surface(rng, N_MAIN)
        S = surface(rng, N_MAIN)
        if gated:
            S[:, 0] += 1.0
            S[:, 2] = 0.3 * np.sin(2 * S[:, 0]) + 0.2 * np.cos(3 * S[:, 1])
        fix.append(X_fix)
        mov.append((S - t) @ rotation(a))
        ts.append(t)
    return np.stack(fix), np.stack(mov), np.stack(ts), -1.0


def pair_of(res, b):
    """Pair b of a batch result, as a one-pair result."""
    return type(res)(*(v[b] for v in res))


def check_batch_kernels(torch, cmp, res, Xf, Xm, cfg, tag):
    """The three batched kernels at the batch's own shapes, timed against
    one pair's launch (warm L2), and each bit-equal to its plain version on
    the whole batch and to its single-pair launch pair by pair: the match
    (B x C x nm, under the batch's final H), the k-NN (B x C x nf, k
    neighbours) and, gated, the 1-NN's d2-only mode
    (B x nf x nm, the gate's own call: the movable clouds under the initial
    H, here the identity)."""
    from simpleicp_tpu_torch.ops import knn

    n0 = len(cmp.cases)
    B, C = res.sel_idx.shape
    Q = torch.gather(Xf, 1, res.sel_idx.long()[..., None].expand(-1, -1, 3))
    H = res.H.to(Xf.dtype)
    calls = [("match_transform", f"{B} x {C} x {Xm.shape[1]}, final H",
              lambda: knn.match_transform(Q, Xm, H),
              lambda: knn.match_transform_plain(Q, Xm, H),
              lambda b: knn.match_transform(Q[b], Xm[b], H[b])),
             ("knn_search", f"{B} x {C} x {Xf.shape[1]}, k={cfg.neighbors}",
              lambda: knn.knn_search(Q, Xf, cfg.neighbors),
              lambda: knn.knn_search_plain(Q, Xf, cfg.neighbors),
              lambda b: knn.knn_search(Q[b], Xf[b], cfg.neighbors))]
    if cfg.overlap_enabled:
        calls.append(("nn_search", f"{B} x {Xf.shape[1]} x {Xm.shape[1]}, d2-only mode",
                      lambda: (knn.min_dist_sq(Xf, Xm), None),
                      lambda: (knn.nn_search_plain(Xf, Xm)[0], None),
                      lambda b: (knn.min_dist_sq(Xf[b], Xm[b]), None)))
    times = {}
    for kernel, shape, fn_k, fn_p, fn_1 in calls:
        # the batched call and pair 0's single call (the match and the
        # k-NN as CUDA-graph replays, as in `times`; the gate's longer
        # sweep with events)
        if kernel == "nn_search":
            times[kernel] = {"batch_ms": cuda_ms(torch, fn_k, 3),
                             "one_pair_ms": cuda_ms(torch, lambda: fn_1(0), 5)}
        else:
            times[kernel] = {"batch_ms": graph_ms(torch, fn_k, 10),
                             "one_pair_ms": graph_ms(torch, lambda: fn_1(0), 10)}
        d_k, i_k = fn_k()
        torch.cuda.synchronize()
        d_p, i_p = fn_p()
        torch.cuda.synchronize()
        cmp.record(kernel, f"float32 {tag} batch {shape}", d_k, i_k, d_p, i_p)
        singles = [fn_1(b) for b in range(B)]
        torch.cuda.synchronize()
        d_1 = torch.stack([d for d, _ in singles])
        i_1 = None if i_k is None else torch.stack([i for _, i in singles])
        cmp.record(kernel, f"float32 {tag} batch {shape}, against {B} single-pair launches",
                   d_k, i_k, d_1, i_1)
    return cmp.since(n0), times


def phase_batch(torch, cmp):
    """icp_register_batch on the card: float32 batches of 100k pairs (B=8
    and 32 ungated, B=8 brute-gated), each pair converged with its motion
    recovered; one launch of each kernel per batch call (the match once an
    iteration); the batched kernels bit-equal to their plain versions and
    to their single-pair launches at the batch's shapes; float64 batches
    equal to each pair's own icp_register on the card; wall time against B
    sequential registrations (medians of 3, in turns), launches, host reads,
    and all launches and device busy time (torch.profiler) of the batch and
    of one registration. Returns each kernel's launches in the B=8
    batches."""
    from simpleicp_tpu_torch import IcpConfig, icp_register_batch
    from simpleicp_tpu_torch.models.icp import _icp_register

    t_phase = time.perf_counter()
    dev, f32, f64 = torch.device("cuda"), torch.float32, torch.float64
    ungated = batch_pairs(max(BATCH_SIZES), SEED + 21)
    gated = batch_pairs(BATCH_GATED, SEED + 22, gated=True)
    out = {"phase": "batch", "n_fix": N_MAIN, "n_mov": N_MAIN, "correspondences": 1000,
           "input": "float32 tensors already on the card"}
    cases = [(f"B={B}", ungated, B, None) for B in BATCH_SIZES]
    cases.append((f"gated B={BATCH_GATED}", gated, BATCH_GATED, GATE_RADIUS))
    for tag, (A, M, ts, x0), B, gate in cases:
        cfg = (IcpConfig() if gate is None else IcpConfig(max_overlap_distance=gate))
        Xf = torch.as_tensor(A[:B], dtype=f32, device=dev)
        Xm = torch.as_tensor(M[:B], dtype=f32, device=dev)

        def batch():
            return icp_register_batch(Xf, Xm, cfg, device=dev, dtype=f32)

        def single(b):
            return _icp_register(
                Xf[b], Xm[b], cfg, rbp_observed_values=None, rbp_observation_weights=None,
                normals_fix=None, planarity_fix=None, planarity_mov=None, fixed_prep=None,
                device=dev, dtype=f32)[0]

        def sequential():
            return [single(b) for b in range(B)]

        res, first_s, launches, reads = timed(torch, batch)
        n_it = [int(v) for v in res.n_iterations.cpu()]
        errs = [check_recovery(pair_of(res, b), ts[b], f"batch {tag} pair {b}")
                for b in range(B)]
        if gate is not None:
            for b in range(B):
                check_overlap(pair_of(res, b), A[b], x0, f"batch {tag} pair {b}")
        want = {"match_transform": max(n_it), "knn_search": 1, "nn_search": 0,
                "nn_search_d2": 0 if gate is None else 1, "dilate": 0}
        check(launches == want, f"batch {tag}: launched {launches}, expected {want} "
              "(one launch of each kernel per batch call, the match once an iteration)")
        seq, _, seq_launches, seq_reads = timed(torch, sequential)
        rows, _ = timed_runs(torch, {"batch": batch, "sequential": sequential}, 3)
        row = {"n_iterations": n_it, "translation_err_max": max(errs),
               "sequential_n_iterations": [int(r.n_iterations) for r in seq],
               "batch": {**rows["batch"], "launches": launches, "first_run_s": first_s},
               "sequential": {**rows["sequential"], "launches": seq_launches,
                              "host_reads_total": seq_reads},
               "host_reads": {"batch": reads, "sequential": seq_reads}}
        # the batch, and one of the B sequential registrations (pair 0):
        # the profiler's own host cost grows with every event it records
        row["one_registration"] = {"n_iterations": n_it[0]}
        for label, fn in (("batch", batch), ("one_registration", lambda: single(0))):
            _, wall_ms, events = traced(torch, fn)
            row[label]["all_launches"] = len(events)
            row[label]["device_busy_ms"] = sum(e.time_range.elapsed_us() for e in events) / 1e3
            row[label]["traced_wall_ms"] = wall_ms
        row["registrations_per_s"] = {
            label: B / rows[label]["median_s"] for label in ("batch", "sequential")}
        row["speedup"] = rows["sequential"]["median_s"] / rows["batch"]["median_s"]
        # every batch's own shapes: at B=32 the k-NN's plan takes one chunk
        # (the scan writes the result, no merge) where at B=8 it takes two,
        # and the match gets fewer chunks a pair
        row["kernel_vs_plain"], row["kernel_times"] = check_batch_kernels(
            torch, cmp, res, Xf, Xm, cfg, tag)
        out[tag] = row
        del Xf, Xm, res, seq

    # float64 on the card: each pair of the batch against its own
    # icp_register (recorded, for the last matches of every pair)
    for tag, (A, M, _, _), gate in (("B=8", ungated, None),
                                    (f"gated B={BATCH_GATED}", gated, GATE_RADIUS)):
        # at most 30 iterations: a float64 pair may never meet the relative
        # criterion (check_recovery) and would run all 100, in the batch and
        # alone
        cfg = IcpConfig(record_trajectory=True, max_iterations=30, **(
            {} if gate is None else {"max_overlap_distance": gate}))
        Xf = torch.as_tensor(A[:BATCH_GATED], dtype=f64, device=dev)
        Xm = torch.as_tensor(M[:BATCH_GATED], dtype=f64, device=dev)
        res = icp_register_batch(Xf, Xm, cfg, device=dev, dtype=f64)
        dH = 0.0
        for b in range(BATCH_GATED):
            own, carry = _icp_register(
                Xf[b], Xm[b], cfg, rbp_observed_values=None, rbp_observation_weights=None,
                normals_fix=None, planarity_fix=None, planarity_mov=None, fixed_prep=None,
                device=dev, dtype=f64)
            one, what = pair_of(res, b), f"float64 batch {tag} pair {b}"
            n = int(one.n_iterations)
            check(n == int(own.n_iterations) and int(one.error_code) == int(own.error_code),
                  f"{what}: iterations or error code differ from its icp_register")
            check(int(one.error_code) == 0, f"{what}: error code {int(one.error_code)}")
            for f in ("sel_idx", "sel_valid", "iter_midx"):
                check(torch.equal(getattr(one, f), getattr(own, f)), f"{what}: {f} differs")
            check(torch.equal(one.iter_midx[n - 1], carry.m_idx),
                  f"{what}: the last matches differ")
            dH = max(dH, float((one.H - own.H).abs().max()))
        check(dH <= 1e-9, f"float64 batch {tag}: H differs from icp_register by {dH} > 1e-9")
        out[f"float64_{tag}_vs_icp_register"] = {
            "n_iterations": [int(v) for v in res.n_iterations.cpu()],
            "iterations_error_codes_selection_matches_equal": True, "H_max_abs_diff": dH}
        del Xf, Xm, res
    # each kernel's launches on the batch path: the B=8 batches' (the dilate
    # gate is refused in batch mode)
    ungated_l = out[f"B={BATCH_GATED}"]["batch"]["launches"]
    gated_l = out[f"gated B={BATCH_GATED}"]["batch"]["launches"]
    batch_launches = {"match_transform": ungated_l["match_transform"],
                      "knn_search": ungated_l["knn_search"],
                      "nn_search": gated_l["nn_search"] + gated_l["nn_search_d2"],
                      "dilate": ungated_l["dilate"] + gated_l["dilate"]}
    for name in ("match_transform", "knn_search", "nn_search"):
        check(batch_launches[name] > 0, f"batch: the {name} kernel was not launched")
    out["kernel_launches_on_the_batch_path"] = batch_launches
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return batch_launches


# The sharded registration (simpleicp_tpu_torch/parallel/): world 1 in this
# process over NCCL, world 2 as two processes sharing the one card over gloo
# (NCCL refuses two ranks on one device). Each case: (clouds, config
# kwargs); the clouds of the scale, gated, dilate and gated-100k cells.
SHARD_REPS = 3
SHARD_CLOUDS = {
    "1.34M": lambda: cloud_pair(N_SCALE, SEED + 2, area_scale=N_SCALE / N_MAIN)[:2],
    "gated 1M": lambda: partial_pair(N_GATE_BIG, SEED + 5, N_GATE_BIG / N_MAIN)[:2],
    "dilate 1.2M": lambda: partial_pair(N_DILATE, SEED + 8, N_DILATE / N_MAIN)[:2],
    "gated 100k": lambda: partial_pair(N_MAIN, SEED + 3)[:2],
}
SHARD_CASES = {
    "ungated 1.34M": ("1.34M", {}),
    "gated 1M ring": ("gated 1M", dict(max_overlap_distance=GATE_RADIUS)),
    "gated 1M allgather": ("gated 1M", dict(max_overlap_distance=GATE_RADIUS,
                                            gate_collective="allgather")),
    "dilate 1.2M": ("dilate 1.2M", dict(max_overlap_distance=GATE_RADIUS)),
    "prepared 1.34M": ("1.34M", {}),
    "gated 100k": ("gated 100k", dict(max_overlap_distance=GATE_RADIUS)),
    "gated 100k K=2": ("gated 100k", dict(max_overlap_distance=GATE_RADIUS,
                                          dispatch="chunked", chunk_iterations=2)),
    "grid 100k": ("gated 100k", dict(max_overlap_distance=GATE_RADIUS, gate_method="grid",
                                     match_method="grid")),
}
SHARD_WORLD1 = ("ungated 1.34M", "gated 1M ring", "gated 1M allgather", "dilate 1.2M",
                "prepared 1.34M", "gated 100k", "gated 100k K=2")
SHARD_WORLD2 = ("ungated 1.34M", "gated 1M ring", "grid 100k")
# Fields every rank must hold bit for bit (the replicated iteration record).
SHARD_FIELDS = ("H", "n_iterations", "error_code", "sel_idx", "sel_valid", "iter_counts",
                "iter_means", "iter_stds", "iter_ps")
SHARD_DEVICE = "cuda"
# The command line of a world-2 rank, after the interpreter.
SHARD_WORKER = [str(Path(__file__).resolve())]


def shard_clouds(cache, key):
    if key not in cache:
        cache[key] = SHARD_CLOUDS[key]()
    return cache[key]


def shard_run(case, clouds, mesh=None, prep=None):
    """One float32 registration of a sharded-phase case: on ``mesh`` with
    icp_register_sharded, or without it with icp_register (the single-card
    reference). Returns (result, final loop state)."""
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models.icp import _icp_register
    from simpleicp_tpu_torch.parallel.sharded import _icp_register_sharded

    import torch

    key, kw = SHARD_CASES[case]
    X_fix, X_mov = shard_clouds(clouds, key)
    args = dict(rbp_observed_values=None, rbp_observation_weights=None, normals_fix=None,
                planarity_fix=None, planarity_mov=None, fixed_prep=prep,
                device=SHARD_DEVICE, dtype=torch.float32)
    if mesh is None:
        return _icp_register(X_fix, X_mov, IcpConfig(**kw), **args)
    return _icp_register_sharded(X_fix, X_mov, IcpConfig(**kw), mesh=mesh, **args)


def shard_sync(torch):
    if SHARD_DEVICE == "cuda":
        torch.cuda.synchronize()


def shard_counted(torch, fn, mesh):
    """fn() with the kernel launches, host reads and the mesh's collective
    counts set to 0 just before and read just after."""
    from simpleicp_tpu_torch.utils import sync

    shard_sync(torch)
    reset_counts()
    sync.reset_host_reads()
    mesh.counts.clear()
    t0 = time.perf_counter()
    out = fn()
    shard_sync(torch)
    return out, {"seconds": time.perf_counter() - t0, "launches": read_counts(),
                 "host_reads": sync.host_reads(), "collectives": dict(mesh.counts)}


def shard_record(res, carry):
    """The fields a sharded run is compared on, on the host."""
    rec = {f: getattr(res, f).cpu().numpy() for f in SHARD_FIELDS}
    rec["m_idx"] = carry.m_idx.cpu().numpy()
    return rec


def shard_compare(got, ref, what):
    """A sharded run against the single-card run: iterations, error code,
    selection and last matches equal, H within 1e-6 (its max difference
    returned; 0 expected)."""
    import numpy as np

    for f in ("n_iterations", "error_code", "sel_idx", "sel_valid", "m_idx"):
        check(np.array_equal(got[f], ref[f]), f"sharded {what}: {f} differs from icp_register")
    dH = float(np.abs(got["H"].astype(np.float64) - ref["H"]).max())
    check(dH <= 1e-6, f"sharded {what}: H differs from icp_register by {dH} > 1e-6")
    return dH


def shard_launch_check(case, launches, n_it, rank=0):
    """The kernels of the case ran on this rank: the match once an iteration
    (none with the grid matcher), the k-NN once (none prepared), the gate's
    1-NN (d2-only) when brute-gated and in the dilate gate's band, the
    dilation on rank 0 of the dilate run."""
    grid = case.startswith("grid")
    want_match = 0 if grid else n_it
    check(launches["match_transform"] == want_match,
          f"sharded {case} rank {rank}: {launches['match_transform']} match launches, "
          f"expected {want_match}")
    want_knn = 0 if case.startswith("prepared") else 1
    check(launches["knn_search"] == want_knn,
          f"sharded {case} rank {rank}: {launches['knn_search']} k-NN launches")
    gated = case.startswith(("gated", "dilate"))  # the grid gate is no kernel
    check((launches["nn_search_d2"] > 0) == gated,
          f"sharded {case} rank {rank}: {launches['nn_search_d2']} d2-only 1-NN launches")
    if case.startswith("dilate"):
        check((launches["dilate"] > 0) == (rank == 0),
              f"sharded {case} rank {rank}: {launches['dilate']} dilate launches")


def sharded_world1(torch, clouds):
    """World 1 in this process over NCCL: every SHARD_WORLD1 case against
    the single-card run (medians of SHARD_REPS, in turns)."""
    import numpy as np

    from simpleicp_tpu_torch import IcpConfig, prepare_fixed
    from simpleicp_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    backend = "nccl" if SHARD_DEVICE == "cuda" else "gloo"
    check(mesh.size == 1 and mesh.rank == 0 and mesh.backend == backend,
          f"world 1: mesh {mesh.size} {mesh.rank} {mesh.backend}")
    out, refs, recs = {}, {}, {}
    for case in SHARD_WORLD1:
        prep = None
        if case.startswith("prepared"):
            X_fix = shard_clouds(clouds, SHARD_CASES[case][0])[0]
            prep = prepare_fixed(X_fix, IcpConfig(), device=SHARD_DEVICE, dtype=torch.float32)
        (res, carry), counted = shard_counted(
            torch, lambda: shard_run(case, clouds, mesh, prep), mesh)
        got = recs[case] = shard_record(res, carry)
        n_it = int(res.n_iterations)
        shard_launch_check(case, counted["launches"], n_it)
        rows, results = timed_runs(torch, {
            "single": lambda: shard_run(case, clouds, None, prep),
            "sharded": lambda: shard_run(case, clouds, mesh, prep)}, SHARD_REPS)
        ref = shard_record(*results["single"][0])
        refs[case] = ref
        for r in results["sharded"]:
            rec = shard_record(*r)
            check(all(np.array_equal(rec[f], got[f]) for f in got),
                  f"sharded {case}: runs of one world differ")
        dH = shard_compare(got, ref, f"world 1 {case}")
        loop = counted["collectives"].get("loop_collectives", 0)
        if case.startswith("prepared"):
            shard_compare(got, refs["ungated 1.34M"], "prepared against self-contained")
        out[case] = {
            "n_iterations": n_it, "error_code": int(res.error_code),
            "H_max_abs_diff_vs_icp_register": dH, "H_bit_equal": dH == 0.0,
            "single_median_s": rows["single"]["median_s"],
            "sharded_median_s": rows["sharded"]["median_s"],
            "single_runs_s": rows["single"]["runs_s"],
            "sharded_runs_s": rows["sharded"]["runs_s"],
            "single_launches": rows["single"]["launches"],
            "single_host_reads": rows["single"]["host_reads"][-1],
            **counted, "collectives_per_iteration": loop / max(n_it, 1)}
    mono, chunk = out["gated 100k"], out["gated 100k K=2"]
    check(all(np.array_equal(recs["gated 100k"][f], recs["gated 100k K=2"][f])
              for f in recs["gated 100k"]), "sharded chunked: differs from monolithic")
    check(chunk["host_reads"] == mono["host_reads"],
          f"sharded chunked: {chunk['host_reads']} host reads against {mono['host_reads']}")
    return out, refs


def sharded_worker(rank: int, spec_path: str) -> int:
    """One rank of world 2 (``chip_smoke.py --sharded-rank RANK SPEC``):
    initialize_multihost over gloo on the shared card, every case of the
    spec counted once and timed SHARD_REPS times, its records written to
    ``out_dir/rank{RANK}.npz`` and ``.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from simpleicp_tpu_torch.parallel import initialize_multihost, make_mesh

    global SHARD_DEVICE
    spec = json.loads(Path(spec_path).read_text())
    SHARD_DEVICE = spec["device"]
    initialize_multihost(f"localhost:{spec['port']}", spec["world"], rank, backend="gloo")
    mesh = make_mesh()
    check(mesh.multihost and mesh.rank == rank, "world 2: this rank's mesh")
    clouds, arrays, info = {}, {}, {}
    for case in spec["cases"]:
        dist.barrier()
        (res, carry), counted = shard_counted(torch, lambda: shard_run(case, clouds, mesh), mesh)
        runs = []
        for _ in range(spec["reps"]):
            dist.barrier()
            shard_sync(torch)
            t0 = time.perf_counter()
            shard_run(case, clouds, mesh)
            shard_sync(torch)
            runs.append(time.perf_counter() - t0)
        arrays.update({f"{case}/{k}": v for k, v in shard_record(res, carry).items()})
        info[case] = {**counted, "runs_s": runs, "median_s": statistics.median(runs)}
    dist.destroy_process_group()
    np.savez(Path(spec["out_dir"]) / f"rank{rank}.npz", **arrays)
    (Path(spec["out_dir"]) / f"rank{rank}.json").write_text(json.dumps(info))
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "simpleicp_tpu")]
    check(not bad, f"world 2 rank {rank} imported {bad}")
    return 0


def sharded_world2(torch, clouds, refs):
    """World 2: two processes on the one card, started through
    initialize_multihost over gloo (collectives staged through host
    memory). Each rank equal to the other bit for bit and to the
    single-card run (``refs``, or run here)."""
    import socket

    import numpy as np

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        spec = Path(tmp) / "spec.json"
        spec.write_text(json.dumps({"port": port, "world": 2, "out_dir": tmp,
                                    "cases": list(SHARD_WORLD2), "reps": SHARD_REPS,
                                    "device": SHARD_DEVICE}))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, *SHARD_WORKER,
                                   "--sharded-rank", str(r), str(spec)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"world 2 rank {r} failed:\n{log[-4000:]}")
        wall = time.perf_counter() - t0
        ranks = [np.load(Path(tmp) / f"rank{r}.npz") for r in range(2)]
        info = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(2)]
    out = {"processes_wall_s": wall}
    for case in SHARD_WORLD2:
        recs = [{k.split("/", 1)[1]: z[k] for k in z.files if k.startswith(case + "/")}
                for z in ranks]
        for f in recs[0]:
            check(np.array_equal(recs[0][f], recs[1][f]),
                  f"world 2 {case}: ranks differ in {f}")
        if case not in refs:
            refs[case] = shard_record(*shard_run(case, clouds))
        dH = shard_compare(recs[0], refs[case], f"world 2 {case}")
        n_it = int(recs[0]["n_iterations"])
        for r in range(2):
            shard_launch_check(case, info[r][case]["launches"], n_it, r)
        out[case] = {
            "n_iterations": n_it, "H_max_abs_diff_vs_icp_register": dH,
            "H_bit_equal": dH == 0.0, "ranks_bit_equal": True,
            "median_s": max(i[case]["median_s"] for i in info),
            "ranks": [{**i[case], "collectives_per_iteration":
                       i[case]["collectives"].get("loop_collectives", 0) / max(n_it, 1)}
                      for i in info]}
    return out


def phase_sharded(torch, smi_line):
    """The sharded registration on the card, float32: world 1 (NCCL, in
    this process) and world 2 (two processes on the one card, gloo), each
    run against icp_register on the card. Returns each kernel's launches
    on the sharded path (world 1's counted runs and both world-2 ranks)."""
    from simpleicp_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    clouds = {}
    world1, refs = launch.run(1, lambda: sharded_world1(torch, clouds), device=SHARD_DEVICE)[0]
    world2 = sharded_world2(torch, clouds, refs)
    launches = {name: 0 for name in KERNELS}
    rows = list(world1.values()) + [r for c in SHARD_WORLD2 for r in world2[c]["ranks"]]
    for row in rows:
        for name, n in row["launches"].items():
            launches["nn_search" if name.startswith("nn_search") else name] += n
    for name in KERNELS:
        check(launches[name] > 0, f"sharded: the {name} kernel was not launched")
    emit({"phase": "sharded", "nvidia_smi": smi_line,
          "note": ("world 2 is two processes sharing one card over gloo: its times "
                   "measure correctness and overhead, not scaling"),
          "world1_nccl_in_process": world1, "world2_gloo_two_processes": world2,
          "kernel_launches_on_the_sharded_path": launches,
          "phase_s": time.perf_counter() - t_phase})
    return launches


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


def graph_ms(torch, fn, reps, calls=20):
    """Mean device ms per call of a short kernel: ``calls`` calls captured in
    one CUDA graph, replayed ``reps`` times between two CUDA events after a
    warm-up replay. The wrappers' host work (checks, allocations, the
    ctypes call) runs once at capture, so a kernel shorter than that host
    work is timed on the device, not on the host: in a plain loop of calls
    (``cuda_ms``) the host, not the card, sets the pace."""
    fn()
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (reps * calls)


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


def nn_floor_ms(n_q, n_r, dtype_bytes):
    """The 1-NN's floor without fused multiply-adds (ms): 9 issues a pair
    (three subtractions, three multiplications, two additions, the running
    minimum) over 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz = 3.35e13
    lane slots a second in float32; in float64 the same 9 operations over
    the 64 FP64 lanes of each SM (1.67e13 a second)."""
    rate = 132 * 4 * 32 * 1.98e9 if dtype_bytes == 4 else 132 * 64 * 1.98e9
    return 1e3 * 9.0 * n_q * n_r / rate


def nn_times(torch, Q, R, dtype_bytes, reps, plain_reps=0):
    """Both 1-NN modes on one shape: ms of the d2-only mode (``ms``, the
    gates' mode) and of the index mode, beside the bound, the unfused
    floor and (with plain_reps) the plain version."""
    from simpleicp_tpu_torch.ops import knn

    b, by = bound_ms("nn_search", Q.shape[0], R.shape[0], dtype_bytes)
    out = {"shape": [Q.shape[0], R.shape[0]],
           "ms": cuda_ms(torch, lambda: knn.min_dist_sq(Q, R), reps),
           "index_ms": cuda_ms(torch, lambda: knn.nn_search(Q, R), reps),
           "bound_ms": b, "bound_by": by,
           "unfused_floor_ms": nn_floor_ms(Q.shape[0], R.shape[0], dtype_bytes),
           "library_ms": None}
    if plain_reps:
        out["plain_ms"] = cuda_ms(torch, lambda: knn.nn_search_plain(Q, R), plain_reps)
    return out


def knn_plans(torch, Q, R, k, reps):
    """The k-NN under the wrapper's plan and under other chunk counts
    (ms per call), to see the plan's cost model against the card."""
    from simpleicp_tpu_torch.ops import knn, knn_cuda

    resident = knn_cuda._resident(Q.device, Q.dtype, "knn32" if k <= 32 else "knn64")
    wave = knn_cuda._knn_waves(Q.device, Q.dtype, k)
    n_r = R.shape[0]
    chosen = knn_cuda._plan_knn_chunks(Q.shape[0], n_r, k, wave)
    out = {"resident_blocks": resident, "wave_blocks": wave, "plan": list(chosen),
           "ms_by_chunks": {}}
    saved = knn_cuda._plan_knn_chunks
    try:
        for c in sorted({1, 4, 8, 16, 24, 33, 48, 66, 132, 264, 528, chosen[1]}):
            plan = (-(-n_r // c), -(-n_r // -(-n_r // c)))
            knn_cuda._plan_knn_chunks = lambda *a, plan=plan: plan
            out["ms_by_chunks"][c] = graph_ms(torch, lambda: knn.knn_search(Q, R, k), reps)
    finally:
        knn_cuda._plan_knn_chunks = saved
    return out


def knn_match_shapes(torch, scale, X_fix, sel):
    """The match and the k-NN at the scale cell's own selection against its
    1.34M clouds, the k-NN at 100k x 100k (every point a query, as
    PointCloud.estimate_normals calls it; held bit-equal to the plain
    version there), and the k-NN's chunk-count sweep at 1000 x 100k."""
    import numpy as np

    from simpleicp_tpu_torch.ops import knn

    dev = torch.device("cuda")
    out = {}
    if scale is not None:
        Xf = torch.as_tensor(scale[0], dtype=torch.float32, device=dev)
        Xm = torch.as_tensor(scale[1], dtype=torch.float32, device=dev)
        Q = Xf[torch.as_tensor(scale[2], device=dev).long()].contiguous()
        H = random_rigid(torch, np.random.default_rng(SEED), torch.float32, dev)
        nq, nr = Q.shape[0], Xm.shape[0]
        rows = {}
        for name, fn, plain, reps in (
                ("match_transform", lambda: knn.match_transform(Q, Xm, H),
                 lambda: knn.match_transform_plain(Q, Xm, H), 20),
                ("knn_search", lambda: knn.knn_search(Q, Xf, 10),
                 lambda: knn.knn_search_plain(Q, Xf, 10), 10)):
            b, by = bound_ms(name, nq, nr, 4, k=10)
            rows[name] = {"shape": [nq, nr], "ms": graph_ms(torch, fn, reps),
                          "plain_ms": cuda_ms(torch, plain, 1), "bound_ms": b,
                          "bound_by": by, "unfused_floor_ms": nn_floor_ms(nq, nr, 4),
                          "library_ms": None}
        out["scale_1.34M"] = rows
        del Xf, Xm, Q
    Xf = torch.as_tensor(X_fix, dtype=torch.float32, device=dev)
    d_k, i_k = knn.knn_search(Xf, Xf, 10)
    d_p, i_p = knn.knn_search_plain(Xf, Xf, 10)
    check(torch.equal(d_k, d_p) and torch.equal(i_k, i_p),
          f"k-NN at {N_MAIN} x {N_MAIN}: differs from the plain version")
    b, by = bound_ms("knn_search", N_MAIN, N_MAIN, 4, k=10)
    out["knn_normals_100k"] = {"shape": [N_MAIN, N_MAIN], "bit_equal_to_plain": True,
                               "ms": cuda_ms(torch, lambda: knn.knn_search(Xf, Xf, 10), 5),
                               "bound_ms": b, "bound_by": by,
                               "unfused_floor_ms": nn_floor_ms(N_MAIN, N_MAIN, 4),
                               "library_ms": None}
    Q = Xf[torch.as_tensor(sel, device=dev)].contiguous()
    out["knn_plans_1000x100k"] = knn_plans(torch, Q, Xf, 10, 20)
    return out


def uniform_nn_plan(n_q, n_r, resident):
    """The uniform chunk plan that the match and k-NN kernels used before
    their redesign (about two waves of blocks, no chunk under the minimum)
    at the 1-NN's queries per block: the baseline of the whole-wave plan."""
    from simpleicp_tpu_torch.ops import knn_cuda

    q_blocks = -(-n_q // knn_cuda._NN_BLOCK)
    want = max(1, min(-(-n_r // knn_cuda._NN_MIN_CHUNK), -(-2 * resident // q_blocks)))
    chunk_len = -(-n_r // want)
    return chunk_len, -(-n_r // chunk_len)


def nn_plans(torch, Q, R, reps):
    """The d2-only 1-NN under the wrapper's chunk plan, which fills the
    resident blocks in whole waves (``waves``), and under the uniform plan
    (``uniform_nn_plan``), alternated twice: each plan, its share of the
    last wave's blocks in use, and its ms per call."""
    from simpleicp_tpu_torch.ops import knn, knn_cuda

    resident = knn_cuda._resident(Q.device, Q.dtype, "nn_d2")
    n_q, n_r = Q.shape[0], R.shape[0]
    q_blocks = -(-n_q // knn_cuda._NN_BLOCK)
    plans = {"waves": knn_cuda._plan_nn_chunks(n_q, n_r, resident),
             "uniform": uniform_nn_plan(n_q, n_r, resident)}
    out = {k: {"chunk_len": c, "n_chunks": n, "blocks": q_blocks * n,
               "waves": -(-q_blocks * n // resident), "ms": []}
           for k, (c, n) in plans.items()}
    saved = knn_cuda._plan_nn_chunks
    try:
        for _ in range(2):
            for k, plan in plans.items():
                knn_cuda._plan_nn_chunks = lambda *a, plan=plan: plan
                out[k]["ms"].append(cuda_ms(torch, lambda: knn.min_dist_sq(Q, R), reps))
    finally:
        knn_cuda._plan_nn_chunks = saved
    return {"resident_blocks": resident, **out}


def nn_block_cost(torch, reps):
    """The d2-only 1-NN's fixed cost of a block, in refs scanned (the
    comment of the chunk plan's _NN_WAVE_COST cites it): one query block
    per resident block against 262 144 random refs in c = 1 .. 1024
    chunks is c whole waves of the same pairs, so ms = A + B c, where A is the scan of the refs
    and B a block's fixed part and its share of the reduce pass; a block
    costs what B n_r / A refs cost."""
    import numpy as np

    from simpleicp_tpu_torch.ops import knn, knn_cuda

    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    dev = torch.device("cuda")
    resident = knn_cuda._resident(dev, torch.float32, "nn_d2")
    n_r = 262_144
    Q = torch.rand((resident * knn_cuda._NN_BLOCK, 3), generator=g, device=dev)
    R = torch.rand((n_r, 3), generator=g, device=dev)
    cs = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
    ms = []
    saved = knn_cuda._plan_nn_chunks
    try:
        for c in cs:
            knn_cuda._plan_nn_chunks = lambda *a, c=c: (n_r // c, c)
            ms.append(cuda_ms(torch, lambda: knn.min_dist_sq(Q, R), reps))
    finally:
        knn_cuda._plan_nn_chunks = saved
    B, A = np.polyfit(np.array(cs, float), np.array(ms), 1)
    return {"queries": Q.shape[0], "refs": n_r, "chunks": list(cs), "ms": ms,
            "fit_A_ms": float(A), "fit_B_ms_per_chunk": float(B),
            "block_cost_refs": float(B * n_r / A)}


# Hopper SM: 64 INT32 lanes; 132 SMs at the H100 SXM's 1.98 GHz boost clock
# (NVIDIA data sheet and Hopper white paper, 700 W). A lane issues one LOP3
# per clock: any boolean function of three 32-bit words, so up to two ORs.
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def dilate_bound_ms(n_words, stencil_sizes):
    """Least time (ms) an H100 SXM could take for one dilation: the larger
    of the bytes (the grid read once, each output grid written once, the
    (dx, dy) table read once) over 3.35 TB/s and the operations over the
    INT32 rate. An output word of a stencil of n entries ORs n words
    together: ceil((n - 1) / 2) three-input ORs (LOP3)."""
    n_entries = sum(stencil_sizes)
    nbytes = 4.0 * n_words * (1 + len(stencil_sizes)) + 8.0 * n_entries
    lop3 = sum(max(0, -(-(n - 1) // 2)) for n in stencil_sizes)
    t_bytes, t_ops = nbytes / 3.35e12, n_words * lop3 / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def gate_stages(torch, X_fix, X_mov):
    """Seconds of each stage of the dilate gate on one pair (the device
    synchronized at each stage's end), after a warm-up call."""
    from simpleicp_tpu_torch.ops.dilate_gate import (
        bbox_of,
        overlap_mask_dilate,
        plan_dilate_gate,
    )

    Xf, Xm0 = gate_inputs(torch, X_fix, X_mov)
    overlap_mask_dilate(Xf, Xm0, GATE_RADIUS, plan_of(Xm0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lo, hi = bbox_of(Xm0).cpu().numpy()
    t1 = time.perf_counter()
    plan = plan_dilate_gate(None, None, GATE_RADIUS, bbox=(lo, hi))
    t2 = time.perf_counter()
    stats = {}
    overlap_mask_dilate(Xf, Xm0, GATE_RADIUS, plan, stats=stats)
    t3 = time.perf_counter()
    return {"bbox_s": t1 - t0, "plan_s": t2 - t1,
            **{k: v for k, v in stats.items() if k.endswith("_s")},
            "gate_total_s": t3 - t0, "band": stats["band"],
            "refs_kept": stats["refs_kept"], "sweep": stats["sweep"]}


def slab_rates(torch):
    """The slab join cost model's two host rates on this machine: seconds
    per exact-sweep launch (a 512-point block against a 4 096-ref run:
    gathers, the 1-NN launch, the compare and the scatter), and numpy's
    stable argsort per element (1M float32 keys)."""
    import numpy as np

    from simpleicp_tpu_torch.ops import knn

    rng = np.random.default_rng(SEED + 30)
    Xf = torch.as_tensor(rng.random((100_000, 3)), dtype=torch.float32, device="cuda")
    R = torch.as_tensor(rng.random((100_000, 3)), dtype=torch.float32, device="cuda")
    q = torch.as_tensor(rng.choice(100_000, 512, replace=False), device="cuda")
    out = torch.zeros(100_000, dtype=torch.bool, device="cuda")
    r2 = torch.tensor(GATE_RADIUS, dtype=torch.float32, device="cuda") ** 2

    def block(j0):
        out[q] = knn.min_dist_sq(Xf[q], R[j0:j0 + 4096]) <= r2

    for j in range(5):
        block(j)
    torch.cuda.synchronize()
    n = 300
    t0 = time.perf_counter()
    for j in range(n):
        block(j * 100)
    torch.cuda.synchronize()
    call_s = (time.perf_counter() - t0) / n
    keys = rng.random(1_000_000).astype(np.float32)
    t0 = time.perf_counter()
    np.argsort(keys, kind="stable")
    sort_s = (time.perf_counter() - t0) / keys.size
    return {"call_s": call_s, "host_sort_s_per_element": sort_s}


# The solve kernel's operations a correspondence a Gauss-Newton step
# (csrc/solver.cu): the transform and residual 26, the Jacobian's three
# rotated columns 60, the weights 7, the 21 + 6 products and sums of the
# normal equations 54: ~150 float64 operations.
GN_OPS_PER_ROW = 150


def gn_inputs(torch, B, C, dtype, seed):
    """gn_solve's tensors on the card for B problems of C correspondences
    (as the ICP loop passes them: one iteration's matches on the wavy
    surface, its analytic normals, the movable side moved back by each
    problem's motion from the seed and noisy, 5 % rejected), p0 = 0, no
    observations; and the active mask (None for one problem)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (B, C, 2))
    xf = np.concatenate([xy, (0.3 * np.sin(2 * xy[..., 0])
                              + 0.2 * np.cos(3 * xy[..., 1]))[..., None]], -1)
    g = np.stack([-0.6 * np.cos(2 * xy[..., 0]), 0.6 * np.sin(3 * xy[..., 1]),
                  np.ones((B, C))], -1)
    n = g / np.linalg.norm(g, axis=-1, keepdims=True)
    motion = rng.uniform([-0.03] * 3 + [-0.05] * 3, [0.03] * 3 + [0.05] * 3, (B, 6))
    R = np.stack([rotation(m[:3]) for m in motion])
    xm = np.einsum("bcj,bji->bci", xf - motion[:, None, 3:], R)
    xm = xm + rng.normal(0, 1e-3, xm.shape)
    dev = torch.device("cuda")
    t = [torch.as_tensor(a, dtype=dtype, device=dev) for a in
         (np.zeros((B, 6)), xm, xf, n)]
    t += [torch.as_tensor(rng.random((B, C)) > 0.05, device=dev),
          torch.ones(B, dtype=dtype, device=dev), torch.zeros((B, 6), dtype=dtype, device=dev),
          torch.zeros((B, 6), dtype=dtype, device=dev)]
    return t, (None if B == 1 else torch.ones(B, dtype=torch.bool, device=dev))


def solver_times(torch):
    """The Gauss-Newton solve kernel (csrc/solver.cu) beside its plain
    version on the card, at the main path's C = 1000, one problem and a
    batch of 32, float32 and float64 coordinates (CUDA events, warm): the
    kernel in a host loop of calls and as CUDA-graph replays (its device
    time), the plain loop; the Gauss-Newton steps (the plain version's
    flag reads), the operation bound (GN_OPS_PER_ROW a correspondence a
    step over 34 TFLOP/s float64), the largest gap between the two
    versions' p and residuals; and the kernel's -Xptxas -v registers,
    stack and spills. Two launches on the same inputs are bit-equal."""
    from simpleicp_tpu_torch import _build
    from simpleicp_tpu_torch.models import solver
    from simpleicp_tpu_torch.utils import sync

    rows = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).replace("torch.", "")
        for B in (1, 32):
            t, act = gn_inputs(torch, B, 1000, dtype, SEED + B)
            k = solver.gn_solve(*t, active=act)
            again = solver.gn_solve(*t, active=act)
            sync.reset_host_reads()
            plain = solver.gn_solve_plain(*t, active=act)
            steps = sync.host_reads()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(k, again)),
                  f"gn_solve kernel {tag} B={B}: two launches differ")
            gap = [float((a.double() - b.double()).abs().max()) for a, b in zip(k[:2], plain[:2])]
            check(gap[0] <= (1e-12 if tag == "float64" else 1e-6),
                  f"gn_solve kernel {tag} B={B}: p differs from plain by {gap[0]}")
            rows[f"{tag} {B} x 1000"] = {
                "ms": graph_ms(torch, lambda: solver.gn_solve(*t, active=act), 20),
                "host_loop_ms": cuda_ms(torch, lambda: solver.gn_solve(*t, active=act), 100),
                "plain_ms": cuda_ms(torch, lambda: solver.gn_solve_plain(*t, active=act), 5),
                "steps": steps,
                "bound_ms": 1e3 * GN_OPS_PER_ROW * B * 1000 * max(steps, 1) / 34e12,
                "bound_by": "operations (the kernel is latency-bound)",
                "max_abs_gap_p_residuals": gap,
            }
    return {"kernel": "gn_solve", "route": "cuda", "source": "simpleicp_tpu_torch/csrc/solver.cu",
            "replaces": "no Pallas kernel: the JAX package's fused lax.while_loop "
                        "(simpleicp_tpu/models/solver.py gn_solve)",
            "ptxas": ptxas_table(_build.BUILD_LOGS.get("solver", "")), "shapes": rows}


# The uncertainty kernel's operations a correspondence (csrc/solver.cu
# uncertainty_kernel): the transform and residual 26, the Jacobian 60, the
# weights 7, the 21 products and sums of J^T P J 42, w r^2 and the count 4:
# ~140 float64 operations.
UNC_OPS_PER_ROW = 140


def uncertainty_times(torch):
    """The uncertainty kernel (csrc/solver.cu) beside its plain version on
    the card at the main path's C = 1000, one problem and a batch of 32,
    float32 and float64 coordinates, at the solve's final p (CUDA events,
    warm): the kernel as CUDA-graph replays (its device time) and in a host
    loop of calls, the plain version; the bound, the larger of the bytes
    bound (each input read once, each output written once, at 3.35 TB/s)
    and the operation bound (UNC_OPS_PER_ROW a correspondence over 34
    TFLOP/s float64); the largest gap between the two versions' sigma and
    Cxx, relative to each one's largest magnitude. Two launches on the same
    inputs are bit-equal."""
    from simpleicp_tpu_torch.models import solver

    rows = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).replace("torch.", "")
        for B in (1, 32):
            t, act = gn_inputs(torch, B, 1000, dtype, SEED + 100 + B)
            t[0] = solver.gn_solve(*t, active=act)[0]
            k = solver.estimate_uncertainties(*t)
            again = solver.estimate_uncertainties(*t)
            plain = solver.estimate_uncertainties_plain(*t)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(k[1:], again[1:]))
                  and torch.equal(k[0].nan_to_num(), again[0].nan_to_num()),
                  f"uncertainty kernel {tag} B={B}: two launches differ")
            gap = [float((a.double() - b.double()).abs().max() / b.double().abs().max())
                   for a, b in zip(k, plain)]
            check(max(gap) <= (1e-12 if tag == "float64" else 2.0**-23),
                  f"uncertainty kernel {tag} B={B}: differs from plain by {gap}")
            # xm, xf, n and the mask a row; p, dw, obs_vals, obs_w, sigma and
            # Cxx a problem
            nbytes = B * 1000 * (9 * t[1].element_size() + 1) + B * 61 * t[1].element_size()
            t_bytes, t_ops = nbytes / 3.35e12, UNC_OPS_PER_ROW * B * 1000 / 34e12
            rows[f"{tag} {B} x 1000"] = {
                "ms": graph_ms(torch, lambda: solver.estimate_uncertainties(*t), 20),
                "host_loop_ms": cuda_ms(torch, lambda: solver.estimate_uncertainties(*t), 100),
                "plain_ms": cuda_ms(torch, lambda: solver.estimate_uncertainties_plain(*t), 20),
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": ("operations" if t_ops >= t_bytes else "bytes")
                + " (the kernel is latency-bound)",
                "max_rel_gap_sigma_cxx": gap,
            }
    return {"kernel": "uncertainty_kernel", "route": "cuda",
            "source": "simpleicp_tpu_torch/csrc/solver.cu",
            "replaces": "no Pallas kernel: XLA's fusion of the JAX package's "
                        "estimate_uncertainties (simpleicp_tpu/models/solver.py)",
            "shapes": rows}


def phase_times(torch, scale, gated_big, cells, dil=None):
    import numpy as np

    from simpleicp_tpu_torch.ops import knn

    dev = torch.device("cuda")
    X_fix, X_mov, _ = cloud_pair(N_MAIN, SEED + 1)
    sel = np.round(np.linspace(0, N_MAIN - 1, 1000)).astype(np.int64)
    # about 0.3 s of the 1-NN first, so that no timing below starts on a
    # card whose clocks idled through the phases before (the CLI's
    # subprocess, the host-bound checks)
    Xw = torch.as_tensor(X_fix, dtype=torch.float32, device=dev)
    cuda_ms(torch, lambda: knn.min_dist_sq(Xw, Xw), 100)
    del Xw
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
            "ms": graph_ms(torch, lambda: knn.match_transform(Q, Xm, H), 10),
            "host_loop_ms": cuda_ms(torch, lambda: knn.match_transform(Q, Xm, H), 50),
            "plain_ms": cuda_ms(torch, lambda: knn.match_transform_plain(Q, Xm, H), 5),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "unfused_floor_ms": nn_floor_ms(1000, N_MAIN, size),
        }
        b, by = bound_ms("knn_search", 1000, N_MAIN, size, k=10)
        row["knn_search"] = {
            "ms": graph_ms(torch, lambda: knn.knn_search(Q, Xf, 10), 5),
            "host_loop_ms": cuda_ms(torch, lambda: knn.knn_search(Q, Xf, 10), 20),
            "plain_ms": cuda_ms(torch, lambda: knn.knn_search_plain(Q, Xf, 10), 3),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "unfused_floor_ms": nn_floor_ms(1000, N_MAIN, size),
            # each list size the kernel is compiled for (32: one slot a
            # lane, 64: two)
            "by_k": {k: graph_ms(torch, lambda: knn.knn_search(Q, Xf, k), 5)
                     for k in (32, 64)},
        }
        # the gate: every fixed point against the movable cloud
        row["nn_search"] = nn_times(torch, Xf, Xm, size, 10, plain_reps=2)
        if dtype == torch.float32:
            row["nn_search"]["chunk_plans"] = nn_plans(torch, Xf, Xm, 10)
        # the index mode's worst order: refs by decreasing distance from the
        # queries' centroid, so that each query's running best keeps falling
        Xw = Xm[torch.argsort(-((Xm - Xf.mean(0)) ** 2).sum(1))].contiguous()
        d_w, i_w = knn.nn_search(Xf, Xw)
        d_p, i_p = knn.nn_search_plain(Xf, Xw)
        check(torch.equal(d_w, d_p) and torch.equal(i_w, i_p),
              f"{tag} 1-NN index mode, refs by decreasing distance: differs from plain")
        row["nn_search"]["index_decreasing_order_ms"] = cuda_ms(
            torch, lambda: knn.nn_search(Xf, Xw), 10)
        kernels[tag] = row
    emit({"phase": "times", "what": f"kernels at 1000 x {N_MAIN} (k=10; by_k: k=32, 64), "
          f"the gate at {N_MAIN} x {N_MAIN} (the 1-NN: ms is the d2-only mode, index_ms the "
          "index mode); warm L2", "kernels": kernels})
    emit({"phase": "times", "what": "the Gauss-Newton solve kernel against its plain "
          "version (B problems x C=1000, warm)", **solver_times(torch)})
    emit({"phase": "times", "what": "the uncertainty kernel against its plain version "
          "(B problems x C=1000 at the solve's final p, warm)", **uncertainty_times(torch)})
    emit({"phase": "times", "what": "the k-NN and the match at more shapes (float32, k=10, "
          "warm L2): the scale cell's own selection, estimate_normals' all-points shape, "
          "the k-NN under other chunk counts",
          **knn_match_shapes(torch, scale, X_fix, sel)})

    nn_rate = None
    if gated_big is not None:
        Xf = torch.as_tensor(gated_big[0], dtype=torch.float32, device=dev)
        Xm = torch.as_tensor(gated_big[1], dtype=torch.float32, device=dev)
        big = nn_times(torch, Xf, Xm, 4, 3)
        nn_rate = N_GATE_BIG * N_GATE_BIG / (big["ms"] / 1e3)
        big["chunk_plans"] = nn_plans(torch, Xf, Xm, 2)
        emit({"phase": "times", "what": f"gate kernel at {N_GATE_BIG} x {N_GATE_BIG}, "
              "float32 (the gated 1M pair's own clouds); its d2-only mode under the "
              "whole-wave and the uniform chunk plans; a block's fixed cost",
              "nn_search": big, "d2_pairs_per_s": nn_rate,
              "nn_block_cost": nn_block_cost(torch, 5)})
        del Xf, Xm

    dilate_row = None
    if dil is not None:
        from simpleicp_tpu_torch.ops.dilate_gate import (
            _pack_occupancy_device,
            dilate_packed_multi,
            dilate_packed_multi_plain,
        )

        from simpleicp_tpu_torch.ops.dilate_gate import classify_queries

        Xf, Xm0 = gate_inputs(torch, *dil["clouds"])
        plan = plan_of(Xm0)
        # the 1-NN at the band sweep's own call: the band's fixed points
        # against the whole transformed movable cloud
        band = Xf[classify_queries(Xf, Xm0, plan=plan)[1]].contiguous()
        band_row = nn_times(torch, band, Xm0, 4, 5)
        band_row["chunk_plans"] = nn_plans(torch, band, Xm0, 5)
        occ = _pack_occupancy_device(Xm0, plan=plan).reshape(plan.wz, *plan.dims[:2])
        del Xf, Xm0, band
        rows = {}
        for label, st in (("IN+POSS", [plan.in_offsets, plan.poss_offsets]),
                          ("POSS", [plan.poss_offsets])):
            b, by = dilate_bound_ms(plan.n_words, [len(o) for o in st])
            rows[label] = {
                "ms": cuda_ms(torch, lambda: dilate_packed_multi(occ, st), 20),
                "plain_ms": cuda_ms(torch, lambda: dilate_packed_multi_plain(occ, st), 1),
                "bound_ms": b, "bound_by": by, "library_ms": None}
        del occ
        dilate_row = rows["IN+POSS"]
        slab = slab_rates(torch)
        slab["pairs_per_s"] = nn_rate
        emit({"phase": "times", "what": f"dilate kernel at the {N_DILATE} x {N_DILATE} "
              "pair's plan (warm L2); the 1-NN at "
              "the band sweep's shape; the gate's stages at 1.2M and 10M; the slab join "
              "cost model's rates (the pair rate: the d2-only 1-NN at the gated 1M pair)",
              "plan": plan_summary(plan), "dilate": rows, "nn_band_sweep": band_row,
              "gate_stages": {"1.2M": gate_stages(torch, *dil["clouds"]),
                              "10M": gate_stages(torch, *dil["clouds10M"])},
              "slab_cost_model": slab})

    reg = {}
    clouds = {"100k": (X_fix, X_mov, None, 5)}
    if scale is not None:
        clouds["1.34M"] = (*scale[:2], None, 3)
    if "gated" in cells:
        G = partial_pair(N_MAIN, SEED + 3)
        clouds["gated 100k"] = (G[0], G[1], GATE_RADIUS, 5)
    if gated_big is not None:
        clouds["gated 1M"] = (gated_big[0], gated_big[1], GATE_RADIUS, 3)
    if dil is not None:
        clouds["dilate 1.2M"] = (*dil["clouds"], GATE_RADIUS, 3)
    for label, (A, B, gate, reps) in clouds.items():
        Af = torch.as_tensor(A, dtype=torch.float32, device=dev)
        Bf = torch.as_tensor(B, dtype=torch.float32, device=dev)
        def run():
            return _register(torch, Af, Bf, torch.float32, "cuda", gate)[0]

        run()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        rows, results = timed_runs(torch, {label: run}, reps)
        reg[label] = {**rows[label],
                      "n_iterations": [int(r.n_iterations) for r in results[label]],
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "gate_radius": gate,
                      "input": "float32 tensors already on the card"}
    emit({"phase": "times", "what": "icp_register, default config (gated: "
          f"max_overlap_distance={GATE_RADIUS}, gate_method auto), float32",
          "registration": reg})
    return {**kernels["float32"], "dilate": dilate_row}


# Device-kernel names of each port kernel's two passes (no name is a
# substring of another).
KERNEL_NAMES = {"match_scan": "match_transform", "match_finish": "match_transform",
                "knn_scan": "knn_search", "knn_merge": "knn_search",
                "nn1_scan": "nn_search", "nn1_min_reduce": "nn_search",
                "nn1_arg_finish": "nn_search", "dilate_kernel": "dilate"}


# Device launches (kernels, copies, fills) of one float32 registration of
# the 100k cell (4 iterations), the Gauss-Newton loop one kernel launch an
# iteration and each iteration a replay of the loop's CUDA graph: 252
# kernels in the first iteration's graph, 264 in a later one's, each
# iteration's flag read, the eager launches around the loop, and the
# finish's uncertainties as one kernel launch. The profile counts 1 282
# after the main, gated, dilate and times phases (H100 80GB HBM3, 700 W);
# replayed_in_full checks the exact count.
LAUNCHES_100K = 1282
# Inputs of the loop's body a graphed registration copies into its entry's
# static buffers: Q, normals, planarity, sel_valid, obs_vals, obs_w, the
# planarity threshold, the noise floor and the movable cloud.
LOOP_INPUTS = 9


def phase_profile(torch, scale_clouds, gated_big, cells, dil=None):
    """Where the time of one float32 registration goes: host wall time,
    the device's busy time (sum of kernel durations; one stream, so they
    do not overlap) and idle share, the number of kernel launches, and the
    device time of the port's kernels against everything else."""
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
    if dil is not None:
        clouds["dilate 1.2M"] = (*dil["clouds"], GATE_RADIUS)
    out = {}
    for label, (A, B, gate) in clouds.items():
        Af = torch.as_tensor(A, dtype=torch.float32, device=dev)
        Bf = torch.as_tensor(B, dtype=torch.float32, device=dev)
        for _ in range(2):  # warm-up: a key's second registration captures its graphs
            _register(torch, Af, Bf, torch.float32, "cuda", gate)
        sync.reset_host_reads()
        (res, _), wall_ms, kernels = traced(
            torch, lambda: _register(torch, Af, Bf, torch.float32, "cuda", gate))
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
        if label == "100k":
            # one registration runs the batch's loop on a batch of one, with
            # no per-pair freezes and one solve launch an iteration: its
            # launches stay LAUNCHES_100K, within 2 %
            check(abs(len(kernels) - LAUNCHES_100K) <= 0.02 * LAUNCHES_100K,
                  f"profile 100k: {len(kernels)} launches, not within 2 % of "
                  f"{LAUNCHES_100K}")
        if gate is not None:
            check(port["nn_search"] > 0, f"profile {label}: no gate kernel traced")
        if label.startswith("dilate"):
            check(port["dilate"] > 0, f"profile {label}: no dilate kernel traced")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        out[label] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "kernel_launches": len(kernels), "host_reads": sync.host_reads(),
            "n_iterations": int(res.n_iterations),
            "port_kernels_ms": port,
            "top_device_ms": [[k, v[0], v[1]] for k, v in top],
        }
        if label == "100k":
            replayed_in_full(torch, res, len(kernels),
                             lambda: _register(torch, Af, Bf, torch.float32, "cuda", gate))
    emit({"phase": "profile", "what": "one float32 registration, default config "
          f"(gated: max_overlap_distance={GATE_RADIUS}, gate_method auto)", "cells": out})
    emit({"phase": "profile", "part": "trace", **trace_file(torch, X_fix, X_mov)})


def replayed_in_full(torch, res, graphed: int, fn):
    """The profiled registration ``res`` ran every iteration as a replay of
    the loop's graphs, and its trace holds every device operation of every
    replay: its ``graphed`` count of traced operations is that of the same
    registration with the body run eagerly, one launch an operation, plus
    the copies the graph's entry adds (the loop's inputs in, the carry in
    and out)."""
    import numpy as np

    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models import icp
    from simpleicp_tpu_torch.utils.profiling import recorded_counters

    n_it = int(res.n_iterations)
    loop = recorded_counters("icp.loop_graph")[-1][2]
    check(loop == {"captures": 0, "replays": n_it, "eager": 0},
          f"profile 100k: the loop ran {loop}, not {n_it} replays")
    engages = icp._loop_graph_engages
    icp._loop_graph_engages = lambda device, x: False
    try:
        (eager_res, _), _, events = traced(torch, fn)
    finally:
        icp._loop_graph_engages = engages
    check(int(eager_res.n_iterations) == n_it, "profile 100k: the eager run's iterations differ")
    carry = icp.make_carry_init(IcpConfig(), torch.float32, torch.zeros(1, 6),
                                torch.eye(4)[None], np.zeros(1, np.int32))
    copies = LOOP_INPUTS + 2 * len(icp._tensors(carry))
    check(graphed == len(events) + copies,
          f"profile 100k: {graphed} traced operations replayed, {len(events)} eager "
          f"+ {copies} copies expected")


def trace_file(torch, X_fix, X_mov):
    """One 100k registration under utils.profiling.trace: its Chrome trace
    must exist and name the match and k-NN kernels (their symbols in
    csrc/knn.cu) among its device events."""
    from simpleicp_tpu_torch.utils.profiling import trace

    dev = torch.device("cuda")
    Af = torch.as_tensor(X_fix, dtype=torch.float32, device=dev)
    Bf = torch.as_tensor(X_mov, dtype=torch.float32, device=dev)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with trace(d) as path:
            _register(torch, Af, Bf, torch.float32, "cuda")
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(os.path.isfile(path), f"trace() wrote no file at {path}")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    named = {sym: sum(sym in k for k in kernels) for sym in ("match_scan", "knn_scan")}
    check(all(named.values()), f"the trace names no {named} kernel "
          f"({len(kernels)} kernel events)")
    return {"path": path, "bytes": size, "events": len(events),
            "kernel_events": len(kernels), "port_kernel_events": named,
            "traced_run_s": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--sharded-rank", nargs=2, metavar=("RANK", "SPEC"),
                    help="run one rank of the sharded phase's world 2 (started by "
                         "the sharded phase itself)")
    ap.add_argument("--cli-counted", nargs=argparse.REMAINDER,
                    help="run python3 -m simpleicp_tpu_torch with these arguments "
                         "and print its kernel launches (started by the cli phase)")
    args = ap.parse_args(argv)
    if args.sharded_rank:
        return sharded_worker(int(args.sharded_rank[0]), args.sharded_rank[1])
    if args.cli_counted is not None:
        return cli_counted(args.cli_counted)
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

    smi_line = phase_device(torch)
    if "build" in phases:
        phase_build()
    cmp = Compare(torch)
    if "kernels" in phases:
        phase_kernels(torch, cmp)
    main_info = phase_main(torch) if "main" in phases else None
    scale = phase_scale(torch, cmp) if "scale" in phases else None
    scale_clouds = None if scale is None else scale[:2]
    gated_launches, gated_big = (phase_gated(torch, cmp) if "gated" in phases
                                 else (None, None))
    dil = phase_dilate(torch, cmp) if "dilate" in phases else None
    grid, bigc = phase_grid(torch, cmp, dil) if "grid" in phases else (None, None)
    chunked = phase_chunked(torch, dil, bigc) if "chunked" in phases else None
    del bigc
    if "policy" in phases:
        phase_policy(torch)
    errs = cmp.err if "kernels" in phases else None
    with tempfile.TemporaryDirectory() as cli_dir:
        cli = phase_cli(torch, cli_dir) if "cli" in phases else None
        installed = phase_install(torch, cli_dir, cli) if "install" in phases else None
    serve = phase_serve(torch, cmp) if "serve" in phases else None
    batch = phase_batch(torch, cmp) if "batch" in phases else None
    sharded = phase_sharded(torch, smi_line) if "sharded" in phases else None
    times = (phase_times(torch, scale, gated_big, phases, dil)
             if "times" in phases else None)
    if "profile" in phases:
        phase_profile(torch, scale_clouds, gated_big, phases, dil)

    if None not in (errs, main_info, gated_launches, times, dil):
        # Launches of each kernel in the run of its path: the ungated main
        # path for the match and k-NN kernels, the brute-gated path for the
        # 1-NN gate (both modes counted; the gate runs the d2-only one, whose
        # time is "ms"), the dilate-gated 1.2M registration for the dilation;
        # and on the serving path (serve_launches): the preparation's k-NN,
        # a prepared registration's matches, and the gated warm start's
        # 1-NN and dilation; and on the batch path (batch_launches): the
        # B=8 batches' match, k-NN and 1-NN (the dilate gate is refused in
        # batch mode); and on the sharded path (sharded_launches): world 1's
        # counted runs and both world-2 ranks; and on the grid path (grid_launches): the big-C
        # grid-matched registration's k-NN (its matcher and gate are the
        # grid engines, PyTorch operations); and on the chunked path
        # (chunked_launches): every kernel over the chunked phase's runs
        # (the 1-NN's two modes summed); and on the CLI's path
        # (cli_launches): the dilate 1.2M CLI run, in its own process; and
        # on the installed program's (install_launches): the installed
        # console script's run of that pair.
        modes = {"d2_only": gated_launches["nn_search_d2"], "index": gated_launches["nn_search"]}
        launches = {**main_info[0], "nn_search": sum(modes.values()),
                    "dilate": dil["launches"]["dilate"]}
        # Only this run's measurements and the computed bound: the floor and
        # the shapes stay in the `times` lines.
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        nn_keys = ("index_ms", "index_decreasing_order_ms")
        emit({"kernels": [
            {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": REPLACES[name], "launches": launches[name],
             "max_abs_err": errs[name], **{k: times[name][k] for k in keys},
             **({**{k: times[name][k] for k in nn_keys}, "launches_by_mode": modes}
                if name == "nn_search" else {}),
             **({} if serve is None else {"serve_launches": serve[name]}),
             **({} if batch is None else {"batch_launches": batch.get(name, 0)}),
             **({} if sharded is None else {"sharded_launches": sharded[name]}),
             **({} if grid is None else {"grid_launches": grid.get(name, 0)}),
             **({} if cli is None else {"cli_launches": cli["launches"][name] + (
                 cli["launches"]["nn_search_d2"] if name == "nn_search" else 0)}),
             **({} if installed is None else {"install_launches": installed[name] + (
                 installed["nn_search_d2"] if name == "nn_search" else 0)}),
             **({} if chunked is None else {"chunked_launches": chunked.get(name, 0) + (
                 chunked.get("nn_search_d2", 0) if name == "nn_search" else 0)})}
            for name in KERNELS
        ]})
    check("jax" not in sys.modules, "JAX was imported during the run")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
