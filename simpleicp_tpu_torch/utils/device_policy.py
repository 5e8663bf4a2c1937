"""Cost model of a registration on the card and on the host CPU, and the
CLI's size-based device routing.

The port's copy of the JAX package's ``utils/device_policy.py``, under its
names, with the card's own rates. Two users:

  * the dispatch planner of ``icp_register`` and ``prepare_fixed``
    (``models/icp.py`` ``_plan_dispatch``): ``estimate_gpu_stage_seconds``
    prices the gate, the normals k-NN, the grid matcher's build and one
    iteration in card seconds, against ``IcpConfig.program_budget_s``;
  * the CLI's ``--device auto`` (``resolve_device``): a registration whose
    plain versions on the host CPU are estimated to take less than the
    card's fixed cost in a fresh process runs on the CPU.

Every rate below was measured by ``chip_smoke.py`` on an NVIDIA H100 80GB
HBM3 at a 700 W power limit (the card's rates) and on the host CPU of
that machine (8 cores; the CPU rates), and is kept a little below the
measurement as a margin; the ``policy`` phase re-measures each and fails
when one is off by more than a factor of 2.

``estimate_gpu_program_seconds`` and ``probe_until_healthy`` have no
caller in the port: they are kept, with their tests, as counterparts of
the JAX package's functions of those names (the planner prices stages
with ``estimate_gpu_stage_seconds``; a chunked run waits with
``models/icp.py`` ``_wait_for_healthy_window``).

The JAX package's ``apply_device`` has no counterpart: it latches the JAX
platform for the process, and the port passes ``device=`` to every entry
point instead. No route ever falls back from the card to the CPU silently:
a route to the card without one raises (``utils/device.resolve``), and only
an explicit ``--device auto`` reroutes a job whose card fails its health
probe.
"""

from __future__ import annotations

import math

# ---- the card (NVIDIA H100 80GB HBM3, 700 W) ----
# Exact 1-NN distance sweeps (the brute gate, the match kernel): 1.25e12
# pairs in 378.5 ms (the match at 100 000 x 12.5M) and 1e12 in 302.4 ms
# (the 1-NN at 1M x 1M): 3.3e12 pairs/s (chip_smoke.py grid and times;
# 3.32e12 at 100 000 x 5M, chip_smoke.py policy).
GPU_SWEEP_PAIRS_PER_SEC = 3.0e12
# The k=10 k-NN (the normals): 100 000 x 12.5M in 546.2 ms, 2.29e12
# pairs/s (chip_smoke.py grid; 2.23e12 at 100 000 x 5M, policy). Its
# cost grows about with k.
GPU_KNN10_PAIRS_PER_SEC = 2.0e12
# Gathered coordinates of the grid engines (27 cells x cap slots x 3 a
# query): the grid match's 130M slots in 10.18 ms and the 10M grid gate's
# 27 x 152 slots a query in 2.97 s, 3.8e10-4.1e10 elements/s (chip_smoke.py
# grid and policy).
GPU_GATHER_ELEMS_PER_SEC = 3.5e10
# The grid build (one stable sort of the hash slots, with its cap's read):
# 12.5M points in 36.9 ms, 3.4e8 points/s (chip_smoke.py grid and policy).
GPU_SORT_ELEMS_PER_SEC = 2.5e8

# ---- the host CPU of the card's machine (8 cores; the plain versions) ----
# The d2-only 1-NN of the brute gate (``ops/knn.py`` ``min_dist_sq`` on
# CPU tensors), the k=10 k-NN and the match, each at 2000 x 200 000:
# 1.05e8-1.41e8, 3.48e7-4.06e7 and 1.09e8-1.42e8 pairs/s (chip_smoke.py
# policy, three runs).
CPU_GATE_PAIRS_PER_SEC = 1.0e8
CPU_KNN10_PAIRS_PER_SEC = 3.3e7
CPU_LOOP_PAIRS_PER_SEC = 1.1e8
# Route to the CPU below this many estimated CPU seconds: what "auto"
# pays before a job on the card would alone take longer. That is the
# health probe (a fresh process that imports torch, starts CUDA and runs
# one matmul: medians of 3 7.85 s and 6.32 s in two runs) plus the
# card's one-time cost in the job's own process (CUDA start-up, loading
# the built kernels, the first launches: its first 2000-point
# registration, CUDA's initialisation included, took 0.90-1.83 s longer
# than its second, medians 0.96-1.17 s of 3 processes in four runs):
# 8.92 s and 7.28 s in all (chip_smoke.py policy). The constant lies
# between the two.
CPU_ROUTE_MAX_SEC = 8.0
# Typical iteration count of a converging registration.
_TYPICAL_ITERATIONS = 10


def estimate_cpu_seconds(
    nf: int,
    nm: int,
    *,
    correspondences: int = 1000,
    neighbors: int = 10,
    max_overlap_distance: float = math.inf,
    max_iterations: int = 100,
) -> float:
    """Estimated seconds of one registration on the host CPU (the plain
    versions): the brute gate when the gate is on, the normals k-NN and
    the typical number of match iterations, each at its measured rate."""
    c = min(correspondences, nf)
    gate = float(nf) * nm if math.isfinite(max_overlap_distance) and max_overlap_distance > 0 else 0.0
    knn = float(c) * nf * max(neighbors, 1) / 10.0
    loop = float(c) * nm * min(_TYPICAL_ITERATIONS, max_iterations)
    return (gate / CPU_GATE_PAIRS_PER_SEC + knn / CPU_KNN10_PAIRS_PER_SEC
            + loop / CPU_LOOP_PAIRS_PER_SEC)


def estimate_gpu_stage_seconds(
    nf: int,
    nm: int,
    *,
    correspondences: int = 1000,
    neighbors: int = 10,
    gate_pairs: float = 0.0,
    match_method: str = "brute",
    match_cell_cap: int = 0,
    has_normals: bool = False,
) -> tuple:
    """(gate_seconds, knn_seconds, build_seconds, per_iteration_seconds)
    of a registration on the card.

    The prologue is the brute gate's ``gate_pairs`` (0 for the dilate and
    grid gates), the normals k-NN (none when normals are given or
    prepared) and the grid matcher's one-time cell-list build; one
    iteration is one match, a sweep of C x nm pairs or 27 cells x cap
    slots x 3 coordinates a query. The k-NN is the piece the planner can
    split into query blocks."""
    c = min(correspondences, nf)
    gate_s = gate_pairs / GPU_SWEEP_PAIRS_PER_SEC
    knn_rate = GPU_KNN10_PAIRS_PER_SEC * (10.0 / max(neighbors, 1))
    knn_s = 0.0 if has_normals else float(c) * nf / knn_rate
    grid = match_method == "grid"
    build_s = float(nm) / GPU_SORT_ELEMS_PER_SEC if grid else 0.0
    if grid:
        per_iter = float(c) * 27.0 * max(match_cell_cap, 1) * 3.0 / GPU_GATHER_ELEMS_PER_SEC
    else:
        per_iter = float(c) * nm / GPU_SWEEP_PAIRS_PER_SEC
    return gate_s, knn_s, build_s, per_iter


def estimate_gpu_program_seconds(
    nf: int,
    nm: int,
    *,
    correspondences: int = 1000,
    gate_pairs: float = 0.0,
    match_method: str = "brute",
    match_cell_cap: int = 0,
    iterations: int = _TYPICAL_ITERATIONS,
) -> float:
    """Card seconds of one whole registration: the prologue's stages and
    ``iterations`` matches."""
    gate_s, knn_s, build_s, per_iter = estimate_gpu_stage_seconds(
        nf, nm, correspondences=correspondences, gate_pairs=gate_pairs,
        match_method=match_method, match_cell_cap=match_cell_cap,
    )
    return gate_s + knn_s + build_s + iterations * per_iter


def resolve_device(
    choice: str,
    nf: int,
    nm: int,
    *,
    correspondences: int = 1000,
    neighbors: int = 10,
    max_overlap_distance: float = math.inf,
    max_iterations: int = 100,
    sharded: bool = False,
) -> str:
    """A ``--device`` choice as "cpu" or "cuda". "auto" routes a job whose
    estimated CPU time is at most ``CPU_ROUTE_MAX_SEC`` to the CPU and any
    other to the card; a sharded run keeps the card."""
    if choice == "cpu":
        return "cpu"
    if choice == "cuda" or sharded:
        return "cuda"
    if choice != "auto":
        raise ValueError(f"unknown device choice: {choice!r}")
    sec = estimate_cpu_seconds(
        nf, nm, correspondences=correspondences, neighbors=neighbors,
        max_overlap_distance=max_overlap_distance, max_iterations=max_iterations,
    )
    return "cpu" if sec <= CPU_ROUTE_MAX_SEC else "cuda"


# A card that fails its probe sends an "auto" job to the CPU when the job is
# estimated under this many CPU seconds; a larger job proceeds on the card.
DEGRADED_CPU_FALLBACK_MAX_S = 3600.0


def probe_default_backend(timeout_s: float = 120.0) -> tuple:
    """Health probe of the card, in a subprocess under a timeout: a
    fresh-shape matmul on the card with its result read back. A subprocess,
    so that a hung card cannot hang the caller.

    Returns (status, backend, seconds): status "ok", "timeout" or "error";
    backend "cuda" when the probe ran there, "" otherwise."""
    import random
    import subprocess
    import sys
    import time

    n = 517 + random.randrange(256)
    code = (
        "import torch\n"
        f"x = torch.ones(({n}, 331), device='cuda')\n"
        "(x @ x.T).cpu()\n"
        "print('PROBE', x.device.type)\n"
    )
    t0 = time.monotonic()
    try:
        r = subprocess.run([sys.executable, "-c", code], timeout=timeout_s,
                           capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return "timeout", "", timeout_s
    dt = time.monotonic() - t0
    backend = ""
    for line in (r.stdout or "").splitlines():
        if line.startswith("PROBE "):
            backend = line.split()[1]
    return ("ok" if r.returncode == 0 else "error"), backend, dt


def degraded_fallback(choice: str, probe_status: str, cpu_est_s: float) -> tuple:
    """The route after a health probe: (resolved, message). A failed probe
    ("timeout" or "error") sends an explicit ``--device auto`` job of at
    most ``DEGRADED_CPU_FALLBACK_MAX_S`` estimated CPU seconds to the CPU;
    ``--device cuda``, and a larger job, proceed on the card. The message
    is set whenever the probe failed."""
    if probe_status == "ok":
        return "cuda", None
    why = ("did not answer a fresh-shape probe" if probe_status == "timeout"
           else "failed a fresh-shape probe")
    if choice == "auto" and cpu_est_s <= DEGRADED_CPU_FALLBACK_MAX_S:
        return "cpu", (
            f"the card {why}; routing this registration to the CPU "
            f"(estimated ~{cpu_est_s:.0f} s there). Use --device cuda to "
            "run on the card instead."
        )
    return "cuda", (
        f"the card {why}; proceeding on it anyway"
        + (" (--device cuda)" if choice != "auto" else
           f" (job too large for the CPU: ~{cpu_est_s:.0f} s estimated there)")
    )


def probe_until_healthy(timeout_s: float = 120.0, budget_s: float = 1200.0,
                        sleep_s: float = 60.0) -> bool:
    """``probe_default_backend`` every ``sleep_s`` seconds until it answers
    "ok" or ``budget_s`` has passed; whether the last probe was healthy."""
    import time

    deadline = time.monotonic() + budget_s
    while True:
        st, _backend, psec = probe_default_backend(timeout_s)
        print(f"  probe: {st} in {psec:.1f} s", flush=True)
        if st == "ok" or time.monotonic() > deadline:
            return st == "ok"
        time.sleep(sleep_s)
