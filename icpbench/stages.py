#!/usr/bin/env python3
"""Where a cell's registrations spend their time, stage by stage: the
traced run of one cell, with its profile read by the program's spans.

    python3 icpbench/stages.py --workload dragon.pairs --seed 7 --seconds 5

It runs the cell as ``run.py --trace 1`` does (``run.run_cell``), keeps the
profile of the calls traced after the window, and reads it on the
profiler's clock, where the program's spans (``icp.*``, host operations of
the profile), the runtime's launch calls and the card's operations lie
together. Standard error gets one line,

    icpbench: stages <span>=<wall_ms>/<self_ms>/<launches>/<host_reads>/<idle_ms> ...

per pair for each span: its wall, its self time (the wall less what its
child spans cover), the runtime's launch calls inside it, the counted reads
back to the host (``icp.host_read`` spans) inside it, and the card's idle
time in the gaps whose middle falls in it as the innermost span. The last
line of standard output is one JSON object: that table (with each span's
count a pair), the traced run's metrics, how far the spans cover the calls,
and the profiled calls' wall.
A program without spans gives an empty table.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from icpbench import run, spec, trace as tr  # noqa: E402
from icpbench.trace import CALL_SPAN, _label_gaps, _union  # noqa: E402

# The runtime calls that put an operation on the card's queue.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cudaMemcpyAsync", "cudaMemsetAsync")
# The registration's stages one call holds once (utils/profiling.py SPANS).
CALL_STAGES = ("icp.plan", "icp.gate", "icp.select", "icp.normals", "icp.loop", "icp.finish")
OUTSIDE = "(python, between operations)"


def _length(iv: np.ndarray) -> float:
    u = _union(iv.reshape(-1, 2))
    return float((u[:, 1] - u[:, 0]).sum()) if len(u) else 0.0


def _inside(points: np.ndarray, iv: np.ndarray) -> np.ndarray:
    """Which of ``points`` lie inside the union of the intervals ``iv``."""
    u = _union(iv.reshape(-1, 2))
    if len(u) == 0:
        return np.zeros(len(points), bool)
    k = np.searchsorted(u[:, 0], points, side="right") - 1
    return (k >= 0) & (points <= u[np.maximum(k, 0), 1])


def stage_table(dev: List[tuple], host: List[tuple], pairs: int, names=None) -> Dict:
    """The per-pair table of the program's spans and the coverage checks
    from one profile (``trace.profile_calls``'s device and host
    operations, (name, start_us, end_us))."""
    calls = np.array([[s, e] for n, s, e in host if n == CALL_SPAN]).reshape(-1, 2)
    lo, hi = calls[:, 0].min(), calls[:, 1].max()
    spans = [h for h in host if h[0].startswith("icp.") and h[2] > lo and h[1] < hi]
    mirrors = sum(1 for d in dev if d[0].startswith("icp."))
    dev = [d for d in dev if d[2] > lo and d[1] < hi and d[0] != CALL_SPAN
           and not d[0].startswith("icp.")]
    busy = _union(np.clip(np.array([[s, e] for _, s, e in dev],
                                   dtype=np.float64).reshape(-1, 2), lo, hi))
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    idle_by: Dict[str, float] = {}
    for label, (s, e) in zip(_label_gaps(gaps, spans) if len(gaps) else [], gaps):
        idle_by[label] = idle_by.get(label, 0.0) + (e - s)
    launches = np.array(sorted(s for n, s, _ in host if n in LAUNCH_CALLS))
    reads = np.array(sorted(s for n, s, _ in spans if n == "icp.host_read"))

    iv_of = {n: np.array([[s, e] for m, s, e in spans if m == n]).reshape(-1, 2)
             for n in {sp[0] for sp in spans}}
    all_iv = np.array([[s, e] for _, s, e in spans]).reshape(-1, 2)
    order = names or sorted(iv_of, key=lambda n: iv_of[n][:, 0].min())
    table = {}
    for name in order:
        iv = iv_of.get(name)
        if iv is None:
            continue
        child = 0.0
        for s, e in iv:
            held = (all_iv[:, 0] >= s) & (all_iv[:, 1] <= e) & ~((all_iv[:, 0] == s)
                                                                 & (all_iv[:, 1] == e))
            child += _length(all_iv[held])
        wall = _length(iv)
        table[name] = {
            "count": len(iv) / pairs,
            "wall_ms": wall / 1e3 / pairs,
            "self_ms": (float((iv[:, 1] - iv[:, 0]).sum()) - child) / 1e3 / pairs,
            "launches": int(_inside(launches, iv).sum()) / pairs,
            "host_reads": int(_inside(reads, iv).sum()) / pairs,
            "idle_ms": idle_by.get(name, 0.0) / 1e3 / pairs,
        }
    idle = sum(idle_by.values())
    checks = {"device_ops_per_pair": len(dev) / pairs,
              "launches_per_pair": int(_inside(launches, calls).sum()) / pairs,
              "call_ms": float((calls[:, 1] - calls[:, 0]).mean()) / 1e3,
              "span_mirrors_on_device": mirrors,
              "idle_outside_spans": idle_by.get(OUTSIDE, 0.0) / idle if idle else None}
    if "icp.register" in iv_of:
        reg = iv_of["icp.register"]
        stages = np.concatenate([iv_of[n] for n in CALL_STAGES if n in iv_of])
        reg_len = _length(reg)
        checks.update(
            register_launches_per_pair=int(_inside(launches, reg).sum()) / pairs,
            stages_cover_register=_length(stages) / reg_len,
            register_covers_call=reg_len / _length(calls))
    return {"stages": table, "checks": checks}


def run_stages(cell, *, seed: int, seconds: float, device: str = "cuda", program=None):
    """The traced run of ``cell`` (``run.run_cell``) and the stage table of
    its profile: (the run's result object, ``stage_table``'s)."""
    kept = {}
    profile_calls = tr.profile_calls

    def keep(*a, **k):
        kept["ops"] = profile_calls(*a, **k)
        return kept["ops"]

    tr.profile_calls = keep
    try:
        out, r, _ = run.run_cell(cell, seed=seed, seconds=seconds, trace=True,
                                 device=device, program=program)
    finally:
        tr.profile_calls = profile_calls
    try:
        from simpleicp_tpu_torch.utils.profiling import SPANS as names
    except ImportError:
        names = None
    _, dev, host = kept["ops"]
    return out, stage_table(dev, host, r.traced_pairs, names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print(f"icpbench: {cell.name} needs a CUDA card", file=sys.stderr)
        return 2
    out, got = run_stages(cell, seed=args.seed, seconds=args.seconds)
    print("icpbench: stages " + " ".join(
        f"{n}={v['wall_ms']:.3f}/{v['self_ms']:.3f}/{v['launches']:.1f}/"
        f"{v['host_reads']:.2f}/{v['idle_ms']:.3f}" for n, v in got["stages"].items()),
        file=sys.stderr)
    print(json.dumps({"workload": cell.name, "seed": args.seed, "correct": out["correct"],
                      "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                      "device": out["device"], **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
