#!/usr/bin/env python3
"""Time the PyTorch port's CLI of two checkouts in turns, on the card.

    python3 scripts/cli_ab_torch.py A_DIR B_DIR [--reps 2]

Writes chip_smoke.py's dilate pair (1.2M x 1.2M points, partial overlap,
the known motion) once at the CLI's default %.3f with ``np.savetxt``, so
that both checkouts read the same file, then runs ``python3 -m
simpleicp_tpu_torch -f fix.xyz -m mov.xyz -o 0.1 --export out.xyz`` of
each checkout once to build its kernels (untimed), then in turns (A, B,
B, A, ...; ``reps`` runs of each), each a fresh process on the card with
``SIMPLEICP_TPU_DEBUG_TIMING=1``. Prints one JSON line a run (the
checkout, its wall seconds, the CLI's "timing:" lines and its "Finished
in" line), then one line of medians by checkout, and the card's name and
power limit. Each run must exit 0 and converge, and the
two checkouts' exported files must be equal.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(tree, f1, f2, out):
    env = {**os.environ, "SIMPLEICP_TPU_DEBUG_TIMING": "1",
           "PYTHONPATH": os.path.abspath(tree)}
    cmd = [sys.executable, "-m", "simpleicp_tpu_torch", "-f", f1, "-m", f2, "-o", "0.1",
           "--export", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0 or "Convergence criteria fulfilled" not in log:
        raise SystemExit(f"{tree}: CLI exited {proc.returncode}:\n{log[-3000:]}")
    timing = {ln[len("timing: "):].rsplit(" ", 2)[0]: float(ln.split()[-2])
              for ln in log.splitlines() if ln.startswith("timing: ")}
    finished = [ln for ln in log.splitlines() if ln.startswith("Finished in ")][-1]
    return {"wall_s": wall, "timing_s": timing, "finished_line": finished}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--reps", type=int, default=2, help="timed runs of each checkout")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    X_fix, X_mov, _, _ = cs.partial_pair(cs.N_DILATE, cs.SEED + 8, cs.N_DILATE / cs.N_MAIN)
    runs = {"a": [], "b": []}
    with tempfile.TemporaryDirectory() as d:
        f1, f2 = os.path.join(d, "fix.xyz"), os.path.join(d, "mov.xyz")
        for path, X in ((f1, X_fix), (f2, X_mov)):
            with open(path, "w") as f:
                f.write("//X Y Z\n")
                np.savetxt(f, X, fmt="%.3f", delimiter=" ")
        exported = {}
        order = ["a", "b", "b", "a"] * (args.reps // 2) + ["a", "b"] * (args.reps % 2)
        for i, key in enumerate(["a", "b", *order]):
            tree = getattr(args, key)
            out = os.path.join(d, f"out_{key}.xyz")
            row = {"tree": key, "dir": tree, "warm_up": i < 2, **run_cli(tree, f1, f2, out)}
            print(json.dumps(row), flush=True)
            if i >= 2:
                runs[key].append(row)
            with open(out, "rb") as f:
                exported[key] = f.read()
        if exported["a"] != exported["b"]:
            raise SystemExit("the two checkouts exported different files")
    med = {}
    for key, rows in runs.items():
        names = sorted({n for r in rows for n in r["timing_s"]})
        med[key] = {"wall_s": statistics.median(r["wall_s"] for r in rows),
                    **{n: statistics.median(r["timing_s"].get(n, float("nan")) for r in rows)
                       for n in names}}
    print(json.dumps({"medians": med, "n_points": cs.N_DILATE, "exports_equal": True}))
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
