#!/usr/bin/env python3
"""Readings the check's limits are set from: the numbers a cell compares,
for the program and for the control, on many seeds in one process.

    python3 icpbench/calibrate.py --workload dragon.pairs --seeds 11,12,13 \
        --seconds 10 --mode program
    python3 icpbench/calibrate.py --workload dragon.pairs --seeds 11,12,13 \
        --mode control

``program`` runs the cell as ``run.py`` does (a window of ``--seconds``,
then the check) on each seed. ``control`` puts the plain reference,
computed in TF32 (``reference.icp``'s ``tf32``), in the program's place:
a window long enough for as many registrations as the check compares,
held against the float32 reference. Each seed prints one JSON line with
the numbers; the benchmark's own runs never run this.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_program(icp):
    """The reference in TF32, with the program's entries' signatures and the
    result fields the check reads."""
    import torch

    from icpbench.reference import icp as ref

    T = icp["max_iterations"]

    def one(Xf, Xm):
        R = ref.register(Xf, Xm, icp, tf=True)
        stds = torch.zeros(T, dtype=torch.float32, device=Xf.device)
        stds[:R["n_iterations"]] = R["iter_stds"][:R["n_iterations"]]
        return {"H": R["H"], "n_iterations": torch.tensor(R["n_iterations"]),
                "converged": torch.tensor(R["converged"]),
                "error_code": torch.tensor(R["error"]), "sel_idx": R["sel_idx"],
                "sel_valid": R["sel_valid"], "normals": R["normals"], "iter_stds": stds}

    def icp_register(Xf, Xm, cfg, device=None):
        return SimpleNamespace(**one(Xf, Xm))

    def icp_register_batch(Xf, Xm, cfg, device=None):
        rows = [one(Xf[b], Xm[b]) for b in range(Xf.shape[0])]
        return SimpleNamespace(**{k: torch.stack([r[k].to(Xf.device) for r in rows])
                                  for k in rows[0]})

    return SimpleNamespace(icp_register=icp_register, icp_register_batch=icp_register_batch,
                           IcpConfig=lambda **kw: kw, host_reads=lambda: 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--mode", choices=("program", "control"), required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from icpbench import spec
    from icpbench.run import run_cell

    cell = spec.load(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    program, seconds, min_pairs = None, args.seconds, 0
    if args.mode == "control":
        # no warm-up; as many registrations as the check compares
        program = control_program(cell.icp_fields())
        cell = dataclasses.replace(cell, traffic={**cell.traffic, "warmup_calls": 0})
        seconds, min_pairs = 0.0, int(cell.settings["check_pairs"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out, readings, _ = run_cell(cell, seed=seed, seconds=seconds, trace=False,
                                    device=args.device, program=program, min_pairs=min_pairs)
        its = readings.window_iterations
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed,
                          "attempted": out["attempted"], "failed": out["failed"],
                          "correct": out["correct"], "checks": out["checks"],
                          "metrics": out["metrics"],
                          "iterations": {n: its.count(n) for n in sorted(set(its))},
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
