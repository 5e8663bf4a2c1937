#!/usr/bin/env python3
"""Run one cell of the benchmark of simpleicp_tpu_torch on the card.

    python3 icpbench/run.py --workload dragon.pairs --seed 7 --seconds 30 --trace 0

Set-up (from the start of this process to the first timed call): import
the program from this checkout, draw the cell's pool of cloud pairs on the
card from the seed, and warm up its calls (the first run in a checkout
builds the program's kernels into ``simpleicp_tpu_torch/_build/``). Then a
closed loop of calls for ``--seconds``; with ``--trace 1`` a few more calls
under the profiler; then the check against the plain reference. The last
line of standard output is one JSON object; the numbers the check compared
are the last lines of standard error. Without a card, or with fewer cards
than the cell asks for, it prints no result and exits with 2; if JAX or the
JAX package was loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level module names the run may not load (compared whole: the
# program's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "simpleicp_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_program():
    """The program of this checkout: its exported names (the entries find
    theirs there) and its count of host reads. One found elsewhere raises."""
    import simpleicp_tpu_torch as st
    from simpleicp_tpu_torch.utils import sync

    where = Path(st.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"simpleicp_tpu_torch imported from {where}, not from {ROOT}")
    return SimpleNamespace(**{k: getattr(st, k) for k in st.__all__},
                           host_reads=sync.host_reads)


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device: str = "cuda",
             program=None, t_start: float = None, min_pairs: int = 0):
    """One run of ``cell`` (a ``spec.Cell``): (the result object the run
    prints, the run's ``Readings``, what was read of the host).
    ``program`` replaces the program (tests plant faults there, the
    calibration its control); ``min_pairs`` keeps the window open until it
    has registered that many pairs (the control's)."""
    import torch

    from icpbench import check, drive, host, trace as tr
    from icpbench.pools import make_pool
    from icpbench.readings import Readings
    from icpbench.reference import icp as ref
    from icpbench.spec import metric_reader

    t_start = time.perf_counter() if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    program = program or load_program()
    dev = torch.device(device)
    cfg_file, traffic = cell.config, cell.traffic
    icp = cell.icp_fields()
    pool = make_pool(pairs=int(traffic["pool"]), n_fix=int(cfg_file["points_fixed"]),
                     n_mov=int(cfg_file["points_movable"]), half=float(cfg_file["half_width"]),
                     geometry=traffic["geometry"], angle_max=float(traffic["angle_max"]),
                     shift_max=float(traffic["shift_max"]),
                     noise=float(cfg_file["height_noise"]), seed=seed, device=dev,
                     root=cell.root)
    cfg = program.IcpConfig(**icp)
    call = drive.entry(program, pool, traffic, cfg, dev, cell.root)
    order = drive.groups(pool, traffic, seed)
    for i in range(int(traffic["warmup_calls"])):
        call(order[i % len(order)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
        host.steady()
    setup_s = time.perf_counter() - t_start

    with host.Watch() as watch:
        window = drive.run_window(call, order, seconds, dev, program.host_reads, min_pairs)
    seen = {**watch.read, **host.halves_ms(window.latency_s, [len(c) for c in window.calls])}
    for res in window.results:
        for k in ("n_iterations", "converged", "error_code"):
            res[k] = res[k].cpu()
    its = [int(v) for res in window.results for v in res["n_iterations"]]
    bad = [int(e) != 0 or not bool(c) for res in window.results
           for e, c in zip(res["error_code"], res["converged"])]
    r = Readings(icp=icp, n_fix=pool.fixed.shape[1], n_mov=pool.movable.shape[1],
                 pairs_per_call=int(traffic.get("pairs_per_call", 1)), setup_s=setup_s,
                 window_seconds=window.seconds, window_pairs=window.pairs,
                 window_host_reads=window.host_reads,
                 pair_latency_s=[t for pairs, t in zip(window.calls, window.latency_s)
                                 for _ in pairs],
                 window_iterations=its,
                 window_loop_iterations=[int(res["n_iterations"].max())
                                         for res in window.results])
    out = {"correct": False, "attempted": window.pairs, "failed": int(sum(bad))}

    if trace:
        results, dev_ops, host_ops = tr.profile_calls(
            call, order, int(cell.settings["trace_calls"]), dev)
        r.traced_pairs = sum(len(order[i % len(order)]) for i in range(len(results)))
        r.traced_iterations = [int(v) for res in results for v in res["n_iterations"].cpu()]
        breakdown = tr.readings_from_trace(r, dev_ops, host_ops)
        del results, dev_ops, host_ops
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = metric_reader(m["name"], cell.root)(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    if dev.type == "cuda":
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                       "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
                       "power_limit_w": power_limit_w()}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace:
        device_info.update(busy_s=r.busy_s, window_s=r.traced_s)
    del call
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    picks = check.sample(window, int(cell.settings["check_pairs"]), seed)
    worst = check.compare(window, picks, lambda j, n: ref.register(
        pool.fixed[j], pool.movable[j], icp, run_to=n))
    out["correct"], shown = check.verdict(worst, cell.settings["limits"])
    out.update(metrics=metrics, device=device_info)
    if trace:
        out["breakdown"] = breakdown
    out["checks"] = shown
    return out, r, seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from icpbench import spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"icpbench: {cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, _, seen = run_cell(cell, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), t_start=T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"icpbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    print("icpbench: host " + " ".join(f"{k}={v!r}" for k, v in seen.items()),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
