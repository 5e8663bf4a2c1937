"""Command-line interface: ``python -m simpleicp_tpu_torch -f fixed.xyz -m
movable.xyz [-o R] [--export out.xyz]``.

The flag names, short options and defaults are those of the JAX package's
CLI, which follow the reference C++ and Rust CLIs, including "a negative
max_overlap_distance disables the gate", the ``--preset`` table and the
``--observed-values``/``--observation-weights`` extension. Differences:
``--device`` takes ``cuda`` (the default; an error without a card),
``cpu``, or ``auto``, which routes a job its plain versions are estimated
to finish on the host CPU within the card's fixed cost to the CPU and
any other to the card (``utils/device_policy.py``); ``--dtype`` chooses
float32 (the default) or float64. A job routed to the card without one
raises; it never falls back to the CPU. Only ``auto`` health-probes the
card first (the JAX package probes before every accelerator job).
``--num-devices`` is not ported
yet and fails with its ROADMAP item.
"""

from __future__ import annotations

import argparse
import logging
import math
import sys
import time

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    p = argparse.ArgumentParser(
        prog="simpleicp-tpu-torch",
        description="Point-to-plane ICP registration on an NVIDIA card (PyTorch/CUDA)",
    )
    p.add_argument(
        "--version", action="version", version=f"%(prog)s {__version__}"
    )
    p.add_argument("-f", "--fixed", required=True, help="path of fixed point cloud (xyz)")
    p.add_argument("-m", "--movable", required=True, help="path of movable point cloud (xyz)")
    p.add_argument("-c", "--correspondences", type=int, default=1000)
    p.add_argument("-n", "--neighbors", type=int, default=10)
    p.add_argument("-p", "--min_planarity", type=float, default=0.3)
    p.add_argument(
        "-o", "--max_overlap_distance", type=float, default=-1.0,
        help="overlap gate radius; negative disables (reference contract)",
    )
    p.add_argument("-i", "--min_change", type=float, default=1.0)
    p.add_argument("-x", "--max_iterations", type=int, default=100)
    p.add_argument("--solver", choices=["nonlinear", "linearized"], default="nonlinear")
    p.add_argument(
        "--preset",
        choices=["python", "cpp", "rust", "julia", "matlab"],
        default=None,
        help="emulate one reference implementation's semantics: python = "
             "nonlinear solver, raw MAD (scale 1.0), planarity-first "
             "rejection, population std; cpp/rust = linearized solver, "
             "1.4826 MAD, joint rejection, sample std; julia/matlab = like "
             "rust with min_change=3. A preset fixes --solver and "
             "--min_change; explicit --mad_scale/--rejection_staging/"
             "--std_ddof still override.",
    )
    p.add_argument(
        "--mad_scale", type=float, default=None,
        help="MAD-to-sigma scale of the rejection band (default 1.4826; "
             "reference Python uses 1.0)",
    )
    p.add_argument(
        "--rejection_staging", choices=["python", "joint"], default=None,
        help="outlier rejection staging: planarity-first (python) or joint "
             "(C++/Rust/Julia/MATLAB)",
    )
    p.add_argument(
        "--std_ddof", type=int, choices=[0, 1], default=None,
        help="ddof of the residual std for logging/convergence "
             "(0 = population like reference Python, 1 = sample)",
    )
    p.add_argument(
        "--observed-values", default=None, metavar="A1,A2,A3,TX,TY,TZ",
        help="rigid-body parameter observations (angles in DEGREES, like "
             "SimpleICP.run): six comma-separated values, also the initial "
             "transform",
    )
    p.add_argument(
        "--observation-weights", default=None, metavar="W1,...,W6",
        help="per-parameter observation weights: 0 free, finite>0 observed, "
             "inf frozen (use with --observed-values)",
    )
    p.add_argument("--export", default="", help="write the transformed movable cloud here")
    p.add_argument("--debug_dirpath", default="")
    p.add_argument(
        "--num-devices", type=int, default=0,
        help="shard the registration over this many devices (0 = one card; "
             "sharding is not ported yet)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu", "auto"), default="cuda",
        help="where to run: cuda (the card, the default), cpu (the plain "
             "versions of the kernels), or auto (the CPU for a registration "
             "estimated to finish there within the card's fixed cost of a "
             "fresh process, else the card)",
    )
    p.add_argument(
        "--dtype", choices=tuple(_DTYPES), default="float32",
        help="coordinate dtype (the solver computes in float64 either way)",
    )
    p.add_argument(
        "--approx-knn", action="store_true",
        help="approximate normal k-NN of the JAX package's TPU serving "
             "config; runs the exact k-NN here",
    )
    p.add_argument(
        "--gate-method", choices=("auto", "brute", "grid", "dilate"),
        default="auto",
        help="overlap-gate engine: auto is the brute 1-NN gate up to 2^40 "
             "fixed x movable pairs, the dilate gate above when its grid "
             "fits, else brute up to 2^41 pairs and the grid gate above",
    )
    p.add_argument(
        "--match-method", choices=("auto", "brute", "grid"), default="auto",
        help="in-loop matcher: auto picks brute up to 2^38 matched pairs per "
             "iteration, and the static-grid matcher above when a radius is "
             "set",
    )
    p.add_argument(
        "--match-radius", type=float, default=0.0,
        help="radius of the grid matcher (0 = use --max_overlap_distance)",
    )
    p.add_argument(
        "--program-budget", type=float, default=30.0,
        help="card seconds one run may take in one piece, priced with the "
             "card's rates: over it the run goes chunked, and a step no "
             "chunking can bring under it is refused (0 disables; no effect "
             "on the CPU)",
    )
    p.add_argument(
        "--dispatch", choices=["auto", "monolithic", "chunked"],
        default="auto",
        help="run the ICP loop in one piece (monolithic), K iterations a "
             "call with the state on the card (chunked; the same result), "
             "or chunked only over --program-budget (auto)",
    )
    p.add_argument(
        "--chunk-iterations", type=int, default=0,
        help="iterations per chunk (0 = from --program-budget on the card, "
             "8 on the CPU)",
    )
    p.add_argument(
        "--warm-start", action="store_true",
        help="coarse-to-fine: register stride-subsampled clouds first and "
             "start the full-resolution run from the coarse result (fewer "
             "expensive iterations, same basin; big-correspondence runs "
             "benefit most; incompatible with finite-weight "
             "--observation-weights)",
    )
    p.add_argument(
        "--warm-start-points", type=int, default=1_000_000,
        help="target subsampled-cloud size of the coarse warm-start pass "
             "(clouds at/below this size skip the coarse pass)",
    )
    p.add_argument(
        "--warm-start-correspondences", type=int, default=1000,
        help="correspondence count of the coarse warm-start pass (capped "
             "at --correspondences)",
    )
    p.add_argument(
        "--stall-policy", choices=["warn", "wait"], default="warn",
        help="chunked dispatch, when a chunk takes far longer than its "
             "card-priced estimate: warn logs and continues; wait holds "
             "the next chunk until a fresh-shape health probe of the card "
             "answers (the state stays on the card, so the result is the "
             "same)",
    )
    p.add_argument(
        "--probe-timeout", type=float, default=120.0,
        help="--device auto: timeout in seconds of the health probe of "
             "the card (a subprocess of a few seconds) before a job routed "
             "there; a failed probe sends a CPU-tractable job to the CPU (0 "
             "disables the probe; --device cuda never probes)",
    )
    p.add_argument("--quiet", action="store_true")
    return p


# Per-implementation semantics:
# (solver, min_change, mad_scale, rejection_staging, std_ddof)
PRESETS = {
    "python": ("nonlinear", 1.0, 1.0, "python", 0),
    "cpp": ("linearized", 1.0, 1.4826, "joint", 1),
    "rust": ("linearized", 1.0, 1.4826, "joint", 1),
    "julia": ("linearized", 3.0, 1.4826, "joint", 1),
    "matlab": ("linearized", 3.0, 1.4826, "joint", 1),
}


def _route(args, nf: int, nm: int, max_overlap: float, log) -> str:
    """The device of the run, "cpu" or "cuda": ``--device`` resolved by
    size (``device_policy.resolve_device``). A route to the card raises
    without one, before any probe. Only ``auto`` health-probes the card
    (``--probe-timeout``), since only there can a failed probe change the
    route: it sends a CPU-tractable job to the CPU, with a warning on
    standard error. ``cuda`` runs on the card unprobed."""
    from .utils import device_policy
    from .utils.device import resolve

    sizes = dict(correspondences=args.correspondences, neighbors=args.neighbors,
                 max_overlap_distance=max_overlap, max_iterations=args.max_iterations)
    routed = device_policy.resolve_device(args.device, nf, nm,
                                          sharded=args.num_devices > 0, **sizes)
    if args.device == "auto":
        log.info("device auto: %s (estimated %.3g s on the CPU, threshold %.3g s)",
                 routed, device_policy.estimate_cpu_seconds(nf, nm, **sizes),
                 device_policy.CPU_ROUTE_MAX_SEC)
    if routed == "cpu":
        return routed
    resolve(routed, None)  # no card: RuntimeError, never the CPU
    if args.device == "auto" and args.probe_timeout > 0:
        status, _, _ = device_policy.probe_default_backend(args.probe_timeout)
        routed, msg = device_policy.degraded_fallback(
            args.device, status, device_policy.estimate_cpu_seconds(nf, nm, **sizes))
        if msg and not args.quiet:
            print(f"WARNING: {msg}", file=sys.stderr, flush=True)
    return routed


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    def _six(spec, flag):
        if spec is None:
            return (0.0,) * 6
        vals = tuple(float(v) for v in spec.split(","))
        if len(vals) != 6:
            raise SystemExit(
                f"{flag} needs six comma-separated values, got {len(vals)}"
            )
        return vals

    obs_vals = _six(args.observed_values, "--observed-values")
    obs_w = _six(args.observation_weights, "--observation-weights")

    from . import PointCloud, SimpleICP
    from .utils.log import enable_verbose_logging
    from .utils.xyz_io import write_xyz

    if not args.quiet:
        enable_verbose_logging()  # before the parse, for its timing line
    log = logging.getLogger("simpleicp_tpu_torch.cli")
    t0 = time.time()
    pc_fix = PointCloud.from_xyz(args.fixed)
    pc_mov = PointCloud.from_xyz(args.movable)
    log.debug("timing: parse both clouds %.2f s", time.time() - t0)

    max_overlap = math.inf if args.max_overlap_distance < 0 else args.max_overlap_distance
    device = _route(args, len(pc_fix), len(pc_mov), max_overlap, log)

    solver, min_change = args.solver, args.min_change
    mad_scale, staging, ddof = args.mad_scale, args.rejection_staging, args.std_ddof
    if args.preset is not None:
        solver, min_change, p_mad, p_staging, p_ddof = PRESETS[args.preset]
        mad_scale = p_mad if mad_scale is None else mad_scale
        staging = p_staging if staging is None else staging
        ddof = p_ddof if ddof is None else ddof

    icp = SimpleICP(verbose=not args.quiet, device=device,
                    dtype=_DTYPES[args.dtype])
    icp.add_point_clouds(pc_fix, pc_mov)
    _, X_out, _, _ = icp.run(
        correspondences=args.correspondences,
        neighbors=args.neighbors,
        min_planarity=args.min_planarity,
        max_overlap_distance=max_overlap,
        min_change=min_change,
        max_iterations=args.max_iterations,
        rbp_observed_values=obs_vals,
        rbp_observation_weights=obs_w,
        solver=solver,
        mad_scale=1.4826 if mad_scale is None else mad_scale,
        rejection_staging="python" if staging is None else staging,
        std_ddof=0 if ddof is None else ddof,
        debug_dirpath=args.debug_dirpath,
        approx_knn=args.approx_knn,
        gate_method=args.gate_method,
        match_method=args.match_method,
        match_radius=args.match_radius,
        program_budget_s=args.program_budget,
        dispatch=args.dispatch,
        chunk_iterations=args.chunk_iterations,
        warm_start=args.warm_start,
        warm_start_points=args.warm_start_points,
        warm_start_correspondences=args.warm_start_correspondences,
        stall_policy=args.stall_policy,
        num_devices=args.num_devices,
    )
    if args.export:
        t0 = time.time()
        write_xyz(args.export, X_out)
        log.debug("timing: write transformed cloud %.2f s", time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
