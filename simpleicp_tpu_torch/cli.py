"""Command-line interface: ``python -m simpleicp_tpu_torch -f fixed.xyz -m
movable.xyz [-o R] [--export out.xyz]``.

The flag names, short options and defaults are those of the JAX package's
CLI, which follow the reference C++ and Rust CLIs, including "a negative
max_overlap_distance disables the gate", the ``--preset`` table and the
``--observed-values``/``--observation-weights`` extension. Differences:
``--device`` takes ``cuda`` (the default; an error without a card) or
``cpu``, with no ``auto`` routing and no health probe, so there is no
``--probe-timeout``; ``--dtype`` chooses float32 (the default) or float64.
Flags whose values are not ported yet fail with their ROADMAP item:
``--num-devices``, ``--dispatch chunked``, ``--warm-start``,
``--approx-knn`` and the grid and dilate engines.
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
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where to run: cuda (the card, the default) or cpu (the plain "
             "versions of the kernels)",
    )
    p.add_argument(
        "--dtype", choices=tuple(_DTYPES), default="float32",
        help="coordinate dtype (the solver computes in float64 either way)",
    )
    p.add_argument(
        "--approx-knn", action="store_true",
        help="approximate normal k-NN (not ported yet)",
    )
    p.add_argument(
        "--gate-method", choices=("auto", "brute", "grid", "dilate"),
        default="auto",
        help="overlap-gate engine: auto is the brute 1-NN gate up to 2^40 "
             "fixed x movable pairs; grid and dilate are not ported yet",
    )
    p.add_argument(
        "--match-method", choices=("auto", "brute", "grid"), default="auto",
        help="in-loop matcher: auto picks brute below 2^38 matched pairs per "
             "iteration; grid is not ported yet",
    )
    p.add_argument(
        "--match-radius", type=float, default=0.0,
        help="radius of the grid matcher (0 = use --max_overlap_distance)",
    )
    p.add_argument(
        "--program-budget", type=float, default=30.0,
        help="TPU program-time guard of the JAX package; no effect here",
    )
    p.add_argument(
        "--dispatch", choices=["auto", "monolithic", "chunked"],
        default="auto",
        help="program shape; auto is monolithic here, chunked is not "
             "ported yet",
    )
    p.add_argument(
        "--chunk-iterations", type=int, default=0,
        help="iterations per chunked-dispatch program (chunked dispatch is "
             "not ported yet)",
    )
    p.add_argument(
        "--warm-start", action="store_true",
        help="coarse-to-fine warm start (not ported yet)",
    )
    p.add_argument("--warm-start-points", type=int, default=1_000_000)
    p.add_argument("--warm-start-correspondences", type=int, default=1000)
    p.add_argument(
        "--stall-policy", choices=["warn", "wait"], default="warn",
        help="TPU chunked-dispatch policy of the JAX package; no effect here",
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

    solver, min_change = args.solver, args.min_change
    mad_scale, staging, ddof = args.mad_scale, args.rejection_staging, args.std_ddof
    if args.preset is not None:
        solver, min_change, p_mad, p_staging, p_ddof = PRESETS[args.preset]
        mad_scale = p_mad if mad_scale is None else mad_scale
        staging = p_staging if staging is None else staging
        ddof = p_ddof if ddof is None else ddof

    icp = SimpleICP(verbose=not args.quiet, device=args.device,
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
