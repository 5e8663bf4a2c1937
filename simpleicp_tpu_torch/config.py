"""Configuration of one ICP registration run.

The same fields, defaults and checks as the JAX package's ``IcpConfig``, so
that a configuration moves between the two packages unchanged
(``convert.config_from_dict``). Some fields only choose TPU tiles; they
change no result there either, and they have no effect here (see the field
notes below).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# The six rigid-body parameters, in the order of the parameter vector.
RBP_NAMES: Tuple[str, ...] = ("alpha1", "alpha2", "alpha3", "tx", "ty", "tz")


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """Static configuration of one ICP registration run.

    Attributes:
        correspondences: number of points selected in the fixed cloud as
            correspondence queries (reference default 1000).
        neighbors: k of the k-NN neighbourhood of the normal estimate
            (default 10).
        min_planarity: minimum planarity to keep a correspondence (0.3).
        max_overlap_distance: overlap gate radius; ``inf`` disables the gate.
        min_change: convergence threshold in percent on the change of the
            mean and the std of the residual distances (default 1.0).
        max_iterations: maximum ICP iterations (default 100).
        distance_weights: weight of the point-to-plane residuals; ``None``
            means 1/std(d)^2 estimated in iteration 0 and frozen.
        mad_scale: MAD to robust sigma factor (1.4826; 1.0 is the reference
            Python's raw MAD).
        solver: "nonlinear" (exact-rotation Gauss-Newton over the six
            absolute parameters every iteration) or "linearized" (one
            small-angle increment per iteration).
        gn_iterations: cap on the inner Gauss-Newton steps of the nonlinear
            solver; the loop exits earlier at 64*eps relative step.
        rejection_staging: "python" (planarity first, median/MAD on the
            survivors) or "joint" (median/MAD on all matches).
        std_ddof: ddof of the residual std of logging and convergence.
        query_tile / ref_tile: tile sizes of the JAX package's distance
            sweeps. No effect in this package: its kernels choose their own
            blocks, and no result depends on a tile size.
        use_pallas: chooses the JAX package's Pallas gate kernel on a TPU.
            No effect in this package.
        approx_knn: approximate normal k-NN (TPU ``approx_min_k``). Runs
            the exact k-NN here, as the JAX package does off the TPU; it
            stays a fingerprint field of ``FixedPrep``.
        record_trajectory: per-iteration trajectory buffers (max_iterations
            slots instead of one).
        gate_method / grid_cell_cap: overlap-gate engine, read when the gate
            is on. "brute" is the 1-NN gate; "dilate" the dilated-occupancy
            gate (the same mask, for large clouds); "auto" resolves as in
            the JAX package: brute up to 2^40 fixed x movable pairs, dilate
            above when its grid fits, else brute up to 2^41 pairs and
            "grid" above. "grid" is the spatial-hash cell list
            (``ops/gridhash.py``); ``grid_cell_cap`` is its cell cap (0:
            counted from the cloud).
        match_method: in-loop matcher. "auto" resolves as in the JAX
            package: "brute", or "grid" above 2^38 pairs per iteration when
            a radius is available. "grid" is the static-grid matcher: one
            cell list over the untransformed movable cloud, exact within
            the radius; rows whose nearest point lies farther are dropped.
        match_radius / match_cell_cap: the grid matcher's radius (0: the
            gate's) and cell cap (0: counted from the cloud).
        program_budget_s: card seconds one run may take in one piece (0:
            no limit). On the card the planner prices each stage with the
            card's rates (``utils/device_policy.py``): above the budget,
            "auto" runs chunked, and a step that no plan can split below
            it raises. No effect on the CPU.
        dispatch: "monolithic" (one loop), "chunked" (K iterations a call,
            the carry on the device; the same result bit for bit) or
            "auto" (chunked when the card-priced estimate exceeds
            ``program_budget_s``; monolithic on the CPU).
        chunk_iterations: iterations per chunk (0: from half the budget on
            the card, 8 on the CPU).
        warm_start / warm_start_points / warm_start_correspondences:
            coarse-to-fine warm start: a registration of clouds subsampled
            to about warm_start_points points (warm_start_correspondences
            selected) gives the full run its initial parameters; clouds at
            or below warm_start_points skip it (``plan_warm_start``).
        convergence_floor_scale: absolute convergence noise floor in units
            of eps(dtype) * max|Q| (0 disables it).
        stall_policy: what a chunk taking far longer than its card-priced
            estimate does (a throttled or shared card): "warn" logs and
            goes on; "wait" holds the next chunk until a health probe of
            the card answers. The result is the same either way.
        gate_collective: collective of the sharded gate (not ported).
    """

    correspondences: int = 1000
    neighbors: int = 10
    min_planarity: float = 0.3
    max_overlap_distance: float = math.inf
    min_change: float = 1.0
    max_iterations: int = 100
    distance_weights: Optional[float] = 1.0
    mad_scale: float = 1.4826
    solver: str = "nonlinear"
    gn_iterations: int = 24
    rejection_staging: str = "python"
    std_ddof: int = 0
    query_tile: int = 2048
    ref_tile: int = 0
    use_pallas: bool = False
    approx_knn: bool = False
    record_trajectory: bool = False
    gate_method: str = "auto"
    grid_cell_cap: int = 0
    match_method: str = "auto"
    match_radius: float = 0.0
    match_cell_cap: int = 0
    program_budget_s: float = 30.0
    dispatch: str = "auto"
    chunk_iterations: int = 0
    warm_start: bool = False
    warm_start_points: int = 1_000_000
    warm_start_correspondences: int = 1000
    convergence_floor_scale: float = 32.0
    stall_policy: str = "warn"
    gate_collective: str = "ring"

    def __post_init__(self):
        if self.correspondences < 6:
            raise ValueError("correspondences must be >= 6")
        if self.correspondences > 2**22:
            raise ValueError("correspondences must be <= 2**22 (4194304)")
        if self.neighbors < 3:
            raise ValueError("neighbors must be >= 3 to estimate a normal")
        if not 0.0 <= self.min_planarity < 1.0:
            raise ValueError("min_planarity must be in [0, 1)")
        if self.max_iterations < 1:
            raise ValueError("max_iterations must be >= 1")
        if self.distance_weights is not None and self.distance_weights <= 0:
            raise ValueError("distance_weights must be > 0")
        if self.solver not in ("nonlinear", "linearized"):
            raise ValueError("solver must be 'nonlinear' or 'linearized'")
        if self.rejection_staging not in ("python", "joint"):
            raise ValueError("rejection_staging must be 'python' or 'joint'")
        if self.std_ddof not in (0, 1):
            raise ValueError("std_ddof must be 0 or 1")
        if self.gate_method not in ("auto", "brute", "grid", "dilate"):
            raise ValueError(
                "gate_method must be 'auto', 'brute', 'grid' or 'dilate'"
            )
        if self.match_method not in ("auto", "brute", "grid"):
            raise ValueError("match_method must be 'auto', 'brute' or 'grid'")
        if self.match_radius < 0:
            raise ValueError("match_radius must be >= 0")
        if self.program_budget_s < 0:
            raise ValueError("program_budget_s must be >= 0 (0 disables)")
        if self.dispatch not in ("auto", "monolithic", "chunked"):
            raise ValueError(
                "dispatch must be 'auto', 'monolithic' or 'chunked'"
            )
        if self.chunk_iterations < 0:
            raise ValueError("chunk_iterations must be >= 0 (0 = auto)")
        if self.warm_start_points < 100:
            raise ValueError("warm_start_points must be >= 100")
        if self.warm_start_correspondences < 6:
            raise ValueError("warm_start_correspondences must be >= 6")
        if self.stall_policy not in ("warn", "wait"):
            raise ValueError("stall_policy must be 'warn' or 'wait'")
        if self.gate_collective not in ("ring", "allgather"):
            raise ValueError("gate_collective must be 'ring' or 'allgather'")
        if self.convergence_floor_scale < 0:
            raise ValueError(
                "convergence_floor_scale must be >= 0 (0 disables the floor)"
            )
        if self.match_method == "grid" and self.match_radius == 0.0 and not (
            math.isfinite(self.max_overlap_distance)
            and self.max_overlap_distance > 0
        ):
            raise ValueError(
                "match_method='grid' needs a radius: set match_radius or "
                "enable the overlap gate (max_overlap_distance)"
            )

    @property
    def overlap_enabled(self) -> bool:
        return math.isfinite(self.max_overlap_distance) and self.max_overlap_distance > 0

