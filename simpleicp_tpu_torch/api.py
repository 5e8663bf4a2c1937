"""The class API: ``PointCloud`` and ``SimpleICP``.

The reference simpleICP Python's public surface, as the JAX package offers
it: a ``PointCloud`` container with a selection mask and geometry ops, and a
``SimpleICP`` class whose ``run()`` has the same arguments, checks,
exceptions, logged lines and return values. The compute is
``models.icp.icp_register``. The container is a struct-of-arrays over numpy
with DataFrame-like accessors.

Device and dtype are explicit: ``SimpleICP(device=..., dtype=...)`` and the
``device``/``dtype`` arguments of the ``PointCloud`` methods that compute.
The default is the card (an error without one) and float32, the
counterpart of the JAX package's platform and x64 switches.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import RBP_NAMES, IcpConfig
from .models import icp as icp_core
from .models.solver import RigidBodyParameters, host_rotation
from .utils.device import DeviceLike, resolve
from .utils.log import enable_verbose_logging, get_logger
from .utils.xyz_io import read_xyz, write_correspondences_xyz, write_xyz

_log = get_logger(__name__)

# Above this many query x reference pairs select_in_range switches to the
# grid cell list, as in the JAX package.
_SELECT_BRUTE_PAIRS = 2**41


class PointCloudException(Exception):
    """Raised when PointCloud is misused."""


class SimpleICPException(Exception):
    """Raised when SimpleICP is misused or the algorithm cannot proceed."""


def _tensor(X, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(X), dtype=dtype, device=device)


class PointCloud:
    """Struct-of-arrays point-cloud container with a selection mask.

    Construction accepts an (n, 3) array, a mapping of column arrays (must
    contain "x", "y", "z"), or a pandas DataFrame (duck-typed). A boolean
    "selected" column is added if missing.
    """

    def __init__(self, data=None, columns: Optional[List[str]] = None) -> None:
        cols: Dict[str, np.ndarray] = {}
        if hasattr(data, "columns") and hasattr(data, "to_numpy"):  # DataFrame
            for name in data.columns:
                cols[str(name)] = np.asarray(data[name].to_numpy())
        elif isinstance(data, dict):
            cols = {k: np.asarray(v) for k, v in data.items()}
        else:
            arr = np.asarray(data, dtype=np.float64)
            if arr.ndim != 2 or arr.shape[1] < 3:
                raise PointCloudException(
                    "PointCloud expects an (n, 3) array, a dict of columns, "
                    "or a DataFrame."
                )
            names = columns if columns is not None else ["x", "y", "z"]
            for j, name in enumerate(names):
                cols[name] = arr[:, j].copy()

        for coordinate in ("x", "y", "z"):
            if coordinate not in cols:
                raise PointCloudException(
                    f'Column "{coordinate}" is missing in DataFrame.'
                )

        self._cols = cols
        self._num_points = len(cols["x"])
        if "selected" not in self._cols:
            self._cols["selected"] = np.ones(self._num_points, dtype=bool)
        else:
            self._cols["selected"] = np.asarray(self._cols["selected"], dtype=bool)

    @classmethod
    def from_xyz(cls, path) -> "PointCloud":
        return cls(read_xyz(path))

    # -- column access -------------------------------------------------------
    @property
    def columns(self):
        return list(self._cols.keys())

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __setitem__(self, name: str, value) -> None:
        value = np.asarray(value)
        if value.shape[0] != self._num_points:
            raise PointCloudException(
                f'Column "{name}" has {value.shape[0]} rows, expected '
                f"{self._num_points}."
            )
        self._cols[name] = value.astype(bool) if name == "selected" else value

    def __len__(self) -> int:
        return self._num_points

    # -- coordinates -----------------------------------------------------------
    @property
    def x(self) -> np.ndarray:
        return self._cols["x"]

    @property
    def y(self) -> np.ndarray:
        return self._cols["y"]

    @property
    def z(self) -> np.ndarray:
        return self._cols["z"]

    @property
    def x_selected(self) -> np.ndarray:
        return self._cols["x"][self._cols["selected"]]

    @property
    def y_selected(self) -> np.ndarray:
        return self._cols["y"][self._cols["selected"]]

    @property
    def z_selected(self) -> np.ndarray:
        return self._cols["z"][self._cols["selected"]]

    @property
    def X(self) -> np.ndarray:
        return np.column_stack([self._cols["x"], self._cols["y"], self._cols["z"]])

    @property
    def X_selected(self) -> np.ndarray:
        sel = self._cols["selected"]
        return np.column_stack(
            [self._cols["x"][sel], self._cols["y"][sel], self._cols["z"][sel]]
        )

    @property
    def idx_selected(self) -> np.ndarray:
        return np.where(self._cols["selected"])[0]

    @idx_selected.setter
    def idx_selected(self, indices) -> None:
        self.unselect_all_points()
        self._cols["selected"][np.asarray(indices, dtype=np.int64)] = True

    @property
    def num_points(self) -> int:
        return self._num_points

    @property
    def num_selected_points(self) -> int:
        return int(np.sum(self._cols["selected"]))

    # -- selection -------------------------------------------------------------
    def select_all_points(self) -> None:
        self._cols["selected"][:] = True

    def unselect_all_points(self) -> None:
        self._cols["selected"][:] = False

    def select_by_indices(self, indices) -> None:
        """Select the intersection of `indices` with the current selection."""
        self.idx_selected = np.intersect1d(self.idx_selected, indices)

    def select_n_points(self, n: int) -> None:
        """Keep n points, equidistant across the currently selected indices."""
        if self.num_selected_points > n:
            idx = np.round(np.linspace(0, self.num_selected_points - 1, n)).astype(int)
            keep = self.idx_selected[idx]
            self.unselect_all_points()
            self._cols["selected"][keep] = True

    def select_in_range(self, X: np.ndarray, max_range: float, *,
                        device: DeviceLike = None,
                        dtype: Optional[torch.dtype] = None) -> None:
        """Keep the selected points whose nearest neighbour in X lies within
        max_range: the brute 1-NN (the 1-NN kernel on the card), and above
        2^41 pairs the grid cell list (its cell cap counted on the host),
        as in the JAX package; both give the same mask."""
        from .ops.gridhash import grid_cell_cap, min_dist_sq_grid
        from .ops.knn import min_dist_sq

        X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] != 3:
            raise PointCloudException("X must have 3 columns!")
        queries = self.X_selected
        dev, dtype = resolve(device, dtype)
        q, r = _tensor(queries, dev, dtype), _tensor(X, dev, dtype)
        if queries.shape[0] * X.shape[0] > _SELECT_BRUTE_PAIRS:
            d2 = min_dist_sq_grid(q, r, max_range, cell_cap=grid_cell_cap(X, max_range))
        else:
            d2 = min_dist_sq(q, r)
        keep = d2.cpu().numpy() <= float(max_range) ** 2
        idx_new = self.idx_selected[keep]
        self.unselect_all_points()
        self._cols["selected"][idx_new] = True

    # -- geometry --------------------------------------------------------------
    def estimate_normals(self, neighbors: int, *, device: DeviceLike = None,
                         dtype: Optional[torch.dtype] = None) -> None:
        """Normals and planarity of the selected points from their k-NN
        neighbourhoods in the whole cloud (the k-NN kernel on the card)."""
        from .ops.knn import knn_search
        from .ops.normals import estimate_normals_from_neighborhoods

        dev, dtype = resolve(device, dtype)
        X = _tensor(self.X, dev, dtype)
        sel = self.idx_selected
        _, idxk = knn_search(X[torch.as_tensor(sel, device=dev)], X, neighbors)
        normals, planarity, _ = estimate_normals_from_neighborhoods(X[idxk.long()])
        normals = normals.cpu().numpy()
        planarity = planarity.cpu().numpy()

        for j, name in enumerate(("nx", "ny", "nz")):
            col = np.full(self._num_points, np.nan, dtype=np.float32)
            col[sel] = normals[:, j]
            self._cols[name] = col
        col = np.full(self._num_points, np.nan, dtype=np.float32)
        col[sel] = planarity
        self._cols["planarity"] = col

    def transform_by_H(self, H: np.ndarray) -> None:
        """Apply the 4x4 homogeneous transform in place."""
        H = np.asarray(H)
        X = self.X @ H[:3, :3].T + H[:3, 3]
        self._cols["x"], self._cols["y"], self._cols["z"] = X[:, 0], X[:, 1], X[:, 2]

    def write_xyz(self, file) -> None:
        write_xyz(file, self.X)


class SimpleICP:
    """Add two clouds, ``run()`` the registration.

    Args:
        verbose: log the reference's lines through a stream handler.
        device: where ``run()`` computes; the card by default (an error
            without one), "cpu" for the plain versions.
        dtype: coordinate dtype, float32 by default.
    """

    def __init__(self, verbose: bool = True, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        self.pc1: Optional[PointCloud] = None
        self.pc2: Optional[PointCloud] = None
        self.device = device
        self.dtype = dtype
        if verbose:
            enable_verbose_logging()

    def add_point_clouds(self, pc_fix: PointCloud, pc_mov: PointCloud) -> None:
        self.pc1 = pc_fix
        self.pc2 = pc_mov

    def run(
        self,
        correspondences: int = 1000,
        neighbors: int = 10,
        min_planarity: float = 0.3,
        max_overlap_distance: float = np.inf,
        min_change: float = 1.0,
        max_iterations: int = 100,
        distance_weights: Optional[float] = 1,
        rbp_observed_values: Tuple[float, ...] = (0.0,) * 6,
        rbp_observation_weights: Tuple[float, ...] = (0.0,) * 6,
        debug_dirpath: str = "",
        solver: str = "nonlinear",
        mad_scale: float = 1.4826,
        rejection_staging: str = "python",
        std_ddof: int = 0,
        center: bool = True,
        approx_knn: bool = False,
        gate_method: str = "auto",
        match_method: str = "auto",
        match_radius: float = 0.0,
        program_budget_s: float = 30.0,
        dispatch: str = "auto",
        chunk_iterations: int = 0,
        warm_start: bool = False,
        warm_start_points: int = 1_000_000,
        warm_start_correspondences: int = 1000,
        stall_policy: str = "warn",
        mesh=None,
        num_devices: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, RigidBodyParameters, np.ndarray]:
        """Run the registration, with the JAX package's arguments.

        Angles of ``rbp_observed_values`` are in degrees. ``center`` shifts
        both clouds by the fixed cloud's centroid before the run and maps
        the result back exactly, on the host in float64 (only when no
        translation is observed). ``warm_start`` runs a coarse
        registration of subsampled clouds first and starts the full run
        from its result (``IcpConfig.warm_start``); ``approx_knn`` runs the
        exact k-NN, as the JAX package does off the TPU; the grid gate and
        matcher run as the config resolves them; ``dispatch``,
        ``chunk_iterations``, ``program_budget_s`` and ``stall_policy``
        plan and run chunked dispatch on the card (``icp_register``).
        Settings that are not ported yet raise NotImplementedError naming
        their ROADMAP item: ``mesh`` and ``num_devices`` (sharded runs).

        Returns:
            (H, X_mov_transformed, rbp, distance_residuals)
        """
        if self.pc1 is None or self.pc2 is None:
            raise SimpleICPException(
                "Point clouds must be added with add_point_clouds() before run()."
            )
        self._check_arguments(
            distance_weights, rbp_observed_values, rbp_observation_weights
        )
        if mesh is not None or num_devices:
            raise icp_core.not_ported(
                "a sharded run (mesh / num_devices)", "item 14 (parallel)"
            )
        dev, dtype = resolve(self.device, self.dtype)

        start_time = time.time()

        if debug_dirpath:
            _log.info(f'Write debug files to directory "{debug_dirpath}"')
            Path(debug_dirpath).mkdir(parents=True, exist_ok=True)

        # degrees -> radians for the three angles
        obs_vals = np.array(rbp_observed_values, dtype=np.float64)
        obs_vals[:3] *= np.pi / 180.0
        obs_w = np.array(rbp_observation_weights, dtype=np.float64)

        cfg = IcpConfig(
            correspondences=correspondences,
            neighbors=neighbors,
            min_planarity=min_planarity,
            max_overlap_distance=(
                max_overlap_distance if max_overlap_distance is not None else math.inf
            ),
            min_change=min_change,
            max_iterations=max_iterations,
            distance_weights=distance_weights,
            solver=solver,
            mad_scale=mad_scale,
            rejection_staging=rejection_staging,
            std_ddof=std_ddof,
            approx_knn=approx_knn,
            gate_method=gate_method,
            match_method=match_method,
            match_radius=match_radius,
            program_budget_s=program_budget_s,
            dispatch=dispatch,
            chunk_iterations=chunk_iterations,
            warm_start=warm_start,
            warm_start_points=warm_start_points,
            warm_start_correspondences=warm_start_correspondences,
            stall_policy=stall_policy,
            record_trajectory=bool(debug_dirpath),
        )

        if cfg.overlap_enabled:
            _log.info("Consider partial overlap of point clouds ...")
        _log.info("Select points for correspondences in fixed point cloud ...")

        has_normals = {"nx", "ny", "nz", "planarity"}.issubset(set(self.pc1.columns))
        if not has_normals:
            _log.info("Estimate normals of selected points ...")

        # A restricted movable selection: matches only among its points.
        mov_sel = self.pc2.idx_selected
        X_mov_sel = self.pc2.X if len(mov_sel) == len(self.pc2) else self.pc2.X[mov_sel]

        # Exact host-side centering, only without translation observations
        # (they refer to the original frame).
        do_center = bool(center) and bool(np.all(obs_w[3:] == 0.0))
        if do_center:
            c = self.pc1.X.mean(axis=0)
            R0 = host_rotation(*obs_vals[:3])
            obs_vals_run = obs_vals.copy()
            obs_vals_run[3:] = obs_vals[3:] + R0 @ c - c
            Xf_run = self.pc1.X - c
            Xm_run = X_mov_sel - c
        else:
            c = np.zeros(3)
            obs_vals_run = obs_vals
            Xf_run = self.pc1.X
            Xm_run = X_mov_sel

        _log.info("Start iterations ...")
        _t_reg = time.time()
        result = icp_core.icp_register(
            Xf_run,
            Xm_run,
            cfg,
            rbp_observed_values=obs_vals_run,
            rbp_observation_weights=obs_w,
            normals_fix=(
                np.column_stack(
                    [self.pc1["nx"], self.pc1["ny"], self.pc1["nz"]]
                ).astype(np.float64)
                if has_normals
                else None
            ),
            planarity_fix=(
                np.asarray(self.pc1["planarity"], dtype=np.float64)
                if has_normals
                else None
            ),
            # Both clouds gate on planarity when the movable cloud has it.
            planarity_mov=(
                np.asarray(self.pc2["planarity"], dtype=np.float64)[mov_sel]
                if "planarity" in self.pc2
                else None
            ),
            device=dev,
            dtype=dtype,
        )
        # One copy of every field to the host.
        result = icp_core.IcpResult(*(t.detach().cpu().numpy() for t in result))
        error = int(result.error_code)
        _log.debug("timing: register (to the host) %.2f s", time.time() - _t_reg)
        _t_post = time.time()
        if error == icp_core.ERR_NO_OVERLAP:
            raise SimpleICPException(
                "Point clouds do not overlap within max_overlap_distance = "
                f"{max_overlap_distance:.5f}! Consider increasing the value of "
                "max_overlap_distance."
            )
        if error == icp_core.ERR_TOO_FEW_CORRESPONDENCES:
            n_bad = int(
                result.iter_counts[max(int(result.n_iterations) - 1, 0)]
            )
            raise SimpleICPException(
                "Too few correspondences! At least 6 correspondences are "
                "needed to estimate the 6 rigid body transformation "
                f"parameters. The current number of correspondences is {n_bad}."
            )

        # The reference's state changes: pc1's selection becomes the
        # correspondence selection; pc1 gains normal columns if estimated.
        sel_idx = result.sel_idx[result.sel_valid]
        self.pc1.unselect_all_points()
        self.pc1["selected"][sel_idx] = True
        if not has_normals:
            valid = result.sel_valid
            for j, name in enumerate(("nx", "ny", "nz")):
                col = np.full(len(self.pc1), np.nan, dtype=np.float32)
                col[sel_idx] = result.normals[valid, j]
                self.pc1[name] = col
            col = np.full(len(self.pc1), np.nan, dtype=np.float32)
            col[sel_idx] = result.planarity[valid]
            self.pc1["planarity"] = col

        H = np.array(result.H, dtype=np.float64)
        p_est = np.array(result.p, dtype=np.float64)
        unc = np.asarray(result.uncertainties, dtype=np.float64)
        if do_center:
            # Back to the original frame: H = T(c) H' T(-c), so the rotation
            # is unchanged and t = t' + c - R c (exact, float64).
            R_est = H[:3, :3]
            H[:3, 3] = H[:3, 3] + c - R_est @ c
            p_est[3:] = p_est[3:] + c - host_rotation(*p_est[:3]) @ c
            # The covariance through the same map, so the sigmas are those
            # of the original frame: J = [[I, 0], [-d(R c)/dalpha, I]], with
            # the exact complex-step derivative of the rotation.
            Cxx = np.asarray(result.covariance, dtype=np.float64)
            Jmap = np.eye(6)
            h = 1e-200
            for j in range(3):
                a = p_est[:3].astype(complex)
                a[j] += 1j * h
                Jmap[3:, j] = -np.imag(host_rotation(a[0], a[1], a[2]) @ c) / h
            C_orig = Jmap @ Cxx @ Jmap.T
            vary = np.isfinite(obs_w)
            unc = np.where(
                vary, np.sqrt(np.maximum(np.diag(C_orig), 0.0)), np.nan
            )
        n_done = int(result.n_iterations)
        converged = bool(result.converged)

        rbp = RigidBodyParameters()
        rbp.set_parameter_attributes_from_list("observed_value", obs_vals)
        rbp.set_parameter_attributes_from_list("observation_weight", obs_w)
        rbp.set_parameter_attributes_from_list("estimated_value", p_est)
        rbp.set_parameter_attributes_from_list("estimated_uncertainty", unc)

        # ---- the iteration table ----
        _log.info(
            f"{'Iteration':>9s} | "
            f"{'correspondences':>15s} | "
            f"{'mean(residuals)':>15s} | "
            f"{'std(residuals)':>15s}"
        )
        _log.info(
            f"{'orig:0':>9s} | "
            f"{int(result.orig_count):15d} | "
            f"{float(result.orig_mean):15.4f} | "
            f"{float(result.orig_std):15.4f}"
        )
        # The converging iteration's row is not printed (the reference
        # Python stops before it prints it).
        n_rows = n_done - 1 if converged else n_done
        for i in range(n_rows):
            _log.info(
                f"{i + 1:9d} | {int(result.iter_counts[i]):15d} | "
                f"{float(result.iter_means[i]):15.4f} | "
                f"{float(result.iter_stds[i]):15.4f}"
            )
        if converged:
            _log.info("Convergence criteria fulfilled -> stop iteration!")

        _log.info("Estimated transformation matrix H:")
        for r in range(4):
            _log.info(
                f"[{H[r, 0]:12.6f} {H[r, 1]:12.6f} "
                f"{H[r, 2]:12.6f} {H[r, 3]:12.6f}]"
            )
        _log.info(
            "... which corresponds to the following rigid-body "
            "transformation parameters:"
        )
        _log.info(
            f"{'parameter':>9s} | "
            f"{'est.value':>15s} | "
            f"{'est.uncertainty':>15s} | "
            f"{'obs.value':>15s} | "
            f"{'obs.weight':>15s}"
        )
        for name in RBP_NAMES:
            param = getattr(rbp, name)
            _log.info(
                f"{name:>9s} | "
                f"{param.estimated_value_scaled:15.6f} | "
                f"{param.estimated_uncertainty_scaled:15.6f} | "
                f"{param.observed_value_scaled:15.6f} | "
                f"{param.observation_weight:15.3e}"
            )
        _log.info(
            "(Unit of est.value, est.uncertainty, and obs.value for "
            "alpha1/2/3 is degree)"
        )

        if debug_dirpath:
            self._write_debug_files(Path(debug_dirpath), result, Xm_run, c, n_done)

        # The final transformation is applied to pc2 for good.
        self.pc2.transform_by_H(H)

        distance_residuals = result.residuals[result.residual_mask]

        _log.debug("timing: postprocess %.2f s", time.time() - _t_post)
        _log.info(f"Finished in {time.time() - start_time:.3f} seconds!")
        return H, self.pc2.X, rbp, distance_residuals

    def _write_debug_files(self, dirpath: Path, result, Xm_run: np.ndarray,
                           c: np.ndarray, n_done: int) -> None:
        """The reference's per-iteration CloudCompare dumps, replayed from
        the recorded trajectory. ``Xm_run`` and the trajectory live in the
        (possibly centered) compute frame; adding ``c`` restores the
        original frame."""
        sel_valid = result.sel_valid
        Qfull = self.pc1.X[result.sel_idx]  # (C,3), slot-aligned
        write_xyz(dirpath / "iteration000_preoptim_pcfix.xyz", self.pc1.X)

        p_prev = None
        for it in range(n_done):
            # pre-optim pcmov: the movable cloud moved by the incoming H of
            # iteration `it` (the previous iteration's estimate).
            p_in = np.zeros(6) if it == 0 else p_prev
            R = host_rotation(p_in[0], p_in[1], p_in[2])
            Xm_t = Xm_run @ R.T + p_in[3:6] + c
            write_xyz(dirpath / f"iteration{it:03d}_preoptim_pcmov.xyz", Xm_t)
            mask = result.iter_masks[it] & sel_valid
            write_correspondences_xyz(
                dirpath / f"iteration{it:03d}_preoptim_correspondences.xyz",
                Qfull[mask],
                Xm_t[result.iter_midx[it][mask]],
                result.iter_dists[it][mask],
            )
            p_prev = result.iter_ps[it]

        Hc = np.asarray(result.H, dtype=np.float64)  # compute-frame transform
        Xm_final = Xm_run @ Hc[:3, :3].T + Hc[:3, 3] + c
        write_xyz(
            dirpath / f"iteration{max(n_done - 1, 0):03d}_postoptim_pcmov.xyz",
            Xm_final,
        )

    @staticmethod
    def _check_arguments(distance_weights, rbp_observed_values,
                         rbp_observation_weights) -> None:
        if distance_weights is not None and distance_weights <= 0:
            raise SimpleICPException("distance_weights must be > 0.")
        if len(rbp_observed_values) != 6:
            raise SimpleICPException("rbp_observed_values must have exactly 6 elements.")
        if len(rbp_observation_weights) != 6:
            raise SimpleICPException(
                "rbp_observation_weights must have exactly 6 elements."
            )
        if not all(w >= 0 for w in rbp_observation_weights):
            raise SimpleICPException(
                "All elements of rbp_observation_weights must be >= 0."
            )
        if not any(np.isfinite(rbp_observation_weights)):
            raise SimpleICPException(
                "At least one element in rbp_observation_weights must be finite."
            )
