"""The ``CorrPts`` correspondence engine of the reference simpleICP Python.

Inside ``icp_register`` matching and rejection are part of the loop; this
class is the interactive surface for users who drive the stages by hand:
match two point clouds, reject correspondences, export them. Matching runs
the 1-NN kernel on the card (``device``, ``dtype`` as everywhere in the
port: the card and float32 by default); the state (index arrays,
distances) lives on the host in numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.stats import masked_mad, masked_median
from .utils.device import DeviceLike, resolve
from .utils.xyz_io import write_correspondences_xyz


class CorrPtsException(Exception):
    """Raised when CorrPts is used out of order (e.g. reject before match)."""


class CorrPts:
    """Correspondences between two point clouds.

    Args:
        pc1: fixed cloud (needs normals for point-to-plane distances:
            ``estimate_normals`` or user-supplied columns).
        pc2: movable cloud.
        device, dtype: where and in which dtype ``match`` computes.
    """

    def __init__(self, pc1, pc2, *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        self.pc1 = pc1
        self.pc2 = pc2
        self.device = device
        self.dtype = dtype
        self.idx_pc1: Optional[np.ndarray] = None  # indices into pc1
        self.idx_pc2: Optional[np.ndarray] = None  # indices into pc2
        self.point_to_plane_distances: Optional[np.ndarray] = None

    @property
    def num_corr_pts(self) -> int:
        return 0 if self.idx_pc1 is None else len(self.idx_pc1)

    @property
    def X1(self) -> np.ndarray:
        return self.pc1.X[self.idx_pc1]

    @property
    def X2(self) -> np.ndarray:
        return self.pc2.X[self.idx_pc2]

    @property
    def normals1(self) -> np.ndarray:
        return np.column_stack(
            [self.pc1["nx"][self.idx_pc1], self.pc1["ny"][self.idx_pc1],
             self.pc1["nz"][self.idx_pc1]]
        )

    @property
    def planarity1(self) -> np.ndarray:
        return np.asarray(self.pc1["planarity"])[self.idx_pc1]

    def match(self) -> None:
        """The nearest selected pc2 point of each selected pc1 point, and
        the signed point-to-plane distances when pc1 carries normals."""
        from .ops.knn import nn_search

        dev, dtype = resolve(self.device, self.dtype)
        idx1 = self.pc1.idx_selected
        idx2 = self.pc2.idx_selected
        _, nn = nn_search(
            torch.as_tensor(self.pc1.X[idx1], dtype=dtype, device=dev),
            torch.as_tensor(self.pc2.X[idx2], dtype=dtype, device=dev),
        )
        self.idx_pc1 = idx1
        self.idx_pc2 = idx2[nn.cpu().numpy()]
        if "nx" in self.pc1:
            self.__compute_point_to_plane_distances()

    def __compute_point_to_plane_distances(self) -> None:
        # d_i = (p2 - p1) . n1
        d = np.einsum("ij,ij->i", self.X2 - self.X1, self.normals1)
        self.point_to_plane_distances = d

    def _require_matched(self) -> None:
        if self.idx_pc1 is None:
            raise CorrPtsException("match() must be called first.")

    def _keep(self, keep: np.ndarray) -> None:
        self.idx_pc1 = self.idx_pc1[keep]
        self.idx_pc2 = self.idx_pc2[keep]
        if self.point_to_plane_distances is not None:
            self.point_to_plane_distances = self.point_to_plane_distances[keep]

    def reject_wrt_planarity(self, min_planarity: float) -> None:
        """Drop correspondences whose planarity is below the threshold: each
        cloud's ``planarity`` column is checked if it has one."""
        self._require_matched()
        if "planarity" in self.pc1:
            self._keep(self.planarity1 >= min_planarity)
        if "planarity" in self.pc2:
            pl2 = np.asarray(self.pc2["planarity"])[self.idx_pc2]
            self._keep(pl2 >= min_planarity)

    def reject_wrt_point_to_plane_distances(self, mad_scale: float = 1.4826,
                                            factor: float = 3.0) -> None:
        """Drop correspondences outside median +- factor * (mad_scale * MAD)
        of the point-to-plane distances (computed in float64 on the host)."""
        self._require_matched()
        if self.point_to_plane_distances is None:
            raise CorrPtsException(
                "point-to-plane distances unavailable: pc1 has no normals."
            )
        d = torch.from_numpy(np.asarray(self.point_to_plane_distances, np.float64))
        mask = torch.ones(d.shape[0], dtype=torch.bool)
        med = float(masked_median(d, mask))
        sigma = float(masked_mad(d, mask, scale=mad_scale))
        keep = np.abs(self.point_to_plane_distances - med) <= factor * sigma
        self._keep(keep)

    def reject_wrt_to_angle_between_normals(
        self, max_angle_deg: Optional[float] = None
    ) -> None:
        """Without an argument: declared but not implemented, as in the
        reference. With ``max_angle_deg`` (an extension of the JAX package):
        drop pairs whose normals, as unoriented lines (|n1.n2|), differ by
        more than the angle; both clouds need nx/ny/nz."""
        if max_angle_deg is None:
            raise NotImplementedError
        self._require_matched()
        for pc, name in ((self.pc1, "pc1"), (self.pc2, "pc2")):
            if "nx" not in pc:
                raise CorrPtsException(
                    f"{name} has no normals: call estimate_normals first."
                )
        n2 = np.column_stack(
            [self.pc2["nx"][self.idx_pc2], self.pc2["ny"][self.idx_pc2],
             self.pc2["nz"][self.idx_pc2]]
        )
        cos = np.abs(np.einsum("ij,ij->i", self.normals1, n2))
        self._keep(cos >= np.cos(np.radians(max_angle_deg)))

    def write_xyz(self, path) -> None:
        """CloudCompare-compatible export of the correspondences."""
        self._require_matched()
        d = self.point_to_plane_distances
        if d is None:
            d = np.zeros(self.num_corr_pts)
        write_correspondences_xyz(path, self.X1, self.X2, d)
