"""Tensor operations of the pipeline and the wrappers of its CUDA kernels:
rigid transforms, nearest-neighbour search, normal estimation, masked
robust statistics. Importing them builds no kernel."""

from .transform import (
    apply_H,
    euler_angles_to_rotation_matrix,
    euler_angles_to_linearized_rotation_matrix,
    rotation_matrix_to_euler_angles,
    make_H,
    invert_H,
    rbp_to_H,
)
from .knn import knn_search, nn_search, nn_search_auto, min_dist_sq
from .gridhash import grid_cell_cap, min_dist_sq_grid, nn_within_radius_grid
from .normals import eigh3x3, estimate_normals_from_neighborhoods
from .stats import masked_mean, masked_std, masked_median, masked_mad
from . import dilate_cuda, knn_cuda, solver_cuda

# The kernel wrappers' launch counters, one ``LAUNCHES`` dict a wrapper
# module: a CUDA graph's capture leaves them as it found them, and each
# replay adds what the graph launches (``models/loop_graph.py``).
LAUNCH_COUNTERS = (knn_cuda.LAUNCHES, solver_cuda.LAUNCHES, dilate_cuda.LAUNCHES)

__all__ = [
    "grid_cell_cap",
    "min_dist_sq_grid",
    "nn_search_auto",
    "nn_within_radius_grid",
    "apply_H",
    "euler_angles_to_rotation_matrix",
    "euler_angles_to_linearized_rotation_matrix",
    "rotation_matrix_to_euler_angles",
    "make_H",
    "invert_H",
    "rbp_to_H",
    "knn_search",
    "nn_search",
    "min_dist_sq",
    "eigh3x3",
    "estimate_normals_from_neighborhoods",
    "masked_mean",
    "masked_std",
    "masked_median",
    "masked_mad",
]
