"""The port's CorrPts and metrics against the JAX package's, on the CPU in
float64, modelled on tests/test_corrpts.py and tests/test_api.py.

Tolerances: matches, kept correspondences and rejections equal (integer
decisions); point-to-plane distances within 1e-6 (the normals are stored
as float32 columns in both packages, and their last bits differ); the
metrics within 1e-12 relative (sums of the same nearest-neighbour
distances, whose last bits differ through XLA's fused multiply-adds).
"""

import numpy as np
import pytest
import torch

import simpleicp_tpu as J
import simpleicp_tpu_torch as T
from simpleicp_tpu.metrics import chamfer_distance as j_chamfer
from simpleicp_tpu.metrics import nn_rmse as j_nn_rmse
from simpleicp_tpu.metrics import rotation_angle_deg as j_rotation_angle
from simpleicp_tpu_torch.metrics import chamfer_distance, nn_rmse, rotation_angle_deg

F64 = dict(device="cpu", dtype=torch.float64)


def _clouds(mod, seed=801, n=3000):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, size=(n, 2))
    X1 = np.column_stack([xy, 0.1 * xy[:, 0] + 0.05 * xy[:, 1] + 0.02 * np.sin(3 * xy[:, 0])])
    X2 = X1[rng.permutation(n)] + np.array([0.01, -0.02, 0.005])
    pc1, pc2 = mod.PointCloud(X1), mod.PointCloud(X2)
    pc1.select_n_points(1200)
    kw = {} if mod is J else F64
    pc1.estimate_normals(10, **kw)
    pc2.estimate_normals(10, **kw)
    return pc1, pc2, (mod.CorrPts(pc1, pc2) if mod is J else mod.CorrPts(pc1, pc2, **F64))


def test_corrpts_pipeline_matches_jax(tmp_path):
    """match -> planarity -> point-to-plane band -> angle extension ->
    export, stage by stage."""
    _, _, cj = _clouds(J)
    _, _, ct = _clouds(T)
    for step in (lambda c: c.match(),
                 lambda c: c.reject_wrt_planarity(0.3),
                 lambda c: c.reject_wrt_point_to_plane_distances(),
                 lambda c: c.reject_wrt_to_angle_between_normals(max_angle_deg=20.0)):
        step(cj)
        step(ct)
        np.testing.assert_array_equal(ct.idx_pc1, cj.idx_pc1)
        np.testing.assert_array_equal(ct.idx_pc2, cj.idx_pc2)
        np.testing.assert_allclose(ct.point_to_plane_distances,
                                   cj.point_to_plane_distances, rtol=0, atol=1e-6)
    assert 0 < ct.num_corr_pts < 1200
    cj.write_xyz(tmp_path / "j.xyz")
    ct.write_xyz(tmp_path / "t.xyz")
    a = np.loadtxt(tmp_path / "t.xyz", comments="//")
    np.testing.assert_allclose(a, np.loadtxt(tmp_path / "j.xyz", comments="//"),
                               rtol=0, atol=1e-6)
    assert a.shape == (ct.num_corr_pts, 7)


def test_corrpts_mad_band_and_errors():
    """The MAD band drops an injected gross outlier only; the out-of-order
    and not-implemented calls raise as in the JAX package."""
    rng = np.random.default_rng(802)
    _, _, ct = _clouds(T, 803)
    with pytest.raises(T.CorrPtsException):
        ct.reject_wrt_planarity(0.3)
    with pytest.raises(NotImplementedError):
        ct.reject_wrt_to_angle_between_normals()
    ct.match()
    ct.point_to_plane_distances = rng.normal(0.0, 0.01, ct.num_corr_pts)
    ct.point_to_plane_distances[0] = 100.0
    _, _, cj = _clouds(J, 803)
    cj.match()
    cj.point_to_plane_distances = ct.point_to_plane_distances.copy()
    n1 = ct.num_corr_pts
    cj.reject_wrt_point_to_plane_distances()
    ct.reject_wrt_point_to_plane_distances()
    np.testing.assert_array_equal(ct.idx_pc1, cj.idx_pc1)
    assert ct.num_corr_pts < n1 and np.abs(ct.point_to_plane_distances).max() < 1.0
    pc1 = T.PointCloud(np.random.default_rng(804).uniform(0, 1, (50, 3)))
    cp = T.CorrPts(pc1, T.PointCloud(pc1.X), **F64)
    cp.match()
    with pytest.raises(T.CorrPtsException, match="no normals"):
        cp.reject_wrt_point_to_plane_distances()


def test_metrics_match_jax():
    rng = np.random.default_rng(805)
    X = rng.uniform(-1, 1, (2000, 3))
    Y = X[::2] + rng.normal(0, 0.002, (1000, 3))
    assert nn_rmse(X, X, **F64) == 0.0 and chamfer_distance(X, X, **F64) == 0.0
    np.testing.assert_allclose(nn_rmse(Y, X, **F64), j_nn_rmse(Y, X), rtol=1e-12)
    np.testing.assert_allclose(nn_rmse(Y, X, step=3, **F64), j_nn_rmse(Y, X, step=3),
                               rtol=1e-12)
    np.testing.assert_allclose(chamfer_distance(X, Y, **F64), j_chamfer(X, Y), rtol=1e-12)
    a = np.deg2rad(5.0)
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    assert rotation_angle_deg(np.eye(3), Rz) == j_rotation_angle(np.eye(3), Rz)
    np.testing.assert_allclose(rotation_angle_deg(np.eye(4), Rz), 5.0, atol=1e-9)
