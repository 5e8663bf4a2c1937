"""The port's class API against the JAX package's: SimpleICP.run,
PointCloud and the logged lines, on the CPU in float64.

Both run the same gated surface pair (the fixed cloud over x in [-2, 2],
the movable over x in [-1, 3], moved by a known motion). Tolerances, as in
tests/test_torch_icp.py: H, the parameters and the transformed cloud
within 1e-9; residuals within 1e-8; uncertainties within 1e-7; normals
within 1e-6 (they are stored as float32 columns, as in the JAX package);
selections, counts and the logged lines equal (except the wall time of
"Finished in").
"""

import logging

import numpy as np
import pytest
import torch

import simpleicp_tpu as J
import simpleicp_tpu_torch as T

F64 = dict(device="cpu", dtype=torch.float64)


def _surface(rng, n, x_lo, x_hi):
    xy = np.column_stack([rng.uniform(x_lo, x_hi, n), rng.uniform(-2, 2, n)])
    return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])


def _pair(seed=701, n=2500):
    rng = np.random.default_rng(seed)
    shift = np.array([0.04, -0.03, 0.02])
    return _surface(rng, n, -2, 2), _surface(rng, n, -1, 3) - shift, shift


def _run(mod, X_fix, X_mov, caplog, pc_kw=None, **run_kw):
    """One SimpleICP.run; returns (outputs, pc1, pc2, logged lines)."""
    icp = mod.SimpleICP(verbose=False, **({} if mod is J else F64))
    pc1, pc2 = mod.PointCloud(X_fix.copy()), mod.PointCloud(X_mov.copy())
    for name, col in (pc_kw or {}).items():
        (pc1 if name.startswith("fix_") else pc2)[name[4:]] = col
    icp.add_point_clouds(pc1, pc2)
    caplog.clear()
    out = icp.run(**run_kw)
    lines = [r.getMessage() for r in caplog.records
             if r.name.startswith(mod.__name__ + ".")]
    return out, pc1, pc2, lines


@pytest.fixture
def logs(caplog):
    caplog.set_level(logging.INFO, logger="simpleicp_tpu")
    caplog.set_level(logging.INFO, logger="simpleicp_tpu_torch")
    return caplog


def test_run_matches_jax_gated_with_debug_files(tmp_path, logs):
    """A gated run with an initial rotation observation and debug files:
    H, the parameter table, residuals, the transformed cloud, pc1's new
    selection and normal columns, the debug files and every logged line."""
    X_fix, X_mov, shift = _pair()
    kw = dict(correspondences=300, max_overlap_distance=0.25, max_iterations=40,
              rbp_observed_values=(0.0, 0.0, 0.5, 0.0, 0.0, 0.0))
    (Hj, Xj, rj, resj), pj1, _, lj = _run(J, X_fix, X_mov, logs,
                                         debug_dirpath=str(tmp_path / "j"), **kw)
    (Ht, Xt, rt, rest), pt1, pt2, lt = _run(T, X_fix, X_mov, logs,
                                           debug_dirpath=str(tmp_path / "t"), **kw)
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(Ht[:3, 3], shift, atol=2e-3)
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(pt2.X, Xt)
    np.testing.assert_allclose(rest, resj, rtol=0, atol=1e-8)
    for name in ("alpha1", "alpha2", "alpha3", "tx", "ty", "tz"):
        a, b = getattr(rt, name), getattr(rj, name)
        assert (a.observed_value, a.observation_weight) == (b.observed_value, b.observation_weight)
        assert a.estimated_value == pytest.approx(b.estimated_value, abs=1e-9)
        assert a.estimated_uncertainty == pytest.approx(b.estimated_uncertainty, abs=1e-7)
        assert a.scale_for_logging == b.scale_for_logging
    np.testing.assert_allclose(rt.H, rj.H, rtol=0, atol=1e-9)
    # pc1: the correspondence selection and the estimated normal columns
    np.testing.assert_array_equal(pt1.idx_selected, pj1.idx_selected)
    assert pt1.num_selected_points == 300 and X_fix[pt1.idx_selected, 0].min() > -1.3
    for c in ("nx", "ny", "nz", "planarity"):
        assert pt1[c].dtype == np.float32
        np.testing.assert_allclose(pt1[c], pj1[c], rtol=0, atol=1e-6, equal_nan=True)
    # the logged lines, except the wall time and the debug directory's name
    assert [m.replace(str(tmp_path / "t"), "D") for m in lt if not m.startswith("Finished in")] == \
        [m.replace(str(tmp_path / "j"), "D") for m in lj if not m.startswith("Finished in")]
    assert "Consider partial overlap of point clouds ..." in lt
    assert any(m.lstrip().startswith("orig:0") for m in lt)
    assert sum(m.startswith("Finished in ") for m in lt) == 1
    # the debug files: same names, same numbers
    fj = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert fj == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert "iteration000_preoptim_correspondences.xyz" in fj and len(fj) > 4
    for name in fj:
        a = np.loadtxt(tmp_path / "t" / name, comments="//", ndmin=2)
        b = np.loadtxt(tmp_path / "j" / name, comments="//", ndmin=2)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 if "pcmov" in name else 1e-8,
                                   err_msg=name)


def test_run_user_normals_and_movable_planarity(logs):
    """pc1 with nx/ny/nz/planarity columns (no normal estimate, so no
    'Estimate normals' line) and pc2 with a planarity column, ungated and
    without centering."""
    X_fix, X_mov, _ = _pair(702)
    rng = np.random.default_rng(703)
    pc1 = J.PointCloud(X_fix.copy())
    pc1.estimate_normals(10)
    cols = {f"fix_{c}": np.asarray(pc1[c]) for c in ("nx", "ny", "nz", "planarity")}
    cols["mov_planarity"] = rng.uniform(0.0, 1.0, len(X_mov)).astype(np.float32)
    kw = dict(correspondences=250, max_iterations=30, center=False, neighbors=8)
    (Hj, _, _, resj), _, _, lj = _run(J, X_fix, X_mov, logs, pc_kw=cols, **kw)
    (Ht, _, _, rest), _, _, lt = _run(T, X_fix, X_mov, logs, pc_kw=cols, **kw)
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rest, resj, rtol=0, atol=1e-8)
    assert "Estimate normals of selected points ..." not in lt
    assert [m for m in lt if not m.startswith("Finished in")] == \
        [m for m in lj if not m.startswith("Finished in")]


def test_run_exceptions_match_jax():
    """No overlap, too few correspondences, bad arguments and a run without
    clouds raise SimpleICPException with the JAX package's messages; a
    sharded run raises NotImplementedError naming its ROADMAP item;
    chunked dispatch runs and gives the monolithic H."""
    X_fix, X_mov, _ = _pair(704, n=800)
    cases = [
        dict(max_overlap_distance=0.5, rbp_observed_values=(0, 0, 0, 40.0, 0, 0),
             correspondences=100),
        dict(min_planarity=0.999, correspondences=100, max_iterations=5),
        dict(distance_weights=0),
        dict(rbp_observed_values=(1.0, 2.0)),
        dict(rbp_observation_weights=(1, 1, 1, 1, 1, -1)),
        dict(rbp_observation_weights=(np.inf,) * 6),
    ]
    for kw in cases:
        msgs = []
        for mod in (J, T):
            icp = mod.SimpleICP(verbose=False, **({} if mod is J else F64))
            icp.add_point_clouds(mod.PointCloud(X_fix), mod.PointCloud(X_mov))
            with pytest.raises(mod.SimpleICPException) as e:
                icp.run(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw
    with pytest.raises(T.SimpleICPException, match="add_point_clouds"):
        T.SimpleICP(verbose=False, **F64).run()
    icp = T.SimpleICP(verbose=False, **F64)
    icp.add_point_clouds(T.PointCloud(X_fix), T.PointCloud(X_mov))
    with pytest.raises(NotImplementedError, match="item 14"):
        icp.run(num_devices=2)
    # chunked dispatch runs: the same H as the monolithic run, bit for bit
    # (a run adds normal columns to pc1, so each run gets its own clouds)
    H = []
    for kw in (dict(dispatch="monolithic"),
               dict(dispatch="chunked", chunk_iterations=1, stall_policy="wait",
                    program_budget_s=0.5)):
        icp = T.SimpleICP(verbose=False, **F64)
        icp.add_point_clouds(T.PointCloud(X_fix), T.PointCloud(X_mov))
        H.append(icp.run(**kw)[0])
    np.testing.assert_array_equal(H[1], H[0])


def test_pointcloud_ops_match_jax():
    """select_in_range (the brute 1-NN), estimate_normals (the k-NN),
    select_n_points and the column accessors."""
    rng = np.random.default_rng(705)
    X = _surface(rng, 1500, -2, 2)
    other = _surface(rng, 1500, -1, 3)
    pcs = {}
    for mod in (J, T):
        pc = mod.PointCloud(X.copy())
        pc.select_n_points(900)
        kw = {} if mod is J else F64
        pc.select_in_range(other, 0.1, **kw)
        pc.estimate_normals(12, **kw)
        pcs[mod] = pc
    np.testing.assert_array_equal(pcs[T].idx_selected, pcs[J].idx_selected)
    assert 300 < pcs[T].num_selected_points < 900
    for c in ("nx", "ny", "nz", "planarity"):
        np.testing.assert_allclose(pcs[T][c], pcs[J][c], rtol=0, atol=1e-6, equal_nan=True)
    with pytest.raises(T.PointCloudException):
        T.PointCloud({"x": np.zeros(3), "y": np.zeros(3)})
    with pytest.raises(T.PointCloudException, match="3 columns"):
        pcs[T].select_in_range(np.zeros((4, 2)), 1.0, **F64)
    assert pcs[T].columns == pcs[J].columns
