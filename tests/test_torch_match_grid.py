"""The grid engines inside the port's registration (CPU, plain versions)
against the JAX package: the static-grid matcher (``match_method="grid"``),
the grid overlap gate (``gate_method="grid"``), their resolution from
``"auto"``, their cell caps from numpy and tensor inputs, and
``PointCloud.select_in_range`` above 2^41 pairs. Mirrors
tests/test_match_grid.py and the registration cases of
tests/test_gridhash.py.

Tolerances, float64: those of tests/test_torch_gate.py (integer decisions,
selection and matches equal; H within 1e-9, ...). Against the port's own
brute engines and between numpy and tensor inputs: none (the same matches
or the same mask give the same run, bit for bit).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu.ops.gridhash import min_dist_sq_grid as jax_min_dist_sq_grid
from simpleicp_tpu_torch import ERR_NO_OVERLAP, ERR_OK, IcpConfig, icp_register
from simpleicp_tpu_torch import api
from simpleicp_tpu_torch.models import icp
from simpleicp_tpu_torch.ops import gridhash
from simpleicp_tpu_torch.utils import sync
from test_torch_dilate_gate import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_gate import _assert_parity, _pair, _run_both

F64 = dict(device="cpu", dtype=torch.float64)


def _cloud_pair(seed, n=4000, angle=0.04, t=(0.05, -0.03, 0.02)):
    """tests/test_match_grid.py's surface and its rigid motion, with the
    movable cloud an independent sample of the surface: a moved copy
    converges to residuals of rounding size, where the rejection's
    median/MAD decides on rounding noise and no two implementations need
    agree."""
    rng = np.random.default_rng(seed)

    def surface():
        xy = rng.uniform(-1, 1, (n, 2))
        return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) * np.cos(3 * xy[:, 1])])

    X_fix, S = surface(), surface()
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    X_mov = (S - np.mean(S, 0)) @ R.T + np.mean(S, 0) + np.asarray(t)
    return X_fix, X_mov


@pytest.mark.parametrize("solver", ["nonlinear", "linearized"])
def test_grid_matcher_matches_jax(solver):
    """tests/test_match_grid.py:30-73 under both solvers, gated, with the
    trajectory: every iteration's matches equal the JAX package's."""
    X_fix, X_mov = _cloud_pair(701)
    jcfg = JaxConfig(solver=solver, max_overlap_distance=0.5, correspondences=500,
                     match_method="grid")
    jres, tres, last = _run_both(jcfg, X_fix, X_mov)
    _assert_parity(jres, tres, last)
    assert int(tres.error_code) == ERR_OK and bool(tres.converged)


def test_grid_matcher_equals_the_brute_matcher():
    """Within the radius the grid matcher is exact: with the nonlinear
    solver (H orthogonal) its matches, hence its whole run, equal the brute
    matcher's bit for bit (tests/test_match_grid.py:30)."""
    X_fix, X_mov = _cloud_pair(702)
    base = IcpConfig(solver="nonlinear", max_overlap_distance=0.5, correspondences=500,
                     record_trajectory=True)
    grid = icp_register(X_fix, X_mov, dataclasses.replace(base, match_method="grid"), **F64)
    brute = icp_register(X_fix, X_mov, dataclasses.replace(base, match_method="brute"), **F64)
    for f in grid._fields:
        if f != "iter_dists":  # the grid's d2 is taken in the movable frame
            assert torch.equal(getattr(grid, f), getattr(brute, f)), f
    torch.testing.assert_close(grid.iter_dists, brute.iter_dists, rtol=0, atol=1e-12)


def test_grid_matcher_explicit_radius_no_gate():
    """tests/test_match_grid.py:76: match_radius without the overlap gate."""
    X_fix, X_mov = _cloud_pair(703, n=2000)
    jcfg = JaxConfig(correspondences=300, solver="nonlinear", match_method="grid",
                     match_radius=0.6)
    jres, tres, last = _run_both(jcfg, X_fix, X_mov)
    _assert_parity(jres, tres, last)
    assert int(tres.error_code) == ERR_OK


def test_grid_matcher_drops_rows_beyond_the_radius():
    """tests/test_match_grid.py:89: a far island of fixed points has no
    movable point within match_radius; its rows are dropped (m_valid) every
    iteration, as in the JAX package."""
    X_fix, X_mov = _cloud_pair(704, n=2000, angle=0.0, t=(0.0, 0.0, 0.0))
    island = np.random.default_rng(705).uniform(9.0, 10.0, (200, 3))
    X_fix = np.vstack([X_fix, island])
    jcfg = JaxConfig(correspondences=400, solver="linearized", match_method="grid",
                     match_radius=0.3, min_planarity=0.0)
    jres, tres, last = _run_both(jcfg, X_fix, X_mov)
    _assert_parity(jres, tres, last)
    n_it = int(tres.n_iterations)
    assert int(tres.error_code) == ERR_OK
    assert tres.iter_counts[:n_it].max() < 400
    # the island's rows (the last selected ones) never match
    island_rows = tres.sel_idx >= 2000
    assert island_rows.sum() > 20 and not tres.iter_masks[0][island_rows].any()


@pytest.mark.parametrize("obs", [False, True])
def test_grid_gate_matches_jax_and_the_brute_gate(obs):
    """The grid gate's mask is the brute gate's: the same selection and the
    same run bit for bit; and the JAX package's grid-gated run within the
    gate tests' tolerances (with an initial transform from observations,
    which the numpy cap is counted under)."""
    X_fix, X_mov, _ = _pair(706, n=2500)
    kw = (dict(rbp_observed_values=np.array([0.01, -0.01, 0.02, 0.04, -0.03, 0.02]),
               rbp_observation_weights=np.zeros(6)) if obs else {})
    jcfg = JaxConfig(correspondences=300, max_overlap_distance=0.2, gate_method="grid",
                     max_iterations=40)
    jres, tres, last = _run_both(jcfg, X_fix, X_mov, **kw)
    _assert_parity(jres, tres, last)
    assert int(tres.error_code) == ERR_OK and bool(tres.sel_valid.all())
    cfg = IcpConfig(correspondences=300, max_overlap_distance=0.2, max_iterations=40)
    grid = icp_register(X_fix, X_mov, dataclasses.replace(cfg, gate_method="grid"), **kw, **F64)
    brute = icp_register(X_fix, X_mov, dataclasses.replace(cfg, gate_method="brute"), **kw, **F64)
    for f in grid._fields:
        assert torch.equal(getattr(grid, f), getattr(brute, f)), f


def test_grid_gate_no_overlap_flag():
    """tests/test_gridhash.py:49 through the registration: nothing within
    the radius gives ERR_NO_OVERLAP and no iteration, as in the JAX
    package."""
    X_fix, X_mov, _ = _pair(707, n=1500)
    jcfg = JaxConfig(correspondences=200, max_overlap_distance=0.5, gate_method="grid")
    jres, tres, last = _run_both(jcfg, X_fix, X_mov + 100.0)
    assert int(tres.error_code) == ERR_NO_OVERLAP and int(tres.n_iterations) == 0
    _assert_parity(jres, tres, last)


CAP_CASES = {
    "grid_matcher": dict(correspondences=300, max_overlap_distance=0.5, match_method="grid",
                         max_iterations=30),
    "grid_gate": dict(correspondences=300, max_overlap_distance=0.5, gate_method="grid",
                      max_iterations=30),
}


@pytest.mark.parametrize("name", list(CAP_CASES))
def test_numpy_and_tensor_inputs_give_one_result(name):
    """tests/test_match_grid.py:234: a numpy movable cloud has its cell cap
    counted on the host (no host read), a tensor on its device (one counted
    host read of the occupancy); any valid cap gives the same matches, so
    the results are bit-equal. An explicit cap reads nothing."""
    X_fix, X_mov = _cloud_pair(708, n=4001)
    cfg = IcpConfig(**CAP_CASES[name])
    brute = dataclasses.replace(cfg, match_method="brute", gate_method="brute")
    sync.reset_host_reads()
    icp_register(X_fix, X_mov, brute, **F64)
    reads_brute = sync.host_reads()
    runs, reads = {}, {}
    cap_field = "match_cell_cap" if name == "grid_matcher" else "grid_cell_cap"
    for label, X, c in (("numpy", X_mov, cfg), ("tensor", torch.from_numpy(X_mov), cfg),
                        ("explicit cap", torch.from_numpy(X_mov),
                         dataclasses.replace(cfg, **{cap_field: 1000}))):
        sync.reset_host_reads()
        runs[label] = icp_register(X_fix, X, c, **F64)
        reads[label] = sync.host_reads()
    assert int(runs["numpy"].error_code) == ERR_OK
    for label in ("tensor", "explicit cap"):
        for f in runs["numpy"]._fields:
            assert torch.equal(getattr(runs[label], f), getattr(runs["numpy"], f)), (label, f)
    n_it = int(runs["numpy"].n_iterations)
    # the grid matcher reads no extra flag an iteration; the loop's reads
    # follow the iterations, which may differ from the brute run's
    base = reads["numpy"]
    assert reads == {"numpy": base, "tensor": base + 1, "explicit cap": base}
    if name == "grid_gate":
        assert base == reads_brute
    assert n_it > 1


def test_device_cap_is_the_rounded_exact_occupancy(monkeypatch):
    """A tensor cloud's cap is its exact occupancy rounded up to a multiple
    of 8; a numpy cloud's is grid_cell_cap (both dtypes, plus 4)."""
    X = np.random.default_rng(709).uniform(0, 1, (3000, 3))
    caps = {}
    orig = gridhash.grid_query_sorted

    def spy(*args, cell_cap, **kw):
        caps.setdefault("seen", []).append(cell_cap)
        return orig(*args, cell_cap=cell_cap, **kw)

    monkeypatch.setattr(icp, "grid_query_sorted", spy)
    cfg = IcpConfig(correspondences=50, max_overlap_distance=0.1, gate_method="grid",
                    max_iterations=2)
    icp_register(X, X, cfg, **F64)
    icp_register(torch.from_numpy(X), torch.from_numpy(X), cfg, **F64)
    exact = int(gridhash.grid_build_cap(torch.from_numpy(X), 0.1)[1])
    assert caps["seen"] == [gridhash.grid_cell_cap(X, 0.1), -(-exact // 8) * 8]


def test_auto_resolves_to_the_grid_matcher():
    """"auto" picks the grid matcher above 2^38 pairs per iteration when a
    radius is set (tests/test_match_grid.py:131-170: the big-C config, the
    boundary, a match_radius without the gate); explicit engines pass
    through. No cloud is allocated."""
    cfg = IcpConfig(correspondences=100_000, max_overlap_distance=1.0)
    assert icp._resolve_engines(cfg, 12_500_000, 12_500_000).match_method == "grid"
    assert icp._resolve_engines(IcpConfig(correspondences=100_000), 10, 12_500_000
                                ).match_method == "brute"
    at = icp.MATCH_AUTO_PAIR_BUDGET // 8
    eight = IcpConfig(correspondences=8, max_overlap_distance=1.0)
    assert icp._resolve_engines(eight, 10, at).match_method == "brute"
    assert icp._resolve_engines(eight, 10, at + 1).match_method == "grid"
    radius = IcpConfig(correspondences=8, match_radius=0.5)
    assert icp._resolve_engines(radius, 10, at + 1).match_method == "grid"
    for method in ("grid", "brute"):
        explicit = IcpConfig(correspondences=8, match_radius=0.5, match_method=method)
        assert icp._resolve_engines(explicit, 10, at + 1).match_method == method


def test_select_in_range_grid_above_2_41_pairs(monkeypatch):
    """PointCloud.select_in_range above 2^41 pairs takes the grid cell list
    (host cap), which keeps the brute 1-NN's set and the JAX package's grid
    mask (its threshold is lowered here so that small clouds reach it)."""
    X_fix, X_mov, _ = _pair(710, n=3000)
    r = 0.15
    kept = {}
    for label, limit in (("brute", 2**41), ("grid", 100)):
        monkeypatch.setattr(api, "_SELECT_BRUTE_PAIRS", limit)
        pc = api.PointCloud(X_fix)
        pc.select_in_range(X_mov, r, **F64)
        kept[label] = pc.idx_selected
    np.testing.assert_array_equal(kept["grid"], kept["brute"])
    cap = gridhash.grid_cell_cap(X_mov, r)
    jd2 = np.asarray(jax_min_dist_sq_grid(jnp.asarray(X_fix), jnp.asarray(X_mov), r,
                                          cell_cap=cap))
    np.testing.assert_array_equal(kept["grid"], np.flatnonzero(jd2 <= r ** 2))
    assert 0 < len(kept["grid"]) < len(X_fix)
