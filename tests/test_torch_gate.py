"""The gated path of the PyTorch port (CPU, plain versions) against the JAX
package: the selection formula, the overlap gate, and gated icp_register
with observations, user normals and planarity, movable planarity, the
recorded trajectory and both error codes.

The clouds are a partial-overlap surface pair: the fixed cloud spans
x in [-2, 2], the movable cloud an independent sample over x in [-1, 3]
moved by a known motion, so a radius of a few point spacings cuts about a
quarter of the fixed cloud away.

Tolerances, float64, as in tests/test_torch_icp.py and for the same
reasons (XLA contracts sums into fused multiply-adds, PyTorch does not):
integer decisions (iterations, selection, counts, masks, matches) equal;
H and p within 1e-9; residual statistics within 1e-8; normals within
1e-10; uncertainties within 1e-7. The selection formula is bit-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu import icp_register as jax_register
from simpleicp_tpu.models.icp import _select_n as jax_select_n
from simpleicp_tpu.models.icp import round_linspace as jax_round_linspace
from simpleicp_tpu_torch import (
    ERR_NO_OVERLAP,
    ERR_TOO_FEW_CORRESPONDENCES,
    IcpConfig,
    config_from_dict,
    icp_register,
    result_to_numpy,
)
from simpleicp_tpu_torch.models.icp import _icp_register, _select_n, round_linspace
from simpleicp_tpu_torch.utils import sync


def _surface(rng, n, x_lo, x_hi):
    xy = np.column_stack([rng.uniform(x_lo, x_hi, n), rng.uniform(-2, 2, n)])
    return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])


def _motion():
    a = np.array([0.02, -0.015, 0.03])
    c1, s1, c2, s2, c3, s3 = (np.cos(a[0]), np.sin(a[0]), np.cos(a[1]),
                              np.sin(a[1]), np.cos(a[2]), np.sin(a[2]))
    R = np.array([
        [c2 * c3, -c2 * s3, s2],
        [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2],
        [s1 * s3 - c1 * s2 * c3, s1 * c3 + c1 * s2 * s3, c1 * c2],
    ])
    return R, np.array([0.05, -0.04, 0.03])


def _pair(seed=601, n=3000):
    rng = np.random.default_rng(seed)
    R, t = _motion()
    return _surface(rng, n, -2, 2), (_surface(rng, n, -1, 3) - t) @ R, t


# ------------------------------------------------------------ selection


SWEEP = [
    # (C, n_sel) of tests/test_icp.py's bit-equality sweep: the overflow
    # repro, numpy-vs-exact-rational tie cases, powers of two, and the
    # extended domain with over a million exact ties per sweep
    (60_000, 48_059_199), (100_000, 100_100_100), (1000, 1_000_000),
    (1000, 100_000_000), (100_000, 1_000_000), (79_133, 1_000_000),
    (79_133, 2_636_235), (75_395, 100_000_000), (76_215, 100_000_000),
    (105_361, 1_000_007), (1567, 33_554_432), (4909, 98_102_698),
    (1024, 33_554_432), (4097, 2**27 + 13), (65_536, 2**30 + 1),
    (2**21, 100_000_000), (2**22, 99_999_999), (2**21 + 1, 99_614_721),
    (2**22 - 1, 98_566_098),
    # small and exactly-divisible spans
    (6, 6), (7, 13), (497, 33_554_432), (1000, 1001), (1000, 2998),
]


def test_round_linspace_bit_equal_to_jax_and_numpy():
    """Bit-equal to the JAX package's int32 emulation and to numpy on the
    sweep of tests/test_icp.py plus 5 random (C, n_sel) pairs."""
    rng = np.random.default_rng(123)
    cases = SWEEP + [(int(rng.integers(1000, 150_001)), int(rng.integers(10**6, 10**8)))
                     for _ in range(5)]
    fn = jax.jit(jax_round_linspace, static_argnums=1)
    for C, n_sel in cases:
        got = round_linspace(n_sel, C).numpy()
        ref = np.round(np.linspace(0, n_sel - 1, C)).astype(np.int64)
        np.testing.assert_array_equal(got, ref, err_msg=f"numpy C={C} n_sel={n_sel}")
        np.testing.assert_array_equal(
            got, np.asarray(fn(jnp.int32(n_sel), C), np.int64),
            err_msg=f"JAX C={C} n_sel={n_sel}")


def test_round_linspace_constructed_ties():
    """Every (C, n_sel) with C <= 120 and n_sel <= 20 C: the many exact
    half-integer slots where numpy's two float64 roundings decide."""
    for C in range(6, 121):
        for n_sel in range(C + 1, 20 * C + 1, 7):
            ref = np.round(np.linspace(0, n_sel - 1, C)).astype(np.int64)
            np.testing.assert_array_equal(round_linspace(n_sel, C).numpy(), ref,
                                          err_msg=f"C={C} n_sel={n_sel}")


@pytest.mark.parametrize("nf,n_sel,C", [(5000, 3777, 500), (997, 450, 1000),
                                        (40, 0, 50), (30, 7, 6)])
def test_select_n_equals_jax(nf, n_sel, C):
    """Indices and validity equal to JAX's _select_n, including the invalid
    slots past the selected points (the zero-padded compaction)."""
    rng = np.random.default_rng(nf + n_sel + C)
    mask = np.zeros(nf, bool)
    mask[rng.choice(nf, size=n_sel, replace=False)] = True
    ji, jv = jax_select_n(jnp.asarray(mask), C)
    ti, tv = _select_n(torch.from_numpy(mask), C)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32


# ------------------------------------------------------- gated registration


def _run_both(jcfg, X_fix, X_mov, **kw):
    """JAX (trajectory recorded) and the port (float64, CPU) on the same
    inputs; returns (jax result, port result as numpy, port last matches)."""
    jres = jax_register(X_fix, X_mov, dataclasses.replace(jcfg, record_trajectory=True),
                        dtype=jnp.float64, **kw)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    tres, carry = _icp_register(
        X_fix, X_mov, cfg,
        rbp_observed_values=kw.get("rbp_observed_values"),
        rbp_observation_weights=kw.get("rbp_observation_weights"),
        normals_fix=kw.get("normals_fix"), planarity_fix=kw.get("planarity_fix"),
        planarity_mov=kw.get("planarity_mov"), fixed_prep=None, device="cpu",
        dtype=torch.float64,
    )
    return jres, result_to_numpy(tres), carry.m_idx.numpy()


def _assert_parity(jres, tres, last_m_idx):
    J = {f: np.asarray(getattr(jres, f)) for f in jres._fields}
    n_it = int(J["n_iterations"])
    for f in ("n_iterations", "converged", "error_code", "sel_idx", "sel_valid",
              "iter_counts", "residual_mask", "orig_count"):
        np.testing.assert_array_equal(getattr(tres, f), J[f], err_msg=f)
    if n_it and int(J["error_code"]) == 0:
        np.testing.assert_array_equal(last_m_idx, J["iter_midx"][n_it - 1])
    R = tres.iter_midx.shape[0]
    np.testing.assert_array_equal(tres.iter_midx, J["iter_midx"][:R])
    np.testing.assert_array_equal(tres.iter_masks, J["iter_masks"][:R])
    np.testing.assert_allclose(tres.iter_dists, J["iter_dists"][:R], rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.iter_ps, J["iter_ps"][:R], rtol=0, atol=1e-9)
    for f, tol in (("H", 1e-9), ("p", 1e-9), ("iter_means", 1e-8),
                   ("iter_stds", 1e-8), ("orig_mean", 1e-8), ("orig_std", 1e-8),
                   ("residuals", 1e-8), ("normals", 1e-10), ("planarity", 1e-10),
                   ("uncertainties", 1e-7), ("iter_gn_rel_steps", 1e-12)):
        np.testing.assert_allclose(getattr(tres, f), J[f], rtol=0, atol=tol, err_msg=f)
    np.testing.assert_allclose(tres.distance_weight, J["distance_weight"], rtol=1e-8)
    cov_scale = max(np.abs(J["covariance"]).max(), 1e-300)
    np.testing.assert_allclose(tres.covariance, J["covariance"], rtol=0,
                               atol=1e-7 * cov_scale)
    assert tres._fields == jres._fields


@pytest.mark.parametrize("solver,staging,obs", [
    # initial transform from observations with weight 0, auto distance weight
    ("linearized", "python", "initial"),
    # one observed (finite weight) and one frozen (inf) parameter (only the
    # nonlinear solver takes observations)
    ("nonlinear", "joint", "weighted"),
])
def test_gated_icp_register_matches_jax(solver, staging, obs):
    X_fix, X_mov, t = _pair()
    jcfg = JaxConfig(correspondences=300, max_overlap_distance=0.2, solver=solver,
                     rejection_staging=staging, max_iterations=40,
                     distance_weights=None if obs == "initial" else 1.0)
    if obs == "initial":
        kw = dict(rbp_observed_values=np.array([0.01, -0.01, 0.02, 0.04, -0.03, 0.02]),
                  rbp_observation_weights=np.zeros(6))
    else:
        kw = dict(rbp_observed_values=np.array([0.0, 0.0, 0.03, 0.05, 0.0, 0.0]),
                  rbp_observation_weights=np.array([0.0, 0.0, 50.0, 0.0, 0.0, np.inf]))
    jres, tres, last = _run_both(jcfg, X_fix, X_mov, **kw)
    _assert_parity(jres, tres, last)
    # the gate cut a real part of the fixed cloud, and the selection stays
    # inside the overlap (x >= -1 up to the radius)
    assert int(tres.error_code) == 0 and bool(tres.sel_valid.all())
    assert X_fix[tres.sel_idx, 0].min() > -1.25
    assert (X_fix[:, 0] < -1.25).sum() > 500
    if obs == "initial":
        assert bool(tres.converged)
        np.testing.assert_allclose(tres.H[:3, 3], t, atol=2e-3)
    else:
        assert tres.p[5] == 0.0 and np.isnan(tres.uncertainties[5])


def test_gated_user_normals_and_planarities_match_jax():
    """User-supplied fixed normals and planarity (no k-NN), and a movable
    planarity that rejects part of the matches."""
    X_fix, X_mov, _ = _pair(602)
    rng = np.random.default_rng(603)
    from simpleicp_tpu.ops.knn import knn_search
    from simpleicp_tpu.ops.normals import estimate_normals_from_neighborhoods

    _, idx = knn_search(jnp.asarray(X_fix), jnp.asarray(X_fix), 10)
    n, pl, _ = estimate_normals_from_neighborhoods(jnp.asarray(X_fix)[idx])
    kw = dict(normals_fix=np.asarray(n), planarity_fix=np.asarray(pl),
              planarity_mov=rng.uniform(0.0, 1.0, len(X_mov)))
    jcfg = JaxConfig(correspondences=300, max_overlap_distance=0.2, max_iterations=40)
    jres, tres, last = _run_both(jcfg, X_fix, X_mov, **kw)
    _assert_parity(jres, tres, last)
    # the movable planarity rejected about 0.3 of the first matches
    assert tres.iter_counts[0] < 0.8 * tres.sel_valid.sum()


def test_no_overlap_runs_no_iteration():
    """ERR_NO_OVERLAP: the JAX loop tests its condition before the first
    iteration, so nothing runs: 0 iterations, H the initial transform, the
    buffers as initialised, and the selection over every fixed point."""
    X_fix, X_mov, _ = _pair(604, n=1500)
    jcfg = JaxConfig(correspondences=200, max_overlap_distance=0.5)
    kw = dict(rbp_observed_values=np.array([0.0, 0.0, 0.0, 50.0, 0.0, 0.0]))
    jres, tres, last = _run_both(jcfg, X_fix, X_mov, **kw)
    assert int(tres.error_code) == ERR_NO_OVERLAP and int(tres.n_iterations) == 0
    _assert_parity(jres, tres, last)
    assert not tres.iter_counts.any() and not tres.residual_mask.any()
    np.testing.assert_array_equal(last, np.zeros_like(last))
    np.testing.assert_array_equal(tres.H[:3, 3], [50.0, 0.0, 0.0])
    np.testing.assert_array_equal(
        tres.sel_idx, np.round(np.linspace(0, len(X_fix) - 1, 200)).astype(np.int32))


def test_gated_too_few_correspondences():
    """ERR_TOO_FEW_CORRESPONDENCES after the gate: one iteration, the
    initial parameters kept."""
    X_fix, X_mov, _ = _pair(605, n=1500)
    jcfg = JaxConfig(correspondences=100, max_overlap_distance=0.3, min_planarity=0.999)
    jres, tres, last = _run_both(jcfg, X_fix, X_mov)
    assert int(tres.error_code) == ERR_TOO_FEW_CORRESPONDENCES
    assert int(tres.n_iterations) == 1
    _assert_parity(jres, tres, last)
    np.testing.assert_array_equal(tres.p, np.zeros(6))


def test_record_trajectory_changes_nothing_else():
    """With the trajectory recorded every iteration fills its slot; without
    it the one slot holds iteration 0; no other field changes."""
    X_fix, X_mov, _ = _pair(606, n=1500)
    cfg = IcpConfig(correspondences=150, max_overlap_distance=0.25)
    off = icp_register(X_fix, X_mov, cfg, device="cpu", dtype=torch.float64)
    on = icp_register(X_fix, X_mov, dataclasses.replace(cfg, record_trajectory=True),
                      device="cpu", dtype=torch.float64)
    n_it = int(on.n_iterations)
    assert on.iter_ps.shape == (cfg.max_iterations, 6) and off.iter_ps.shape == (1, 6)
    for f in ("iter_ps", "iter_midx", "iter_masks", "iter_dists"):
        assert torch.equal(getattr(off, f)[0], getattr(on, f)[0]), f
        assert bool((getattr(on, f)[:n_it] != 0).any(dim=-1).all()), f
        assert not bool(getattr(on, f)[n_it:].any()), f
    for f in off._fields:
        if not f.startswith(("iter_ps", "iter_midx", "iter_masks", "iter_dists")):
            assert torch.equal(getattr(off, f), getattr(on, f)), f


def test_gate_reads_back_one_count():
    """The gate adds exactly one host read (the number of survivors) to the
    loop's flag reads."""
    X_fix, X_mov, _ = _pair(607, n=1000)
    cfg = IcpConfig(correspondences=100, max_iterations=5)
    sync.reset_host_reads()
    icp_register(X_fix, X_mov, cfg, device="cpu")
    ungated = sync.host_reads()
    sync.reset_host_reads()
    icp_register(X_fix, X_mov, dataclasses.replace(cfg, max_overlap_distance=10.0),
                 device="cpu")
    assert sync.host_reads() == ungated + 1


def test_grid_gate_runs_and_matches_jax():
    """gate_method="grid" (refused before the grid engines were ported):
    the JAX package's grid-gated run within this file's tolerances."""
    X_fix, X_mov, _ = _pair(608, n=1200)
    jcfg = JaxConfig(correspondences=150, max_overlap_distance=0.2, gate_method="grid")
    jres, tres, last = _run_both(jcfg, X_fix, X_mov)
    _assert_parity(jres, tres, last)
    assert int(tres.error_code) == 0


def test_auto_gate_resolves_to_grid_without_a_plan():
    """Above 2^41 pairs with no dilate plan (the box is 10^9 radii wide),
    "auto" is the grid gate, as in the JAX package; below, the brute gate.
    Only the sizes are given: no cloud is allocated."""
    from simpleicp_tpu_torch.models import icp

    huge = (np.zeros(3), np.full(3, 1e5))
    cfg = icp._resolve_engines(IcpConfig(max_overlap_distance=1e-4), 2**21, 2**20 + 1)
    assert cfg.gate_method == "auto"
    assert icp._resolve_gate(cfg, 2**21, 2**20 + 1, lambda: huge) == ("grid", None)
    assert icp._resolve_gate(cfg, 2**21, 2**20, lambda: huge) == ("brute", None)


def test_auto_matcher_resolves_to_grid_above_2_38_pairs():
    """match_method="auto" with a radius is the grid matcher above 2^38
    pairs per iteration (C=2^22 against 2^17 movable points is 2^39), as in
    the JAX package; without a radius, or at 2^38, the brute matcher."""
    from simpleicp_tpu_torch.models import icp

    cfg = IcpConfig(max_overlap_distance=1.0, correspondences=2**22)
    assert icp._resolve_engines(cfg, 50, 2**17).match_method == "grid"
    assert icp._resolve_engines(cfg, 50, 2**16).match_method == "brute"
    ungated = IcpConfig(correspondences=2**22)
    assert icp._resolve_engines(ungated, 50, 2**17).match_method == "brute"


def test_auto_gate_resolves_to_brute_up_to_2_40_pairs(monkeypatch):
    """gate_method='auto' is the brute gate exactly where the JAX package
    resolves it so (nf * nm <= 2^40); above it the dilate gate is planned
    over the bounding box, as in the JAX package."""
    from simpleicp_tpu_torch.models import icp
    from simpleicp_tpu_torch.ops.dilate_gate import plan_dilate_gate

    cfg = IcpConfig(max_overlap_distance=1.0)
    assert icp._resolve_engines(cfg, 2**20, 2**20).gate_method == "brute"
    big = icp._resolve_engines(cfg, 2**20, 2**20 + 1)
    assert big.gate_method == "auto"
    box = (np.zeros(3), np.full(3, 30.0))
    method, plan = icp._resolve_gate(big, 2**20, 2**20 + 1, lambda: box)
    assert method == "dilate" and plan == plan_dilate_gate(None, None, 1.0, bbox=box)
    assert icp._resolve_engines(IcpConfig(), 2**30, 2**30).gate_method == "auto"
