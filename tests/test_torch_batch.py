"""icp_register_batch: the PyTorch port (CPU, plain versions) against the
JAX package's icp_register_batch on the same numpy inputs, and against the
port's own icp_register pair by pair. The cases of tests/test_batch.py,
and the batch's own: pairs that stop at different iterations, both solvers
and rejection stagings, the trajectory, frozen observations, float32, the
refusals, the settings the batch ignores, and the ops on a pair axis.

Inputs: B = 3 pairs of 3000-point synthetic surfaces (an independent
sample of the fixed surface moved by each pair's own rigid motion), C =
300, float64 unless said otherwise. Tolerances, and why:
* iterations, convergence, error codes, selection, valid counts, the
  residual masks and every iteration's matches: equal (integer decisions);
* H and p within 1e-10: both solve in float64, but XLA contracts sums
  into fused multiply-adds and PyTorch does not, so the last bits differ;
* residual statistics within 1e-9, normals within 1e-10, uncertainties
  within 1e-7 relative to their scale (an inverse 6x6 amplifies the last
  bits), as in tests/test_torch_icp.py.
The JAX batch returns a gated selection as int64 (its vmapped selection);
the port keeps int32, as its icp_register does, so sel_idx is compared by
value.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu.models.icp import icp_register_batch as jax_batch
from simpleicp_tpu_torch import (
    ERR_NO_OVERLAP,
    ERR_OK,
    ERR_TOO_FEW_CORRESPONDENCES,
    IcpConfig,
    config_from_dict,
    icp_register,
    icp_register_batch,
    result_to_numpy,
)
from simpleicp_tpu_torch.models import solver
from simpleicp_tpu_torch.ops import stats, transform
from test_torch_dilate_gate import _one_torch_thread  # noqa: F401 (autouse fixture)

F64 = dict(device="cpu", dtype=torch.float64)
B, N, C = 3, 3000, 300


def _surface(rng, n):
    xy = rng.uniform(-2, 2, size=(n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z])


def _rotation(a):
    c1, s1, c2, s2, c3, s3 = (np.cos(a[0]), np.sin(a[0]), np.cos(a[1]),
                              np.sin(a[1]), np.cos(a[2]), np.sin(a[2]))
    return np.array([
        [c2 * c3, -c2 * s3, s2],
        [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2],
        [s1 * s3 - c1 * s2 * c3, s1 * c3 + c1 * s2 * s3, c1 * c2],
    ])


def _pairs(seed, scales=(1.0, 0.5, 0.1), n=N):
    """B pairs: a fixed surface and an independent sample of it under the
    pair's rigid motion (angles up to 0.03 rad, shifts up to 0.06, times
    the pair's scale, so that the pairs need different iteration counts).
    Returns (X_fix (B, n, 3), X_mov (B, n, 3), translations (B, 3))."""
    rng = np.random.default_rng(seed)
    fix, mov, ts = [], [], []
    for s in scales:
        a, t = s * rng.uniform(-0.03, 0.03, 3), s * rng.uniform(-0.06, 0.06, 3)
        fix.append(_surface(rng, n))
        mov.append((_surface(rng, n) - t) @ _rotation(a))
        ts.append(t)
    return np.stack(fix), np.stack(mov), np.array(ts)


def _run_jax(jcfg, X_fix, X_mov, dtype=torch.float64, **obs):
    """The JAX batch with its trajectory recorded (recording changes no
    other result), as numpy."""
    res = jax_batch(X_fix, X_mov, dataclasses.replace(jcfg, record_trajectory=True),
                    dtype=jnp.float64 if dtype == torch.float64 else jnp.float32, **obs)
    return type(res)(*(np.asarray(v) for v in res))


def _run_port(jcfg, X_fix, X_mov, dtype=torch.float64, **obs):
    cfg = config_from_dict(dataclasses.asdict(dataclasses.replace(jcfg, record_trajectory=True)))
    return result_to_numpy(icp_register_batch(X_fix, X_mov, cfg, device="cpu", dtype=dtype,
                                              **obs))


def _assert_batch_parity(J, T, h_tol=1e-10):
    """The port's batch result against the JAX batch's, both recorded."""
    assert T._fields == J._fields
    for f in T._fields:
        a, b = getattr(T, f), getattr(J, f)
        assert a.shape == b.shape and a.shape[:1] == (B,), f  # the leading pair axis
        if f != "sel_idx":
            assert a.dtype == b.dtype, f
    for f in ("n_iterations", "converged", "error_code", "sel_idx", "sel_valid",
              "iter_counts", "residual_mask", "orig_count", "iter_midx", "iter_masks"):
        np.testing.assert_array_equal(getattr(T, f), getattr(J, f), err_msg=f)
    for f, tol in (("H", h_tol), ("p", h_tol), ("iter_ps", h_tol), ("iter_means", 1e-9),
                   ("iter_stds", 1e-9), ("orig_mean", 1e-9), ("orig_std", 1e-9),
                   ("residuals", 1e-9), ("iter_dists", 1e-9), ("normals", 1e-10),
                   ("planarity", 1e-10), ("iter_gn_rel_steps", 1e-12)):
        np.testing.assert_allclose(getattr(T, f), getattr(J, f), rtol=0, atol=tol, err_msg=f)
    np.testing.assert_allclose(T.distance_weight, J.distance_weight, rtol=1e-8)
    for b in range(B):
        scale = max(np.abs(J.covariance[b]).max(), 1e-300)
        np.testing.assert_allclose(T.covariance[b], J.covariance[b], rtol=0,
                                   atol=1e-7 * scale)
        fin = np.isfinite(J.uncertainties[b])
        np.testing.assert_array_equal(np.isfinite(T.uncertainties[b]), fin)
        np.testing.assert_allclose(T.uncertainties[b][fin], J.uncertainties[b][fin],
                                   rtol=1e-6, atol=1e-12)


# --------------------------------------------------------- shared JAX results


@pytest.fixture(scope="module")
def pairs():
    return _pairs(700)


@pytest.fixture(scope="module")
def base(pairs):
    """The default config (nonlinear solver, "python" staging): JAX and
    port batch results."""
    jcfg = JaxConfig(correspondences=C, max_iterations=30)
    return jcfg, _run_jax(jcfg, *pairs[:2]), _run_port(jcfg, *pairs[:2])


# ---------------------------------------------------------------- the cases


def test_batch_matches_jax(base):
    _, J, T = base
    _assert_batch_parity(J, T)
    assert np.all(T.error_code == ERR_OK) and T.converged.all()


def test_batch_matches_serial(pairs, base):
    """Each pair of the batch against the port's own icp_register of that
    pair: the same iterations, selection and matches, H within 1e-10."""
    jcfg, _, T = base
    cfg = config_from_dict(dataclasses.asdict(dataclasses.replace(jcfg,
                                                                  record_trajectory=True)))
    for b in range(B):
        r = result_to_numpy(icp_register(pairs[0][b], pairs[1][b], cfg, **F64))
        for f in ("n_iterations", "converged", "error_code", "sel_idx", "sel_valid",
                  "iter_counts", "residual_mask", "iter_midx"):
            np.testing.assert_array_equal(getattr(T, f)[b], getattr(r, f), err_msg=f)
        np.testing.assert_allclose(T.H[b], r.H, rtol=0, atol=1e-10)


def test_batch_recovers_transforms(pairs, base):
    T = base[2]
    assert np.all(T.error_code == ERR_OK)
    np.testing.assert_allclose(T.H[:, :3, 3], pairs[2], atol=5e-3)


@pytest.mark.parametrize("solver_name,staging", [("nonlinear", "joint"),
                                                 ("linearized", "python"),
                                                 ("linearized", "joint")])
def test_batch_solvers_and_stagings(pairs, solver_name, staging):
    """The other solver and rejection staging combinations (the default,
    nonlinear with "python" staging, is test_batch_matches_jax)."""
    jcfg = JaxConfig(correspondences=C, max_iterations=30, solver=solver_name,
                     rejection_staging=staging)
    _assert_batch_parity(_run_jax(jcfg, *pairs[:2]), _run_port(jcfg, *pairs[:2]))


def test_pairs_stop_at_different_iterations():
    """One batch in which each pair stops on its own: pair 0 converges
    early (a motion a tenth of pair 2's), pair 1's clouds are a flat strip
    1e-3 wide (each neighbourhood about 13 times longer than wide:
    planarity near 0.006, below min_planarity everywhere, so too few
    correspondences in iteration 0), pair 2 runs longest. The stopped
    pairs keep their state while the others iterate."""
    X_fix, X_mov, _ = _pairs(701, scales=(0.1, 1.0, 1.0))
    rng = np.random.default_rng(702)
    strip = np.column_stack([rng.uniform(-2, 2, N), rng.uniform(-5e-4, 5e-4, N), np.zeros(N)])
    X_fix[1], X_mov[1] = strip, strip + [0.01, 0.0, 0.0]
    jcfg = JaxConfig(correspondences=C, max_iterations=30)
    J, T = _run_jax(jcfg, X_fix, X_mov), _run_port(jcfg, X_fix, X_mov)
    _assert_batch_parity(J, T)
    assert list(T.error_code) == [ERR_OK, ERR_TOO_FEW_CORRESPONDENCES, ERR_OK]
    assert T.n_iterations[1] == 1 and T.n_iterations[0] < T.n_iterations[2]
    np.testing.assert_array_equal(T.p[1], np.zeros(6))


def test_gated_batch_with_a_pair_without_overlap():
    """The brute gate on every pair; pair 1's movable cloud lies beyond the
    radius, so it starts with ERR_NO_OVERLAP, runs no iteration and
    selects over all its fixed points, while the others register."""
    X_fix, X_mov, _ = _pairs(703)
    X_mov[1] += [100.0, 0.0, 0.0]
    jcfg = JaxConfig(correspondences=C, max_iterations=30, max_overlap_distance=0.3)
    J, T = _run_jax(jcfg, X_fix, X_mov), _run_port(jcfg, X_fix, X_mov)
    _assert_batch_parity(J, T)
    assert list(T.error_code) == [ERR_OK, ERR_NO_OVERLAP, ERR_OK]
    assert T.n_iterations[1] == 0 and T.n_iterations[0] > 0


def test_batch_with_gate_and_observations():
    """The gate and per-pair observations: alpha1 frozen at 0 (inf weight)
    in every pair, a weighted observation of tz in pair 2; NaN uncertainty
    where frozen."""
    X_fix, X_mov, _ = _pairs(704)
    obs = np.zeros((B, 6))
    w = np.zeros((B, 6))
    w[:, 0] = np.inf
    obs[2, 5], w[2, 5] = 0.01, 100.0
    kw = dict(rbp_observed_values=obs, rbp_observation_weights=w)
    jcfg = JaxConfig(correspondences=200, max_iterations=30, max_overlap_distance=1.0)
    J, T = _run_jax(jcfg, X_fix, X_mov, **kw), _run_port(jcfg, X_fix, X_mov, **kw)
    _assert_batch_parity(J, T)
    assert np.all(T.error_code == ERR_OK)
    np.testing.assert_array_equal(T.p[:, 0], 0.0)
    assert np.all(np.isnan(T.uncertainties[:, 0]))


def test_batch_record_trajectory(pairs, base):
    """The trajectory buffers carry the pair axis, (B, R, C); each pair's
    rows stop at its own iteration count, and recording changes no other
    field."""
    jcfg, _, T = base
    R = jcfg.max_iterations
    assert T.iter_midx.shape == (B, R, C) and T.iter_ps.shape == (B, R, 6)
    for b in range(B):
        n = int(T.n_iterations[b])
        assert not T.iter_masks[b, n:].any() and not T.iter_ps[b, n:].any()
    plain = result_to_numpy(icp_register_batch(
        *pairs[:2], config_from_dict(dataclasses.asdict(jcfg)), **F64))
    assert plain.iter_midx.shape == (B, 1, C)
    for f in ("H", "p", "n_iterations", "iter_counts", "residuals", "uncertainties"):
        np.testing.assert_array_equal(getattr(plain, f), getattr(T, f), err_msg=f)
    np.testing.assert_array_equal(plain.iter_midx[:, 0], T.iter_midx[:, 0])


def test_batch_float32(pairs):
    """float32 in both: the same iteration counts, H within 1e-5 (float32
    coordinates; both solve in float64)."""
    jcfg = JaxConfig(correspondences=C, max_iterations=30)
    J = _run_jax(jcfg, *pairs[:2], dtype=torch.float32)
    T = _run_port(jcfg, *pairs[:2], dtype=torch.float32)
    assert T.H.dtype == np.float32
    np.testing.assert_array_equal(T.n_iterations, J.n_iterations)
    np.testing.assert_array_equal(T.error_code, J.error_code)
    np.testing.assert_allclose(T.H, J.H, rtol=0, atol=1e-5)
    np.testing.assert_allclose(T.H[:, :3, 3], pairs[2], atol=5e-3)


@pytest.mark.parametrize("kw,match", [
    (dict(max_overlap_distance=1.0, gate_method="grid"), "gate_method='grid' is not supported"),
    (dict(max_overlap_distance=1.0, gate_method="dilate"),
     "gate_method='dilate' is not supported"),
    (dict(match_method="grid", match_radius=0.5), "match_method='grid' is not supported"),
])
def test_batch_refusals(kw, match):
    """The JAX package's refusals, with its messages, in both packages."""
    X = np.zeros((1, 10, 3))
    for run, cfg in ((jax_batch, JaxConfig(**kw)), (icp_register_batch, IcpConfig(**kw))):
        extra = {} if run is jax_batch else F64
        with pytest.raises(ValueError, match=match):
            run(X, X, cfg, **extra)


def test_batch_shape_checks():
    rng = np.random.default_rng(705)
    for run, extra in ((jax_batch, {}), (icp_register_batch, F64)):
        with pytest.raises(ValueError, match=r"batched clouds must have shape \(B, n, 3\)"):
            run(rng.uniform(size=(10, 3)), rng.uniform(size=(10, 3)), **extra)
        with pytest.raises(ValueError, match="batch sizes of fixed and movable clouds differ"):
            run(rng.uniform(size=(2, 10, 3)), rng.uniform(size=(3, 10, 3)), **extra)


def test_auto_resolves_to_brute(pairs):
    """match_method "auto" and gate_method "auto" (the defaults) give the
    brute matcher's and the brute gate's results, whatever the pair counts
    (test_gated_batch_with_a_pair_without_overlap holds "auto" against the
    JAX batch)."""
    jcfg = JaxConfig(correspondences=C, max_iterations=30, max_overlap_distance=0.3)
    assert (jcfg.match_method, jcfg.gate_method) == ("auto", "auto")
    auto = _run_port(jcfg, *pairs[:2])
    brute = _run_port(dataclasses.replace(jcfg, match_method="brute", gate_method="brute"),
                      *pairs[:2])
    for f in auto._fields:
        np.testing.assert_array_equal(getattr(auto, f), getattr(brute, f), err_msg=f)


@pytest.mark.parametrize("kw", [dict(dispatch="chunked", chunk_iterations=2),
                                dict(warm_start=True, warm_start_points=1000)],
                         ids=["chunked", "warm_start"])
def test_batch_ignores_dispatch_and_warm_start(pairs, base, kw):
    """Batch mode runs the monolithic loop with no warm start, as the JAX
    batch does: these settings give the JAX batch's result, which is the
    default config's."""
    jcfg, J, T = base
    other = dataclasses.replace(jcfg, **kw)
    T2 = _run_port(other, *pairs[:2])
    for f in T._fields:
        np.testing.assert_array_equal(getattr(T2, f), getattr(T, f), err_msg=f)
    _assert_batch_parity(_run_jax(other, *pairs[:2]), T2)
    _assert_batch_parity(J, T2)


def test_batch_tiles_change_nothing(pairs, base):
    """query_tile and ref_tile choose TPU tiles, and no result depends on
    them. This replaces tests/test_batch.py's
    test_batch_tile_shrink_footprint_and_warning: the JAX batch shrinks its
    tiles and warns because a vmapped distance block of 4x a measured budget
    faulted its TPU worker. The port's kernels hold no distance block and
    its plain versions bound their block over the whole batch, so there is
    no shrink and no warning to test; what stays is that tiles change no
    result."""
    jcfg, _, T = base
    for qt, rt in ((256, 1024), (512, 1536)):
        T2 = _run_port(dataclasses.replace(jcfg, query_tile=qt, ref_tile=rt), *pairs[:2])
        for f in T._fields:
            np.testing.assert_array_equal(getattr(T2, f), getattr(T, f), err_msg=f)


# ----------------------------------------------------- the ops on a pair axis


def test_stats_on_a_pair_axis():
    rng = np.random.default_rng(706)
    x = torch.as_tensor(rng.standard_normal((4, 301)))
    mask = torch.as_tensor(rng.random((4, 301)) < 0.6)
    mask[2] = False  # a row with nothing valid
    mask[3, :] = False
    mask[3, :2] = True  # an even count: the mean of the two middles
    for fn in (stats.masked_mean, stats.masked_median,
               lambda a, m: stats.masked_std(a, m, ddof=1),
               lambda a, m: stats.masked_mad(a, m, scale=1.4826)):
        got = fn(x, mask)
        assert got.shape == (4,)
        for b in range(4):
            torch.testing.assert_close(got[b], fn(x[b], mask[b]), rtol=1e-15, atol=0)
    old, new = torch.as_tensor([[0.0, 1.0], [2.0, 0.0]]), torch.as_tensor([[0.0, 2.0], [2.0, 1.0]])
    torch.testing.assert_close(stats.pct_change(new, old),
                               torch.as_tensor([[0.0, 100.0], [0.0, float("inf")]]))


def test_transform_on_a_pair_axis():
    rng = np.random.default_rng(707)
    p = torch.as_tensor(rng.uniform(-0.3, 0.3, (3, 6)))
    X = torch.as_tensor(rng.uniform(-5, 5, (3, 50, 3)))
    H = transform.rbp_to_H(p)
    assert H.shape == (3, 4, 4)
    for b in range(3):
        Hb = transform.rbp_to_H(p[b])
        assert torch.equal(H[b], Hb)
        assert torch.equal(transform.apply_H(X, H)[b], transform.apply_H(X[b], Hb))
        assert torch.equal(transform.compose_H(H, H.flip(0))[b],
                           transform.compose_H(Hb, H.flip(0)[b]))
        assert torch.equal(transform.invert_H(H)[b], transform.invert_H(Hb))
        angles = transform.rotation_matrix_to_euler_angles(H)
        for a, ab in zip(angles, transform.rotation_matrix_to_euler_angles(Hb)):
            assert torch.equal(a[b], ab)


def test_solver_on_a_pair_axis():
    """gn_solve, linearized_solve and estimate_uncertainties on three
    problems at once against each alone; gn_solve's per-problem freeze:
    an inactive problem takes no step, and a problem that has converged
    stops stepping while the others go on."""
    rng = np.random.default_rng(708)
    n = 200
    xm = torch.as_tensor(_surface(rng, 3 * n).reshape(3, n, 3))
    xf = xm + torch.as_tensor(rng.normal(0, 1e-3, (3, n, 3)))
    nrm = torch.nn.functional.normalize(torch.as_tensor(rng.standard_normal((3, n, 3))), dim=-1)
    mask = torch.as_tensor(rng.random((3, n)) < 0.9)
    p0 = torch.as_tensor(rng.uniform(-0.01, 0.01, (3, 6)))
    dw = torch.as_tensor([1.0, 2.0, 0.5])
    obs = torch.zeros((3, 6), dtype=torch.float64)
    w = torch.zeros((3, 6), dtype=torch.float64)
    w[1, 2] = float("inf")
    w[2, 4] = 10.0
    active = torch.as_tensor([True, True, False])
    p, r, rel = solver.gn_solve(p0, xm, xf, nrm, mask, dw, obs, w, n_steps=24, active=active)
    assert torch.equal(p[2], p0[2]) and torch.isinf(rel[2])
    dH, lr, sol = solver.linearized_solve(xm, xf, nrm, mask)
    sig, cov = solver.estimate_uncertainties(p, xm, xf, nrm, mask, dw, obs, w)
    for b in range(2):
        pb, rb, relb = solver.gn_solve(p0[b], xm[b], xf[b], nrm[b], mask[b], dw[b], obs[b],
                                       w[b], n_steps=24)
        torch.testing.assert_close(p[b], pb, rtol=0, atol=1e-14)
        torch.testing.assert_close(r[b], rb, rtol=0, atol=1e-14)
        assert bool(relb <= 64 * torch.finfo(torch.float64).eps)
    for b in range(3):
        dHb, lrb, solb = solver.linearized_solve(xm[b], xf[b], nrm[b], mask[b])
        torch.testing.assert_close(dH[b], dHb, rtol=0, atol=1e-14)
        torch.testing.assert_close(lr[b], lrb, rtol=0, atol=1e-14)
        sb, cb = solver.estimate_uncertainties(p[b], xm[b], xf[b], nrm[b], mask[b], dw[b],
                                               obs[b], w[b])
        torch.testing.assert_close(sig[b], sb, rtol=1e-12, atol=0, equal_nan=True)
        torch.testing.assert_close(cov[b], cb, rtol=1e-12, atol=1e-30)
