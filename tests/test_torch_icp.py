"""icp_register end to end: the PyTorch port (CPU, plain versions) against
simpleicp_tpu.icp_register on the same ~4000-point surface pair, C=300.

The movable cloud is an independent sample of the fixed cloud's surface
moved by a known rigid motion. The JAX run records its trajectory, which
gives its last iteration's matches (recording changes no other result).

Tolerances, float64, and why:
* iteration count, convergence, error code, selection, per-iteration valid
  counts, final residual mask and last matches: equal (integer decisions);
* H and p within 1e-9: both solve in float64, but XLA contracts sums into
  fused multiply-adds and PyTorch does not, so the last bits differ;
* per-iteration residual means and stds within 1e-8 (statistics of
  residuals of those parameters);
* normals within 1e-10 (closed-form eigensolver, other trig and sums);
* uncertainties within 1e-7 (an inverse of a 6x6 matrix whose rotation
  and translation columns differ by |coords|^2 amplifies the last bits).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu import icp_register as jax_register
from simpleicp_tpu_torch import IcpConfig, config_from_dict, icp_register, result_to_numpy
from simpleicp_tpu_torch.models.icp import _icp_register


def _surface(rng, n):
    xy = rng.uniform(-2, 2, size=(n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z])


def _known_motion():
    a = np.array([0.02, -0.015, 0.03])
    t = np.array([0.05, -0.04, 0.03])
    c1, s1, c2, s2, c3, s3 = (
        np.cos(a[0]), np.sin(a[0]), np.cos(a[1]), np.sin(a[1]),
        np.cos(a[2]), np.sin(a[2]),
    )
    R = np.array(
        [
            [c2 * c3, -c2 * s3, s2],
            [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2],
            [s1 * s3 - c1 * s2 * c3, s1 * c3 + c1 * s2 * s3, c1 * c2],
        ]
    )
    return R, t


def _pair(seed=501, n=4000):
    rng = np.random.default_rng(seed)
    R, t = _known_motion()
    return _surface(rng, n), (_surface(rng, n) - t) @ R, t


def _run_both(jcfg, X_fix, X_mov, dtype=torch.float64, **obs):
    jres = jax_register(
        X_fix, X_mov, dataclasses.replace(jcfg, record_trajectory=True),
        dtype=jnp.float64 if dtype == torch.float64 else jnp.float32,
        **{k: v for k, v in obs.items()},
    )
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    tres, carry = _icp_register(
        X_fix, X_mov, cfg, rbp_observed_values=obs.get("rbp_observed_values"),
        rbp_observation_weights=obs.get("rbp_observation_weights"),
        normals_fix=None, planarity_fix=None, planarity_mov=None,
        fixed_prep=None, device="cpu", dtype=dtype,
    )
    return jres, result_to_numpy(tres), carry.m_idx.numpy()


def _assert_parity(jres, tres, last_m_idx):
    J = {f: np.asarray(getattr(jres, f)) for f in jres._fields}
    n_it = int(J["n_iterations"])
    for f in ("n_iterations", "converged", "error_code", "sel_idx", "sel_valid",
              "iter_counts", "residual_mask", "orig_count"):
        np.testing.assert_array_equal(getattr(tres, f), J[f], err_msg=f)
    if int(J["error_code"]) == 0:
        np.testing.assert_array_equal(last_m_idx, J["iter_midx"][n_it - 1])
    else:  # on an error the loop keeps the previous (here: initial) matches
        np.testing.assert_array_equal(last_m_idx, np.zeros_like(last_m_idx))
    np.testing.assert_array_equal(tres.iter_midx[0], J["iter_midx"][0])
    np.testing.assert_array_equal(tres.iter_masks[0], J["iter_masks"][0])
    for f, tol in (("H", 1e-9), ("p", 1e-9), ("iter_means", 1e-8),
                   ("iter_stds", 1e-8), ("orig_mean", 1e-8), ("orig_std", 1e-8),
                   ("residuals", 1e-8), ("normals", 1e-10), ("planarity", 1e-10),
                   ("uncertainties", 1e-7), ("iter_gn_rel_steps", 1e-12)):
        np.testing.assert_allclose(getattr(tres, f), J[f], rtol=0, atol=tol, err_msg=f)
    np.testing.assert_allclose(tres.iter_dists[0], J["iter_dists"][0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.iter_ps[0], J["iter_ps"][0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(tres.distance_weight, J["distance_weight"], rtol=1e-8)
    cov_scale = np.abs(J["covariance"]).max()
    np.testing.assert_allclose(tres.covariance, J["covariance"], rtol=0,
                               atol=1e-7 * cov_scale)
    # the result has the JAX package's field names, shapes and dtypes
    assert tres._fields == jres._fields
    for f in ("H", "p", "iter_counts", "iter_means", "sel_idx", "normals",
              "iter_gn_rel_steps", "n_iterations", "converged", "error_code"):
        assert getattr(tres, f).shape == J[f].shape, f
        assert getattr(tres, f).dtype == J[f].dtype, f


@pytest.mark.parametrize("solver", ["nonlinear", "linearized"])
@pytest.mark.parametrize("staging", ["python", "joint"])
def test_icp_register_matches_jax(solver, staging):
    X_fix, X_mov, t = _pair()
    jcfg = JaxConfig(correspondences=300, solver=solver, rejection_staging=staging)
    jres, tres, last = _run_both(jcfg, X_fix, X_mov)
    _assert_parity(jres, tres, last)
    assert bool(tres.converged)
    np.testing.assert_allclose(tres.H[:3, 3], t, atol=2e-3)


def test_icp_register_auto_weight_and_observations():
    """distance_weights=None (1/std^2 from iteration 0), one observed and
    one frozen parameter, an initial transform, and sample std (ddof=1)."""
    X_fix, X_mov, _ = _pair(502)
    jcfg = JaxConfig(correspondences=300, distance_weights=None, std_ddof=1,
                     mad_scale=1.0)
    obs = dict(rbp_observed_values=np.array([0.0, 0.0, 0.01, 0.02, 0.0, 0.0]),
               rbp_observation_weights=np.array([0.0, 0.0, 100.0, 0.0, 0.0, np.inf]))
    jres, tres, last = _run_both(jcfg, X_fix, X_mov, **obs)
    _assert_parity(jres, tres, last)
    assert tres.p[5] == 0.0 and np.isnan(tres.uncertainties[5])


def test_icp_register_float32():
    """float32 in both: the same iteration count, H within 1e-5 (float32
    coordinates; both solve in float64)."""
    X_fix, X_mov, t = _pair(503)
    jres = jax_register(X_fix, X_mov, JaxConfig(correspondences=300), dtype=jnp.float32)
    tres = result_to_numpy(icp_register(X_fix, X_mov, IcpConfig(correspondences=300),
                                        device="cpu", dtype=torch.float32))
    assert int(tres.n_iterations) == int(jres.n_iterations)
    assert tres.H.dtype == np.float32
    np.testing.assert_allclose(tres.H, np.asarray(jres.H), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tres.H[:3, 3], t, atol=2e-3)


def test_icp_register_too_few_correspondences_keeps_state():
    """min_planarity near 1 rejects every correspondence: error code 2 in
    the first iteration, the initial parameters kept, as in JAX."""
    X_fix, X_mov, _ = _pair(504, n=1500)
    jcfg = JaxConfig(correspondences=100, min_planarity=0.999)
    jres, tres, last = _run_both(jcfg, X_fix, X_mov)
    assert int(tres.error_code) == 2 and int(tres.n_iterations) == 1
    _assert_parity(jres, tres, last)
    np.testing.assert_array_equal(tres.p, np.zeros(6))
