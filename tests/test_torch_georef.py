"""Georeferenced (UTM-scale) clouds through the port's SimpleICP, against
the JAX package: the five cases of tests/test_georef.py (exact host-side
centering, and why float32 needs it), on their own seeded surfaces.

Both packages run in float64 on the CPU (the port with device="cpu",
dtype=float64; the JAX package under the tests' x64 switch), except the
float32 case. Tolerances: a centered run's H within 1e-9 in its rotation
and 1e-6 in its translation (the centroid, ~5e6 m, is added back on the
host in float64, whose spacing there is 1e-9). The uncentered run sits on a valley of equivalent alignments (a tiny rotation
about the distant origin is a translation locally), so there the two
packages are held to the JAX test's own claim, the alignment's quality.
"""

import numpy as np
import torch

import jax.numpy as jnp

from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu import PointCloud as JaxPointCloud
from simpleicp_tpu import SimpleICP as JaxSimpleICP
from simpleicp_tpu import icp_register as jax_register
from simpleicp_tpu_torch import IcpConfig, PointCloud, SimpleICP, icp_register
from test_torch_dilate_gate import _one_torch_thread  # noqa: F401 (autouse fixture)

UTM_OFFSET = np.array([4.5e5, 5.2e6, 300.0])


def _surface(seed, n=15000):
    xy = np.random.default_rng(seed).uniform(-2, 2, size=(n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z])


def _runs(X_fix, X_mov, **run):
    """(port, JAX) SimpleICP.run results on the same clouds."""
    port = SimpleICP(verbose=False, device="cpu", dtype=torch.float64)
    port.add_point_clouds(PointCloud(X_fix.copy()), PointCloud(X_mov.copy()))
    ref = JaxSimpleICP(verbose=False)
    ref.add_point_clouds(JaxPointCloud(X_fix.copy()), JaxPointCloud(X_mov.copy()))
    return port.run(**run), ref.run(**run)


def _assert_H_close(H, H_ref):
    np.testing.assert_allclose(H[:3, :3], H_ref[:3, :3], rtol=0, atol=1e-9)
    np.testing.assert_allclose(H[:3, 3], H_ref[:3, 3], rtol=0, atol=1e-6)


def _rms(X_mov, H, X_fix):
    return np.sqrt(np.mean((X_mov @ H[:3, :3].T + H[:3, 3] - X_fix) ** 2))


def test_centered_identifies_translation_at_utm_scale():
    X_fix = _surface(601, 4000) + UTM_OFFSET
    t = np.array([0.08, -0.05, 0.03])
    X_mov = X_fix - t
    (H, _, _, _), (H_ref, _, _, _) = _runs(X_fix, X_mov, center=True)
    _assert_H_close(H, H_ref)
    np.testing.assert_allclose(H[:3, 3], t, atol=1e-6)
    (H, _, _, _), (H_ref, _, _, _) = _runs(X_fix, X_mov, center=False)
    assert _rms(X_mov, H, X_fix) < 1e-3 and _rms(X_mov, H_ref, X_fix) < 1e-3


def test_centered_recovers_rotation_at_utm_scale():
    X_fix = _surface(602, 8000) + UTM_OFFSET
    a = np.deg2rad(0.6)
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]])
    c = X_fix.mean(axis=0)
    t = np.array([0.08, -0.05, 0.03]) + c - R @ c
    X_mov = (X_fix - t) @ R
    (H, _, _, _), (H_ref, _, _, _) = _runs(X_fix, X_mov, center=True)
    _assert_H_close(H, H_ref)
    assert _rms(X_mov, H, X_fix) < 1e-3


def test_centering_disabled_with_translation_observation():
    X_fix = _surface(603, 8000) + UTM_OFFSET
    X_mov = X_fix - np.array([0.05, 0.02, -0.01])
    run = dict(rbp_observed_values=(0, 0, 0, 0.05, 0, 0),
               rbp_observation_weights=(0, 0, 0, np.inf, 0, 0), center=True)
    (H, _, rbp, res), (H_ref, _, rbp_ref, res_ref) = _runs(X_fix, X_mov, **run)
    assert rbp.tx.estimated_value == rbp_ref.tx.estimated_value == 0.05
    np.testing.assert_allclose(H, H_ref, rtol=0, atol=1e-6)
    assert res.shape == res_ref.shape


def test_f32_needs_centering():
    """The functional API in float32 on centered coordinates: converged,
    the shift recovered to 5e-3, and the same iterations as the JAX
    package's float32 run with H within 1e-5 (both solve in float64)."""
    X_fix = _surface(604) + UTM_OFFSET
    X_mov = X_fix - np.array([0.08, -0.05, 0.03])
    c = X_fix.mean(axis=0)
    res = icp_register(X_fix - c, X_mov - c, IcpConfig(), device="cpu",
                       dtype=torch.float32)
    ref = jax_register(X_fix - c, X_mov - c, JaxConfig(), dtype=jnp.float32)
    assert int(res.error_code) == 0 and bool(res.converged)
    p = res.p.numpy().astype(np.float64)
    np.testing.assert_allclose(p[3:], [0.08, -0.05, 0.03], atol=5e-3)
    assert int(res.n_iterations) == int(ref.n_iterations)
    np.testing.assert_allclose(res.H.numpy(), np.asarray(ref.H), rtol=0, atol=1e-5)


def test_initial_guess_mapping_under_centering():
    X_fix = _surface(605, 10000) + UTM_OFFSET
    a = np.deg2rad(20.0)
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]])
    c = X_fix.mean(axis=0)
    X_mov = (X_fix - c) @ R + c
    t0 = c - R @ c
    run = dict(rbp_observed_values=(0.0, 0.0, 20.0, *t0),
               rbp_observation_weights=(0.0,) * 6, center=True)
    (H, _, rbp, res), (H_ref, _, rbp_ref, _) = _runs(X_fix, X_mov, **run)
    assert abs(rbp.alpha3.estimated_value_scaled - 20.0) < 0.5
    assert np.std(res) < 0.05
    _assert_H_close(H, H_ref)
    np.testing.assert_allclose(rbp.alpha3.estimated_value_scaled,
                               rbp_ref.alpha3.estimated_value_scaled, rtol=0, atol=1e-7)
