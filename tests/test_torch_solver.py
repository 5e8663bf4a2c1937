"""PyTorch port's solvers vs the JAX package's, on the CPU in float64.

gn_solve, linearized_solve and estimate_uncertainties with parameter
observations of weight 0 (free), finite (observed) and inf (frozen). Both
packages solve in float64 by the same unrolled Cholesky; the JAX Jacobian is
jax.jacfwd, the port's is analytic, and the two libraries reduce in other
orders, so results agree within 1e-10 (relative to each value's scale).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpleicp_tpu.models import solver as js
from simpleicp_tpu.ops.transform import rbp_to_H as j_rbp_to_H
from simpleicp_tpu_torch.models import solver as ts

TOL = 1e-10

OBS = {
    "free": (np.zeros(6), np.zeros(6)),
    "observed": (np.array([0.01, -0.02, 0.005, 0.3, -0.1, 0.2]),
                 np.array([50.0, 0.0, 20.0, 0.0, 5.0, 0.0])),
    "frozen": (np.array([0.0, 0.0, 0.03, 0.0, 0.0, 0.25]),
               np.array([np.inf, 0.0, np.inf, 0.0, 0.0, np.inf])),
}


def _problem(seed=301, C=400):
    """Correspondences on a wavy surface, the movable side moved by a small
    rigid motion, with noise and a few outliers masked out."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-3, 3, (C, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    xf = np.column_stack([xy, z])
    g = np.column_stack([-0.6 * np.cos(2 * xy[:, 0]), 0.6 * np.sin(3 * xy[:, 1]),
                         np.ones(C)])
    n = g / np.linalg.norm(g, axis=1, keepdims=True)
    p_true = np.array([0.02, -0.015, 0.03, 0.05, -0.04, 0.03])
    H = np.asarray(j_rbp_to_H(jnp.asarray(p_true)))
    xm = (xf - H[:3, 3]) @ H[:3, :3] + rng.normal(0, 1e-3, (C, 3))
    mask = rng.random(C) > 0.05
    return xm, xf, n, mask


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.nanmax(np.abs(b)))) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("obs", list(OBS))
def test_gn_solve(obs):
    xm, xf, n, mask = _problem()
    ov, ow = OBS[obs]
    p0 = np.zeros(6)
    dw = 2.5
    pj, rj, gj = js.gn_solve(jnp.asarray(p0), jnp.asarray(xm), jnp.asarray(xf),
                             jnp.asarray(n), jnp.asarray(mask), jnp.asarray(dw),
                             jnp.asarray(ov), jnp.asarray(ow))
    pt, rt, gt = ts.gn_solve(_t(p0), _t(xm), _t(xf), _t(n), _t(mask),
                             torch.tensor(dw, dtype=torch.float64), _t(ov), _t(ow))
    _close(pt.numpy(), pj)
    _close(rt.numpy(), rj)
    assert float(gt) <= 64 * np.finfo(np.float64).eps
    if obs == "frozen":
        frozen = np.isinf(ow)
        np.testing.assert_array_equal(pt.numpy()[frozen], ov[frozen])


@pytest.mark.parametrize("obs", list(OBS))
def test_estimate_uncertainties(obs):
    xm, xf, n, mask = _problem(302)
    ov, ow = OBS[obs]
    p = np.array([0.02, -0.015, 0.03, 0.05, -0.04, 0.03])
    dw = 3.0
    sj, cj = js.estimate_uncertainties(jnp.asarray(p), jnp.asarray(xm), jnp.asarray(xf),
                                       jnp.asarray(n), jnp.asarray(mask), jnp.asarray(dw),
                                       jnp.asarray(ov), jnp.asarray(ow))
    st, ct = ts.estimate_uncertainties(_t(p), _t(xm), _t(xf), _t(n), _t(mask),
                                       torch.tensor(dw, dtype=torch.float64), _t(ov), _t(ow))
    _close(st.numpy(), sj)
    _close(ct.numpy(), cj)
    assert np.isnan(st.numpy()[np.isinf(ow)]).all()


def test_linearized_solve():
    xm, xf, n, mask = _problem(303)
    dHj, rj, sj = js.linearized_solve(jnp.asarray(xm), jnp.asarray(xf), jnp.asarray(n),
                                      jnp.asarray(mask))
    dHt, rt, st = ts.linearized_solve(_t(xm), _t(xf), _t(n), _t(mask))
    _close(dHt.numpy(), dHj)
    _close(rt.numpy(), rj)
    _close(st.numpy(), sj)


def test_jacobian_matches_jacfwd():
    xm, xf, n, _ = _problem(304, C=50)
    p = np.array([0.3, -0.2, 0.5, 1.0, 2.0, -1.0])
    Jj = jax.jacfwd(lambda q: js.point_to_plane_residuals(q, jnp.asarray(xm),
                                                          jnp.asarray(xf), jnp.asarray(n)))(
        jnp.asarray(p))
    Jt = ts.residual_jacobian(_t(p), _t(xm), _t(n))
    _close(Jt.numpy(), Jj, 1e-13)
    rj = js.point_to_plane_residuals(jnp.asarray(p), jnp.asarray(xm), jnp.asarray(xf),
                                     jnp.asarray(n))
    rt = ts.point_to_plane_residuals(_t(p), _t(xm), _t(xf), _t(n))
    _close(rt.numpy(), rj, 1e-13)


def test_spd6_solve_and_inverse():
    rng = np.random.default_rng(305)
    A = rng.normal(size=(6, 6))
    N = A @ A.T + np.diag([1e-2, 1.0, 10.0, 1e3, 1e4, 1e5])
    b = rng.normal(size=6)
    xj = js.solve_spd6(jnp.asarray(N), jnp.asarray(b))
    xt = ts.solve_spd6(_t(N), _t(b))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12)
    np.testing.assert_allclose(N @ xt.numpy(), b, rtol=0, atol=1e-9)
    Ij = js.inv_spd6(jnp.asarray(N))
    It = ts.inv_spd6(_t(N))
    np.testing.assert_allclose(It.numpy(), np.asarray(Ij), rtol=1e-12, atol=1e-15)
