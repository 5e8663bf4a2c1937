"""PyTorch port vs the JAX package: transform, masked statistics, normals.

Same inputs (numpy, fixed seeds) through both packages, the port on the CPU.
Tolerances: rbp_to_H is bit-equal in float64 (float32: one ulp, from
XLA's own float32 sin/cos). apply_H agrees to a few ulp of the
coordinates: XLA's CPU backend contracts the products of X R^T into fused
multiply-adds (the jitted JAX apply_H equals an FMA emulation bit for bit
in float32), while the port keeps every product and sum unfused, the order
its CUDA kernel uses. Everything else within 1e-12 in float64, where the
two libraries' trig functions and reduction orders may differ in the last
bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpleicp_tpu.ops import normals as jn
from simpleicp_tpu.ops import stats as js
from simpleicp_tpu.ops import transform as jt
from simpleicp_tpu_torch.ops import normals as tn
from simpleicp_tpu_torch.ops import stats as ts
from simpleicp_tpu_torch.ops import transform as tt

DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]


def _params(rng, n=4):
    return rng.uniform([-0.4, -0.4, -0.4, -3, -3, -3], [0.4, 0.4, 0.4, 3, 3, 3], (n, 6))


@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_apply_H_matches_jax(np_dt, t_dt):
    rng = np.random.default_rng(101)
    X = rng.uniform(-50, 50, (2000, 3)).astype(np_dt)
    apply_j = jax.jit(jt.apply_H)
    for p in _params(rng):
        p = p.astype(np_dt)
        Hj = np.asarray(jt.rbp_to_H(jnp.asarray(p)))
        Ht = tt.rbp_to_H(torch.from_numpy(p)).numpy()
        if np_dt == np.float64:
            np.testing.assert_array_equal(Ht, Hj)
        else:  # XLA's float32 sin/cos may differ from PyTorch's by one ulp
            np.testing.assert_allclose(Ht, Hj, rtol=0, atol=2 * np.finfo(np_dt).eps)
        Yj = np.asarray(apply_j(jnp.asarray(X), jnp.asarray(Hj)))
        Yt = tt.apply_H(torch.from_numpy(X.copy()), torch.from_numpy(Hj.copy())).numpy()
        # FMA contraction vs unfused: a few ulp of the largest partial sum
        ulps = 4 * np.finfo(np_dt).eps * (np.abs(X).max() + np.abs(Hj[:3, 3]).max())
        np.testing.assert_allclose(Yt, Yj, rtol=0, atol=ulps)


@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_rotation_helpers(np_dt, t_dt):
    rng = np.random.default_rng(102)
    tol = 1e-12 if np_dt == np.float64 else 1e-6
    for p in _params(rng):
        p = p.astype(np_dt)
        a = [torch.tensor(v) for v in p[:3]]
        Rl_j = np.asarray(jt.euler_angles_to_linearized_rotation_matrix(*p[:3]))
        Rl_t = tt.euler_angles_to_linearized_rotation_matrix(*a).numpy()
        np.testing.assert_array_equal(Rl_t, Rl_j)
        H = jt.rbp_to_H(jnp.asarray(p))
        ang_j = np.asarray(jt.rotation_matrix_to_euler_angles(H))
        ang_t = np.asarray([v.item() for v in tt.rotation_matrix_to_euler_angles(
            torch.from_numpy(np.array(H)))])
        np.testing.assert_allclose(ang_t, ang_j, rtol=0, atol=tol)
        np.testing.assert_allclose(ang_t, p[:3], rtol=0, atol=10 * tol)
        Hinv_j = np.asarray(jt.invert_H(H))
        Hinv_t = tt.invert_H(torch.from_numpy(np.array(H))).numpy()
        np.testing.assert_allclose(Hinv_t, Hinv_j, rtol=0, atol=tol)


def test_compose_and_homogeneous():
    rng = np.random.default_rng(103)
    A, B = (np.array(jt.rbp_to_H(jnp.asarray(p))) for p in _params(rng, 2))
    np.testing.assert_allclose(
        tt.compose_H(torch.from_numpy(A), torch.from_numpy(B)).numpy(), A @ B,
        rtol=0, atol=1e-12,
    )
    X = rng.uniform(-5, 5, (50, 3))
    Xh_j = np.array(jt.euler_coord_to_homogeneous_coord(jnp.asarray(X)))
    Xh_t = tt.euler_coord_to_homogeneous_coord(torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(Xh_t, Xh_j)
    Xh = Xh_j * rng.uniform(0.5, 2.0, (50, 1))
    np.testing.assert_array_equal(
        tt.homogeneous_coord_to_euler_coord(torch.from_numpy(Xh)).numpy(),
        np.asarray(jt.homogeneous_coord_to_euler_coord(jnp.asarray(Xh))),
    )


# --- masked statistics --------------------------------------------------

_MASKS = {
    "odd": lambda rng, n: rng.random(n) < 0.5,
    "even": None,
    "all_masked": lambda rng, n: np.zeros(n, bool),
    "one_valid": lambda rng, n: np.arange(n) == 7,
}


def _stats_case(kind):
    rng = np.random.default_rng(104)
    n = 301
    x = rng.normal(0.3, 2.0, n)
    if kind == "even":
        mask = np.zeros(n, bool)
        mask[rng.choice(n, 120, replace=False)] = True
    else:
        mask = _MASKS[kind](rng, n)
        if kind == "odd" and mask.sum() % 2 == 0:
            mask[np.flatnonzero(~mask)[0]] = True
    return x, mask


@pytest.mark.parametrize("kind", list(_MASKS))
def test_masked_stats(kind):
    x, mask = _stats_case(kind)
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    pairs = [
        (js.masked_mean(xj, mj), ts.masked_mean(xt, mt)),
        (js.masked_std(xj, mj), ts.masked_std(xt, mt)),
        (js.masked_std(xj, mj, ddof=1), ts.masked_std(xt, mt, ddof=1)),
        (js.masked_median(xj, mj), ts.masked_median(xt, mt)),
        (js.masked_mad(xj, mj, 1.4826), ts.masked_mad(xt, mt, 1.4826)),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-12)
    if mask.any():
        np.testing.assert_allclose(ts.masked_median(xt, mt).item(), np.median(x[mask]),
                                   rtol=1e-15)


def test_pct_change_guards():
    new = np.array([0.0, 1.0, 2.0, -3.0, 0.0, 5.0])
    old = np.array([0.0, 0.0, 1.0, 2.0, 4.0, -5.0])
    got = ts.pct_change(torch.from_numpy(new), torch.from_numpy(old)).numpy()
    want = np.asarray(js.pct_change(jnp.asarray(new), jnp.asarray(old)))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0 and np.isinf(got[1])


# --- normals --------------------------------------------------------------


def _neighbourhoods(rng, n=400, k=10):
    centers = rng.uniform(-10, 10, (n, 1, 3))
    # anisotropic local patches: mostly planar with random orientation
    basis = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    coeff = rng.normal(size=(n, k, 3)) * np.array([1.0, 0.6, 0.03])
    return centers + np.einsum("nkj,nij->nki", coeff, basis)


def test_eigh3x3_matches_jax_with_sign():
    rng = np.random.default_rng(105)
    neigh = _neighbourhoods(rng)
    centered = neigh - neigh.mean(1, keepdims=True)
    C = np.einsum("nki,nkj->nij", centered, centered) / 9
    ev_j, v_j = (np.asarray(a) for a in jn.eigh3x3(jnp.asarray(C)))
    ev_t, v_t = (a.numpy() for a in tn.eigh3x3(torch.from_numpy(C)))
    np.testing.assert_allclose(ev_t, ev_j, rtol=1e-12, atol=1e-12)
    # same vector AND same sign (the sign changes every ICP statistic)
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ev_t, np.linalg.eigvalsh(C)[:, ::-1], rtol=1e-9, atol=1e-12)


def test_eigh3x3_degenerate_fallback():
    C = np.stack([np.eye(3) * 2.5, np.zeros((3, 3)), np.diag([1.0, 1.0, 1.0])])
    ev_j, v_j = (np.asarray(a) for a in jn.eigh3x3(jnp.asarray(C)))
    ev_t, v_t = (a.numpy() for a in tn.eigh3x3(torch.from_numpy(C)))
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(v_t, np.tile([0.0, 0.0, 1.0], (3, 1)))
    np.testing.assert_allclose(ev_t, ev_j, rtol=0, atol=1e-12)


def test_eigh3x3_cross_product_tie_takes_first():
    # diag(1, 0, 0): rows r1 x r2 is the only nonzero cross product;
    # diag(3, 3, 0): two cross products tie in norm, the first one wins.
    C = np.stack([np.diag([1.0, 0.0, 0.0]), np.diag([3.0, 3.0, 0.0]),
                  np.diag([0.0, 2.0, 2.0])])
    _, v_j = jn.eigh3x3(jnp.asarray(C))
    _, v_t = tn.eigh3x3(torch.from_numpy(C))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0, atol=1e-12)


@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_estimate_normals_from_neighborhoods(np_dt, t_dt):
    rng = np.random.default_rng(106)
    neigh = _neighbourhoods(rng).astype(np_dt)
    nj, pj, ej = (np.asarray(a) for a in jn.estimate_normals_from_neighborhoods(
        jnp.asarray(neigh)))
    nt, pt, et = (a.numpy() for a in tn.estimate_normals_from_neighborhoods(
        torch.from_numpy(neigh)))
    tol = 1e-12 if np_dt == np.float64 else 2e-4
    np.testing.assert_allclose(nt, nj, rtol=0, atol=tol)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=tol)
    np.testing.assert_allclose(et, ej, rtol=tol, atol=tol)


def test_xyz_io_round_trip_with_jax_package(tmp_path):
    """Files written by either package read back in the other, to the last
    bit (the JAX package's native parser may round the last bit otherwise
    than numpy's correctly rounded one)."""
    from simpleicp_tpu.utils import xyz_io as jio
    from simpleicp_tpu_torch.utils import xyz_io as tio

    X = np.random.default_rng(107).uniform(-1e3, 1e3, (257, 3))
    tio.write_xyz(tmp_path / "t.xyz", X, fmt="%.6f")
    jio.write_xyz(tmp_path / "j.xyz", X, fmt="%.6f")
    np.testing.assert_allclose(tio.read_xyz(tmp_path / "j.xyz"),
                               jio.read_xyz(tmp_path / "j.xyz"), rtol=4e-16)
    np.testing.assert_allclose(tio.read_xyz(tmp_path / "t.xyz"),
                               jio.read_xyz(tmp_path / "t.xyz"), rtol=4e-16)
    np.testing.assert_allclose(tio.read_xyz(tmp_path / "t.xyz"), X, atol=5e-7)
    (tmp_path / "bad.xyz").write_text("1 2 3\n4 5\n")
    with pytest.raises(tio.XyzIOError):
        tio.read_xyz(tmp_path / "bad.xyz")
    with pytest.raises(tio.XyzIOError):
        tio.read_xyz(tmp_path / "missing.xyz")
    tio.write_correspondences_xyz(tmp_path / "c.xyz", X[:5], X[5:10], np.arange(5.0))
    assert (tmp_path / "c.xyz").read_text().startswith("//X1 Y1 Z1 X2 Y2 Z2")
