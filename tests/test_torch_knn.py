"""PyTorch port's nearest-neighbour search vs the JAX package, on the CPU.

The port runs its plain versions here (the CUDA kernels are held bit-equal
to them on the card by tests/test_torch_gpu.py and chip_smoke.py).

Tolerances:
* against the lax nn_search / knn_search: indices equal; d2 within rtol
  1e-15 (float64) or 5e-7 (float32). The two are not bit-equal because
  XLA's CPU backend contracts the sum of squares into fused multiply-adds,
  while the port keeps each square and sum unfused (measured at 300 x 5000:
  3.1e-16 and 1.3e-7 relative);
* against the Pallas kernels in interpret mode: indices equal, d2 within
  rtol 1e-6 (the Pallas transform associates as the port does, its
  distance sum is contracted like XLA's);
* where every coordinate difference and square is exact (the integer and
  half-integer tie lattice), d2 is bit-equal too.
The 1-NN of the overlap gate (nn_search, min_dist_sq) is
held to the same: indices bit-equal everywhere, including masked rows,
queries with no valid ref (+inf, index 0; the Pallas kernel's masked lanes
carry 1e30 there and are compared as such), odd sizes and exact ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu.ops import knn as jk
from simpleicp_tpu.ops.knn_pallas import (
    knn_search_pallas,
    match_transform_pallas,
    nn_search_pallas,
    pad_ref_planes,
)
from simpleicp_tpu.ops.transform import apply_H as j_apply_H
from simpleicp_tpu.ops.transform import rbp_to_H as j_rbp_to_H
from simpleicp_tpu_torch.ops import knn as tk

RTOL = {np.float64: 1e-15, np.float32: 5e-7}
DTYPES = [np.float64, np.float32]


def _clouds(seed, nq, nr, dtype, lo=-10.0, hi=20.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (nq, 3)).astype(dtype),
            rng.uniform(lo, hi, (nr, 3)).astype(dtype))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", DTYPES)
def test_nn_search_vs_lax(dtype):
    q, r = _clouds(201, 300, 5000, dtype)
    dj, ij = jk.nn_search(jnp.asarray(q), jnp.asarray(r))
    dt, it = tk.nn_search(_t(q), _t(r))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL[dtype])
    assert it.dtype == torch.int32


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 10, 40])
def test_knn_search_vs_lax(dtype, k):
    q, r = _clouds(202, 300, 5000, dtype)
    dj, ij = jk.knn_search(jnp.asarray(q), jnp.asarray(r), k)
    dt, it = tk.knn_search(_t(q), _t(r), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL[dtype])
    assert np.all(np.diff(dt.numpy(), axis=1) >= 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_match_transform_vs_lax(dtype):
    """match_transform(Q, X, H) == nn_search(Q, apply_H(X, H))."""
    q, r = _clouds(203, 300, 5000, dtype, -5, 5)
    H = np.asarray(j_rbp_to_H(jnp.asarray(np.array([0.03, -0.02, 0.1, 0.4, -0.2, 0.05], dtype))))
    moved = j_apply_H(jnp.asarray(r), jnp.asarray(H))
    dj, ij = jk.nn_search(jnp.asarray(q), moved)
    dt, it = tk.match_transform(_t(q), _t(r), _t(H))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # apply_H itself is a few ulp apart (FMA contraction), so d2 too
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=100 * RTOL[dtype],
                               atol=10 * np.finfo(dtype).eps)


def test_match_transform_vs_pallas_interpret():
    """Against the TPU kernel it replaces, at the shape of
    tests/test_knn_pallas.py (float64, interpret mode)."""
    rng = np.random.default_rng(204)
    q = rng.uniform(-5, 5, (1000, 3))
    r = rng.uniform(-5, 5, (9100, 3))
    H = np.asarray(j_rbp_to_H(jnp.asarray([0.03, -0.02, 0.1, 0.4, -0.2, 0.05])))
    planes = pad_ref_planes(jnp.asarray(r), ref_tile=2048)
    dp, ip = match_transform_pallas(jnp.asarray(q), planes, jnp.asarray(H),
                                    ref_tile=2048, interpret=True)
    dt, it = tk.match_transform(_t(q), _t(r), _t(H))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ip))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dp), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 10, 40])
def test_knn_vs_pallas_interpret(k):
    """Against the TPU k-NN kernel at the shape of tests/test_knn_pallas.py."""
    q, r = _clouds(205, 700, 5000, np.float32)
    dp, ip = knn_search_pallas(jnp.asarray(q), jnp.asarray(r), k, interpret=True)
    dt, it = tk.knn_search(_t(q), _t(r), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ip))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dp), rtol=1e-6)


def _lattice():
    g = np.arange(6.0)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


def test_ties_go_to_the_lower_index():
    """Queries at cell centres and edge midpoints are equidistant from 2, 4
    or 8 lattice points: the lower index must win (first minimum, stable
    sort), exactly as in the lax functions."""
    rng = np.random.default_rng(206)
    lat = _lattice()
    q = lat[rng.choice(len(lat), 80, replace=False)] + 0.5 * rng.integers(0, 2, (80, 3))
    dj, ij = jk.nn_search(jnp.asarray(q), jnp.asarray(lat))
    dt, it = tk.nn_search(_t(q), _t(lat))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    kj, kij = jk.knn_search(jnp.asarray(q), jnp.asarray(lat), 12)
    kt, kit = tk.knn_search(_t(q), _t(lat), 12)
    np.testing.assert_array_equal(kit.numpy(), np.asarray(kij))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    # within each run of equal distances the indices ascend
    d, i = kt.numpy(), kit.numpy()
    same = d[:, 1:] == d[:, :-1]
    assert np.all(i[:, 1:][same] > i[:, :-1][same])
    eye = np.eye(4)
    mt, mit = tk.match_transform(_t(q), _t(lat), _t(eye))
    np.testing.assert_array_equal(mit.numpy(), it.numpy())
    np.testing.assert_array_equal(mt.numpy(), dt.numpy())


def test_masked_refs_never_win():
    rng = np.random.default_rng(207)
    q = rng.uniform(0, 1, (130, 3))
    r = rng.uniform(0, 1, (3000, 3))
    mask = rng.random(3000) < 0.4
    dj, ij = jk.nn_search(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask))
    dt, it = tk.nn_search(_t(q), _t(r), ref_mask=_t(mask))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert mask[it.numpy()].all()
    kj, kij = jk.knn_search(jnp.asarray(q), jnp.asarray(r), 5, ref_mask=jnp.asarray(mask))
    kt, kit = tk.knn_search(_t(q), _t(r), 5, ref_mask=_t(mask))
    np.testing.assert_array_equal(kit.numpy(), np.asarray(kij))
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-15)


def test_fewer_valid_refs_than_k():
    """Slots past the valid refs hold +inf; no valid ref at all gives
    +inf and index 0 for the 1-NN."""
    rng = np.random.default_rng(208)
    q = rng.uniform(0, 1, (20, 3))
    r = rng.uniform(0, 1, (300, 3))
    mask = np.zeros(300, bool)
    mask[[3, 77, 250]] = True
    kj, kij = jk.knn_search(jnp.asarray(q), jnp.asarray(r), 6, ref_mask=jnp.asarray(mask))
    kt, kit = tk.knn_search(_t(q), _t(r), 6, ref_mask=_t(mask))
    np.testing.assert_array_equal(kit.numpy(), np.asarray(kij))
    assert np.isinf(kt.numpy()[:, 3:]).all() and np.isfinite(kt.numpy()[:, :3]).all()
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-15)
    none = np.zeros(300, bool)
    dj, ij = jk.nn_search(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(none))
    dt, it = tk.nn_search(_t(q), _t(r), ref_mask=_t(none))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert np.isinf(dt.numpy()).all()


def test_min_dist_sq_and_k_too_large():
    q, r = _clouds(209, 50, 400, np.float64)
    np.testing.assert_allclose(
        tk.min_dist_sq(_t(q), _t(r)).numpy(),
        np.asarray(jk.min_dist_sq(jnp.asarray(q), jnp.asarray(r))), rtol=1e-15,
    )
    with pytest.raises(ValueError, match="exceeds"):
        tk.knn_search(_t(q), _t(r[:5]), 6)


def test_plain_versions_chunk_queries(monkeypatch):
    """A distance block smaller than the query count gives the same result
    as one block."""
    q, r = _clouds(210, 257, 1000, np.float64)
    d1, i1 = tk.knn_search(_t(q), _t(r), 7)
    n1, m1 = tk.nn_search(_t(q), _t(r))
    monkeypatch.setattr(tk, "_PLAIN_BLOCK_ELEMS", 3 * 1000)
    d2, i2 = tk.knn_search(_t(q), _t(r), 7)
    n2, m2 = tk.nn_search(_t(q), _t(r))
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    assert torch.equal(m1, m2) and torch.equal(n1, n2)


NN_SHAPES = [(1, 1), (7, 130), (512, 2048), (600, 3000), (1003, 4777)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq,nr", NN_SHAPES)
def test_nn_search_auto_vs_lax(dtype, nq, nr):
    """The port's nn_search against the JAX gate's dispatcher
    nn_search_auto under each of its tile and kernel choices, and
    min_dist_sq in the JAX call form; odd sizes, with and without a ref
    mask."""
    q, r = _clouds(211 + nq, nq, nr, dtype, -5, 5)
    mask = np.random.default_rng(nr).random(nr) < 0.6
    mask[0] = True
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else _t(m)
        dt, it = tk.nn_search(_t(q), _t(r), ref_mask=tm)
        for kw in ({}, dict(ref_tile=64, query_tile=16, use_pallas=False)):
            dj, ij = jk.nn_search_auto(jnp.asarray(q), jnp.asarray(r), ref_mask=jm, **kw)
            np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
            np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL[dtype])
        np.testing.assert_array_equal(
            tk.min_dist_sq(_t(q), _t(r), ref_tile=64, query_tile=16,
                           ref_mask=tm).numpy(), dt.numpy())


@pytest.mark.parametrize("nq,nr", NN_SHAPES[:3])
def test_nn_search_vs_pallas_interpret(nq, nr):
    """Against the TPU 1-NN kernel it replaces, at the shapes of
    tests/test_knn_pallas.py, masked and unmasked (float32)."""
    q, r = _clouds(212 + nr, nq, nr, np.float32, 0, 1)
    mask = np.zeros(nr, bool)
    mask[::3] = True
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        dp, ip = nn_search_pallas(jnp.asarray(q), jnp.asarray(r), ref_mask=jm,
                                  interpret=True)
        dt, it = tk.nn_search(_t(q), _t(r), ref_mask=None if m is None else _t(m))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ip))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dp), rtol=1e-6)


def test_nn_search_no_valid_ref_and_tie_lattice():
    """No valid ref: +inf and index 0 (lax), where the Pallas kernel gives
    its 1e30 marker and index 0. On the tie lattice, masked and unmasked,
    indices and d2 are bit-equal to both."""
    rng = np.random.default_rng(213)
    lat = _lattice()
    q = lat[rng.choice(len(lat), 80, replace=False)] + 0.5 * rng.integers(0, 2, (80, 3))
    none = np.zeros(len(lat), bool)
    dj, ij = jk.nn_search(jnp.asarray(q), jnp.asarray(lat), ref_mask=jnp.asarray(none))
    dp, ip = nn_search_pallas(jnp.asarray(q, np.float32), jnp.asarray(lat, np.float32),
                              ref_mask=jnp.asarray(none), interpret=True)
    dt, it = tk.nn_search(_t(q), _t(lat), ref_mask=_t(none))
    assert np.isinf(dt.numpy()).all() and not it.numpy().any()
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ip))
    assert (np.asarray(dp) >= 1e30).all()
    mask = rng.random(len(lat)) < 0.5
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        dj, ij = jk.nn_search(jnp.asarray(q), jnp.asarray(lat), ref_mask=jm)
        dp, ip = nn_search_pallas(jnp.asarray(q, np.float32),
                                  jnp.asarray(lat, np.float32), ref_mask=jm,
                                  interpret=True)
        dt, it = tk.nn_search(_t(q), _t(lat), ref_mask=None if m is None else _t(m))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ip))
        np.testing.assert_array_equal(dt.numpy().astype(np.float32), np.asarray(dp))
