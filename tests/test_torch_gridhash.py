"""The port's spatial-hash cell list (``simpleicp_tpu_torch/ops/gridhash.py``,
CPU) against the JAX package's ``simpleicp_tpu/ops/gridhash.py``, on the
same numpy-seeded inputs in float64 and float32, mirroring
tests/test_gridhash.py.

Tolerances: the hash, the cells, the sort (``sorted_slots``, ``order``,
``origin``, ``run_end``), every index, certificate and cell cap equal; d2
within 4 ulp (XLA contracts the sum of squares into fused multiply-adds,
PyTorch does not; on the tie lattice every product is exact and d2 is
bit-equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu.models.icp import _grid_build_cap_jit as jax_grid_build_cap
from simpleicp_tpu.ops import gridhash as jg
from simpleicp_tpu_torch.ops import gridhash as tg
from simpleicp_tpu_torch.ops.knn import knn_search_plain

DTYPES = [np.float64, np.float32]
JDT = {np.float64: jnp.float64, np.float32: jnp.float32}


def _ids(dt):
    return np.dtype(dt).name


def _mixed(seed, dt):
    """tests/test_gridhash.py:13's cloud: uniform refs with a dense cluster
    (a large cell cap), queries partly outside the refs' box."""
    rng = np.random.default_rng(seed)
    refs = np.concatenate([rng.uniform(0, 10, (6000, 3)), rng.normal(5.0, 0.1, (800, 3))])
    queries = rng.uniform(-2, 12, (2003, 3))
    return refs.astype(dt), queries.astype(dt)


def _assert_d2_close(port, ref, dt):
    """Equal infinities; finite values within 4 ulp."""
    port, ref = np.asarray(port), np.asarray(ref)
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    fin = np.isfinite(ref)
    ulp = np.spacing(np.abs(ref[fin]).astype(dt))
    assert np.all(np.abs(port[fin] - ref[fin]) <= 4 * ulp)


def _grids(refs, radius, valid=None, origin=None):
    dt = refs.dtype.type
    J = jg.build_sorted_grid(jnp.asarray(refs), jnp.asarray(radius, JDT[dt]),
                             None if valid is None else jnp.asarray(valid),
                             None if origin is None else jnp.asarray(origin))
    T = tg.build_sorted_grid(torch.from_numpy(refs), radius,
                             None if valid is None else torch.from_numpy(valid),
                             None if origin is None else torch.from_numpy(origin))
    return J, T


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
@pytest.mark.parametrize("variant", ["plain", "valid", "origin", "valid_origin"])
def test_build_sorted_grid_bit_equal(dt, variant):
    refs, _ = _mixed(11, dt)
    rng = np.random.default_rng(12)
    valid = rng.random(len(refs)) < 0.7 if "valid" in variant else None
    origin = np.array([-1.25, -0.5, -3.0], dt) if "origin" in variant else None
    J, T = _grids(refs, 0.5, valid, origin)
    for name, a, b in zip(("sorted_pts", "sorted_slots", "order", "origin", "run_end"), J, T):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert T[1].dtype == T[4].dtype == torch.int32
    if valid is not None:
        assert int((T[1] == tg._HASH_SIZE).sum()) == int((~valid).sum())


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
@pytest.mark.parametrize("with_run_end", [True, False])
def test_grid_query_sorted_equals_jax(dt, with_run_end):
    """Positions bit-equal, d2 within 4 ulp, on the mixed-density cloud
    with queries outside the box (some with no reference in reach)."""
    refs, queries = _mixed(13, dt)
    r = 0.5
    cap = tg.grid_cell_cap(refs, r)
    J, T = _grids(refs, r)
    jd, jp = jg.grid_query_sorted(jnp.asarray(queries), J[0], J[1], J[3], r, cell_cap=cap,
                                  run_end=J[4] if with_run_end else None)
    td, tp = tg.grid_query_sorted(torch.from_numpy(queries), T[0], T[1], T[3], r,
                                  cell_cap=cap, run_end=T[4] if with_run_end else None)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _assert_d2_close(td.numpy(), jd, dt)
    found = np.isfinite(td.numpy())
    assert 0.2 < found.mean() < 0.9  # both answers occur
    assert not tp.numpy()[~found].any()  # (+inf, 0) without a candidate


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_nn_within_radius_and_min_dist_sq_grid_equal_jax(dt):
    refs, queries = _mixed(14, dt)
    r = 0.4
    cap = tg.grid_cell_cap(refs, r)
    jd, ji = jg.nn_within_radius_grid(jnp.asarray(queries), jnp.asarray(refs), r, cell_cap=cap)
    td, ti = tg.nn_within_radius_grid(torch.from_numpy(queries), torch.from_numpy(refs), r,
                                      cell_cap=cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    _assert_d2_close(td.numpy(), jd, dt)
    md = tg.min_dist_sq_grid(torch.from_numpy(queries), torch.from_numpy(refs), r, cell_cap=cap)
    assert torch.equal(md, td)


@pytest.mark.parametrize("per_pass", [1, 7, 500])
def test_chunking_changes_no_result(monkeypatch, per_pass):
    """The queries in one pass (below the block cap) or in chunks of
    ``per_pass`` queries (the block cap lowered) give the same bits."""
    refs, queries = _mixed(15, np.float32)
    r = 0.5
    cap = tg.grid_cell_cap(refs, r)
    T = tg.build_sorted_grid(torch.from_numpy(refs), r)
    q = torch.from_numpy(queries)

    def both():
        return (tg.grid_query_sorted(q, T[0], T[1], T[3], r, cell_cap=cap, run_end=T[4])
                + tg.knn_query_sorted(q, *T[:4], r, 7, cell_cap=cap, run_end=T[4]))

    assert len(tg._query_chunks(len(queries), cap)) == 1
    whole = both()
    monkeypatch.setattr(tg, "_BLOCK_SLOTS", 27 * cap * per_pass)
    assert len(tg._query_chunks(len(queries), cap)) == -(-len(queries) // per_pass)
    assert all(torch.equal(a, b) for a, b in zip(whole, both()))


def test_block_cap_splits_the_queries(monkeypatch):
    """Above the block cap the queries go in chunks of the cap's size."""
    monkeypatch.setattr(tg, "_BLOCK_SLOTS", 27 * 40 * 100)
    chunks = tg._query_chunks(1050, 40)
    assert [c.stop - c.start for c in chunks] == [100] * 10 + [50]
    assert len(tg._query_chunks(1050, 0)) == 1  # a cap of 0 counts as 1


def _knn_both(refs, queries, r, k, cap, cert_margin=1e-3):
    J, T = _grids(refs, r)
    dt = refs.dtype.type
    jr = jg.knn_query_sorted(jnp.asarray(queries), *J[:4], jnp.asarray(r, JDT[dt]), k,
                             cell_cap=cap, run_end=J[4], cert_margin=cert_margin)
    tr = tg.knn_query_sorted(torch.from_numpy(queries), *T[:4], r, k, cell_cap=cap,
                             run_end=T[4], cert_margin=cert_margin)
    return [np.asarray(x) for x in jr], [x.numpy() for x in tr]


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_knn_query_tie_lattice(dt):
    """tests/test_gridhash.py:82: a scrambled lattice, queries at cell
    centres with 8 neighbours tied at 0.75: every tie goes to the lower
    index, as in the JAX package and in the plain dense k-NN."""
    g = np.arange(8, dtype=np.float64)
    refs = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    refs = refs[np.random.default_rng(3).permutation(len(refs))]
    interior = ((refs >= 1) & (refs <= 5)).all(axis=1)
    queries = (refs[interior][:200] + 0.5).astype(dt)
    refs = refs.astype(dt)
    k, r = 12, 2.1
    (jd, ji, jc), (td, ti, tc) = _knn_both(refs, queries, r, k, tg.grid_cell_cap(refs, r))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tc, jc)
    assert tc.all()
    dd, di = knn_search_plain(torch.from_numpy(queries), torch.from_numpy(refs), k)
    np.testing.assert_array_equal(ti, di.numpy())
    np.testing.assert_array_equal(td, dd.numpy())


def _colliding_cells():
    """Two neighbour cells, (a, b, 0) and (a + 1, b + 1, 0), whose hashes
    share one slot (found by a birthday search over a, b < 2^17)."""
    a, b = 32399, 124734
    cells = torch.tensor([[a, b, 0], [a + 1, b + 1, 0]])
    slots = tg._slot_of(cells)
    assert slots[0] == slots[1]
    return a, b


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_knn_query_masks_duplicate_slots(dt):
    """A query whose 27 probes include two neighbour cells hashed to one
    slot scans that run once: no duplicate in its list, as in the JAX
    package."""
    a, b = _colliding_cells()
    rng = np.random.default_rng(17)
    centre = np.array([a + 0.5, b + 0.5, 0.5])
    refs = np.concatenate([
        np.zeros((1, 3)),                                       # pins the origin
        centre + rng.uniform(-0.3, 0.3, (20, 3)),               # cell (a, b, 0)
        centre + [1, 1, 0] + rng.uniform(-0.3, 0.3, (20, 3)),  # cell (a+1, b+1, 0)
    ]).astype(dt)
    queries = (centre + rng.uniform(-0.4, 0.4, (30, 3))).astype(dt)
    r, k = 1.0, 10
    cap = tg.grid_cell_cap(refs, r)
    T = tg.build_sorted_grid(torch.from_numpy(refs), r)
    assert int((T[4] - torch.arange(len(refs), dtype=torch.int32)).max()) == 40  # one run
    (jd, ji, jc), (td, ti, tc) = _knn_both(refs, queries, r, k, cap)
    np.testing.assert_array_equal(ti, ji)
    _assert_d2_close(td, jd, dt)
    np.testing.assert_array_equal(tc, jc)
    assert all(len(set(row)) == k for row in ti)


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_knn_query_pads_below_k_candidates(dt):
    """27 * cell_cap < k: the lists are padded with (+inf, 2^31 - 1) and no
    row is certified, as in the JAX package."""
    refs, queries = _mixed(18, dt)
    (jd, ji, jc), (td, ti, tc) = _knn_both(refs, queries[:300], 0.2, 30, 1)
    assert td.shape == (300, 30)
    np.testing.assert_array_equal(ti, ji)
    _assert_d2_close(td, jd, dt)
    np.testing.assert_array_equal(tc, jc)
    assert (ti[:, 27:] == 2**31 - 1).all() and np.isinf(td[:, 27:]).all() and not tc.any()


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_knn_query_uncertified_rows(dt):
    """tests/test_gridhash.py:107: a radius under the median 10th-neighbour
    distance leaves about half the rows uncertified; certificates equal the
    JAX package's, and certified rows equal the dense k-NN."""
    rng = np.random.default_rng(19)
    refs = rng.uniform(0, 1, (3000, 3)).astype(dt)
    queries = rng.uniform(0, 1, (600, 3)).astype(dt)
    k = 10
    dd, di = knn_search_plain(torch.from_numpy(queries), torch.from_numpy(refs), k)
    d10 = np.sqrt(dd.numpy()[:, -1].astype(np.float64))
    r = float(np.median(d10)) * 0.8
    (jd, ji, jc), (td, ti, tc) = _knn_both(refs, queries, r, k, tg.grid_cell_cap(refs, r))
    np.testing.assert_array_equal(tc, jc)
    assert 0 < tc.sum() < len(queries)
    np.testing.assert_array_equal(ti, ji)
    _assert_d2_close(td, jd, dt)
    np.testing.assert_array_equal(ti[tc], di.numpy()[tc])
    np.testing.assert_array_equal(td[tc], dd.numpy()[tc])
    assert tc[d10 < r * 0.9].all()


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_knn_search_grid_equals_jax_and_dense(dt):
    """tests/test_gridhash.py:60: with a generous radius every row is
    certified, equal to the JAX package's and bit-equal to the port's dense
    k-NN (the same elementwise d2)."""
    rng = np.random.default_rng(20)
    refs = rng.uniform(0, 1, (5000, 3)).astype(dt)
    queries = rng.uniform(0, 1, (800, 3)).astype(dt)
    k = 10
    dd, di = knn_search_plain(torch.from_numpy(queries), torch.from_numpy(refs), k)
    r = float(np.sqrt(dd.numpy()[:, -1].max())) * 1.3
    cap = tg.grid_cell_cap(refs, r)
    jd, ji, jc = jg.knn_search_grid(jnp.asarray(queries), jnp.asarray(refs), r, k, cell_cap=cap)
    td, ti, tc = tg.knn_search_grid(torch.from_numpy(queries), torch.from_numpy(refs), r, k,
                                    cell_cap=cap)
    assert tc.all() and np.asarray(jc).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _assert_d2_close(td.numpy(), jd, dt)
    assert torch.equal(ti, di) and torch.equal(td, dd)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_grid_cell_cap_equals_jax(seed):
    rng = np.random.default_rng(seed)
    refs = np.concatenate([rng.uniform(-50, 50, (4000, 3)),
                           rng.normal(3.0, 0.05 * seed / 21, (500, 3))])
    for r in (0.05, 0.5, 4.0):
        assert tg.grid_cell_cap(refs, r) == jg.grid_cell_cap(refs, r)
    assert tg.grid_cell_cap(np.zeros((0, 3)), 1.0) == jg.grid_cell_cap(np.zeros((0, 3)), 1.0)


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_grid_build_cap_equals_jax(dt):
    """The device count of the occupancy (no slack) equals the JAX
    package's ``_grid_build_cap_jit``, and its grid is build_sorted_grid's."""
    refs, _ = _mixed(24, dt)
    r = 0.3
    (jgrid, jcap) = jax_grid_build_cap(jnp.asarray(refs), jnp.asarray(r, JDT[dt]))
    tgrid, tcap = tg.grid_build_cap(torch.from_numpy(refs), r)
    assert int(tcap) == int(jcap)
    assert int(tcap) + 4 <= tg.grid_cell_cap(refs, r)
    for a, b in zip(jgrid, tgrid):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_slot_hash_parity_negative_and_wrapping_cells():
    """The int32 products of the JAX hash wrap past 2^31; the port's int64
    products masked to 30 bits give the same slots, negative cells
    included."""
    rng = np.random.default_rng(25)
    cells = np.concatenate([
        rng.integers(-2**31, 2**31, (4000, 3)),
        rng.integers(-300, 300, (1000, 3)),
        [[2**31 - 1, -2**31, 0], [-1, -1, -1], [0, 0, 0], [30, 111, 2**20]],
    ]).astype(np.int32)
    want = np.asarray(jg._slot_of(jnp.asarray(cells)))
    got = tg._slot_of(torch.from_numpy(cells)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got >= 0).all() and (got < 2**30).all()


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_cells_equal_jax_outside_the_box(dt):
    """Cells of points below the origin are negative; floor((p - o) * inv)
    with inv = 1 / r in the coordinate dtype, as in the JAX package."""
    pts = np.random.default_rng(26).uniform(-7, 7, (3000, 3)).astype(dt)
    origin = np.array([0.1, -0.2, 0.3], dt)
    r = 0.37
    inv = 1.0 / jnp.asarray(r, JDT[dt])
    want = np.asarray(jg._cell_of(jnp.asarray(pts), jnp.asarray(origin), inv))
    got = tg._cell_of(torch.from_numpy(pts), torch.from_numpy(origin),
                      1.0 / torch.tensor(r, dtype=torch.from_numpy(pts).dtype))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any()


def test_no_reference_in_reach():
    """tests/test_gridhash.py:49: queries far from every reference get
    d2 = +inf and the index at sorted position 0, as in the JAX package."""
    rng = np.random.default_rng(27)
    refs = rng.uniform(0, 1, (500, 3))
    queries = refs + 100.0
    cap = tg.grid_cell_cap(refs, 0.25)
    d2, idx = tg.nn_within_radius_grid(torch.from_numpy(queries), torch.from_numpy(refs), 0.25,
                                       cell_cap=cap)
    jd, ji = jg.nn_within_radius_grid(jnp.asarray(queries), jnp.asarray(refs), 0.25,
                                      cell_cap=cap)
    order = tg.build_sorted_grid(torch.from_numpy(refs), 0.25)[2]
    assert torch.isinf(d2).all() and (idx == order[0]).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert np.isinf(np.asarray(jd)).all()
