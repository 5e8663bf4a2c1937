"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA card: ``pytest -m gpu tests/test_torch_gpu.py``.
Without a card every test skips (the decision is taken inside the fixture,
so every xdist worker collects the same tests). Tolerance: none — indices
equal and d2 bit-equal, because the kernels round every product and sum as
the plain version's separate elementwise operations do.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rigid(rng, dtype, dev):
    from simpleicp_tpu_torch.ops.transform import rbp_to_H

    p = rng.uniform([-0.2] * 3 + [-1.0] * 3, [0.2] * 3 + [1.0] * 3)
    return rbp_to_H(torch.tensor(p, dtype=dtype, device=dev))


def _equal(kernel_out, plain_out):
    torch.cuda.synchronize()
    (dk, ik), (dp, ip) = kernel_out, plain_out
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)


SHAPES = [(1, 1), (7, 130), (512, 2048), (1000, 100_000)]
DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq,nr", SHAPES)
def test_match_transform_kernel(cuda, dtype, nq, nr):
    from simpleicp_tpu_torch.ops import knn, knn_cuda

    rng = np.random.default_rng(nq + nr)
    q = torch.as_tensor(rng.uniform(-5, 5, (nq, 3)), dtype=dtype, device=cuda)
    r = torch.as_tensor(rng.uniform(-5, 5, (nr, 3)), dtype=dtype, device=cuda)
    H = _rigid(rng, dtype, cuda)
    before = knn_cuda.LAUNCHES["match_transform"]
    out = knn.match_transform(q, r, H)
    assert knn_cuda.LAUNCHES["match_transform"] == before + 1
    _equal(out, knn.match_transform_plain(q, r, H))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq,nr", SHAPES)
@pytest.mark.parametrize("k", [1, 10, 40])
def test_knn_kernel(cuda, dtype, nq, nr, k):
    from simpleicp_tpu_torch.ops import knn, knn_cuda

    k = min(k, nr)
    rng = np.random.default_rng(3 * nq + nr + k)
    q = torch.as_tensor(rng.uniform(-5, 5, (nq, 3)), dtype=dtype, device=cuda)
    r = torch.as_tensor(rng.uniform(-5, 5, (nr, 3)), dtype=dtype, device=cuda)
    before = knn_cuda.LAUNCHES["knn_search"]
    out = knn.knn_search(q, r, k)
    assert knn_cuda.LAUNCHES["knn_search"] == before + 1
    _equal(out, knn.knn_search_plain(q, r, k))


@pytest.mark.parametrize("dtype", DTYPES)
def test_knn_kernel_mask_and_ties(cuda, dtype):
    from simpleicp_tpu_torch.ops import knn

    rng = np.random.default_rng(7)
    g = np.arange(8.0)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    q = lat[rng.choice(len(lat), 200, replace=False)] + 0.5 * rng.integers(0, 2, (200, 3))
    Q = torch.as_tensor(q, dtype=dtype, device=cuda)
    R = torch.as_tensor(lat, dtype=dtype, device=cuda)
    _equal(knn.knn_search(Q, R, 26), knn.knn_search_plain(Q, R, 26))
    eye = torch.eye(4, dtype=dtype, device=cuda)
    _equal(knn.match_transform(Q, R, eye), knn.match_transform_plain(Q, R, eye))
    mask = torch.as_tensor(rng.random(len(lat)) < 0.3, device=cuda)
    _equal(knn.knn_search(Q, R, 12, ref_mask=mask),
           knn.knn_search_plain(Q, R, 12, ref_mask=mask))
    few = torch.zeros(len(lat), dtype=torch.bool, device=cuda)
    few[[4, 100]] = True
    _equal(knn.knn_search(Q, R, 5, ref_mask=few),
           knn.knn_search_plain(Q, R, 5, ref_mask=few))


# k on each side of the k-NN's list sizes (32 pairs: one slot a lane; 64:
# two), at the main path's shape and at a normals-like all-points shape
BUCKET_KS = [1, 10, 31, 32, 33, 40, 64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq,nr", [(1000, 100_000), (20_000, 20_000)])
@pytest.mark.parametrize("k", BUCKET_KS)
def test_knn_kernel_buckets(cuda, dtype, nq, nr, k):
    from simpleicp_tpu_torch.ops import knn, knn_cuda

    rng = np.random.default_rng(nq + k)
    q = torch.as_tensor(rng.uniform(-5, 5, (nq, 3)), dtype=dtype, device=cuda)
    r = torch.as_tensor(rng.uniform(-5, 5, (nr, 3)), dtype=dtype, device=cuda)
    before = dict(knn_cuda.LAUNCHES)
    out = knn.knn_search(q, r, k)
    assert knn_cuda.LAUNCHES == {**before, "knn_search": before["knn_search"] + 1}
    _equal(out, knn.knn_search_plain(q, r, k))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [5, 26, 33, 64])
def test_knn_kernel_masks_ties_and_plans(cuda, dtype, k, monkeypatch):
    """Masks (random, and fewer valid refs than k), the tie lattice
    repeated so that ties fall in different chunks, under the wrapper's
    plan and under forced plans of ragged chunks (one launch each)."""
    from simpleicp_tpu_torch.ops import knn, knn_cuda

    rng = np.random.default_rng(31 + k)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=cuda)
    g = np.arange(10.0)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    Q = T(lat[rng.choice(len(lat), 300, replace=False)] + 0.5 * rng.integers(0, 2, (300, 3)))
    R = T(np.concatenate([lat] * 5))
    mask = torch.as_tensor(rng.random(len(R)) < 0.3, device=cuda)
    few = torch.zeros(len(R), dtype=torch.bool, device=cuda)
    few[torch.as_tensor(rng.choice(len(R), k - 2 if k > 2 else 0, replace=False),
                        dtype=torch.long, device=cuda)] = True
    plans = [None, (1000, 5), (333, 16), (5000, 1)]
    for plan in plans:
        if plan is not None:
            monkeypatch.setattr(knn_cuda, "_plan_knn_chunks", lambda *a, p=plan: p)
        for m in (None, mask, few):
            before = knn_cuda.LAUNCHES["knn_search"]
            out = knn.knn_search(Q, R, k, ref_mask=m)
            assert knn_cuda.LAUNCHES["knn_search"] == before + 1
            _equal(out, knn.knn_search_plain(Q, R, k, ref_mask=m))


@pytest.mark.parametrize("dtype", DTYPES)
def test_match_kernel_rigid_and_ties(cuda, dtype):
    """The match at 1000 x 200 000 under a random rigid H, and on the tie
    lattice (repeated, so that ties fall in different chunks) under the
    identity: one launch each."""
    from simpleicp_tpu_torch.ops import knn, knn_cuda

    rng = np.random.default_rng(37)
    q = torch.as_tensor(rng.uniform(-5, 5, (1000, 3)), dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.uniform(-5, 5, (200_000, 3)), dtype=dtype, device=cuda)
    g = np.arange(10.0)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    lq = torch.as_tensor(lat[rng.choice(len(lat), 1000)] + 0.5 * rng.integers(0, 2, (1000, 3)),
                         dtype=dtype, device=cuda)
    lr = torch.as_tensor(np.concatenate([lat] * 50), dtype=dtype, device=cuda)
    eye = torch.eye(4, dtype=dtype, device=cuda)
    for Q, X, H in ((q, x, _rigid(rng, dtype, cuda)), (lq, lr, eye)):
        before = dict(knn_cuda.LAUNCHES)
        out = knn.match_transform(Q, X, H)
        assert knn_cuda.LAUNCHES == {**before,
                                     "match_transform": before["match_transform"] + 1}
        _equal(out, knn.match_transform_plain(Q, X, H))


NN_SHAPES = SHAPES + [(4099, 3001), (100_000, 100_000)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq,nr", NN_SHAPES)
def test_nn_kernel(cuda, dtype, nq, nr):
    """The 1-NN kernel of the overlap gate, with and without a ref mask."""
    from simpleicp_tpu_torch.ops import knn, knn_cuda

    rng = np.random.default_rng(5 * nq + nr)
    q = torch.as_tensor(rng.uniform(-5, 5, (nq, 3)), dtype=dtype, device=cuda)
    r = torch.as_tensor(rng.uniform(-5, 5, (nr, 3)), dtype=dtype, device=cuda)
    mask = torch.as_tensor(rng.random(nr) < 0.5, device=cuda)
    before = knn_cuda.LAUNCHES["nn_search"]
    out = knn.nn_search(q, r)
    assert knn_cuda.LAUNCHES["nn_search"] == before + 1
    _equal(out, knn.nn_search_plain(q, r))
    _equal(knn.nn_search(q, r, ref_mask=mask),
           knn.nn_search_plain(q, r, ref_mask=mask))
    # the d2-only mode, which min_dist_sq launches
    before = dict(knn_cuda.LAUNCHES)
    d2 = knn.min_dist_sq(q, r, ref_mask=mask)
    assert knn_cuda.LAUNCHES == {**before, "nn_search_d2": before["nn_search_d2"] + 1}
    torch.cuda.synchronize()
    assert torch.equal(d2, knn.nn_search_plain(q, r, ref_mask=mask)[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_nn_kernel_ties_and_no_valid_ref(cuda, dtype):
    from simpleicp_tpu_torch.ops import knn

    rng = np.random.default_rng(9)
    g = np.arange(10.0)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    q = lat[rng.choice(len(lat), 500, replace=False)] + 0.5 * rng.integers(0, 2, (500, 3))
    Q = torch.as_tensor(q, dtype=dtype, device=cuda)
    R = torch.as_tensor(lat, dtype=dtype, device=cuda)
    _equal(knn.nn_search(Q, R), knn.nn_search_plain(Q, R))
    mask = torch.as_tensor(rng.random(len(lat)) < 0.3, device=cuda)
    _equal(knn.nn_search(Q, R, ref_mask=mask), knn.nn_search_plain(Q, R, ref_mask=mask))
    none = torch.zeros(len(lat), dtype=torch.bool, device=cuda)
    d, i = knn.nn_search(Q, R, ref_mask=none)
    _equal((d, i), knn.nn_search_plain(Q, R, ref_mask=none))
    assert bool(torch.isinf(d).all()) and not bool(i.any())
    for m in (None, mask, none):
        d2 = knn.min_dist_sq(Q, R, ref_mask=m)
        torch.cuda.synchronize()
        assert torch.equal(d2, knn.nn_search_plain(Q, R, ref_mask=m)[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_nn_kernel_query_slices(cuda, dtype, monkeypatch):
    """Queries beyond one launch's grid go in slices, one launch each, with
    the unsliced result (the grid's limit lowered to 1 024 queries), in
    both modes."""
    from simpleicp_tpu_torch.ops import knn, knn_cuda

    rng = np.random.default_rng(11)
    q = torch.as_tensor(rng.uniform(-5, 5, (4099, 3)), dtype=dtype, device=cuda)
    r = torch.as_tensor(rng.uniform(-5, 5, (3001, 3)), dtype=dtype, device=cuda)
    mask = torch.as_tensor(rng.random(3001) < 0.5, device=cuda)
    whole = knn.nn_search(q, r, ref_mask=mask)
    monkeypatch.setattr(knn_cuda, "_NN_MAX_QUERIES", 1024)
    before = knn_cuda.LAUNCHES["nn_search"]
    out = knn.nn_search(q, r, ref_mask=mask)
    assert knn_cuda.LAUNCHES["nn_search"] == before + 5
    _equal(out, whole)
    _equal(out, knn.nn_search_plain(q, r, ref_mask=mask))
    before = knn_cuda.LAUNCHES["nn_search_d2"]
    d2 = knn.min_dist_sq(q, r, ref_mask=mask)
    assert knn_cuda.LAUNCHES["nn_search_d2"] == before + 5
    torch.cuda.synchronize()
    assert torch.equal(d2, whole[0])


def _nn_edge_cases(dtype, dev, rng):
    """(name, queries, refs, mask, reference mask): the 1-NN's tie and edge
    cases. The reference is the plain version under the reference mask: a
    NaN distance never wins in the kernel, where the plain argmin takes the
    first NaN, so for refs with NaN coordinates the reference masks them."""
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    g = np.arange(10.0)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    # 2 500 queries (three query blocks of 1 024, the last ragged) at cell
    # centres and edge midpoints, against 40 copies of the lattice: every
    # answer is an exact tie across sub-tiles, tiles and reference chunks.
    lq = T(lat[rng.choice(len(lat), 2500)] + 0.5 * rng.integers(0, 2, (2500, 3)))
    lr = T(np.concatenate([lat] * 40))
    cases = [("ties across tiles, chunks and query blocks", lq, lr, None, None)]
    m = torch.as_tensor(rng.random(len(lr)) < 0.5, device=dev)
    cases.append(("ties, masked", lq, lr, m, m))
    # each query's nearest ref repeated at the start of every tile: every
    # later tile's minimum equals the running best and must not take it
    q = T(rng.uniform(0, 1, (1500, 3)))
    r = rng.uniform(5, 6, (8192, 3))
    r[::512] = np.asarray(q[0].cpu())
    cases.append(("tile minimum equal to the running best", q, T(r), None, None))
    cases.append(("all refs masked", q, T(r), torch.zeros(8192, dtype=torch.bool, device=dev),
                  torch.zeros(8192, dtype=torch.bool, device=dev)))
    rn = rng.uniform(0, 1, (5000, 3))
    rn[1024:2048] = np.nan
    rn[3000, 1] = np.nan
    rn = T(rn)
    finite = ~torch.isnan(rn).any(1)
    cases.append(("a tile of NaN distances", q, rn, None, finite))
    cases.append(("a tile of NaN distances, masked", q, rn, finite, finite))
    # refs by decreasing distance from the queries: every sub-tile improves
    r = rng.uniform(-1, 1, (20000, 3))
    r = r[np.argsort(-(r ** 2).sum(1))]
    cases.append(("refs by decreasing distance", T(rng.uniform(-0.1, 0.1, (3000, 3))),
                  T(r), None, None))
    return cases


@pytest.mark.parametrize("dtype", DTYPES)
def test_nn_kernel_modes_edge_cases(cuda, dtype):
    """Both 1-NN modes bit-equal to the plain version on ties that fall in
    different tiles, chunks and query blocks, a ragged query count, a tile
    minimum equal to the running best, no valid ref, NaN distances and the
    index mode's worst order."""
    from simpleicp_tpu_torch.ops import knn

    rng = np.random.default_rng(17)
    for name, q, r, m, ref_m in _nn_edge_cases(dtype, cuda, rng):
        d, i = knn.nn_search(q, r, ref_mask=m)
        d2 = knn.min_dist_sq(q, r, ref_mask=m)
        pd, pi = knn.nn_search_plain(q, r, ref_mask=ref_m)
        torch.cuda.synchronize()
        assert torch.equal(i, pi), name
        assert torch.equal(d, pd), name
        assert torch.equal(d2, pd), name


def test_gated_icp_register_on_the_card(cuda):
    """The gated path on the card: one 1-NN launch (the gate, in the
    d2-only mode), one k-NN launch, one match launch per iteration;
    float64 on the card equal to float64 on the CPU in iterations,
    selection and last matches, H within 1e-9."""
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models.icp import _icp_register
    from simpleicp_tpu_torch.ops import knn_cuda

    rng = np.random.default_rng(12)

    def surface(n, lo, hi):
        xy = np.column_stack([rng.uniform(lo, hi, n), rng.uniform(-2, 2, n)])
        return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])

    X_fix, X_mov = surface(20000, -2, 2), surface(20000, -1, 3) + [0.02, -0.01, 0.01]
    cfg = IcpConfig(correspondences=500, max_iterations=30, max_overlap_distance=0.1)

    def run(device):
        return _icp_register(
            X_fix, X_mov, cfg, rbp_observed_values=None,
            rbp_observation_weights=None, normals_fix=None, planarity_fix=None,
            planarity_mov=None, fixed_prep=None, device=device,
            dtype=torch.float64)

    knn_cuda.reset_launch_counts()
    g, gc = run(cuda)
    assert knn_cuda.LAUNCHES == {"match_transform": int(g.n_iterations),
                                 "knn_search": 1, "nn_search": 0, "nn_search_d2": 1}
    c, cc = run("cpu")
    assert int(g.n_iterations) == int(c.n_iterations)
    assert torch.equal(g.sel_idx.cpu(), c.sel_idx)
    assert torch.equal(gc.m_idx.cpu(), cc.m_idx)
    assert float((g.H.cpu() - c.H).abs().max()) <= 1e-9
    assert X_fix[g.sel_idx.cpu().numpy(), 0].min() > -1.2


def test_icp_register_on_the_card(cuda):
    """The main path on the card: each kernel launched as often as the path
    needs, and float64 on the card equal to float64 on the CPU in
    iterations, selection and last matches, H within 1e-9. (The two are
    not bit-equal end to end: float64 sin/cos and reduction orders differ
    between the CPU and the card in the last bit.) The movable cloud is an
    independent sample of the surface, so no decision sits at rounding
    noise."""
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models.icp import _icp_register
    from simpleicp_tpu_torch.ops import knn_cuda, solver_cuda

    rng = np.random.default_rng(11)

    def surface(n):
        xy = rng.uniform(-2, 2, (n, 2))
        return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])

    X_fix, X_mov = surface(20000), surface(20000) + [0.02, -0.01, 0.01]
    cfg = IcpConfig(correspondences=500, max_iterations=30)

    def run(device):
        return _icp_register(
            X_fix, X_mov, cfg, rbp_observed_values=None,
            rbp_observation_weights=None, normals_fix=None, planarity_fix=None,
            planarity_mov=None, fixed_prep=None, device=device,
            dtype=torch.float64)

    knn_cuda.reset_launch_counts()
    solver_cuda.reset_launch_counts()
    g, gc = run(cuda)
    assert knn_cuda.LAUNCHES == {"match_transform": int(g.n_iterations), "knn_search": 1,
                                 "nn_search": 0, "nn_search_d2": 0}
    # one solve kernel launch per iteration: the Gauss-Newton loop on the
    # card; one uncertainty kernel launch: the finish
    assert solver_cuda.LAUNCHES == {"gn_solve": int(g.n_iterations), "uncertainties": 1}
    c, cc = run("cpu")
    assert int(g.n_iterations) == int(c.n_iterations)
    assert torch.equal(g.sel_idx.cpu(), c.sel_idx)
    assert torch.equal(gc.m_idx.cpu(), cc.m_idx)
    assert float((g.H.cpu() - c.H).abs().max()) <= 1e-9
    _close_uncertainties(g, c)


def _close_uncertainties(g, c, pairs=...):
    """The card's uncertainties and covariance (of ``pairs`` of a batch)
    within the 1e-7 that test_torch_icp.py holds the CPU's to against the
    JAX package."""
    sg, sc = g.uncertainties.cpu()[pairs], c.uncertainties[pairs]
    assert float((sg - sc).abs().max()) <= 1e-7
    cg, cc = g.covariance.cpu()[pairs], c.covariance[pairs]
    assert float((cg - cc).abs().max()) <= 1e-7 * float(cc.abs().max())


def test_wrappers_check_their_inputs(cuda):
    from simpleicp_tpu_torch.ops import knn_cuda

    # the wrappers take the pair axis (knn adds it for one pair)
    q = torch.zeros((1, 4, 3), device=cuda)
    with pytest.raises(ValueError):
        knn_cuda.knn_search_cuda(q[0], q[0], 2)
    with pytest.raises(TypeError):
        knn_cuda.knn_search_cuda(q, q.double(), 2)
    with pytest.raises(ValueError):
        knn_cuda.knn_search_cuda(q, torch.zeros((1, 4, 6), device=cuda)[..., ::2], 2)
    with pytest.raises(ValueError):
        knn_cuda.knn_search_cuda(q, q, 65)
    with pytest.raises(ValueError):
        knn_cuda.match_transform_cuda(q, q, torch.eye(3, device=cuda)[None])
    with pytest.raises(ValueError):
        knn_cuda.nn_search_cuda(q, q, torch.ones((1, 5), dtype=torch.bool, device=cuda))
    with pytest.raises(TypeError):
        knn_cuda.nn_search_cuda(q, q, torch.ones((1, 4), device=cuda))
    with pytest.raises(ValueError):
        knn_cuda.nn_d2_cuda(q, q, torch.ones((1, 5), dtype=torch.bool, device=cuda))
    with pytest.raises(TypeError):
        knn_cuda.nn_d2_cuda(q, q.double())


# ------------------------------------------------------------ dilate kernel


def _dilate_cases():
    """(name, occ (wz, nx, ny) uint32, stencils): the CPU tests' cases."""
    from simpleicp_tpu_torch.ops.dilate_gate import _pack_occupancy_device, plan_dilate_gate

    rng = np.random.default_rng(21)

    def occ(wz, nx, ny, density=0.02):
        words = rng.random((wz, nx, ny)) < density
        return np.where(words, rng.integers(0, 2**32, (wz, nx, ny), dtype=np.uint32),
                        np.uint32(0))

    a = tuple((dx, dy, 4 - max(abs(dx), abs(dy))) for dx in range(-2, 3) for dy in range(-2, 3))
    b = ((0, 0, 3), (1, -1, 0), (-2, 0, 1))
    cases = [(f"synthetic {s}", occ(*s), [a, b]) for s in [(2, 40, 48), (3, 17, 33), (1, 64, 130)]]
    cases.append(("single stencil", occ(3, 70, 45), [b]))
    cases.append(("empty and one", occ(2, 20, 20), [(), a]))
    carry = np.zeros((3, 9, 10), np.uint32)
    carry[0, 0, 0] = carry[2, 8, 9] = 1 | (1 << 31)
    carry[1, 4, 5], carry[2, 4, 5], carry[0, 8, 0] = 1 << 31, 1, 1 << 31
    for z in (1, 17, 31):
        cases.append((f"carries z={z}", carry, [((0, 0, z), (1, 0, 0), (0, -1, 0)),
                                                ((0, 0, z), (-1, 1, z // 2))]))
    cases.append(("every bit set", np.full((3, 37, 41), 0xFFFFFFFF, np.uint32), [a, b]))
    pts = rng.random((2000, 3)) * np.array([8.0, 6.0, 4.0])
    for div in (16, 8, 4, 2):
        plan = plan_dilate_gate(None, pts, 1.0, cell_div=div)
        words = _pack_occupancy_device(torch.from_numpy(pts), plan=plan).numpy().view(np.uint32)
        cases.append((f"plan cell_div {div}", words.reshape(plan.wz, *plan.dims[:2]),
                      [plan.in_offsets, plan.poss_offsets]))
    # any stencil, no lax precondition: z-radii that do not peak at (0, 0)
    odd = tuple((int(dx), int(dy), int(z)) for dx, dy, z in
                zip(rng.integers(-6, 7, 40), rng.integers(-6, 7, 40), rng.integers(0, 32, 40)))
    cases.append(("random stencil", occ(4, 50, 61, 0.05), [odd, odd[:7]]))
    return cases


def test_dilate_kernel(cuda):
    """Bit-equal to the plain version on every case, and at the largest
    reach the kernel takes (18); one launch per call with a non-empty
    stencil."""
    from simpleicp_tpu_torch.ops import dilate_cuda
    from simpleicp_tpu_torch.ops.dilate_gate import dilate_packed_multi, dilate_packed_multi_plain

    rng = np.random.default_rng(23)
    wide = tuple((int(dx), int(dy), int(z)) for dx, dy, z in
                 zip(rng.integers(-18, 19, 30), rng.integers(-18, 19, 30), rng.integers(0, 32, 30)))
    wide += ((18, -18, 3), (-18, 18, 0))
    occ18 = np.where(rng.random((3, 150, 70)) < 0.01,
                     rng.integers(0, 2**32, (3, 150, 70), dtype=np.uint32), np.uint32(0))
    for name, occ, stencils in _dilate_cases() + [("reach 18", occ18, [wide, wide[:9]])]:
        t = torch.from_numpy(np.ascontiguousarray(occ).view(np.int32)).to(cuda)
        before = dilate_cuda.LAUNCHES["dilate"]
        got = dilate_packed_multi(t, stencils)
        assert dilate_cuda.LAUNCHES["dilate"] == before + 1, name
        want = dilate_packed_multi_plain(t, stencils)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
    t = torch.zeros((2, 5, 5), dtype=torch.int32, device=cuda)
    before = dilate_cuda.LAUNCHES["dilate"]
    assert all(not g.any() for g in dilate_packed_multi(t, [(), ()]))
    assert dilate_cuda.LAUNCHES["dilate"] == before


def test_dilate_wrapper_checks_its_inputs(cuda):
    from simpleicp_tpu_torch.ops import dilate_cuda

    occ = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        dilate_cuda.dilate_cuda(occ.float(), [((0, 0, 1),)])
    with pytest.raises(ValueError):
        dilate_cuda.dilate_cuda(occ[:, :, ::2], [((0, 0, 1),)])
    with pytest.raises(ValueError):
        dilate_cuda.dilate_cuda(occ, [((0, 0, 32),)])
    with pytest.raises(ValueError):
        dilate_cuda.dilate_cuda(occ, [((0, 0, 1),)] * 3)
    with pytest.raises(ValueError):
        dilate_cuda.dilate_cuda(occ, [((60, 0, 1),)])


def test_dilate_gated_icp_register_on_the_card(cuda):
    """gate_method="dilate" on the card: one dilate launch, one 1-NN launch
    (the band, in the d2-only mode), the brute-gated run's selection, and
    float64 on the card equal to float64 on the CPU (iterations, selection,
    last matches, H within 1e-9)."""
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models.icp import _icp_register
    from simpleicp_tpu_torch.ops import dilate_cuda, knn_cuda

    rng = np.random.default_rng(13)

    def surface(n, lo, hi):
        xy = np.column_stack([rng.uniform(lo, hi, n), rng.uniform(-2, 2, n)])
        return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])

    X_fix, X_mov = surface(20000, -2, 2), surface(20000, -1, 3) + [0.02, -0.01, 0.01]

    def run(device, method):
        cfg = IcpConfig(correspondences=500, max_iterations=30, max_overlap_distance=0.1,
                        gate_method=method)
        return _icp_register(
            X_fix, X_mov, cfg, rbp_observed_values=None,
            rbp_observation_weights=None, normals_fix=None, planarity_fix=None,
            planarity_mov=None, fixed_prep=None, device=device,
            dtype=torch.float64)

    knn_cuda.reset_launch_counts()
    dilate_cuda.reset_launch_counts()
    g, gc = run(cuda, "dilate")
    assert dilate_cuda.LAUNCHES == {"dilate": 1}
    assert knn_cuda.LAUNCHES == {"match_transform": int(g.n_iterations),
                                 "knn_search": 1, "nn_search": 0, "nn_search_d2": 1}
    b, _ = run(cuda, "brute")
    assert torch.equal(g.sel_idx, b.sel_idx) and torch.equal(g.H, b.H)
    c, cc = run("cpu", "dilate")
    assert int(g.n_iterations) == int(c.n_iterations)
    assert torch.equal(g.sel_idx.cpu(), c.sel_idx)
    assert torch.equal(gc.m_idx.cpu(), cc.m_idx)
    assert float((g.H.cpu() - c.H).abs().max()) <= 1e-9


@pytest.mark.parametrize("dtype", DTYPES)
def test_dilate_gate_slab_join_on_the_card(cuda, dtype, monkeypatch):
    """The band-ref compaction and the slab join, forced on a 200 000-point
    strips pair (the movable strip tilted, so that a wide band is left to
    resolve): two dilation launches, one d2-only 1-NN launch a block, the
    slab plan's sorts and searches on the card, and the mask equal to the
    brute mask bit for bit."""
    from simpleicp_tpu_torch.ops import dilate_cuda, dilate_gate as dg, knn_cuda
    from simpleicp_tpu_torch.ops.knn import min_dist_sq

    for name, value in (("_DIRECT_SWEEP_MAX", 1), ("_SLAB_SWEEP_MIN", 1),
                        ("_SLAB1_MIN", 256), ("_SLAB_CHUNK_OPTS", (4096, 16384))):
        monkeypatch.setattr(dg, name, value)
    rng = np.random.default_rng(17)
    n, half, a = 200_000, 2.83, 0.05

    def surface(xy):
        return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])

    X_fix = surface(rng.uniform(-half, half, (n, 2)))
    S = surface(rng.uniform(-half, half, (n, 2)) + [half / 2, 0.0])
    R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]])
    Xf = torch.as_tensor(X_fix, dtype=dtype, device=cuda)
    Xm = torch.as_tensor(S @ R.T, dtype=dtype, device=cuda)
    lo, hi = dg.bbox_of(Xm).cpu().numpy()
    plan = dg.plan_dilate_gate(None, None, 0.1, bbox=(lo, hi))
    knn_cuda.reset_launch_counts()
    dilate_cuda.reset_launch_counts()
    stats = {}
    mask = dg.overlap_mask_dilate(Xf, Xm, 0.1, plan, stats=stats)
    assert stats["compaction"] and stats["sweep"] == "slab join", stats
    assert stats["slab_blocks"] > 1 and stats["band"] > 5_000, stats
    assert dilate_cuda.LAUNCHES == {"dilate": 2}
    assert knn_cuda.LAUNCHES["nn_search_d2"] == stats["slab_blocks"]
    brute = min_dist_sq(Xf, Xm) <= torch.tensor(0.1, dtype=dtype, device=cuda) ** 2
    assert torch.equal(mask, brute)


def _serving_pair(n_fix=20000, n_mov=18000, seed=14):
    rng = np.random.default_rng(seed)

    def surface(n):
        xy = rng.uniform(-2, 2, (n, 2))
        return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])

    return surface(n_fix), surface(n_mov) + [0.02, -0.01, 0.01]


@pytest.mark.parametrize("dtype", DTYPES)
def test_prepared_equals_self_contained_on_the_card(cuda, dtype):
    """prepare_fixed on the card, then a prepared registration: bit-equal to
    the self-contained run on the card, every field and the last matches;
    the prepared run launches no k-NN (one match a iteration), the
    preparation exactly one."""
    from simpleicp_tpu_torch import IcpConfig, prepare_fixed
    from simpleicp_tpu_torch.models.icp import _icp_register
    from simpleicp_tpu_torch.ops import knn_cuda

    X_fix, X_mov = _serving_pair()
    Xf = torch.as_tensor(X_fix, dtype=dtype, device=cuda)
    Xm = torch.as_tensor(X_mov, dtype=dtype, device=cuda)
    cfg = IcpConfig(correspondences=2000, max_iterations=30)
    knn_cuda.reset_launch_counts()
    prep = prepare_fixed(Xf, cfg, device=cuda, dtype=dtype)
    assert knn_cuda.LAUNCHES["knn_search"] == 1

    def run(fixed_prep):
        return _icp_register(
            Xf, Xm, cfg, rbp_observed_values=None, rbp_observation_weights=None,
            normals_fix=None, planarity_fix=None, planarity_mov=None,
            fixed_prep=fixed_prep, device=cuda, dtype=dtype)

    knn_cuda.reset_launch_counts()
    p, pc = run(prep)
    torch.cuda.synchronize()
    assert knn_cuda.LAUNCHES == {"match_transform": int(p.n_iterations), "knn_search": 0,
                                 "nn_search": 0, "nn_search_d2": 0}
    s, sc = run(None)
    for f in p._fields:
        assert torch.equal(getattr(p, f), getattr(s, f)), f
    assert torch.equal(pc.m_idx, sc.m_idx)
    assert bool(p.converged) and int(p.error_code) == 0


def test_loaded_preparation_on_the_card(cuda, tmp_path):
    """A preparation saved from the card and loaded back onto it (the
    default device of load_fixed_prep) is bit-equal and serves a
    registration bit-equal to the self-contained one; a float64 file is
    refused by a float32 call, and a preparation on the CPU by a call on
    the card."""
    from simpleicp_tpu_torch import IcpConfig, icp_register, load_fixed_prep, prepare_fixed

    X_fix, X_mov = _serving_pair(12000, 12000, 15)
    cfg = IcpConfig(correspondences=1000)
    prep = prepare_fixed(X_fix, cfg)
    prep.save(tmp_path / "p32.npz")
    loaded = load_fixed_prep(tmp_path / "p32.npz")
    assert loaded.Q.is_cuda and loaded.Q.dtype == torch.float32
    for a, b in zip(prep[:5], loaded[:5]):
        assert torch.equal(a, b)
    ref = icp_register(X_fix, X_mov, cfg)
    got = icp_register(X_fix, X_mov, cfg, fixed_prep=loaded)
    for f in ref._fields:
        assert torch.equal(getattr(ref, f), getattr(got, f)), f

    prepare_fixed(X_fix, cfg, dtype=torch.float64).save(tmp_path / "p64.npz")
    p64 = load_fixed_prep(tmp_path / "p64.npz")
    assert p64.Q.dtype == torch.float64 and p64.Q.is_cuda
    with pytest.raises(ValueError, match="fixed_prep dtype float64 does not match "
                                         "this call's dtype float32"):
        icp_register(X_fix, X_mov, cfg, fixed_prep=p64)
    on_cpu = load_fixed_prep(tmp_path / "p32.npz", device="cpu")
    with pytest.raises(ValueError, match="fixed_prep lies on cpu, but this icp_register "
                                         "call runs on cuda"):
        icp_register(X_fix, X_mov, cfg, fixed_prep=on_cpu)


def test_warm_start_on_the_card(cuda):
    """warm_start=True on the card: the coarse pass runs on strided views of
    the clouds on the card (its own k-NN and match launches, one more k-NN
    in all), and float64 on the card equals float64 on the CPU (iterations,
    selection, H within 1e-9)."""
    from simpleicp_tpu_torch import IcpConfig, icp_register
    from simpleicp_tpu_torch.ops import knn_cuda

    X_fix, X_mov = _serving_pair(30000, 30000, 16)
    cfg = IcpConfig(correspondences=1000, warm_start=True, warm_start_points=10000)
    Xf = torch.as_tensor(X_fix, dtype=torch.float64, device=cuda)
    Xm = torch.as_tensor(X_mov, dtype=torch.float64, device=cuda)
    knn_cuda.reset_launch_counts()
    g = icp_register(Xf, Xm, cfg, dtype=torch.float64)
    torch.cuda.synchronize()
    assert knn_cuda.LAUNCHES["knn_search"] == 2
    assert knn_cuda.LAUNCHES["match_transform"] > int(g.n_iterations)
    c = icp_register(X_fix, X_mov, cfg, device="cpu", dtype=torch.float64)
    assert int(g.n_iterations) == int(c.n_iterations)
    assert torch.equal(g.sel_idx.cpu(), c.sel_idx)
    assert float((g.H.cpu() - c.H).abs().max()) <= 1e-9


# ------------------------------------------------------------- the pair axis


def _stacked_rigid(rng, B, dtype, dev):
    return torch.stack([_rigid(rng, dtype, dev) for _ in range(B)])


def _batched_calls(Q, R, H, k, mask=None):
    """(launch count key, kernel call, plain call, single-pair call of pair
    b) of each kernel with a pair axis, on (B, q, 3) queries and (B, n, 3)
    refs (the match under H (B, 4, 4); the 1-NN under ``mask``)."""
    from simpleicp_tpu_torch.ops import knn

    def m(b):
        return None if mask is None else mask[b]

    return [
        ("match_transform", lambda: knn.match_transform(Q, R, H),
         lambda: knn.match_transform_plain(Q, R, H),
         lambda b: knn.match_transform(Q[b], R[b], H[b])),
        ("knn_search", lambda: knn.knn_search(Q, R, k),
         lambda: knn.knn_search_plain(Q, R, k),
         lambda b: knn.knn_search(Q[b], R[b], k)),
        ("nn_search_d2", lambda: (knn.min_dist_sq(Q, R, ref_mask=mask), None),
         lambda: (knn.nn_search_plain(Q, R, mask)[0], None),
         lambda b: (knn.min_dist_sq(Q[b], R[b], ref_mask=m(b)), None)),
        ("nn_search", lambda: knn.nn_search(Q, R, ref_mask=mask),
         lambda: knn.nn_search_plain(Q, R, mask),
         lambda b: knn.nn_search(Q[b], R[b], ref_mask=m(b))),
    ]


def _check_batched(Q, R, H, k, mask=None, launches=1):
    """Each kernel on the batch: ``launches`` launches, bit-equal to its
    plain version on the batch and to its single-pair launches."""
    from simpleicp_tpu_torch.ops import knn_cuda

    B = Q.shape[0]
    for name, kernel, plain, single in _batched_calls(Q, R, H, k, mask):
        before = knn_cuda.LAUNCHES[name]
        d, i = kernel()
        assert knn_cuda.LAUNCHES[name] == before + launches, name
        torch.cuda.synchronize()
        dp, ip = plain()
        assert torch.equal(d, dp), name
        assert i is None or torch.equal(i, ip), name
        for b in range(B):
            d1, i1 = single(b)
            torch.cuda.synchronize()
            assert torch.equal(d[b], d1), (name, b)
            assert i is None or torch.equal(i[b], i1), (name, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("nq,nr", [(1, 1), (7, 130), (1000, 20_000), (2500, 40_000)])
def test_batched_kernels(cuda, dtype, B, nq, nr):
    """The match, the k-NN and the 1-NN (both modes) on B independent pairs:
    one launch for the batch, each pair bit-equal to the plain version and
    to its own single-pair launch."""
    rng = np.random.default_rng(B * 1000 + nq + nr)
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    Q = T(rng.uniform(-5, 5, (B, nq, 3)))
    R = T(rng.uniform(-5, 5, (B, nr, 3)))
    mask = torch.as_tensor(rng.random((B, nr)) < 0.5, device=cuda)
    _check_batched(Q, R, _stacked_rigid(rng, B, dtype, cuda), min(10, nr))
    _check_batched(Q, R, _stacked_rigid(rng, B, dtype, cuda), min(40, nr), mask)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nr", [1000, 40_000])
def test_batched_kernels_pair_offset_trap(cuda, dtype, nr):
    """Pair b's queries and refs are pair 0's shifted by b x 1e3 along each
    axis, and its H moves them as pair 0's H moves pair 0's: a pass that
    reads another pair's refs, H, mask or partials, or writes into another
    pair's output, gives a d2 of about 1e6 or more, or a wrong index. Query
    blocks are ragged (2 500 queries). At 1 000 refs the k-NN's plan takes
    one chunk (the scan writes the result and fills short lists itself), at
    40 000 several (partials, the merge and the finish passes). Masks: none,
    half the refs, and a sparse one that leaves pair b only b valid refs, so
    that lists short of k are filled from the pair's own mask."""
    from simpleicp_tpu_torch.ops import knn_cuda
    from simpleicp_tpu_torch.ops.transform import rbp_to_H

    rng = np.random.default_rng(99)
    B, nq = 8, 2500
    if nr == 1000:
        waves = knn_cuda._knn_waves(cuda, dtype, 10)
        assert knn_cuda._plan_knn_chunks(nq, nr, 10, waves, B)[1] == 1
    q0, r0 = rng.uniform(-5, 5, (nq, 3)), rng.uniform(-5, 5, (nr, 3))
    shift = 1e3 * np.arange(B)[:, None, None] * np.ones(3)
    p = rng.uniform([-0.2] * 3 + [-1.0] * 3, [0.2] * 3 + [1.0] * 3)
    H0 = rbp_to_H(torch.as_tensor(p)).numpy()
    H = np.repeat(H0[None], B, axis=0)
    # R x_b + t_b = R x_0 + t_0 + s_b for x_b = x_0 + s_b
    H[:, :3, 3] += shift[:, 0] - shift[:, 0] @ H0[:3, :3].T
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    Q, R, Hb = T(q0[None] + shift), T(r0[None] + shift), T(H)
    half = torch.as_tensor(rng.random((B, nr)) < 0.5, device=cuda)
    sparse = np.zeros((B, nr), bool)
    for b in range(B):
        sparse[b, rng.choice(nr, b, replace=False)] = True
    for m in (None, half, torch.as_tensor(sparse, device=cuda)):
        _check_batched(Q, R, Hb, 10, m)
        for _, kernel, _, _ in _batched_calls(Q, R, Hb, 10, m):
            d = kernel()[0]
            # in-pair distances are at most ~300
            assert float(d[torch.isfinite(d)].max()) < 1e3


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_kernels_slices(cuda, dtype, monkeypatch):
    """A batch above a launch's pair limit goes in slices of pairs, and the
    1-NN's queries above its query limit in slices of queries, one launch
    each, with the unsliced result (limits lowered to 3 pairs and 1 024
    queries)."""
    from simpleicp_tpu_torch.ops import knn_cuda

    rng = np.random.default_rng(98)
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    Q, R = T(rng.uniform(-5, 5, (8, 2100, 3))), T(rng.uniform(-5, 5, (8, 3001, 3)))
    H = _stacked_rigid(rng, 8, dtype, cuda)
    mask = torch.as_tensor(rng.random((8, 3001)) < 0.5, device=cuda)
    whole = [kernel() for _, kernel, _, _ in _batched_calls(Q, R, H, 10, mask)]
    monkeypatch.setattr(knn_cuda, "_MAX_PAIRS", 3)
    monkeypatch.setattr(knn_cuda, "_NN_MAX_QUERIES", 1024)
    for (name, kernel, _, _), (d, i) in zip(_batched_calls(Q, R, H, 10, mask), whole):
        before = knn_cuda.LAUNCHES[name]
        ds, is_ = kernel()
        # 3 slices of pairs; the 1-NN and the match also 3 slices of queries
        want = 3 if name == "knn_search" else 9
        assert knn_cuda.LAUNCHES[name] == before + want, name
        torch.cuda.synchronize()
        assert torch.equal(ds, d) and (i is None or torch.equal(is_, i)), name


@pytest.mark.parametrize("gated", [False, True])
def test_icp_register_batch_on_the_card(cuda, gated):
    """icp_register_batch on the card: one k-NN launch, one match launch
    per iteration of the batch (and one gate launch, d2-only), and float64
    on the card equal to float64 on the CPU in iterations, error codes,
    selection and every iteration's matches, H within 1e-9. Gated, pair 1
    has no overlap (ERR_NO_OVERLAP, no iteration)."""
    from simpleicp_tpu_torch import IcpConfig, icp_register_batch
    from simpleicp_tpu_torch.ops import knn_cuda, solver_cuda

    rng = np.random.default_rng(13)

    def surface(n):
        xy = rng.uniform(-2, 2, (n, 2))
        return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])

    X_fix = np.stack([surface(20000) for _ in range(3)])
    X_mov = np.stack([surface(20000) + rng.uniform(-0.03, 0.03, 3) for _ in range(3)])
    kw = dict(max_overlap_distance=0.1) if gated else {}
    if gated:
        X_mov[1] += [100.0, 0.0, 0.0]
    cfg = IcpConfig(correspondences=500, max_iterations=30, record_trajectory=True, **kw)

    def run(device):
        return icp_register_batch(X_fix, X_mov, cfg, device=device, dtype=torch.float64)

    knn_cuda.reset_launch_counts()
    solver_cuda.reset_launch_counts()
    g = run(cuda)
    assert knn_cuda.LAUNCHES == {"match_transform": int(g.n_iterations.max()),
                                 "knn_search": 1, "nn_search": 0,
                                 "nn_search_d2": int(gated)}
    assert solver_cuda.LAUNCHES == {"gn_solve": int(g.n_iterations.max()), "uncertainties": 1}
    c = run("cpu")
    for f in ("n_iterations", "error_code", "converged", "sel_idx", "sel_valid", "iter_midx"):
        assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
    assert float((g.H.cpu() - c.H).abs().max()) <= 1e-9
    # gated, pair 1 has no iteration and no matches to weigh
    _close_uncertainties(g, c, [0, 2] if gated else ...)
    if gated:
        assert g.error_code.tolist() == [0, 1, 0] and int(g.n_iterations[1]) == 0


def _grid_clouds(dtype, dev, seed=31):
    rng = np.random.default_rng(seed)
    refs = np.concatenate([rng.uniform(0, 10, (30_000, 3)), rng.normal(5.0, 0.1, (2000, 3))])
    queries = rng.uniform(-2, 12, (5003, 3))
    return (torch.as_tensor(refs, dtype=dtype, device=dev),
            torch.as_tensor(queries, dtype=dtype, device=dev))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_ops_on_the_card_equal_the_cpu(cuda, dtype):
    """The grid engines are PyTorch operations: on the card they give the
    CPU's bits (the sort, every position and index, d2, certificates)."""
    from simpleicp_tpu_torch.ops import gridhash as tg

    refs, queries = _grid_clouds(dtype, cuda)
    r = 0.5
    cap = tg.grid_cell_cap(refs.cpu().numpy(), r)
    on = tg.build_sorted_grid(refs, r)
    off = tg.build_sorted_grid(refs.cpu(), r)
    for a, b in zip(on, off):
        assert torch.equal(a.cpu(), b)
    for with_run_end in (True, False):
        got = tg.grid_query_sorted(queries, on[0], on[1], on[3], r, cell_cap=cap,
                                   run_end=on[4] if with_run_end else None)
        want = tg.grid_query_sorted(queries.cpu(), off[0], off[1], off[3], r, cell_cap=cap,
                                    run_end=off[4] if with_run_end else None)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    got = tg.knn_query_sorted(queries, *on[:4], r, 10, cell_cap=cap, run_end=on[4])
    want = tg.knn_query_sorted(queries.cpu(), *off[:4], r, 10, cell_cap=cap, run_end=off[4])
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    grid, occ = tg.grid_build_cap(refs, r)
    assert occ.device == refs.device and int(occ) + 4 <= cap


@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_d2_equals_the_nn_kernel(cuda, dtype):
    """Within the radius the grid's d2 is the 1-NN kernel's bit for bit (the
    same elementwise order), so the grid gate's mask is the brute gate's."""
    from simpleicp_tpu_torch.ops import gridhash as tg
    from simpleicp_tpu_torch.ops import knn

    refs, queries = _grid_clouds(dtype, cuda, seed=32)
    r = 0.3
    cap = tg.grid_cell_cap(refs.cpu().numpy(), r)
    d2, idx = tg.nn_within_radius_grid(queries, refs, r, cell_cap=cap)
    kd, ki = knn.nn_search(queries, refs)
    torch.cuda.synchronize()
    rr = torch.tensor(r, dtype=dtype, device=cuda)
    inside = kd <= rr * rr
    assert torch.equal(d2 <= rr * rr, inside) and 0 < int(inside.sum()) < len(queries)
    assert torch.equal(d2[inside], kd[inside]) and torch.equal(idx[inside], ki[inside])


@pytest.mark.parametrize("engine", ["grid_matcher", "grid_gate"])
def test_grid_engines_icp_register_on_the_card(cuda, engine):
    """A grid-matched or grid-gated registration on the card: float64 equal
    to the CPU in iterations, selection and last matches, H within 1e-9; the
    grid matcher launches no match kernel, the grid gate no 1-NN; a tensor
    cloud's cell cap is one host read."""
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models.icp import _icp_register
    from simpleicp_tpu_torch.ops import knn_cuda
    from simpleicp_tpu_torch.utils import sync

    rng = np.random.default_rng(13)

    def surface(n, lo, hi):
        xy = np.column_stack([rng.uniform(lo, hi, n), rng.uniform(-2, 2, n)])
        return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])

    X_fix, X_mov = surface(20000, -2, 2), surface(20000, -1, 3) + [0.02, -0.01, 0.01]
    kw = (dict(match_method="grid", match_radius=0.1) if engine == "grid_matcher"
          else dict(max_overlap_distance=0.1, gate_method="grid"))
    cfg = IcpConfig(correspondences=2000, max_iterations=30, **kw)

    def run(device, X):
        return _icp_register(
            X_fix, X, cfg, rbp_observed_values=None, rbp_observation_weights=None,
            normals_fix=None, planarity_fix=None, planarity_mov=None, fixed_prep=None,
            device=device, dtype=torch.float64)

    knn_cuda.reset_launch_counts()
    g, gc = run(cuda, X_mov)
    n_it = int(g.n_iterations)
    want = {"match_transform": 0 if engine == "grid_matcher" else n_it, "knn_search": 1,
            "nn_search": 0, "nn_search_d2": 0}
    assert knn_cuda.LAUNCHES == want
    c, cc = run("cpu", X_mov)
    assert n_it == int(c.n_iterations) and int(g.error_code) == int(c.error_code) == 0
    assert torch.equal(g.sel_idx.cpu(), c.sel_idx)
    assert torch.equal(gc.m_idx.cpu(), cc.m_idx)
    assert float((g.H.cpu() - c.H).abs().max()) <= 1e-9
    sync.reset_host_reads()
    run(cuda, X_mov)
    from_numpy = sync.host_reads()
    sync.reset_host_reads()
    t = run(cuda, torch.as_tensor(X_mov, device=cuda))[0]
    assert sync.host_reads() == from_numpy + 1
    assert torch.equal(t.H, g.H)


@pytest.mark.parametrize("case", ["K=1", "K=3", "gated K=2", "grid K=2"])
def test_chunked_equals_monolithic_on_the_card(cuda, case):
    """Chunked dispatch on the card, float32, at 20k: every result field and
    the last matches equal to the monolithic run's, with the same kernel
    launches and host reads."""
    import dataclasses

    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models.icp import _icp_register
    from simpleicp_tpu_torch.ops import knn_cuda
    from simpleicp_tpu_torch.utils import sync

    rng = np.random.default_rng(17)

    def surface(n, lo, hi):
        xy = np.column_stack([rng.uniform(lo, hi, n), rng.uniform(-2, 2, n)])
        return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])

    X_fix, X_mov = surface(20000, -2, 2), surface(20000, -1, 3) + [0.02, -0.01, 0.01]
    kw = {"gated K=2": dict(max_overlap_distance=0.1),
          "grid K=2": dict(match_method="grid", match_radius=0.1)}.get(case, {})
    cfg = IcpConfig(correspondences=2000, **kw)
    k = int(case[-1])

    def run(c):
        knn_cuda.reset_launch_counts()
        sync.reset_host_reads()
        out = _icp_register(
            X_fix, X_mov, c, rbp_observed_values=None, rbp_observation_weights=None,
            normals_fix=None, planarity_fix=None, planarity_mov=None, fixed_prep=None,
            device=cuda, dtype=torch.float32)
        return out, dict(knn_cuda.LAUNCHES), sync.host_reads()

    (mono, mono_c), mono_l, mono_r = run(cfg)
    (res, res_c), res_l, res_r = run(dataclasses.replace(cfg, dispatch="chunked",
                                                         chunk_iterations=k))
    assert int(mono.error_code) == 0 and int(mono.n_iterations) > k
    for f in mono._fields:
        assert torch.equal(getattr(res, f), getattr(mono, f)), f
    assert torch.equal(res_c.m_idx, mono_c.m_idx)
    assert res_l == mono_l and res_r == mono_r


def _cascade_case(kind, C, rng):
    """(Xf, query indices) forcing one branch of the grid k-NN cascade at C
    queries (the constructions of tests/test_torch_chunked.py, with the
    sample's stride C // 1024): sparse queries the radius sample skips (a
    dense patch), or sees (a round-2 regrid)."""
    stride = C // 1024
    n_side = 224 if kind == "dense_patch" else 180
    g = np.stack(np.meshgrid(np.arange(n_side), np.arange(n_side)), -1).reshape(-1, 2)
    dense = np.column_stack([g * 0.01, 0.001 * np.sin(g.sum(1))])
    q_idx = np.linspace(0, dense.shape[0] - 1, C).astype(int)
    if kind == "dense_patch":
        sparse = rng.uniform(50.0, 60.0, size=(40, 3))
        for j in range(sparse.shape[0]):
            q_idx[stride * j + 1] = dense.shape[0] + j
    else:
        gs = np.stack(np.meshgrid(np.arange(40), np.arange(40)), -1).reshape(-1, 2)
        sparse = np.column_stack([gs * 0.12 + 10.0, 0.01 * np.cos(gs.sum(1))])
        for j in range(400):
            q_idx[2 * stride * j + stride] = dense.shape[0] + (j % sparse.shape[0])
    return np.vstack([dense, sparse]), q_idx


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["regrid", "dense_patch"])
def test_knn_grid_normals_on_the_card(cuda, kind, dtype, monkeypatch, caplog):
    """The grid k-NN cascade on the card at C=8192, its k-NN rates lowered
    so that the grid plan is economical on these small clouds, with a
    forced round-2 regrid or a forced dense patch: the normals and
    planarity bit-equal to the dense k-NN's on the card."""
    import logging

    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models import icp
    from simpleicp_tpu_torch.utils import device_policy

    monkeypatch.setattr(device_policy, "GPU_KNN10_PAIRS_PER_SEC", 1e7)
    monkeypatch.setattr(device_policy, "GPU_GATHER_ELEMS_PER_SEC", 1e8)
    monkeypatch.setattr(device_policy, "GPU_SORT_ELEMS_PER_SEC", 2.5e7)
    C = 8192
    X, q_idx = _cascade_case(kind, C, np.random.default_rng(19))
    Xf = torch.as_tensor(X, dtype=dtype, device=cuda)
    Q = Xf[torch.as_tensor(q_idx, device=cuda)]
    cfg = IcpConfig(correspondences=C)
    with caplog.at_level(logging.INFO, "simpleicp_tpu_torch.models.icp"):
        normals, planarity = icp._knn_grid_normals(Q, Xf, cfg, 2048)
    lines = [r.getMessage() for r in caplog.records]
    assert normals is not None, "grid plan unexpectedly uneconomical"
    assert any(("regrid" if kind == "regrid" else "dense recompute") in m for m in lines), lines
    dn, dp = icp._dense_knn_rows(Q, Xf, cfg)
    assert torch.equal(normals, dn) and torch.equal(planarity, dp)


@pytest.mark.parametrize("case", ["ungated", "gated ring", "gated allgather", "grid"])
def test_sharded_world_one_on_the_card(cuda, case):
    """The sharded registration as a world of one over NCCL (in this
    process), float32 at 20k: every result field and the last matches equal
    to icp_register's on the card, with the match kernel launched once an
    iteration and the k-NN once."""
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.models.icp import _icp_register
    from simpleicp_tpu_torch.ops import knn_cuda
    from simpleicp_tpu_torch.parallel import launch, make_mesh
    from simpleicp_tpu_torch.parallel.sharded import _icp_register_sharded

    rng = np.random.default_rng(19)

    def surface(n, lo, hi):
        xy = np.column_stack([rng.uniform(lo, hi, n), rng.uniform(-2, 2, n)])
        return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])

    X_fix, X_mov = surface(20000, -2, 2), surface(20000, -1, 3) + [0.02, -0.01, 0.01]
    kw = {"gated ring": dict(max_overlap_distance=0.1),
          "gated allgather": dict(max_overlap_distance=0.1, gate_collective="allgather"),
          "grid": dict(max_overlap_distance=0.1, gate_method="grid", match_method="grid")
          }.get(case, {})
    cfg = IcpConfig(correspondences=2000, **kw)
    args = dict(rbp_observed_values=None, rbp_observation_weights=None, normals_fix=None,
                planarity_fix=None, planarity_mov=None, fixed_prep=None, device=cuda,
                dtype=torch.float32)
    ref, ref_c = _icp_register(X_fix, X_mov, cfg, **args)

    def sharded():
        mesh = make_mesh()
        assert mesh.backend == "nccl"
        knn_cuda.reset_launch_counts()
        out = _icp_register_sharded(X_fix, X_mov, cfg, mesh=mesh, **args)
        return out, dict(knn_cuda.LAUNCHES)

    (res, res_c), launches = launch.run(1, sharded)[0]
    assert int(res.error_code) == 0
    for f in ref._fields:
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    assert torch.equal(res_c.m_idx, ref_c.m_idx)
    assert launches["knn_search"] == 1
    assert launches["match_transform"] == (0 if case == "grid" else int(res.n_iterations))


def test_profiling_trace_names_the_kernels(cuda, tmp_path):
    """utils.profiling.trace around a registration on the card writes a
    Chrome trace whose device events name the match and the k-NN kernels
    (their symbols in csrc/knn.cu)."""
    import json

    from simpleicp_tpu_torch import IcpConfig, icp_register
    from simpleicp_tpu_torch.utils.profiling import trace

    rng = np.random.default_rng(12)
    xy = rng.uniform(-2, 2, (20000, 2))
    X = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])
    cfg = IcpConfig(correspondences=500, max_iterations=10)
    icp_register(X, X + [0.02, -0.01, 0.01], cfg)  # build and warm up outside the trace
    with trace(str(tmp_path)) as path:
        res = icp_register(X, X + [0.02, -0.01, 0.01], cfg)
        torch.cuda.synchronize()
    assert int(res.error_code) == 0
    names = {e.get("name", "") for e in json.loads(open(path).read())["traceEvents"]
             if e.get("cat") == "kernel"}
    for symbol in ("match_scan", "knn_scan"):
        assert any(symbol in n for n in names), (symbol, sorted(names)[:20])


def test_spans_are_host_operations_of_the_profile(cuda):
    """Under the profiler on the card the registration's spans are host
    operations that hold the runtime's launch calls, and no span has a
    device-side event: the device's events are the kernels, copies and
    fills alone. The iterations replay the graphs the warm-up captured (a
    key's first registration runs eagerly, its second captures), so they
    hold no stage span of their own."""
    from torch.profiler import ProfilerActivity, profile

    from simpleicp_tpu_torch import IcpConfig, icp_register
    from simpleicp_tpu_torch.utils.profiling import SPANS

    rng = np.random.default_rng(13)
    xy = rng.uniform(-2, 2, (20000, 2))
    X = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])
    cfg = IcpConfig(correspondences=500, max_iterations=10, max_overlap_distance=0.5)
    for _ in range(2):  # build and warm up outside the profile
        icp_register(X, X + [0.02, -0.01, 0.01], cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = icp_register(X, X + [0.02, -0.01, 0.01], cfg)
        torch.cuda.synchronize()
    assert int(res.error_code) == 0
    events = list(prof.events())
    on_card = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert on_card and not [n for n in on_card if n.startswith("icp.")]
    spans = [e for e in events if e.name in SPANS]
    assert {e.name for e in spans} >= {"icp.register", "icp.gate", "icp.iteration",
                                        "icp.host_read"}
    assert not {e.name for e in spans} & {"icp.match", "icp.reject", "icp.solve",
                                          "icp.converge"}
    (reg,) = [e for e in spans if e.name == "icp.register"]
    launches = [e for e in events if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                                "cuLaunchKernel")]
    inside = [e for e in launches if reg.time_range.start <= e.time_range.start
              <= reg.time_range.end]
    assert launches and len(inside) == len(launches)


# ------------------------------------------------------ Gauss-Newton kernel

GN_TOL = 64 * torch.finfo(torch.float64).eps


def _gn_surface(rng, B, C, motion):
    """(xm, xf, n) of B problems of C correspondences: a wavy surface with
    its analytic normals, the movable side moved back by each problem's
    rigid motion (B, 6) and noisy."""
    from simpleicp_tpu_torch.ops.transform import rbp_to_H

    xy = rng.uniform(-2, 2, (B, C, 2))
    z = 0.3 * np.sin(2 * xy[..., 0]) + 0.2 * np.cos(3 * xy[..., 1])
    xf = np.concatenate([xy, z[..., None]], axis=-1)
    g = np.stack([-0.6 * np.cos(2 * xy[..., 0]), 0.6 * np.sin(3 * xy[..., 1]),
                  np.ones((B, C))], axis=-1)
    n = g / np.linalg.norm(g, axis=-1, keepdims=True)
    H = rbp_to_H(torch.as_tensor(motion)).numpy()
    xm = np.einsum("bcj,bji->bci", xf - H[:, None, :3, 3], H[:, :3, :3])
    return xm + rng.normal(0, 1e-3, xm.shape), xf, n


def _gn_case(case, rng):
    """The arguments of gn_solve (numpy, float64) and n_steps, for one case:
    one problem without a pair axis; 32 problems with an active mask that
    stops some from the start (the others converge at their own steps);
    finite and frozen observation weights; a degenerate plane; a solve cut
    by n_steps; a mask of fewer than 6 rows."""
    B = {"one": 1, "batch32": 32, "observed": 4, "plane": 1, "n_steps": 2,
         "few_rows": 2}[case]
    C = 1000
    motion = rng.uniform([-0.03] * 3 + [-0.05] * 3, [0.03] * 3 + [0.05] * 3, (B, 6))
    if case == "n_steps":
        motion *= 8.0
    xm, xf, n = _gn_surface(rng, B, C, motion)
    mask = rng.random((B, C)) > 0.05
    p0 = np.zeros((B, 6))
    obs, w = np.zeros((B, 6)), np.zeros((B, 6))
    dw = rng.uniform(0.5, 2.0, B)
    # the plain loop reads one flag a step: with more than one problem it
    # needs the active mask
    active = None if B == 1 else np.ones(B, dtype=bool)
    steps = 24
    if case == "batch32":
        active = rng.random(B) > 0.25
        p0[::3] = motion[::3]  # these start at their motion and stop early
    if case == "observed":
        obs = motion + rng.normal(0, 0.01, (B, 6))
        w[:, [0, 3]] = 50.0
        w[1:, [2, 5]] = np.inf
        w[3] = np.inf
    if case == "plane":
        # a plane z = 0 sampled on a dyadic grid, the movable copy lifted
        # by 0.25: every product and sum of the solve is exact, the
        # in-plane motions (alpha3, tx, ty) leave exactly zero columns in
        # N, and only the damping keeps the Cholesky off 0 / 0
        g = (np.arange(32) - 15.5) / 8.0  # symmetric: sums of x, y and xy are 0
        xf = np.stack(np.meshgrid(g, g, [0.0], indexing="ij"), -1).reshape(1, -1, 3)
        C = xf.shape[1]
        xm = xf + [0.0, 0.0, 0.25]
        n = np.broadcast_to([0.0, 0.0, 1.0], xf.shape).copy()
        mask = np.ones((1, C), dtype=bool)
        dw = np.ones(1)
    if case == "n_steps":
        steps = 2
    if case == "few_rows":
        mask[:] = False
        mask[:, [3, 100, 500, 900]] = True  # 4 rows, two parameters frozen
        w[:, [3, 4]] = np.inf
    if case == "one":
        args = [a[0] for a in (p0, xm, xf, n, mask, dw, obs, w)]
    else:
        args = [p0, xm, xf, n, mask, dw, obs, w]
    return args, active, steps


def _gn_tensors(args, active, dtype, dev):
    out = [torch.as_tensor(np.asarray(a), device=dev,
                           dtype=torch.bool if a.dtype == bool else dtype).contiguous()
           for a in args]
    return out, None if active is None else torch.as_tensor(active, device=dev)


GN_CASES = ["one", "batch32", "observed", "plane", "n_steps", "few_rows"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", GN_CASES)
def test_gn_solve_kernel(cuda, dtype, case):
    """The solve kernel against the plain gn_solve on the card, one launch:
    p and the residuals within 1e-12 of (1 + their largest magnitude) in
    float64 (the kernel sums the normal equations in another order; within
    one float32 rounding in float32, where both round the same float64
    numbers), rel at or below 64 eps wherever the plain version converged,
    +inf for a problem that is not active, and near the plain version's
    where n_steps cut the solve."""
    from simpleicp_tpu_torch.models import solver
    from simpleicp_tpu_torch.ops import solver_cuda

    args, active, steps = _gn_case(case, np.random.default_rng(41))
    t, act = _gn_tensors(args, active, dtype, cuda)
    solver_cuda.reset_launch_counts()
    p, r, rel = solver.gn_solve(*t, n_steps=steps, active=act)
    assert solver_cuda.LAUNCHES == {"gn_solve": 1, "uncertainties": 0}
    pp, rp, relp = solver.gn_solve_plain(*t, n_steps=steps, active=act)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 2.0**-23
    for got, want in ((p, pp), (r, rp)):
        assert got.shape == want.shape and got.dtype == want.dtype
        err = float((got - want).abs().max())
        assert err <= tol * (1.0 + float(want.abs().max())), (case, err)
    rel, relp = rel.double().cpu(), relp.double().cpu()
    done = relp <= GN_TOL
    assert bool((rel[done] <= GN_TOL).all())
    if act is not None:
        assert bool(torch.isinf(rel[~act.cpu()]).all())
        assert torch.equal(p[~act], pp[~act])
    if case == "n_steps":
        assert bool((relp > GN_TOL).all())
        torch.testing.assert_close(rel, relp, rtol=1e-6, atol=0)
    if case == "observed":
        frozen = torch.isinf(t[7])
        assert torch.equal(p[frozen], t[6][frozen])
    if case == "plane":
        want = torch.tensor([[0.0, 0, 0, 0, 0, -0.25]], dtype=dtype)
        assert float((p.cpu() - want).abs().max()) <= 1e-15


@pytest.mark.parametrize("dtype", DTYPES)
def test_gn_solve_kernel_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same bits (a fixed
    reduction order, no atomics): sharded ranks solve alike."""
    from simpleicp_tpu_torch.models import solver

    args, active, steps = _gn_case("batch32", np.random.default_rng(42))
    t, act = _gn_tensors(args, active, dtype, cuda)
    a = solver.gn_solve(*t, n_steps=steps, active=act)
    b = solver.gn_solve(*t, n_steps=steps, active=act)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------------------------------------------------ uncertainty kernel

F64_EPS = torch.finfo(torch.float64).eps


def _uncertainty_case(B, C, obs, rng):
    """estimate_uncertainties' arguments (numpy, float64) for B problems of
    C correspondences at a final p near each problem's motion: 5 % of the
    rows rejected (none at C = 6, where every row is needed), and with 32
    problems one whose rows are all rejected; observations none, weighted
    (alpha1 and tx at weight 50) or alpha3 frozen at its value."""
    motion = rng.uniform([-0.03] * 3 + [-0.05] * 3, [0.03] * 3 + [0.05] * 3, (B, 6))
    xm, xf, n = _gn_surface(rng, B, C, motion)
    p = motion + rng.normal(0, 1e-4, (B, 6))
    mask = rng.random((B, C)) > 0.05 if C > 6 else np.ones((B, C), dtype=bool)
    if B == 32:
        mask[1] = False
    dw = rng.uniform(0.5, 2.0, B)
    vals, w = np.zeros((B, 6)), np.zeros((B, 6))
    if obs == "weighted":
        vals = motion + rng.normal(0, 0.01, (B, 6))
        w[:, [0, 3]] = 50.0
    if obs == "frozen":
        vals[:, 2] = p[:, 2]
        w[:, 2] = np.inf
    return [p, xm, xf, n, mask, dw, vals, w]


def _condition(args):
    """The condition number of each problem's damped, reduced N, as the
    plain version builds it (numpy, float64)."""
    import numpy.linalg as la

    from simpleicp_tpu_torch.models import solver

    p, xm, _, n, mask, dw, _, w = (torch.as_tensor(a) for a in args)
    J = solver.residual_jacobian(p, xm, n)
    N = J.mT @ (J * torch.where(mask, dw[:, None], 0.0)[..., None])
    vary = torch.isfinite(w)
    N = N + torch.diag_embed(torch.where(vary & (w > 0), w, 0.0))
    vf = vary.double()
    N = solver._damp(N * vf[:, :, None] * vf[:, None, :] + torch.diag_embed(1.0 - vf))
    return la.cond(N.numpy())


def _ulp32(x):
    x = x.abs().float()
    return (torch.nextafter(x, torch.full_like(x, float("inf"))) - x).double()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("C", [6, 129, 1000])
@pytest.mark.parametrize("obs", ["none", "weighted", "frozen"])
def test_uncertainty_kernel(cuda, dtype, B, C, obs):
    """The uncertainty kernel against the plain estimate_uncertainties on
    the same card tensors, one launch. NaN at the same places and frozen
    rows and columns of Cxx zero in both. The kernel sums J^T P J and vPv in
    another order, and an inverse amplifies that by the condition number of
    N: in float64, sigma within 16 eps cond(N) of the plain one's and Cxx
    within 16 eps cond(N) of its largest entry (1e-12 at cond(N) <= 280;
    C = 6 rows give cond(N) up to ~1e6); in float32 within that plus one
    float32 ulp, both rounding float64 numbers. A problem with no valid row
    gives the plain version's bits."""
    from simpleicp_tpu_torch.models import solver
    from simpleicp_tpu_torch.ops import solver_cuda

    args = _uncertainty_case(B, C, obs, np.random.default_rng(43 + C))
    t, _ = _gn_tensors(args, None, dtype, cuda)
    solver_cuda.reset_launch_counts()
    sig, cxx = solver.estimate_uncertainties(*t)
    assert solver_cuda.LAUNCHES == {"gn_solve": 0, "uncertainties": 1}
    sig_p, cxx_p = solver.estimate_uncertainties_plain(*t)
    torch.cuda.synchronize()
    for got, want in ((sig, sig_p), (cxx, cxx_p)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(torch.isnan(got), torch.isnan(want))
    frozen = ~torch.isfinite(t[7])
    assert bool(torch.isnan(sig[frozen]).all())
    for c in (cxx, cxx_p):
        assert bool((c.transpose(-1, -2)[frozen] == 0).all() and (c[frozen] == 0).all())

    sig, cxx, sig_p, cxx_p = (a.cpu().double() for a in (sig, cxx, sig_p, cxx_p))
    solved = torch.ones(B, dtype=torch.bool)
    if B == 32:  # no valid row: the same arithmetic on zeros
        solved[1] = False
        assert torch.equal(sig[1].nan_to_num(), sig_p[1].nan_to_num())
        assert torch.equal(cxx[1].nan_to_num(), cxx_p[1].nan_to_num())
    tol = 16 * F64_EPS * torch.as_tensor(_condition(args))[solved]
    sig, cxx, sig_p, cxx_p = (a[solved] for a in (sig, cxx, sig_p, cxx_p))
    vary = ~frozen.cpu()[solved]
    assert bool(torch.isfinite(sig_p[vary]).all() and torch.isfinite(cxx_p).all())
    err_s = (sig - sig_p).abs().nan_to_num()
    err_c = (cxx - cxx_p).abs().flatten(1).amax(1)
    lim_s = tol[:, None] * sig_p.abs().nan_to_num()
    lim_c = tol * cxx_p.abs().flatten(1).amax(1)
    if dtype == torch.float32:
        lim_s = lim_s + _ulp32(sig_p.nan_to_num())
        err_c = ((cxx - cxx_p).abs() - _ulp32(cxx_p)).flatten(1).amax(1)
    assert bool((err_s <= lim_s).all()), (err_s / lim_s.clamp_min(1e-300)).max()
    assert bool((err_c <= lim_c).all()), (err_c / lim_c).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_uncertainty_kernel_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same bits (the solve
    kernel's fixed reduction order): sharded ranks finish alike."""
    from simpleicp_tpu_torch.models import solver

    args = _uncertainty_case(32, 1000, "weighted", np.random.default_rng(44))
    t, _ = _gn_tensors(args, None, dtype, cuda)
    a = solver.estimate_uncertainties(*t)
    b = solver.estimate_uncertainties(*t)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())
        assert torch.equal(torch.isnan(x), torch.isnan(y))
