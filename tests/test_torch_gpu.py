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
    _equal(knn.nn_search_auto(q, r, ref_mask=mask),
           knn.nn_search_plain(q, r, ref_mask=mask))


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


def test_gated_icp_register_on_the_card(cuda):
    """The gated path on the card: one 1-NN launch (the gate), one k-NN
    launch, one match launch per iteration; float64 on the card equal to
    float64 on the CPU in iterations, selection and last matches, H within
    1e-9."""
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
                                 "knn_search": 1, "nn_search": 1}
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
    from simpleicp_tpu_torch.ops import knn_cuda

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
    g, gc = run(cuda)
    assert knn_cuda.LAUNCHES == {"match_transform": int(g.n_iterations), "knn_search": 1,
                                 "nn_search": 0}
    c, cc = run("cpu")
    assert int(g.n_iterations) == int(c.n_iterations)
    assert torch.equal(g.sel_idx.cpu(), c.sel_idx)
    assert torch.equal(gc.m_idx.cpu(), cc.m_idx)
    assert float((g.H.cpu() - c.H).abs().max()) <= 1e-9


def test_wrappers_check_their_inputs(cuda):
    from simpleicp_tpu_torch.ops import knn_cuda

    q = torch.zeros((4, 3), device=cuda)
    with pytest.raises(TypeError):
        knn_cuda.knn_search_cuda(q, q.double(), 2)
    with pytest.raises(ValueError):
        knn_cuda.knn_search_cuda(q, torch.zeros((4, 6), device=cuda)[:, ::2], 2)
    with pytest.raises(ValueError):
        knn_cuda.knn_search_cuda(q, q, 65)
    with pytest.raises(ValueError):
        knn_cuda.match_transform_cuda(q, q, torch.eye(3, device=cuda))
    with pytest.raises(ValueError):
        knn_cuda.nn_search_cuda(q, q, torch.ones(5, dtype=torch.bool, device=cuda))
    with pytest.raises(TypeError):
        knn_cuda.nn_search_cuda(q, q, torch.ones(4, device=cuda))
