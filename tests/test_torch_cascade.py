"""The grid k-NN normals cascade of chunked dispatch
(``models/icp.py`` ``_knn_cascade_radius``, ``_knn_grid_normals``) on the
CPU against the JAX package's, in its three forced branches, built as in
tests/test_chunked.py: every row certified in round 1, a round-2 regrid,
and a dense patch. Both packages' rates are set equal, with the k-NN's
lowered so that the grid plan is economical on these small clouds.
Tolerances: the port's normals bit-equal to its own dense k-NN normals and
within 1e-10 of the JAX package's; the same branch log lines; the same
k-NN neighbours.
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu_torch import IcpConfig
from simpleicp_tpu_torch.models import icp
from simpleicp_tpu_torch.utils import device_policy

_LOG = "simpleicp_tpu_torch.models.icp"


def test_knn_cascade_radius_equals_jax():
    from simpleicp_tpu.models.icp import _knn_cascade_radius as jax_radius

    rng = np.random.default_rng(911)
    samples = {
        "tight": np.full(1024, 0.01),
        "heavy_tail": np.concatenate([np.full(1000, 0.01), np.full(24, 25.0)]),
        "random": rng.gamma(2.0, 1e-4, 1024),
        "random_f32": rng.lognormal(-9.0, 1.0, 1024).astype(np.float32),
    }
    for name, d2 in samples.items():
        r_hi = 1.25 * float(np.sqrt(d2.max()))
        assert icp._knn_cascade_radius(d2, r_hi) == jax_radius(d2, r_hi), name
    tail = samples["heavy_tail"]
    r_hi = 1.25 * float(np.sqrt(tail.max()))
    assert icp._knn_cascade_radius(tail, r_hi) < 0.2 * r_hi
    assert icp._knn_cascade_radius(samples["tight"], 0.125) == 0.125


def _cascade_cloud(kind, rng):
    """(Xf, query indices) of the three forced branches of the cascade, as
    in tests/test_chunked.py: a dense uniform slab alone, queried away from
    its edges (every row certified in round 1), with a sparse far patch
    whose queries the 1024-query radius sample skips (dense patch), and
    with a coarser lattice the sample sees (round-2 regrid)."""
    n_side = {"certified": 120, "dense_patch": 120, "regrid": 180}[kind]
    g = np.stack(np.meshgrid(np.arange(n_side), np.arange(n_side)), -1).reshape(-1, 2)
    dense = np.column_stack([g * 0.01, 0.001 * np.sin(g.sum(1))])
    C = 4096
    q_idx = np.linspace(0, dense.shape[0] - 1, C).astype(int)
    if kind == "certified":
        inner = np.flatnonzero(((g >= 4) & (g < n_side - 4)).all(axis=1))
        return dense, inner[np.linspace(0, inner.size - 1, C).astype(int)]
    if kind == "dense_patch":
        sparse = rng.uniform(50.0, 60.0, size=(40, 3))
        for j in range(sparse.shape[0]):
            q_idx[4 * j + 1] = dense.shape[0] + j
    else:
        gs = np.stack(np.meshgrid(np.arange(40), np.arange(40)), -1).reshape(-1, 2)
        sparse = np.column_stack([gs * 0.12 + 10.0, 0.01 * np.cos(gs.sum(1))])
        for j in range(400):
            q_idx[8 * j + 4] = dense.shape[0] + (j % sparse.shape[0])
    return np.vstack([dense, sparse]), q_idx


@pytest.mark.parametrize("kind", ["certified", "regrid", "dense_patch"])
def test_knn_grid_normals_branches(kind, monkeypatch, caplog):
    """The cascade's three branches, forced by construction with both
    packages' rates set equal and the k-NN's lowered (so that the grid plan
    is economical on a small cloud): the same branch log lines as the JAX
    package, the port's normals bit-equal to its dense k-NN normals and
    within 1e-10 of the JAX package's, and the same k-NN neighbours."""
    from simpleicp_tpu.models import icp as jax_icp
    from simpleicp_tpu.ops.knn import knn_search as jax_knn
    from simpleicp_tpu.utils import device_policy as jax_policy

    from simpleicp_tpu_torch.ops.knn import knn_search

    for mod, prefix in ((jax_policy, "TPU"), (device_policy, "GPU")):
        monkeypatch.setattr(mod, f"{prefix}_KNN10_PAIRS_PER_SEC", 1e7)
        monkeypatch.setattr(mod, f"{prefix}_GATHER_ELEMS_PER_SEC", 1e8)
        monkeypatch.setattr(mod, f"{prefix}_SORT_ELEMS_PER_SEC", 2.5e7)
    X, q_idx = _cascade_cloud(kind, np.random.default_rng(912))
    cfg_j, cfg_t = JaxConfig(correspondences=4096), IcpConfig(correspondences=4096)

    with caplog.at_level(logging.INFO, "simpleicp_tpu.models.icp"):
        Xj = jnp.asarray(X)
        nj, pj = jax_icp._knn_grid_normals(Xj[jnp.asarray(q_idx)], Xj, cfg_j, knn_block=2048)
    jax_lines = [r.getMessage() for r in caplog.records if r.name == "simpleicp_tpu.models.icp"]
    caplog.clear()
    Xt = torch.as_tensor(X)
    Q = Xt[torch.as_tensor(q_idx)]
    with caplog.at_level(logging.INFO, _LOG):
        nt, pt = icp._knn_grid_normals(Q, Xt, cfg_t, 2048)
    port_lines = [r.getMessage() for r in caplog.records if r.name == _LOG]

    assert nj is not None and nt is not None, "grid plan unexpectedly uneconomical"
    assert port_lines == jax_lines
    want = {"certified": (), "regrid": ("regrid",), "dense_patch": ("dense recompute",)}[kind]
    assert all(any(w in m for m in port_lines) for w in want), port_lines
    assert (not port_lines) == (kind == "certified"), port_lines
    if kind == "regrid":
        assert not any("dense recompute" in m for m in port_lines), port_lines
    dn, dp = icp._dense_knn_rows(Q, Xt, cfg_t)
    assert torch.equal(nt, dn) and torch.equal(pt, dp)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-10)
    # the same neighbours as the JAX package's k-NN; their order within a
    # row may differ on the lattice's near-ties, where XLA's fused
    # multiply-adds round d2 otherwise
    _, it = knn_search(Q, Xt, 10)
    _, ij = jax_knn(Xj[jnp.asarray(q_idx)], Xj, 10)
    np.testing.assert_array_equal(np.sort(it.numpy(), 1), np.sort(np.asarray(ij), 1))


def test_knn_grid_normals_declines_small_or_uneconomical():
    X, q_idx = _cascade_cloud("certified", np.random.default_rng(913))
    Xt = torch.as_tensor(X)
    Q = Xt[torch.as_tensor(q_idx)]
    assert icp._knn_grid_normals(Q[:4095], Xt, IcpConfig(correspondences=4095), 0) == (None, None)
    # at the card's rates a 14 400-point cloud is cheaper as a dense k-NN
    assert icp._knn_grid_normals(Q, Xt, IcpConfig(correspondences=4096), 0) == (None, None)
