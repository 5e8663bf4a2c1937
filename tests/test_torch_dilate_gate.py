"""The dilate gate of the PyTorch port (CPU, plain versions) on every
geometry of tests/test_dilate_gate.py: its mask against the port's brute
gate, and against the JAX package's ``overlap_mask_dilate``.

Tolerances. Against the port's brute gate (``min_dist_sq(Xf, Xm0) <= r²``
on the same transformed cloud ``Xm0 = apply_H(Xm, H0)``): none, bit for
bit. Against the JAX package: equal except at points whose nearest
distance lies within a few ulp of r, because the two packages' d2 (and,
under an initial transform, their transformed clouds) differ in the last
bits (XLA contracts into fused multiply-adds); such points are counted and
allowed, and none occurs on these inputs unless the test says so. The
bunny fixture of the JAX tests is replaced by a synthetic surface.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu.ops import dilate_gate as J
from simpleicp_tpu_torch.ops import dilate_gate as T
from simpleicp_tpu_torch.ops.knn import min_dist_sq
from simpleicp_tpu_torch.ops.transform import apply_H


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and torch's spinning thread pools in each slow the
    others down far more than one thread costs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gate(Xf, Xm, r, H0=None, cell_div=None):
    """(port dilate mask, port brute mask, port d2, JAX dilate mask, stats)."""
    H0 = np.eye(4) if H0 is None else H0
    Xft = torch.from_numpy(Xf)
    Xm0 = apply_H(torch.from_numpy(Xm), torch.from_numpy(H0))
    lo, hi = T.bbox_of(Xm0).numpy()
    plan = T.plan_dilate_gate(None, None, r, cell_div=cell_div, bbox=(lo, hi))
    assert plan is not None
    stats = {}
    mask = T.overlap_mask_dilate(Xft, Xm0, r, plan, stats=stats)
    d2 = min_dist_sq(Xft, Xm0)
    brute = d2 <= torch.tensor(r, dtype=Xft.dtype) ** 2
    jplan = J.plan_dilate_gate(Xf, Xm @ H0[:3, :3].T + H0[:3, 3], r, cell_div=cell_div)
    jmask = J.overlap_mask_dilate(jnp.asarray(Xf), jnp.asarray(Xm), jnp.asarray(H0),
                                  r, jplan)
    return mask.numpy(), brute.numpy(), d2.numpy(), np.asarray(jmask), stats


def _check(Xf, Xm, r, H0=None, cell_div=None, boundary_allowed=0):
    mask, brute, d2, jmask, stats = _gate(Xf, Xm, r, H0, cell_div)
    np.testing.assert_array_equal(mask, brute)
    diff = np.nonzero(mask != jmask)[0]
    # every point where the packages differ sits within a few ulp of r
    assert np.all(np.abs(d2[diff] - r * r) <= 1e-12 * r * r), d2[diff]
    assert diff.size <= boundary_allowed, diff.size
    return mask, stats


def _transform(a, axis, t):
    c, s = np.cos(a), np.sin(a)
    R = {"z": [[c, -s, 0], [s, c, 0], [0, 0, 1.0]],
         "y": [[c, 0, s], [0, 1.0, 0], [-s, 0, c]]}[axis]
    H0 = np.eye(4)
    H0[:3, :3] = R
    H0[:3, 3] = t
    return H0


# r = 0.05 pins cell_div 8: at the planner's 16 its grid has 10M words and
# the plain dilations take over half a minute on one CPU thread (r = 0.13
# runs the planner's cell_div 16).
@pytest.mark.parametrize("r,cell_div", [(0.05, 8), (0.13, None), (0.5, None)])
def test_random_clouds(r, cell_div):
    rng = np.random.default_rng(101)
    Xf = rng.uniform(-1, 1, size=(4000, 3))
    Xm = rng.uniform(-1, 1, size=(3000, 3)) + np.array([0.4, 0.0, 0.0])
    _, stats = _check(Xf, Xm, r, cell_div=cell_div)
    assert stats["band"] > 0 and stats["sweep"] == "direct"


@pytest.mark.parametrize("cell_div", [8, 4, 2])
def test_coarse_lattices(cell_div):
    rng = np.random.default_rng(102)
    Xf = rng.uniform(-1, 1, size=(4000, 3))
    Xm = rng.uniform(-1, 1, size=(3000, 3)) + np.array([0.4, 0.0, 0.0])
    _check(Xf, Xm, 0.13, cell_div=cell_div)


def test_boundary_distances():
    """Queries at r - 1e-9 and r + 1e-6 from one ref each."""
    r = 0.25
    g = np.arange(5) * 2.0
    Xm = np.stack(np.meshgrid(g, g, g), axis=-1).reshape(-1, 3)
    Xf = np.concatenate([Xm[:50] + [r - 1e-9, 0, 0], Xm[50:100] + [r + 1e-6, 0, 0]])
    mask, _ = _check(Xf, Xm, r)
    assert mask[:50].all() and not mask[50:].any()


def test_grid_aligned_points():
    rng = np.random.default_rng(103)
    Xm = np.round(rng.uniform(-1, 1, size=(2000, 3)) * 10) / 10
    Xf = np.round(rng.uniform(-1, 1, size=(2000, 3)) * 10) / 10
    _check(Xf, Xm, 0.2)


def test_planar_degenerate():
    rng = np.random.default_rng(104)
    xy = rng.uniform(-1, 1, size=(1500, 2))
    Xf = np.column_stack([xy, np.zeros(1500)])
    Xm = np.column_stack([xy[:1000] + 0.03, np.full(1000, 0.05)])
    _check(Xf, Xm, 0.1)


def test_disjoint_and_coincident_clouds():
    rng = np.random.default_rng(105)
    Xf = rng.uniform(0, 1, size=(500, 3))
    mask, stats = _check(Xf, rng.uniform(5, 6, size=(500, 3)), 0.1)
    assert not mask.any() and stats["band"] == 0
    mask, _ = _check(Xf, Xf.copy(), 0.1)
    assert mask.all()


def test_initial_transform():
    rng = np.random.default_rng(106)
    Xf = rng.uniform(-1, 1, size=(1000, 3))
    Xm = rng.uniform(-1, 1, size=(1000, 3))
    _check(Xf, Xm, 0.15, H0=_transform(0.3, "z", [0.2, -0.1, 0.05]))
    _check(Xf, Xm, 0.15, H0=_transform(0.21, "y", [0.11, 0.02, -0.3]))


def test_far_queries_clamp_to_rejection():
    rng = np.random.default_rng(107)
    Xm = rng.uniform(0, 1, size=(2000, 3))
    near = rng.uniform(-0.3, 1.3, size=(1500, 3))
    far = rng.uniform(50, 80, size=(500, 3)) * rng.choice([-1, 1], size=(500, 3))
    mask, _ = _check(np.concatenate([near, far]), Xm, 0.2)
    assert mask[:1500].any() and not mask[1500:].any()


def test_band_is_thin_for_dense_surfaces():
    """A synthetic surface in place of the bunny: the band stays a small
    fraction of the fixed points."""
    rng = np.random.default_rng(108)
    xy = rng.uniform(-2, 2, size=(20000, 2))
    Xf = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0])])
    Xm = Xf + rng.normal(scale=0.01, size=Xf.shape)
    _, stats = _check(Xf, Xm, 0.5, cell_div=8)
    assert stats["band"] < 0.05 * len(Xf), stats


def _force(monkeypatch, **consts):
    for name, value in consts.items():
        monkeypatch.setattr(T, name, value)
        monkeypatch.setattr(J, name, value)


@pytest.mark.parametrize("with_transform", [False, True])
def test_band_ref_compaction(monkeypatch, with_transform):
    _force(monkeypatch, _DIRECT_SWEEP_MAX=0)
    rng = np.random.default_rng(109)
    Xf = rng.uniform(-1, 1, size=(4000, 3))
    Xm = rng.uniform(-1, 1, size=(3000, 3)) + np.array([0.4, 0.0, 0.0])
    H0 = _transform(0.2, "z", [0.1, -0.05, 0.02]) if with_transform else None
    _, stats = _check(Xf, Xm, 0.13, H0=H0)
    assert stats["compaction"] and 0 < stats["refs_kept"] < len(Xm)
    assert stats["sweep"] == "direct"


def test_slab_planner_edge_cases(monkeypatch):
    """_pick_slab_chunk_2d survives degenerate geometry as the JAX one does,
    and with the same rates and no per-launch cost it picks what the JAX
    planner picks."""
    rng = np.random.default_rng(115)
    qx = np.sort(rng.uniform(0, 100, 300_000))
    qy = rng.uniform(0, 30, 300_000)
    rx = np.sort(rng.uniform(0, 100, 250_000))
    ry = rng.uniform(0, 30, 250_000)
    cases = [(qx, qy, rx, ry), (qx, qy, rx, np.zeros_like(ry)),
             (qx, qy, rx + 1000.0, ry), (qx[:100], qy[:100], rx, ry)]
    for args in cases:
        assert T._pick_slab_chunk_2d(*args, 0.05) in T._SLAB_CHUNK_OPTS
    monkeypatch.setattr(T, "_SLAB_PAIRS_PER_SEC", J._SLAB_PAIRS_PER_SEC)
    monkeypatch.setattr(T, "_SLAB_WINDOW_SEC", J._SLAB_HOST_SORT_SEC)
    monkeypatch.setattr(T, "_SLAB_CALL_SEC", 0.0)
    monkeypatch.setattr(J, "_SLAB_CALL_SEC", 0.0)
    for args in cases:
        for reach in (0.05, 2.0):
            assert T._pick_slab_chunk_2d(*args, reach) == J._pick_slab_chunk_2d(*args, reach)
    for s0 in T._SLAB_CHUNK_OPTS:
        assert T._slab1_of(s0) == J._slab1_of(s0)
