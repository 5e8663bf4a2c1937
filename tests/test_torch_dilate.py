"""The dilate gate's building blocks in the PyTorch port (CPU, plain
versions) against the JAX package on the same seeded inputs: the plan, the
occupancy pack, the packed stencil dilation (lax ``_dilate_packed_multi``
and the Pallas kernel in interpret mode), the classify, and the JAX call
form of ``min_dist_sq``.

Tolerance: none. The plan is numpy on both sides and compares field for
field; packs, dilated grids and classify masks are integer results and
compare bit for bit (grids as uint32 words: the port holds them as int32
with the same bit pattern).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu.ops import dilate_gate as J
from simpleicp_tpu.ops.dilate_pallas import dilate_packed_multi_pallas
from simpleicp_tpu.ops.knn import min_dist_sq as jax_min_dist_sq
from simpleicp_tpu_torch.ops import dilate_cuda
from simpleicp_tpu_torch.ops import dilate_gate as T
from simpleicp_tpu_torch.ops.knn import min_dist_sq
from test_torch_dilate_gate import _one_torch_thread  # noqa: F401 (autouse fixture)


def _t(grid_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(grid_u32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _random_occ(rng, wz, nx, ny, density=0.02):
    words = rng.random((wz, nx, ny)) < density
    bits = rng.integers(0, 2**32, size=(wz, nx, ny), dtype=np.uint32)
    return np.where(words, bits, np.uint32(0))


def _assert_dilations_equal(occ_u32, stencils, pallas=True):
    """Port plain version == lax (== the Pallas kernel in interpret mode)."""
    got = [_u32(g) for g in T.dilate_packed_multi_plain(_t(occ_u32), stencils)]
    want = [np.asarray(w) for w in J._dilate_packed_multi(jnp.asarray(occ_u32), stencils)]
    assert len(got) == len(want) == len(stencils)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if pallas:
        pal = dilate_packed_multi_pallas(jnp.asarray(occ_u32), stencils, interpret=True)
        for g, p in zip(got, pal):
            np.testing.assert_array_equal(g, np.asarray(p))
    return got


# ------------------------------------------------------------------ plan


def _bboxes():
    rng = np.random.default_rng(31)
    clouds = [
        rng.uniform(-1, 1, (4000, 3)) + [0.4, 0.0, 0.0],          # test_dilate_gate
        rng.uniform(-1, 1, (2500, 3)) * [4.0, 1.0, 1.0],
        np.column_stack([rng.uniform(-1, 1, (1000, 2)), np.full(1000, 0.05)]),  # planar
        rng.uniform(50, 80, (500, 3)) * rng.choice([-1, 1], (500, 3)),
        rng.random((500, 3)) * [8.0, 6.0, 4.0],                    # test_dilate_pallas
    ]
    return [(c.min(axis=0), c.max(axis=0)) for c in clouds]


@pytest.mark.parametrize("cell_div", [None, 16, 8, 4, 2])
def test_plan_equals_jax(cell_div):
    for lo, hi in _bboxes():
        for r in (0.05, 0.13, 0.5, 1.0):
            want = J.plan_dilate_gate(None, None, r, cell_div=cell_div, bbox=(lo, hi))
            got = T.plan_dilate_gate(None, None, r, cell_div=cell_div, bbox=(lo, hi))
            assert (got is None) == (want is None), (lo, hi, r)
            if got is not None:
                assert got._fields == want._fields
                for f in got._fields:
                    assert getattr(got, f) == getattr(want, f), f


def test_plan_budgets_and_degenerate_boxes_give_none_as_jax():
    lo, hi = np.zeros(3), np.full(3, 10.0)
    for kw in (dict(max_words=1000), dict(max_shift_words=10**6),
               dict(cell_div=16, max_words=10**5), dict(cell_div=2, max_shift_words=1)):
        assert J.plan_dilate_gate(None, None, 0.1, bbox=(lo, hi), **kw) is None
        assert T.plan_dilate_gate(None, None, 0.1, bbox=(lo, hi), **kw) is None
    bad = (np.array([0.0, np.nan, 0.0]), hi)
    assert T.plan_dilate_gate(None, None, 0.1, bbox=bad) is None
    assert T.plan_dilate_gate(None, np.zeros((0, 3)), 0.1) is None
    with pytest.raises(ValueError, match="cell_div"):
        T.plan_dilate_gate(None, None, 0.1, cell_div=32, bbox=(lo, hi))
    # from points instead of a box
    pts = np.random.default_rng(2).uniform(-1, 1, (300, 3))
    assert T.plan_dilate_gate(None, pts, 0.2) == J.plan_dilate_gate(None, pts, 0.2)


# ------------------------------------------------------------------ pack


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_equals_jax(dtype):
    """Bit-equal to the JAX device pack and to the host pack, with exact
    duplicates, boundary-aligned points and H0 = I."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, size=(5000, 3)).astype(dtype)
    pts[1000:2000] = pts[:1000]
    pts[2000:3000] = np.round(pts[2000:3000] * 20) / 20
    for r in (0.1, 0.37):
        plan = T.plan_dilate_gate(None, pts, r)
        jplan = J.plan_dilate_gate(None, pts, r)
        got = _u32(T._pack_occupancy_device(torch.from_numpy(pts), plan=plan))
        np.testing.assert_array_equal(
            got, np.asarray(J._pack_occupancy_device(jnp.asarray(pts), plan=jplan)))
        np.testing.assert_array_equal(got, J.pack_occupancy(pts, jplan, dtype))
        assert got.any()


# ------------------------------------------------------------------ dilation


STENCIL_A = tuple(
    (dx, dy, 4 - max(abs(dx), abs(dy))) for dx in range(-2, 3) for dy in range(-2, 3)
)
STENCIL_B = ((0, 0, 3), (1, -1, 0), (-2, 0, 1))


@pytest.mark.parametrize("shape", [(2, 40, 48), (3, 17, 33), (1, 64, 130)])
def test_dilation_equals_lax_and_pallas(shape):
    """The shapes and synthetic stencils of tests/test_dilate_pallas.py
    (each stencil's (0, 0) column carries its largest z-radius, the lax
    version's precondition)."""
    occ = _random_occ(np.random.default_rng(7), *shape)
    _assert_dilations_equal(occ, [STENCIL_A, STENCIL_B])
    _assert_dilations_equal(occ, [STENCIL_B])


def test_dilation_real_plan_stencils_equal_lax_and_pallas():
    rng = np.random.default_rng(3)
    pts = rng.random((500, 3)) * np.array([8.0, 6.0, 4.0])
    plan = T.plan_dilate_gate(None, pts, 1.0, cell_div=4)
    occ = _u32(T._pack_occupancy_device(torch.from_numpy(pts), plan=plan))
    occ = occ.reshape(plan.wz, plan.dims[0], plan.dims[1])
    got = _assert_dilations_equal(occ, [plan.in_offsets, plan.poss_offsets])
    assert got[0].any() and got[1].any()
    _assert_dilations_equal(occ, [plan.poss_offsets], pallas=False)


def test_dilation_empty_stencil_lists():
    occ = _random_occ(np.random.default_rng(11), 2, 20, 20)
    for stencils in ([(), ()], [()], [], [(), STENCIL_B]):
        got = _assert_dilations_equal(occ, stencils, pallas=bool(stencils))
        assert all(not g[...].any() for g, st in zip(got, stencils) if not st)


def test_dilation_carries_across_words():
    """Bits 0 and 31 of the first and last words and of inner words: the
    z-shifts carry them into the neighbouring word and drop them past the
    grid's ends."""
    occ = np.zeros((3, 9, 10), np.uint32)
    occ[0, 0, 0] = 1 | (1 << 31)
    occ[2, 8, 9] = 1 | (1 << 31)
    occ[1, 4, 5] = 1 << 31
    occ[2, 4, 5] = 1
    occ[0, 8, 0] = 1 << 31
    for z in (1, 5, 17, 31):
        _assert_dilations_equal(occ, [((0, 0, z), (1, 0, 0), (0, -1, 0)),
                                      ((0, 0, z), (-1, 1, z // 2))], pallas=z < 31)
    full = np.full((2, 5, 6), 0xFFFFFFFF, np.uint32)
    _assert_dilations_equal(full, [STENCIL_A, STENCIL_B])


def test_dilation_refuses_z_radius_of_32():
    occ = torch.zeros((1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="z-radius"):
        T.dilate_packed_multi_plain(occ, [((0, 0, 32),)])


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    monkeypatch.setattr(dilate_cuda, "dilate_cuda", boom)
    occ = _t(_random_occ(np.random.default_rng(1), 2, 8, 9))
    got = T.dilate_packed_multi(occ, [STENCIL_A, STENCIL_B])
    want = T.dilate_packed_multi_plain(occ, [STENCIL_A, STENCIL_B])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_kernel_wrapper_refuses_cpu_tensors():
    occ = torch.zeros((1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dilate_cuda.dilate_cuda(occ, [STENCIL_A])


# ------------------------------------------------------------------ classify


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_classify_equals_jax(dtype):
    """in_mask and band_mask bit-equal to JAX _classify_packed on the same
    grid and queries, far queries included."""
    rng = np.random.default_rng(13)
    Xm = rng.uniform(-1, 1, (3000, 3)).astype(dtype)
    Xf = np.concatenate([rng.uniform(-1.3, 1.3, (2000, 3)),
                         rng.uniform(40, 60, (100, 3))]).astype(dtype)
    plan = T.plan_dilate_gate(None, Xm, 0.2, cell_div=8)
    occ = J.pack_occupancy(Xm, plan, dtype)
    want = J._classify_packed(jnp.asarray(Xf), jnp.asarray(occ), plan=plan)
    got = T._classify_packed(torch.from_numpy(Xf), _t(occ), plan=plan)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    in_mask, band = got
    assert in_mask.any() and band.any() and not (in_mask & band).any()
    full = T.classify_queries(torch.from_numpy(Xf), torch.from_numpy(Xm), plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(full, got))


# ------------------------------------------------------------------ min_dist_sq


def test_min_dist_sq_takes_the_jax_call_form():
    """The keywords the JAX gate passes (ref_tile, query_tile, layout) are
    accepted and ignored: the same d2 as without them, and the JAX d2
    within float64 rounding (XLA contracts the sum of squares)."""
    rng = np.random.default_rng(17)
    q, r = rng.uniform(-1, 1, (700, 3)), rng.uniform(-1, 1, (900, 3))
    plain = min_dist_sq(torch.from_numpy(q), torch.from_numpy(r))
    for kw in (dict(ref_tile=65536, layout="tq"),
               dict(ref_tile=512, query_tile=128, layout="tq"),
               dict(ref_tile=4096, query_tile=2048, layout="qt")):
        got = min_dist_sq(torch.from_numpy(q), torch.from_numpy(r), **kw)
        assert torch.equal(got, plain)
        want = np.asarray(jax_min_dist_sq(jnp.asarray(q), jnp.asarray(r), **kw))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
