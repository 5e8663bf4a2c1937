"""The 1-NN kernel's two modes, on the CPU.

``min_dist_sq`` is the d2-only mode: the brute overlap gate and the
metrics call it and never ask for an index; ``nn_search`` is the index
mode. Here, where the plain versions run:

* ``min_dist_sq``, the brute gate's mask and selection, and the metrics
  equal the JAX package's on the same inputs (d2 within rtol 1e-15 in
  float64 and 5e-7 in float32, as tests/test_torch_knn.py explains; masks,
  selections and tie-lattice d2 bit-equal);
* the gate and the metrics go through ``min_dist_sq``, and
  ``min_dist_sq`` on a CUDA tensor launches the d2-only kernel
  (``knn_cuda.nn_d2_cuda``), never the index mode;
* the 1-NN's chunk plan fills the card's resident blocks in whole waves at
  the gate's shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu import metrics as jax_metrics
from simpleicp_tpu.models.icp import _select_n as jax_select_n
from simpleicp_tpu.ops import knn as jk
from simpleicp_tpu_torch import IcpConfig, metrics
from simpleicp_tpu_torch.models import icp as ticp
from simpleicp_tpu_torch.ops import knn as tk
from simpleicp_tpu_torch.ops import knn_cuda
from simpleicp_tpu_torch.ops.transform import apply_H, rbp_to_H

RTOL = {np.float64: 1e-15, np.float32: 5e-7}


def _t(a):
    return torch.from_numpy(np.array(a))


def _surface(rng, n, lo, hi):
    xy = np.column_stack([rng.uniform(lo, hi, n), rng.uniform(-1, 1, n)])
    return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["plain", "masked", "no valid ref", "tie lattice"])
def test_min_dist_sq_equals_jax(dtype, case):
    rng = np.random.default_rng(41)
    q = rng.uniform(-2, 2, (333, 3)).astype(dtype)
    r = rng.uniform(-2, 2, (2049, 3)).astype(dtype)
    mask = None
    if case == "masked":
        mask = rng.random(2049) < 0.3
    elif case == "no valid ref":
        mask = np.zeros(2049, bool)
    elif case == "tie lattice":
        g = np.arange(6.0)
        r = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3).astype(dtype)
        q = (r[rng.choice(len(r), 90, replace=False)]
             + 0.5 * rng.integers(0, 2, (90, 3))).astype(dtype)
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jk.min_dist_sq(jnp.asarray(q), jnp.asarray(r), ref_mask=jm))
    got = tk.min_dist_sq(_t(q), _t(r), ref_mask=None if mask is None else _t(mask)).numpy()
    assert got.dtype == dtype and got.shape == (len(q),)
    if case in ("no valid ref", "tie lattice"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[dtype])
    # the index mode's d2 is the same function
    np.testing.assert_array_equal(got, tk.nn_search(_t(q), _t(r), ref_mask=None if mask is None
                                                   else _t(mask))[0].numpy())


@pytest.mark.parametrize("radius", [0.05, 0.1, 0.3])
def test_brute_gate_mask_and_selection_equal_jax(radius):
    """The brute gate (min_dist_sq <= r^2 of the fixed cloud against the
    movable cloud under the initial H) against the JAX gate's
    nn_search_auto mask and _select_n, float64."""
    rng = np.random.default_rng(42)
    Xf, Xm = _surface(rng, 3000, -2, 2), _surface(rng, 2500, -1, 3)
    H0 = rbp_to_H(torch.tensor([0.01, -0.02, 0.015, 0.03, -0.01, 0.02], dtype=torch.float64))
    Xm0 = apply_H(_t(Xm), H0)
    d2j, _ = jk.nn_search_auto(jnp.asarray(Xf), jnp.asarray(Xm0.numpy()))
    want = np.asarray(d2j <= jnp.asarray(radius, jnp.float64) ** 2)
    cfg = IcpConfig(correspondences=400, max_overlap_distance=radius)
    sel_idx, sel_valid, err = ticp._gate_select_stages(_t(Xf), _t(Xm), H0, cfg=cfg)
    mask = tk.min_dist_sq(_t(Xf), Xm0) <= torch.tensor(radius, dtype=torch.float64) ** 2
    np.testing.assert_array_equal(mask.numpy(), want)
    assert err == ticp.ERR_OK and 0 < want.sum() < len(Xf)
    j_idx, j_valid = jax_select_n(jnp.asarray(want), 400)
    np.testing.assert_array_equal(sel_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(sel_valid.numpy(), np.asarray(j_valid))


def test_metrics_equal_jax():
    rng = np.random.default_rng(43)
    A, B = _surface(rng, 1500, -1, 1), _surface(rng, 1700, -1, 1)
    np.testing.assert_allclose(metrics.nn_rmse(A, B, step=3, device="cpu", dtype=torch.float64),
                               jax_metrics.nn_rmse(A, B, step=3), rtol=1e-12)
    np.testing.assert_allclose(
        metrics.chamfer_distance(A, B, device="cpu", dtype=torch.float64),
        jax_metrics.chamfer_distance(A, B), rtol=1e-12)


def test_gate_and_metrics_go_through_min_dist_sq(monkeypatch):
    """The brute gate and the metrics ask for d2 only: with nn_search
    replaced by a failure they still run, through min_dist_sq."""
    calls = []
    real = tk.min_dist_sq

    def counted(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    def boom(*a, **k):
        raise AssertionError("the index mode was asked for")

    monkeypatch.setattr(tk, "nn_search", boom)
    monkeypatch.setattr(tk, "min_dist_sq", counted)
    monkeypatch.setattr(ticp, "min_dist_sq", counted)
    rng = np.random.default_rng(44)
    Xf, Xm = _surface(rng, 2000, -2, 2), _surface(rng, 2000, -1, 3) + [0.02, -0.01, 0.01]
    res = ticp.icp_register(Xf, Xm, IcpConfig(correspondences=200, max_overlap_distance=0.2),
                            device="cpu", dtype=torch.float64)
    assert int(res.error_code) == 0 and calls == [2000]
    metrics.chamfer_distance(Xf, Xm, step=2, device="cpu", dtype=torch.float64)
    assert calls == [2000, 1000, 1000]


def test_min_dist_sq_launches_the_d2_mode_on_a_card(monkeypatch):
    """On a CUDA tensor min_dist_sq calls the d2-only wrapper with the
    query, the refs and the mask (with the pair axis, which the wrappers
    take), and never the index mode. (No card here:
    the device test is stood in for, the kernel's own test is on the card.)"""
    seen = []

    def d2_kernel(q, r, m):
        seen.append((q.shape, r.shape, m is not None))
        return tk.nn_search_plain(q, r, m)[0]

    def boom(*a, **k):
        raise AssertionError("the index mode was launched")

    monkeypatch.setattr(tk, "_on_device", lambda q: True)
    monkeypatch.setattr(knn_cuda, "nn_d2_cuda", d2_kernel)
    monkeypatch.setattr(knn_cuda, "nn_search_cuda", boom)
    rng = np.random.default_rng(45)
    q, r = _t(rng.uniform(0, 1, (50, 3))), _t(rng.uniform(0, 1, (70, 3)))
    m = _t(rng.random(70) < 0.5)
    got = tk.min_dist_sq(q, r, ref_tile=64, ref_mask=m)
    assert seen == [((1, 50, 3), (1, 70, 3), True)]
    assert torch.equal(got, tk.nn_search_plain(q, r, m)[0])


SHAPES = [(100_000, 100_000), (71_551, 1_200_000), (1_000_000, 1_000_000),
          (16_777_216, 1_000_000)]


@pytest.mark.parametrize("n_q,n_r", SHAPES)
@pytest.mark.parametrize("resident", [528, 396, 264, 132])
def test_nn_plan_fills_the_card(n_q, n_r, resident):
    """At the gate's shapes (the 100k and 1M brute gates, the 1.2M dilate
    gate's band sweep, a slice of the largest launch) the chunks cover the
    reference axis exactly and the grid fills at least 98 % of its waves of
    resident blocks (132 SMs x 1-4 blocks)."""
    chunk_len, n_chunks = knn_cuda._plan_nn_chunks(n_q, n_r, resident)
    assert (n_chunks - 1) * chunk_len < n_r <= n_chunks * chunk_len
    assert chunk_len >= knn_cuda._NN_MIN_CHUNK
    blocks = -(-n_q // knn_cuda._NN_BLOCK) * n_chunks
    assert blocks / (-(-blocks // resident) * resident) >= 0.98


def test_nn_plan_small_sweeps():
    """Fewer refs than one chunk: one chunk; a slab-join block (512 x 4 096)
    spreads over chunks of the smallest size."""
    assert knn_cuda._plan_nn_chunks(1, 1, 528) == (1, 1)
    assert knn_cuda._plan_nn_chunks(7, 200, 528) == (200, 1)
    assert knn_cuda._plan_nn_chunks(512, 4096, 528) == (256, 16)
    assert knn_cuda._NN_MAX_QUERIES == 65535 * 4 * 256
