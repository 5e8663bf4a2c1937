"""The blocked 2-D slab join of the port's dilate gate (CPU, plain
versions), forced on small clouds by lowering its thresholds in both
packages as tests/test_dilate_gate.py does: the mask against the port's
brute gate (bit for bit) and against the JAX package (the tolerance of
tests/test_torch_dilate_gate.py). Two cases pin cell_div to 8 (the planner
picks 16): their plain dilations would take tens of seconds on the CPU."""

import jax.numpy as jnp
import numpy as np

from simpleicp_tpu.ops.transform import rbp_to_H as jax_rbp_to_H
from test_torch_dilate_gate import _check, _force
from test_torch_dilate_gate import _one_torch_thread  # noqa: F401 (autouse fixture)


def test_slab_join(monkeypatch):
    _force(monkeypatch, _DIRECT_SWEEP_MAX=1, _SLAB_SWEEP_MIN=1,
           _SLAB_CHUNK_OPTS=(64, 256), _SLAB1_MIN=16)
    rng = np.random.default_rng(110)
    Xf = rng.uniform(-1, 1, size=(3000, 3)) * np.array([4.0, 1.0, 1.0])
    Xm = rng.uniform(-1, 1, size=(2500, 3)) * np.array([4.0, 1.0, 1.0])
    _, stats = _check(Xf, Xm, 0.11)
    assert stats["sweep"] == "slab join" and stats["slab_blocks"] > 1


def test_slab_join_with_initial_transform(monkeypatch):
    _force(monkeypatch, _DIRECT_SWEEP_MAX=1, _SLAB_SWEEP_MIN=1,
           _SLAB_CHUNK_OPTS=(128,), _SLAB1_MIN=32)
    rng = np.random.default_rng(111)
    Xf = rng.uniform(-1, 1, size=(2000, 3)) * np.array([1.0, 3.0, 1.0])
    Xm = rng.uniform(-1, 1, size=(2200, 3)) * np.array([1.0, 3.0, 1.0])
    H0 = np.array(jax_rbp_to_H(jnp.asarray([0.02, -0.01, 0.05, 0.1, -0.2, 0.3])))
    _, stats = _check(Xf, Xm, 0.2, H0=H0)
    assert stats["sweep"] == "slab join"


def test_slab_join_multi_call(monkeypatch):
    """The JAX package splits the blocks over several calls under a tiny
    pair budget; the port launches one sweep per block either way."""
    _force(monkeypatch, _DIRECT_SWEEP_MAX=1, _SLAB_SWEEP_MIN=1,
           _SLAB_CHUNK_OPTS=(128, 512), _SLAB1_MIN=32, _SWEEP_PAIR_BUDGET=1 << 16)
    rng = np.random.default_rng(112)
    Xf = rng.uniform(-1, 1, size=(5000, 3)) * np.array([5.0, 2.0, 1.0])
    Xm = rng.uniform(-1, 1, size=(4000, 3)) * np.array([5.0, 2.0, 1.0])
    # cell_div 8: at the planner's 16 the plain dilations of this 17.7M-word
    # grid take about a minute on the CPU
    _, stats = _check(Xf, Xm, 0.09, cell_div=8)
    assert stats["slab_blocks"] > 4


def test_slab_join_skewed_density(monkeypatch):
    _force(monkeypatch, _DIRECT_SWEEP_MAX=1, _SLAB_SWEEP_MIN=1,
           _SLAB_CHUNK_OPTS=(256,), _SLAB1_MIN=16, _SWEEP_PAIR_BUDGET=1 << 15)
    rng = np.random.default_rng(113)
    dense = rng.normal(0.0, 0.03, size=(2500, 3)) + np.array([3.0, 0.2, 0.0])
    sparse = rng.uniform(-1, 1, size=(1500, 3)) * np.array([4.0, 1.0, 1.0])
    Xf = np.concatenate([
        rng.normal(0.0, 0.05, size=(800, 3)) + np.array([3.0, 0.2, 0.0]),
        rng.uniform(-1, 1, size=(1200, 3)) * np.array([4.0, 1.0, 1.0]),
    ])
    _, stats = _check(Xf, np.concatenate([dense, sparse]), 0.12, cell_div=8)
    assert stats["sweep"] == "slab join"
