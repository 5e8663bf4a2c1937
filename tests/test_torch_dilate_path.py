"""The dilate-gated path of the PyTorch port (CPU, plain versions):
icp_register with gate_method="dilate" against the JAX package and against
the port's brute gate, gate_method="auto" above 2^40 pairs, the plan's
resolution, and the host reads it adds.

Tolerances: against the JAX package, those of tests/test_torch_gate.py
(float64: integer decisions equal, H within 1e-9, ...). Against the port's
brute gate: none; the gate's mask is the brute mask bit for bit, so the
selection and everything after it are the same.
"""

import dataclasses

import numpy as np
import pytest
import torch

from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu_torch import IcpConfig, icp_register
from simpleicp_tpu_torch.models import icp
from simpleicp_tpu_torch.ops import dilate_gate
from simpleicp_tpu_torch.utils import sync
from test_torch_dilate_gate import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_gate import _assert_parity, _pair, _run_both

OBS = dict(rbp_observed_values=np.array([0.01, -0.01, 0.02, 0.04, -0.03, 0.02]),
           rbp_observation_weights=np.zeros(6))


def test_dilate_gated_icp_register_matches_jax():
    """float64, a partial-overlap surface pair with an initial transform."""
    X_fix, X_mov, t = _pair(611)
    jcfg = JaxConfig(correspondences=300, max_overlap_distance=0.2, max_iterations=40,
                     gate_method="dilate")
    jres, tres, last = _run_both(jcfg, X_fix, X_mov, **OBS)
    _assert_parity(jres, tres, last)
    assert int(tres.error_code) == 0 and bool(tres.converged)
    assert X_fix[tres.sel_idx, 0].min() > -1.25
    np.testing.assert_allclose(tres.H[:3, 3], t, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dilate_equals_brute_in_the_port(dtype):
    """Every field of the result equal to the brute-gated run's."""
    X_fix, X_mov, _ = _pair(612)
    runs = {}
    for method in ("dilate", "brute"):
        cfg = IcpConfig(correspondences=300, max_overlap_distance=0.2,
                        gate_method=method, record_trajectory=True)
        runs[method] = icp_register(X_fix, X_mov, cfg, device="cpu", dtype=dtype, **OBS)
    for f in runs["brute"]._fields:
        assert torch.equal(getattr(runs["dilate"], f), getattr(runs["brute"], f)), f


def test_auto_above_2_40_pairs_runs_the_dilate_gate(monkeypatch):
    """With the brute limit lowered, "auto" plans and runs the dilate gate
    (one call) and gives the brute gate's result."""
    X_fix, X_mov, _ = _pair(613, n=1500)
    cfg = IcpConfig(correspondences=200, max_overlap_distance=0.25)
    want = icp_register(X_fix, X_mov, dataclasses.replace(cfg, gate_method="brute"),
                        device="cpu", dtype=torch.float64)
    calls = []
    real = icp.overlap_mask_dilate

    def spy(*a, **k):
        calls.append(a[3])
        return real(*a, **k)

    monkeypatch.setattr(icp, "GATE_AUTO_BRUTE_PAIRS", 1500 * 1500 - 1)
    monkeypatch.setattr(icp, "overlap_mask_dilate", spy)
    got = icp_register(X_fix, X_mov, cfg, device="cpu", dtype=torch.float64)
    assert len(calls) == 1 and calls[0].dims[0] > 0
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_gate_resolution_as_in_jax():
    """_resolve_gate: brute reads no box; dilate and auto plan over the box;
    with no plan, dilate raises the JAX package's ValueError and auto is the
    brute gate up to 2^41 pairs and the grid gate above; grid reads no box
    either."""
    cfg = IcpConfig(max_overlap_distance=0.1)
    box = (np.zeros(3), np.full(3, 4.0))
    huge = (np.zeros(3), np.full(3, 1e5))

    def no_read():
        raise AssertionError("the brute gate reads no bounding box")

    for method in ("brute", "grid"):
        assert icp._resolve_gate(dataclasses.replace(cfg, gate_method=method),
                                 2**30, 2**30, no_read) == (method, None)
    for method in ("dilate", "auto"):
        resolved, plan = icp._resolve_gate(dataclasses.replace(cfg, gate_method=method),
                                           2**20, 2**20 + 1, lambda: box)
        assert resolved == "dilate"
        assert plan == dilate_gate.plan_dilate_gate(None, None, 0.1, bbox=box)
    auto = dataclasses.replace(cfg, gate_method="auto")
    assert icp._resolve_gate(auto, 2**20, 2**21, lambda: huge) == ("brute", None)
    assert icp._resolve_gate(auto, 2**20, 2**21 + 1, lambda: huge) == ("grid", None)
    with pytest.raises(ValueError, match="needs a dense cell grid"):
        icp._resolve_gate(dataclasses.replace(cfg, gate_method="dilate"), 10, 10,
                          lambda: huge)


def test_dilate_without_a_plan_raises_in_icp_register():
    rng = np.random.default_rng(614)
    X = rng.uniform(0, 1e4, (200, 3))
    with pytest.raises(ValueError, match="needs a dense cell grid"):
        icp_register(X, X, IcpConfig(correspondences=20, max_overlap_distance=1e-3,
                                     gate_method="dilate"), device="cpu")


def test_dilate_gate_host_reads(monkeypatch):
    """The dilate gate reads back the bounding box, the band and the
    survivors' count: two reads more than the brute gate; the band-ref
    compaction adds one (the kept refs)."""
    X_fix, X_mov, _ = _pair(615, n=1000)
    cfg = IcpConfig(correspondences=100, max_iterations=5, max_overlap_distance=0.25)
    reads = {}
    for method in ("brute", "dilate"):
        sync.reset_host_reads()
        icp_register(X_fix, X_mov, dataclasses.replace(cfg, gate_method=method),
                     device="cpu")
        reads[method] = sync.host_reads()
    assert reads["dilate"] == reads["brute"] + 2
    stats = {}
    Xf = torch.as_tensor(X_fix, dtype=torch.float32)
    Xm = torch.as_tensor(X_mov, dtype=torch.float32)
    plan = dilate_gate.plan_dilate_gate(None, X_mov, 0.25)
    sync.reset_host_reads()
    dilate_gate.overlap_mask_dilate(Xf, Xm, 0.25, plan, stats=stats)
    assert stats["band"] > 0 and sync.host_reads() == 1
    monkeypatch.setattr(dilate_gate, "_DIRECT_SWEEP_MAX", 0)
    sync.reset_host_reads()
    dilate_gate.overlap_mask_dilate(Xf, Xm, 0.25, plan, stats=stats)
    assert stats["compaction"] and sync.host_reads() == 2
