"""The strips tile cell (``airborne_lidar_50m.strips_tile``): it loads by
name, its traffic draws the pairs it says, and the readers of its three
per-layer metrics (``metrics/{gate_slab_plan_ms,gate_sweep_roofline,
dilate_roofline}.py``, over ``counters.py`` and ``rooflines/gate.py``) read
hand-built spans, counters and device times, and nothing on a program
without them."""

import numpy as np
import pytest
import torch

from icpbench import spec
from icpbench.pools import make_pool, rotation
from icpbench.readings import Readings
from icpbench.rooflines.gate import dilate_bound_ms, sweep_bound_ms
from simpleicp_tpu_torch.utils import profiling

CELL = "airborne_lidar_50m.strips_tile"
METRICS = ("gate_slab_plan_ms", "gate_sweep_roofline", "dilate_roofline")


def test_the_cell_loads_by_name():
    cell = spec.load(CELL)
    assert cell.config_name == cell.config["name"] == "airborne_lidar_50m"
    # the project's 50M tile cut to 25M points a cloud, the cut named in ``reduced``
    assert cell.config["points_fixed"] == cell.config["points_movable"] == 25_000_000
    # the 1.34M configuration's density, 6 250 points a square unit
    assert cell.config["points_fixed"] / (2 * cell.config["half_width"]) ** 2 == pytest.approx(
        6250.0)
    assert cell.config["reduced"] == ["layout", "points_fixed", "points_movable", "scale"]
    assert cell.icp_fields()["gate_method"] == "auto"
    assert cell.icp_fields()["max_overlap_distance"] == 0.1
    assert cell.traffic["pool"] == 8 and cell.traffic["pairs_per_call"] == 1
    assert cell.settings["limits"]["select_off"] == 0
    names = [m["name"] for m in cell.per_layer]
    assert set(METRICS) <= set(names)
    for other in ("airborne_lidar.strips", "dragon.pairs"):
        assert not set(METRICS) & {m["name"] for m in spec.load(other).per_layer}


def test_a_small_pool_of_the_cell_has_its_geometry_and_motions():
    cell = spec.load(CELL)
    t, half, n = cell.traffic, cell.config["half_width"], 3000
    pool = make_pool(pairs=4, n_fix=n, n_mov=n, half=half, geometry=t["geometry"],
                     angle_max=t["angle_max"], shift_max=t["shift_max"],
                     noise=cell.config["height_noise"], seed=2**33 + 3,
                     device=torch.device("cpu"))
    assert pool.fixed.shape == pool.movable.shape == (4, n, 3)
    m = pool.motion.double()
    assert (m[:, :3].abs() <= t["angle_max"]).all() and (m[:, 3:].abs() <= t["shift_max"]).all()
    assert (m[:, :3].abs().amax(dim=0) > 0.5 * t["angle_max"]).all()
    for p in range(4):
        f = pool.fixed[p].double()
        # the movable sample, moved back by its pair's motion: S = R X + t
        S = pool.movable[p].double() @ rotation(m[p, :3]).T + m[p, 3:]
        assert f[:, 0].min() >= -half - 1e-3 and f[:, 0].max() <= half + 1e-3
        assert S[:, 0].min() >= -half / 2 - 1e-3 and S[:, 0].max() <= 1.5 * half + 1e-3
        for xy in (f[:, :2], S[:, :2]):
            assert xy[:, 1].abs().max() <= half + 1e-3
        # both samples lie on the wavy surface, up to the scanner's noise
        for X in (f, S):
            z = 0.3 * torch.sin(2 * X[:, 0]) + 0.2 * torch.cos(3 * X[:, 1])
            assert (X[:, 2] - z).abs().max() < 8 * cell.config["height_noise"] + 1e-4
        # three quarters of the movable strip lie over the fixed one
        assert (S[:, 0] < half).float().mean() == pytest.approx(0.75, abs=0.05)


def _readings(pairs=2):
    return Readings(icp={}, n_fix=1, n_mov=1, pairs_per_call=1, traced_pairs=pairs)


# Two profiled calls (seconds on the host's clock) after one the window made.
SPANS = [("icp.register", 0.0, 5.0), ("icp.gate_slab_plan", 1.0, 2.0),
         ("icp.gate_slab_plan", 11.0, 11.25), ("icp.gate", 10.5, 12.0),
         ("icp.register", 10.0, 14.0),
         ("icp.gate_slab_plan", 21.0, 21.5), ("icp.register", 20.0, 24.0)]
COUNTS = dict(cell_div=8, n_words=40_000_000, in_offsets=137, poss_offsets=269, dilations=2,
              band=3_000_000, refs_kept=4_000_000, compaction=1, slab_blocks=700,
              sweep_launches=700, sweep_pairs=2 * 10**11, sweep_queries=3_000_000,
              sweep_refs=90_000_000)
KEPT = [("icp.gate", 1.5, {**COUNTS, "band": 1}), ("icp.gate", 11.5, COUNTS),
        ("icp.gate", 21.2, COUNTS)]


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(SPANS))
    monkeypatch.setattr(profiling, "recorded_counters",
                        lambda name=None: [k for k in KEPT if name in (None, k[0])])


def test_readers_on_hand_built_spans_counters_and_device_times(recorded):
    r = _readings()
    r.device_names = ["void nn1_min_reduce<float>", "dilate_kernel", "nn1_scan", "knn_scan"]
    r.device_us = np.array([40_000.0, 30_000.0, 20_000.0, 1_000.0])
    read = {m: spec.metric_reader(m)(r) for m in METRICS}
    # the window's registration (host time 1-2) is not a traced call's
    assert read["gate_slab_plan_ms"] == pytest.approx(1e3 * (0.25 + 0.5) / 2)
    sweep = 2 * sweep_bound_ms(COUNTS["sweep_pairs"], COUNTS["sweep_queries"],
                               COUNTS["sweep_refs"])
    assert sweep == pytest.approx(2 * 1e3 * 8 * 2e11 / 67e12)
    assert read["gate_sweep_roofline"] == pytest.approx(100 * sweep / 60.0)
    dil = 2 * dilate_bound_ms(40_000_000, 137, 269, 2)
    lop3 = 40_000_000 * (68 + 134 + 134)
    assert dil == pytest.approx(2 * 1e3 * lop3 / (132 * 64 * 1.98e9))
    assert read["dilate_roofline"] == pytest.approx(100 * dil / 30.0)


def test_readers_read_nothing_without_spans_counters_or_kernels(monkeypatch, recorded):
    r = _readings()
    assert all(spec.metric_reader(m)(r) is None for m in METRICS[1:])  # no device trace
    r.device_names, r.device_us = ["knn_scan"], np.array([5.0])
    assert all(spec.metric_reader(m)(r) is None for m in METRICS[1:])  # no gate kernels
    r.device_names = ["nn1_scan", "dilate_kernel"]
    r.device_us = np.array([5.0, 5.0])
    monkeypatch.delattr(profiling, "recorded_counters")  # a program without counters
    assert spec.metric_reader("gate_slab_plan_ms")(r) is not None
    assert all(spec.metric_reader(m)(r) is None for m in METRICS[1:])
    monkeypatch.delattr(profiling, "recorded_spans")  # nor spans
    assert all(spec.metric_reader(m)(r) is None for m in METRICS)


def test_a_program_without_the_gate_spans_reads_none(monkeypatch):
    """The parent program has the registration's spans but none of the
    gate's stages, and keeps no counters."""
    monkeypatch.setattr(profiling, "recorded_spans", lambda: [
        ("icp.register", 0.0, 4.0), ("icp.gate", 1.0, 2.0), ("icp.register", 5.0, 9.0)])
    monkeypatch.delattr(profiling, "recorded_counters")
    r = _readings()
    r.device_names, r.device_us = ["nn1_scan", "dilate_kernel"], np.array([5.0, 5.0])
    assert all(spec.metric_reader(m)(r) is None for m in METRICS)
