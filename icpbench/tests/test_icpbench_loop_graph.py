"""The reader of ``loop_graph_share`` (``metrics/loop_graph_share.py``):
replayed iterations over all iterations of the profiled calls, from the
program's ``icp.loop_graph`` counters, on the CPU."""

import json

import pytest

from icpbench import spec
from icpbench.readings import Readings
from simpleicp_tpu_torch.utils import profiling

# A registration of the window (host time 0-5), then two profiled calls.
SPANS = [("icp.register", 0.0, 5.0), ("icp.register", 10.0, 14.0),
         ("icp.register", 20.0, 24.0)]
KEPT = [("icp.loop_graph", 4.0, {"captures": 2, "replays": 1, "eager": 2}),
        ("icp.gate", 11.0, {"band": 5}),
        ("icp.loop_graph", 13.0, {"captures": 0, "replays": 4, "eager": 0}),
        ("icp.loop_graph", 22.0, {"captures": 0, "replays": 2, "eager": 0}),
        ("icp.loop_graph", 23.0, {"captures": 0, "replays": 0, "eager": 2})]


def _readings():
    return Readings(icp={}, n_fix=1, n_mov=1, pairs_per_call=1, traced_pairs=2)


def _keep(monkeypatch, kept):
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(SPANS))
    monkeypatch.setattr(profiling, "recorded_counters",
                        lambda name=None: [k for k in kept if name in (None, k[0])])


def test_share_of_replayed_iterations_in_the_profiled_calls(monkeypatch):
    _keep(monkeypatch, KEPT)
    # the window's registration is left out: 6 replays of 8 iterations
    assert spec.metric_reader("loop_graph_share")(_readings()) == pytest.approx(6 / 8)


def test_reads_none_without_the_counter(monkeypatch):
    read = spec.metric_reader("loop_graph_share")
    _keep(monkeypatch, [k for k in KEPT if k[0] != "icp.loop_graph"])
    assert read(_readings()) is None  # a program that keeps no such counter
    _keep(monkeypatch, [("icp.loop_graph", 13.0, {"captures": 0, "replays": 0, "eager": 0})])
    assert read(_readings()) is None  # no iteration ran
    monkeypatch.delattr(profiling, "recorded_counters")  # a program without counters
    assert read(_readings()) is None


def test_the_metric_is_declared_for_every_cell():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    metric = next(m for m in bench["per_layer"] if m["name"] == "loop_graph_share")
    assert metric["source"] == "program_counter" and metric["moves"] == "register_ms"
    assert sorted(metric["workloads"]) == sorted(w["name"] for w in bench["workloads"])
    for cell in metric["workloads"]:
        assert "loop_graph_share" in [m["name"] for m in spec.load(cell).per_layer]
