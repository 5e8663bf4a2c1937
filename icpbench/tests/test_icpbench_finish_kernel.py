"""The reader of ``finish_kernel_share`` (``metrics/finish_kernel_share.py``):
the uncertainty kernel's launches in the profiled calls' device trace over
the finishes those calls ran (the program's ``icp.finish`` counters), on
the CPU."""

import json

import pytest

from icpbench import spec
from icpbench.readings import Readings
from simpleicp_tpu_torch.utils import profiling

# A registration of the window (host time 0-5), then two profiled calls.
SPANS = [("icp.register", 0.0, 5.0), ("icp.register", 10.0, 14.0),
         ("icp.register", 20.0, 24.0)]
KEPT = [("icp.finish", 4.0, {"kernel": 0, "plain": 1}),
        ("icp.loop_graph", 12.0, {"captures": 0, "replays": 4, "eager": 0}),
        ("icp.finish", 13.0, {"kernel": 1, "plain": 0}),
        ("icp.finish", 23.0, {"kernel": 0, "plain": 1})]
UNC = "void (anonymous namespace)::uncertainty_kernel<float>(float const*, float const*)"
SOLVE = "void (anonymous namespace)::gn_solve_kernel<float>(float const*, float const*)"


def _readings(names=(UNC, SOLVE)):
    return Readings(icp={}, n_fix=1, n_mov=1, pairs_per_call=1, traced_pairs=2,
                    device_names=list(names))


def _keep(monkeypatch, kept):
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(SPANS))
    monkeypatch.setattr(profiling, "recorded_counters",
                        lambda name=None: [k for k in kept if name in (None, k[0])])


def test_share_of_finishes_that_launched_the_kernel(monkeypatch):
    _keep(monkeypatch, KEPT)
    # the window's registration is left out: 1 launch for 2 finishes
    assert spec.metric_reader("finish_kernel_share")(_readings()) == pytest.approx(0.5)


@pytest.mark.parametrize("names, share", [((), 0.0), ((UNC, UNC), 1.0),
                                          ((UNC, UNC, UNC, SOLVE), 1.5)])
def test_the_launches_are_counted_in_the_trace(monkeypatch, names, share):
    """A finish that launched nothing reads below 1, one that launched the
    kernel twice above it, whatever the counters say the dispatch chose."""
    _keep(monkeypatch, KEPT)
    assert spec.metric_reader("finish_kernel_share")(_readings(names)) == pytest.approx(share)


def test_reads_none_without_the_counter(monkeypatch):
    read = spec.metric_reader("finish_kernel_share")
    _keep(monkeypatch, [k for k in KEPT if k[0] != "icp.finish"])
    assert read(_readings()) is None  # a program that keeps no such counter
    monkeypatch.delattr(profiling, "recorded_counters")  # a program without counters
    assert read(_readings()) is None


def test_the_metric_is_declared_for_every_cell():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    metric = next(m for m in bench["per_layer"] if m["name"] == "finish_kernel_share")
    assert metric["source"] == "device_trace" and metric["moves"] == "register_ms"
    assert metric["layer"] == "kernels"
    assert sorted(metric["workloads"]) == sorted(w["name"] for w in bench["workloads"])
    for cell in metric["workloads"]:
        assert "finish_kernel_share" in [m["name"] for m in spec.load(cell).per_layer]
