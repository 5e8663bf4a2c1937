"""The per-layer metrics that read the program's spans (``spans.py``,
``metrics/{plan_ms,gate_wall_ms,solve_share,host_wait_share}.py``) and the
stage table of ``stages.py``, on the CPU."""

import json

import pytest

from icpbench import spec, stages
from icpbench.readings import Readings
from icpbench.trace import CALL_SPAN
from simpleicp_tpu_torch.utils import profiling

SPAN_METRICS = ("plan_ms", "gate_wall_ms", "solve_share", "host_wait_share")

# Two profiled calls of one pair each (seconds on the host's clock), after a
# registration the window made earlier (profiled elsewhere in the process).
RECORDED = [
    ("icp.register", 0.0, 5.0),
    ("icp.plan", 10.0, 10.5), ("icp.host_read", 11.2, 11.4), ("icp.gate", 11.0, 11.5),
    ("icp.solve", 12.0, 13.0), ("icp.host_read", 12.5, 12.6), ("icp.register", 10.0, 14.0),
    ("icp.plan", 20.0, 20.5), ("icp.register", 20.2, 20.4), ("icp.plan", 20.25, 20.3),
    ("icp.solve", 21.0, 23.0), ("icp.register", 20.0, 24.0),
]


def _readings(pairs=2, per_call=1):
    return Readings(icp={}, n_fix=1, n_mov=1, pairs_per_call=per_call, traced_pairs=pairs)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(RECORDED))


def test_span_metrics_on_hand_built_spans(recorded):
    r = _readings()
    read = {m: spec.metric_reader(m)(r) for m in SPAN_METRICS}
    # the first register is left out; the warm start's nested plan counts once
    assert read["plan_ms"] == pytest.approx(1e3 * (0.5 + 0.5) / 2)
    assert read["gate_wall_ms"] == pytest.approx(1e3 * 0.5 / 2)
    assert read["solve_share"] == pytest.approx(3.0 / 8.0)
    assert read["host_wait_share"] == pytest.approx(0.3 / 8.0)


def test_span_metrics_read_nothing_without_spans(monkeypatch, recorded):
    assert spec.metric_reader("plan_ms")(_readings(pairs=4)) is None  # too few calls
    assert spec.metric_reader("gate_wall_ms")(_readings(pairs=1)) is None  # no gate
    monkeypatch.delattr(profiling, "recorded_spans")
    for m in SPAN_METRICS:
        assert spec.metric_reader(m)(_readings()) is None


def _host(*rows):
    return [(n, float(s), float(e)) for n, s, e in rows]


def test_stage_table_on_a_synthetic_profile():
    host = _host((CALL_SPAN, 0, 100), ("icp.register", 1, 99), ("icp.plan", 1, 10),
                 ("icp.loop", 10, 90), ("icp.iteration", 10, 50), ("icp.solve", 20, 40),
                 ("icp.host_read", 45, 50), ("icp.finish", 90, 98),
                 ("aten::mul", 24, 31), ("cudaLaunchKernel", 25, 26),
                 ("cudaLaunchKernel", 30, 31), ("cudaMemcpyAsync", 46, 47),
                 ("cudaLaunchKernel", 60, 61))
    dev = _host(("kernel_a", 8, 12), ("kernel_b", 61, 70), (CALL_SPAN, 0, 100))
    with_mirrors = dev + _host(("icp.solve", 20, 40), ("icp.register", 1, 99))
    got = stages.stage_table(dev, host, 1, profiling.SPANS)
    assert stages.stage_table(with_mirrors, host, 1, profiling.SPANS)["stages"] == got["stages"]
    t = got["stages"]
    assert list(t) == ["icp.register", "icp.plan", "icp.loop", "icp.iteration", "icp.solve",
                       "icp.finish", "icp.host_read"]
    assert t["icp.register"]["wall_ms"] == pytest.approx(0.098)
    assert t["icp.register"]["self_ms"] == pytest.approx(0.098 - 0.097)
    assert t["icp.iteration"]["self_ms"] == pytest.approx(0.040 - 0.025)
    assert t["icp.solve"]["launches"] == 2 and t["icp.iteration"]["launches"] == 3
    assert t["icp.loop"]["launches"] == 4 and t["icp.iteration"]["host_reads"] == 1
    # idle: 0-8 (middle 4: plan), 12-61 (36.5: solve), 70-100 (85: loop)
    assert t["icp.plan"]["idle_ms"] == pytest.approx(0.008)
    assert t["icp.solve"]["idle_ms"] == pytest.approx(0.049)
    assert t["icp.loop"]["idle_ms"] == pytest.approx(0.030)
    assert t["icp.iteration"]["idle_ms"] == 0
    c = got["checks"]
    assert c["device_ops_per_pair"] == 2 and c["register_launches_per_pair"] == 4
    assert c["stages_cover_register"] == pytest.approx(97 / 98)
    assert c["register_covers_call"] == pytest.approx(0.98)
    assert c["idle_outside_spans"] == 0 and c["span_mirrors_on_device"] == 0


def test_traced_run_reads_the_span_metrics(tiny_root, program):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in SPAN_METRICS:
            m["workloads"] += ["tiny.strips"]
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load("tiny.strips", root=tiny_root)
    out, got = stages.run_stages(cell, seed=2**31 + 24, seconds=0.1, device="cpu",
                                 program=program)
    assert out["correct"] is True
    assert set(SPAN_METRICS) <= set(out["metrics"])
    assert all(out["metrics"][m]["value"] > 0 for m in SPAN_METRICS)
    t = got["stages"]
    assert list(t)[:6] == ["icp.register", "icp.plan", "icp.gate", "icp.gate_plan",
                           "icp.select", "icp.normals"]
    assert t["icp.register"]["host_reads"] == pytest.approx(
        t["icp.gate"]["host_reads"] + t["icp.loop"]["host_reads"])
    assert got["checks"]["stages_cover_register"] > 0.9
