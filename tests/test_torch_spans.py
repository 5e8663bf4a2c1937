"""The registration's spans (``utils/profiling.py`` ``span``, ``SPANS``):
where they open under a recording profiler, what they hold, and that they
cost no torch call and change no result without one."""

import contextlib
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from simpleicp_tpu_torch import IcpConfig, icp_register, icp_register_batch
from simpleicp_tpu_torch.utils import profiling, sync

CALL_STAGES = ["icp.plan", "icp.gate", "icp.select", "icp.normals", "icp.loop", "icp.finish"]
ITERATION_STAGES = ["icp.match", "icp.reject", "icp.solve", "icp.converge"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surface(rng, n, lo, hi):
    xy = np.column_stack([rng.uniform(lo, hi, n), rng.uniform(-1, 1, n)])
    return np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])


def _pair(seed, n=2000):
    """A fixed surface over x in [-2, 2] and a moved sample of it over
    [-1, 3]: a partial overlap."""
    rng = np.random.default_rng(seed)
    a = 0.02
    R = np.array([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0],
                  [0.0, 0.0, 1.0]])
    t = np.array([0.03, -0.02, 0.01])
    return _surface(rng, n, -2, 2), (_surface(rng, n, -1, 3) - t) @ R


GATED = dict(correspondences=200, max_overlap_distance=0.25)
CASES = {
    "ungated": (IcpConfig(correspondences=200), False),
    "brute": (IcpConfig(**GATED, gate_method="brute"), False),
    "dilate": (IcpConfig(**GATED, gate_method="dilate"), False),
    "batch": (IcpConfig(**GATED, gate_method="brute"), True),
}


def _register(case):
    cfg, batch = CASES[case]
    if batch:
        pairs = [_pair(700 + b) for b in range(3)]
        return icp_register_batch(np.stack([p[0] for p in pairs]),
                                  np.stack([p[1] for p in pairs]), cfg, device="cpu",
                                  dtype=torch.float64)
    return icp_register(*_pair(700), cfg, device="cpu", dtype=torch.float64)


def _children(events, parent):
    """The icp.* spans whose nearest enclosing event is ``parent``, by start."""
    return sorted((e for e in events if e.name.startswith("icp.") and e.cpu_parent is parent),
                  key=lambda e: e.time_range.start)


@pytest.mark.parametrize("case", list(CASES))
def test_spans_of_a_registration(case):
    profiling.clear_recorded_spans()
    reads0 = sync.host_reads()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _register(case)
    reads = sync.host_reads() - reads0
    events = [e for e in prof.events() if e.name.startswith("icp.")]
    assert {e.name for e in events} <= set(profiling.SPANS)

    (reg,) = [e for e in events if e.name == "icp.register"]
    assert reg.cpu_parent is None
    gated = CASES[case][0].overlap_enabled
    want = [s for s in CALL_STAGES if gated or s != "icp.gate"]
    assert [e.name for e in _children(events, reg)] == want

    iterations = [e for e in events if e.name == "icp.iteration"]
    (loop,) = [e for e in events if e.name == "icp.loop"]
    assert all(e.cpu_parent is loop for e in iterations)
    assert len(iterations) == int(res.n_iterations.max()) > 0
    for it in iterations:
        inner = [e.name for e in _children(events, it) if e.name != "icp.host_read"]
        assert inner == ITERATION_STAGES

    assert sum(e.name == "icp.host_read" for e in events) == reads
    plans = [e for e in events if e.name == "icp.gate_plan"]
    if gated:
        (gate,) = [e for e in events if e.name == "icp.gate"]
        assert len(plans) == 1 and plans[0].cpu_parent is gate
    else:
        assert plans == []

    # the host-clock record holds the same spans
    recorded = profiling.recorded_spans()
    assert sorted(n for n, _, _ in recorded) == sorted(e.name for e in events)
    assert all(e > s for _, s, e in recorded)


def test_without_a_profiler_a_span_is_the_shared_noop(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a torch function was called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    profiling.clear_recorded_spans()
    noop = profiling.span("icp.register")
    assert profiling.span("icp.solve") is noop
    assert isinstance(noop, contextlib.nullcontext)
    res = _register("dilate")
    assert int(res.error_code) == 0 and profiling.recorded_spans() == []


@pytest.mark.parametrize("case", list(CASES))
def test_results_are_the_same_under_the_profiler(case):
    plain = _register(case)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _register(case)
    for f in plain._fields:
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f


def test_stage_timer_opens_a_span_and_waits_for_the_card(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(a))
    timer = profiling.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("load"):
            torch.ones(3).sum()
    assert [e.name for e in prof.events() if e.name == "load"] == ["load"]
    assert len(synced) == 1 and timer.timings["load"] > 0
