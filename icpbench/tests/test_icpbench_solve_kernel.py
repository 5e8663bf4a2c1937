"""The reader of ``solve_kernel_share`` (``metrics/solve_kernel_share.py``):
the solve kernel's device time over the profiled calls' wall span, on the
CPU."""

import json

import numpy as np
import pytest

from icpbench import spec
from icpbench.readings import Readings


def _readings(ops, traced_s=0.01):
    return Readings(icp={}, n_fix=1, n_mov=1, pairs_per_call=1, traced_pairs=2,
                    traced_s=traced_s, device_names=[n for n, _ in ops],
                    device_us=np.array([us for _, us in ops], dtype=np.float64))


def test_share_of_the_solve_kernels_device_time():
    ops = [("void gn_solve_kernel<double>(double const*)", 36.0), ("match_scan", 41.0),
           ("void gn_solve_kernel<double>(double const*)", 40.0), ("Memcpy DtoH", 3.0)]
    read = spec.metric_reader("solve_kernel_share")
    assert read(_readings(ops)) == pytest.approx(76e-6 / 0.01)


def test_reads_none_without_the_kernel_or_a_profile():
    read = spec.metric_reader("solve_kernel_share")
    assert read(_readings([("match_scan", 41.0)])) is None  # a program without it
    assert read(_readings([])) is None
    assert read(Readings(icp={}, n_fix=1, n_mov=1, pairs_per_call=1)) is None  # untraced


def test_the_metric_is_declared_for_every_cell():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    metric = next(m for m in bench["per_layer"] if m["name"] == "solve_kernel_share")
    assert metric["source"] == "device_trace" and metric["moves"] == "register_ms"
    assert sorted(metric["workloads"]) == sorted(w["name"] for w in bench["workloads"])
    for cell in metric["workloads"]:
        assert "solve_kernel_share" in [m["name"] for m in spec.load(cell).per_layer]
