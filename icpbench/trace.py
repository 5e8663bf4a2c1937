"""The traced run's readings: a bounded number of calls under
``torch.profiler``, after the window.

Only a few calls are profiled (the cell's ``trace_calls``): a registration
launches thousands of device operations, and the profiler keeps every one
of them in host memory; nothing is written to disk. The idle share is
1 - (union of the device's kernel, copy and fill intervals) / (wall span of
the profiled calls). The profiler's own host time is inside that span, so a
traced run's idle share reads somewhat higher than an untraced run's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .readings import Readings

CALL_SPAN = "icpbench.call"
# Symbols of the program's own kernels (csrc/*.cu), by the name the
# benchmark gives each.
PORT_KERNELS = {"match_scan": "match_transform", "match_finish": "match_transform",
                "knn_scan": "knn_search", "knn_merge": "knn_search",
                "nn1_scan": "nn_search", "nn1_min_reduce": "nn_search",
                "nn1_arg_finish": "nn_search", "dilate_kernel": "dilate"}


def _short(name: str) -> str:
    for sym, kernel in PORT_KERNELS.items():
        if sym in name:
            return f"{kernel} ({sym})"
    return name[:120]


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals of the (n, 2) intervals iv."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out)


def _label_gaps(gaps: np.ndarray, cpu: List[tuple]) -> List[str]:
    """Each gap (start, end) labelled by the innermost host operation open
    at its middle (a runtime call with the operation around it)."""
    mids = (gaps[:, 0] + gaps[:, 1]) / 2
    order = np.argsort(mids)
    labels = [""] * len(gaps)
    cpu = sorted(cpu, key=lambda e: (e[1], -e[2]))
    stack: List[tuple] = []
    k = 0
    for gi in order:
        m = mids[gi]
        while k < len(cpu) and cpu[k][1] <= m:
            while stack and stack[-1][2] <= cpu[k][1]:
                stack.pop()
            stack.append(cpu[k])
            k += 1
        while stack and stack[-1][2] < m:
            stack.pop()
        if not stack:
            labels[gi] = "(python, between operations)"
        elif stack[-1][0].startswith("cuda") and len(stack) > 1:
            labels[gi] = f"{stack[-2][0]} > {stack[-1][0]}"
        else:
            labels[gi] = stack[-1][0]
    return labels


def profile_calls(call, order: Sequence[List[int]], n_calls: int, device: torch.device):
    """``n_calls`` calls under the profiler, each waited on. Returns (their
    results, the device's operations [(name, start_us, end_us)], the host's
    operations [(name, start_us, end_us)])."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    results = []
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for i in range(n_calls):
            with record_function(CALL_SPAN):
                results.append(call(order[i % len(order)]))
                if cuda:
                    torch.cuda.synchronize()
    dev, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        (dev if e.device_type == torch.autograd.DeviceType.CUDA else host).append(row)
    return results, dev, host


def readings_from_trace(r: Readings, dev: List[tuple], host: List[tuple]) -> Dict:
    """Fills the trace's fields of ``r``; returns the breakdown."""
    spans = [h for h in host if h[0] == CALL_SPAN]
    lo = min(s for _, s, _ in spans)
    hi = max(e for _, _, e in spans)
    # the profiler mirrors the call's span on the device's timeline: it is
    # no operation of the device
    dev = [d for d in dev if d[2] > lo and d[1] < hi and d[0] != CALL_SPAN]
    iv = np.clip(np.array([[s, e] for _, s, e in dev], dtype=np.float64).reshape(-1, 2), lo, hi)
    merged = _union(iv)
    busy = float((merged[:, 1] - merged[:, 0]).sum()) if len(merged) else 0.0
    r.busy_s, r.traced_s = busy / 1e6, (hi - lo) / 1e6
    r.device_names = [d[0] for d in dev]
    r.device_us = iv[:, 1] - iv[:, 0]

    by_op: Dict[str, float] = {}
    for name, us in zip(r.device_names, r.device_us):
        key = _short(name)
        by_op[key] = by_op.get(key, 0.0) + us / 1e6
    edges = np.concatenate([[lo], merged.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    by_gap: Dict[str, float] = {}
    if len(gaps):
        cpu = [h for h in host if h[0] != CALL_SPAN and h[2] > lo and h[1] < hi]
        for label, (s, e) in zip(_label_gaps(gaps, cpu), gaps):
            by_gap[label] = by_gap.get(label, 0.0) + (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}
